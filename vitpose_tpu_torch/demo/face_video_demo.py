"""Face-landmark video demo: per-frame face box -> landmark model ->
annotated video (counterpart of demo/face_video_demo.py). Without a face
detector, boxes come from a json ({frame_idx: [xywh, ...]}) or default to
the full frame.

    python -m vitpose_tpu_torch.demo.face_video_demo VIDEO
        [--det-json boxes.json] [--dataset 300w] [--checkpoint ckpt.pth]
        [--variant s] [--out-video-root vis_results] [--kpt-thr 0.3]
        [--max-frames N] [--device cuda|cpu]

The model is the variant with the dataset's joint count, in f32 without
fused attention, as in JAX.
"""
import argparse
import json

from ..api import (inference_top_down_pose_model, init_pose_model,
                   vis_pose_result)
from ..data.dataset_info import DatasetInfo
from ._video import run_video


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('video')
    ap.add_argument('--det-json', default=None,
                    help='json: {frame_idx: [xywh boxes]}')
    ap.add_argument('--dataset', default='300w')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--variant', default='s')
    ap.add_argument('--out-video-root', default='vis_results')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    info = DatasetInfo.load(args.dataset)
    model = init_pose_model(
        dict(variant=args.variant, dataset=args.dataset,
             out_channels=info.num_joints), checkpoint=args.checkpoint,
        device=args.device)
    dets = None
    if args.det_json:
        with open(args.det_json) as f:
            dets = json.load(f)

    def draw(i, frame):
        h, w = frame.shape[:2]
        boxes = dets.get(str(i), []) if dets else [[0, 0, w, h]]
        results, _ = inference_top_down_pose_model(
            model, frame[..., ::-1], [{'bbox': b} for b in boxes])
        return vis_pose_result(model, frame[..., ::-1], results,
                               kpt_score_thr=args.kpt_thr)

    n, out_path = run_video(args.video, args.out_video_root, 'face_',
                            args.max_frames, draw)
    print(f'{n} frames -> {out_path}')
    return n, out_path


if __name__ == '__main__':
    main()

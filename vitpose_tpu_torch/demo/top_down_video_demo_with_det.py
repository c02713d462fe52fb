"""Top-down video demo driven by per-frame detector output (counterpart of
demo/top_down_video_demo_with_det.py; boxes from a per-frame json in place
of mmdet).

    python -m vitpose_tpu_torch.demo.top_down_video_demo_with_det VIDEO
        --det-json dets.json [--bbox-thr 0.3] [--checkpoint ckpt.pth]
        [--variant b] [--out-video-root vis_results] [--kpt-thr 0.3]
        [--max-frames N] [--device cuda|cpu]

det json: {frame_idx: [[x, y, w, h, score?], ...], ...}. `--variant` is a
variant name or a config file.
"""
import argparse
import json

from ..api import (inference_top_down_pose_model, init_pose_model,
                   vis_pose_result)
from ._video import run_video


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('video')
    ap.add_argument('--det-json', required=True)
    ap.add_argument('--bbox-thr', type=float, default=0.3)
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--variant', default='b')
    ap.add_argument('--out-video-root', default='vis_results')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    with open(args.det_json) as f:
        dets = json.load(f)
    model = init_pose_model(args.variant, checkpoint=args.checkpoint,
                            device=args.device)

    def draw(i, frame):
        person = [{'bbox': b} for b in dets.get(str(i), [])]
        pose_results, _ = inference_top_down_pose_model(
            model, frame[..., ::-1], person, bbox_thr=args.bbox_thr)
        return vis_pose_result(model, frame[..., ::-1], pose_results,
                               kpt_score_thr=args.kpt_thr)

    n, out_path = run_video(args.video, args.out_video_root, 'vis_det_',
                            args.max_frames, draw)
    print(f'{n} frames -> {out_path}')
    return n, out_path


if __name__ == '__main__':
    main()

"""Pose-tracking demo: per-frame pose + IoU/OKS track ids (counterpart of
demo/top_down_pose_tracking_demo.py, with a detection json or full-frame
boxes in place of mmdet).

    python -m vitpose_tpu_torch.demo.top_down_pose_tracking_demo VIDEO
        [--det-json dets.json] [--checkpoint ckpt.pth] [--variant s]
        [--out-video-root vis_results] [--kpt-thr 0.3] [--tracking-thr 0.3]
        [--use-oks-tracking] [--max-frames N] [--device cuda|cpu]

det json: {frame_idx: [xywh boxes]}. `--variant` is a variant name or a
config file.
"""
import argparse
import json

from ..api import (get_track_id, inference_top_down_pose_model,
                   init_pose_model, vis_pose_result)
from ._video import run_video


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('video')
    ap.add_argument('--det-json', default=None,
                    help='json: {frame_idx: [xywh boxes]}')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--variant', default='s')
    ap.add_argument('--out-video-root', default='vis_results')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--tracking-thr', type=float, default=0.3)
    ap.add_argument('--use-oks-tracking', action='store_true')
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    model = init_pose_model(args.variant, checkpoint=args.checkpoint,
                            device=args.device)
    dets = None
    if args.det_json:
        with open(args.det_json) as f:
            dets = json.load(f)
    track = {'last': [], 'next_id': 0}

    def draw(i, frame):
        h, w = frame.shape[:2]
        boxes = dets.get(str(i), []) if dets else [[0, 0, w, h]]
        pose_results, _ = inference_top_down_pose_model(
            model, frame[..., ::-1], [{'bbox': b} for b in boxes])
        pose_results, track['next_id'] = get_track_id(
            pose_results, track['last'], track['next_id'],
            use_oks=args.use_oks_tracking, tracking_thr=args.tracking_thr,
            bbox_format='xywh')
        track['last'] = pose_results
        return vis_pose_result(model, frame[..., ::-1], pose_results,
                               kpt_score_thr=args.kpt_thr)

    n, out_path = run_video(args.video, args.out_video_root, 'track_',
                            args.max_frames, draw)
    print(f'{n} frames, {track["next_id"]} tracks -> {out_path}')
    return n, out_path


if __name__ == '__main__':
    main()

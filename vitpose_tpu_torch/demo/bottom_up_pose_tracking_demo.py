"""Bottom-up pose-tracking video demo: whole-frame AE pose per frame +
IoU/OKS greedy track ids across frames (counterpart of
demo/bottom_up_pose_tracking_demo.py).

    python -m vitpose_tpu_torch.demo.bottom_up_pose_tracking_demo VIDEO
        [--checkpoint ckpt.pth] [--base-size 256] [--use-oks-tracking]
        [--tracking-thr 0.3] [--out-video-root vis_results]
        [--kpt-thr 0.3] [--max-frames N] [--device cuda|cpu]

The estimator is the video demo's (`build_estimator`); the poses carry an
'area' and no box, from which `get_track_id` derives one.
"""
import argparse

from ..api import (get_track_id, inference_bottom_up_pose_model,
                   vis_pose_result)
from ._video import run_video
from .bottom_up_video_demo import add_common_args, build_estimator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('video')
    add_common_args(ap)
    ap.add_argument('--out-video-root', default='vis_results')
    ap.add_argument('--tracking-thr', type=float, default=0.3)
    ap.add_argument('--use-oks-tracking', action='store_true')
    ap.add_argument('--max-frames', type=int, default=0)
    args = ap.parse_args(argv)

    est = build_estimator(args.base_size, args.checkpoint, args.device)
    track = {'last': [], 'next_id': 0}

    def draw(i, frame):
        results, _ = inference_bottom_up_pose_model(
            est, frame[..., ::-1], base_size=args.base_size)
        results, track['next_id'] = get_track_id(
            results, track['last'], track['next_id'],
            use_oks=args.use_oks_tracking, tracking_thr=args.tracking_thr)
        track['last'] = results
        return vis_pose_result(None, frame[..., ::-1], results,
                               kpt_score_thr=args.kpt_thr,
                               dataset_info=est.dataset_info)

    n, out_path = run_video(args.video, args.out_video_root, 'bu_track_',
                            args.max_frames, draw)
    print(f'{n} frames, {track["next_id"]} tracks -> {out_path}')
    return n, out_path


if __name__ == '__main__':
    main()

"""Video top-down demo: a full-frame person box per frame -> pose ->
annotated video (counterpart of demo/top_down_video_demo.py).

    python -m vitpose_tpu_torch.demo.top_down_video_demo VIDEO
        [--checkpoint ckpt.pth] [--variant s] [--out-video-root vis_results]
        [--kpt-thr 0.3] [--max-frames N] [--device cuda|cpu]

`--variant` is a variant name or a config file. The output video is written
with MJPG where its name ends in .avi, else mp4v (utils/video.py).
"""
import argparse

from ..api import (inference_top_down_pose_model, init_pose_model,
                   vis_pose_result)
from ._video import run_video


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('video')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--variant', default='s')
    ap.add_argument('--out-video-root', default='vis_results')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    model = init_pose_model(args.variant, checkpoint=args.checkpoint,
                            device=args.device)

    def draw(i, frame):
        h, w = frame.shape[:2]
        person = [{'bbox': [0, 0, w, h]}]      # full-frame box
        pose_results, _ = inference_top_down_pose_model(
            model, frame[..., ::-1], person)
        return vis_pose_result(model, frame[..., ::-1], pose_results,
                               kpt_score_thr=args.kpt_thr)

    n, out_path = run_video(args.video, args.out_video_root, 'vis_',
                            args.max_frames, draw)
    print(f'{n} frames -> {out_path}')
    return n, out_path


if __name__ == '__main__':
    main()

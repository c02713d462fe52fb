"""Bottom-up video demo: whole-frame multi-person associative-embedding pose
per frame, no detector -> annotated video (counterpart of
demo/bottom_up_video_demo.py).

    python -m vitpose_tpu_torch.demo.bottom_up_video_demo VIDEO
        [--checkpoint ckpt.pth] [--base-size 256]
        [--out-video-root vis_results] [--kpt-thr 0.3] [--max-frames N]
        [--device cuda|cpu]

The estimator is JAX's `build_estimator`: a ViT (embed 384, depth 12, 12
heads, f32) at --base-size with the AE head, fused attention on (K1 on the
card, the plain attention on the CPU); weights seeded (torch.Generator 0)
unless --checkpoint (.pth, or the JAX package's .npz) gives them. The output
video is written with MJPG where its name ends in .avi, else mp4v.
"""
import argparse

import torch

from ..api import inference_bottom_up_pose_model, vis_pose_result
from ..api.inference import _device, load_checkpoint
from ..data import DatasetInfo
from ..models.bottomup import BottomUpEstimator
from ..models.vit import ViTConfig
from ._video import run_video


def build_estimator(base_size, checkpoint=None, device='cuda'):
    """The demos' bottom-up estimator on `device`, in eval mode."""
    dev = _device(device)
    est = BottomUpEstimator(
        ViTConfig(img_size=(base_size, base_size), embed_dim=384, depth=12,
                  num_heads=12, fused_attention=True),
        num_joints=17, dataset_info=DatasetInfo.load('coco'),
        generator=torch.Generator().manual_seed(0))
    if checkpoint:
        load_checkpoint(est, checkpoint)
    return est.to(dev).eval()


def add_common_args(ap):
    ap.add_argument('--checkpoint', default=None,
                    help='estimator weights (.pth or .npz)')
    ap.add_argument('--base-size', type=int, default=256)
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--device', default='cuda')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('video')
    add_common_args(ap)
    ap.add_argument('--out-video-root', default='vis_results')
    ap.add_argument('--max-frames', type=int, default=0)
    args = ap.parse_args(argv)

    est = build_estimator(args.base_size, args.checkpoint, args.device)

    def draw(i, frame):
        results, _ = inference_bottom_up_pose_model(
            est, frame[..., ::-1], base_size=args.base_size)
        return vis_pose_result(None, frame[..., ::-1], results,
                               kpt_score_thr=args.kpt_thr,
                               dataset_info=est.dataset_info)

    n, out_path = run_video(args.video, args.out_video_root, 'bu_',
                            args.max_frames, draw)
    print(f'{n} frames -> {out_path}')
    return n, out_path


if __name__ == '__main__':
    main()

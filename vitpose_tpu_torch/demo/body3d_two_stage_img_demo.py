"""Two-stage 3D image demo: 2D keypoints (from a COCO-style json, or
top-down on the whole image) -> a single-frame window through the pose
lifter -> one 3D skeleton drawing (counterpart of
demo/body3d_two_stage_img_demo.py).

    python -m vitpose_tpu_torch.demo.body3d_two_stage_img_demo IMG
        [--json-file kpts.json] [--checkpoint lifter.pth|.npz]
        [--variant s] [--pose-checkpoint ckpt.pth]
        [--out-img-root vis_results] [--device cuda|cpu]

The lifter is JAX's default PoseLifter (TCN 1024 wide, kernels (3, 3, 3):
a 27-frame receptive field, filled by repeating the image) with seeded
weights (torch.Generator 0) unless --checkpoint gives them (the port's
.pth or the JAX package's .npz). `--variant` is a variant name or a
top-down config file for the 2D stage (the COCO-B config runs ViTPose-B in
bf16 with K1), `--pose-checkpoint` its weights. The drawing is
matplotlib's, written to OUT/3d_<image name>.png.
"""
import argparse
import json
import os

import numpy as np
import torch

from ..api import inference_top_down_pose_model, init_pose_model
from ..api.inference import _device, load_checkpoint, vis_pose_result_3d
from ..api.inference_3d import inference_pose_lifter_model
from ..data import DatasetInfo
from ..data.bottomup import read_rgb
from ..models.pose3d import PoseLifter


def build_lifter(num_joints, checkpoint=None, device='cuda'):
    """The demos' PoseLifter on `device`, in eval mode."""
    lifter = PoseLifter(num_joints=num_joints,
                        generator=torch.Generator().manual_seed(0))
    if checkpoint:
        load_checkpoint(lifter, checkpoint)
    return lifter.to(_device(device)).eval()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('img')
    ap.add_argument('--json-file', default=None,
                    help='COCO keypoints json: its keypoints are the 2D '
                         'stage (reference --only-second-stage)')
    ap.add_argument('--checkpoint', default=None,
                    help='lifter weights (.pth or .npz)')
    ap.add_argument('--variant', default='s')
    ap.add_argument('--pose-checkpoint', default=None,
                    help='weights of the 2D stage')
    ap.add_argument('--out-img-root', default='vis_results')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    img = read_rgb(args.img)
    h, w = img.shape[:2]
    if args.json_file:
        with open(args.json_file) as f:
            anns = json.load(f)
        anns = anns.get('annotations', anns)
        pose_results = [
            {'keypoints': np.asarray(a['keypoints'],
                                     np.float32).reshape(-1, 3),
             'bbox': a.get('bbox', [0, 0, w, h])} for a in anns]
    else:
        model = init_pose_model(args.variant,
                                checkpoint=args.pose_checkpoint,
                                device=args.device)
        pose_results, _ = inference_top_down_pose_model(
            model, img, [{'bbox': [0, 0, w, h]}])
    lifter = build_lifter(pose_results[0]['keypoints'].shape[0],
                          args.checkpoint, args.device)
    # one image: the frame repeated over the receptive field
    res3d = inference_pose_lifter_model(
        lifter, [pose_results] * lifter.receptive_field, image_size=(w, h))
    os.makedirs(args.out_img_root, exist_ok=True)
    out = os.path.join(args.out_img_root,
                       '3d_' + os.path.basename(args.img) + '.png')
    vis_pose_result_3d(res3d, skeleton=DatasetInfo.load('h36m')
                       .skeleton_links, out_file=out)
    print(f'{len(res3d)} people lifted -> {out}')
    return res3d, out


if __name__ == '__main__':
    main()

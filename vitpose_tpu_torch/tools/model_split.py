"""Split a ViTPose+ (MoE) checkpoint into single-task checkpoints.

    python -m vitpose_tpu_torch.tools.model_split SOURCE.pth --out-dir DIR
        [--datasets coco aic mpii ap10k apt36k wholebody]

Counterpart of tools/model_split.py (the reference's tools/model_split.py):
for the i-th dataset, expert i's rows go back onto fc2, associate head i - 1
becomes `keypoint_head` (dataset 0 keeps the main head), and the final layer
is cut to the dataset's keypoint count. Each result is a plain ViTPose state
dict under the mmpose names, written as DIR/{dataset}.pth, which the
evaluation CLI and `init_pose_model` read with the single-dataset config.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..utils.torch_ckpt import load_torch_state_dict, merge_moe_expert

DATASET_KPTS = dict(coco=17, aic=14, mpii=16, ap10k=17, apt36k=17,
                    wholebody=133)


def split_one(sd, expert_id, num_kpts, depth):
    """The single-task state dict of dataset `expert_id` of a ViTPose+
    state dict `sd` (mmpose names)."""
    out = merge_moe_expert(sd, expert_id, depth)
    if expert_id > 0:
        prefix = f'associate_keypoint_heads.{expert_id - 1}.'
        renamed = {}
        for k, v in out.items():
            if k.startswith('associate_keypoint_heads.'):
                if k.startswith(prefix):
                    renamed['keypoint_head.' + k[len(prefix):]] = v
            elif not k.startswith('keypoint_head.'):
                renamed[k] = v
        out = renamed
    else:
        out = {k: v for k, v in out.items()
               if not k.startswith('associate_keypoint_heads.')}
    for k in list(out):
        if k.startswith('keypoint_head.final_layer.'):
            out[k] = out[k][:num_kpts].clone()
    return out


def main(argv=None):
    """Write one checkpoint per dataset; returns their paths."""
    ap = argparse.ArgumentParser(description='Split a ViTPose+ checkpoint '
                                 'into single-task checkpoints')
    ap.add_argument('source')
    ap.add_argument('--out-dir', required=True)
    ap.add_argument('--datasets', nargs='*',
                    default=['coco', 'aic', 'mpii', 'ap10k', 'apt36k',
                             'wholebody'])
    args = ap.parse_args(argv)

    sd = load_torch_state_dict(args.source)
    depth = 1 + max(int(k.split('.')[2]) for k in sd
                    if k.startswith('backbone.blocks.'))
    os.makedirs(args.out_dir, exist_ok=True)
    paths = []
    for i, name in enumerate(args.datasets):
        out = split_one(sd, i, DATASET_KPTS.get(name, 17), depth)
        path = os.path.join(args.out_dir, f'{name}.pth')
        torch.save(out, path)
        print(f'wrote {path} ({len(out)} tensors)')
        paths.append(path)
    return paths


if __name__ == '__main__':
    main()

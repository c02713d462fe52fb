"""End-to-end convergence check: train a small ViTPose-S from scratch on a
handful of COCO persons and watch AP rise through the whole stack (loader
-> preprocess on the card -> training -> flip-tested evaluation -> decode
-> COCO AP).

    python -m vitpose_tpu_torch.tools.analysis.overfit_sanity
        --ann ANN.json --img-root IMG_DIR/ [--epochs 1200]
        [--work-dir work_dirs/overfit_sanity_torch] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/overfit_sanity.py, whose
recipe `overfit_config` keeps (ViT width 128, depth 4, 4 heads at 128x96,
batch 12, UDP targets, layer-decay AdamW at 5e-3 with its decay epochs),
with the attention on K1 and K2 (`fused_attention`) so that the check runs
the kernels. The training set is also the val set, with ground-truth
boxes; the evaluation runs every 100 epochs and at the last one. JAX's
script reads the reference checkout's 12-person COCO fixture, which this
repository does not hold: the set is an argument here. Prints the last
evaluated AP beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os

from ...train.loop import train_model
from ._common import where


def overfit_config(ann, img_root, epochs=1200,
                   work_dir='work_dirs/overfit_sanity_torch'):
    """JAX's overfit recipe as a config dict on the set `ann`, `img_root`,
    for `epochs` epochs (its LR decay epochs kept), with the ViT's
    attention on the kernels."""
    data = dict(ann_file=ann, img_prefix=img_root)
    return dict(
        model=dict(variant='s', img_size=(128, 96), out_channels=17,
                   head='heatmap', flip_test=True, use_udp=True,
                   backbone_overrides=dict(embed_dim=128, depth=4,
                                           num_heads=4, drop_path_rate=0.0,
                                           fused_attention=True)),
        data=dict(dataset='coco', image_size=(96, 128), heatmap_size=(24, 32),
                  batch_size=12, canvas_size=640, num_workers=1,
                  train=dict(data),
                  val=dict(data, use_gt_bbox=True),
                  aug=dict(flip_prob=0.3, half_body_prob=0.0,
                           scale_factor=0.15, rot_factor=15.0,
                           rot_prob=0.3)),
        target=dict(encoding='UDP', sigma=2.0),
        optimizer=dict(base_lr=5e-3, warmup_iters=20,
                       decay_epochs=(900, 1100), total_epochs=epochs,
                       layer_decay_rate=0.9),
        runtime=dict(work_dir=work_dir, log_interval=50,
                     eval_interval=min(100, epochs), ckpt_interval=1000,
                     seed=0),
    )


def main(argv=None):
    """Train; print and return the evaluated epochs' stats."""
    ap = argparse.ArgumentParser(description='overfit a small ViTPose on a '
                                 'few persons (PyTorch port)')
    ap.add_argument('--ann', required=True)
    ap.add_argument('--img-root', required=True)
    ap.add_argument('--epochs', type=int, default=1200)
    ap.add_argument('--work-dir', default='work_dirs/overfit_sanity_torch')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    cfg = overfit_config(args.ann, args.img_root, args.epochs, args.work_dir)
    train_model(cfg, work_dir=args.work_dir, device=args.device)
    with open(os.path.join(args.work_dir, 'train.log.json')) as f:
        evals = [r for r in map(json.loads, f)
                 if r.get('mode') == 'epoch' and 'AP' in r]
    for r in evals:
        print(f"epoch {r['epoch'] + 1}: AP {r['AP']:.4f} "
              f"(AP50 {r['AP .5']:.4f}) {where(args.device)}")
    return evals


if __name__ == '__main__':
    main()

"""Speed of the bare network forward of a config's model.

    python -m vitpose_tpu_torch.tools.analysis.speed_test CONFIG
        [--bz 32] [--iters 20] [--warmup 3] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/speed_test.py (reference
tools/analysis/speed_test.py:25-63): the backbone and head forward of
random weights in eval mode on synthetic batches, with no flip test, no
decode and no pretrained weights; the config's dtype and attention (the
ViTs through K1 on the card). Each timed call gets another of four
distinct inputs and is timed between CUDA events on the card (the host
clock on the CPU); the median is printed beside the card's name and power
limit.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ._common import config_model, input_size, random_crops, timed_ms, where


def main(argv=None):
    """Print and return {'batch', 'ms', 'img_s', 'times_ms'}."""
    ap = argparse.ArgumentParser(description='benchmark the bare forward '
                                 '(PyTorch port)')
    ap.add_argument('config')
    ap.add_argument('--bz', type=int, default=32)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--warmup', type=int, default=3)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)

    _, model = config_model(args.config, args.device)
    ih, iw = input_size(model)
    xs = random_crops((args.bz, ih, iw, 3), 4, args.device)

    def fwd(x):
        with torch.inference_mode():
            model(x)

    timed_ms(fwd, xs, args.warmup, args.device)
    ms = timed_ms(fwd, xs, args.iters, args.device)
    med = float(np.median(ms))
    img_s = args.bz / med * 1e3
    print(f'batch={args.bz} iters={args.iters}: median {med:.3f} ms -> '
          f'{img_s:.1f} img/s (bare forward) {where(args.device)}')
    return {'batch': args.bz, 'ms': med, 'img_s': img_s, 'times_ms': ms}


if __name__ == '__main__':
    main()

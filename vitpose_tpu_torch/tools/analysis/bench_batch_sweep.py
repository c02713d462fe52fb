"""Batch-size sweep of the flip-test inference path.

    python -m vitpose_tpu_torch.tools.analysis.bench_batch_sweep
        [--batches 32 64 128 256] [--iters 5] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/bench_batch_sweep.py, which
runs when it is imported; this one runs from `main(argv)`. ViTPose-B 256x192
in bf16 with K1 (24 launches a batch), random weights from seed 0,
`models.infer` with the flip test (no decode). For each batch size: one
warm-up call, then `--iters` calls, each on another of three distinct
inputs and timed between CUDA events (the host clock on the CPU); the best
time is printed beside the card's name and power limit.

`--img-size H W` and `--backbone KEY=VALUE ...` (ViTConfig fields) shrink
the model for a run on the CPU.
"""
from __future__ import annotations

import argparse

import torch

from ...api.inference import _device
from ...data.dataset_info import DatasetInfo
from ...models.topdown import infer
from ._common import (Launches, backbone_options, device_randn, timed_ms,
                      vit_model, where)


def main(argv=None):
    """Print one line per batch size; returns {batch: {'ms', 'img_s',
    'launches'}}."""
    ap = argparse.ArgumentParser(description='batch-size sweep of the '
                                 'flip-test path (PyTorch port)')
    ap.add_argument('--batches', type=int, nargs='+',
                    default=[32, 64, 128, 256])
    ap.add_argument('--iters', type=int, default=5)
    ap.add_argument('--img-size', type=int, nargs=2, default=(256, 192))
    ap.add_argument('--backbone', nargs='*', default=[],
                    help='ViTConfig fields as KEY=VALUE (small CPU runs)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    hw = tuple(args.img_size)
    model = vit_model('b', dev, hw, 'bfloat16', True,
                      backbone_options(args.backbone))
    fi = torch.as_tensor(DatasetInfo.load('coco').flip_index, device=dev)

    def call(x):
        with torch.inference_mode():
            return infer(model, x, flip_index=fi)

    out = {}
    for b in args.batches:
        inputs = [device_randn((b, *hw, 3), i, dev) for i in range(3)]
        with Launches() as counted:
            timed_ms(call, inputs[:1], 1, dev)
            ms = min(timed_ms(call, inputs[1:] + inputs[:1], args.iters,
                              dev))
        print(f'batch {b}: {ms:.1f} ms -> {b / ms * 1e3:.0f} imgs/s '
              f'{where(dev)}', flush=True)
        out[b] = {'ms': ms, 'img_s': b / ms * 1e3,
                  'launches': counted.counts()}
        del inputs
    return out


if __name__ == '__main__':
    main()

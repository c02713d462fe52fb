"""K1 against the plain attention on the ViTPose-B bf16 flip-test inference
path.

    python -m vitpose_tpu_torch.tools.analysis.bench_fused_attention
        [--batch 64] [--iters 6] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/bench_fused_attention.py:
`models.infer` with the flip test (no decode) of ViTPose-B 256x192 in bf16,
random weights from seed 0, first with the model's plain attention
(fused=False: the einsums of models/vit.py `Attention`) and then with K1
(fused=True: `vitpose::attention_fwd`, csrc/attention_fwd.cu, 24 launches a
batch). JAX prints its compile seconds; this prints the first call's
seconds (the kernel build where it has not run yet, the first launches).
Then `--iters` calls, each on another of four distinct inputs and timed
between CUDA events (the host clock on the CPU); the best time is printed
beside the card's name and power limit.

`--img-size H W` and `--backbone KEY=VALUE ...` (ViTConfig fields) shrink
the model for a run on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from ...api.inference import _device
from ...data.dataset_info import DatasetInfo
from ...models.topdown import infer
from ._common import (Launches, backbone_options, device_randn, sync,
                      timed_ms, vit_model, where)


def run(fused, batch, iters, device, img_size=(256, 192), backbone=None):
    """One arm: print its first-call seconds and its best time; returns
    {'first_s', 'ms', 'img_s', 'launches'}."""
    model = vit_model('b', device, img_size, 'bfloat16', fused, backbone)
    fi = torch.as_tensor(DatasetInfo.load('coco').flip_index, device=device)
    base = device_randn((batch, *img_size, 3), 0, device)
    inputs = [base + i * 1e-6 for i in range(4)]

    def call(x):
        with torch.inference_mode():
            return infer(model, x, flip_index=fi)

    with Launches() as counted:
        t0 = time.perf_counter()
        call(inputs[0])
        sync(device)
        first_s = time.perf_counter() - t0
        print(f'fused={fused}: first call {first_s:.0f}s {where(device)}',
              flush=True)
        ms = min(timed_ms(call, inputs[1:] + inputs[:1], iters, device))
    print(f'fused={fused}: {ms:.1f} ms/batch -> {batch / ms * 1e3:.0f} '
          f'imgs/s (fliptest) {where(device)}', flush=True)
    return {'first_s': first_s, 'ms': ms, 'img_s': batch / ms * 1e3,
            'launches': counted.counts()}


def main(argv=None):
    """Run the plain arm, then the K1 arm; returns {'plain': ..., 'fused':
    ...} (see `run`)."""
    ap = argparse.ArgumentParser(description='K1 against the plain '
                                 'attention, ViTPose-B flip test (PyTorch '
                                 'port)')
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--iters', type=int, default=6)
    ap.add_argument('--img-size', type=int, nargs=2, default=(256, 192))
    ap.add_argument('--backbone', nargs='*', default=[],
                    help='ViTConfig fields as KEY=VALUE (small CPU runs)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    over = backbone_options(args.backbone)
    return {name: run(fused, args.batch, args.iters, dev,
                      tuple(args.img_size), over)
            for name, fused in (('plain', False), ('fused', True))}


if __name__ == '__main__':
    main()

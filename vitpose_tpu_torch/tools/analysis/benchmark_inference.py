"""Inference speed of a config's model: batches of crops through the
flip-tested forward.

    python -m vitpose_tpu_torch.tools.analysis.benchmark_inference CONFIG
        [--batch 64] [--iters 10] [--no-flip] [--group G] [--fast]
        [--int8 | --int8-qkv] [--latency] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/benchmark_inference.py
(reference tools/analysis/benchmark_inference.py): `models.infer` (the
flip test unless `--no-flip`; no decode) of random weights on batches of
random crops, each timed call on another of four distinct inputs, between
CUDA events on the card (the host clock on the CPU), the best time
printed beside the card's name and power limit.

  * `--fast`: bf16, K1 and the tanh GELU;
  * `--int8`: also W8A8 MLP products with static scales calibrated on two
    batches of 8 random crops on the card itself; `--int8-qkv`: the
    attention's qkv and proj products too (implies --int8);
  * `--group G`: G batches, back to back, per timed call (JAX scans them
    in one dispatch);
  * `--latency`: per-call latency at batches of 1, 8 and 32, p50 and p99
    by the host clock around a call that ends in a synchronise (what a
    server pays per request); `--group` is ignored.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ...data.dataset_info import DatasetInfo
from ...models.topdown import infer
from ...utils.quantize import (calibrate_act_scales, int8_serving_config,
                               rebuild)
from ._common import config_model, input_size, random_crops, timed_ms, where


def _latency_ms(fn, xs, calls, device):
    """Host-clock milliseconds of each of `calls` calls, each ending in a
    synchronise on the card."""
    cuda = torch.device(device).type == 'cuda'
    out = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn(xs[i % len(xs)])
        if cuda:
            torch.cuda.synchronize(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv=None):
    """Print and return the measured figures."""
    ap = argparse.ArgumentParser(description='inference speed (PyTorch '
                                 'port)')
    ap.add_argument('config')
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--iters', type=int, default=10)
    ap.add_argument('--no-flip', action='store_true')
    ap.add_argument('--group', type=int, default=1,
                    help='batches per timed call, back to back')
    ap.add_argument('--fast', action='store_true',
                    help='bf16 + K1 attention + tanh GELU')
    ap.add_argument('--int8', action='store_true',
                    help='W8A8 MLP with static scales calibrated on the '
                         'card (implies --fast)')
    ap.add_argument('--int8-qkv', action='store_true',
                    help='also quantise the attention qkv/proj (implies '
                         '--int8)')
    ap.add_argument('--latency', action='store_true',
                    help='per-call latency percentiles at batches 1, 8, 32')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    args.int8 = args.int8 or args.int8_qkv

    cfg, model = config_model(args.config, args.device,
                              fast=args.fast or args.int8)
    dev = torch.device(args.device)
    ih, iw = input_size(model)
    if args.int8:
        cal = random_crops((8, ih, iw, 3), 2, dev, seed=100)
        scales = calibrate_act_scales(model, cal, attn=args.int8_qkv)
        model = rebuild(model, int8_serving_config(model.cfg, scales,
                                                   qkv=args.int8_qkv))
    fi = None if args.no_flip else torch.as_tensor(
        DatasetInfo.load(cfg['data'].get('dataset', 'coco')).flip_index,
        device=dev)
    mode = 'flip test' if fi is not None else 'single forward'

    def run(x):
        with torch.inference_mode():
            return infer(model, x, flip_index=fi)

    if args.latency:
        rows = {}
        for lb in (1, 8, 32):
            xs = random_crops((lb, ih, iw, 3), 8, dev)
            run(xs[0])
            ts = sorted(_latency_ms(run, xs, max(16, args.iters), dev))
            p50 = ts[len(ts) // 2]
            p99 = ts[min(len(ts) - 1, int(len(ts) * 0.99))]
            rows[lb] = {'p50_ms': p50, 'p99_ms': p99}
            print(f'batch {lb:3d}: p50 {p50:7.2f} ms  p99 {p99:7.2f} ms per '
                  f'call ({mode}) {where(dev)}')
        return {'latency': rows}

    g = max(1, args.group)
    groups = [random_crops((args.batch, ih, iw, 3), g, dev, seed=s)
              for s in range(4)]

    def run_group(xs):
        for x in xs:
            run(x)

    t0 = time.perf_counter()
    run_group(groups[0])
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    print(f'first call (kernel builds, cuDNN plans) in '
          f'{time.perf_counter() - t0:.1f} s {where(dev)}')
    ms = timed_ms(run_group, groups[1:] + groups[:1], args.iters, dev)
    best = min(ms)
    img_s = args.batch * g / best * 1e3
    print(f'batch {args.batch} x group {g}: {best:.2f} ms -> {img_s:.1f} '
          f'imgs/s ({mode}; median {float(np.median(ms)):.2f} ms) '
          f'{where(dev)}')
    return {'batch': args.batch, 'group': g, 'ms': best,
            'median_ms': float(np.median(ms)), 'img_s': img_s,
            'times_ms': ms}


if __name__ == '__main__':
    main()

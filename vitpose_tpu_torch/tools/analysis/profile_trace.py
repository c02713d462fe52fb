"""A torch.profiler trace of the inference or the training step of a
config's model, written as a Chrome trace.

    python -m vitpose_tpu_torch.tools.analysis.profile_trace CONFIG
        --out trace.json [--mode infer|train] [--batch 64] [--steps 3]
        [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/profile_trace.py (a
jax.profiler trace). One step runs first outside the profile (kernel
builds, cuDNN plans); then `--steps` steps run under
torch.profiler.profile (CPU, and CUDA activity on the card), and the card
is synchronised before the profile stops, so that the trace holds the last
step's kernels. Open `--out` in Perfetto or chrome://tracing.

  * infer: `models.infer` with the flip test on a random batch;
  * train: the runner's train state for the config (`build_train_state`)
    and `make_train_step` on a random batch with zero heatmap targets, as
    JAX's tool feeds it.

Prints the device time of the busiest kernels per step beside the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import os
from collections import defaultdict

import torch

from ...api.inference import _device
from ...data.dataset_info import DatasetInfo
from ...models.topdown import infer
from ...train.loop import build_train_state
from ...train.step import make_train_step
from ...utils.config import load_config
from ._common import config_model, input_size, random_crops, where


def device_kernels(prof):
    """{kernel name: total device microseconds} of a profile's CUDA
    kernels (the profiler's raw events; annotations left out)."""
    out = defaultdict(float)
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()):
            out[e.name()] += e.duration_ns() / 1e3
    return dict(out)


def main(argv=None):
    """Write the trace; print and return {'out', 'kernels_us', 'steps'}."""
    ap = argparse.ArgumentParser(description='profile a step (PyTorch '
                                 'port)')
    ap.add_argument('config')
    ap.add_argument('--out', required=True,
                    help='the Chrome trace file to write')
    ap.add_argument('--mode', default='infer', choices=['infer', 'train'])
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)

    dev = _device(args.device)
    if args.mode == 'infer':
        cfg, model = config_model(args.config, dev)
        ih, iw = input_size(model)
        x = random_crops((args.batch, ih, iw, 3), 1, dev)[0]
        fi = torch.as_tensor(DatasetInfo.load(
            cfg['data'].get('dataset', 'coco')).flip_index, device=dev)

        def step():
            with torch.inference_mode():
                infer(model, x, flip_index=fi)
    else:
        cfg = load_config(args.config)
        state = build_train_state(cfg, 1000, dev)
        ih, iw = input_size(state.model)
        x = random_crops((args.batch, ih, iw, 3), 1, dev)[0]
        train_step = make_train_step(state.model)
        k = state.model.cfg.out_channels
        batch = {'imgs': x,
                 'target': torch.zeros(args.batch, k, ih // 4, iw // 4,
                                       device=dev),
                 'target_weight': torch.ones(args.batch, k, device=dev)}
        gen = torch.Generator(device=dev).manual_seed(0)

        def step():
            train_step(state, batch, gen)

    cuda = dev.type == 'cuda'
    step()
    if cuda:
        torch.cuda.synchronize(dev)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(args.steps):
            step()
        if cuda:
            # before the profile stops, or the last step's kernels are lost
            torch.cuda.synchronize(dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(args.out)
    kernels = device_kernels(prof)
    print(f'trace of {args.steps} {args.mode} steps at batch {args.batch} '
          f'written to {args.out}; the busiest kernels, device ms a step, '
          f'{where(dev)}:')
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        print(f'  {us / args.steps / 1e3:9.3f}  {name[:100]}')
    return {'out': args.out, 'kernels_us': kernels, 'steps': args.steps}


if __name__ == '__main__':
    main()

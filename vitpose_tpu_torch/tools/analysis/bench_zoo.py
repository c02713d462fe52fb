"""Serving throughput across the model zoo.

    python -m vitpose_tpu_torch.tools.analysis.bench_zoo [--iters 3]
        [--only vitpose_s,...] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/bench_zoo.py, with its
`ZOO` table (config, batch, group), the configs read in place from
vitpose_tpu/configs/. Each model is built as JAX's `build_fast` builds it:
bf16, K1 and the tanh GELU for the ViTs; the backbone's dtype set to bf16
for the CNNs whose backbone takes a dtype, read from its constructor
(`train.loop.backbone_takes`) where JAX catches the TypeError of one that
does not and measures it in f32 (every backbone of the table takes one).
Weights from seed 0.

`measure`: GROUP batches of BATCH f32 crops (drawn in bf16 on the card)
back to back per timed call, as JAX scans them in one dispatch (no CUDA
graph), each through the bare forward (no flip test, no decode; a
multi-stage model's last map) and the max over space; one warm-up call,
then ITERS calls on another of three distinct inputs, each between CUDA
events (the host clock on the CPU), the median kept. JAX syncs on a host
readback, which this does not copy. FLOPs per image: one forward of a batch
under FlopCounterMode (`get_flops.count_flops`: the products of the linear
layers, convolutions and attention, 2 per multiply-add), where JAX reads
XLA's cost analysis, which also counts the elementwise work. One JSON line
per model with JAX's keys and the card, then the markdown table, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from ...api.inference import _device
from ...train.loop import backbone_takes, build_model_from_cfg
from ...utils.config import load_config
from ._common import Launches, input_size, json_line, sync, timed_ms, where
from .get_flops import count_flops

CFG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       *(['..'] * 3), 'vitpose_tpu', 'configs')

# name -> (config, batch, group), JAX's table
ZOO = {
    'vitpose_s': ('coco/vitpose_s_coco_256x192.py', 256, 16),
    'vitpose_b': ('coco/vitpose_b_coco_256x192.py', 256, 16),
    'vitpose_l': ('coco/vitpose_l_coco_256x192.py', 256, 8),
    'vitpose_h': ('coco/vitpose_h_coco_256x192.py', 128, 8),
    'hrnet_w32': ('coco/hrnet_w32_coco_256x192.py', 256, 8),
    'hrnet_w48': ('coco/hrnet_w48_coco_256x192.py', 128, 8),
    'res50': ('coco/res50_coco_256x192.py', 256, 8),
    'litehrnet_18': ('coco/litehrnet_18_coco_256x192.py', 256, 8),
    'mobilenetv2': ('coco/mobilenetv2_coco_256x192.py', 256, 8),
    'hrformer_small': ('coco/hrformer_small_coco_256x192.py', 128, 8),
}


def fast_model_dict(path):
    """The config's model dict with JAX's `build_fast` overrides."""
    mcfg = dict(load_config(os.path.join(CFG_DIR, path))['model'])
    mcfg['dtype'] = 'bfloat16'
    over = dict(mcfg.get('backbone_overrides', {}))
    backbone_type = mcfg.get('backbone_type', 'vit')
    if backbone_type == 'vit':
        over.update(fused_attention=True, gelu_approx=True)
    elif backbone_takes(backbone_type, 'dtype'):
        over['dtype'] = 'bfloat16'
    else:
        # no dtype knob: JAX measures this backbone in f32
        over.pop('dtype', None)
    mcfg['backbone_overrides'] = over
    return mcfg


def build_fast(path, device):
    """The fast model of a ZOO config, in eval mode on `device`."""
    model = build_model_from_cfg(fast_model_dict(path))
    return model.to(device).eval()


def measure(model, batch, group, iters, device):
    """(img/s, FLOPs per image) of the bare forward, GROUP batches per
    timed call."""
    ih, iw = input_size(model)
    gen = torch.Generator(device=device).manual_seed(0)
    inputs = [torch.randn((group, batch, ih, iw, 3), generator=gen,
                          device=device, dtype=torch.bfloat16).float()
              for _ in range(3)]

    def fwd(xs):
        outs = []
        with torch.inference_mode():
            for x in xs:
                hm = model(x)
                if isinstance(hm, (list, tuple)):
                    hm = hm[-1]
                outs.append(hm.amax(dim=(2, 3)))
        return outs

    fwd(inputs[0])                         # kernel builds, cuDNN plans
    sync(device)
    flops = count_flops(model, inputs[0][0])[0] / batch or None
    ms = timed_ms(fwd, inputs[1:] + inputs[:1], iters, device)
    dt = sorted(ms)[len(ms) // 2]
    return group * batch / dt * 1e3, flops


def main(argv=None):
    """Print one JSON line per model and the table; returns {'rows': [...],
    'launches': {model: {'k1', 'k2'}}, 'build_s': {model: s}}."""
    ap = argparse.ArgumentParser(description='zoo serving throughput '
                                 '(PyTorch port)')
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--only', type=str, default='')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    names = [n for n in args.only.split(',') if n] or list(ZOO)

    rows, launches, build_s = [], {}, {}
    for name in names:
        path, batch, group = ZOO[name]
        t0 = time.perf_counter()
        model = build_fast(path, dev)
        build_s[name] = time.perf_counter() - t0
        with Launches() as counted:
            imgs_s, flops = measure(model, batch, group, args.iters, dev)
        launches[name] = counted.counts()
        rows.append(json_line(
            {'model': name, 'imgs_per_sec': round(imgs_s, 1),
             'batch': batch, 'group': group,
             'gflops_per_img': round(flops / 1e9, 2) if flops else None,
             'tflops_per_sec': (round(imgs_s * flops / 1e12, 1)
                                if flops else None)}, dev))
        del model
        if dev.type == 'cuda':
            torch.cuda.empty_cache()

    # FlopCounterMode counts the products only; img/s is the metric, the
    # FLOP columns are context
    print('\n| model | batch | imgs/s/card | GFLOP/img (FlopCounterMode) '
          '| TFLOP/s |')
    print('|---|---|---|---|---|')
    for r in rows:
        print(f"| {r['model']} | {r['batch']}x{r['group']} | "
              f"{r['imgs_per_sec']} | {r['gflops_per_img'] or '-'} | "
              f"{r['tflops_per_sec'] or '-'} |")
    print(f'(figures {where(dev)})', flush=True)
    return {'rows': rows, 'launches': launches, 'build_s': build_s}


if __name__ == '__main__':
    main()

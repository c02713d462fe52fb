"""What the analysis tools share: the config's model on its device, seeded
inputs on the card, timing that ends on the card's clock, the bench tools'
JSON lines and their count of the attention kernels' launches."""
from __future__ import annotations

import ast
import collections
import dataclasses
import functools
import json
import time

import torch

from ...api.inference import _device
from ...models.topdown import TopDownModel, make_config
from ...ops.attention import fused_attention, fused_attention_bwd
from ...train.loop import build_model_from_cfg
from ...utils.config import apply_options, load_config
from ...utils.env import card_line


def config_model(config, device, options=(), fast=False):
    """(config dict, model in eval mode on `device`): the config (with the
    dotted `options`) and its model with weights drawn from seed 0; `fast`
    sets the ViT backbone to bf16 with K1 and the tanh GELU (JAX's
    --fast)."""
    dev = _device(device)
    cfg = apply_options(load_config(config), list(options))
    model = build_model_from_cfg(cfg['model'],
                                 torch.Generator().manual_seed(0))
    if fast:
        from ...utils.quantize import rebuild
        model = rebuild(model, dataclasses.replace(
            model.cfg, backbone=dataclasses.replace(
                model.cfg.backbone, dtype='bfloat16', fused_attention=True,
                gelu_approx=True)))
    return cfg, model.to(dev).eval()


def input_size(model, default=(256, 192)):
    """The model's crop (h, w)."""
    try:
        return tuple(model.cfg.backbone.img_size)
    except AttributeError:
        return default


def random_crops(shape, count, device, seed=0):
    """`count` distinct standard-normal tensors of `shape`, drawn on the
    CPU from `seed` and moved to `device` (so the card and the CPU get the
    same inputs)."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device)
            for _ in range(count)]


def timed_ms(fn, inputs, iters, device):
    """Milliseconds of each of `iters` calls fn(inputs[i % len(inputs)])
    (a distinct input each call): on CUDA between torch.cuda.Events around
    the call, waited for; on the CPU by the host clock."""
    dev = torch.device(device)
    out = []
    for i in range(iters):
        x = inputs[i % len(inputs)]
        if dev.type == 'cuda':
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(x)
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(x)
            out.append((time.perf_counter() - t0) * 1e3)
    return out


@functools.lru_cache(maxsize=None)
def _card(device):
    return card_line(device)


def where(device):
    """'on <card name, power limit>' for the figures a tool prints."""
    return f'on {_card(torch.device(device))}'


def json_line(rec, device):
    """Print `rec` as one JSON line, the card's name and power limit after
    its figures under 'card'; returns rec."""
    print(json.dumps({**rec, 'card': _card(torch.device(device))}),
          flush=True)
    return rec


def device_randn(shape, seed, device, dtype=torch.float32):
    """A standard-normal tensor drawn on `device` itself from `seed` (the
    bench tools' inputs, too large to draw on the host and copy)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def sync(device):
    """Wait for the card (nothing on the CPU)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def timeit(name, fn, inputs, work_per_iter, device, unit='imgs/sec',
           warmup=1, iters=3, extra=None):
    """The JAX bench tools' `timeit` (tools/analysis/bench_breakdown.py:21):
    fn(inputs[i]) for `warmup` calls, then `iters` timed calls on the next
    inputs, each between CUDA events and waited for (timed_ms); prints
    {exp, per_sec, ms_per_iter, unit} and the keys of `extra` as one JSON
    line and returns it."""
    for i in range(warmup):
        fn(inputs[i])
    sync(device)
    ms = sum(timed_ms(fn, inputs[warmup:warmup + iters], iters, device))
    return json_line({'exp': name,
                      'per_sec': round(work_per_iter * iters / ms * 1e3, 2),
                      'ms_per_iter': round(ms / iters, 2), 'unit': unit,
                      **(extra or {})}, device)


class Launches:
    """K1 and K2 launches inside a `with` block: `k1`, `k2` and `shapes`,
    a Counter of (kernel, shape, dtype) launched at, from the wrappers'
    own counts (ops.attention), read on exit."""

    def __enter__(self):
        self._start = (fused_attention.launches,
                       fused_attention_bwd.launches,
                       self._shapes())
        return self

    def __exit__(self, *exc):
        k1, k2, shapes = self._start
        self.k1 = fused_attention.launches - k1
        self.k2 = fused_attention_bwd.launches - k2
        self.shapes = self._shapes() - shapes
        return False

    @staticmethod
    def _shapes():
        return collections.Counter(
            {(name, shape, str(dtype).replace('torch.', '')): n
             for name, fn in (('K1', fused_attention),
                              ('K2', fused_attention_bwd))
             for (shape, dtype), n in fn.shapes.items()})

    def counts(self):
        return {'k1': self.k1, 'k2': self.k2}


def backbone_options(pairs):
    """KEY=VALUE strings (Python literals) -> a dict of ViTConfig fields,
    e.g. ['embed_dim=32', 'depth=2'] for a small CPU run."""
    out = {}
    for pair in pairs or ():
        key, _, value = pair.partition('=')
        try:
            out[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            out[key] = value
    return out


def vit_model(variant, device, img_size=(256, 192), dtype='bfloat16',
              fused=True, backbone=None, **make_kw):
    """ViTPose-`variant` with the classic head and 17 joints (make_config),
    the ViT in `dtype` with K1 on the card when `fused`, its fields
    `backbone` over the variant's; weights drawn from seed 0, in eval mode
    on `device`."""
    cfg = make_config(variant, img_size=tuple(img_size), out_channels=17,
                      dtype=dtype, **make_kw)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, fused_attention=fused, **(backbone or {})))
    model = TopDownModel(cfg, generator=torch.Generator().manual_seed(0))
    return model.to(_device(device)).eval()

"""What the analysis tools share: the config's model on its device, seeded
inputs on the card, and timing that ends on the card's clock."""
from __future__ import annotations

import dataclasses
import time

import torch

from ...api.inference import _device
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


def where(device):
    """'on <card name, power limit>' for the figures a tool prints."""
    return f'on {card_line(device)}'

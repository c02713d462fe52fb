"""AdamW with ViT layer-wise lr decay, as torch.optim.AdamW parameter groups
and a LambdaLR schedule.

Counterpart of vitpose_tpu/train/optim.py:26-121 and :165-205
(`OptimConfig`, `layer_id_for_path`, `make_lr_schedule`,
`layer_decay_adamw`, `make_freeze_mask`, `freeze_tx`), on the port's
parameter names:

  * layer id: `backbone.pos_embed` / `backbone.patch_embed.*` -> 0,
    `backbone.blocks.{i}.*` -> i + 1, everything else (last_norm, the
    head) -> depth + 1;
  * lr scale = layer_decay_rate ** (depth + 1 - layer id);
  * no weight decay for tensors with ndim <= 1, LayerNorm weights,
    biases and pos_embed (flax's LayerNorm scale is 1-D, which JAX never
    decays, where the ContextBlock's LayerNorm([planes, 1, 1]) keeps
    mmpose's 3-D shape).

The optax chain clips, then Adam, then decoupled decay, then lr times the
layer scale; torch's AdamW with a group lr of lr * scale and weight_decay
`weight_decay` is the same update, p <- p - lr*scale * (m_hat / (sqrt(v_hat)
+ eps) + wd * p), eps 1e-8 in both. The global-norm clip is applied by the
train state before the step, as optax.clip_by_global_norm does it: grads
are scaled by max_norm / norm only when norm >= max_norm (torch's
clip_grad_norm_ would use max_norm / (norm + 1e-6)).

Freezing (`freeze_tx` around the optax chain in JAX) leaves the frozen
parameters out of the optimizer: they get no update and no weight decay, and
the clip inside the chain sees only the trainable gradients, as optax's
multi_transform gives it. They still get gradients, which count in the
logged `grad_norm` (TrainState.apply_gradients).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    base_lr: float = 5e-4
    weight_decay: float = 0.1
    layer_decay_rate: float = 0.75
    num_layers: int = 12                   # transformer depth
    betas: tuple = (0.9, 0.999)
    warmup_iters: int = 500
    warmup_ratio: float = 1e-3
    decay_epochs: Sequence[int] = (170, 200)
    decay_factor: float = 0.1
    total_epochs: int = 210
    grad_clip_norm: float = 1.0


def layer_id_for_path(name: str, depth: int) -> int:
    """ViT layer id of a parameter, by its name in TopDownModel."""
    keys = name.split('.')
    if any(k in ('pos_embed', 'cls_token', 'mask_token', 'patch_embed')
           for k in keys):
        return 0
    for a, b in zip(keys, keys[1:]):
        if a == 'blocks':
            return int(b) + 1
    return depth + 1


def _decays(name: str, param) -> bool:
    return not (param.ndim <= 1 or name.endswith('.bias')
                or 'pos_embed' in name)


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int,
                     policy: str = 'step'):
    """count -> lr: linear warmup from warmup_ratio * base_lr over
    warmup_iters, then 'step' (x decay_factor at each of decay_epochs, from
    the update whose count reaches the boundary, as optax's
    piecewise_constant_schedule) or 'cosine' (to 0 over the post-warmup part
    of total_epochs)."""
    if policy not in ('step', 'cosine'):
        raise ValueError(f"lr policy {policy!r}: expected 'step' or 'cosine'")
    boundaries = [e * steps_per_epoch for e in cfg.decay_epochs]
    total = cfg.total_epochs * steps_per_epoch

    def schedule(count):
        if count < cfg.warmup_iters:
            return cfg.base_lr * (cfg.warmup_ratio + (1.0 - cfg.warmup_ratio)
                                  * count / cfg.warmup_iters)
        if policy == 'cosine':
            frac = min(max((count - cfg.warmup_iters)
                           / max(total - cfg.warmup_iters, 1), 0.0), 1.0)
            return cfg.base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))
        return cfg.base_lr * cfg.decay_factor ** sum(count >= b
                                                     for b in boundaries)

    return schedule


def make_freeze_mask(model, frozen_stages=-1, freeze_attn=False,
                     freeze_ffn=False) -> dict:
    """{parameter name: trainable} for the ViT backbone's freezing options
    (reference vit.py:249 `_freeze_stages`, JAX optim.py:165-196).

    frozen_stages >= 0 freezes patch_embed and blocks 1..frozen_stages (the
    reference's quirk of starting at block 1 is kept); freeze_attn freezes
    every block's attn and norm1; freeze_ffn freezes pos_embed,
    patch_embed, and every block's mlp and norm2.
    """
    def trainable(name):
        keys = name.split('.')
        if frozen_stages >= 0:
            if 'patch_embed' in keys:
                return False
            m = re.search(r'blocks\.(\d+)', name)
            if m and 1 <= int(m.group(1)) <= frozen_stages:
                return False
        if freeze_attn and ('attn' in keys or 'norm1' in keys):
            return False
        if freeze_ffn and any(k in keys for k in ('pos_embed', 'patch_embed',
                                                  'mlp', 'norm2')):
            return False
        return True

    return {name: trainable(name) for name, _ in model.named_parameters()}


def layer_decay_adamw(model, cfg: OptimConfig, steps_per_epoch: int = 1000,
                      policy: str = 'step',
                      trainable: Optional[dict] = None):
    """(AdamW, LambdaLR) over `model`'s parameters: one group per
    (layer id, decay) pair with lr = schedule(count) * scale. Step the
    scheduler after each optimizer step, so update t uses schedule(t).
    `trainable` ({name: bool}, from make_freeze_mask) leaves the frozen
    parameters out of every group (JAX `freeze_tx`).

    On CUDA the optimizer is `capturable`: its step counts live on the card,
    so a step reads nothing back to the host. (torch's fused AdamW was tried
    and left: its CUDA update differs from the CPU one ten times more than
    this one does; PERF.md.)
    """
    depth = cfg.num_layers
    norm_weights = {id(m.weight) for m in model.modules()
                    if isinstance(m, torch.nn.LayerNorm)
                    and m.weight is not None}
    groups = {}
    for name, p in model.named_parameters():
        if not p.requires_grad or (trainable and not trainable[name]):
            continue
        lid = layer_id_for_path(name, depth)
        decay = id(p) not in norm_weights and _decays(name, p)
        if (lid, decay) not in groups:
            groups[lid, decay] = {
                'params': [],
                'lr_scale': cfg.layer_decay_rate ** (depth + 1 - lid),
                'weight_decay': cfg.weight_decay if decay else 0.0}
        groups[lid, decay]['params'].append(p)
    param_groups = [groups[key] for key in sorted(groups)]
    for g in param_groups:
        g['lr'] = cfg.base_lr * g['lr_scale']
    cuda = next(model.parameters()).device.type == 'cuda'
    opt = torch.optim.AdamW(param_groups, lr=cfg.base_lr, betas=cfg.betas,
                            eps=1e-8, weight_decay=cfg.weight_decay,
                            capturable=cuda)
    schedule = make_lr_schedule(cfg, steps_per_epoch, policy)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / cfg.base_lr)
    return opt, sched

"""Config-driven model construction.

Counterpart of the `vit` branch of vitpose_tpu/train/loop.py:84-101
`build_model_from_cfg`. The rest of that module (the training runner with
loader, checkpoints and periodic evaluation) is not ported yet (ROADMAP.md
queue 1 item 7).
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.topdown import TopDownConfig, TopDownModel, make_config


def topdown_config(mcfg: dict) -> TopDownConfig:
    """A config file's `model` dict -> TopDownConfig (`img_size` is (h, w)
    there). Only the plain-ViT top-down model is ported: another `family`
    or `backbone_type` raises."""
    mcfg = dict(mcfg)
    family = mcfg.pop('family', 'topdown')
    if family != 'topdown':
        raise NotImplementedError(
            f'model family {family!r} is not ported yet (ROADMAP.md queue 1 '
            'item 12)')
    backbone_type = mcfg.pop('backbone_type', 'vit')
    if backbone_type != 'vit':
        raise NotImplementedError(
            f'backbone_type {backbone_type!r} is not ported yet (ROADMAP.md '
            'queue 1 item 12); only the plain ViT is')
    variant = mcfg.pop('variant', 'b')
    hw = mcfg.pop('img_size', (256, 192))
    bb_over = mcfg.pop('backbone_overrides', None)
    cfg = make_config(variant, img_size=tuple(hw), **mcfg)
    if bb_over:
        cfg = dataclasses.replace(
            cfg, backbone=dataclasses.replace(cfg.backbone, **bb_over))
    return cfg


def build_model_from_cfg(mcfg: dict, generator=None) -> TopDownModel:
    """A config file's `model` dict -> TopDownModel with random weights,
    drawn on the CPU from `generator` (default: a torch.Generator seeded
    with 0, as in `init_pose_model`)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return TopDownModel(topdown_config(mcfg), generator=generator)

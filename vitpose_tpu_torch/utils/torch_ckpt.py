"""Load-time adaptation of released ViTPose/MAE .pth weights to a model's
input geometry.

The port's own copy of vitpose_tpu/utils/torch_ckpt.py:79-134, which
reproduces the reference loader (mmcv_custom/checkpoint.py:312
`load_checkpoint`):
  * a 14x14 patch-embed kernel is zero-padded (or interpolated) to the
    model's patch size;
  * the position embedding is regridded bicubically (torch
    `F.interpolate`, align_corners=False) to the model's token grid,
    keeping the cls-token slot.
The port keeps the mmpose parameter names, so no name map is needed. Both
functions work on host numpy arrays, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _interpolate_pos_embed(pos, num_patches, grid_hw):
    """Bicubic-regrid [1, L, C] pos embed to [1, num_patches + 1, C] (cls
    slot + grid). Handles cls-bearing, cls-less, and distilled (2 prefix
    tokens) sources; the prefix size is inferred as the smallest e in
    {1, 0, 2} leaving a square source grid."""
    l = pos.shape[1]
    c = pos.shape[-1]
    if l == num_patches + 1:
        return pos
    if l == num_patches:            # cls-less source matching the grid:
        zero_cls = np.zeros((1, 1, c), pos.dtype)
        return np.concatenate([zero_cls, pos], axis=1)
    extra = next((e for e in (1, 0, 2)
                  if int(round((l - e) ** 0.5)) ** 2 == l - e), None)
    if extra is None:
        raise ValueError(
            f'cannot infer a square source grid from pos_embed length {l}')
    cls_tok = (pos[:, :1] if extra
               else np.zeros((1, 1, c), pos.dtype))
    patch_pos = pos[:, extra:]
    side = int(round(patch_pos.shape[1] ** 0.5))
    h, w = grid_hw
    t = torch.from_numpy(np.ascontiguousarray(
        patch_pos.reshape(1, side, side, -1).transpose(0, 3, 1, 2)))
    t = F.interpolate(t, size=(h, w), mode='bicubic', align_corners=False)
    new_patch = t.permute(0, 2, 3, 1).reshape(1, h * w, -1).numpy()
    return np.concatenate([cls_tok, new_patch], axis=1)


def _adapt_patch_embed(kernel, patch_size, mode='pad'):
    """Adapt a conv kernel [D, 3, k, k] to patch_size (reference
    checkpoint.py:360-374 `patch_padding` modes).

    mode='pad' (the reference default) zero-pads asymmetrically
    (padding_l = diff//2, padding_r = diff - padding_l), e.g. the MAE 14x14
    kernel gets 1px each side to reach 16x16; 'bilinear'/'bicubic'
    interpolate instead. Kernels LARGER than patch_size always interpolate
    (negative padding would crop)."""
    k = kernel.shape[-1]
    if k == patch_size:
        return kernel
    if mode == 'pad' and k < patch_size:
        diff = patch_size - k
        pl = diff // 2
        pr = diff - pl
        return np.pad(kernel, [(0, 0), (0, 0), (pl, pr), (pl, pr)])
    t = torch.from_numpy(kernel)
    t = F.interpolate(t, size=(patch_size, patch_size),
                      mode='bilinear' if mode == 'bilinear' else 'bicubic',
                      align_corners=False)
    return t.numpy()


def adapt_state_dict(sd, backbone_cfg):
    """Regrid a top-down state dict's pos embed and pad its patch kernel to
    `backbone_cfg` (a ViTConfig), as the JAX package's
    `convert_topdown_checkpoint` does; other entries are kept as they are.
    Returns a new dict of CPU tensors."""
    sd = dict(sd)
    key = 'backbone.patch_embed.proj.weight'
    if key in sd:
        sd[key] = torch.from_numpy(_adapt_patch_embed(
            _numpy(sd[key]), backbone_cfg.patch_size))
    key = 'backbone.pos_embed'
    if key in sd:
        sd[key] = torch.from_numpy(_interpolate_pos_embed(
            _numpy(sd[key]), backbone_cfg.num_patches, backbone_cfg.grid))
    return sd


def _numpy(t):
    t = torch.as_tensor(t).detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

"""Reading released ViTPose/MAE .pth weights and adapting them to a model's
input geometry.

The port's own copy of vitpose_tpu/utils/torch_ckpt.py:36-170 and :320
(`load_torch_state_dict`, `split_moe_experts`, `merge_moe_expert`,
`convert_backbone_checkpoint`), which reproduce the reference loader
(mmcv_custom/checkpoint.py:312 `load_checkpoint`):
  * {'state_dict' | 'model' | 'module'} containers are opened and 'module.'
    and MoBY 'encoder.' prefixes taken off;
  * a 14x14 patch-embed kernel is zero-padded (or interpolated) to the
    model's patch size;
  * the position embedding is regridded bicubically (torch
    `F.interpolate`, align_corners=False) to the model's token grid,
    keeping the cls-token slot;
  * a dense backbone gives a ViTPose+ backbone its experts: each takes the
    last `part_dim` rows of fc2, and fc2 keeps the rest.
The port keeps the mmpose parameter names, so no name map is needed. The
regrid and the pad work on host numpy arrays, as in the JAX package.
`checkpoint_state_dict` also reads the JAX package's .npz exports, and
routes a CNN model's checkpoint by its backbone type: a .pth in mmpose names
as it is, an .npz through `cnn_state_dict_from_flax` (the counterpart of
vitpose_tpu/api/inference.py:97-120 and
vitpose_tpu/utils/cnn_ckpt.py:872 `convert_generic_topdown_checkpoint`),
and a bottom-up model's .npz through `bottomup_state_dict_from_flax`.
"""
from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from .convert import (bottomup_state_dict_from_flax,
                      cnn_state_dict_from_flax,
                      interhand3d_state_dict_from_flax,
                      mesh_state_dict_from_flax,
                      pose_lifter_state_dict_from_flax,
                      posewarper_state_dict_from_flax, state_dict_from_flax,
                      voxelpose_state_dict_from_flax)
from .checkpoint import load_params_npz

# the backbone entries the JAX package's `convert_backbone` carries
# (vitpose_tpu/utils/torch_ckpt.py:182-226); the rest of an MAE checkpoint
# (cls_token, its final `norm`, a decoder) stays behind
_BACKBONE_KEY = re.compile(
    r'(patch_embed\.proj|blocks\.\d+\.(norm1|norm2|attn\.qkv|attn\.proj|'
    r'mlp\.fc1|mlp\.fc2|mlp\.experts\.\d+)|last_norm)\.(weight|bias)|'
    r'pos_embed')


def load_torch_state_dict(path):
    """A .pth file -> {name: CPU tensor}: read with weights_only=True, out
    of a {'state_dict' | 'model' | 'module'} container, without a 'module.'
    prefix on every key or the MoBY 'encoder.' prefix."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    for key in ('state_dict', 'model', 'module'):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
            break
    if all(k.startswith('module.') for k in sd):
        sd = {k[len('module.'):]: v for k, v in sd.items()}
    if sorted(sd)[0].startswith('encoder.'):
        sd = {k[len('encoder.'):]: v for k, v in sd.items()
              if k.startswith('encoder.')}
    return sd


def checkpoint_state_dict(checkpoint: str, backbone_cfg,
                          backbone_type: str = 'vit',
                          family: str = 'topdown') -> dict:
    """The state dict of a whole-model checkpoint file for a model whose
    backbone is `backbone_cfg` (a ViTConfig) or, for a CNN, of type
    `backbone_type`: an .npz written by the JAX package, or a .pth, adapted
    to a ViT backbone's geometry (a CNN's loads as it is: no position
    embedding to regrid). A bottom-up model's .npz (`family` 'bottomup')
    holds JAX's {'backbone', 'head'} variables, as an InterHand3D's
    ('interhand3d') and a mesh's ('mesh'; its loop's {'gen', 'disc'}) do;
    a PoseWarper's ('posewarper') and a pose lifter's ('pose_lifter') one
    tree of each; a VoxelPose's ('voxelpose') {'center', 'pose'}."""
    if checkpoint.endswith('.npz'):
        variables = load_params_npz(checkpoint)
        if family == 'bottomup':
            return bottomup_state_dict_from_flax(variables, backbone_type)
        if family == 'posewarper':
            return posewarper_state_dict_from_flax(variables, backbone_type)
        if family == 'pose_lifter':
            return pose_lifter_state_dict_from_flax(variables)
        if family == 'interhand3d':
            return interhand3d_state_dict_from_flax(variables, backbone_type)
        if family == 'mesh':
            return mesh_state_dict_from_flax(variables, backbone_type)
        if family == 'voxelpose':
            return voxelpose_state_dict_from_flax(variables)
        if backbone_type == 'vit':
            return state_dict_from_flax(variables)
        return cnn_state_dict_from_flax(variables, backbone_type)
    if checkpoint.endswith('.pth'):
        sd = load_torch_state_dict(checkpoint)
        return (adapt_state_dict(sd, backbone_cfg) if backbone_type == 'vit'
                else sd)
    raise ValueError(f'unsupported checkpoint {checkpoint!r}: expected .npz '
                     '(JAX export) or .pth')


def convert_backbone_checkpoint(path, backbone_cfg):
    """A backbone-only (MAE pretraining) .pth, its keys without the
    'backbone.' prefix -> the ViT state dict entries it holds, its patch
    kernel padded and its pos embed regridded to `backbone_cfg` (a
    ViTConfig), and for a ViTPose+ backbone its fc2 split into experts
    (`split_moe_experts`). Raises if it holds none."""
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if _BACKBONE_KEY.fullmatch(k)}
    if not sd:
        raise ValueError(f'{path} holds no ViT backbone entries (expected '
                         "names such as 'blocks.0.attn.qkv.weight')")
    sd = adapt_state_dict({f'backbone.{k}': v for k, v in sd.items()},
                          backbone_cfg)
    sd = {k[len('backbone.'):]: v for k, v in sd.items()}
    if backbone_cfg.num_experts:
        sd = split_moe_experts(sd, backbone_cfg.num_experts,
                               backbone_cfg.part_dim, backbone_cfg.depth)
    return sd


def split_moe_experts(sd, num_experts, part_dim, depth):
    """Give a ViTPose+ backbone its experts from a dense fc2 (reference
    checkpoint.py:396-404): each expert gets the LAST `part_dim` output
    rows of fc2, and fc2 keeps the rest. Keys without the 'backbone.'
    prefix; returns a new dict."""
    sd = dict(sd)
    for i in range(depth):
        wk = f'blocks.{i}.mlp.fc2.weight'
        bk = f'blocks.{i}.mlp.fc2.bias'
        if wk not in sd or sd[wk].shape[0] <= part_dim:
            continue
        w, b = sd[wk], sd[bk]
        for e in range(num_experts):
            sd[f'blocks.{i}.mlp.experts.{e}.weight'] = w[-part_dim:].clone()
            sd[f'blocks.{i}.mlp.experts.{e}.bias'] = b[-part_dim:].clone()
        sd[wk] = w[:-part_dim].clone()
        sd[bk] = b[:-part_dim].clone()
    return sd


def merge_moe_expert(sd, expert_id, depth):
    """The inverse of the split for one task: expert `expert_id`'s rows
    appended to fc2 again, and every expert dropped (reference
    tools/model_split.py:38-43). Keys with the 'backbone.' prefix; returns
    a new dict."""
    sd = dict(sd)
    for i in range(depth):
        b = f'backbone.blocks.{i}.mlp.'
        if b + 'fc2.weight' in sd and f'{b}experts.{expert_id}.weight' in sd:
            for p in ('weight', 'bias'):
                sd[f'{b}fc2.{p}'] = torch.cat(
                    [sd[f'{b}fc2.{p}'], sd[f'{b}experts.{expert_id}.{p}']])
    return {k: v for k, v in sd.items() if '.experts.' not in k}


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

"""Post-training int8 calibration for the serving path.

Counterpart of vitpose_tpu/utils/quantize.py (`calibrate_act_scales`,
`int8_serving_config`, `first_last_skip`, `calibrate_from_loader`): run the
float model over a few calibration batches, record the absmax of every
int8 product's input, and bake those static scales into
`ViTConfig.int8_act_scales`, which `models.vit.Int8Linear` reads.

Where flax captures module outputs (`capture_intermediates`, the sown
`proj_in`), the port hooks the float model's modules:
  * fc1's scale: `norm2`'s output; qkv's: `norm1`'s. The port's LayerNorm
    computes in f32 and the block casts its output to the compute dtype;
    the hook applies the same cast, so it reads the value flax's `norm1` /
    `norm2` return;
  * fc2's scale: gelu(fc1's output), with the model's `gelu_approx`;
  * proj's scale: proj's input, the tensor JAX sows as `proj_in`.
Blocks are indexed by their place in `backbone.blocks`.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..models.topdown import TopDownModel, forward
from ..models.vit import compute_dtype
from ..ops.geometry import affine_matrix, udp_warp_matrix
from ..ops.warp import warp_affine_batch


def calibrate_act_scales(model: TopDownModel, batches: Sequence,
                         margin: float = 1.0, attn: bool = False):
    """Per-block absmax of the int8 products' inputs over `batches`
    (normalised NHWC crops, numpy or tensors), each times `margin`: one
    (fc1_in, fc2_in) pair per block, or with ``attn=True`` (fc1_in, fc2_in,
    qkv_in, proj_in), ready for `int8_serving_config`. The model runs in
    eval mode without the flip test, on its own device."""
    bb = model.backbone
    dtype = compute_dtype(bb.cfg.dtype)
    approx = 'tanh' if bb.cfg.gelu_approx else 'none'
    dev = next(model.parameters()).device
    stats = {k: {} for k in ('fc1', 'fc2', 'qkv', 'proj')}

    def bump(kind, idx, t):
        val = float(t.abs().amax())
        stats[kind][idx] = max(stats[kind].get(idx, 0.0), val)

    hooks = []
    for i, blk in enumerate(bb.blocks):
        hooks += [
            blk.norm2.register_forward_hook(
                lambda m, a, out, i=i: bump('fc1', i, out.to(dtype))),
            blk.mlp.fc1.register_forward_hook(
                lambda m, a, out, i=i: bump(
                    'fc2', i, F.gelu(out, approximate=approx)))]
        if attn:
            hooks += [
                blk.norm1.register_forward_hook(
                    lambda m, a, out, i=i: bump('qkv', i, out.to(dtype))),
                blk.attn.proj.register_forward_pre_hook(
                    lambda m, a, i=i: bump('proj', i, a[0]))]
    try:
        with torch.inference_mode():
            for batch in batches:
                x = torch.as_tensor(np.asarray(batch, np.float32)
                                    if not torch.is_tensor(batch) else batch)
                forward(model, x.to(dev), train=False)
    finally:
        for h in hooks:
            h.remove()
    kinds = ('fc1', 'fc2') + (('qkv', 'proj') if attn else ())
    depth = bb.cfg.depth
    missing = [(k, i) for k in kinds for i in range(depth)
               if i not in stats[k]]
    if missing:
        raise RuntimeError(f'calibration captured no stats for {missing}')
    return tuple(tuple(stats[k][i] * margin for k in kinds)
                 for i in range(depth))


def int8_serving_config(cfg, scales, qkv: bool = False,
                        skip_blocks: Sequence[int] = ()):
    """TopDownConfig -> the same config with the int8 serving products on:
    the MLP's, and with ``qkv=True`` attention's qkv and proj too (which
    needs the 4-element scales of ``calibrate_act_scales(..., attn=True)``).
    ``skip_blocks`` keeps the listed blocks in the float path."""
    if qkv and any(len(s) < 4 for s in scales):
        raise ValueError('qkv=True needs (fc1, fc2, qkv, proj) scales; '
                         'calibrate with attn=True')
    if getattr(cfg.backbone, 'num_experts', 0) > 0:
        raise NotImplementedError(
            'int8 serving is not implemented for MoE (num_experts > 0) '
            'backbones: MoEMlp has no int8 path')
    bb = dataclasses.replace(
        cfg.backbone, int8_mlp=True, int8_qkv=qkv,
        int8_act_scales=tuple(tuple(float(a) for a in s) for s in scales),
        int8_skip_blocks=tuple(int(i) for i in skip_blocks))
    return dataclasses.replace(cfg, backbone=bb)


def first_last_skip(depth: int, k_first: int, k_last: int):
    """Block indices keeping the first ``k_first`` and the last ``k_last``
    blocks in the float path (selective quantisation).

    Unlike the JAX function, this one refuses k_first + k_last >= depth:
    that would keep every block in the float path while the caller asks
    for int8."""
    if k_first < 0 or k_last < 0 or k_first + k_last >= depth:
        raise ValueError(f'keeping the first {k_first} and last {k_last} of '
                         f'{depth} blocks in the float path leaves no block '
                         'in int8')
    return tuple(sorted(set(range(k_first))
                        | set(range(depth - k_last, depth))))


def calibrate_from_loader(model: TopDownModel, loader, n_batches: int = 2,
                          attn: bool = True, margin: float = 1.0):
    """Activation scales from an eval loader's first `n_batches` batches,
    cropped as the val step crops them (uint8 canvas -> UDP or affine
    warp -> imagenet normalisation), on the model's device. The calibration
    behind `tools/test.py --int8`."""
    dev = next(model.parameters()).device
    iw, ih = loader.image_size
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    batches = []
    with torch.inference_mode():
        for b in itertools.islice(iter(loader), n_batches):
            x = torch.from_numpy(np.ascontiguousarray(b['imgs'])).to(dev)
            center, scale = (torch.from_numpy(
                np.ascontiguousarray(b[k], np.float32)).to(dev)
                for k in ('center', 'scale'))
            rot = torch.zeros(center.shape[0], device=dev)
            if model.cfg.use_udp:
                mat = udp_warp_matrix(rot, center, scale, (iw, ih))
            else:
                mat = affine_matrix(center, scale, rot, (iw, ih))
            crops = warp_affine_batch(x.float() / 255.0, mat, (iw, ih))
            batches.append((crops - mean) / std)
    return calibrate_act_scales(model, batches, attn=attn, margin=margin)


def rebuild(model: TopDownModel, cfg) -> TopDownModel:
    """A TopDownModel of `cfg` (an `int8_serving_config` of the model's
    config) holding `model`'s weights and BN statistics, on its device, in
    eval mode: the parameter names do not depend on int8."""
    dev = next(model.parameters()).device
    out = TopDownModel(cfg, generator=torch.Generator().manual_seed(0))
    out.load_state_dict(model.state_dict(), strict=True)
    return out.to(dev).eval()

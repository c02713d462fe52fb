"""Deformable convolution v1/v2 as PyTorch tensor ops (bilinear grid_sample).

Counterpart of vitpose_tpu/ops/deform_conv.py:19-113 (`deform_conv2d`,
`_deform_sample`), in torch's layouts (mmcv's DeformConv2d): x [N, C_in,
H, W], offsets [N, 2 * kh * kw * G, H_out, W_out] (per tap a (dy, dx)
pair, tap-major within a group and group-major across groups, as JAX's last
axis), weight [C_out, C_in, kh, kw], mask [N, kh * kw, H_out, W_out].

Each output pixel p and tap k samples p * stride - padding + k * dilation +
offset bilinearly: `floor`, then the four corners, each corner outside the
map counting zero on its own (JAX's gathers; here F.grid_sample with zero
padding, one fused pass); the v2 mask scales each tap; then one dense
contraction over taps and input channels, accumulated in f32 and cast to
x's dtype. torchvision is not a dependency (ROADMAP §2: a hand kernel only
where a profile asks for one).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def out_size(n, kernel, stride, padding, dilation):
    return (n + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def deform_sample(x, offsets, kh, kw, stride=1, padding=1, dilation=1,
                  deform_groups=1):
    """Bilinear tap sampling: x [N, C, H, W] and offsets [N, 2 * kh * kw *
    G, Ho, Wo] -> [N, C, Ho, Wo, kh * kw] in x's dtype, each group's C / G
    channels sampled with its own offsets: one F.grid_sample over the
    [N * G, C / G, H, W] groups, its grid the taps' pixel positions in
    align_corners=False coordinates ((2p + 1) / size - 1), 'zeros' padding
    (each corner outside the map counts zero on its own, as JAX's)."""
    n, c, h, w = x.shape
    g = deform_groups
    if c % g:
        raise ValueError(f'{c} input channels in {g} deform groups')
    ho = out_size(h, kh, stride, padding, dilation)
    wo = out_size(w, kw, stride, padding, dilation)
    taps = kh * kw
    if offsets.shape != (n, 2 * taps * g, ho, wo):
        raise ValueError(f'offsets {tuple(offsets.shape)}: expected '
                         f'{(n, 2 * taps * g, ho, wo)}')
    dev = x.device
    ys = torch.arange(ho, device=dev) * stride - padding
    xs = torch.arange(wo, device=dev) * stride - padding
    ky = (torch.arange(kh, device=dev) * dilation).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dilation).repeat(kh)
    # [N, G, K, 2, Ho, Wo] -> [N, G, Ho, Wo, K] per coordinate
    off = offsets.reshape(n, g, taps, 2, ho, wo).permute(0, 1, 4, 5, 2, 3)
    sy = (ys[:, None, None] + ky).to(offsets.dtype) + off[..., 0]
    sx = (xs[None, :, None] + kx).to(offsets.dtype) + off[..., 1]
    grid = torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], -1)
    out = F.grid_sample(x.reshape(n * g, c // g, h, w),
                        grid.reshape(n * g, ho, wo * taps, 2).to(x.dtype),
                        mode='bilinear', padding_mode='zeros',
                        align_corners=False)
    return out.reshape(n, c, ho, wo, taps)


def deform_conv2d(x, offsets, weight, mask=None, stride=1, padding=1,
                  dilation=1, deform_groups=1):
    """Deformable 2D convolution: [N, C_in, H, W] -> [N, C_out, H_out,
    W_out] in x's dtype (layouts in the module docstring). With
    `deform_groups` G the input channels split into G groups, each sampled
    with its own offset field (the PoseWarper neck: one per joint); the
    contraction over taps and channels stays dense."""
    c_out, c_in, kh, kw = weight.shape
    if x.shape[1] != c_in:
        raise ValueError(f'x has {x.shape[1]} channels, weight {c_in}')
    val = deform_sample(x, offsets, kh, kw, stride, padding, dilation,
                        deform_groups)
    n, _, ho, wo, taps = val.shape
    if mask is not None:
        val = val * mask.reshape(n, taps, ho, wo).permute(0, 2, 3, 1)[
            :, None]
    acc = torch.promote_types(x.dtype, torch.float32)
    out = torch.einsum('nchwk,ock->nohw', val.to(acc),
                       weight.reshape(c_out, c_in, taps).to(acc))
    return out.to(x.dtype)

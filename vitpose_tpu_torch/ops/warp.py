"""Batched affine warp (crop) with cv2.warpAffine semantics, as PyTorch
tensor code.

Counterpart of vitpose_tpu/ops/warp.py: ``dst(x, y) = src(M^-1 [x, y, 1])``
with bilinear interpolation and a constant-zero border, for a whole batch of
boxes at once.
"""
from __future__ import annotations

import torch

from .geometry import invert_affine


def warp_affine_batch(images, matrices, output_size):
    """Warp [N, H, W, C] float images with [N, 2, 3] forward affines.

    ``output_size`` is (out_w, out_h); returns [N, out_h, out_w, C], zero
    outside the source. ``images`` may be an expanded view of one image
    (stride 0 on N): the samples are gathered by indexing, which reads
    through the strides and copies nothing.
    """
    out_w, out_h = int(output_size[0]), int(output_size[1])
    n, h, w, _ = images.shape
    dev = images.device
    inv = invert_affine(torch.as_tensor(matrices, dtype=torch.float32))
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')       # [out_h, out_w]

    def row(i):
        return inv[:, i, 0, None, None], inv[:, i, 1, None, None], \
            inv[:, i, 2, None, None]

    a, b, c = row(0)
    sx = a * gx + b * gy + c                             # [N, out_h, out_w]
    a, b, c = row(1)
    sy = a * gx + b * gy + c

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    bidx = torch.arange(n, device=dev)[:, None, None]

    def sample(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = images[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return torch.where(valid[..., None], vals, 0.0)

    v00 = sample(x0i, y0i)
    v01 = sample(x0i + 1, y0i)
    v10 = sample(x0i, y0i + 1)
    v11 = sample(x0i + 1, y0i + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy

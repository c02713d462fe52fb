"""Batched crop geometry for top-down pose, as PyTorch tensor code.

Counterpart of vitpose_tpu/ops/geometry.py, with the same functions, layouts
([..., 2] centers and scales, [..., 2, 3] affine matrices, [N, K, H, W]
heatmaps) and f32 arithmetic. Every function works on the device of its
inputs; numpy arrays and lists become CPU tensors. Constants are Python
floats, so nothing here creates a tensor on another device.
"""
from __future__ import annotations

import numpy as np
import torch

PIXEL_STD = 200.0


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def bbox_xywh2cs(bbox, aspect_ratio, padding=1.25, pixel_std=PIXEL_STD):
    """[..., 4] xywh boxes -> (center [..., 2], scale [..., 2]).

    The box grows symmetrically to the aspect ratio (w/h), is normalised by
    ``pixel_std`` and padded (reference top_down_transform.py:13).
    """
    bbox = _f32(bbox)
    x, y, w, h = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    center = torch.stack([x + w * 0.5, y + h * 0.5], dim=-1)
    h_fit = torch.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w_fit = torch.where(w < aspect_ratio * h, h * aspect_ratio, w)
    scale = torch.stack([w_fit, h_fit], dim=-1) / pixel_std * padding
    return center, scale


def bbox_xyxy2xywh(bbox):
    """[..., 4+] xyxy(+score) -> xywh(+score)."""
    bbox = _f32(bbox)
    wh = bbox[..., 2:4] - bbox[..., :2]
    return torch.cat([bbox[..., :2], wh, bbox[..., 4:]], dim=-1)


def bbox_cs2xyxy(center, scale, pixel_std=PIXEL_STD):
    """(center [..., 2], scale [..., 2]) -> [..., 4] xyxy boxes: the
    inverse of bbox_xywh2cs, its padding kept."""
    wh = _f32(scale) * pixel_std
    xy = _f32(center) - wh * 0.5
    return torch.cat([xy, xy + wh], dim=-1)


def affine_matrix(center, scale, rot_deg, output_size, shift=(0.0, 0.0),
                  inv=False, pixel_std=PIXEL_STD):
    """Batched classic (MSRA) crop affine in closed form, [..., 2, 3].

    Maps the source box (center, scale * pixel_std, rotated by ``rot_deg``)
    onto an ``output_size = (w, h)`` canvas; only the box width sets the zoom
    (reference post_transforms.py:197-252). ``inv`` gives dst -> src.
    """
    center = _f32(center)
    scale = _f32(scale)
    rot = torch.deg2rad(_f32(rot_deg).to(center.device))
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    src_wh = scale * pixel_std
    s = dst_w / src_wh[..., 0]
    cos, sin = torch.cos(rot), torch.sin(rot)
    a00 = s * cos
    a01 = s * sin
    a10 = -s * sin
    a11 = s * cos
    p0x = center[..., 0] + src_wh[..., 0] * shift[0]
    p0y = center[..., 1] + src_wh[..., 1] * shift[1]
    t0 = dst_w * 0.5 - (a00 * p0x + a01 * p0y)
    t1 = dst_h * 0.5 - (a10 * p0x + a11 * p0y)
    fwd = torch.stack([torch.stack([a00, a01, t0], dim=-1),
                       torch.stack([a10, a11, t1], dim=-1)], dim=-2)
    return invert_affine(fwd) if inv else fwd


def invert_affine(mat):
    """Invert [..., 2, 3] affine matrices analytically."""
    a = mat[..., :, :2]
    t = mat[..., :, 2]
    det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    inv00 = a[..., 1, 1] / det
    inv01 = -a[..., 0, 1] / det
    inv10 = -a[..., 1, 0] / det
    inv11 = a[..., 0, 0] / det
    it0 = -(inv00 * t[..., 0] + inv01 * t[..., 1])
    it1 = -(inv10 * t[..., 0] + inv11 * t[..., 1])
    return torch.stack([torch.stack([inv00, inv01, it0], dim=-1),
                        torch.stack([inv10, inv11, it1], dim=-1)], dim=-2)


def udp_warp_matrix(rot_deg, center, scale, output_size, pixel_std=PIXEL_STD):
    """Batched UDP (unbiased) crop affine, dst <- src, [..., 2, 3].

    The ROI of size ``scale * pixel_std`` at ``center`` maps onto the
    ``output_size - 1`` grid (reference post_transforms.py:312
    `get_warp_matrix` called with ``c * 2`` as the input size).
    """
    center = _f32(center)
    scale = _f32(scale)
    theta = torch.deg2rad(_f32(rot_deg).to(center.device))
    size_input = center * 2.0
    dst_w, dst_h = output_size[0] - 1.0, output_size[1] - 1.0
    size_target = scale * pixel_std
    cos, sin = torch.cos(theta), torch.sin(theta)
    scale_x = dst_w / size_target[..., 0]
    scale_y = dst_h / size_target[..., 1]
    m00 = cos * scale_x
    m01 = -sin * scale_x
    m02 = scale_x * (-0.5 * size_input[..., 0] * cos
                     + 0.5 * size_input[..., 1] * sin
                     + 0.5 * size_target[..., 0])
    m10 = sin * scale_y
    m11 = cos * scale_y
    m12 = scale_y * (-0.5 * size_input[..., 0] * sin
                     - 0.5 * size_input[..., 1] * cos
                     + 0.5 * size_target[..., 1])
    return torch.stack([torch.stack([m00, m01, m02], dim=-1),
                        torch.stack([m10, m11, m12], dim=-1)], dim=-2)


def apply_affine_to_points(points, mat):
    """Apply [..., 2, 3] affines to [..., K, 2] points -> [..., K, 2].

    Written elementwise, so it is exact f32 on every device whatever the
    TF32 settings (the JAX package asks for Precision.HIGHEST: a rounded
    product would cost whole pixels on image-scale coordinates).
    """
    points = _f32(points)
    x, y = points[..., 0], points[..., 1]
    row = [[mat[..., i, j, None] for j in range(3)] for i in range(2)]
    return torch.stack([row[i][0] * x + row[i][1] * y + row[i][2]
                        for i in range(2)], dim=-1)


def transform_preds(coords, center, scale, output_size, use_udp=False,
                    pixel_std=PIXEL_STD):
    """Map [..., K, 2] heatmap-grid coords back to source-image space.

    ``output_size`` is the heatmap (w, h); under UDP the grid spans
    ``size - 1`` units (reference post_transforms.py:150-194).
    """
    coords = _f32(coords)
    center = _f32(center)
    scale_px = _f32(scale) * pixel_std
    w, h = float(output_size[0]), float(output_size[1])
    if use_udp:
        w, h = w - 1.0, h - 1.0
    fx = scale_px[..., 0] / w
    fy = scale_px[..., 1] / h
    factor = torch.stack([fx, fy], dim=-1)
    origin = center - scale_px * 0.5
    return coords * factor[..., None, :] + origin[..., None, :]


def flip_index_from_pairs(flip_pairs, num_joints):
    """Length-K permutation (numpy, host side) from mirror pairs."""
    idx = np.arange(num_joints)
    for a, b in flip_pairs:
        idx[a], idx[b] = b, a
    return idx


def fliplr_joints(joints, visible, img_width, flip_index):
    """Mirror [..., K, C] joints of an image `img_width` wide (x -> W - 1 -
    x), permuted by `flip_index` with their [..., K, C'] visibility and
    masked by it (reference post_transforms.py:13-51). Returns (joints,
    visible)."""
    joints = _f32(joints)[..., flip_index, :]
    visible = _f32(visible)[..., flip_index, :]
    x = img_width - 1 - joints[..., 0:1]
    return torch.cat([x, joints[..., 1:]], dim=-1) * visible, visible


def fliplr_regression(regression, flip_pairs, center_mode='static',
                      center_x=0.5, center_index=0, flip_index=None):
    """Flip regressed [..., K, D] coordinates horizontally (reference
    post_transforms.py:54): swap the left/right `flip_pairs`, then mirror x
    about a static x (`center_x`, normalised coordinates) or about joint
    `center_index`'s x ('root'). `flip_index`, the permutation itself (a
    tensor on the coordinates' device), stands in for the pairs where the
    caller holds it, so that nothing is read back from the card."""
    if regression.ndim < 2:
        raise ValueError(f'fliplr_regression takes [..., K, D] coordinates, '
                         f'got shape {tuple(regression.shape)}')
    if center_mode == 'static':
        x_c = center_x
    elif center_mode == 'root':
        x_c = regression[..., center_index:center_index + 1, 0:1]
    else:
        raise ValueError(center_mode)
    if flip_index is None:
        flip_index = flip_index_from_pairs(flip_pairs, regression.shape[-2])
    out = regression[..., torch.as_tensor(flip_index,
                                          device=regression.device), :]
    return torch.cat([x_c * 2 - out[..., :1], out[..., 1:]], dim=-1)


def flip_back(heatmaps, flip_index, target_type='GaussianHeatmap'):
    """Un-flip [N, K, H, W] heatmaps of a horizontally flipped input.

    Channel permutation, then reversal of W; for CombinedTarget
    ([N, 3K, H, W]) the x-offset channels are negated
    (reference post_transforms.py:110-147).
    """
    flip_index = torch.as_tensor(flip_index, device=heatmaps.device)
    if target_type.lower() == 'combinedtarget':
        n, c3, h, w = heatmaps.shape
        hm = heatmaps.reshape(n, c3 // 3, 3, h, w)
        sign = torch.ones(3, dtype=hm.dtype, device=hm.device)
        sign[1] = -1.0
        hm = (hm * sign[:, None, None])[:, flip_index]
        heatmaps = hm.reshape(n, c3, h, w)
    else:
        heatmaps = heatmaps[:, flip_index]
    return heatmaps.flip(-1)


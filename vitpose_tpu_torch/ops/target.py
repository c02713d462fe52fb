"""Heatmap training targets, vectorised over (batch, joints) as tensor code
on the input's device.

Counterpart of vitpose_tpu/ops/target.py `generate_msra_heatmaps`,
`generate_udp_heatmaps`, `generate_combined_target` and
`generate_megvii_heatmaps` (reference top_down_transform.py:409-653). The
Gaussian ones are full-grid
Gaussians masked to the (6 sigma + 1)^2 paste window around the joint's
rounded position, with the window anchor truncated toward zero as Python's
int() does, and the joint's weight zeroed when the window misses the map.
Joints are in input-image pixels; the sizes are (w, h).
"""
from __future__ import annotations

import torch


def _grid(joints, heatmap_size):
    w, h = int(heatmap_size[0]), int(heatmap_size[1])
    xs = torch.arange(w, dtype=torch.float32, device=joints.device)
    ys = torch.arange(h, dtype=torch.float32, device=joints.device)
    return w, h, xs, ys


def _window_weight(mu_i, visible, w, h, tmp_size):
    """The joint's weight: `visible`, or 0 where the paste window around the
    integer anchor `mu_i` misses the map."""
    ul = mu_i - int(tmp_size)
    br = mu_i + int(tmp_size) + 1
    oob = ((ul[..., 0] >= w) | (ul[..., 1] >= h)
           | (br[..., 0] < 0) | (br[..., 1] < 0))
    return torch.where(oob, 0.0, visible)


def _gaussian(cx, cy, xs, ys, sigma):
    """[..., K, H, W] Gaussians centred at (cx, cy) [..., K]."""
    gx = xs - cx[..., None]
    gy = ys - cy[..., None]
    return torch.exp(-(gx[..., None, :] ** 2 + gy[..., :, None] ** 2)
                     / (2.0 * sigma ** 2))


def _in_window(mu_i, xs, ys, tmp_size):
    ax = mu_i[..., 0, None].float()
    ay = mu_i[..., 1, None].float()
    return (((xs - ax).abs() <= tmp_size)[..., None, :]
            & ((ys - ay).abs() <= tmp_size)[..., :, None])


def generate_msra_heatmaps(joints, visible, image_size, heatmap_size,
                           sigma=2.0, unbiased=False):
    """Classic MSRA targets: joints [..., K, 2], visible [..., K] ->
    (target [..., K, H, W], weight [..., K]), float32.

    `unbiased` (DARK) centres the Gaussian on the continuous position and
    tests the window there, unmasked; otherwise the centre is the rounded
    position and the Gaussian is cut to the 3 sigma window.
    """
    joints = torch.as_tensor(joints, dtype=torch.float32)
    visible = torch.as_tensor(visible, dtype=torch.float32)
    w, h, xs, ys = _grid(joints, heatmap_size)
    tmp_size = sigma * 3.0
    mu_x = joints[..., 0] / (image_size[0] / w)
    mu_y = joints[..., 1] / (image_size[1] / h)
    if unbiased:
        oob = ((mu_x - tmp_size >= w) | (mu_y - tmp_size >= h)
               | (mu_x + tmp_size + 1 < 0) | (mu_y + tmp_size + 1 < 0))
        weight = torch.where(oob, 0.0, visible)
        g = _gaussian(mu_x, mu_y, xs, ys, sigma)
    else:
        mu_i = torch.trunc(torch.stack([mu_x, mu_y], -1) + 0.5).int()
        weight = _window_weight(mu_i, visible, w, h, tmp_size)
        g = _gaussian(mu_i[..., 0].float(), mu_i[..., 1].float(), xs, ys,
                      sigma)
        g = torch.where(_in_window(mu_i, xs, ys, tmp_size), g, 0.0)
    target = torch.where((weight > 0.5)[..., None, None], g, 0.0)
    return target, weight


def generate_udp_heatmaps(joints, visible, image_size, heatmap_size,
                          sigma=2.0):
    """UDP GaussianHeatmap targets on the unit-length grid: the stride is
    (image_size - 1) / (heatmap_size - 1), the Gaussian sits at the exact
    position and the window at the rounded one. Returns (target
    [..., K, H, W], weight [..., K]), float32."""
    joints = torch.as_tensor(joints, dtype=torch.float32)
    visible = torch.as_tensor(visible, dtype=torch.float32)
    w, h, xs, ys = _grid(joints, heatmap_size)
    tmp_size = sigma * 3.0
    mu_x = joints[..., 0] / ((image_size[0] - 1.0) / (w - 1.0))
    mu_y = joints[..., 1] / ((image_size[1] - 1.0) / (h - 1.0))
    mu_i = torch.trunc(torch.stack([mu_x, mu_y], -1) + 0.5).int()
    weight = _window_weight(mu_i, visible, w, h, tmp_size)
    g = _gaussian(mu_x, mu_y, xs, ys, sigma)
    g = torch.where(_in_window(mu_i, xs, ys, tmp_size), g, 0.0)
    target = torch.where((weight > 0.5)[..., None, None], g, 0.0)
    return target, weight


def generate_combined_target(joints, visible, image_size, heatmap_size,
                             valid_radius_factor=0.0546875):
    """UDP CombinedTarget: per joint a response map (1 inside the valid
    radius around the joint on the unit-length grid, 0 outside) and its x
    and y offset maps, in radius units (reference
    top_down_transform.py:625-653). Returns (target [..., K, 3, H, W],
    weight [..., K] = visible), float32."""
    joints = torch.as_tensor(joints, dtype=torch.float32)
    visible = torch.as_tensor(visible, dtype=torch.float32)
    w, h, xs, ys = _grid(joints, heatmap_size)
    valid_radius = valid_radius_factor * h
    mu_x = joints[..., 0] / ((image_size[0] - 1.0) / (w - 1.0))
    mu_y = joints[..., 1] / ((image_size[1] - 1.0) / (h - 1.0))
    x_off = (mu_x[..., None, None] - xs[None, :]) / valid_radius
    y_off = (mu_y[..., None, None] - ys[:, None]) / valid_radius
    keep = ((x_off ** 2 + y_off ** 2) <= 1.0) \
        & (visible > 0.5)[..., None, None]
    target = torch.stack([keep.float(), torch.where(keep, x_off, 0.0),
                          torch.where(keep, y_off, 0.0)], dim=-3)
    return target, visible


def generate_megvii_heatmaps(joints, visible, image_size, heatmap_size,
                             kernel=11):
    """Megvii's target (reference top_down_transform.py:496
    `_megvii_generate_target`): a delta at the joint's truncated heatmap
    cell, blurred as cv2.GaussianBlur(kernel, 0) with reflected borders,
    scaled so that the cell reads 255. Joints outside the map keep no
    map and, where visible, weight 0. Returns (target [..., K, H, W],
    weight [..., K]), float32."""
    from .decode import gaussian_blur_reflect
    joints = torch.as_tensor(joints, dtype=torch.float32)
    visible = torch.as_tensor(visible, dtype=torch.float32)
    w, h, xs, ys = _grid(joints, heatmap_size)
    tx = torch.trunc(joints[..., 0] * w / image_size[0]).int()
    ty = torch.trunc(joints[..., 1] * h / image_size[1]).int()
    inb = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
    weight = torch.where(visible >= 1, torch.where(inb, visible, 0.0),
                         visible)
    paint = (visible >= 1) & inb
    txc, tyc = tx.clamp(0, w - 1), ty.clamp(0, h - 1)
    onehot = ((xs[None, :] == txc[..., None, None])
              & (ys[:, None] == tyc[..., None, None])
              & paint[..., None, None]).float()
    blurred = gaussian_blur_reflect(onehot, kernel)
    peak = torch.gather(
        torch.gather(blurred, -2, tyc[..., None, None].long().expand(
            *tyc.shape, 1, w)), -1, txc[..., None, None].long())[..., 0, 0]
    scale = torch.where(paint, 255.0 / peak.clamp_min(1e-20), 0.0)
    return blurred * scale[..., None, None], weight

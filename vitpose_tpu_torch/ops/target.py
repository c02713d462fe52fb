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

The 3D targets, `generate_3d_heatmaps` (InterHand3D's 2.5D volumes) and
`generate_voxel_3d_targets` (VoxelPose's metric voxel Gaussians), are host
numpy as in the JAX package (vitpose_tpu/ops/target.py:200-308): the
loaders build them per record.
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


def generate_3d_heatmaps(joints_3d, visible, image_size, heatmap_size,
                         depth_bound, sigma=2.0, max_bound=1.0,
                         joint_indices=None, joint_weights=None):
    """2.5D Gaussian volumes (reference pose3d_transform.py:470
    `Generate3DHeatmapTarget`): joints_3d [K, 3] ((x, y) in input pixels, z
    metric within +-depth_bound / 2), visible [K] or [K, 3]; image_size (w,
    h), heatmap_size (W, H, D). Returns (target [K, D, H, W] f32, weight
    [K, 1]). Each joint paints its (6 sigma + 1)^3 cube at coordinates
    rounded then clipped per axis, as the outer product of three 1-D
    Gaussians."""
    import numpy as np
    joints_3d = np.asarray(joints_3d, np.float32)
    visible = np.asarray(visible, np.float32)
    if visible.ndim == 2:
        visible = visible[:, 0]
    if joint_indices is not None:
        joints_3d = joints_3d[joint_indices]
        visible = visible[joint_indices]
        if joint_weights is not None:
            joint_weights = np.asarray(joint_weights)[joint_indices]
    num_joints = joints_3d.shape[0]
    W, H, D = (int(s) for s in heatmap_size)
    mu_x = joints_3d[:, 0] * W / image_size[0]
    mu_y = joints_3d[:, 1] * H / image_size[1]
    mu_z = (joints_3d[:, 2] / depth_bound + 0.5) * D
    weight = visible * (mu_z >= 0) * (mu_z < D)
    if joint_weights is not None:
        weight = weight * np.asarray(joint_weights, np.float32).reshape(-1)
    weight = weight.astype(np.float32)[:, None]
    tmp = 3 * sigma
    offs = np.arange(2 * tmp + 1, dtype=np.float32) - tmp
    target = np.zeros((num_joints, D, H, W), np.float32)
    for k in range(num_joints):
        xs = np.round(mu_x[k] + offs).clip(0, W - 1)
        ys = np.round(mu_y[k] + offs).clip(0, H - 1)
        zs = np.round(mu_z[k] + offs).clip(0, D - 1)
        gx = np.exp(-(xs - mu_x[k]) ** 2 / (2 * sigma ** 2))
        gy = np.exp(-(ys - mu_y[k]) ** 2 / (2 * sigma ** 2))
        gz = np.exp(-(zs - mu_z[k]) ** 2 / (2 * sigma ** 2))
        target[k, zs.astype(int)[:, None, None],
               ys.astype(int)[None, :, None],
               xs.astype(int)[None, None, :]] = (
            gz[:, None, None] * gy[None, :, None] * gx[None, None, :])
    return target * max_bound, weight


def generate_voxel_3d_targets(joints_3d, visible, space_size, space_center,
                              cube_size, sigma=200.0, joint_indices=None):
    """Per-joint metric 3D Gaussians over a voxel grid (reference
    pose3d_transform.py:559 `GenerateVoxel3DHeatmapTarget`): joints_3d
    [P, K, 3] mm, visible [P, K] or [P, K, C]; the grid's size, centre and
    resolution (`cube_size`) per axis (x, y, z). Returns [K', X, Y, Z] f32,
    the max over people clipped to [0, 1]; one selected joint gives [X, Y,
    Z]. Only the voxels within 3 sigma of a joint are painted."""
    import numpy as np
    joints_3d = np.asarray(joints_3d, np.float32)
    visible = np.asarray(visible, np.float32)
    if visible.ndim == 3:
        visible = visible[..., 0]
    num_people, num_joints = joints_3d.shape[:2]
    idxs = list(range(num_joints)) if joint_indices is None \
        else list(joint_indices)
    grids = [np.linspace(-space_size[a] / 2, space_size[a] / 2,
                         cube_size[a]) + space_center[a] for a in range(3)]
    target = np.zeros((len(idxs),) + tuple(int(c) for c in cube_size),
                      np.float32)
    for n in range(num_people):
        for out_k, k in enumerate(idxs):
            if visible[n, k] < 1:
                continue
            mu = joints_3d[n, k]
            lo = [np.searchsorted(grids[a], mu[a] - 3 * sigma)
                  for a in range(3)]
            hi = [np.searchsorted(grids[a], mu[a] + 3 * sigma, 'right')
                  for a in range(3)]
            if any(lo[a] >= hi[a] for a in range(3)):
                continue
            gs = [np.exp(-(grids[a][lo[a]:hi[a]] - mu[a]) ** 2
                         / (2 * sigma ** 2)) for a in range(3)]
            g = (gs[0][:, None, None] * gs[1][None, :, None]
                 * gs[2][None, None, :])
            sl = (out_k, slice(lo[0], hi[0]), slice(lo[1], hi[1]),
                  slice(lo[2], hi[2]))
            target[sl] = np.maximum(target[sl], g)
    target = np.clip(target, 0, 1)
    if target.shape[0] == 1:
        target = target[0]
    return target

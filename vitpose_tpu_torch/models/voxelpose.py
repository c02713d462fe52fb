"""VoxelPose multiview 3D pose, in PyTorch: voxel aggregation, V2VNet and
the cuboid heads.

Counterpart of vitpose_tpu/models/voxelpose.py (reference mmpose
detectors/multiview_pose.py `DetectAndRegress`, backbones/v2v_net.py,
heads/voxelpose_head.py):

  * `make_voxel_grid` [X, Y, Z, 3] world coordinates (mm);
  * `stack_camera_params` V SimpleCameras -> arrays (R_w2c, T_w2c, K and
    the distortion normalised to the rational-6 form);
    `project_points_pix` world points -> [V, P, 2] pixels, written
    elementwise so that it is exact f32 whatever the TF32 settings;
  * `project_heatmaps_to_voxels` samples each view's [K, H, W] heatmaps at
    the voxels' projections and averages the views: one `F.grid_sample`
    (bilinear, align_corners, zero padding: each of the four corners reads
    zero outside the map, as JAX's gathers do) over every view;
  * `V2VNet` (`_Basic3D`, `_Res3D`, `_Up3D`) under mmpose's names, NCDHW
    (JAX's NDHWC volumes [N, X, Y, Z, C] are [N, C, X, Y, Z] here), BN with
    flax's semantics;
  * `CuboidCenterHead.get_proposals` (host numpy argsort, JAX's call) and
    `CuboidPoseHead` (a beta-scaled softmax over the cube's voxels in f32,
    then the expected grid position), without parameters as mmpose's;
  * `DetectAndRegress` with mmpose's modules (`human_detector.center_net`
    and `pose_regressor.pose_net` the V2VNets, JAX's heads' `v2v`):
    `forward` (the center volume, the host's
    proposals, every proposal's cube through the pose net in one batch),
    `training_losses` (one scene, a batch of 1 per candidate as JAX's) and
    `training_losses_batched` (frames and candidates in one batch each).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import data_sum
from .heads import batch_norm
from .vit import at_least_f32, normal_


def make_voxel_grid(center, size, resolution, device=None):
    """Axis-aligned grid: centre [3], size [3] (mm), resolution (nx, ny,
    nz) -> [nx, ny, nz, 3] f32 world coordinates."""
    axes = [torch.linspace(float(center[i]) - float(size[i]) / 2,
                           float(center[i]) + float(size[i]) / 2,
                           int(resolution[i]), dtype=torch.float64)
            for i in range(3)]
    grid = torch.stack(torch.meshgrid(*axes, indexing='ij'), dim=-1)
    return grid.to(device=device, dtype=torch.float32)


def stack_camera_params(cameras):
    """V SimpleCameras -> dict of numpy arrays: R [V, 3, 3], T [V, 1, 3]
    (world -> camera), K [V, 3, 2], k [V, 6] (radial, zero-padded to the
    rational form), p [V, 2] (tangential)."""
    def k6(cam):
        kk = np.zeros(6, np.float32)
        if getattr(cam, 'has_dist', False):
            kv = np.asarray(cam.k, np.float32).ravel()
            kk[:kv.shape[0]] = kv
        return kk

    def p2(cam):
        if getattr(cam, 'has_dist', False):
            return np.asarray(cam.p, np.float32).ravel()[:2]
        return np.zeros(2, np.float32)

    return dict(R=np.stack([np.asarray(c.R_w2c, np.float32)
                            for c in cameras]),
                T=np.stack([np.asarray(c.T_w2c, np.float32)
                            for c in cameras]),
                K=np.stack([np.asarray(c.K, np.float32) for c in cameras]),
                k=np.stack([k6(c) for c in cameras]),
                p=np.stack([p2(c) for c in cameras]))


def camera_tensors(cameras, device):
    """SimpleCameras, or stack_camera_params' arrays, as f32 tensors on
    `device`."""
    cp = cameras if isinstance(cameras, dict) \
        else stack_camera_params(cameras)
    return {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=device) for k, v in cp.items()}


def project_points_pix(pts, cp):
    """World points [P, 3] -> pixels [V, P, 2] for every view of `cp`
    (camera_tensors): SimpleCamera's world_to_camera and camera_to_pixel,
    vectorised over the views."""
    r, t = cp['R'], cp['T']
    xc = (pts[None, :, 0, None] * r[:, None, 0] + pts[None, :, 1, None]
          * r[:, None, 1] + pts[None, :, 2, None] * r[:, None, 2]) + t
    v = xc / xc[..., 2:]
    x, y = v[..., 0], v[..., 1]
    r2 = x * x + y * y
    k, p = cp['k'][:, None], cp['p'][:, None]
    num = 1.0 + k[..., 0] * r2 + k[..., 1] * r2 ** 2 + k[..., 2] * r2 ** 3
    den = 1.0 + k[..., 3] * r2 + k[..., 4] * r2 ** 2 + k[..., 5] * r2 ** 3
    tangential = 2.0 * (p[..., 1] * x + p[..., 0] * y)
    fac = num / den + tangential
    x2 = x * fac + r2 * p[..., 1]
    y2 = y * fac + r2 * p[..., 0]
    kk = cp['K'][:, None]
    return torch.stack([x2 * kk[..., 0, j] + y2 * kk[..., 1, j]
                        + kk[..., 2, j] for j in range(2)], dim=-1)


def project_heatmaps_to_voxels(heatmaps, cameras, grid):
    """Multiview heatmaps [V, K, H, W] sampled at the projections of the
    grid's points [..., 3] and averaged over the views -> [..., K]
    (bilinear, zeros outside). `cameras`: SimpleCameras in the heatmaps'
    pixel frame, or their camera_tensors."""
    v, k, h, w = heatmaps.shape
    cp = cameras if isinstance(cameras, dict) and torch.is_tensor(
        cameras['R']) else camera_tensors(cameras, heatmaps.device)
    heatmaps = at_least_f32(heatmaps)
    pts = grid.reshape(-1, 3)
    pix = project_points_pix(pts, cp)                      # [V, P, 2]
    norm = torch.stack([pix[..., 0] * (2.0 / (w - 1)) - 1.0,
                        pix[..., 1] * (2.0 / (h - 1)) - 1.0], dim=-1)
    val = F.grid_sample(heatmaps, norm[:, None].to(heatmaps.dtype),
                        mode='bilinear',
                        padding_mode='zeros', align_corners=True)
    return val[:, :, 0].mean(0).t().reshape(grid.shape[:-1] + (k,))


def _bn(bn, x):
    """flax BN over an NCDHW volume (`heads.batch_norm` on [N, C, D,
    H * W])."""
    n, c, d, h, w = x.shape
    return batch_norm(bn, x.reshape(n, c, d, h * w)).reshape(
        n, c, d, h, w)


def _conv(layer, x):
    return F.conv3d(x, layer.weight, layer.bias, padding=layer.padding)


class _ConvBN(nn.Module):
    """mmcv's ConvModule in 3-D: `conv` (with bias) and `bn`."""

    def __init__(self, cin, cout, kernel):
        super().__init__()
        self.conv = nn.Conv3d(cin, cout, kernel, padding=(kernel - 1) // 2)
        self.bn = nn.BatchNorm3d(cout, eps=1e-5)

    def forward(self, x, relu=True):
        y = _bn(self.bn, _conv(self.conv, x))
        return F.relu(y) if relu else y


class _Basic3D(nn.Module):
    """mmpose's Basic3DBlock: `block` conv + BN + ReLU."""

    def __init__(self, cin, cout, kernel=3):
        super().__init__()
        self.block = _ConvBN(cin, cout, kernel)

    def forward(self, x):
        return self.block(x)


class _Res3D(nn.Module):
    """mmpose's Res3DBlock: `res_branch.{0,1}` (the second without ReLU)
    plus the identity or the `skip_con` 1x1 conv + BN, then ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.res_branch = nn.Sequential(_ConvBN(cin, cout, 3),
                                        _ConvBN(cout, cout, 3))
        self.skip_con = _ConvBN(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        y = self.res_branch[1](self.res_branch[0](x), relu=False)
        skip = x if self.skip_con is None else self.skip_con(x, relu=False)
        return F.relu(y + skip)


class _Up3D(nn.Module):
    """mmpose's Upsample3DBlock: `block.0` ConvTranspose3d(2, 2) with bias,
    `block.1` BN, ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.block = nn.Sequential(nn.ConvTranspose3d(cin, cout, 2, 2),
                                   nn.BatchNorm3d(cout, eps=1e-5))

    def forward(self, x):
        deconv, bn = self.block
        return F.relu(_bn(bn, F.conv_transpose3d(x, deconv.weight,
                                                 deconv.bias, stride=2)))


class _EncoderDecoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.encoder_res1 = _Res3D(c, c * 2)
        self.encoder_res2 = _Res3D(c * 2, c * 4)
        self.mid_res = _Res3D(c * 4, c * 4)
        self.decoder_res2 = _Res3D(c * 4, c * 4)
        self.decoder_upsample2 = _Up3D(c * 4, c * 2)
        self.decoder_res1 = _Res3D(c * 2, c * 2)
        self.decoder_upsample1 = _Up3D(c * 2, c)
        self.skip_res1 = _Res3D(c, c)
        self.skip_res2 = _Res3D(c * 2, c * 2)


class V2VNet(nn.Module):
    """[N, C_in, X, Y, Z] -> [N, out_channels, X, Y, Z] (X, Y, Z divisible
    by 4): the 7^3 basic block and a residual one in front, a two-level
    pooled encoder with residual skips, the transposed-conv decoder, the
    1^3 output conv (reference v2v_net.py:212)."""

    def __init__(self, in_channels, out_channels, mid_channels=32,
                 generator=None):
        super().__init__()
        c = mid_channels
        self.front_layers = nn.Sequential(_Basic3D(in_channels, c // 2, 7),
                                          _Res3D(c // 2, c))
        self.encoder_decoder = _EncoderDecoder(c)
        self.output_layer = nn.Conv3d(c, out_channels, 1)
        init_3d(self, generator)

    def forward(self, x):
        ed = self.encoder_decoder
        # f32, or f64 in a float64 model (model.double())
        x = self.front_layers[1](self.front_layers[0](
            x.to(self.output_layer.weight.dtype)))
        s1 = ed.skip_res1(x)
        x = ed.encoder_res1(F.max_pool3d(x, 2, 2))
        s2 = ed.skip_res2(x)
        x = ed.encoder_res2(F.max_pool3d(x, 2, 2))
        x = ed.decoder_res2(ed.mid_res(x))
        x = ed.decoder_res1(ed.decoder_upsample2(x) + s2)
        x = ed.decoder_upsample1(x) + s1
        return _conv(self.output_layer, x)


def init_3d(module, generator=None):
    """Seeded init of the 3-D convs below `module` (normal, std fan_in **
    -0.5 cut at two deviations, as `resnet.init_cnn`; a transposed conv's
    fan-in is its input channels times its kernel volume; zero biases)
    and BN."""
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
            normal_(m.weight, m.weight[0].numel() ** -0.5, generator)
        elif isinstance(m, nn.ConvTranspose3d):
            normal_(m.weight, (m.weight.shape[0] * m.weight[0, 0].numel())
                    ** -0.5, generator)
        elif isinstance(m, nn.BatchNorm3d):
            m.reset_parameters()
            continue
        else:
            continue
        nn.init.zeros_(m.bias)


class CuboidCenterHead(nn.Module):
    """The centre net's volume [N, 1, X, Y, Z] -> [N, X, Y, Z]; the
    proposals on the host (mmpose's head has no parameters: the V2VNet is
    the detector's `center_net`)."""

    def forward(self, vol):
        return vol[:, 0]

    @staticmethod
    def get_proposals(center_volume, grid, max_people=10, threshold=0.1):
        """[X, Y, Z] centre volume -> [(world xyz, score)] of the
        `max_people` largest voxels above `threshold` (host numpy
        argsort)."""
        vol = np.asarray(center_volume)
        g = np.asarray(grid)
        flat = vol.ravel()
        order = np.argsort(-flat)[:max_people]
        out = []
        for idx in order:
            if flat[idx] < threshold:
                break
            out.append((g.reshape(-1, 3)[idx], float(flat[idx])))
        return out


class CuboidPoseHead(nn.Module):
    """Per-joint cube volumes [N, K, X, Y, Z] and the grid [X, Y, Z, 3]
    (shared) or [N, X, Y, Z, 3] -> joints [N, K, 3]: the softmax of beta x
    the volume over the cube's voxels, in f32, then the expected grid
    position (no parameters: the V2VNet is the regressor's `pose_net`)."""

    def __init__(self, beta=100.0):
        super().__init__()
        self.beta = beta

    def forward(self, vol, grid):
        n, k = vol.shape[:2]
        w = torch.softmax(self.beta * at_least_f32(vol).reshape(n, k, -1),
                          dim=-1)
        pts = grid.reshape(n if grid.ndim == 5 else 1, -1, 3).to(w.dtype)
        return torch.matmul(w, pts)


class DetectAndRegress(nn.Module):
    """Multiview heatmaps -> people's 3D joints: the space volume, the
    centre net and its proposals, a cube per proposal through the pose
    net."""

    def __init__(self, num_joints=15, space_center=(0, 0, 1000),
                 space_size=(8000, 8000, 2000),
                 space_resolution=(40, 40, 16), cube_size=(800, 800, 800),
                 cube_resolution=(16, 16, 16), mid_channels=16, beta=100.0,
                 max_people=10, center_threshold=0.1, generator=None):
        super().__init__()
        self.num_joints = num_joints
        self.space_center = space_center
        self.space_size = space_size
        self.space_resolution = space_resolution
        self.cube_size = cube_size
        self.cube_resolution = cube_resolution
        self.max_people = max_people
        self.center_threshold = center_threshold
        self.human_detector = nn.Module()
        self.human_detector.center_net = V2VNet(num_joints, 1, mid_channels,
                                                generator)
        self.human_detector.center_head = CuboidCenterHead()
        self.pose_regressor = nn.Module()
        self.pose_regressor.pose_net = V2VNet(num_joints, num_joints,
                                              mid_channels, generator)
        self.pose_regressor.pose_head = CuboidPoseHead(beta)

    def center(self, x):
        """Space volumes [N, K, X, Y, Z] -> centre volumes [N, X, Y, Z]."""
        return self.human_detector.center_head(
            self.human_detector.center_net(x))

    def pose(self, x, grid):
        """Cube volumes [N, K, X, Y, Z] and their grids -> joints
        [N, K, 3]."""
        return self.pose_regressor.pose_head(
            self.pose_regressor.pose_net(x), grid)

    def space_grid(self, device=None):
        return make_voxel_grid(self.space_center, self.space_size,
                               self.space_resolution, device)

    def _volume(self, heatmaps, cp, grid):
        """[..., 3] grid -> the NCDHW volume of its projected heatmaps."""
        vol = project_heatmaps_to_voxels(heatmaps, cp, grid)
        dims = tuple(range(vol.ndim - 1))
        return vol.permute((vol.ndim - 1,) + dims)

    def center_volume(self, heatmaps, cameras):
        """[V, K, H, W] heatmaps -> the centre net's [X, Y, Z] volume
        (the module's mode as it is)."""
        dev = heatmaps.device
        cp = camera_tensors(cameras, dev)
        return self.center(
            self._volume(heatmaps, cp, self.space_grid(dev))[None])[0]

    def cube_grids(self, centers):
        """[P, 3] centres -> [P, Xc, Yc, Zc, 3] cube grids."""
        offsets = make_voxel_grid((0, 0, 0), self.cube_size,
                                  self.cube_resolution, centers.device)
        return centers[:, None, None, None, :].float() + offsets

    def pose_joints(self, heatmaps, cp, centers):
        """The pose net on every centre's cube in one batch -> [P, K, 3]."""
        grids = self.cube_grids(centers)
        vols = project_heatmaps_to_voxels(heatmaps, cp, grids)
        return self.pose(vols.permute(0, 4, 1, 2, 3), grids)

    @torch.no_grad()
    def forward(self, heatmaps, cameras):
        """Eval-mode inference on one scene: heatmaps [V, K, H, W] and
        cameras in their pixel frame -> [(joints [K, 3] numpy, score)]."""
        was = self.training
        self.eval()
        try:
            dev = heatmaps.device
            cp = camera_tensors(cameras, dev)
            space = self.space_grid(dev)
            center = self.center(self._volume(heatmaps, cp,
                                                  space)[None])[0]
            proposals = CuboidCenterHead.get_proposals(
                center.cpu().numpy(), space.cpu().numpy(),
                max_people=self.max_people,
                threshold=self.center_threshold)
            if not proposals:
                return []
            centers = torch.as_tensor(np.stack([c for c, _ in proposals]),
                                      device=dev)
            joints = self.pose_joints(heatmaps, cp, centers).cpu().numpy()
        finally:
            self.train(was)
        return [(j, s) for j, (_, s) in zip(joints, proposals)]

    def training_losses(self, heatmaps, cameras, candidates, cand_mask,
                        gt_joints, gt_vis, targets_3d):
        """One scene's losses in the module's mode (reference
        multiview_pose.py:818 and :519, JAX `training_losses`): the centre
        MSE against `targets_3d` [X, Y, Z], and the weighted L1 of each
        candidate's joints, one candidate a batch (its own BN statistics),
        over the valid candidates' joint entries. Returns dict(loss_center,
        loss_pose)."""
        dev = heatmaps.device
        cp = camera_tensors(cameras, dev)
        center = self.center(self._volume(
            heatmaps, cp, self.space_grid(dev))[None])[0]
        loss_center = ((center - targets_3d) ** 2).mean()
        pose_abs = heatmaps.new_zeros(())
        pose_cnt = heatmaps.new_zeros(())
        for p in range(int(candidates.shape[0])):
            joints = self.pose_joints(heatmaps, cp, candidates[p:p + 1])[0]
            w = cand_mask[p] * gt_vis[p][:, None]
            pose_abs = pose_abs + ((joints - gt_joints[p]) * w).abs().sum()
            pose_cnt = pose_cnt + cand_mask[p] * joints.numel()
        return dict(loss_center=loss_center,
                    loss_pose=pose_abs / pose_cnt.clamp_min(1.0))

    def training_losses_batched(self, heatmaps, cam_params, candidates,
                                cand_mask, gt_joints, gt_vis, targets_3d):
        """G frames at once (JAX `training_losses_batched`): heatmaps
        [G, V, K, H, W], cam_params camera_tensors with a leading [G, V]
        axis, candidates [G, P, 3], cand_mask [G, P], gt_joints
        [G, P, K, 3], gt_vis [G, P, K], targets_3d [G, X, Y, Z]. The centre
        net takes the G space volumes and the pose net the G * P cubes as
        one batch each (padded candidates enter the BN statistics and leave
        the loss)."""
        g, p = candidates.shape[:2]
        dev = heatmaps.device
        space = self.space_grid(dev)
        cps = [{k: v[i] for k, v in cam_params.items()} for i in range(g)]
        space_vols = torch.stack([self._volume(heatmaps[i], cps[i], space)
                                  for i in range(g)])
        center = self.center(space_vols)
        loss_center = ((center - targets_3d) ** 2).mean()
        grids = torch.stack([self.cube_grids(candidates[i])
                             for i in range(g)])       # [G, P, X, Y, Z, 3]
        cubes = torch.cat([project_heatmaps_to_voxels(
            heatmaps[i], cps[i], grids[i]) for i in range(g)])
        joints = self.pose(cubes.permute(0, 4, 1, 2, 3),
                               grids.flatten(0, 1))
        joints = joints.reshape(g, p, self.num_joints, 3)
        w = cand_mask[..., None, None] * gt_vis[..., None]
        # under a data axis the sum and the count are the global batch's
        # (parallel/mesh.py `data_sum`): a mean of per-rank ratios would be
        # another loss
        pose_abs = data_sum(((joints - gt_joints) * w).abs().sum())
        pose_cnt = data_sum(cand_mask.sum()) * self.num_joints * 3
        return dict(loss_center=loss_center,
                    loss_pose=pose_abs / pose_cnt.clamp_min(1.0))

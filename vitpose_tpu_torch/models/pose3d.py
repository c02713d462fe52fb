"""3D pose lifting: the TCN backbone, the temporal regression head and the
PoseLifter, in PyTorch under mmpose's names.

Counterpart of vitpose_tpu/models/pose3d.py:23-138 (`TCN`,
`TemporalRegressionHead`, `PoseLifter`, `decode_pose3d`):

  * TCN over [N, T, K * 2] keypoint sequences as Conv1d on [N, K * 2, T]:
    `expand_conv` (conv kernel_sizes[0], no bias, flax BN, ReLU, dropout),
    then per further kernel size a `tcn_blocks.{i}` of a dilated conv1 and a
    1x1 conv2 (each `.0.conv` + `.0.bn`, ReLU, dropout) added to the
    residual, which is cropped by (k - 1) * dilation // 2 on each side; the
    dilation grows by each kernel size. BN is flax's (momentum 0.9 in
    flax's terms, eps 1e-5, `heads.batch_norm`); dropout keeps with
    probability 1 - p and scales by 1 / (1 - p), drawn from the caller's
    torch.Generator.
  * TemporalRegressionHead: the centre frame's features through a 1x1
    Conv1d (`keypoint_head.conv`, JAX's Dense 'fc') -> [N, K, 3].
  * PoseLifter with `with_traj`: a second TCN and a 1-joint head
    (`traj_backbone`, `traj_head`) give the global root, [N, 1, 3].
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .heads import batch_norm
from .vit import at_least_f32, compute_dtype, normal_


def dropout(x, p, generator):
    """flax nn.Dropout in training: keep with probability 1 - p, scaled by
    1 / (1 - p); the mask drawn from `generator` (a torch.Generator on x's
    device)."""
    if p <= 0:
        return x
    if generator is None:
        raise ValueError('dropout in training draws from a torch.Generator: '
                         'pass one (forward(..., generator=g))')
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=x.dtype) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), 0.0)


class ConvModule1d(nn.Module):
    """mmcv's ConvModule over sequences: `conv` (Conv1d, no bias) and `bn`."""

    def __init__(self, cin, cout, kernel, dilation=1):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, dilation=dilation,
                              bias=False)
        self.bn = nn.BatchNorm1d(cout, eps=1e-5)

    def forward(self, x, dtype):
        y = F.conv1d(x.to(dtype), self.conv.weight.to(dtype),
                     dilation=self.conv.dilation)
        return F.relu(batch_norm(self.bn, at_least_f32(y)[..., None])[..., 0]
                      ).to(dtype)


class TemporalBlock(nn.Module):
    """mmpose's BasicTemporalBlock: conv1 (dilated), conv2 (1x1)."""

    def __init__(self, channels, kernel, dilation):
        super().__init__()
        self.pad = (kernel - 1) * dilation // 2
        self.conv1 = nn.Sequential(ConvModule1d(channels, channels, kernel,
                                                dilation))
        self.conv2 = nn.Sequential(ConvModule1d(channels, channels, 1))


class TCN(nn.Module):
    """[N, C_in, T] -> [N, C, T'] (T' = T - receptive field + 1)."""

    def __init__(self, in_channels, stem_channels=1024,
                 kernel_sizes: Sequence[int] = (3, 3, 3), dropout=0.25,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.dropout = dropout
        c = stem_channels
        self.expand_conv = ConvModule1d(in_channels, c, kernel_sizes[0])
        blocks = []
        dilation = kernel_sizes[0]
        for k in kernel_sizes[1:]:
            blocks.append(TemporalBlock(c, k, dilation))
            dilation *= k
        self.tcn_blocks = nn.ModuleList(blocks)

    def forward(self, x, generator=None):
        dt = self.dtype
        p = self.dropout if self.training else 0.0
        x = dropout(self.expand_conv(x, dt), p, generator)
        for block in self.tcn_blocks:
            res = x[:, :, block.pad:x.shape[2] - block.pad]
            y = dropout(block.conv1[0](x, dt), p, generator)
            y = dropout(block.conv2[0](y, dt), p, generator)
            x = res + y
        return x


class TemporalRegressionHead(nn.Module):
    """[N, C, T'] -> [N, K, 3] from the centre frame."""

    def __init__(self, in_channels, num_joints, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.num_joints = num_joints
        self.conv = nn.Conv1d(in_channels, num_joints * 3, 1)

    def forward(self, x):
        dt = self.dtype
        x = x[:, :, x.shape[2] // 2].to(dt)
        out = F.linear(x, self.conv.weight[:, :, 0].to(dt),
                       self.conv.bias.to(dt))
        return out.reshape(-1, self.num_joints, 3)


class PoseLifter(nn.Module):
    """[N, T, K_in, 2] 2D keypoint windows -> [N, num_joints, 3]
    root-relative 3D poses, or with `with_traj` (pose, traj [N, 1, 3]).
    T must be the receptive field, the product of the kernel sizes. The
    input's joints K_in are the 2D keypoints (17 for H36M, also where the
    SimpleBaseline3D configs lift to 16 root-free joints)."""

    def __init__(self, num_joints=17, stem_channels=1024,
                 kernel_sizes=(3, 3, 3), with_traj=False, dropout=0.25,
                 in_joints=None, dtype='float32', generator=None):
        super().__init__()
        self.num_joints = num_joints
        self.kernel_sizes = tuple(kernel_sizes)
        self.with_traj = with_traj
        self.dtype = compute_dtype(dtype)
        cin = (in_joints or num_joints) * 2
        self.backbone = TCN(cin, stem_channels, kernel_sizes, dropout, dtype)
        self.keypoint_head = TemporalRegressionHead(stem_channels,
                                                    num_joints, dtype)
        if with_traj:
            self.traj_backbone = TCN(cin, stem_channels, kernel_sizes,
                                     dropout, dtype)
            self.traj_head = TemporalRegressionHead(stem_channels, 1, dtype)
        init_conv1d(self, generator)

    @property
    def receptive_field(self):
        return int(np.prod(self.kernel_sizes))

    def forward(self, kp2d_seq, generator=None):
        n, t, k, _ = kp2d_seq.shape
        x = kp2d_seq.reshape(n, t, k * 2).to(self.dtype).transpose(1, 2)
        pose = self.keypoint_head(self.backbone(x, generator))
        if not self.with_traj:
            return at_least_f32(pose)
        traj = self.traj_head(self.traj_backbone(x, generator))
        return at_least_f32(pose), at_least_f32(traj)


def init_conv1d(module, generator=None):
    """Seeded init of the Conv1d layers below `module` as
    `resnet.init_cnn` does the 2-D ones (normal, std fan_in ** -0.5, cut
    at two deviations; zero biases) and BN."""
    for m in module.modules():
        if isinstance(m, nn.Conv1d):
            normal_(m.weight, m.weight[0].numel() ** -0.5, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm1d):
            m.reset_parameters()


def decode_pose3d(output, target_root=None):
    """Global positions from root-relative predictions (reference
    temporal_regression_head.py:225, restore_global_position)."""
    output = np.asarray(output)
    if target_root is not None:
        output = output + np.asarray(target_root)[:, None, :]
    return output

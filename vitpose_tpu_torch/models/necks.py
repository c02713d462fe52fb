"""Necks: GlobalAveragePooling and PoseWarper's temporal aggregation.

Counterpart of vitpose_tpu/models/necks.py:20-126 under mmpose's names
(posewarper_neck.py), so that a reference .pth loads strictly:

  * `trans_layer`: one 1x1 conv with a bias, shared by every frame, from
    the backbone's channels to `out_channels` (`trans_conv_kernel` 0: the
    identity);
  * `offset_feats.{i}`: `num_blocks` ResNet BasicBlocks (flax BN) over the
    key-minus-support difference, the first projecting out_channels to
    `inner_channels` with a 1x1 `downsample`;
  * per dilation `offset_layers.{j}` (no bias, zero init, padding
    (k // 2) * dilation) and `deform_conv_layers.{j}.weight` (no bias,
    identity init: the centre tap's eye), `deform_groups` 0 meaning one
    group per output channel;
  * the warps are averaged over dilations and summed over frames with
    `frame_weight` (default 1 / T each).

Frames fold into the batch axis: the offset chain, the offset convs and the
deformable warps each run once over [N * T, ...]. Features are NCHW.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.deform_conv import deform_conv2d
from .resnet import BasicBlock, conv2d, init_cnn, make_downsample
from .vit import compute_dtype


class GlobalAveragePooling(nn.Module):
    """[N, C, H, W] -> [N, C] (mmpose gap_neck.py)."""

    def forward(self, x):
        return x.mean((2, 3))


class _DeformConv(nn.Module):
    """A deformable conv's parameter under mmcv DeformConv2d's name."""

    def __init__(self, channels, kernel):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, kernel,
                                               kernel))
        self.reset_parameters()

    def reset_parameters(self):
        c, k = self.weight.shape[0], self.weight.shape[2]
        with torch.no_grad():
            self.weight.zero_()
            self.weight[:, :, k // 2, k // 2] = torch.eye(c)


class PoseWarperNeck(nn.Module):
    def __init__(self, in_channels, out_channels=48, inner_channels=128,
                 kernel=3, offsets_kernel=3, num_blocks=20,
                 trans_conv_kernel=1, deform_groups=0,
                 dilations=(3, 6, 12, 18, 24), dtype='float32',
                 generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.kernel = kernel
        self.dilations = tuple(dilations)
        if trans_conv_kernel > 0:
            pad = (trans_conv_kernel - 1) // 2
            self.trans_layer = nn.Conv2d(in_channels, out_channels,
                                         trans_conv_kernel, padding=pad)
            co = out_channels
        else:
            self.trans_layer = None
            co = in_channels
        self.out_channels = co
        blocks = [BasicBlock(co, inner_channels, downsample=(
            make_downsample(co, inner_channels, 1, False)
            if co != inner_channels else None), dtype=dtype)]
        blocks += [BasicBlock(inner_channels, inner_channels, dtype=dtype)
                   for _ in range(1, num_blocks)]
        self.offset_feats = nn.Sequential(*blocks)
        self.groups = deform_groups or co
        ok = offsets_kernel
        self.offset_layers = nn.ModuleList([
            nn.Conv2d(inner_channels, 2 * ok * ok * self.groups, ok,
                      padding=(ok - 1) // 2 * d, dilation=d, bias=False)
            for d in self.dilations])
        self.deform_conv_layers = nn.ModuleList([
            _DeformConv(co, kernel) for _ in self.dilations])
        init_cnn(self, generator)
        for layer in self.offset_layers:
            nn.init.zeros_(layer.weight)
        for layer in self.deform_conv_layers:
            layer.reset_parameters()

    def forward(self, key, supports, frame_weight=None):
        """key [N, C, H, W], supports [N, T, C, H, W] (every frame of the
        window, the key among them) -> [N, out_channels, H, W]."""
        n, t, c, h, w = supports.shape
        dt = self.dtype
        sup = supports.reshape(n * t, c, h, w)
        if self.trans_layer is not None:
            key = conv2d(self.trans_layer, key, dt)
            sup = conv2d(self.trans_layer, sup, dt)
        diff = key.repeat_interleave(t, 0) - sup
        diff = self.offset_feats(diff)
        if frame_weight is None:
            fw = torch.full((t,), 1.0 / t, dtype=dt, device=sup.device)
        else:
            fw = torch.as_tensor(frame_weight, dtype=dt, device=sup.device)
        warped = None
        for d, off_layer, dcn in zip(self.dilations, self.offset_layers,
                                     self.deform_conv_layers):
            off = conv2d(off_layer, diff, dt)
            out = deform_conv2d(sup.to(dt), off, dcn.weight.to(dt),
                                padding=(self.kernel // 2) * d, dilation=d,
                                deform_groups=self.groups)
            warped = out if warped is None else warped + out
        warped = warped / len(self.dilations)
        co = warped.shape[1]
        return torch.einsum('t,ntchw->nchw', fw,
                            warped.reshape(n, t, co, h, w))

"""HRNet and HRNetV2 backbones in PyTorch, with mmpose's parameter names.

Counterpart of vitpose_tpu/models/hrnet.py: `HRNetConfig`, the exchange
module (`HRModule`, mmpose's name: per-branch basic blocks, then all-to-all
fusion) and `HRNet` (two stride-2 stem convs, four bottlenecks, the
transitions that add a branch at half the resolution, and the stages). The
output is the highest-resolution branch [N, W, H/4, W/4]; with
`multiscale_concat` (HRNetV2) the last module keeps every branch and the
output is their channel concat at 1/4 resolution, the lower branches
upsampled bilinearly (align_corners=False, jax.image.resize's 'bilinear').

Names as in mmpose hrnet.py: `conv1`/`bn1`/`conv2`/`bn2`, `layer1.{k}`,
`transition{s}.{b}` (a Sequential(conv, bn, ReLU) for a branch whose width
changes, Sequential(Sequential(conv, bn, ReLU)) for a new branch; None, so
absent from the state dict, where nothing changes), `stage{s}.{m}.branches.
{b}.{k}` and `stage{s}.{m}.fuse_layers.{i}.{j}`. Branch i takes from a
lower-resolution branch j > i a 1x1 conv and BN, then a nearest resize to
its size that samples at half-pixel centres as jax.image.resize does
(torch's 'nearest-exact'); from a higher-resolution branch j < i, i - j
strided 3x3 convs with BN, with a ReLU between them but not after the
last.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import (BasicBlock, Bottleneck, conv2d, init_cnn,
                     make_downsample, norm)
from .vit import compute_dtype


@dataclasses.dataclass(frozen=True)
class HRNetConfig:
    width: int = 32
    # modules per stage 2..4; basic blocks per branch in every module
    stage_modules: Tuple[int, ...] = (1, 4, 3)
    stage_blocks: int = 4
    # HRNetV2: the last module keeps every branch, the output concatenates
    # them at 1/4 resolution
    multiscale_concat: bool = False
    dtype: str = 'float32'

    @property
    def channels(self):
        w = self.width
        return (w, w * 2, w * 4, w * 8)


def _conv_bn(cin, cout, stride, relu):
    layers = [nn.Conv2d(cin, cout, 3, stride, 1, bias=False),
              nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


def _conv_bn_seq(seq, x, dtype):
    """A Sequential(conv, bn[, ReLU]) on `x`."""
    return norm(seq[1], conv2d(seq[0], x, dtype), dtype, relu=len(seq) == 3)


class HRModule(nn.Module):
    """One exchange module: `num_blocks` basic blocks per branch, then every
    target branch i sums what each branch j gives it and takes a ReLU.
    Without `multiscale` only branch 0 is fused (mmpose's
    multiscale_output=False)."""

    def __init__(self, channels, num_blocks, multiscale=True,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c, dtype=dtype)
                            for _ in range(num_blocks)]) for c in channels)
        n = len(channels)
        rows = []
        for i in range(n if multiscale else 1):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        nn.BatchNorm2d(channels[i])))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j],
                                 channels[i] if k == i - j - 1
                                 else channels[j], 2, k < i - j - 1)
                        for k in range(i - j)]))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        dt = self.dtype
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                y = outs[j]
                if j > i:
                    y = norm(layer[1], conv2d(layer[0], y, dt), dt)
                    y = F.interpolate(y, size=outs[i].shape[-2:],
                                      mode='nearest-exact')
                elif j < i:
                    for seq in layer:
                        y = _conv_bn_seq(seq, y, dt)
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


class HRNet(nn.Module):
    """[N, H, W, 3] crops -> [N, C, H/4, W/4] features in the compute dtype:
    C = width, or 15 * width with `multiscale_concat`."""

    def __init__(self, cfg: HRNetConfig = HRNetConfig(), generator=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg.dtype)
        chans = cfg.channels
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if k == 0 else 256, 64,
                       downsample=(make_downsample(64, 256, 1, False)
                                   if k == 0 else None), dtype=cfg.dtype)
            for k in range(4)])
        self.transition1 = nn.ModuleList([
            _conv_bn(256, chans[0], 1, True),
            nn.Sequential(_conv_bn(256, chans[1], 2, True))])
        n_stages = len(cfg.stage_modules)
        for stage, n_mod in enumerate(cfg.stage_modules):
            n_br = stage + 2
            mods = []
            for m in range(n_mod):
                last = stage == n_stages - 1 and m == n_mod - 1
                mods.append(HRModule(chans[:n_br], cfg.stage_blocks,
                                     multiscale=not last
                                     or cfg.multiscale_concat,
                                     dtype=cfg.dtype))
            self.add_module(f'stage{stage + 2}', nn.Sequential(*mods))
            if stage < n_stages - 1:
                # a new branch from the lowest-resolution one
                self.add_module(f'transition{stage + 2}', nn.ModuleList(
                    [None] * n_br + [nn.Sequential(_conv_bn(
                        chans[n_br - 1], chans[n_br], 2, True))]))
        self.out_channels = (sum(chans[:n_stages + 1])
                             if cfg.multiscale_concat else chans[0])
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        x = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        x = norm(self.bn2, conv2d(self.conv2, x, dt), dt, relu=True)
        x = self.layer1(x)
        xs = [_conv_bn_seq(self.transition1[0], x, dt),
              _conv_bn_seq(self.transition1[1][0], x, dt)]
        n_stages = len(self.cfg.stage_modules)
        for stage in range(n_stages):
            for module in getattr(self, f'stage{stage + 2}'):
                xs = module(xs)
            if stage < n_stages - 1:
                new = getattr(self, f'transition{stage + 2}')[-1][0]
                xs = xs + [_conv_bn_seq(new, xs[-1], dt)]
        if not self.cfg.multiscale_concat:
            return xs[0]
        size = xs[0].shape[-2:]
        return torch.cat([xs[0]] + [
            F.interpolate(y, size=size, mode='bilinear', align_corners=False)
            for y in xs[1:]], dim=1)

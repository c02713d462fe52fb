"""The lightweight and stacked backbones MobileNetV2, ShuffleNetV2, stacked
Hourglass and Hourglass-AE in PyTorch, with mmpose's parameter names.

Counterpart of vitpose_tpu/models/lightweight.py: `InvertedResidual` and
`MobileNetV2` (:18-72; channels max(8, int(ch * w + 4) // 8 * 8), ReLU6),
`ShuffleUnit` and `ShuffleNetV2` (:75-145; the split, the concatenation and
the shuffle in 2 groups), `_res_layer` (:148; BasicBlocks, the stride and
width change in the first block or, with downsample_first=False, the last),
`HourglassModule` and `Hourglass` (:182-250), `HourglassAEModule` and
`HourglassAE` (:253-320; 2x2 unpadded max pools).

Names: mmpose's, which the JAX package's `convert_mobilenet_v2`,
`convert_shufflenet_v2`, `convert_hourglass` and `convert_hourglass_ae`
read (`conv1.conv`, `layer{i}.{j}.conv.{k}.conv`, `conv2.conv`;
`layers.{s}.{b}.branch{1,2}.{k}.conv`, `layers.3.conv`; `stem.{0,1}`,
`hourglass_modules.{i}.{up1,low1,low2,low3}.{k}`, `out_convs.{i}`,
`conv1x1s.{i}`, `remap_convs.{i}`, `inters.{i}`; `stem.{0,1,3,4}`,
`hourglass_modules.{i}.{0,1,2}`, `out_convs.{i}.conv`,
`remap_out_convs.{i}`, `remap_feature_convs.{i}`), so a reference .pth
loads with strict=True.

The crops come in NHWC and are read through a permuted view; convs run in
the compute dtype, BN in f32 (`resnet.norm`). Hourglass and Hourglass-AE
return a list of NCHW maps, one per stack; the nearest x2 upsampling is
torch's 'nearest-exact' (JAX's 'nearest').
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .more_cnns import ConvBN, channel_shuffle
from .multistage_nets import resize_nearest
from .resnet import (BasicBlock, BiasConv, conv2d, init_cnn,
                     make_downsample)
from .vit import compute_dtype


class InvertedResidual(nn.Module):
    """`conv`: a 1x1 expansion (when expand != 1), a 3x3 depthwise conv
    (both ReLU6) and a 1x1 projection (no activation); the input added where
    the shape holds."""

    def __init__(self, cin, cout, stride=1, expand=6, dtype='float32'):
        super().__init__()
        mid = cin * expand
        layers = ([ConvBN(cin, mid, 1, act='relu6', dtype=dtype)]
                  if expand != 1 else [])
        layers += [ConvBN(mid, mid, 3, stride, groups=mid, act='relu6',
                            dtype=dtype),
                   ConvBN(mid, cout, 1, dtype=dtype)]
        self.conv = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.conv(x)
        return x + y if self.residual else y


class MobileNetV2(nn.Module):
    """[N, H, W, 3] -> [N, 1280, H/32, W/32]."""
    # (expand, out, repeats, stride)
    ARCH = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))

    def __init__(self, widen_factor=1.0, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)

        def c(ch):
            return max(8, int(ch * widen_factor + 4) // 8 * 8)

        self.conv1 = ConvBN(3, c(32), 3, 2, act='relu6', dtype=dtype)
        cin = c(32)
        for li, (e, ch, n, s) in enumerate(self.ARCH):
            blocks = []
            for bi in range(n):
                blocks.append(InvertedResidual(cin, c(ch), s if bi == 0 else 1,
                                               e, dtype))
                cin = c(ch)
            self.add_module(f'layer{li + 1}', nn.Sequential(*blocks))
        self.conv2 = ConvBN(cin, 1280, 1, act='relu6', dtype=dtype)
        self.out_channels = 1280
        init_cnn(self, generator)

    def forward(self, imgs):
        x = self.conv1(imgs.permute(0, 3, 1, 2))
        for li in range(len(self.ARCH)):
            x = getattr(self, f'layer{li + 1}')(x)
        return self.conv2(x)


class ShuffleUnit(nn.Module):
    """ShuffleNetV2's unit: stride 1 keeps the first half and runs
    `branch2` (1x1 + ReLU, 3x3 depthwise, 1x1 + ReLU) on the second; stride
    2 runs `branch1` (3x3/2 depthwise, 1x1 + ReLU) and `branch2` on the
    whole input; the halves concatenated and shuffled in 2 groups."""

    def __init__(self, cin, cout, stride=1, dtype='float32'):
        super().__init__()
        half = cout // 2
        self.stride = stride
        if stride > 1:
            self.branch1 = nn.Sequential(
                ConvBN(cin, cin, 3, 2, groups=cin, dtype=dtype),
                ConvBN(cin, half, 1, dtype=dtype, act='relu'))
        self.branch2 = nn.Sequential(
            ConvBN(cin if stride > 1 else half, half, 1, dtype=dtype,
                   act='relu'),
            ConvBN(half, half, 3, stride, groups=half, dtype=dtype),
            ConvBN(half, half, 1, dtype=dtype, act='relu'))

    def forward(self, x):
        if self.stride == 1:
            x1, x2 = x.chunk(2, 1)
            out = torch.cat([x1, self.branch2(x2)], 1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Module):
    """The stem (`conv1`, 3x3/2, 24 wide, and the 3x3/2 max pool), three
    stages of 4, 8 and 4 units in `layers.{0,1,2}` and the 1x1 ConvModule
    to 1024 in `layers.3`: [N, H, W, 3] -> [N, 1024, H/32, W/32]."""
    CHANNELS = {0.5: (48, 96, 192), 1.0: (116, 232, 464),
                1.5: (176, 352, 704), 2.0: (244, 488, 976)}

    def __init__(self, widen_factor=1.0, dtype='float32', generator=None):
        super().__init__()
        if widen_factor not in self.CHANNELS:
            raise KeyError(f'ShuffleNetV2 widen_factor {widen_factor}: '
                           f'expected one of {sorted(self.CHANNELS)}')
        self.dtype = compute_dtype(dtype)
        self.conv1 = ConvBN(3, 24, 3, 2, dtype=dtype, act='relu')
        layers, cin = [], 24
        for ch, reps in zip(self.CHANNELS[widen_factor], (4, 8, 4)):
            units = []
            for bi in range(reps):
                units.append(ShuffleUnit(cin, ch, 2 if bi == 0 else 1,
                                         dtype))
                cin = ch
            layers.append(nn.Sequential(*units))
        layers.append(ConvBN(cin, 1024, 1, dtype=dtype, act='relu'))
        self.layers = nn.Sequential(*layers)
        self.out_channels = 1024
        init_cnn(self, generator)

    def forward(self, imgs):
        x = F.max_pool2d(self.conv1(imgs.permute(0, 3, 1, 2)), 3, 2, 1)
        return self.layers(x)


def res_layer(num_blocks, in_ch, out_ch, stride=1, downsample_first=True,
              dtype='float32'):
    """mmpose's ResLayer of BasicBlocks: the stride and width change, with
    the shortcut conv (`downsample.{0,1}`), in the first block, or in the
    last with `downsample_first=False` (the hourglass's `low3`)."""
    blocks = []
    for k in range(num_blocks):
        edge = k == 0 if downsample_first else k == num_blocks - 1
        cin = in_ch if downsample_first and k == 0 or not downsample_first \
            else out_ch
        cout = out_ch if downsample_first or edge else in_ch
        s = stride if edge else 1
        ds = (make_downsample(cin, cout, s, False)
              if edge and (stride != 1 or in_ch != out_ch) else None)
        blocks.append(BasicBlock(cin, cout, s, ds, dtype))
    return nn.Sequential(*blocks)


class HourglassModule(nn.Module):
    """`up1` at this depth's width; `low1` (stride 2 to the next width),
    `low2` (the next depth, or a ResLayer at the bottom), `low3` (back to
    this width in its last block), upsampled x2 (nearest) and added."""

    def __init__(self, depth, stage_channels, stage_blocks, dtype='float32'):
        super().__init__()
        cur_b, next_b = stage_blocks[0], stage_blocks[1]
        cur_c, next_c = stage_channels[0], stage_channels[1]
        self.up1 = res_layer(cur_b, cur_c, cur_c, dtype=dtype)
        self.low1 = res_layer(cur_b, cur_c, next_c, 2, dtype=dtype)
        self.low2 = (HourglassModule(depth - 1, stage_channels[1:],
                                     stage_blocks[1:], dtype)
                     if depth > 1 else
                     res_layer(next_b, next_c, next_c, dtype=dtype))
        self.low3 = res_layer(cur_b, next_c, cur_c, downsample_first=False,
                              dtype=dtype)

    def forward(self, x):
        low = self.low3(self.low2(self.low1(x)))
        return self.up1(x) + resize_nearest(low, tuple(2 * s for s in
                                                       low.shape[2:]))


class Hourglass(nn.Module):
    """Stacked hourglass (Hourglass-52/104): `stem` (7x7/2 ConvModule to
    128, a ResLayer of one strided block to 256), then per stack the
    hourglass, `out_convs.{i}` (3x3 ConvModule) and, between stacks,
    `conv1x1s.{i}` + `remap_convs.{i}` (1x1, no ReLU) summed, ReLU and
    `inters.{i}` (a BasicBlock). [N, H, W, 3] -> a list of [N,
    feat_channel, H/4, W/4], one per stack."""

    def __init__(self, downsample_times=5, num_stacks=2,
                 stage_channels: Sequence[int] = (256, 256, 384, 384, 384,
                                                  512),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 feat_channel=256, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        cur = stage_channels[0]
        self.stem = nn.Sequential(
            ConvBN(3, 128, 7, 2, dtype=dtype, act='relu'),
            res_layer(1, 128, 256, 2, dtype=dtype))
        self.hourglass_modules = nn.ModuleList(
            HourglassModule(downsample_times, stage_channels, stage_blocks,
                            dtype) for _ in range(num_stacks))
        self.out_convs = nn.ModuleList(
            ConvBN(cur, feat_channel, 3, dtype=dtype, act='relu')
            for _ in range(num_stacks))
        self.conv1x1s = nn.ModuleList(
            ConvBN(cur, cur, 1, dtype=dtype)
            for _ in range(num_stacks - 1))
        self.remap_convs = nn.ModuleList(
            ConvBN(feat_channel, cur, 1, dtype=dtype)
            for _ in range(num_stacks - 1))
        self.inters = nn.ModuleList(BasicBlock(cur, cur, dtype=dtype)
                                    for _ in range(num_stacks - 1))
        self.out_channels = feat_channel
        init_cnn(self, generator)

    def forward(self, imgs):
        x = self.stem(imgs.permute(0, 3, 1, 2))
        outs = []
        for si, (hg, out_conv) in enumerate(zip(self.hourglass_modules,
                                                self.out_convs)):
            out = out_conv(hg(x))
            outs.append(out)
            if si < len(self.inters):
                x = self.inters[si](F.relu(self.conv1x1s[si](x)
                                           + self.remap_convs[si](out)))
        return outs


class HourglassAEModule(nn.Module):
    """`up1` (3x3 ConvModule); a 2x2 max pool, `low1` to the next width,
    `low2` (the next depth or a ConvModule), `low3` back, upsampled x2
    (nearest) and added."""

    def __init__(self, depth, stage_channels, dtype='float32'):
        super().__init__()
        cur_c, next_c = stage_channels[0], stage_channels[1]
        self.up1 = ConvBN(cur_c, cur_c, 3, dtype=dtype, act='relu')
        self.low1 = ConvBN(cur_c, next_c, 3, dtype=dtype, act='relu')
        self.low2 = (HourglassAEModule(depth - 1, stage_channels[1:], dtype)
                     if depth > 1 else ConvBN(next_c, next_c, 3,
                                                dtype=dtype, act='relu'))
        self.low3 = ConvBN(next_c, cur_c, 3, dtype=dtype, act='relu')

    def forward(self, x):
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return self.up1(x) + resize_nearest(low, tuple(2 * s for s in
                                                       low.shape[2:]))


class HourglassAE(nn.Module):
    """Hourglass-AE: `stem` (7x7/2 to 64, 3x3 to 128, a 2x2 max pool, 3x3
    to 128 and to feat_channels), then per stack `hourglass_modules.{i}`
    (the hourglass and two 3x3 ConvModules) and `out_convs.{i}` (a 1x1 conv
    with a bias to out_channels, the stack's prediction); between stacks the
    input plus `remap_out_convs.{i}` of the prediction and
    `remap_feature_convs.{i}` of the features (1x1, no ReLU). [N, H, W, 3]
    -> a list of [N, out_channels, H/4, W/4] maps, one per stack."""

    def __init__(self, downsample_times=4, num_stacks=1, out_channels=34,
                 stage_channels: Sequence[int] = (256, 384, 512, 640, 768),
                 feat_channels=256, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        f = feat_channels
        self.stem = nn.Sequential(
            ConvBN(3, 64, 7, 2, dtype=dtype, act='relu'),
            ConvBN(64, 128, 3, dtype=dtype, act='relu'), nn.MaxPool2d(2, 2),
            ConvBN(128, 128, 3, dtype=dtype, act='relu'),
            ConvBN(128, f, 3, dtype=dtype, act='relu'))
        self.hourglass_modules = nn.ModuleList(nn.Sequential(
            HourglassAEModule(downsample_times, stage_channels, dtype),
            ConvBN(f, f, 3, dtype=dtype, act='relu'),
            ConvBN(f, f, 3, dtype=dtype, act='relu'))
            for _ in range(num_stacks))
        self.out_convs = nn.ModuleList(BiasConv(f, out_channels)
                                       for _ in range(num_stacks))
        self.remap_out_convs = nn.ModuleList(
            ConvBN(out_channels, f, 1, dtype=dtype)
            for _ in range(num_stacks - 1))
        self.remap_feature_convs = nn.ModuleList(
            ConvBN(f, f, 1, dtype=dtype)
            for _ in range(num_stacks - 1))
        self.out_channels = out_channels
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = self.stem(imgs.permute(0, 3, 1, 2))
        outs = []
        for si, hg in enumerate(self.hourglass_modules):
            feat = hg(x)
            out = conv2d(self.out_convs[si].conv, feat, dt)
            outs.append(out)
            if si < len(self.remap_out_convs):
                x = (x + self.remap_out_convs[si](out)
                     + self.remap_feature_convs[si](feat))
        return outs

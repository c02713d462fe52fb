"""The classic CNN backbones in PyTorch: SE-ResNet, VGG and AlexNet, with the
squeeze-and-excitation gate they share with SE-ResNeXt and ViPNAS.

Counterpart of vitpose_tpu/models/classic_cnns.py: `SELayer` (:64, also
the 'hsigmoid' gate, mmcv's HSigmoid(bias=3, divisor=6)), `SEBottleneck`
and `SEResNet` (:86-143), `VGG` (:24, with and without BN) and `AlexNet`
(:44), and `CPM` (:146; flax's padded max pools pad with -inf, as
torch's do).

Names: SE-ResNet takes mmpose's (`layer{i}.{j}.conv{k}`, `bn{k}`,
`downsample.{0,1}`, `se_layer.conv{1,2}.conv`: the SE layer is a pair of
1x1 convs with a bias, which the JAX package's converter squeezes into its
Dense layers), so a reference .pth loads with strict=True. The JAX package
has no converter for VGG or AlexNet: their modules take the flax names
(`conv{stage}_{i}`, `bn{stage}_{i}`; `conv1`...`conv5`), and their
checkpoints are the port's own or the JAX package's .npz. CPM takes
mmpose's (`stem.{0,2,4,6,7,8}` ConvModules between the max pools and the
biased `stem.9.conv`; `middle.{0,2,4}`, `middle_conv.{t}.0`,
`cpm_stages.{t}.model.{0,1,2}`, `out_convs.{t}.0` and the biased
`out_convs.{t}.1.conv`), which `convert_cpm` reads.

The crops come in NHWC and are read through a permuted view
(channels_last); convs run in the compute dtype, BN in f32 with flax's
semantics, its output cast (`resnet.conv2d`, `resnet.norm`). Max pools
without padding floor, as flax's 'VALID' pools do.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import (BiasConv, ConvModule, ResNetTrunk, bottleneck_layers,
                     conv2d, init_cnn, norm, shortcut)
from .vit import compute_dtype

VGG_SPECS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def squeeze_excite(x, fc1, fc2, gate, dtype):
    """x * gate(fc2(relu(fc1(mean over H, W of x)))) with fc1 and fc2 1x1
    convs or linear layers, all in `dtype`; gate 'sigmoid' or 'hsigmoid'
    (clip((s + 3) / 6, 0, 1))."""
    s = x.to(dtype).mean((2, 3))
    if isinstance(fc1, nn.Conv2d):
        s = s[:, :, None, None]
        s = conv2d(fc2, F.relu(conv2d(fc1, s, dtype)), dtype)
    else:
        s = F.linear(F.relu(F.linear(s, fc1.weight.to(dtype),
                                     fc1.bias.to(dtype))),
                     fc2.weight.to(dtype), fc2.bias.to(dtype))[..., None,
                                                                None]
    if gate == 'hsigmoid':
        s = ((s + 3.0) / 6.0).clamp(0.0, 1.0)
    else:
        s = s.sigmoid()
    return x.to(dtype) * s


class SELayer(nn.Module):
    """mmpose's SELayer: average over H and W, `conv1.conv` (1x1, to
    max(int(C / ratio), 1) channels) + ReLU, `conv2.conv` (1x1, back to C),
    the gate, and the input scaled by it."""

    def __init__(self, channels, ratio=16, gate='sigmoid', dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.gate = gate
        squeeze = max(int(channels / ratio), 1)
        self.conv1 = BiasConv(channels, squeeze)
        self.conv2 = BiasConv(squeeze, channels)

    def forward(self, x):
        return squeeze_excite(x, self.conv1.conv, self.conv2.conv, self.gate,
                              self.dtype)


class SEBottleneck(nn.Module):
    """The ResNet bottleneck (expansion 4) with the SE gate after bn3,
    before the residual add."""

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 se_ratio=16, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.se_layer = SELayer(planes * 4, se_ratio, dtype=dtype)
        self.downsample = downsample

    def forward(self, x):
        dt = self.dtype
        y = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        y = norm(self.bn2, conv2d(self.conv2, y, dt), dt, relu=True)
        y = self.se_layer(norm(self.bn3, conv2d(self.conv3, y, dt), dt))
        return F.relu(y + shortcut(self.downsample, x.to(dt), dt))


def SEResNet(depth=50, se_ratio=16, dtype='float32', generator=None):
    """SE-ResNet (reference seresnet.py): [N, H, W, 3] -> [N, 2048, H/32,
    W/32]."""
    layers, out = bottleneck_layers(
        lambda cin, planes, s, ds: SEBottleneck(cin, planes, s, ds, se_ratio,
                                                dtype), depth)
    return ResNetTrunk(layers, out, dtype=dtype, generator=generator)


class VGG(nn.Module):
    """Five stages of 3x3 convs (64, 128, 256, 512, 512 wide; with BN and
    no conv bias when `with_bn`), ReLU, and a 2x2/2 max pool after each:
    [N, H, W, 3] -> [N, 512, H // 32, W // 32]."""

    def __init__(self, depth=16, with_bn=False, dtype='float32',
                 generator=None):
        super().__init__()
        if depth not in VGG_SPECS:
            raise KeyError(f'VGG depth {depth}: expected one of '
                           f'{sorted(VGG_SPECS)}')
        self.dtype = compute_dtype(dtype)
        self.with_bn = with_bn
        self.layout = []
        cin = 3
        for si, (reps, ch) in enumerate(zip(VGG_SPECS[depth],
                                            (64, 128, 256, 512, 512))):
            for bi in range(reps):
                self.add_module(f'conv{si}_{bi}', nn.Conv2d(
                    cin, ch, 3, padding=1, bias=not with_bn))
                if with_bn:
                    self.add_module(f'bn{si}_{bi}', nn.BatchNorm2d(ch))
                cin = ch
            self.layout.append(reps)
        self.out_channels = cin
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        for si, reps in enumerate(self.layout):
            for bi in range(reps):
                x = conv2d(getattr(self, f'conv{si}_{bi}'), x, dt)
                x = (norm(getattr(self, f'bn{si}_{bi}'), x, dt, relu=True)
                     if self.with_bn else F.relu(x))
            x = F.max_pool2d(x, 2, 2)
        return x


class AlexNet(nn.Module):
    """conv1 11x11/4 (pad 2), conv2 5x5 (pad 2), conv3-5 3x3 (384, 256,
    256), each with a bias and ReLU; 3x3/2 max pools without padding after
    conv1, conv2 and conv5: [N, H, W, 3] -> [N, 256, h, w] (7x5 at
    256x192)."""

    def __init__(self, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv2d(3, 64, 11, 4, 2)
        self.conv2 = nn.Conv2d(64, 192, 5, padding=2)
        self.conv3 = nn.Conv2d(192, 384, 3, padding=1)
        self.conv4 = nn.Conv2d(384, 256, 3, padding=1)
        self.conv5 = nn.Conv2d(256, 256, 3, padding=1)
        self.out_channels = 256
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        for i in range(1, 6):
            x = F.relu(conv2d(getattr(self, f'conv{i}'), x, dt))
            if i in (1, 2, 5):
                x = F.max_pool2d(x, 3, 2)
        return x


class CPM(nn.Module):
    """Convolutional Pose Machines: `stem` gives the stage-1 maps (three
    9x9 ConvModules each before a 3x3/2 max pool, 5x5 to 32, 9x9 to 512,
    1x1 to 512, the 1x1 prediction conv); `middle` the shared features
    (three 9x9 ConvModules and pools); each later stage t concatenates the
    previous maps and `middle_conv.{t}` (5x5 to middle_channels) into
    `cpm_stages.{t}` (three 11x11 ConvModules) and `out_convs.{t}` (a 1x1
    ConvModule and the prediction conv). [N, H, W, 3] -> a list of
    num_stages [N, out_channels, H/8, W/8] maps in the compute dtype."""

    def __init__(self, out_channels=17, num_stages=6, feat_channels=128,
                 middle_channels=32, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        k, f = out_channels, feat_channels

        def cbr(cin, cout, kernel):
            return ConvModule(cin, cout, kernel, 1, (kernel - 1) // 2, dtype)

        pool = nn.MaxPool2d(3, 2, 1)
        self.stem = nn.Sequential(
            cbr(3, 128, 9), pool, cbr(128, 128, 9), pool, cbr(128, 128, 9),
            pool, cbr(128, 32, 5), cbr(32, 512, 9), cbr(512, 512, 1),
            BiasConv(512, k))
        self.middle = nn.Sequential(cbr(3, 128, 9), pool, cbr(128, 128, 9),
                                    pool, cbr(128, 128, 9), pool)
        self.middle_conv = nn.ModuleList(
            nn.Sequential(cbr(128, middle_channels, 5))
            for _ in range(num_stages - 1))
        self.cpm_stages = nn.ModuleList(nn.Module() for _ in
                                        range(num_stages - 1))
        for stage in self.cpm_stages:
            stage.model = nn.Sequential(cbr(k + middle_channels, f, 11),
                                        cbr(f, f, 11), cbr(f, f, 11))
        self.out_convs = nn.ModuleList(
            nn.Sequential(cbr(f, f, 1), BiasConv(f, k))
            for _ in range(num_stages - 1))
        self.out_channels = k
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        out = conv2d(self.stem[-1].conv, self.stem[:-1](x), dt)
        m = self.middle(x)
        outs = [out]
        for mid, stage, head in zip(self.middle_conv, self.cpm_stages,
                                    self.out_convs):
            y = stage.model(torch.cat([outs[-1], mid(m)], 1))
            outs.append(conv2d(head[1].conv, head[0](y), dt))
        return outs

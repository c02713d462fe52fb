"""The other single-stage CNN backbones in PyTorch: SCNet, ResNeSt,
ShuffleNetV1, ViPNAS-ResNet, ViPNAS-MobileNetV3, RegNet and MobileNetV3.

Counterpart of vitpose_tpu/models/more_cnns.py: `_hswish` (:21),
`SCConv` and `SCBottleneck` (:25-90; the calibration pool clamped to the
map, r = max(1, min(4, H, W)), and JAX's nearest resize, torch's
'nearest-exact'), `ContextBlock`, `ViPNASBottleneck` and `ViPNASResNet`
(:93-189), `SplitAttention` and `ResNeStBottleneck` (:192-243; JAX's
block: no BN in the attention path, no cardinality, the stride as a 3x3
average pool that counts its padding), `_ResNetLike` with `SCNet` and
`ResNeSt` (:246-279, here `resnet.ResNetTrunk` over `bottleneck_layers`),
`RegNet` (:282), `MobileNetV3` (:322), `ShuffleNetV1` (:363; the channel
shuffle, the ungrouped first unit, the strided units' concatenation of the
average-pooled input) and `ViPNASMobileNetV3` (:417).

Names. SCNet, ViPNAS-ResNet and ViPNAS-MobileNetV3 take mmpose's
(`layer{i}.{j}.k1.0`, `scconv.k2.1`, ...; `attention.conv_mask`,
`attention.channel_add_conv.{0,1,3}` with mmpose's LayerNorm([planes, 1,
1]); `conv1.conv`, `layer{n}.{expand_conv,depthwise_conv,linear_conv}.
{conv,bn}` and `layer{n}.se.conv{1,2}.conv`, numbered flat in stage-major
order), which the JAX package's converters read, so a reference .pth loads
with strict=True. The JAX package has no converter for ResNeSt, ShuffleNetV1,
RegNet or MobileNetV3: their modules take the flax names (`layer{i}.{j}.
splat.fc1`, `s{i}b{j}_g1`, `s{i}b{j}_c2`, `b{i}_se.fc1`, ...; a strided
block's `ds`/`ds_bn` as `downsample.{0,1}`), and their checkpoints are the
port's own or the JAX package's .npz. Dense layers are nn.Linear there and
1x1 convs under the mmpose names.

The crops come in NHWC and are read through a permuted view
(channels_last); convs, Dense layers, softmaxes and gates run in the compute
dtype, BN and LayerNorm statistics in f32 (`resnet.norm`), as flax does.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .classic_cnns import SELayer, squeeze_excite
from .resnet import (ResNetTrunk, bottleneck_layers, conv2d, init_cnn,
                     make_downsample, norm, shortcut)
from .vit import at_least_f32, compute_dtype


def _hswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def _activate(x, kind):
    return _hswish(x) if kind == 'hswish' else F.relu(x)


def _conv_bn(cin, cout, k, stride=1, groups=1):
    """Sequential(conv without a bias, padding k // 2; BN)."""
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, k // 2,
                                   groups=groups, bias=False),
                         nn.BatchNorm2d(cout))


def _run(seq, x, dtype, relu=False):
    """The last conv and BN of a Sequential on `x`."""
    return norm(seq[-1], conv2d(seq[-2], x, dtype), dtype, relu=relu)


_ACTS = {None: lambda x: x, 'relu': F.relu, 'relu6': F.relu6}


class ConvBN(nn.Module):
    """mmcv's ConvModule with BN: `conv` (no bias, padding k // 2) and `bn`,
    then `act` (None: left to the caller, 'relu' or 'relu6')."""

    def __init__(self, cin, cout, k, stride=1, groups=1, dtype='float32',
                 act=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.act = act
        self.conv = nn.Conv2d(cin, cout, k, stride, k // 2, groups=groups,
                              bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return _ACTS[self.act](norm(self.bn, conv2d(self.conv, x, self.dtype),
                                    self.dtype))


# --- SCNet -------------------------------------------------------------------

class SCConv(nn.Module):
    """Self-calibrated conv: a gate from the average-pooled map (k2, nearest
    upsampling back) scales k3's output at full resolution; k4 carries the
    stride and the ReLU. `k2` is [AvgPool2d, conv, BN] as mmpose's; the
    pool's size is clamped to the map at run time."""

    def __init__(self, channels, stride=1, pooling_r=4, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.pooling_r = pooling_r
        self.k2 = nn.Sequential(nn.AvgPool2d(pooling_r, pooling_r),
                                *_conv_bn(channels, channels, 3))
        self.k3 = _conv_bn(channels, channels, 3)
        self.k4 = _conv_bn(channels, channels, 3, stride)

    def forward(self, x):
        dt = self.dtype
        h, w = x.shape[2:]
        r = max(1, min(self.pooling_r, h, w))
        down = _run(self.k2, F.avg_pool2d(x, r, r), dt)
        up = F.interpolate(down, size=(h, w), mode='nearest-exact')
        y = _run(self.k3, x, dt) * torch.sigmoid(x + up)
        return _run(self.k4, y, dt, relu=True)


class SCBottleneck(nn.Module):
    """Two half-width branches, plain (conv1, k1) and self-calibrated
    (conv2, scconv), concatenated into conv3 (expansion 4)."""

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        half = planes // 2
        self.conv1 = nn.Conv2d(inplanes, half, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(half)
        self.k1 = _conv_bn(half, half, 3, stride)
        self.conv2 = nn.Conv2d(inplanes, half, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(half)
        self.scconv = SCConv(half, stride, dtype=dtype)
        self.conv3 = nn.Conv2d(2 * half, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        dt = self.dtype
        a = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        a = _run(self.k1, a, dt, relu=True)
        b = norm(self.bn2, conv2d(self.conv2, x, dt), dt, relu=True)
        b = self.scconv(b)
        y = norm(self.bn3, conv2d(self.conv3, torch.cat([a, b], 1), dt), dt)
        return F.relu(y + shortcut(self.downsample, x.to(dt), dt))


def SCNet(depth=50, dtype='float32', generator=None):
    """[N, H, W, 3] -> [N, 2048, H/32, W/32]."""
    layers, out = bottleneck_layers(
        lambda cin, planes, s, ds: SCBottleneck(cin, planes, s, ds, dtype),
        depth)
    return ResNetTrunk(layers, out, dtype=dtype, generator=generator)


# --- ResNeSt -----------------------------------------------------------------

class SplitAttention(nn.Module):
    """A 3x3 conv of `radix` groups to radix x C channels (+ BN, ReLU); the
    splits' sum, averaged over H and W, through fc1 (max(C // 4, 32) wide,
    ReLU) and fc2 gives a softmax over the radix per channel, which weighs
    the splits' sum."""

    def __init__(self, channels, radix=2, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.channels, self.radix = channels, radix
        self.conv = nn.Conv2d(channels, channels * radix, 3, 1, 1,
                              groups=radix, bias=False)
        self.bn = nn.BatchNorm2d(channels * radix)
        inter = max(channels // 4, 32)
        self.fc1 = nn.Linear(channels, inter)
        self.fc2 = nn.Linear(inter, channels * radix)

    def forward(self, x):
        dt = self.dtype
        y = norm(self.bn, conv2d(self.conv, x, dt), dt, relu=True)
        # the NHWC [n, h, w, radix, C] of JAX is [n, radix, C, h, w] here
        splits = y.unflatten(1, (self.radix, self.channels))
        gap = splits.sum(1).mean((2, 3))
        att = F.relu(F.linear(gap, self.fc1.weight.to(dt),
                              self.fc1.bias.to(dt)))
        att = F.linear(att, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        att = torch.softmax(att.unflatten(1, (self.radix, self.channels)), 1)
        return (splits * att[..., None, None]).sum(1)


class ResNeStBottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=None, radix=2,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.splat = SplitAttention(planes, radix, dtype)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        dt = self.dtype
        y = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        y = self.splat(y)
        if self.stride > 1:
            # flax's avg_pool counts the padding, as torch's default does
            y = F.avg_pool2d(y, 3, self.stride, 1)
        y = norm(self.bn3, conv2d(self.conv3, y, dt), dt)
        return F.relu(y + shortcut(self.downsample, x.to(dt), dt))


def ResNeSt(depth=50, dtype='float32', generator=None):
    """[N, H, W, 3] -> [N, 2048, H/32, W/32]."""
    layers, out = bottleneck_layers(
        lambda cin, planes, s, ds: ResNeStBottleneck(cin, planes, s, ds,
                                                     dtype=dtype), depth)
    return ResNetTrunk(layers, out, dtype=dtype, generator=generator)


# --- ViPNAS-ResNet -----------------------------------------------------------

class ContextBlock(nn.Module):
    """GCNet's global context (mmcv context_block.py): a softmax over H x W
    of `conv_mask` pools the map to one vector per image; channel_add_conv
    (1x1 conv, LayerNorm([planes, 1, 1]), ReLU, 1x1 conv; JAX's Dense,
    flax LayerNorm, ReLU, Dense) adds its transform to every position."""

    def __init__(self, channels, ratio, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        planes = int(channels * ratio)
        self.conv_mask = nn.Conv2d(channels, 1, 1)
        self.channel_add_conv = nn.Sequential(
            nn.Conv2d(channels, planes, 1), nn.LayerNorm([planes, 1, 1]),
            nn.ReLU(inplace=True), nn.Conv2d(planes, channels, 1))

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        n, c, h, w = x.shape
        mask = torch.softmax(conv2d(self.conv_mask, x, dt).reshape(n, h * w),
                             1)
        ctx = torch.einsum('ncp,np->nc', x.reshape(n, c, h * w), mask)
        fc1, ln, _, fc2 = self.channel_add_conv
        y = conv2d(fc1, ctx[:, :, None, None], dt)
        y = F.layer_norm(at_least_f32(y), ln.normalized_shape, ln.weight, ln.bias,
                         ln.eps).to(dt)
        return x + conv2d(fc2, F.relu(y), dt)


class ViPNASBottleneck(nn.Module):
    """ViPNAS_Bottleneck (expansion 1 by default): the searched kernel size
    and groups in conv2, and the optional context block after bn3."""

    def __init__(self, inplanes, out_ch, expansion=1, stride=1,
                 downsample=None, kernel_size=3, groups=1, attention=False,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        mid = out_ch // expansion
        k = kernel_size
        self.conv1 = nn.Conv2d(inplanes, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, k, stride, k // 2, groups=groups,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.attention = (ContextBlock(out_ch, max(1.0 / 16, 16.0 / out_ch),
                                       dtype) if attention else None)
        self.downsample = downsample

    def forward(self, x):
        dt = self.dtype
        y = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        y = norm(self.bn2, conv2d(self.conv2, y, dt), dt, relu=True)
        y = norm(self.bn3, conv2d(self.conv3, y, dt), dt)
        if self.attention is not None:
            y = self.attention(y)
        return F.relu(y + shortcut(self.downsample, x.to(dt), dt))


def ViPNASResNet(wid=(48, 80, 160, 304, 608), expan=(0, 1, 1, 1, 1),
                 dep=(0, 4, 6, 7, 3), ks=(7, 3, 5, 5, 5),
                 group=(0, 16, 16, 16, 16),
                 att=(False, True, False, True, True), strides=(1, 2, 2, 2),
                 dtype='float32', generator=None):
    """ViPNAS_ResNet-50's searched stages (index 0: the stem's width and
    kernel): [N, H, W, 3] -> [N, wid[-1] * expan[-1], H/32, W/32]."""
    layers, cin = [], wid[0]
    for i in range(1, len(wid)):
        out_ch = wid[i] * expan[i]
        blocks = []
        for b in range(dep[i]):
            s = strides[i - 1] if b == 0 else 1
            ds = (make_downsample(cin, out_ch, s, False)
                  if b == 0 and (s != 1 or cin != out_ch) else None)
            blocks.append(ViPNASBottleneck(cin, out_ch, expan[i], s, ds,
                                           ks[i], group[i], att[i], dtype))
            cin = out_ch
        layers.append(blocks)
    return ResNetTrunk(layers, cin, stem_width=wid[0], stem_kernel=ks[0],
                       dtype=dtype, generator=generator)


# --- ViPNAS-MobileNetV3 ------------------------------------------------------

class InvertedResidual(nn.Module):
    """mmpose's InvertedResidual as JAX runs it: a 1x1 `expand_conv` unless
    the expansion is 1, the searched k x k `depthwise_conv` (groups `g`),
    each with BN and the stage's activation; the hsigmoid SE gate (ratio
    4); the 1x1 `linear_conv` + BN; the input added where the shape
    stays."""

    def __init__(self, cin, mid, cout, k, stride, groups, expand, se, act,
                 dtype='float32'):
        super().__init__()
        self.act = act
        self.expand_conv = ConvBN(cin, mid, 1, dtype=dtype) if expand else None
        self.depthwise_conv = ConvBN(mid if expand else cin, mid, k, stride,
                                     groups, dtype)
        self.se = SELayer(mid, 4, 'hsigmoid', dtype) if se else None
        self.linear_conv = ConvBN(mid, cout, 1, dtype=dtype)
        self.residual = stride == 1 and cin == cout

    def forward(self, x):
        y = x
        if self.expand_conv is not None:
            y = _activate(self.expand_conv(y), self.act)
        y = _activate(self.depthwise_conv(y), self.act)
        if self.se is not None:
            y = self.se(y)
        y = self.linear_conv(y)
        return y + x if self.residual else y


class ViPNASMobileNetV3(nn.Module):
    """ViPNAS_MobileNetV3's searched stages (index 0: the stem), blocks
    `layer1`, `layer2`, ... in stage-major order: [N, H, W, 3] -> [N,
    wid[-1], H/32, W/32]."""

    def __init__(self, wid=(16, 16, 24, 40, 80, 112, 160),
                 expan=(0, 1, 5, 4, 5, 5, 6), dep=(0, 1, 4, 4, 4, 4, 4),
                 ks=(3, 3, 7, 7, 5, 7, 5),
                 group=(0, 8, 120, 20, 100, 280, 240),
                 att=(False, True, True, False, True, True, True),
                 stride=(2, 1, 2, 2, 2, 1, 2),
                 act=('hswish', 'relu', 'relu', 'relu', 'hswish', 'hswish',
                      'hswish'), dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.stem_act = act[0]
        self.conv1 = ConvBN(3, wid[0], ks[0], stride[0], dtype=dtype)
        n, cin = 0, wid[0]
        for i in range(1, len(wid)):
            mid, g = wid[i] * expan[i], max(1, group[i])
            if mid % g:
                raise ValueError(f'stage {i}: width {mid} does not split '
                                 f'into {g} groups')
            for j in range(dep[i]):
                n += 1
                self.add_module(f'layer{n}', InvertedResidual(
                    cin, mid, wid[i], ks[i], stride[i] if j == 0 else 1, g,
                    expan[i] != 1, att[i], act[i], dtype))
                cin = wid[i]
        self.num_layers = n
        self.out_channels = cin
        init_cnn(self, generator)

    def forward(self, imgs):
        x = _activate(self.conv1(imgs.permute(0, 3, 1, 2)), self.stem_act)
        for n in range(1, self.num_layers + 1):
            x = getattr(self, f'layer{n}')(x)
        return x


# --- ShuffleNetV1, RegNet, MobileNetV3 (flax names) --------------------------

def _flat_conv_bn(module, prefix, conv, bn, x, dtype, relu=False):
    """`module`'s flax-named conv `{prefix}_{conv}` and BN `{prefix}_{bn}`
    on `x`."""
    return norm(getattr(module, f'{prefix}_{bn}'),
                conv2d(getattr(module, f'{prefix}_{conv}'), x, dtype), dtype,
                relu=relu)


def channel_shuffle(x, groups):
    """[n, c, h, w] with channel i * (c / g) + j moved to j * g + i."""
    n, c, h, w = x.shape
    return x.unflatten(1, (groups, c // groups)).transpose(1, 2).reshape(
        n, c, h, w)


class ShuffleNetV1(nn.Module):
    """The stem (3x3/2 conv 24, BN, ReLU, 3x3/2 max pool), then units of
    grouped 1x1 `g1` (+ BN, ReLU, channel shuffle), 3x3 depthwise `dw`
    (+ BN) and grouped 1x1 `g2` (+ BN) over three stages of 4, 8 and 4
    units; a strided unit concatenates the 3x3/2 average-pooled input
    before the ReLU, the others add it. [N, H, W, 3] -> [N, C, H/32,
    W/32], C = 960 for 3 groups."""
    CHANNELS = {1: (144, 288, 576), 2: (200, 400, 800), 3: (240, 480, 960),
                4: (272, 544, 1088), 8: (384, 768, 1536)}

    def __init__(self, groups=3, dtype='float32', generator=None):
        super().__init__()
        if groups not in self.CHANNELS:
            raise KeyError(f'ShuffleNetV1 groups {groups}: expected one of '
                           f'{sorted(self.CHANNELS)}')
        self.dtype = compute_dtype(dtype)
        self.groups = g = groups
        self.stem = nn.Conv2d(3, 24, 3, 2, 1, bias=False)
        self.stem_bn = nn.BatchNorm2d(24)
        self.units = []
        cin = 24
        for si, (ch, reps) in enumerate(zip(self.CHANNELS[g], (4, 8, 4))):
            for bi in range(reps):
                stride = 2 if bi == 0 else 1
                body = ch - cin if stride == 2 else ch
                first = 1 if si == 0 and bi == 0 else g
                mid = max(body // 4 // g * g, g)
                p = f's{si}b{bi}'
                self.add_module(f'{p}_g1', nn.Conv2d(cin, mid, 1,
                                                     groups=first,
                                                     bias=False))
                self.add_module(f'{p}_bn1', nn.BatchNorm2d(mid))
                self.add_module(f'{p}_dw', nn.Conv2d(mid, mid, 3, stride, 1,
                                                     groups=mid, bias=False))
                self.add_module(f'{p}_bn2', nn.BatchNorm2d(mid))
                self.add_module(f'{p}_g2', nn.Conv2d(mid, body, 1, groups=g,
                                                     bias=False))
                self.add_module(f'{p}_bn3', nn.BatchNorm2d(body))
                self.units.append((p, stride, first == g))
                cin = ch
        self.out_channels = cin
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        x = norm(self.stem_bn, conv2d(self.stem, x, dt), dt, relu=True)
        x = F.max_pool2d(x, 3, 2, 1)
        for p, stride, shuffle in self.units:
            y = _flat_conv_bn(self, p, 'g1', 'bn1', x, dt, relu=True)
            if shuffle:
                y = channel_shuffle(y, self.groups)
            y = _flat_conv_bn(self, p, 'dw', 'bn2', y, dt)
            y = _flat_conv_bn(self, p, 'g2', 'bn3', y, dt)
            if stride == 2:
                x = F.relu(torch.cat([F.avg_pool2d(x, 3, 2, 1), y], 1))
            else:
                x = F.relu(x + y)
        return x


class RegNet(nn.Module):
    """RegNetX-style stages of group-width bottlenecks (the resolved widths
    and depths per stage, as JAX takes them): the stem (3x3/2 conv 32, BN,
    ReLU), then per block `s{i}b{j}_c1` 1x1, `_c2` 3x3 grouped (stride 2 in
    a stage's first block), `_c3` 1x1, each with BN (ReLU after the first
    two), and `_ds`/`_dsbn` where the shape changes. [N, H, W, 3] -> [N,
    stage_widths[-1], H/32, W/32]."""

    def __init__(self, stage_widths=(80, 240, 560, 1360),
                 stage_depths=(2, 6, 15, 2), group_width=40, dtype='float32',
                 generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.stem_bn = nn.BatchNorm2d(32)
        self.blocks = []
        cin = 32
        for si, (wd, dp) in enumerate(zip(stage_widths, stage_depths)):
            groups = max(wd // group_width, 1)
            for bi in range(dp):
                stride = 2 if bi == 0 else 1
                p = f's{si}b{bi}'
                for name, module in (
                        ('c1', nn.Conv2d(cin, wd, 1, bias=False)),
                        ('bn1', nn.BatchNorm2d(wd)),
                        ('c2', nn.Conv2d(wd, wd, 3, stride, 1, groups=groups,
                                         bias=False)),
                        ('bn2', nn.BatchNorm2d(wd)),
                        ('c3', nn.Conv2d(wd, wd, 1, bias=False)),
                        ('bn3', nn.BatchNorm2d(wd))):
                    self.add_module(f'{p}_{name}', module)
                ds = stride != 1 or cin != wd
                if ds:
                    self.add_module(f'{p}_ds', nn.Conv2d(cin, wd, 1, stride,
                                                         bias=False))
                    self.add_module(f'{p}_dsbn', nn.BatchNorm2d(wd))
                self.blocks.append((p, ds))
                cin = wd
        self.out_channels = cin
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        x = norm(self.stem_bn, conv2d(self.stem, x, dt), dt, relu=True)
        for p, ds in self.blocks:
            y = _flat_conv_bn(self, p, 'c1', 'bn1', x, dt, relu=True)
            y = _flat_conv_bn(self, p, 'c2', 'bn2', y, dt, relu=True)
            y = _flat_conv_bn(self, p, 'c3', 'bn3', y, dt)
            identity = (_flat_conv_bn(self, p, 'ds', 'dsbn', x, dt) if ds
                        else x)
            x = F.relu(y + identity)
        return x


class DenseSELayer(nn.Module):
    """The SE gate with flax's Dense layers as nn.Linear `fc1` and `fc2`
    (ratio 4, sigmoid), for MobileNetV3's flax names."""

    def __init__(self, channels, ratio=4, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        squeeze = max(int(channels / ratio), 1)
        self.fc1 = nn.Linear(channels, squeeze)
        self.fc2 = nn.Linear(squeeze, channels)

    def forward(self, x):
        return squeeze_excite(x, self.fc1, self.fc2, 'sigmoid', self.dtype)


class MobileNetV3(nn.Module):
    """MobileNetV3-small-style inverted residuals with SE and h-swish (JAX's
    fixed ARCH), the 1x1 `head` to 576 channels: [N, H, W, 3] -> [N, 576,
    H/32, W/32]."""
    # (kernel, expand, out, use_se, use_hs, stride)
    ARCH = ((3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
            (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
            (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
            (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
            (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
            (5, 576, 96, True, True, 1))

    def __init__(self, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.stem = nn.Conv2d(3, 16, 3, 2, 1, bias=False)
        self.stem_bn = nn.BatchNorm2d(16)
        cin = 16
        for i, (k, e, o, se, _, s) in enumerate(self.ARCH):
            self.add_module(f'b{i}_exp', nn.Conv2d(cin, e, 1, bias=False))
            self.add_module(f'b{i}_exp_bn', nn.BatchNorm2d(e))
            self.add_module(f'b{i}_dw', nn.Conv2d(e, e, k, s, (k - 1) // 2,
                                                  groups=e, bias=False))
            self.add_module(f'b{i}_dw_bn', nn.BatchNorm2d(e))
            if se:
                self.add_module(f'b{i}_se', DenseSELayer(e, 4, dtype))
            self.add_module(f'b{i}_proj', nn.Conv2d(e, o, 1, bias=False))
            self.add_module(f'b{i}_proj_bn', nn.BatchNorm2d(o))
            cin = o
        self.head = nn.Conv2d(cin, 576, 1, bias=False)
        self.head_bn = nn.BatchNorm2d(576)
        self.out_channels = 576
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        x = _hswish(norm(self.stem_bn, conv2d(self.stem, x, dt), dt))
        cin = 16
        for i, (_, _, o, se, hs, s) in enumerate(self.ARCH):
            act = 'hswish' if hs else 'relu'
            p = f'b{i}'
            y = _activate(_flat_conv_bn(self, p, 'exp', 'exp_bn', x, dt), act)
            y = _activate(_flat_conv_bn(self, p, 'dw', 'dw_bn', y, dt), act)
            if se:
                y = getattr(self, f'{p}_se')(y)
            y = _flat_conv_bn(self, p, 'proj', 'proj_bn', y, dt)
            x = y + x if s == 1 and cin == o else y
            cin = o
        return _hswish(norm(self.head_bn, conv2d(self.head, x, dt), dt))

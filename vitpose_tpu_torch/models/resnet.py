"""ResNet and ResNetV1d backbones in PyTorch, with mmpose's parameter names.

Counterpart of vitpose_tpu/models/resnet.py: `RESNET_SPECS`, `BasicBlock`,
`Bottleneck`, `ResNet` (the 7x7 stem or the deep stem, the 3x3/2 max pool,
four stages) and `ResNetV1d` (deep stem and `avg_down`: a 2x2 ceil-mode
average pool that leaves the pad out of its count, before a stride-1 1x1
shortcut conv). The modules take mmpose's names (`conv1`, `bn1`,
`layer{i}.{j}.conv{k}`, `downsample.{0,1}` or, after an average pool,
`downsample.{1,2}`, `stem.{i}.conv`/`.bn`), so a reference .pth loads with
load_state_dict(strict=True).

The crops come in NHWC, as the JAX package takes them; the backbone reads
them as NCHW through a permuted view, which is channels_last in memory, and
PyTorch keeps that layout through every conv. Convs cast their input and
their f32 weights to the compute dtype, as flax's Conv(dtype=...) does;
BatchNorm computes in f32 and casts its output (`heads.batch_norm`: flax's
statistics in training); residual sums run in the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .heads import batch_norm
from .vit import at_least_f32, compute_dtype, normal_

RESNET_SPECS = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
    # ResNeSt-only depths (reference resnest.py:217 arch_settings)
    200: ('bottleneck', (3, 24, 36, 3)),
    269: ('bottleneck', (3, 30, 48, 3)),
}


def conv2d(layer: nn.Conv2d, x, dtype):
    """`layer` on `x`, both cast to `dtype` (flax Conv(dtype=dtype))."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride,
                    layer.padding, layer.dilation, layer.groups)


def norm(bn: nn.BatchNorm2d, x, dtype, relu=False):
    """`bn` in f32 (f64 in a float64 model) with flax's semantics, the
    result cast to `dtype`, with an optional ReLU after it."""
    y = batch_norm(bn, at_least_f32(x))
    if relu:
        y = F.relu(y)
    return y.to(dtype)


def init_cnn(module: nn.Module, generator=None):
    """Seeded init of every conv and linear layer below `module` (normal,
    std fan_in ** -0.5, cut at two deviations; zero biases), BN (scale 1,
    bias 0, running mean 0 and variance 1) and LayerNorm (scale 1, bias
    0)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            normal_(m.weight, fan_in ** -0.5, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()


class ConvModule(nn.Module):
    """mmcv's ConvModule: `conv` (no bias), `bn`, ReLU."""

    def __init__(self, cin, cout, kernel, stride=1, padding=0,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x):
        return norm(self.bn, conv2d(self.conv, x, self.dtype), self.dtype,
                    relu=True)


class BiasConv(nn.Module):
    """mmcv's ConvModule without a norm or an activation: `conv`, with a
    bias (padding k // 2)."""

    def __init__(self, cin, cout, k=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)


def make_downsample(cin, cout, stride, avg_down):
    """The shortcut of a block whose shape changes: Sequential(conv, bn),
    or with `avg_down` and stride > 1 Sequential(AvgPool2d, stride-1 conv,
    bn) (reference resnet.py:355-371)."""
    if avg_down and stride != 1:
        return nn.Sequential(
            nn.AvgPool2d(stride, stride, ceil_mode=True,
                         count_include_pad=False),
            nn.Conv2d(cin, cout, 1, bias=False), nn.BatchNorm2d(cout))
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


def shortcut(downsample, x, dtype):
    """The block's identity branch: `x`, or `x` through its downsample."""
    if downsample is None:
        return x
    for layer in downsample:
        if isinstance(layer, nn.AvgPool2d):
            # JAX pads right and bottom and leaves the pad out of the mean
            x = F.avg_pool2d(x, layer.kernel_size, layer.stride,
                             ceil_mode=True, count_include_pad=False)
        elif isinstance(layer, nn.Conv2d):
            x = conv2d(layer, x, dtype)
        else:
            x = norm(layer, x, dtype)
    return x


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        dt = self.dtype
        y = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        y = norm(self.bn2, conv2d(self.conv2, y, dt), dt)
        return F.relu(y + shortcut(self.downsample, x.to(dt), dt))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = downsample

    def forward(self, x):
        dt = self.dtype
        y = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        y = norm(self.bn2, conv2d(self.conv2, y, dt), dt, relu=True)
        y = norm(self.bn3, conv2d(self.conv3, y, dt), dt)
        return F.relu(y + shortcut(self.downsample, x.to(dt), dt))


class ResNet(nn.Module):
    """[N, H, W, 3] crops -> [N, C, H/32, W/32] features (C = 512 for
    depths 18 and 34, 2048 above) in the compute dtype.

    `deep_stem` replaces the 7x7 stem conv by three 3x3 ConvModules
    (32-32-64, `stem.{i}`); `avg_down` pools before the strided shortcuts'
    stride-1 1x1 convs (mmpose resnet.py:447-449, 573-607).
    """

    def __init__(self, depth=50, deep_stem=False, avg_down=False,
                 dtype='float32', generator=None):
        super().__init__()
        if depth not in RESNET_SPECS:
            raise KeyError(f'ResNet depth {depth}: expected one of '
                           f'{sorted(RESNET_SPECS)}')
        self.dtype = compute_dtype(dtype)
        self.deep_stem = deep_stem
        kind, stage_blocks = RESNET_SPECS[depth]
        block = BasicBlock if kind == 'basic' else Bottleneck
        if deep_stem:
            self.stem = nn.Sequential(
                ConvModule(3, 32, 3, 2, 1, dtype), ConvModule(32, 32, 3, 1, 1,
                                                              dtype),
                ConvModule(32, 64, 3, 1, 1, dtype))
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.bn1 = nn.BatchNorm2d(64)
        inplanes, planes = 64, 64
        for si, n in enumerate(stage_blocks):
            stride = 1 if si == 0 else 2
            blocks = []
            for bi in range(n):
                s = stride if bi == 0 else 1
                ds = None
                if bi == 0 and (s != 1 or inplanes != planes * block.expansion):
                    ds = make_downsample(inplanes, planes * block.expansion,
                                         s, avg_down)
                blocks.append(block(inplanes, planes, s, ds, dtype))
                inplanes = planes * block.expansion
            self.add_module(f'layer{si + 1}', nn.Sequential(*blocks))
            planes *= 2
        self.out_channels = inplanes
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f'layer{i}')(x)
        return x


def ResNetV1d(depth=50, dtype='float32', generator=None):
    """Bag-of-tricks ResNetV1d (reference resnet.py:698-710): ResNet with
    the deep stem and avg_down."""
    return ResNet(depth, deep_stem=True, avg_down=True, dtype=dtype,
                  generator=generator)


def bottleneck_layers(make_block, depth):
    """The blocks of a bottleneck ResNet's four stages with `depth`'s stage
    counts (JAX reads RESNET_SPECS[depth]'s counts whatever its block kind,
    so depths 18 and 34 give bottlenecks too): `make_block(inplanes,
    planes, stride, downsample)` for planes 64, 128, 256, 512, expansion 4,
    the stride in each stage's first block. Returns (layers, out
    channels)."""
    if depth not in RESNET_SPECS:
        raise KeyError(f'depth {depth}: expected one of '
                       f'{sorted(RESNET_SPECS)}')
    layers, inplanes, planes = [], 64, 64
    for si, n in enumerate(RESNET_SPECS[depth][1]):
        blocks = []
        for bi in range(n):
            s = 2 if si and not bi else 1
            ds = None
            if bi == 0 and (s != 1 or inplanes != planes * 4):
                ds = make_downsample(inplanes, planes * 4, s, False)
            blocks.append(make_block(inplanes, planes, s, ds))
            inplanes = planes * 4
        layers.append(blocks)
        planes *= 2
    return layers, inplanes


class ResNetTrunk(nn.Module):
    """The ResNet layout that SE-ResNet, ResNeXt, SCNet, ResNeSt and
    ViPNAS-ResNet share: `conv1` (k x k, stride 2, no bias), `bn1`, ReLU and
    the 3x3/2 max pool, then the stages `layer1`, `layer2`, ... (Sequentials
    of `layers`' blocks). [N, H, W, 3] crops -> [N, out_channels, h, w] in
    the compute dtype. Weights are drawn from `generator` (`init_cnn`)."""

    def __init__(self, layers, out_channels, stem_width=64, stem_kernel=7,
                 dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv2d(3, stem_width, stem_kernel, 2,
                               stem_kernel // 2, bias=False)
        self.bn1 = nn.BatchNorm2d(stem_width)
        self.stages = len(layers)
        for i, blocks in enumerate(layers):
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
        self.out_channels = out_channels
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        x = imgs.permute(0, 3, 1, 2)
        x = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, self.stages + 1):
            x = getattr(self, f'layer{i}')(x)
        return x

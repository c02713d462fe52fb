"""ResNeXt and SE-ResNeXt backbones in PyTorch, with mmpose's parameter
names.

Counterpart of vitpose_tpu/models/resnext.py: `ResNeXtBottleneck` (the
bottleneck of width ``planes * groups * width_per_group // 64`` with a
grouped 3x3 conv2 and, for SE-ResNeXt, the SE gate after bn3, before the
residual add), `ResNeXt` (the ResNet layout, 32x4d by default) and
`SEResNeXt` (se_ratio 16). Names: `layer{i}.{j}.conv{k}`, `bn{k}`,
`downsample.{0,1}`, `se_layer.conv{1,2}.conv`, as the JAX package's
`convert_resnext` reads them.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .classic_cnns import SELayer
from .resnet import ResNetTrunk, bottleneck_layers, conv2d, norm, shortcut
from .vit import compute_dtype


class ResNeXtBottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=32,
                 width_per_group=4, se_ratio=0, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        mid = planes * groups * width_per_group // 64
        self.conv1 = nn.Conv2d(inplanes, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, groups=groups,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.se_layer = (SELayer(planes * 4, se_ratio, dtype=dtype)
                         if se_ratio else None)
        self.downsample = downsample

    def forward(self, x):
        dt = self.dtype
        y = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        y = norm(self.bn2, conv2d(self.conv2, y, dt), dt, relu=True)
        y = norm(self.bn3, conv2d(self.conv3, y, dt), dt)
        if self.se_layer is not None:
            y = self.se_layer(y)
        return F.relu(y + shortcut(self.downsample, x.to(dt), dt))


def ResNeXt(depth=50, groups=32, width_per_group=4, se_ratio=0,
            dtype='float32', generator=None):
    """[N, H, W, 3] -> [N, 2048, H/32, W/32]."""
    layers, out = bottleneck_layers(
        lambda cin, planes, s, ds: ResNeXtBottleneck(
            cin, planes, s, ds, groups, width_per_group, se_ratio, dtype),
        depth)
    return ResNetTrunk(layers, out, dtype=dtype, generator=generator)


def SEResNeXt(depth=50, groups=32, width_per_group=4, se_ratio=16,
              dtype='float32', generator=None):
    """SE-ResNeXt (reference seresnext.py): ResNeXt with the SE gate."""
    return ResNeXt(depth, groups, width_per_group, se_ratio, dtype,
                   generator)

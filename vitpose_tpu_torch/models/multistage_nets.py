"""The multi-stage pose backbones MSPN, RSN and Lite-HRNet in PyTorch, with
mmpose's parameter names.

Counterpart of vitpose_tpu/models/multistage_nets.py: `_conv_bn` (:28, here
`more_cnns.ConvBN`), `resize_bilinear_ac` (:56), `RSB` (:68),
`_DownsampleModule` (:117), `_UpsampleUnit` (:158), `_SingleStage`
(:189), `MSPN` (:225) and `RSN` (:256), `_channel_shuffle` (:269, here `more_cnns.channel_shuffle`:
JAX's NHWC order, channel i * (c / g) + j to j * g + i, is the same on the
NCHW axis), `_adaptive_avg_pool` (:277), `SpatialWeighting`,
`CrossResolutionWeighting`, `ConditionalChannelWeighting`, `LiteHRNetStem`,
`LiteFuse` (here `LiteHRModule`'s fusion) and `LiteHRNet` (:286-528).

Names. The modules take mmpose's (`top.top.0`, `multi_stage_mspn.{s}` or
`multi_stage_rsn.{s}` with `downsample.layer{u}.{b}` and
`upsample.up{u}.{in_skip,up_conv,out_skip1,out_skip2,cross_conv}`;
`stem.{conv1,branch1.{0,1},expand_conv,depthwise_conv,linear_conv}`,
`transition{s}.{b}`, `stage{s}.{m}.layers.{k}` and
`stage{s}.{m}.fuse_layers.{i}.{j}`), which the JAX package's
`convert_mspn` and `convert_litehrnet` read, so a reference .pth loads with
strict=True.

MSPN and RSN return a list over stages of the per-unit NCHW features,
lowest resolution first; Lite-HRNet its high-resolution branch. The
backbones take NHWC crops through a permuted view (channels_last); convs run
in the compute dtype, BN in f32 (`resnet.norm`, flax's statistics in
training), as flax does. Every `jax.image.resize(..., 'nearest')` is torch's
'nearest-exact'.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .classic_cnns import squeeze_excite
from .more_cnns import ConvBN, channel_shuffle
from .resnet import BiasConv, conv2d, init_cnn, norm
from .vit import at_least_f32, compute_dtype

def resize_bilinear_ac(x, size_hw):
    """NCHW align-corners bilinear resize, in f32 (f64 in a float64 model):
    JAX computes it as two matmuls at Precision.HIGHEST, which promote a
    bf16 input to f32."""
    return F.interpolate(at_least_f32(x), size=tuple(size_hw),
                         mode='bilinear', align_corners=True)


def adaptive_avg_pool(x, out_hw):
    """Adaptive average pool for integer-ratio downsizes only (JAX asserts
    the ratio)."""
    h, w = x.shape[2:]
    th, tw = out_hw
    if h % th or w % tw:
        raise ValueError(f'adaptive_avg_pool: {h}x{w} to {th}x{tw} is not an '
                         'integer ratio')
    return F.avg_pool2d(x, (h // th, w // tw))


def resize_nearest(x, size_hw):
    """jax.image.resize(..., 'nearest'): torch's 'nearest-exact'."""
    return F.interpolate(x, size=tuple(size_hw), mode='nearest-exact')


# --- MSPN and RSN ------------------------------------------------------------

class MSPNBottleneck(nn.Module):
    """The ResNet bottleneck (expansion 4, the stride in conv2) with
    mmpose's ConvModule shortcut `downsample.conv`/`.bn`."""

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (ConvBN(inplanes, planes * 4, 1, stride, dtype=dtype)
                           if downsample else None)

    def forward(self, x):
        dt = self.dtype
        x = x.to(dt)
        y = norm(self.bn1, conv2d(self.conv1, x, dt), dt, relu=True)
        y = norm(self.bn2, conv2d(self.conv2, y, dt), dt, relu=True)
        y = norm(self.bn3, conv2d(self.conv3, y, dt), dt)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class RSB(nn.Module):
    """Residual Steps Block: a strided 1x1 to num_steps branches of `branch`
    channels; branch i runs i + 1 3x3 ConvModules, step j of it also taking
    branch i - 1's step-j output; their last outputs concatenated into a
    1x1 (no ReLU), plus the identity or `downsample`, then ReLU."""

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 num_steps=4, expand_times=26, res_top_channels=64,
                 dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.num_steps = num_steps
        branch = inplanes * expand_times // res_top_channels
        self.conv_bn_relu1 = ConvBN(inplanes, num_steps * branch, 1,
                                      stride, dtype=dtype, act='relu')
        for i in range(num_steps):
            for j in range(i + 1):
                self.add_module(f'conv_bn_relu2_{i + 1}_{j + 1}',
                                ConvBN(branch, branch, 3, dtype=dtype,
                                       act='relu'))
        self.conv_bn3 = ConvBN(num_steps * branch, planes, 1, dtype=dtype)
        self.downsample = (ConvBN(inplanes, planes, 1, stride, dtype=dtype)
                           if downsample else None)

    def forward(self, x):
        x = x.to(self.dtype)
        spx = self.conv_bn_relu1(x).chunk(self.num_steps, 1)
        outputs = []
        for i in range(self.num_steps):
            outputs.append([])
            for j in range(i + 1):
                inp = spx[i] if j == 0 else outputs[i][j - 1]
                if i > j:
                    inp = inp + outputs[i - 1][j]
                outputs[i].append(
                    getattr(self, f'conv_bn_relu2_{i + 1}_{j + 1}')(inp))
        y = self.conv_bn3(torch.cat([o[-1] for o in outputs], 1))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class DownsampleModule(nn.Module):
    """The trunk of one stage: `layer{u}` (Sequentials of bottlenecks or
    RSBs, planes 64 * 2 ** (u - 1), the stride in a layer's first block but
    the first layer's), each output plus the previous stage's two skips
    when `has_skip`. Returns the outputs lowest resolution first."""

    def __init__(self, num_blocks=(2, 2, 2, 2), has_skip=False,
                 use_rsb=False, num_steps=4, expand_times=26, in_channels=64,
                 dtype='float32'):
        super().__init__()
        self.has_skip = has_skip
        self.num_units = len(num_blocks)
        in_ch = in_channels
        for i, nb in enumerate(num_blocks):
            planes = in_channels * 2 ** i
            blocks = []
            for b in range(nb):
                s = (1 if i == 0 else 2) if b == 0 else 1
                if use_rsb:
                    blocks.append(RSB(in_ch, planes, s,
                                      b == 0 and (s != 1 or in_ch != planes),
                                      num_steps, expand_times, in_channels,
                                      dtype))
                    in_ch = planes
                else:
                    blocks.append(MSPNBottleneck(
                        in_ch, planes, s,
                        b == 0 and (s != 1 or in_ch != planes * 4), dtype))
                    in_ch = planes * 4
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
        self.channels = [in_channels * 2 ** i * (1 if use_rsb else 4)
                         for i in range(self.num_units)]

    def forward(self, x, skip1, skip2):
        outs = []
        for i in range(self.num_units):
            x = getattr(self, f'layer{i + 1}')(x)
            if self.has_skip:
                x = x + skip1[i] + skip2[i]
            outs.append(x)
        return outs[::-1]


class UpsampleUnit(nn.Module):
    """One unit of a stage's upsampling path: `in_skip` (1x1, no ReLU) of
    the trunk's output plus, above the lowest unit, `up_conv` (1x1, no
    ReLU) of the unit below resized with align corners, then ReLU; the
    skips `out_skip1` (of the trunk's output) and `out_skip2` (of the
    unit's) to the next stage, and on the last unit `cross_conv` to its
    input."""

    def __init__(self, ind, num_units, in_channels, unit_channels=256,
                 gen_skip=False, gen_cross_conv=False, out_channels=64,
                 dtype='float32'):
        super().__init__()
        self.ind = ind
        self.in_skip = ConvBN(in_channels, unit_channels, 1, dtype=dtype)
        if ind > 0:
            self.up_conv = ConvBN(unit_channels, unit_channels, 1,
                                    dtype=dtype)
        self.gen_skip = gen_skip
        if gen_skip:
            self.out_skip1 = ConvBN(in_channels, in_channels, 1,
                                      dtype=dtype, act='relu')
            self.out_skip2 = ConvBN(unit_channels, in_channels, 1,
                                      dtype=dtype, act='relu')
        self.gen_cross = ind == num_units - 1 and gen_cross_conv
        if self.gen_cross:
            self.cross_conv = ConvBN(unit_channels, out_channels, 1,
                                       dtype=dtype, act='relu')

    def forward(self, x, up_x):
        out = self.in_skip(x)
        if self.ind > 0:
            out = out + self.up_conv(resize_bilinear_ac(up_x, x.shape[2:]))
        out = F.relu(out)
        skip1 = skip2 = cross = None
        if self.gen_skip:
            skip1, skip2 = self.out_skip1(x), self.out_skip2(out)
        if self.gen_cross:
            cross = self.cross_conv(out)
        return out, skip1, skip2, cross


class Upsample(nn.Module):
    """The units `up{u}`, lowest resolution first (`channels`: the trunk's
    outputs' widths in that order)."""

    def __init__(self, channels, unit_channels, gen_skip, gen_cross_conv,
                 out_channels, dtype):
        super().__init__()
        n = len(channels)
        for i in range(n):
            self.add_module(f'up{i + 1}', UpsampleUnit(
                i, n, channels[i], unit_channels, gen_skip,
                gen_cross_conv, out_channels, dtype))
        self.num_units = n

    def forward(self, mid):
        outs, s1, s2, cross = [], [], [], None
        for i in range(self.num_units):
            out, a, b, c = getattr(self, f'up{i + 1}')(
                mid[i], outs[i - 1] if i else None)
            outs.append(out)
            s1.append(a)
            s2.append(b)
            cross = c if c is not None else cross
        return outs, s1[::-1], s2[::-1], cross


class SingleStage(nn.Module):
    """One MSPN/RSN stage: `downsample` (the trunk) and `upsample`."""

    def __init__(self, has_skip, gen_skip, gen_cross_conv, unit_channels,
                 num_blocks, use_rsb, num_steps, expand_times, in_channels,
                 dtype):
        super().__init__()
        self.downsample = DownsampleModule(num_blocks, has_skip, use_rsb,
                                           num_steps, expand_times,
                                           in_channels, dtype)
        self.upsample = Upsample(self.downsample.channels[::-1],
                                 unit_channels, gen_skip, gen_cross_conv,
                                 in_channels, dtype)

    def forward(self, x, skip1, skip2):
        return self.upsample(self.downsample(x, skip1, skip2))


class ResNetTop(nn.Module):
    """`top.0`: the 7x7/2 ConvModule; then the 3x3/2 max pool."""

    def __init__(self, channels=64, dtype='float32'):
        super().__init__()
        self.top = nn.Sequential(ConvBN(3, channels, 7, 2, dtype=dtype,
                                        act='relu'))

    def forward(self, x):
        return F.max_pool2d(self.top(x), 3, 2, 1)


class MSPN(nn.Module):
    """Multi-Stage Pose Network: [N, H, W, 3] -> a list over stages of the
    `num_units` NCHW unit features (unit_channels wide), lowest resolution
    first. `use_rsb` makes it RSN (the stages `multi_stage_rsn`)."""

    def __init__(self, num_stages=2, num_units=4, num_blocks=(2, 2, 2, 2),
                 unit_channels=256, res_top_channels=64, use_rsb=False,
                 num_steps=4, expand_times=26, dtype='float32',
                 generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.top = ResNetTop(res_top_channels, dtype)
        stages = nn.ModuleList(
            SingleStage(st > 0, st < num_stages - 1, st < num_stages - 1,
                        unit_channels, tuple(num_blocks[:num_units]),
                        use_rsb, num_steps, expand_times, res_top_channels,
                        dtype)
            for st in range(num_stages))
        self.stage_key = 'multi_stage_rsn' if use_rsb else 'multi_stage_mspn'
        self.add_module(self.stage_key, stages)
        self.out_channels = unit_channels
        init_cnn(self, generator)

    def forward(self, imgs):
        x = self.top(imgs.permute(0, 3, 1, 2))
        feats, skip1, skip2 = [], None, None
        for stage in getattr(self, self.stage_key):
            outs, skip1, skip2, cross = stage(x, skip1, skip2)
            feats.append(outs)
            x = cross
        return feats


def RSN(num_stages=2, unit_channels=256, num_units=4,
        num_blocks=(2, 2, 2, 2), num_steps=4, expand_times=26,
        dtype='float32', generator=None):
    """RSN: MSPN's topology with Residual Steps Blocks."""
    return MSPN(num_stages, num_units, num_blocks, unit_channels,
                use_rsb=True, num_steps=num_steps, expand_times=expand_times,
                dtype=dtype, generator=generator)


# --- Lite-HRNet --------------------------------------------------------------

class SpatialWeighting(nn.Module):
    """SE-style gate: the spatial mean through `conv1` (1x1, ReLU) and
    `conv2` (1x1, sigmoid), mmpose's 1x1 convs for JAX's Dense layers."""

    def __init__(self, channels, ratio=4, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.conv1 = BiasConv(channels, int(channels / ratio))
        self.conv2 = BiasConv(int(channels / ratio), channels)

    def forward(self, x):
        return squeeze_excite(x, self.conv1.conv, self.conv2.conv, 'sigmoid',
                              self.dtype)


class CrossResolutionWeighting(nn.Module):
    """Every branch average-pooled to the smallest's size, concatenated,
    `conv1` (1x1 + BN + ReLU) and `conv2` (1x1 + BN + sigmoid); the gates
    split per branch, resized back (nearest) and multiplied in."""

    def __init__(self, channels, ratio=8, dtype='float32'):
        super().__init__()
        self.channels = list(channels)
        total = sum(channels)
        self.conv1 = ConvBN(total, int(total / ratio), 1, dtype=dtype,
                            act='relu')
        self.conv2 = ConvBN(int(total / ratio), total, 1, dtype=dtype)

    def forward(self, xs):
        mini = xs[-1].shape[2:]
        out = torch.cat([adaptive_avg_pool(s, mini) for s in xs[:-1]]
                        + [xs[-1]], 1)
        out = torch.sigmoid(self.conv2(self.conv1(out)))
        return [s * resize_nearest(a, s.shape[2:])
                for s, a in zip(xs, out.split(self.channels, 1))]


class ConditionalChannelWeighting(nn.Module):
    """Each branch split in halves; the second halves through
    `cross_resolution_weighting`, then per branch `depthwise_convs.{b}`
    (3x3 depthwise + BN) and `spatial_weighting.{b}`; each branch's halves
    concatenated and channel-shuffled in 2 groups."""

    def __init__(self, in_channels, reduce_ratio=8, dtype='float32'):
        super().__init__()
        halves = [c // 2 for c in in_channels]
        self.halves = halves
        self.cross_resolution_weighting = CrossResolutionWeighting(
            halves, reduce_ratio, dtype)
        self.depthwise_convs = nn.ModuleList(
            ConvBN(h, h, 3, groups=h, dtype=dtype)
            for h in halves)
        self.spatial_weighting = nn.ModuleList(
            SpatialWeighting(h, 4, dtype) for h in halves)

    def forward(self, xs):
        x1 = [s[:, :h] for s, h in zip(xs, self.halves)]
        x2 = self.cross_resolution_weighting(
            [s[:, h:] for s, h in zip(xs, self.halves)])
        x2 = [sw(dw(s)) for s, dw, sw in zip(x2, self.depthwise_convs,
                                             self.spatial_weighting)]
        return [channel_shuffle(torch.cat([a, b], 1), 2)
                for a, b in zip(x1, x2)]


class LiteHRNetStem(nn.Module):
    """`conv1` (3x3/2 + BN + ReLU), then a ShuffleNetV2-style strided unit:
    the first half through `branch1` (3x3/2 depthwise + BN, 1x1 + BN +
    ReLU), the second through `expand_conv`, `depthwise_conv` (3x3/2, no
    ReLU) and `linear_conv`; concatenated and shuffled."""

    def __init__(self, stem_channels=32, out_channels=32, expand_ratio=1,
                 dtype='float32'):
        super().__init__()
        self.half = half = stem_channels // 2
        mid = int(round(stem_channels * expand_ratio))
        same = stem_channels == out_channels
        inc = out_channels - half if same else out_channels - stem_channels
        lin_out = half if same else stem_channels
        self.conv1 = ConvBN(3, stem_channels, 3, 2, dtype=dtype, act='relu')
        self.branch1 = nn.Sequential(
            ConvBN(half, half, 3, 2, groups=half, dtype=dtype),
            ConvBN(half, inc, 1, dtype=dtype, act='relu'))
        self.expand_conv = ConvBN(stem_channels - half, mid, 1,
                                    dtype=dtype, act='relu')
        self.depthwise_conv = ConvBN(mid, mid, 3, 2, groups=mid, dtype=dtype)
        self.linear_conv = ConvBN(mid, lin_out, 1, dtype=dtype, act='relu')

    def forward(self, x):
        x = self.conv1(x)
        b1 = self.branch1(x[:, :self.half])
        y = self.linear_conv(self.depthwise_conv(
            self.expand_conv(x[:, self.half:])))
        return channel_shuffle(torch.cat([b1, y], 1), 2)


def _dw_pw(cin, cout, stride, relu, dtype):
    """mmpose's Sequential of a 3x3 depthwise conv, BN, a 1x1 conv, BN (and
    ReLU): `.0` to `.3`."""
    layers = [nn.Conv2d(cin, cin, 3, stride, 1, groups=cin, bias=False),
              nn.BatchNorm2d(cin), nn.Conv2d(cin, cout, 1, bias=False),
              nn.BatchNorm2d(cout)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


def _run_dw_pw(seq, x, dtype):
    x = norm(seq[1], conv2d(seq[0], x, dtype), dtype)
    return norm(seq[3], conv2d(seq[2], x, dtype), dtype, relu=len(seq) > 4)


class LiteHRModule(nn.Module):
    """`layers.{k}`: the module's ConditionalChannelWeighting blocks;
    `fuse_layers.{i}.{j}`: j > i a 1x1 conv + BN (`.0`, `.1`) resized up
    (nearest), j < i a chain of i - j depthwise-separable strided
    Sequentials (`.{d}.0` to `.3`, ReLU but on the last).

    The fusion copies the reference's two quirks: branch 0's contribution
    counts twice in every sum (it seeds the sum and is added again), and
    branch 0's fused sum, before its ReLU, replaces branch 0's features for
    the later outputs (reference litehrnet.py:720-729 mutates out[0] in
    place)."""

    def __init__(self, channels, num_blocks, reduce_ratio, dtype):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.layers = nn.ModuleList(
            ConditionalChannelWeighting(channels, reduce_ratio, dtype)
            for _ in range(num_blocks))
        n = len(channels)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        nn.BatchNorm2d(channels[i])))
                elif j < i:
                    row.append(nn.Sequential(*(
                        _dw_pw(channels[j], channels[i] if k == i - j - 1
                               else channels[j], 2, k < i - j - 1, dtype)
                        for k in range(i - j))))
                else:
                    row.append(None)
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        dt = self.dtype
        for block in self.layers:
            xs = block(xs)
        xs = list(xs)
        fused = []
        for i, row in enumerate(self.fuse_layers):
            contribs = []
            for j, layer in enumerate(row):
                y = xs[j]
                if j > i:
                    y = resize_nearest(norm(layer[1], conv2d(layer[0], y, dt),
                                            dt), xs[i].shape[2:])
                elif j < i:
                    for seq in layer:
                        y = _run_dw_pw(seq, y, dt)
                contribs.append(y)
            acc = contribs[0] + sum(contribs[1:], contribs[0])
            if i == 0:
                xs[0] = acc
            fused.append(F.relu(acc))
        return fused


class LiteHRNet(nn.Module):
    """Lite-HRNet: the shuffle stem, then per stage `transition{s}` (a
    depthwise-separable remap where a branch's width changes, None where it
    does not, and strided chains to each new branch) and `stage{s}`, the
    stage's LiteHRModules. [N, H, W, 3] -> [N, stage_channels[-1][0], H/4,
    W/4], the high-resolution branch."""

    def __init__(self, stem_channels=32, stem_out_channels=32,
                 expand_ratio=1, num_modules=(2, 4, 2), num_blocks=(2, 2, 2),
                 reduce_ratios=(8, 8, 8),
                 stage_channels: Sequence[Sequence[int]] = (
                     (40, 80), (40, 80, 160), (40, 80, 160, 320)),
                 dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.stem = LiteHRNetStem(stem_channels, stem_out_channels,
                                  expand_ratio, dtype)
        prev = [stem_out_channels]
        self.num_stages = len(num_modules)
        for si in range(self.num_stages):
            cur = list(stage_channels[si])
            trans = []
            for b, c in enumerate(cur):
                if b < len(prev):
                    trans.append(_dw_pw(prev[b], c, 1, True, dtype)
                                 if c != prev[b] else None)
                else:
                    n = b + 1 - len(prev)
                    trans.append(nn.Sequential(*(
                        _dw_pw(prev[-1], c if k == n - 1 else prev[-1], 2,
                               True, dtype) for k in range(n))))
            self.add_module(f'transition{si}', nn.ModuleList(trans))
            self.add_module(f'stage{si}', nn.ModuleList(
                LiteHRModule(cur, num_blocks[si], reduce_ratios[si], dtype)
                for _ in range(num_modules[si])))
            prev = cur
        self.out_channels = prev[0]
        init_cnn(self, generator)

    def forward(self, imgs):
        dt = self.dtype
        ys = [self.stem(imgs.permute(0, 3, 1, 2))]
        for si in range(self.num_stages):
            xs = []
            for b, layer in enumerate(getattr(self, f'transition{si}')):
                if b < len(ys):
                    xs.append(ys[b] if layer is None
                              else _run_dw_pw(layer, ys[b], dt))
                else:
                    y = ys[-1]
                    for seq in layer:
                        y = _run_dw_pw(seq, y, dt)
                    xs.append(y)
            for module in getattr(self, f'stage{si}'):
                xs = module(xs)
            ys = xs
        return ys[0]

"""The bottom-up associative-embedding heads, in PyTorch with mmpose's names.

Counterpart of the AE heads of vitpose_tpu/models/heads_extra.py:

  * `AEHead` (JAX :46, mmpose's `AESimpleHead`): the classic deconv head
    (`HeatmapHead`: `deconv_layers.{3i}` ConvTranspose2d, `.{3i+1}` BN,
    `final_layer`) with K heatmap channels and K (or 1) tag channels;
  * `AEHigherResolutionHead` (JAX :281, mmpose's ae_higher_resolution_head
    .py:13): `final_layers.{i}` convs with a bias, one per output, and per
    deconv stage `deconv_layers.{d}.0.0` ConvTranspose2d, `.0.1` BN (ReLU
    after it) and `.{b+1}.0` BasicBlocks; a stage may take the previous
    prediction concatenated after its input features.

Both take NCHW features and return a list of NCHW maps in the compute
dtype, one per output, at increasing resolution.

The top-down `ViPNASHead` (JAX :191, mmpose's ViPNASHeatmapSimpleHead) is
the classic head with grouped 4x4/2 deconvs (`deconv_layers.{3i}` one
ConvTranspose2d of g groups, where JAX keeps g flax ConvTransposes
`deconv_{i}_{gi}`) and a 1x1 `final_layer`; it takes NHWC features as
`HeatmapHead` does and returns NCHW heatmaps. Parameters stay f32; BN has
flax's semantics (`heads.batch_norm`).

The multi-stage heads take a list of NCHW stage features and return a list
of NCHW maps in the compute dtype:

  * `MultiStageHead` (JAX :74, mmpose's TopdownHeatmapMultiStageHead): per
    stage a HeatmapHead's deconvs (`multi_deconv_layers.{s}`) and
    prediction conv (`multi_final_layers.{s}`, None for the identity);
    `AEMultiStageHead` (JAX :331, head 'ae_multi') is the same layout;
  * `PRM` (JAX :100, the Pose Refine Machine) and `MSMUHead` (JAX :145,
    mmpose's TopdownHeatmapMSMUHead): per (stage, unit)
    `predict_layers.{s * num_units + u}` with `conv_layers.{0,1}` (1x1 +
    ReLU, 3x3 to K), the map resized with align corners to `out_shape`,
    and `prm` when `use_prm` is set.

`RegressionHead` (JAX :26, mmpose's DeepposeRegressionHead behind the
GlobalAveragePooling neck): the mean over the NHWC features' H and W, then
`fc` to [N, K, 2] normalised coordinates in the compute dtype.

`Interhand3DHead` (JAX :223, mmpose's interhand_3d_head.py): on NCHW
features, the 2.5D volumes from `right_hand_head` and `left_hand_head`
(with `split_hands`, mmpose's layout: each a HeatmapHead's deconvs and
1x1 `final_layer` to 21 x D channels, right first) or one `hand_head`
(JAX's fused layout); `root_head.fc` and `hand_type_head.fc` (Linear 512,
ReLU, Linear) on the features' spatial mean. The volumes come out
[N, K, D, H, W] in JAX's channel order (channel j * D + d is joint j at
depth bin d).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .heads import _DECONV_PADDING, HeatmapHead, run_heatmap_head
from .more_cnns import ConvBN
from .multistage_nets import resize_bilinear_ac
from .resnet import BasicBlock, conv2d, init_cnn, norm
from .vit import compute_dtype, linear, normal_


class RegressionHead(nn.Module):
    """DeepPose: global average pool + `fc` -> [N, K, 2]."""

    def __init__(self, in_channels, num_joints, dtype='float32',
                 generator=None):
        super().__init__()
        self.num_joints = num_joints
        self.dtype = compute_dtype(dtype)
        self.fc = nn.Linear(in_channels, num_joints * 2)
        init_cnn(self, generator)

    def forward(self, x):
        x = x.to(self.dtype).mean(dim=(1, 2))
        return linear(self.fc, x, self.dtype).reshape(-1, self.num_joints, 2)


class AEHead(HeatmapHead):
    """Associative-embedding simple head: K heatmaps + K tag maps (or one
    shared tag map without `tag_per_joint`; none without `with_ae_loss`)."""

    def __init__(self, in_channels, num_joints, tag_per_joint=True,
                 with_ae_loss=True, deconv_filters=(), deconv_kernels=(),
                 final_kernel=1, dtype='float32', generator=None):
        dim_tag = num_joints if tag_per_joint else 1
        super().__init__(in_channels,
                         num_joints + (dim_tag if with_ae_loss else 0),
                         deconv_filters, deconv_kernels, final_kernel, dtype,
                         generator)
        self.with_ae_loss = with_ae_loss

    def forward(self, x):
        # HeatmapHead takes NHWC: a permuted view of the NCHW features
        return [super().forward(x.permute(0, 2, 3, 1))]


class AEHigherResolutionHead(nn.Module):
    """HigherHRNet's head: a prediction conv on the input features, then
    per deconv stage [deconv + BN + ReLU, `num_basic_blocks` BasicBlocks]
    and that stage's prediction conv."""

    def __init__(self, in_channels, num_joints, tag_per_joint=True,
                 num_deconv_layers=1, deconv_filters=(32,),
                 deconv_kernels=(4,), num_basic_blocks=4, cat_output=(True,),
                 with_ae_loss=(True, False), final_kernel=1,
                 dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.with_ae_loss = tuple(with_ae_loss)
        self.cat_output = tuple(cat_output)
        dim_tag = num_joints if tag_per_joint else 1
        outs = [num_joints + dim_tag if self.with_ae_loss[i] else num_joints
                for i in range(num_deconv_layers + 1)]
        pad = (final_kernel - 1) // 2
        widths = [in_channels] + list(deconv_filters[:num_deconv_layers])
        self.final_layers = nn.ModuleList(
            nn.Conv2d(widths[i], outs[i], final_kernel, padding=pad)
            for i in range(num_deconv_layers + 1))
        stages = []
        c = in_channels
        for i in range(num_deconv_layers):
            cin = c + outs[i] if self.cat_output[i] else c
            k = deconv_kernels[i]
            if k not in _DECONV_PADDING:
                raise ValueError(f'deconv kernel {k}: expected 2, 3 or 4')
            p, out_pad = _DECONV_PADDING[k]
            planes = deconv_filters[i]
            stages.append(nn.Sequential(
                nn.Sequential(nn.ConvTranspose2d(
                    cin, planes, k, stride=2, padding=p,
                    output_padding=out_pad, bias=False),
                    nn.BatchNorm2d(planes, eps=1e-5), nn.ReLU(inplace=True)),
                *[nn.Sequential(BasicBlock(planes, planes, dtype=dtype))
                  for _ in range(num_basic_blocks)]))
            c = planes
        self.deconv_layers = nn.ModuleList(stages)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        init_cnn(self, generator)              # the convs and BN
        for stage in self.deconv_layers:
            deconv = stage[0][0]
            normal_(deconv.weight, (deconv.in_channels
                                    * deconv.kernel_size[0]
                                    * deconv.kernel_size[1]) ** -0.5,
                    generator)

    def forward(self, x):
        dt = self.dtype
        outs = [conv2d(self.final_layers[0], x, dt)]
        for i, stage in enumerate(self.deconv_layers):
            if self.cat_output[i]:
                x = torch.cat([x.to(dt), outs[-1]], dim=1)
            deconv, bn = stage[0][0], stage[0][1]
            x = F.conv_transpose2d(x.to(dt), deconv.weight.to(dt), None,
                                   stride=2, padding=deconv.padding,
                                   output_padding=deconv.output_padding)
            x = norm(bn, x, dt, relu=True)
            for block in stage[1:]:
                x = block[0](x)
            outs.append(conv2d(self.final_layers[i + 1], x, dt))
        return outs


class ViPNASHead(HeatmapHead):
    """ViPNAS's head: per layer a grouped 4x4/2 deconv of f // g * g
    outputs, BN, ReLU (the pairs of `deconv_filters` and `deconv_groups`,
    zipped as JAX zips them), then the 1x1 prediction conv. The defaults are
    the ViPNAS-ResNet recipe (144 wide, 16 groups)."""

    def __init__(self, in_channels, out_channels,
                 deconv_filters=(144, 144, 144), deconv_groups=(16, 16, 16),
                 dtype='float32', generator=None):
        pairs = list(zip(deconv_filters, deconv_groups))
        super().__init__(in_channels, out_channels, [f for f, _ in pairs],
                         [4] * len(pairs), 1, dtype, generator,
                         deconv_groups=[g for _, g in pairs])


class MultiStageHead(nn.Module):
    """One classic head per stage over a list of NCHW stage features: the
    deconvs of `deconv_filters`/`deconv_kernels` and the prediction conv
    (final_kernel 0: none; no deconvs and no conv pass the maps through, as
    the CPM configs' identity head does)."""

    def __init__(self, in_channels, out_channels, num_stages=1,
                 deconv_filters=(256, 256, 256), deconv_kernels=(4, 4, 4),
                 final_kernel=1, dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        heads = [HeatmapHead(in_channels, out_channels, deconv_filters,
                             deconv_kernels, final_kernel, dtype, generator)
                 for _ in range(num_stages)]
        self.multi_deconv_layers = nn.ModuleList(h.deconv_layers
                                                 for h in heads)
        self.multi_final_layers = nn.ModuleList(h.final_layer for h in heads)

    def forward(self, xs):
        if len(xs) != len(self.multi_deconv_layers):
            raise ValueError(f'{len(xs)} stage features for '
                             f'{len(self.multi_deconv_layers)} stages')
        return [run_heatmap_head(d, f, x, self.dtype) for d, f, x in
                zip(self.multi_deconv_layers, self.multi_final_layers, xs)]


class AEMultiStageHead(MultiStageHead):
    """Hourglass-AE's head: per stage `num_deconv_layers` deconvs and the
    prediction conv (final_kernel 0: none; the zoo's config has neither, so
    the backbone's per-stack maps pass through), outputs in f32."""

    def __init__(self, in_channels, out_channels, num_stages=1,
                 num_deconv_layers=3, deconv_filters=(256, 256, 256),
                 deconv_kernels=(4, 4, 4), final_kernel=1, dtype='float32',
                 generator=None):
        super().__init__(in_channels, out_channels, num_stages,
                         deconv_filters[:num_deconv_layers],
                         deconv_kernels[:num_deconv_layers], final_kernel,
                         dtype, generator)

    def forward(self, xs):
        return [o.float() for o in super().forward(xs)]


class _SeparableConv(nn.Module):
    """mmcv's DepthwiseSeparableConvModule: `depthwise_conv` and
    `pointwise_conv` ConvModules, both with BN and ReLU."""

    def __init__(self, cin, cout, k, dtype):
        super().__init__()
        self.depthwise_conv = ConvBN(cin, cin, k, groups=cin, dtype=dtype,
                                     act='relu')
        self.pointwise_conv = ConvBN(cin, cout, 1, dtype=dtype, act='relu')

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class PRM(nn.Module):
    """Pose Refine Machine: `conv_bn_relu_prm_1` (3x3), then the channel
    attention `middle_path` (spatial mean, Linear + BN1d + ReLU twice,
    sigmoid) and the spatial one `bottom_path` (1x1, 9x9 depthwise-
    separable to one channel, sigmoid): out1 * (1 + channel * spatial)."""

    def __init__(self, channels, dtype='float32'):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        k = channels
        self.conv_bn_relu_prm_1 = ConvBN(k, k, 3, dtype=dtype, act='relu')
        self.middle_path = nn.Sequential(
            nn.Linear(k, k), nn.BatchNorm1d(k), nn.ReLU(), nn.Linear(k, k),
            nn.BatchNorm1d(k), nn.ReLU(), nn.Sigmoid())
        self.bottom_path = nn.Sequential(
            ConvBN(k, k, 1, dtype=dtype, act='relu'),
            _SeparableConv(k, 1, 9, dtype), nn.Sigmoid())

    def forward(self, x):
        dt = self.dtype
        out1 = self.conv_bn_relu_prm_1(x)
        m = out1.mean((2, 3))
        for fc, bn in ((self.middle_path[0], self.middle_path[1]),
                       (self.middle_path[3], self.middle_path[4])):
            m = F.linear(m, fc.weight.to(dt), fc.bias.to(dt))
            m = norm(bn, m[:, :, None, None], dt, relu=True)[:, :, 0, 0]
        b = self.bottom_path[1](self.bottom_path[0](out1))
        return out1 * (1.0 + torch.sigmoid(m)[:, :, None, None]
                       * torch.sigmoid(b))


class _PredictHeatmap(nn.Module):
    """mmpose's PredictHeatmap: `conv_layers` (1x1 ConvModule with ReLU,
    3x3 ConvModule to K without) and, with `use_prm`, `prm`."""

    def __init__(self, in_channels, out_channels, use_prm, dtype):
        super().__init__()
        self.conv_layers = nn.Sequential(
            ConvBN(in_channels, in_channels, 1, dtype=dtype, act='relu'),
            ConvBN(in_channels, out_channels, 3, dtype=dtype))
        self.prm = PRM(out_channels, dtype) if use_prm else None


class MSMUHead(nn.Module):
    """The Multi-Stage Multi-Unit head of MSPN and RSN over their list of
    stages of unit features: every unit's map, resized with align corners
    to `out_shape` (h, w) in f32 (JAX's matmul form at HIGHEST), then the
    PRM, in stage-major, unit order (each unit lowest resolution first)."""

    def __init__(self, in_channels, out_channels, num_stages=2, num_units=4,
                 out_shape=None, use_prm=False, dtype='float32',
                 generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.num_units = num_units
        self.out_shape = out_shape
        self.predict_layers = nn.ModuleList(
            _PredictHeatmap(in_channels, out_channels, use_prm, dtype)
            for _ in range(num_stages * num_units))
        init_cnn(self, generator)

    def forward(self, stage_feats):
        out_shape = self.out_shape or stage_feats[0][-1].shape[2:]
        outs = []
        for si, feats in enumerate(stage_feats):
            if len(feats) != self.num_units:
                raise ValueError(f'stage {si}: {len(feats)} unit features for '
                                 f'{self.num_units} units')
            for ui, f in enumerate(feats):
                layer = self.predict_layers[si * self.num_units + ui]
                x = resize_bilinear_ac(layer.conv_layers(f), out_shape)
                outs.append(x if layer.prm is None else layer.prm(x))
        return outs


class Interhand3DHead(nn.Module):
    """NCHW features -> (heatmaps3d [N, K, D, H, W], root-depth logits
    [N, root_depth_bins], hand-type logits [N, 2]) in the compute dtype."""

    def __init__(self, in_channels, num_joints=42, depth_size=64,
                 root_depth_bins=64, deconv_filters=(256, 256),
                 split_hands=False, dtype='float32', generator=None):
        super().__init__()
        self.num_joints = num_joints
        self.depth_size = depth_size
        self.split_hands = split_hands
        self.dtype = compute_dtype(dtype)
        n = len(deconv_filters)
        kw = dict(deconv_filters=tuple(deconv_filters),
                  deconv_kernels=(4,) * n, final_kernel=1, dtype=dtype,
                  generator=generator)
        if split_hands:
            if num_joints % 2:
                raise ValueError(f'split_hands with {num_joints} joints: '
                                 'expected an even number')
            half = num_joints // 2 * depth_size
            self.right_hand_head = HeatmapHead(in_channels, half, **kw)
            self.left_hand_head = HeatmapHead(in_channels, half, **kw)
        else:
            self.hand_head = HeatmapHead(in_channels,
                                         num_joints * depth_size, **kw)
        self.root_head = nn.Module()
        self.root_head.fc = nn.Sequential(
            nn.Linear(in_channels, 512), nn.ReLU(),
            nn.Linear(512, root_depth_bins))
        self.hand_type_head = nn.Module()
        self.hand_type_head.fc = nn.Sequential(
            nn.Linear(in_channels, 512), nn.ReLU(), nn.Linear(512, 2))
        init_cnn(self.root_head, generator)
        init_cnn(self.hand_type_head, generator)

    @staticmethod
    def _mlp(fc, x, dt):
        return linear(fc[2], F.relu(linear(fc[0], x, dt)), dt)

    def forward(self, x):
        dt = self.dtype
        heads = ((self.right_hand_head, self.left_hand_head)
                 if self.split_hands else (self.hand_head,))
        hm = torch.cat([run_heatmap_head(h.deconv_layers, h.final_layer, x,
                                         dt) for h in heads], dim=1)
        n, _, hh, ww = hm.shape
        heatmaps3d = hm.reshape(n, self.num_joints, self.depth_size, hh, ww)
        pooled = x.to(dt).mean(dim=(2, 3))
        return (heatmaps3d, self._mlp(self.root_head.fc, pooled, dt),
                self._mlp(self.hand_type_head.fc, pooled, dt))

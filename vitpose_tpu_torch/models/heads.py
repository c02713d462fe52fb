"""The ViTPose decoders in PyTorch: the classic deconv heatmap head and the
simple decoder.

Counterpart of vitpose_tpu/models/heads.py `HeatmapHead` and `SimpleHead`,
with the mmpose names (`deconv_layers.{3i}` ConvTranspose2d,
`deconv_layers.{3i+1}` BatchNorm2d, `final_layer`). Flax's
ConvTranspose(k4, s2, 'SAME', transpose_kernel=True) is
ConvTranspose2d(k4, s2, padding 1, no bias); the BN
eps is 1e-5 and eval uses the running statistics. Parameters stay f32 and are
cast to the compute dtype; BN runs in f32 and casts its result, as flax does.

BatchNorm in training mode follows flax's `BatchNorm(momentum=0.9)`, not
torch's: statistics in f32 over (N, H, W) with the variance taken as
max(0, E[x^2] - E[x]^2), the biased variance both to normalise and in the
running update `0.9 * old + 0.1 * batch` (torch's BatchNorm2d stores the
unbiased one).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.mesh import all_reduce_sum, axis_group
from .vit import at_least_f32, compute_dtype, normal_

FLAX_BN_MOMENTUM = 0.9

# mmpose `_get_deconv_cfg`: kernel -> (padding, output_padding)
_DECONV_PADDING = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


class HeatmapHead(nn.Module):
    """Deconv stack, optional channel-preserving Conv + BN + ReLU layers,
    then the prediction conv: NHWC features -> NCHW heatmaps in the compute
    dtype.

    `deconv_groups` makes each deconv grouped (the ViPNAS head): one
    ConvTranspose2d of `groups` g and f // g * g outputs, mmpose's
    [in, f // g, k, k] weight, for JAX's g flax ConvTransposes.

    `extra_conv_kernels` (JAX's `extra_conv_kernels`, mmpose's extra
    num_conv_layers/num_conv_kernels, used by the HRNetV2 heads) turns
    `final_layer` into mmpose's Sequential: conv (with bias), BN and ReLU
    at `final_layer.{3i}`, `.{3i+1}`, `.{3i+2}` per extra layer, the
    prediction conv last.
    """

    def __init__(self, in_channels, out_channels, deconv_filters=(256, 256),
                 deconv_kernels=(4, 4), final_kernel=1, dtype='float32',
                 generator=None, extra_conv_kernels=(), deconv_groups=()):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        layers = []
        c = in_channels
        groups = deconv_groups or (1,) * len(deconv_filters)
        for f, k, g in zip(deconv_filters, deconv_kernels, groups):
            if k not in _DECONV_PADDING:
                raise ValueError(f'deconv kernel {k}: expected 2, 3 or 4')
            pad, out_pad = _DECONV_PADDING[k]
            f = f // g * g                  # g transposed convs of f // g
            layers += [nn.ConvTranspose2d(c, f, k, stride=2, padding=pad,
                                          output_padding=out_pad, groups=g,
                                          bias=False),
                       nn.BatchNorm2d(f, eps=1e-5),
                       nn.ReLU(inplace=True)]
            c = f
        self.deconv_layers = nn.Sequential(*layers)
        final = []
        for k in extra_conv_kernels:
            final += [nn.Conv2d(c, c, k, padding=(k - 1) // 2),
                      nn.BatchNorm2d(c, eps=1e-5), nn.ReLU(inplace=True)]
        # final_kernel <= 0: no prediction conv, the deconv features are the
        # output (the JAX head's identity final layer)
        if final_kernel > 0:
            final.append(nn.Conv2d(c, out_channels, final_kernel,
                                   padding=(final_kernel - 1) // 2))
        self.final_layer = (None if not final else final[0]
                            if len(final) == 1 else nn.Sequential(*final))
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        for layer in self.deconv_layers:
            if isinstance(layer, nn.ConvTranspose2d):
                fan_in = layer.in_channels // layer.groups \
                    * layer.kernel_size[0] * layer.kernel_size[1]
                normal_(layer.weight, fan_in ** -0.5, generator)
            elif isinstance(layer, nn.BatchNorm2d):
                layer.reset_parameters()
        final = self.final_layer
        for layer in ([] if final is None else final.modules()):
            if isinstance(layer, nn.Conv2d):
                init_conv(layer, generator)
            elif isinstance(layer, nn.BatchNorm2d):
                layer.reset_parameters()

    def forward(self, x):
        return run_heatmap_head(self.deconv_layers, self.final_layer,
                                x.permute(0, 3, 1, 2), self.dtype)


def run_heatmap_head(deconv_layers, final_layer, x, dt):
    """A HeatmapHead's `deconv_layers` and `final_layer` (None: the
    identity) on NCHW `x` in the compute dtype `dt`."""
    for i in range(0, len(deconv_layers), 3):
        deconv, bn = deconv_layers[i], deconv_layers[i + 1]
        x = F.conv_transpose2d(x.to(dt), deconv.weight.to(dt), None,
                               stride=2, padding=deconv.padding,
                               output_padding=deconv.output_padding,
                               groups=deconv.groups)
        x = F.relu(batch_norm(bn, at_least_f32(x)).to(dt))
    if final_layer is None:
        return x
    if not isinstance(final_layer, nn.Sequential):
        return conv(final_layer, x, dt)
    for i in range(0, len(final_layer) - 1, 3):
        x = conv(final_layer[i], x, dt)
        x = F.relu(batch_norm(final_layer[i + 1], at_least_f32(x)).to(dt))
    last = final_layer[-1]
    return conv(last, x, dt) if isinstance(last, nn.Conv2d) else x


class SimpleHead(nn.Module):
    """The ViTPose simple decoder: ReLU -> bilinear upsample by `upsample`
    (align_corners=False, jax.image.resize's 'bilinear' when enlarging) ->
    k x k prediction conv `final_layer`; NHWC features -> NCHW heatmaps in
    the compute dtype."""

    def __init__(self, in_channels, out_channels, upsample=4, final_kernel=3,
                 dtype='float32', generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.upsample = upsample
        self.final_layer = nn.Conv2d(in_channels, out_channels, final_kernel,
                                     padding=(final_kernel - 1) // 2)
        init_conv(self.final_layer, generator)

    def forward(self, x):
        dt = self.dtype
        x = F.relu(x.to(dt).permute(0, 3, 1, 2))
        x = F.interpolate(x, scale_factor=self.upsample, mode='bilinear',
                          align_corners=False)
        return conv(self.final_layer, x, dt)


def init_conv(layer: nn.Conv2d, generator=None):
    fan_in = layer.in_channels * layer.kernel_size[0] * layer.kernel_size[1]
    normal_(layer.weight, fan_in ** -0.5, generator)
    nn.init.zeros_(layer.bias)


def conv(layer: nn.Conv2d, x, dtype):
    """`layer` applied in `dtype`, with its input and f32 parameters cast."""
    return F.conv2d(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype), padding=layer.padding)


def batch_norm(bn: nn.BatchNorm2d, x):
    """`bn` on f32 NCHW `x` with flax semantics: running statistics in eval
    mode; in training mode batch statistics, and the running ones updated
    in place with the biased variance. Under an active data axis
    (parallel/mesh.py) the batch statistics are the global batch's."""
    if not bn.training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    group, n, _ = axis_group('data')
    if group is None:
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
    else:
        # the global batch's moments (JAX's sync-BN under the data mesh,
        # vitpose_tpu/models/heads.py:15-23): the sums over every data
        # rank's rows, their gradients summed back in the backward
        c = x.shape[1]
        sums = all_reduce_sum(torch.cat([x.sum((0, 2, 3)),
                                         (x * x).sum((0, 2, 3))]), group)
        count = x.numel() // c * n
        mean = sums[:c] / count
        var = torch.clamp(sums[c:] / count - mean * mean, min=0.0)
    with torch.no_grad():
        m = FLAX_BN_MOMENTUM
        bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
        bn.running_var.copy_(m * bn.running_var + (1 - m) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]

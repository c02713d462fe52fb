"""Classic deconv heatmap head, in PyTorch.

Counterpart of vitpose_tpu/models/heads.py `HeatmapHead`, with the mmpose
names (`deconv_layers.{3i}` ConvTranspose2d, `deconv_layers.{3i+1}`
BatchNorm2d, `final_layer`). Flax's ConvTranspose(k4, s2, 'SAME',
transpose_kernel=True) is ConvTranspose2d(k4, s2, padding 1, no bias); the BN
eps is 1e-5 and eval uses the running statistics. Parameters stay f32 and are
cast to the compute dtype; BN runs in f32 and casts its result, as flax does.
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from .vit import compute_dtype, normal_

# mmpose `_get_deconv_cfg`: kernel -> (padding, output_padding)
_DECONV_PADDING = {4: (1, 0), 3: (1, 1), 2: (0, 0)}


class HeatmapHead(nn.Module):
    """Deconv stack + 1x1 prediction conv: NHWC features -> NCHW heatmaps in
    the compute dtype."""

    def __init__(self, in_channels, out_channels, deconv_filters=(256, 256),
                 deconv_kernels=(4, 4), final_kernel=1, dtype='float32',
                 generator=None):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        layers = []
        c = in_channels
        for f, k in zip(deconv_filters, deconv_kernels):
            if k not in _DECONV_PADDING:
                raise ValueError(f'deconv kernel {k}: expected 2, 3 or 4')
            pad, out_pad = _DECONV_PADDING[k]
            layers += [nn.ConvTranspose2d(c, f, k, stride=2, padding=pad,
                                          output_padding=out_pad, bias=False),
                       nn.BatchNorm2d(f, eps=1e-5),
                       nn.ReLU(inplace=True)]
            c = f
        self.deconv_layers = nn.Sequential(*layers)
        if final_kernel < 1:
            raise NotImplementedError('an identity final layer is not ported '
                                      'yet (ROADMAP.md queue 1 item 12)')
        self.final_layer = nn.Conv2d(c, out_channels, final_kernel,
                                     padding=(final_kernel - 1) // 2)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        for layer in self.deconv_layers:
            if isinstance(layer, nn.ConvTranspose2d):
                fan_in = layer.in_channels * layer.kernel_size[0] \
                    * layer.kernel_size[1]
                normal_(layer.weight, fan_in ** -0.5, generator)
            elif isinstance(layer, nn.BatchNorm2d):
                layer.reset_parameters()
        final = self.final_layer
        fan_in = final.in_channels * final.kernel_size[0] * final.kernel_size[1]
        normal_(final.weight, fan_in ** -0.5, generator)
        nn.init.zeros_(final.bias)

    def forward(self, x):
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        for i in range(0, len(self.deconv_layers), 3):
            deconv, bn = self.deconv_layers[i], self.deconv_layers[i + 1]
            x = F.conv_transpose2d(x, deconv.weight.to(dt), None, stride=2,
                                   padding=deconv.padding,
                                   output_padding=deconv.output_padding)
            x = F.relu(bn(x.float()).to(dt))
        final = self.final_layer
        return F.conv2d(x, final.weight.to(dt), final.bias.to(dt),
                        padding=final.padding)

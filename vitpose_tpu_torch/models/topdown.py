"""Top-down pose estimator (ViT backbone + classic deconv head), in PyTorch.

Counterpart of vitpose_tpu/models/topdown.py: `TopDownConfig`,
`make_config`, `TopDownModel`, `forward`, `infer` (flip test with
`flip_back` and the optional 1-pixel `shift_heatmap`) and `loss_fn`. Models
take NHWC float crops and return NCHW float32 heatmaps, as in the JAX
package.

The mode is explicit, as JAX's `train=` argument is: `forward` sets the
module's training mode for its call, and `infer` always runs in eval mode,
whatever mode a training step left the module in.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..ops.geometry import flip_back
from .heads import HeatmapHead
from .losses import joints_mse_loss
from .vit import ViT, ViTConfig, VIT_VARIANTS


@dataclasses.dataclass(frozen=True)
class TopDownConfig:
    backbone: ViTConfig = ViTConfig()
    head_type: str = 'heatmap'
    out_channels: int = 17
    deconv_filters: tuple = (256, 256)
    deconv_kernels: tuple = (4, 4)
    final_kernel: int = 1
    # test-time behaviour (reference test_cfg)
    flip_test: bool = True
    shift_heatmap: bool = False
    post_process: str = 'default'
    modulate_kernel: int = 11
    use_udp: bool = True
    target_type: str = 'GaussianHeatmap'


def make_config(variant='b', img_size=(256, 192), head='heatmap',
                out_channels=17, num_experts=0, part_dim=0,
                dtype='float32', remat=False, remat_policy='full',
                **test_cfg):
    bb = ViTConfig(img_size=tuple(img_size), num_experts=num_experts,
                   part_dim=part_dim, dtype=dtype, remat_blocks=remat,
                   remat_policy=remat_policy, **VIT_VARIANTS[variant])
    return TopDownConfig(backbone=bb, head_type=head,
                         out_channels=out_channels, **test_cfg)


class TopDownModel(nn.Module):
    """`backbone` (ViT) + `keypoint_head` (HeatmapHead): [N, H, W, 3] ->
    [N, K, H/4, W/4] float32."""

    def __init__(self, cfg: TopDownConfig, generator=None):
        super().__init__()
        if cfg.head_type != 'heatmap':
            raise NotImplementedError(
                f'head_type {cfg.head_type!r}: only the classic deconv head '
                'is ported (ROADMAP.md queue 1 item 3)')
        self.cfg = cfg
        self.backbone = ViT(cfg.backbone, generator)
        self.keypoint_head = HeatmapHead(
            cfg.backbone.embed_dim, cfg.out_channels, cfg.deconv_filters,
            cfg.deconv_kernels, cfg.final_kernel, cfg.backbone.dtype,
            generator)

    def forward(self, imgs, generator=None):
        return self.keypoint_head(self.backbone(imgs, generator)).float()


def forward(model: TopDownModel, imgs, train=False, generator=None):
    """The counterpart of the JAX `forward(model, variables, imgs, train,
    rngs=...)`: the parameters and BN statistics live in the module.

    Sets the module's mode to `train` for this call. In training mode BN
    uses (and updates) batch statistics and DropPath draws from
    `generator`, a torch.Generator on the input's device.
    """
    model.train(train)
    return model(imgs, generator)


def infer(model: TopDownModel, imgs, flip_index=None):
    """Eval forward with the optional flip test, all on the input's device.

    The averaged heatmap is (hm + flip_back(hm(flipped))) / 2, the flipped
    map shifted right by one pixel when `shift_heatmap` is set (reference
    top_down.py:163-188). The flipped pass is a second forward.
    """
    cfg = model.cfg
    model.eval()
    hm = model(imgs)
    if flip_index is None or not cfg.flip_test:
        return hm
    hm_f = model(imgs.flip(2))                       # W axis of NHWC
    hm_f = flip_back(hm_f, flip_index, target_type=cfg.target_type)
    if cfg.shift_heatmap:
        hm_f = torch.cat([hm_f[..., :1], hm_f[..., :-1]], dim=-1)
    return (hm + hm_f) * 0.5


def loss_fn(heatmaps, target, target_weight, target_type='GaussianHeatmap'):
    """Keypoint loss dict (reference TopdownHeatmapSimpleHead.get_loss)."""
    if target_type.lower() == 'combinedtarget':
        raise NotImplementedError('the CombinedTarget loss is not ported yet '
                                  '(ROADMAP.md queue 1 item 7)')
    return {'heatmap_loss': joints_mse_loss(heatmaps, target, target_weight)}

"""Top-down pose estimators in PyTorch: the ViT with the classic deconv head
or the simple decoder, and a CNN backbone with the classic or the ViPNAS
head.

Counterpart of vitpose_tpu/models/topdown.py: `TopDownConfig`,
`make_config`, `TopDownModel` (with the ViTPose+ associate heads),
`GenericTopDown` (every single-stage CNN of `train.loop.build_backbone`,
with the classic, the ViPNAS or the DeepPose regression head),
`GenericMultiStageTopDown` (CPM, stacked Hourglass, MSPN and RSN with
their heads), `forward`, `infer` (flip test with `flip_back` and the
optional 1-pixel `shift_heatmap`; for DeepPose the static-centre flip of
the coordinates) and `loss_fn`. Models take NHWC float crops and return
NCHW float32 heatmaps (DeepPose: [N, K, 2] float32 normalised
coordinates), as in the JAX package.

The mode is explicit, as JAX's `train=` argument is: `forward` sets the
module's training mode for its call, and `infer` always runs in eval mode,
whatever mode a training step left the module in.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..ops.geometry import flip_back, fliplr_regression
from .heads import HeatmapHead, SimpleHead
from .heads_extra import MSMUHead, MultiStageHead, RegressionHead, ViPNASHead
from .losses import combined_target_mse_loss, joints_mse_loss
from .vit import ViT, ViTConfig, VIT_VARIANTS, at_least_f32


@dataclasses.dataclass(frozen=True)
class TopDownConfig:
    backbone: ViTConfig = ViTConfig()
    head_type: str = 'heatmap'
    out_channels: int = 17
    deconv_filters: tuple = (256, 256)
    deconv_kernels: tuple = (4, 4)
    # the ViPNAS head's groups per deconv; () keeps its defaults (144 wide,
    # 16 groups: the ViPNAS-ResNet recipe)
    deconv_groups: tuple = ()
    final_kernel: int = 1
    # channel-preserving Conv+BN+ReLU layers before the prediction conv
    # (the HRNetV2 heads)
    head_extra_convs: tuple = ()
    upsample: int = 4                   # the simple decoder's factor
    # test-time behaviour (reference test_cfg)
    flip_test: bool = True
    shift_heatmap: bool = False
    post_process: str = 'default'
    modulate_kernel: int = 11
    use_udp: bool = True
    target_type: str = 'GaussianHeatmap'
    # criteria: the DeepPose regression loss ('smooth_l1', 'wing',
    # 'soft_wing') and the heatmap loss ('mse', 'awing')
    reg_loss: str = 'smooth_l1'
    heatmap_loss: str = 'mse'
    # ViTPose+: associate heads for the other datasets of the mixture
    num_extra_heads: int = 0
    extra_head_channels: tuple = ()
    # the multi-stage backbones' heads (CPM, Hourglass, MSPN, RSN): stage
    # and unit counts; use_prm appends RSN's Pose Refine Machine
    num_stages: int = 1
    num_units: int = 4
    use_prm: bool = False


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
    """`backbone` (ViT) + `keypoint_head` (HeatmapHead for head_type
    'heatmap', SimpleHead for 'simple'): [N, H, W, 3] -> [N, K, H/4, W/4]
    float32. ViTPose+ adds `associate_keypoint_heads` (mmpose's name), one
    HeatmapHead like the main one per extra dataset (JAX
    `extra_head_{j}`)."""
    backbone_type = 'vit'

    def __init__(self, cfg: TopDownConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.backbone = ViT(cfg.backbone, generator)
        d, dtype = cfg.backbone.embed_dim, cfg.backbone.dtype
        if cfg.head_type == 'heatmap':
            self.keypoint_head = HeatmapHead(
                d, cfg.out_channels, cfg.deconv_filters, cfg.deconv_kernels,
                cfg.final_kernel, dtype, generator)
        elif cfg.head_type == 'simple':
            self.keypoint_head = SimpleHead(d, cfg.out_channels,
                                            cfg.upsample, dtype=dtype,
                                            generator=generator)
        else:
            # a ViT takes the classic deconv head or the simple decoder;
            # JAX raises ValueError(head_type) for any other
            raise ValueError(cfg.head_type)
        self.associate_keypoint_heads = nn.ModuleList([
            HeatmapHead(d, ch, cfg.deconv_filters, cfg.deconv_kernels,
                        cfg.final_kernel, dtype, generator)
            for ch in (cfg.extra_head_channels[j]
                       for j in range(cfg.num_extra_heads))])

    def forward(self, imgs, generator=None, expert_idx=None, head_idx=None,
                all_heads=False):
        """Heatmaps of the main head (`head_idx` None or 0) or of associate
        head head_idx - 1; with `all_heads`, the list over [main,
        *associate] heads, each run on the whole batch (ViTPose+ training,
        reference top_down_moe.py:166-203). `expert_idx`: see
        vit.expert_routing."""
        feat = self.backbone(imgs, generator, expert_idx)
        if all_heads:
            heads = [self.keypoint_head, *self.associate_keypoint_heads]
            return [at_least_f32(h(feat)) for h in heads]
        head = (self.keypoint_head if not head_idx
                else self.associate_keypoint_heads[head_idx - 1])
        return at_least_f32(head(feat))


class GenericTopDown(nn.Module):
    """A CNN backbone (`backbone`, an NCHW feature module with
    `out_channels`) + `keypoint_head`, the classic head built from the
    config's deconv_filters/kernels, final_kernel and head_extra_convs, for
    head_type 'vipnas' the ViPNAS head from deconv_filters and
    deconv_groups, or for 'regression' the DeepPose head ([N, K, 2] f32
    coordinates, not transposed), in the placeholder backbone config's
    dtype (JAX GenericTopDown, vitpose_tpu/models/topdown.py:131-178). Same
    interface
    as TopDownModel: `generator`, `expert_idx` and `head_idx` are accepted
    and ignored, and `all_heads` returns [heatmaps]. `backbone_type` (the
    config's name, e.g. 'hrnet') routes checkpoints to their converter."""

    def __init__(self, backbone: nn.Module, cfg: TopDownConfig,
                 backbone_type: str, generator=None):
        super().__init__()
        self.cfg = cfg
        self.backbone_type = backbone_type
        self.backbone = backbone
        if cfg.head_type == 'vipnas':
            kw = (dict(deconv_filters=cfg.deconv_filters,
                       deconv_groups=cfg.deconv_groups)
                  if cfg.deconv_groups else {})
            self.keypoint_head = ViPNASHead(
                backbone.out_channels, cfg.out_channels,
                dtype=cfg.backbone.dtype, generator=generator, **kw)
        elif cfg.head_type == 'regression':
            self.keypoint_head = RegressionHead(
                backbone.out_channels, cfg.out_channels, cfg.backbone.dtype,
                generator)
        else:
            self.keypoint_head = HeatmapHead(
                backbone.out_channels, cfg.out_channels, cfg.deconv_filters,
                cfg.deconv_kernels, cfg.final_kernel, cfg.backbone.dtype,
                generator, extra_conv_kernels=cfg.head_extra_convs)

    def forward(self, imgs, generator=None, expert_idx=None, head_idx=None,
                all_heads=False):
        feat = self.backbone(imgs)
        # the head takes NHWC: a permuted view of the NCHW features, which
        # it permutes back
        out = at_least_f32(self.keypoint_head(feat.permute(0, 2, 3, 1)))
        return [out] if all_heads else out


class GenericMultiStageTopDown(nn.Module):
    """A multi-stage CNN backbone (a list of NCHW stage features, or for
    MSPN and RSN a list of stages of unit features) + `keypoint_head`, one
    map per stage or (stage, unit): head_type 'msmu' the MSMU head at a
    quarter of the crop, 'multistage' the classic head per stage,
    'identity' the backbone's own per-stage maps (CPM; mmpose's multi-stage
    head without layers), in the placeholder backbone config's dtype (JAX
    GenericMultiStageTopDown, vitpose_tpu/models/topdown.py:181-233). In
    training mode, or with `all_heads`, it returns the list of every map
    in f32, so that every stage is supervised; in eval mode the last one,
    so that `infer` and its flip test see the final prediction. Same
    interface as GenericTopDown otherwise."""

    def __init__(self, backbone: nn.Module, cfg: TopDownConfig,
                 backbone_type: str, generator=None):
        super().__init__()
        self.cfg = cfg
        self.backbone_type = backbone_type
        self.backbone = backbone
        c, dtype = backbone.out_channels, cfg.backbone.dtype
        if cfg.head_type == 'msmu':
            ih, iw = cfg.backbone.img_size
            self.keypoint_head = MSMUHead(
                c, cfg.out_channels, cfg.num_stages, cfg.num_units,
                (ih // 4, iw // 4), cfg.use_prm, dtype, generator)
        elif cfg.head_type == 'identity':
            self.keypoint_head = MultiStageHead(c, cfg.out_channels,
                                                cfg.num_stages, (), (), 0,
                                                dtype)
        elif cfg.head_type == 'multistage':
            self.keypoint_head = MultiStageHead(
                c, cfg.out_channels, cfg.num_stages, cfg.deconv_filters,
                cfg.deconv_kernels, cfg.final_kernel, dtype, generator)
        else:
            raise ValueError(f'head_type {cfg.head_type!r}: a multi-stage '
                             "model takes 'msmu', 'multistage' or "
                             "'identity'")

    def forward(self, imgs, generator=None, expert_idx=None, head_idx=None,
                all_heads=False):
        outs = [at_least_f32(o)
                for o in self.keypoint_head(self.backbone(imgs))]
        return outs if self.training or all_heads else outs[-1]


def forward(model: TopDownModel, imgs, train=False, generator=None,
            expert_idx=None, **kw):
    """The counterpart of the JAX `forward(model, variables, imgs, train,
    expert_idx, rngs=...)`: the parameters and BN statistics live in the
    module; `kw` (head_idx, all_heads) goes to the model.

    Sets the module's mode to `train` for this call. In training mode BN
    uses (and updates) batch statistics, every head's under `all_heads`,
    and DropPath draws from `generator`, a torch.Generator on the input's
    device.
    """
    model.train(train)
    return model(imgs, generator, expert_idx, **kw)


def infer(model: TopDownModel, imgs, flip_index=None, expert_idx=None,
          head_idx=None):
    """Eval forward with the optional flip test, all on the input's device.

    The averaged heatmap is (hm + flip_back(hm(flipped))) / 2, the flipped
    map shifted right by one pixel when `shift_heatmap` is set (reference
    top_down.py:163-188). The flipped pass is a second forward. A ViTPose+
    model runs expert `expert_idx` and head `head_idx` (0: the main one).
    A DeepPose model averages its coordinates with the flipped pass's,
    permuted by `flip_index` and mirrored about the static centre: x ->
    1 - x (deeppose_regression_head.py:110).
    """
    cfg = model.cfg
    model.eval()
    hm = model(imgs, expert_idx=expert_idx, head_idx=head_idx)
    if flip_index is None or not cfg.flip_test:
        return hm
    hm_f = model(imgs.flip(2), expert_idx=expert_idx,      # W axis of NHWC
                 head_idx=head_idx)
    if cfg.head_type == 'regression':
        return (hm + fliplr_regression(hm_f, None,
                                       flip_index=flip_index)) * 0.5
    hm_f = flip_back(hm_f, flip_index, target_type=cfg.target_type)
    if cfg.shift_heatmap:
        hm_f = torch.cat([hm_f[..., :1], hm_f[..., :-1]], dim=-1)
    return (hm + hm_f) * 0.5


def loss_fn(heatmaps, target, target_weight, target_type='GaussianHeatmap'):
    """Keypoint loss dict (reference TopdownHeatmapSimpleHead.get_loss)."""
    if target_type.lower() == 'combinedtarget':
        return {'heatmap_loss': combined_target_mse_loss(
            heatmaps, target, target_weight)}
    return {'heatmap_loss': joints_mse_loss(heatmaps, target, target_weight)}

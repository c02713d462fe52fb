"""PoseWarper: video top-down pose with deformable temporal alignment.

Counterpart of vitpose_tpu/models/posewarper.py:18-76 (`PoseWarper`,
`build_posewarper`) under mmpose's names (`backbone.*`, `neck.*`,
`keypoint_head.*`): one backbone pass over the N * T frames of [N, T, H, W,
3] windows, the PoseWarperNeck warping every frame onto the key frame
(static `key_index`, default T // 2) and summing them with `frame_weight`,
then the heatmap head: [N, K, H/4, W/4] float32.
"""
from __future__ import annotations

import torch.nn as nn

from .heads import HeatmapHead
from .necks import PoseWarperNeck
from .vit import at_least_f32


class PoseWarper(nn.Module):
    """`backbone` (an NCHW feature module with `out_channels`), `neck` and
    `keypoint_head`. `backbone_type` routes checkpoints to their
    converter."""

    def __init__(self, backbone, neck, keypoint_head, backbone_type='hrnet'):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.keypoint_head = keypoint_head
        self.backbone_type = backbone_type

    def forward(self, frames, frame_weight=None, key_index=None):
        n, t, h, w, c = frames.shape
        feats = self.backbone(frames.reshape(n * t, h, w, c))
        feats = feats.reshape(n, t, *feats.shape[1:])
        key = feats[:, t // 2 if key_index is None else int(key_index)]
        agg = self.neck(key, feats, frame_weight=frame_weight)
        # the head takes NHWC: a permuted view of the NCHW features
        return at_least_f32(self.keypoint_head(agg.permute(0, 2, 3, 1)))


def build_posewarper(mcfg: dict, build_backbone, generator=None):
    """A config's `model` dict -> PoseWarper with random weights drawn from
    `generator`; `build_backbone` is train.loop's registry. The head
    defaults to the stage-2 recipe's parameter-free identity (no deconvs,
    no prediction conv: the neck already gives the heatmaps; reference
    stage-2 checkpoints hold no keypoint_head tensors); head_overrides that
    add deconvs get the 1x1 prediction conv unless they say otherwise."""
    mcfg = dict(mcfg)
    mcfg.pop('family', None)
    backbone_type = mcfg.pop('backbone_type', 'hrnet')
    bb = build_backbone(backbone_type, generator,
                        **(mcfg.pop('backbone_overrides', None) or {}))
    neck_kw = dict(mcfg.pop('neck', None) or {})
    # the optimizer's knob (train/posewarper_loop.py), not the module's
    neck_kw.pop('freeze_trans_layer', None)
    neck = PoseWarperNeck(bb.out_channels, generator=generator, **neck_kw)
    head_kw = dict(mcfg.pop('head_overrides', None) or {})
    head_kw.setdefault('deconv_filters', ())
    head_kw.setdefault('deconv_kernels', ())
    head_kw.setdefault('final_kernel',
                       0 if not head_kw['deconv_filters'] else 1)
    head = HeatmapHead(neck.out_channels, mcfg.pop('out_channels', 17),
                       generator=generator, **head_kw)
    return PoseWarper(bb, neck, head, backbone_type)

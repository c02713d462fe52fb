"""Bottom-up (associative embedding) pose estimation, in PyTorch.

Counterpart of vitpose_tpu/models/bottomup.py (the reference
`AssociativeEmbedding` detector, mmpose/models/detectors/
associative_embedding.py:28, and its aggregation utilities,
mmpose/core/evaluation/bottom_up_eval.py):

  * `BottomUpEstimator`: `backbone` + `keypoint_head` (mmpose's names, so a
    reference .pth loads with strict=True) and the `HeatmapParser`; its
    forward gives the head's list of NCHW maps in f32;
  * `infer` / `ae_forward_with_flip`: the original and the flipped pass on
    the input's device, heatmaps averaged and tags stacked along L;
    `parse` groups on the host and maps the poses back to the image
    (`get_group_preds`);
  * the multi-scale test protocol's helpers (`split_ae_outputs`,
    `flip_feature_maps`, `aggregate_stage_flip`, `aggregate_scale`).

Resizing: `jax.image.resize(..., 'bilinear')` samples at half-pixel centres
and antialiases when it shrinks, which is `F.interpolate(mode='bilinear',
align_corners=False, antialias=True)` (`resize_bilinear`); the
align-corners path of the UDP configs is `F.interpolate(align_corners=True)`
without antialiasing (`multistage_nets.resize_bilinear_ac`, JAX's
multistage_nets.py:56).

A multi-stage head (`AEMultiStageHead`, Hourglass-AE's) takes the
backbone's whole per-stack list and gives one output per stack, all of
which training supervises; at test time only the last stage is kept
(`multi_stage`; the reference config's select_output_index=[3]), where a
multi-resolution head's outputs are reduced to one map.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import transform_preds
from ..ops.group import HeatmapParser
from .heads_extra import AEHead, AEMultiStageHead
from .multistage_nets import resize_bilinear_ac
from .vit import ViT, ViTConfig


def resize_bilinear(x, size_hw):
    """NCHW bilinear resize as jax.image.resize's 'bilinear' (half-pixel
    centres, antialiased when shrinking)."""
    return F.interpolate(x, size=tuple(size_hw), mode='bilinear',
                         align_corners=False, antialias=True)


def reduce_multires_output(outs, num_joints, with_ae=None):
    """Multi-resolution AE head outputs (NCHW list, e.g.
    AEHigherResolutionHead's) -> ONE [N, K+tagK, H, W] map at the highest
    resolution: heatmaps bilinearly upsampled and averaged across outputs,
    tags taken from the first tag-bearing output (HigherHRNet's
    single-scale aggregation)."""
    outs = list(outs)
    k = num_joints
    if not isinstance(with_ae, (list, tuple)):
        with_ae = [o.shape[1] > k for o in outs]
    target = max(outs, key=lambda o: o.shape[2] * o.shape[3])
    size = tuple(target.shape[2:])

    def up(x):
        return x if tuple(x.shape[2:]) == size else resize_bilinear(x, size)

    hm = sum(up(o[:, :k]) for o in outs) / len(outs)
    for o, wa in zip(outs, with_ae):
        if wa and o.shape[1] > k:
            return torch.cat([hm, up(o[:, k:])], dim=1)
    return hm


def ae_forward_with_flip(apply_fn, imgs, num_joints, flip_index,
                         with_flip=True):
    """Run an AE model on NHWC `imgs` and their horizontal flip; average the
    heatmaps and stack the tags along L (reference aggregate_stage_flip for
    the single-stage case, bottom_up_eval.py:165).

    apply_fn(imgs) -> [N, K(+K), H, W]; `flip_index` a tensor on the
    images' device. Returns (heatmaps [N, K, H, W], tags [N, K, H, W, L]).
    """
    k = num_joints
    out = apply_fn(imgs)
    hm, tag = out[:, :k], out[:, k:]
    if not with_flip:
        return hm, tag[..., None]
    out_f = apply_fn(imgs.flip(2))                  # the W axis of NHWC
    hm_f = out_f[:, :k][:, flip_index].flip(-1)
    tag_f = out_f[:, k:]
    if tag_f.shape[1] == k:
        tag_f = tag_f[:, flip_index]
    # tag_per_joint=False: one shared tag map, no channel permutation
    tag_f = tag_f.flip(-1)
    return (hm + hm_f) * 0.5, torch.stack([tag, tag_f], dim=-1)


def get_group_preds(grouped_joints, center, scale, heatmap_size,
                    use_udp=False):
    """Grouped poses (heatmap coords) -> image coords (reference
    bottom_up_eval.py:293). grouped_joints: [P, K, 3+L] numpy.

    In UDP mode `scale` comes from resize_align_multi_scale(use_udp=True)
    and is the ORIGINAL image span in pixels (size-1 units): the mapping is
    a pure rescale by scale / (heatmap size - 1).
    """
    if len(grouped_joints) == 0:
        return []
    joints = np.asarray(grouped_joints, np.float32)
    coords = joints[..., :2]
    if use_udp:
        factor = (np.asarray(scale, np.float32)
                  / (np.asarray(heatmap_size, np.float32) - 1.0))
        out = coords.reshape(-1, 2) * factor
    else:
        out = transform_preds(coords.reshape(-1, 2),
                              np.asarray(center, np.float32),
                              np.asarray(scale, np.float32),
                              heatmap_size).numpy()
    joints = joints.copy()
    joints[..., :2] = out.reshape(coords.shape)
    return [joints[i] for i in range(joints.shape[0])]


class BottomUpEstimator(nn.Module):
    """Backbone + AE head + parser.

    `backbone` is an NCHW feature module with `out_channels` (HRNet,
    ResNet: fully convolutional, so the multi-scale protocol may feed it any
    size), or a ViTConfig / dict of one, which builds the plain ViT (fixed
    input size). `head` defaults to JAX's: an AEHead with one 256-wide
    deconv. Weights are drawn from `generator`. `backbone_type` names the
    backbone for the checkpoint converters ('vit' for a ViT).
    """

    def __init__(self, backbone, num_joints=17, tag_per_joint=True,
                 parser_cfg=None, dataset_info=None, head=None,
                 generator=None, backbone_type=None):
        super().__init__()
        if isinstance(backbone, nn.Module):
            self.backbone = backbone
            self.backbone_type = backbone_type or 'cnn'
            channels = backbone.out_channels
            dtype = getattr(getattr(backbone, 'cfg', None), 'dtype',
                            'float32')
        else:
            cfg = (backbone if isinstance(backbone, ViTConfig)
                   else ViTConfig(**backbone))
            self.backbone = ViT(cfg, generator)
            self.backbone_type = 'vit'
            channels, dtype = cfg.embed_dim, cfg.dtype
        self.keypoint_head = head or AEHead(
            channels, num_joints, tag_per_joint=tag_per_joint,
            deconv_filters=(256,), deconv_kernels=(4,), dtype=dtype,
            generator=generator)
        self.multi_stage = isinstance(self.keypoint_head, AEMultiStageHead)
        self.num_joints = num_joints
        self.parser = HeatmapParser(num_joints=num_joints,
                                    **(parser_cfg or {}))
        self.dataset_info = dataset_info

    @property
    def device(self):
        return next(self.parameters()).device

    def features(self, imgs):
        """[N, H, W, 3] -> the backbone's NCHW features: a multi-stage
        head's whole list, else the first of a list."""
        feat = self.backbone(imgs)
        if self.backbone_type == 'vit':
            return feat.permute(0, 3, 1, 2)
        if isinstance(feat, (list, tuple)) and not self.multi_stage:
            return feat[0]
        return feat

    def forward(self, imgs):
        """[N, H, W, 3] -> the head's outputs, a list of [N, C, h, w] f32
        maps (BN in training mode uses and updates the batch statistics)."""
        return [o.float() for o in self.keypoint_head(self.features(imgs))]

    def infer(self, imgs, flip_index, with_flip=True):
        """Eval forward with the flip pass, the last stage of a multi-stage
        head or the outputs of a multi-resolution head reduced to one map:
        (heatmaps [N, K, H, W], tags [N, K, H, W, L]) on the input's
        device. `flip_index` is a
        sequence or a tensor."""
        self.eval()
        fi = (flip_index.to(imgs.device)
              if isinstance(flip_index, torch.Tensor) else torch.as_tensor(
                  np.asarray(flip_index, np.int64), device=imgs.device))
        with_ae = getattr(self.keypoint_head, 'with_ae_loss', None)

        def apply(x):
            outs = self(x)
            if self.multi_stage:
                return outs[-1]
            return reduce_multires_output(outs, self.num_joints, with_ae)

        with torch.no_grad():
            return ae_forward_with_flip(apply, imgs, self.num_joints, fi,
                                        with_flip=with_flip)

    def parse(self, heatmaps, tags, center, scale, adjust=True, refine=True,
              use_udp=False):
        results, scores = self.parser.parse(heatmaps, tags, adjust=adjust,
                                            refine=refine)
        h, w = heatmaps.shape[-2:]
        preds = get_group_preds(results[0], center, scale, (w, h),
                                use_udp=use_udp)
        return preds, scores


# ---------------------------------------------------------------------------
# multi-stage / multi-scale aggregation (reference bottom_up_eval.py)
# ---------------------------------------------------------------------------

def split_ae_outputs(outputs, num_joints, with_heatmaps, with_ae,
                     select_output_index):
    """NCHW outputs -> (heatmap list, tag list)
    (reference bottom_up_eval.py:9)."""
    heatmaps, tags = [], []
    for i, out in enumerate(outputs):
        if i not in select_output_index:
            continue
        if with_heatmaps[i]:
            heatmaps.append(out[:, :num_joints])
        if with_ae[i]:
            off = num_joints if with_heatmaps[i] else 0
            tags.append(out[:, off:])
    return heatmaps, tags


def flip_feature_maps(feature_maps, flip_index=None):
    """Horizontal flip (+ channel permutation) of NCHW maps (reference
    bottom_up_eval.py:46). Indices past the channels are clamped, as JAX's
    gather clamps them (a shared tag map takes channel 0)."""
    out = []
    for fm in feature_maps:
        fm = fm.flip(-1)
        if flip_index is not None:
            idx = torch.as_tensor(np.asarray(flip_index, np.int64),
                                  device=fm.device)
            fm = fm[:, idx.clamp(max=fm.shape[1] - 1)]
        out.append(fm)
    return out


def _resize_nchw(fm, size_hw, align_corners):
    if tuple(fm.shape[2:]) == tuple(size_hw):
        return fm
    if align_corners:
        return resize_bilinear_ac(fm, size_hw)
    return resize_bilinear(fm, size_hw)


def _resize_list(feature_maps, align_corners, index=-1, resize_size=None):
    if resize_size is None:
        resize_size = feature_maps[index].shape[2:]
    return [_resize_nchw(fm, resize_size, align_corners)
            for fm in feature_maps]


def aggregate_stage_flip(feature_maps, feature_maps_flip, index=-1,
                         project2image=True, size_projected=None,
                         align_corners=False, aggregate_stage='concat',
                         aggregate_flip='average'):
    """reference bottom_up_eval.py:165: resize multi-stage maps to a base
    size, then average/concat the original and flipped passes."""
    if feature_maps_flip is None:
        aggregate_flip = 'none'
    size = ((size_projected[1], size_projected[0])
            if project2image and size_projected else None)

    def agg(maps):
        if maps is None:
            return None
        resized = _resize_list(maps, align_corners, index=index,
                               resize_size=size)
        if aggregate_stage == 'average':
            return [sum(resized[1:], resized[0]) / len(resized)]
        return resized                     # 'concat'

    origin = agg(feature_maps)
    flipped = agg(feature_maps_flip)
    if aggregate_flip == 'average':
        return [(o + f) / 2.0 for o, f in zip(origin, flipped)]
    if aggregate_flip == 'concat':
        return list(origin) + list(flipped)
    return list(origin)


def aggregate_scale(feature_maps_list, align_corners=False,
                    aggregate_scale_mode='average'):
    """reference bottom_up_eval.py:254: combine per-scale maps at the first
    scale's size: 'average' heatmaps or 'unsqueeze_concat' tags."""
    resized = _resize_list(feature_maps_list, align_corners, index=0)
    if aggregate_scale_mode == 'average':
        return sum(resized[1:], resized[0]) / len(resized)
    return torch.stack(resized, dim=-1)     # [N, K, H, W, L]

"""Top-down training input: host-side augmentation parameters, device-side
pixels and targets.

Counterpart of vitpose_tpu/data/pipeline.py:37-228. The host draws each
record's flip, half-body crop, scale and rotation (`sample_augmentations`,
numpy, the same draws as the JAX package from the same RandomState); the
device warps every crop in one batched gather, normalises it and paints the
UDP or MSRA heatmap targets (`make_preprocess_fn`, plain tensor code).

Geometry as in the reference: a flipped record mirrors its joints with
``W - 1 - x`` and its center with ``W - 1 - cx`` on the host
(top_down_transform.py:149-164), and the source pixel mirror is folded into
the warp matrix on the device; targets use the crop-space joints, i.e. the
unflipped warp applied to the mirrored joints.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.geometry import (affine_matrix, apply_affine_to_points,
                            udp_warp_matrix)
from ..ops.target import generate_msra_heatmaps, generate_udp_heatmaps
from ..ops.warp import warp_affine_batch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass
class AugmentConfig:
    flip_prob: float = 0.5
    half_body_prob: float = 0.3
    num_joints_half_body: int = 8
    scale_factor: float = 0.5
    rot_factor: float = 40.0
    rot_prob: float = 0.6
    shift_prob: float = 0.0          # TopDownRandomShiftBboxCenter
    shift_factor: float = 0.16
    trans_prob: float = 0.0          # TopDownRandomTranslation
    trans_factor: float = 0.15
    # image-level augs of the JAX loader; not ported, so setting one raises
    photometric: object = None
    coarse_dropout: object = None
    grid_dropout: object = None
    albumentations: object = None

    def __post_init__(self):
        if self.has_image_augs():
            raise NotImplementedError(
                'image-level augmentations (photometric, dropouts, '
                'albumentations) are not ported yet (ROADMAP.md queue 1 '
                'item 7)')

    def has_image_augs(self):
        return bool(self.photometric or self.coarse_dropout
                    or self.grid_dropout or self.albumentations)


def sample_augmentations(rng: np.random.RandomState, record, info, image_w,
                         aug: AugmentConfig, image_size):
    """Host side: draw one record's augmentation, mirroring the reference
    transforms' distributions. Returns (center, scale, rot, joints, vis,
    flipped); the record is not changed.

    The flip mirrors joints and center around the canvas width here; the
    source pixel mirror happens on the device, so the caller passes
    `flipped` on to the preprocess function.
    """
    joints = record['joints_3d'][:, :2].copy()
    vis = record['joints_3d_visible'][:, 0].copy()
    center = np.asarray(record['center'], np.float32).copy()
    scale = np.asarray(record['scale'], np.float32).copy()
    flipped = False

    if rng.rand() <= aug.flip_prob:
        flipped = True
        flip_index = info.flip_index
        joints = joints[flip_index]
        vis = vis[flip_index]
        joints[:, 0] = image_w - 1 - joints[:, 0]
        joints *= vis[:, None]
        center[0] = image_w - center[0] - 1

    # half-body (reference top_down_transform.py:176)
    if (vis.sum() > aug.num_joints_half_body
            and rng.rand() < aug.half_body_prob):
        upper = [j for j in info.upper_body_ids if vis[j] > 0]
        lower = [j for j in range(info.num_joints)
                 if j not in info.upper_body_ids and vis[j] > 0]
        if rng.randn() < 0.5 and len(upper) > 2:
            sel = upper
        elif len(lower) > 2:
            sel = lower
        else:
            sel = upper
        if len(sel) >= 2:
            pts = joints[sel]
            c = pts.mean(axis=0)
            lt, rb = pts.min(axis=0), pts.max(axis=0)
            w, h = rb[0] - lt[0], rb[1] - lt[1]
            ar = image_size[0] / image_size[1]
            if w > ar * h:
                h = w / ar
            elif w < ar * h:
                w = h * ar
            center = c.astype(np.float32)
            scale = np.array([w / 200.0, h / 200.0], np.float32) * 1.5

    if aug.shift_prob > 0 and rng.rand() < aug.shift_prob:
        center = center + rng.uniform(-1, 1, 2) * aug.shift_factor \
            * scale * 200.0

    # TopDownRandomTranslation (reference top_down_transform.py:816)
    if aug.trans_prob > 0 and rng.rand() <= aug.trans_prob:
        center = center + aug.trans_factor * rng.uniform(-1, 1, 2) \
            * scale * 200.0

    sf, rf = aug.scale_factor, aug.rot_factor
    scale = scale * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
    rot = np.clip(rng.randn() * rf, -rf * 2, rf * 2) \
        if rng.rand() <= aug.rot_prob else 0.0

    return (center.astype(np.float32), scale.astype(np.float32),
            np.float32(rot), joints.astype(np.float32),
            vis.astype(np.float32), flipped)


def make_preprocess_fn(image_size=(192, 256), heatmap_size=(48, 64),
                       use_udp=True, sigma=2.0, with_targets=True,
                       unbiased=False, pad_num_joints=None,
                       target_type='GaussianHeatmap'):
    """Build the device-side preprocessing function.

    fn(imgs_uint8 [N, H, W, 3], center [N, 2], scale [N, 2], rot [N],
       joints [N, K, 2], vis [N, K], flip [N] bool or None) ->
       dict(imgs [N, h, w, 3] normalised, target [N, K, hh, hw],
            target_weight [N, K])

    All on the inputs' device (the canvases share one shape). For a sample
    with `flip` set, the source mirror F = [[-1, 0, W-1], [0, 1, 0]] is
    composed on the right of its pixel warp, so the crop matches the labels
    that sample_augmentations mirrored, at any rotation and with no pixel
    copy.
    """
    if target_type.lower() != 'gaussianheatmap':
        raise NotImplementedError(f'target_type {target_type!r}: only '
                                  'GaussianHeatmap targets are ported '
                                  '(ROADMAP.md queue 1 item 7)')
    if pad_num_joints is not None:
        raise NotImplementedError('pad_num_joints (ViTPose+ MoE) is not '
                                  'ported yet (ROADMAP.md queue 1 item 10)')
    iw, ih = int(image_size[0]), int(image_size[1])
    norm = {}                        # device -> (mean, std), copied once

    def preprocess(imgs, center, scale, rot, joints, vis, flip=None):
        dev = imgs.device
        if dev not in norm:
            norm[dev] = (torch.as_tensor(IMAGENET_MEAN, device=dev),
                         torch.as_tensor(IMAGENET_STD, device=dev))
        mean, std = norm[dev]
        imgs = imgs.float() / 255.0
        if use_udp:
            mat = udp_warp_matrix(rot, center, scale, (iw, ih))
        else:
            mat = affine_matrix(center, scale, rot, (iw, ih))
        mat_pix = mat
        if flip is not None:
            col0 = mat[..., :, 0]
            flipped = torch.stack([-col0, mat[..., :, 1],
                                   mat[..., :, 2] + (imgs.shape[2] - 1) * col0],
                                  dim=-1)
            mat_pix = torch.where(flip.bool()[:, None, None], flipped, mat)
        crops = (warp_affine_batch(imgs, mat_pix, (iw, ih)) - mean) / std
        out = {'imgs': crops}
        if with_targets:
            joints_c = apply_affine_to_points(joints, mat)
            if use_udp:
                target, weight = generate_udp_heatmaps(
                    joints_c, vis, (iw, ih), heatmap_size, sigma=sigma)
            else:
                target, weight = generate_msra_heatmaps(
                    joints_c, vis, (iw, ih), heatmap_size, sigma=sigma,
                    unbiased=unbiased)
            out['target'] = target
            out['target_weight'] = weight
        return out

    return preprocess

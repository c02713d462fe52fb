"""Top-down training input: host-side augmentation parameters, device-side
pixels and targets.

Counterpart of vitpose_tpu/data/pipeline.py:37-228 and :293-418. The host
draws each record's flip, half-body crop, scale and rotation
(`sample_augmentations`, numpy, the same draws as the JAX package from the
same RandomState), and runs the image-level augmentations on the record's
canvas (`apply_image_augmentations`: photometric distortion, coarse and
grid dropout; cv2 and numpy); the device warps every crop in one batched
gather, normalises it and paints the targets: UDP or MSRA heatmaps,
CombinedTarget maps, or DeepPose's normalised coordinates
(`make_preprocess_fn`, plain tensor code).

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
import torch.nn.functional as F

from ..ops.geometry import (affine_matrix, apply_affine_to_points,
                            udp_warp_matrix)
from ..ops.target import (generate_combined_target, generate_msra_heatmaps,
                          generate_udp_heatmaps)
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
    # image-level augmentations, run by the loader on the host canvas before
    # the warp (JAX's order): True, or a dict of the function's arguments;
    # the albumentations path needs a package neither machine has
    photometric: object = None
    coarse_dropout: object = None
    grid_dropout: object = None
    albumentations: object = None

    def __post_init__(self):
        if self.albumentations:
            raise NotImplementedError(
                'the albumentations transform needs the `albumentations` '
                'package, which is not installed (ROADMAP.md "Not queued"); '
                'photometric, coarse_dropout and grid_dropout are native')

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

    `target_type` 'CombinedTarget' gives target [N, 3K, hh, hw];
    'Regression' target [N, K, 2] (crop coordinates over the crop size)
    and target_weight [N, K, 2].

    With `pad_num_joints`, target and target_weight are padded with zeros
    to that many joints (ViTPose+).

    All on the inputs' device (the canvases share one shape). For a sample
    with `flip` set, the source mirror F = [[-1, 0, W-1], [0, 1, 0]] is
    composed on the right of its pixel warp, so the crop matches the labels
    that sample_augmentations mirrored, at any rotation and with no pixel
    copy.
    """
    iw, ih = int(image_size[0]), int(image_size[1])
    kind = target_type.lower()
    if pad_num_joints is not None and kind == 'regression':
        raise ValueError('pad_num_joints (ViTPose+ MoE padding) expects '
                         'heatmap targets, not Regression coordinates')
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
            if kind == 'regression':
                # DeepPose: coordinates normalised to the crop, weight 0 for
                # joints outside it (reference top_down_transform.py:761)
                size = torch.tensor([iw, ih], dtype=torch.float32,
                                    device=dev)
                inside = ((joints_c[..., 0] >= 0)
                          & (joints_c[..., 0] <= iw - 1)
                          & (joints_c[..., 1] >= 0)
                          & (joints_c[..., 1] <= ih - 1))
                target = joints_c / size
                weight = (vis.float() * inside.float())[..., None] \
                    .expand(*vis.shape, 2).contiguous()
            elif kind == 'combinedtarget':
                # [N, K, 3, H, W] laid out as 3K channels
                t, weight = generate_combined_target(
                    joints_c, vis, (iw, ih), heatmap_size)
                target = t.reshape(t.shape[0], -1, *t.shape[-2:])
            elif use_udp:
                target, weight = generate_udp_heatmaps(
                    joints_c, vis, (iw, ih), heatmap_size, sigma=sigma)
            else:
                target, weight = generate_msra_heatmaps(
                    joints_c, vis, (iw, ih), heatmap_size, sigma=sigma,
                    unbiased=unbiased)
            pad = 0 if pad_num_joints is None \
                else int(pad_num_joints) - target.shape[1]
            if pad > 0:
                # ViTPose+ pads every dataset's targets to max_num_joints,
                # so one step serves the mixture (reference
                # top_down_transform.py:746-755)
                target = F.pad(target, (0, 0, 0, 0, 0, pad))
                weight = F.pad(weight, (0, pad))
            out['target'] = target
            out['target_weight'] = weight
        return out

    return preprocess


# --- image-level augmentations (vitpose_tpu/data/pipeline.py:293-418) -------

def photometric_distortion(rng: np.random.RandomState, img,
                           brightness_delta=32, contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5), hue_delta=18):
    """Random brightness, contrast (before or after the colour changes),
    saturation and hue (through uint8 HSV, only where one of them fires)
    and channel order of a uint8 RGB image, drawn from `rng` in JAX's
    order, the gates of the branches that do not fire included (reference
    shared_transform.py:303 `PhotometricDistortion`)."""
    import cv2
    img = img.astype(np.float32)
    if rng.randint(2):
        img += rng.uniform(-brightness_delta, brightness_delta)
    contrast_last = rng.randint(2)
    if not contrast_last and rng.randint(2):
        img *= rng.uniform(*contrast_range)
    sat_gate = rng.randint(2)
    sat_mult = rng.uniform(*saturation_range) if sat_gate else None
    hue_gate = rng.randint(2)
    hue_shift = rng.uniform(-hue_delta, hue_delta) if hue_gate else None
    if sat_gate or hue_gate:
        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_RGB2HSV).astype(np.float32)
        if sat_gate:
            hsv[..., 1] *= sat_mult
        if hue_gate:
            hsv[..., 0] = (hsv[..., 0] + hue_shift) % 180
        img = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                           cv2.COLOR_HSV2RGB).astype(np.float32)
    if contrast_last and rng.randint(2):
        img *= rng.uniform(*contrast_range)
    if rng.randint(2):
        img = img[..., rng.permutation(3)]
    return np.clip(img, 0, 255).astype(np.uint8)


def coarse_dropout(rng: np.random.RandomState, img, max_holes=8,
                   max_height=40, max_width=40, min_holes=1, min_height=10,
                   min_width=10, p=0.5, fill_value=0):
    """With probability `p`, between min_holes and max_holes random
    rectangles of the image set to `fill_value` (Albumentations'
    CoarseDropout, which hrnet_w32_coco_256x192_coarsedropout.py uses)."""
    if rng.rand() >= p:
        return img
    img = img.copy()
    h, w = img.shape[:2]
    for _ in range(rng.randint(min_holes, max_holes + 1)):
        hh = rng.randint(min_height, max_height + 1)
        ww = rng.randint(min_width, max_width + 1)
        y = rng.randint(0, max(1, h - hh + 1))
        x = rng.randint(0, max(1, w - ww + 1))
        img[y:y + hh, x:x + ww] = fill_value
    return img


def grid_dropout(rng: np.random.RandomState, img, unit_size_min=10,
                 unit_size_max=40, ratio=0.5, random_offset=True, p=0.5,
                 fill_value=0):
    """With probability `p`, a square grid of `unit`-sized cells, each with
    a hole of `ratio * unit` at its corner (Albumentations' GridDropout,
    which hrnet_w32_coco_256x192_gridmask.py uses)."""
    if rng.rand() >= p:
        return img
    img = img.copy()
    h, w = img.shape[:2]
    unit = int(rng.randint(unit_size_min, unit_size_max + 1))
    hole = max(1, int(unit * ratio))
    oy = int(rng.randint(0, unit)) if random_offset else 0
    ox = int(rng.randint(0, unit)) if random_offset else 0
    for y in range(-oy, h, unit):
        for x in range(-ox, w, unit):
            img[max(0, y):max(0, y + hole),
                max(0, x):max(0, x + hole)] = fill_value
    return img


def apply_image_augmentations(rng: np.random.RandomState, img,
                              aug: AugmentConfig):
    """The configured image-level augmentations of `aug` in JAX's order
    (photometric, coarse dropout, grid dropout), each given its dict of
    arguments or its defaults (True)."""
    for enabled, fn in ((aug.photometric, photometric_distortion),
                        (aug.coarse_dropout, coarse_dropout),
                        (aug.grid_dropout, grid_dropout)):
        if enabled:
            img = fn(rng, img, **(enabled if isinstance(enabled, dict)
                                  else {}))
    return img

"""Bottom-up COCO dataset, targets and augmentation for associative
embedding, on the host in numpy and cv2.

The port's own copy of vitpose_tpu/data/bottomup.py (the reference
mmpose/datasets/datasets/bottom_up/bottom_up_coco.py and
mmpose/datasets/pipelines/bottom_up_transform.py): image-level records with
every person's joints, a loss mask that zeroes crowd regions and people
without keypoints, per-output-scale heatmap and AE-joint targets (and the
PAF targets of the reference pipeline), the test-time multi-scale sizing,
and the training affine and flip with the same numpy draws. Evaluation goes
through the port's `eval/cocoeval.py`. Targets are numpy arrays; the AE
joint indices are padded to [max_people, K, 2] for the loss
(models/losses.py `ae_tag_loss`).
"""
from __future__ import annotations

import os

import numpy as np

from .coco_index import CocoIndex
from .dataset_info import DatasetInfo
from .mask import segmentation_to_mask


def read_rgb(path):
    """The RGB array of the image file at `path` (cv2); raises if cv2
    cannot read it."""
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f'cv2 cannot read the image {path!r}')
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


class BottomUpCocoDataset:
    """Image-level COCO records for bottom-up training/eval."""

    def __init__(self, ann_file, img_prefix, dataset_info='coco',
                 input_size=512, output_sizes=(128,), max_people=30,
                 test_mode=False):
        self.info = (dataset_info if isinstance(dataset_info, DatasetInfo)
                     else DatasetInfo.load(dataset_info))
        self.coco = CocoIndex(ann_file)
        self.img_prefix = img_prefix
        self.input_size = input_size
        self.output_sizes = tuple(output_sizes)
        self.max_people = max_people
        self.test_mode = test_mode
        self.img_ids = [i for i in self.coco.getImgIds()
                        if test_mode or len(self.coco.getAnnIds(
                            imgIds=i, iscrowd=None)) > 0]

    def __len__(self):
        return len(self.img_ids)

    def record(self, idx):
        """-> dict(image_file, joints [M, K, 3], mask_info for loss mask)."""
        img_id = self.img_ids[idx]
        img = self.coco.imgs[img_id]
        anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))
        k = self.info.num_joints
        joints = np.zeros((self.max_people, k, 3), np.float32)
        m = 0
        mask_anns = []
        for ann in anns:
            if ann.get('iscrowd', 0) or ann.get('num_keypoints', 0) == 0:
                mask_anns.append(ann)                 # masked out of loss
                continue
            if m >= self.max_people:
                continue
            kp = np.asarray(ann['keypoints'], np.float32).reshape(k, 3)
            joints[m, :, :2] = kp[:, :2]
            joints[m, :, 2] = (kp[:, 2] > 0).astype(np.float32)
            m += 1
        return dict(
            image_file=os.path.join(self.img_prefix, img['file_name']),
            image_id=img_id, width=img['width'], height=img['height'],
            joints=joints, num_people=m, mask_anns=mask_anns)

    def build_loss_mask(self, rec):
        """[h, w] float mask: 1 everywhere except crowd/unannotated
        regions (parity: bottom_up datasets' `_get_mask`)."""
        mask = np.ones((rec['height'], rec['width']), np.float32)
        for ann in rec['mask_anns']:
            if 'segmentation' in ann and ann['segmentation']:
                m = segmentation_to_mask(ann['segmentation'],
                                         rec['height'], rec['width'])
                mask[m > 0] = 0.0
        return mask

    # ------------------------------------------------------------------
    # evaluation (reference bottom_up_coco.py:143 `evaluate`)
    # ------------------------------------------------------------------
    def evaluate(self, results, res_folder=None, metric='mAP',
                 use_nms=False, soft_nms=False, oks_thr=0.9):
        """COCO OKS mAP over grouped bottom-up predictions.

        results: list of dicts with
          preds: list over people of [K, 3+] arrays (x, y, score[, tag]),
          scores: list of per-person scores,
          image_paths: [str] (first entry names the image).

        Person area is the keypoint bounding box (reference
        bottom_up_coco.py:200); use_nms defaults off like the reference's
        test_cfg default.
        """
        import json as _json
        from collections import OrderedDict
        metrics = metric if isinstance(metric, (list, tuple)) else [metric]
        for m in metrics:
            if m != 'mAP':
                raise KeyError(f'metric {m} is not supported')

        from ..ops.nms import oks_nms, soft_oks_nms
        from ..eval.cocoeval import CocoKeypointEval

        name2id = {os.path.basename(img['file_name']): iid
                   for iid, img in self.coco.imgs.items()}
        detections = []
        for result in results:
            image_id = name2id[os.path.basename(result['image_paths'][0])]
            people = []
            for kpt, score in zip(result['preds'], result['scores']):
                kpt = np.asarray(kpt, np.float64)
                area = ((kpt[:, 0].max() - kpt[:, 0].min())
                        * (kpt[:, 1].max() - kpt[:, 1].min()))
                people.append(dict(keypoints=kpt[:, :3], area=area,
                                   score=float(score)))
            if use_nms and people:
                nms = soft_oks_nms if soft_nms else oks_nms
                keep = nms(people, oks_thr, sigmas=self.info.sigmas)
                people = [people[i] for i in keep]
            for p in people:
                detections.append(dict(
                    image_id=int(image_id), category_id=1,
                    keypoints=np.asarray(
                        p['keypoints']).flatten().tolist(),
                    score=p['score']))
        if res_folder is not None:
            os.makedirs(res_folder, exist_ok=True)
            with open(os.path.join(res_folder,
                                   'result_keypoints.json'), 'w') as f:
                _json.dump(detections, f)
        if 'annotations' not in self.coco.dataset:
            return OrderedDict()
        coco_dt = self.coco.loadRes(detections)
        if self.info.dataset_name == 'crowdpose':
            # reference BottomUpCrowdPoseDataset: iouType
            # 'keypoints_crowd' (no-area OKS + easy/medium/hard AP)
            from ..eval.cocoeval import evaluate_crowdpose
            return OrderedDict(evaluate_crowdpose(
                self.coco, coco_dt, sigmas=self.info.sigmas))
        # bottom-up AIC/MHP also evaluate with use_area=False
        # (reference bottom_up_aic.py / bottom_up_mhp.py)
        evaluator = CocoKeypointEval(
            self.coco, sigmas=self.info.sigmas,
            use_area=self.info.dataset_name not in ('aic', 'mhp'))
        return OrderedDict(evaluator.evaluate(coco_dt))


def generate_ae_targets(joints, mask, input_size, output_size, sigma=2.0,
                        max_people=30, use_udp=False):
    """Build one output scale's training targets.

    Args:
      joints: [M, K, 3] in input-image pixels; mask [h, w] input-res.
      input_size, output_size: ints (square, reference convention).
      use_udp: UDP joint scaling ((S-1)/(in-1)) + continuous sub-pixel
        gaussian centers (reference HeatmapGenerator(use_udp=True)).

    Returns dict(heatmaps [K, S, S], mask [S, S], ae_joints [M, K, 2]
    int32: flat pixel index + visibility for ae_tag_loss), numpy.
    """
    import cv2

    if use_udp:
        ratio = (output_size - 1.0) / (input_size - 1.0)
    else:
        ratio = output_size / input_size
    scaled = np.concatenate([joints[:, :, :2] * ratio, joints[:, :, 2:3]],
                            axis=-1)
    vis = joints[:, :, 2]

    # the reference bottom-up painter (HeatmapGenerator, truncated-int or
    # UDP-continuous centers, max over people)
    heatmaps = generate_heatmap_targets(scaled, output_size, sigma=sigma,
                                        use_udp=use_udp)

    mask_s = cv2.resize(mask, (output_size, output_size),
                        interpolation=cv2.INTER_LINEAR)
    mask_s = (mask_s > 0.5).astype(np.float32)

    # JointsEncoder (bottom_up_transform.py:255): truncated-int indices
    xi = np.trunc(scaled[..., 0]).astype(np.int64)
    yi = np.trunc(scaled[..., 1]).astype(np.int64)
    inside = ((xi >= 0) & (xi < output_size)
              & (yi >= 0) & (yi < output_size))
    ae = np.zeros(joints.shape[:2] + (2,), np.int32)
    ae[..., 0] = (np.clip(yi, 0, output_size - 1) * output_size
                  + np.clip(xi, 0, output_size - 1))
    ae[..., 1] = ((vis > 0) & inside).astype(np.int32)
    return dict(heatmaps=heatmaps, mask=mask_s, ae_joints=ae)


def generate_paf_targets(joints, output_size, limb_width, skeleton):
    """Part-affinity-field targets for one output scale (reference
    bottom_up_transform.py:268 `PAFGenerator` / :663
    `BottomUpGeneratePAFTarget`; Cao et al., CVPR, 2017).

    Args:
      joints: [P, K, 3] per-person joints in OUTPUT-map pixels (x, y, vis).
      output_size: (w, h) of the PAF map (int means square).
      limb_width: half-width of the affinity band in output pixels.
      skeleton: list of (src_joint, dst_joint) index pairs.

    Returns [2*L, h, w] float32 — per limb an (x, y) unit-vector field
    averaged over the persons whose band covers each pixel.

    Matches the reference exactly, including its conventions: the band is
    bounded by the floor/ceil bbox window around the segment (so the
    perpendicular-distance test is only applied inside that window), a
    zero-length limb contributes a zero vector but still increments the
    normalization count, and accumulated vectors are divided by
    max(count, 1).
    """
    if np.isscalar(output_size):
        output_size = (int(output_size), int(output_size))
    w, h = int(output_size[0]), int(output_size[1])
    joints = np.asarray(joints, np.float32)
    pafs = np.zeros((len(skeleton) * 2, h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for idx, (a, b) in enumerate(skeleton):
        count = np.zeros((h, w), np.float32)
        for p in joints:
            src, dst = p[a], p[b]
            if src[2] <= 0 or dst[2] <= 0:
                continue
            limb = dst[:2] - src[:2]
            norm = float(np.linalg.norm(limb))
            unit = limb / norm if norm > 0 else np.zeros(2, np.float32)
            min_x = max(np.floor(min(src[0], dst[0]) - limb_width), 0)
            max_x = min(np.ceil(max(src[0], dst[0]) + limb_width), w - 1)
            min_y = max(np.floor(min(src[1], dst[1]) - limb_width), 0)
            max_y = min(np.ceil(max(src[1], dst[1]) + limb_width), h - 1)
            if int(max_x) < int(min_x) or int(max_y) < int(min_y):
                continue
            dist = np.abs((xs - src[0]) * unit[1] - (ys - src[1]) * unit[0])
            mask = ((xs >= int(min_x)) & (xs <= int(max_x))
                    & (ys >= int(min_y)) & (ys <= int(max_y))
                    & (dist < limb_width))
            pafs[2 * idx] += mask * unit[0]
            pafs[2 * idx + 1] += mask * unit[1]
            count += mask
        pafs[2 * idx:2 * idx + 2] /= np.maximum(count, 1)
    return pafs


def generate_paf_targets_multiscale(joints_list, output_sizes, limb_width,
                                    skeleton):
    """Multi-scale PAF targets (reference BottomUpGeneratePAFTarget.__call__):
    one [2*L, h_s, w_s] map per scale, `joints_list[s]` already in that
    scale's output coordinates (the bottom-up pipeline keeps per-scale
    joint copies)."""
    return [generate_paf_targets(j, s, limb_width, skeleton)
            for j, s in zip(joints_list, output_sizes)]


def generate_heatmap_targets(joints, output_size, sigma=-1.0, use_udp=False):
    """One scale of bottom-up gaussian heatmap targets (reference
    bottom_up_transform.py:134 `HeatmapGenerator`): per visible joint a
    gaussian patch, max-accumulated over people.

    Args:
      joints: [P, K, 3] per-person joints in OUTPUT-map pixels (x, y, vis).
      output_size: (w, h) of the heatmap (int means square).
      sigma: gaussian std-dev; < 0 derives the reference default
        sqrt(w*h)/64.
      use_udp: paint at the continuous sub-pixel center instead of the
        truncated-integer one (unbiased data processing).

    Returns [K, h, w] float32.

    Matches the reference conventions exactly: joints whose truncated
    integer coordinates fall outside the map are skipped entirely, the
    gaussian is only painted inside the rounded [x-3s-1, x+3s+2) window,
    and in the biased mode the gaussian is centered on the truncated
    integer pixel.
    """
    if np.isscalar(output_size):
        output_size = (int(output_size), int(output_size))
    w, h = int(output_size[0]), int(output_size[1])
    if sigma is None or sigma < 0:
        sigma = np.sqrt(w * h) / 64.0
    joints = np.asarray(joints, np.float32)
    p, k = joints.shape[:2]
    if p == 0:
        return np.zeros((k, h, w), np.float32)

    xt = np.trunc(joints[..., 0]).astype(np.int64)    # [P, K] int centers
    yt = np.trunc(joints[..., 1]).astype(np.int64)
    valid = ((joints[..., 2] > 0) & (xt >= 0) & (yt >= 0)
             & (xt < w) & (yt < h))

    # window bounds (reference ul/br); the gaussian lookup index i maps to
    # pixel ul + i, and g[i] = exp(-((i - (3s+1) [- frac]))^2 / 2s^2), so
    # the effective continuous center is ul + 3s + 1 (+ fractional part in
    # UDP mode)
    u = 3.0 * sigma + 1.0
    ulx = np.round(xt - u).astype(np.int64)
    uly = np.round(yt - u).astype(np.int64)
    brx = np.round(xt + u + 1.0).astype(np.int64)
    bry = np.round(yt + u + 1.0).astype(np.int64)
    glen = len(np.arange(0.0, 6.0 * sigma + 3.0))
    cx = ulx + u + (joints[..., 0] - xt if use_udp else 0.0)
    cy = uly + u + (joints[..., 1] - yt if use_udp else 0.0)

    xs = np.arange(w, dtype=np.float32)
    ys = np.arange(h, dtype=np.float32)
    gx = np.exp(-(xs - cx[..., None]) ** 2 / (2.0 * sigma ** 2))  # [P,K,W]
    gy = np.exp(-(ys - cy[..., None]) ** 2 / (2.0 * sigma ** 2))  # [P,K,H]
    ix = xs[None, None] - ulx[..., None]              # gaussian index per px
    iy = ys[None, None] - uly[..., None]
    gx = np.where((ix >= 0) & (ix < glen)
                  & (xs[None, None] < brx[..., None]), gx, 0.0)
    gy = np.where((iy >= 0) & (iy < glen)
                  & (ys[None, None] < bry[..., None]), gy, 0.0)
    # JAX takes the max over every person of gy x gx x valid, [P, K, H, W]
    # in f64; the products are >= 0, so the max over the valid (person,
    # joint) pairs alone, from zeros, is the same value, without painting
    # the padded people
    out = np.zeros((k, h, w))
    for pi, ki in zip(*np.nonzero(valid)):
        np.maximum(out[ki], np.outer(gy[pi, ki], gx[pi, ki]), out=out[ki])
    return out.astype(np.float32)


def generate_heatmap_targets_multiscale(joints_list, output_sizes,
                                        sigma=-1.0, use_udp=False):
    """Multi-scale heatmap-only targets (reference bottom_up_transform.py:572
    `BottomUpGenerateHeatmapTarget`): the AE pipeline's gaussian targets
    without tag supervision — one [K, h_s, w_s] map per scale,
    `joints_list[s]` already in that scale's output coordinates."""
    return [generate_heatmap_targets(j, s, sigma=sigma, use_udp=use_udp)
            for j, s in zip(joints_list, output_sizes)]


# ---------------------------------------------------------------------------
# test-time multi-scale input sizing (reference bottom_up_transform.py:16-131)
# ---------------------------------------------------------------------------

def _ceil_to_multiples_of(x, base=64):
    return int(np.ceil(x / base) * base)


def get_multi_scale_size(image, input_size, current_scale, min_scale,
                         use_udp=False):
    """Resized (w, h), center, and scale for one test scale (reference
    `_get_multi_scale_size`): the short side lands on a multiple of 64 of
    `min_scale * input_size`, the long side keeps aspect (ceil to 64)."""
    h, w = image.shape[:2]
    min_input_w = _ceil_to_multiples_of(min_scale * input_size[0], 64)
    min_input_h = _ceil_to_multiples_of(min_scale * input_size[1], 64)
    if w < h:
        w_resized = int(min_input_w * current_scale / min_scale)
        h_resized = int(_ceil_to_multiples_of(min_input_w / w * h, 64)
                        * current_scale / min_scale)
        if use_udp:
            scale_w = w - 1.0
            scale_h = (h_resized - 1.0) / (w_resized - 1.0) * (w - 1.0)
        else:
            scale_w = w / 200.0
            scale_h = h_resized / w_resized * w / 200.0
    else:
        h_resized = int(min_input_h * current_scale / min_scale)
        w_resized = int(_ceil_to_multiples_of(min_input_h / h * w, 64)
                        * current_scale / min_scale)
        if use_udp:
            scale_h = h - 1.0
            scale_w = (w_resized - 1.0) / (h_resized - 1.0) * (h - 1.0)
        else:
            scale_h = h / 200.0
            scale_w = w_resized / h_resized * h / 200.0
    if use_udp:
        center = np.array([scale_w / 2.0, scale_h / 2.0], np.float32)
    else:
        center = np.array([round(w / 2.0), round(h / 2.0)], np.float32)
    return (w_resized, h_resized), center, np.array([scale_w, scale_h],
                                                    np.float32)


def _udp_raw_warp_matrix(theta, size_input, size_dst, size_target):
    """reference post_transforms.py:312 `get_warp_matrix` (numpy)."""
    import math
    theta = np.deg2rad(theta)
    m = np.zeros((2, 3), np.float32)
    sx = size_dst[0] / size_target[0]
    sy = size_dst[1] / size_target[1]
    m[0, 0] = math.cos(theta) * sx
    m[0, 1] = -math.sin(theta) * sx
    m[0, 2] = sx * (-0.5 * size_input[0] * math.cos(theta)
                    + 0.5 * size_input[1] * math.sin(theta)
                    + 0.5 * size_target[0])
    m[1, 0] = math.sin(theta) * sy
    m[1, 1] = math.cos(theta) * sy
    m[1, 2] = sy * (-0.5 * size_input[0] * math.sin(theta)
                    - 0.5 * size_input[1] * math.cos(theta)
                    + 0.5 * size_target[1])
    return m


def resize_align_multi_scale(image, input_size, current_scale, min_scale,
                             use_udp=False):
    """Test-time resize for bottom-up inference, plain or UDP (reference
    `_resize_align_multi_scale(_udp)`). Returns (resized, center, scale)
    where (center, scale) feed get_group_preds with the same use_udp."""
    import cv2
    from ..ops.geometry import affine_matrix
    if use_udp:
        size_resized, _, _ = get_multi_scale_size(
            image, input_size, current_scale, min_scale, True)
        _, center, scale = get_multi_scale_size(
            image, input_size, min_scale, min_scale, True)
        trans = _udp_raw_warp_matrix(
            0.0, np.array(scale, np.float32),
            np.array(size_resized, np.float32) - 1.0,
            np.array(scale, np.float32))
        resized = cv2.warpAffine(image.copy(), trans, size_resized,
                                 flags=cv2.INTER_LINEAR)
    else:
        size_resized, center, scale = get_multi_scale_size(
            image, input_size, current_scale, min_scale)
        trans = affine_matrix(center[None], scale[None], np.zeros(1),
                              size_resized)[0].numpy()
        resized = cv2.warpAffine(image, trans, size_resized)
    return resized, center, scale


# ---------------------------------------------------------------------------
# train-time augmentation (reference bottom_up_transform.py:360-569:
# BottomUpRandomAffine + BottomUpRandomFlip)
# ---------------------------------------------------------------------------

def _pad_scale(image_wh, resized_wh, scale_type):
    """reference BottomUpRandomAffine._get_scale (bottom_up_transform.py:426):
    the source window (w_pad, h_pad) whose aspect matches the destination;
    'short' fits the short image side, 'long' the long one."""
    w, h = float(image_wh[0]), float(image_wh[1])
    wr, hr = float(resized_wh[0]), float(resized_wh[1])
    if w / wr < h / hr:
        if scale_type == 'long':
            return np.array([h / hr * wr, h], np.float32)
        if scale_type == 'short':
            return np.array([w, w / wr * hr], np.float32)
    else:
        if scale_type == 'long':
            return np.array([w, w / wr * hr], np.float32)
        if scale_type == 'short':
            return np.array([h / hr * wr, h], np.float32)
    raise ValueError(f'Unknown scale type: {scale_type}')


def bottomup_random_affine(img, mask, joints, input_size, output_sizes, rng,
                           rot_factor=30.0, scale_factor=(0.75, 1.5),
                           scale_type='short', trans_factor=40,
                           use_udp=False):
    """Reference `BottomUpRandomAffine` (bottom_up_transform.py:401): random
    rotation in [-rot_factor, rot_factor], random zoom in scale_factor
    (relative to the scale_type side), random center translation, applied
    to the whole image AND separately to every output scale's joints/mask
    (so per-scale targets are painted, never resized).

    Args:
      img: [H, W, 3] uint8; mask [H, W] float; joints [P, K, 3(+1)] pixels.
      input_size: int (square input canvas S).
      output_sizes: sequence of ints (square heatmap sizes per scale).
      rng: np.random.RandomState — draws happen in the reference's order
        (scale, rot, dx, dy) so goldens can replay them.

    Returns (img_warped [S, S, 3], masks_per_scale, joints_per_scale,
    aug_scale). When joints carry a 4th (scale-aware sigma) column, it is
    divided by aug_scale exactly like the reference (:519,:553)."""
    import cv2
    from ..ops.geometry import affine_matrix

    height, width = img.shape[:2]
    if use_udp:
        center = np.array([(width - 1.0) / 2, (height - 1.0) / 2])
    else:
        center = np.array([width / 2.0, height / 2.0])
    img_scale = np.array([width, height], np.float32)
    aug_scale = rng.random_sample() * (scale_factor[1] - scale_factor[0]) \
        + scale_factor[0]
    img_scale = img_scale * aug_scale
    aug_rot = (rng.random_sample() * 2 - 1) * rot_factor
    if trans_factor > 0:
        dx = rng.randint(-trans_factor * img_scale[0] / 200.0,
                         trans_factor * img_scale[0] / 200.0)
        dy = rng.randint(-trans_factor * img_scale[1] / 200.0,
                         trans_factor * img_scale[1] / 200.0)
        center = center + np.array([dx, dy], np.float64)

    in_wh = (int(input_size), int(input_size))
    masks_out, joints_out = [], []
    for i, out_size in enumerate(output_sizes):
        out_wh = (int(out_size), int(out_size))
        scale = _pad_scale(img_scale, out_wh, scale_type)
        if use_udp:
            trans = _udp_raw_warp_matrix(
                aug_rot, center * 2.0,
                np.array(out_wh, np.float32) - 1.0, scale)
        else:
            trans = affine_matrix(
                center[None].astype(np.float32),
                (scale / 200.0)[None], np.array([aug_rot], np.float32),
                out_wh)[0].numpy()
        # both reference branches resolve to INTER_LINEAR (the non-UDP one
        # via cv2's default flags) followed by the 0.5 binarization
        m = cv2.warpAffine((mask[i] * 255).astype(np.uint8), trans, out_wh,
                           flags=cv2.INTER_LINEAR) / 255
        m = (m > 0.5).astype(np.float32)
        j = joints[i].copy()
        if j.size:
            pts = j[:, :, :2]
            ones = np.ones(pts.shape[:2] + (1,), np.float32)
            j[:, :, :2] = np.concatenate([pts, ones], axis=2) @ trans.T
            if j.shape[-1] > 3:
                j[:, :, 3] = j[:, :, 3] / aug_scale
        masks_out.append(m)
        joints_out.append(j)

    scale = _pad_scale(img_scale, in_wh, scale_type)
    if use_udp:
        mat_input = _udp_raw_warp_matrix(
            aug_rot, center * 2.0,
            np.array(in_wh, np.float32) - 1.0, scale)
    else:
        mat_input = affine_matrix(
            center[None].astype(np.float32), (scale / 200.0)[None],
            np.array([aug_rot], np.float32), in_wh)[0].numpy()
    img_warped = cv2.warpAffine(img, mat_input, in_wh,
                                flags=cv2.INTER_LINEAR)
    return img_warped, masks_out, joints_out, aug_scale


def bottomup_random_flip(img, masks, joints, flip_index, output_sizes, rng,
                         flip_prob=0.5):
    """Reference `BottomUpRandomFlip` (bottom_up_transform.py:360): runs
    AFTER the affine, flipping the input-res image and each output scale's
    mask/joints in its own pixel frame (x -> out_size - x - 1)."""
    if rng.random_sample() >= flip_prob:
        return img, masks, joints, False
    img = img[:, ::-1].copy()
    masks = [m[:, ::-1].copy() for m in masks]
    out = []
    for j, out_size in zip(joints, output_sizes):
        j = j[:, flip_index].copy()
        j[:, :, 0] = out_size - j[:, :, 0] - 1
        out.append(j)
    return img, masks, out, True

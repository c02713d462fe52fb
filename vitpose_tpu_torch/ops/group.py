"""Bottom-up keypoint grouping (associative embedding), in PyTorch and numpy.

Counterpart of vitpose_tpu/ops/group.py (the reference `HeatmapParser`,
mmpose/core/post_processing/group.py:144), split as there:

  * on the maps' device (torch): heatmap NMS (max-pool equality) and the
    per-joint top candidates with their locations and tags
    (`heatmap_nms`, `topk_candidates`);
  * on the host (numpy + scipy): greedy tag matching per image
    (scipy.optimize.linear_sum_assignment), the 0.25-pixel adjustment and
    the refinement of missed joints (`match_by_tag`, `adjust_poses`,
    `refine_pose`, copied from the JAX package; `refine_pose` takes the tag
    distances of all missed joints in one pass, `tag_distance`, with the
    same values).

Tie order: NMS keeps every pixel of a flat maximum, so equal values are
common. `jax.lax.top_k` returns equal values in index order and
`torch.topk` does not promise any order, so the candidates come from a
stable descending sort, which keeps JAX's order; the order decides which
candidates reach the matching and the order of the people that come out.
COCO's joint matching order and every threshold follow the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .decode import post_dark_udp

COCO_JOINT_ORDER = [i - 1 for i in
                    [1, 2, 3, 4, 5, 6, 7, 12, 13, 8, 9, 10, 11, 14, 15, 16,
                     17]]


def heatmap_nms(heatmaps, kernel=5):
    """Keep only local maxima: x * (maxpool(x) == x), [..., H, W]; the pool
    pads with -inf, as JAX's reduce_window does."""
    shape = heatmaps.shape
    x = heatmaps.reshape((-1, 1) + tuple(shape[-2:]))
    m = F.max_pool2d(x, kernel, 1, (kernel - 1) // 2)
    return torch.where(m == x, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device)).reshape(shape)


def topk_candidates(heatmaps, tags, max_num_people=30, nms_kernel=5):
    """NMS + the `max_num_people` largest values per joint, equal values in
    index order (JAX's `lax.top_k`), on the maps' device.

    heatmaps [N, K, H, W]; tags [N, K, H, W, L].
    Returns dict(val_k [N,K,M], loc_k [N,K,M,2] (x,y), tag_k [N,K,M,L]).
    """
    n, k, h, w = heatmaps.shape
    hm = heatmap_nms(heatmaps, nms_kernel).reshape(n, k, h * w)
    val, ind = torch.sort(hm, dim=-1, descending=True, stable=True)
    val_k, ind = val[..., :max_num_people], ind[..., :max_num_people]
    tags_flat = tags.reshape(n, k, h * w, -1)
    tag_k = torch.gather(tags_flat, 2, ind[..., None].expand(
        -1, -1, -1, tags_flat.shape[-1]))
    loc_k = torch.stack([(ind % w).float(), (ind // w).float()], dim=-1)
    return dict(val_k=val_k, loc_k=loc_k, tag_k=tag_k)


def match_by_tag(val_k, loc_k, tag_k, joint_order=None,
                 detection_threshold=0.1, tag_threshold=1.0,
                 max_num_people=30, use_detection_val=True,
                 ignore_too_much=False):
    """Host-side grouping for ONE image (parity: group.py:28
    `_match_by_tag`). val_k [K,M], loc_k [K,M,2], tag_k [K,M,L] numpy.

    Returns [P, K, 3+L] poses (x, y, score, tag...).
    """
    from scipy.optimize import linear_sum_assignment

    k, m = val_k.shape
    tag_dim = tag_k.shape[2]
    if joint_order is None:
        joint_order = (COCO_JOINT_ORDER if k == 17 else list(range(k)))
    default = np.zeros((k, 3 + tag_dim), np.float32)

    joint_dict = {}
    tag_dict = {}
    for i in range(k):
        idx = joint_order[i]
        joints = np.concatenate(
            [loc_k[idx], val_k[idx, :, None], tag_k[idx]], axis=1)
        mask = joints[:, 2] > detection_threshold
        tags = tag_k[idx][mask]
        joints = joints[mask]
        if joints.shape[0] == 0:
            continue
        if i == 0 or len(joint_dict) == 0:
            for tag, joint in zip(tags, joints):
                key = tag[0]
                joint_dict.setdefault(key, np.copy(default))[idx] = joint
                tag_dict[key] = [tag]
            continue

        grouped_keys = list(joint_dict.keys())[:max_num_people]
        grouped_tags = [np.mean(tag_dict[g], axis=0) for g in grouped_keys]
        if ignore_too_much and len(grouped_keys) == max_num_people:
            continue

        diff = joints[:, None, 3:] - np.asarray(grouped_tags)[None]
        diff_normed = np.linalg.norm(diff, ord=2, axis=2)
        diff_saved = diff_normed.copy()
        if use_detection_val:
            diff_normed = np.round(diff_normed) * 100 - joints[:, 2:3]
        num_added, num_grouped = diff_normed.shape
        if num_added > num_grouped:
            diff_normed = np.concatenate(
                [diff_normed,
                 np.full((num_added, num_added - num_grouped), 1e10,
                         np.float32)], axis=1)
        rows, cols = linear_sum_assignment(diff_normed)
        for row, col in zip(rows, cols):
            if (row < num_added and col < num_grouped
                    and diff_saved[row, col] < tag_threshold):
                key = grouped_keys[col]
                joint_dict[key][idx] = joints[row]
                tag_dict[key].append(tags[row])
            else:
                key = tags[row][0]
                joint_dict.setdefault(key, np.copy(default))[idx] = \
                    joints[row]
                tag_dict[key] = [tags[row]]

    if not joint_dict:
        return np.zeros((0, k, 3 + tag_dim), np.float32)
    return np.stack(list(joint_dict.values())).astype(np.float32)


def adjust_poses(poses, heatmaps):
    """0.25-px shift toward the larger neighbor + 0.5 center offset
    (parity: group.py:244 `HeatmapParser.adjust`). poses [P, K, 3+],
    heatmaps [K, H, W] numpy."""
    k, h, w = heatmaps.shape
    poses = poses.copy()
    for p in poses:
        for j in range(k):
            if p[j, 2] > 0:
                x, y = p[j, :2]
                xx, yy = int(x), int(y)
                hm = heatmaps[j]
                y += 0.25 if hm[min(h - 1, yy + 1), xx] > \
                    hm[max(0, yy - 1), xx] else -0.25
                x += 0.25 if hm[yy, min(w - 1, xx + 1)] > \
                    hm[yy, max(0, xx - 1)] else -0.25
                p[j, 0] = x + 0.5
                p[j, 1] = y + 0.5
    return poses


def tag_distance(diff):
    """np.linalg.norm(diff, axis=-1), bit for bit: numpy computes it as
    sqrt(add.reduce(diff * diff, axis=-1)), which adds the L terms one
    after another for L < 8 (pairwise from 8 on); added plane by plane, the
    same sums take one vectorised pass instead of a short reduction per
    pixel."""
    sq = diff * diff
    if sq.shape[-1] < 8:
        return np.sqrt(np.add.reduce(np.moveaxis(sq, -1, 0), axis=0))
    return np.sqrt(np.add.reduce(sq, axis=-1))


def refine_pose(heatmaps, tags, pose, use_udp=False):
    """Fill in missed joints from the pose's mean tag
    (parity: group.py:281 `HeatmapParser.refine`). heatmaps [K, H, W],
    tags [K, H, W, L], pose [K, 3+L] numpy."""
    k, h, w = heatmaps.shape
    if tags.ndim == 3:
        tags = tags[..., None]
    found = [tags[j, int(np.clip(pose[j, 1], 0, h - 1)),
                  int(np.clip(pose[j, 0], 0, w - 1))]
             for j in range(k) if pose[j, 2] > 0]
    if not found:
        return pose
    prev_tag = np.mean(found, axis=0)
    pose = pose.copy()
    missing = [j for j in range(k) if not pose[j, 2] > 0]
    if not missing:
        return pose
    # every missed joint at once: the same values as JAX's loop over them
    dist = tag_distance(tags[missing] - prev_tag)
    best = (heatmaps[missing] - np.round(dist)).reshape(
        len(missing), -1).argmax(axis=1)
    for j, flat in zip(missing, best):
        yy, xx = divmod(int(flat), w)
        val = heatmaps[j, yy, xx]
        if val <= 0:
            continue
        x, y = float(xx), float(yy)
        if not use_udp:
            x += 0.5
            y += 0.5
        x += 0.25 if heatmaps[j, yy, min(w - 1, xx + 1)] > \
            heatmaps[j, yy, max(0, xx - 1)] else -0.25
        y += 0.25 if heatmaps[j, min(h - 1, yy + 1), xx] > \
            heatmaps[j, max(0, yy - 1), xx] else -0.25
        pose[j, :3] = (x, y, val)
    return pose


class HeatmapParser:
    """Bottom-up parser: the candidates on the maps' device, the grouping
    on the host (parity with the reference HeatmapParser.parse,
    group.py:360)."""

    def __init__(self, num_joints=17, max_num_people=30, nms_kernel=5,
                 detection_threshold=0.1, tag_threshold=1.0,
                 use_detection_val=True, ignore_too_much=False,
                 tag_per_joint=True, use_udp=False, score_per_joint=False):
        self.num_joints = num_joints
        self.max_num_people = max_num_people
        self.nms_kernel = nms_kernel
        self.detection_threshold = detection_threshold
        self.tag_threshold = tag_threshold
        self.use_detection_val = use_detection_val
        self.ignore_too_much = ignore_too_much
        self.tag_per_joint = tag_per_joint
        self.use_udp = use_udp
        self.score_per_joint = score_per_joint

    def parse(self, heatmaps, tags, adjust=True, refine=True):
        """heatmaps [1, K, H, W], tags [1, K, H, W, L] (tensors on any
        device, or numpy). Returns (list with one [P, K, 3+L] array, scores
        list)."""
        heatmaps = torch.as_tensor(heatmaps)
        tags = torch.as_tensor(tags)
        cand = topk_candidates(heatmaps, tags,
                               max_num_people=self.max_num_people,
                               nms_kernel=self.nms_kernel)
        val_k, loc_k, tag_k = (cand[k][0].cpu().numpy()
                               for k in ('val_k', 'loc_k', 'tag_k'))
        poses = match_by_tag(
            val_k, loc_k, tag_k,
            detection_threshold=self.detection_threshold,
            tag_threshold=self.tag_threshold,
            max_num_people=self.max_num_people,
            use_detection_val=self.use_detection_val,
            ignore_too_much=self.ignore_too_much)

        hm0 = heatmaps[0].cpu().numpy()
        tg0 = tags[0].cpu().numpy()
        if poses.shape[0] and adjust:
            if self.use_udp:
                # the Newton step on the maps' device, one copy of the maps
                # per pose, as JAX broadcasts them
                coords = torch.from_numpy(poses[..., :2]).to(heatmaps.device)
                poses[..., :2] = post_dark_udp(
                    coords, heatmaps[:1].float().expand(
                        poses.shape[0], -1, -1, -1)).cpu().numpy()
            else:
                poses = adjust_poses(poses, hm0)

        if self.score_per_joint:
            scores = [p[:, 2] for p in poses]
        else:
            scores = [p[:, 2].mean() for p in poses]

        if refine and poses.shape[0]:
            t = tg0 if self.tag_per_joint else \
                np.tile(tg0, (self.num_joints, 1, 1, 1))
            poses = np.stack([
                refine_pose(hm0, t, p, use_udp=self.use_udp)
                for p in poses])
        return [poses], scores

"""OKS-based NMS for COCO-style keypoint evaluation (host-side numpy).

The port's own copy of vitpose_tpu/ops/nms.py:10-88. It runs once per
evaluation over a handful of candidates per image, on the host in numpy, as
in the JAX package (reference mmpose/core/post_processing/nms.py).
"""
from __future__ import annotations

import numpy as np

COCO_SIGMAS = np.array([
    0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
    0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
], dtype=np.float32)


def oks_iou(g, d, a_g, a_d, sigmas=None, vis_thr=None):
    """Object-keypoint-similarity between one GT pose ``g`` [K*3] and a set of
    poses ``d`` [M, K*3] with areas a_g (scalar) / a_d [M].
    Parity: reference nms.py:51.
    """
    sigmas = COCO_SIGMAS if sigmas is None else np.asarray(sigmas)
    vars_ = (sigmas * 2.0) ** 2
    xg, yg, vg = g[0::3], g[1::3], g[2::3]
    ious = np.zeros(len(d), dtype=np.float32)
    for i, (dd, aa) in enumerate(zip(d, a_d)):
        xd, yd, vd = dd[0::3], dd[1::3], dd[2::3]
        dx, dy = xd - xg, yd - yg
        e = (dx ** 2 + dy ** 2) / vars_ / ((a_g + aa) / 2.0 + np.spacing(1)) / 2.0
        if vis_thr is not None:
            ind = (vg > vis_thr) & (vd > vis_thr)
            e = e[ind]
        ious[i] = np.sum(np.exp(-e)) / len(e) if len(e) != 0 else 0.0
    return ious


def oks_nms(kpts_db, thr, sigmas=None, vis_thr=None, score_per_joint=False):
    """Greedy OKS NMS over a list of dicts with 'keypoints' [K,3] and 'score'.
    Returns kept indices. Parity: reference nms.py:89.
    """
    if len(kpts_db) == 0:
        return []
    if score_per_joint:
        scores = np.array([k['score'].mean() for k in kpts_db])
    else:
        scores = np.array([k['score'] for k in kpts_db])
    kpts = np.array([k['keypoints'].flatten() for k in kpts_db])
    areas = np.array([k['area'] for k in kpts_db])

    order = scores.argsort()[::-1]
    keep = []
    while len(order) > 0:
        i = order[0]
        keep.append(i)
        ious = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                       sigmas, vis_thr)
        order = order[1:][ious <= thr]
    return keep


def soft_oks_nms(kpts_db, thr, max_dets=20, sigmas=None, vis_thr=None,
                 score_per_joint=False):
    """Soft OKS NMS with gaussian rescoring. Returns kept indices
    (parity: reference nms.py:155)."""
    if len(kpts_db) == 0:
        return []
    if score_per_joint:
        scores = np.array([k['score'].mean() for k in kpts_db])
    else:
        scores = np.array([k['score'] for k in kpts_db])
    kpts = np.array([k['keypoints'].flatten() for k in kpts_db])
    areas = np.array([k['area'] for k in kpts_db])

    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = np.zeros(max_dets, dtype=np.intp)
    keep_cnt = 0
    while len(order) > 0 and keep_cnt < max_dets:
        i = order[0]
        ious = oks_iou(kpts[i], kpts[order[1:]], areas[i], areas[order[1:]],
                       sigmas, vis_thr)
        order = order[1:]
        scores = scores[1:] * np.exp(-(ious ** 2) / thr)
        tmp = scores.argsort()[::-1]
        order = order[tmp]
        scores = scores[tmp]
        keep[keep_cnt] = i
        keep_cnt += 1
    return keep[:keep_cnt].tolist()

"""Pose tracking across video frames (greedy IoU or OKS association), in
numpy on the host.

The port's own copy of vitpose_tpu/api/tracking.py (`get_track_id`,
`_match`, `_temporal_refine`, `vis_pose_tracking_result`): assigns stable
track ids from frame to frame and optionally smooths keypoints with a
One-Euro filter per track. OKS matching uses the port's `ops.nms.oks_iou`.
"""
from __future__ import annotations

import numpy as np

from ..ops.nms import oks_iou
from ..ops.smoothing import OneEuroFilter


def _compute_iou(a, b):
    """IoU of two xyxy boxes."""
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area_a = max(0.0, a[2] - a[0]) * max(0.0, a[3] - a[1])
    area_b = max(0.0, b[2] - b[0]) * max(0.0, b[3] - b[1])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def _fill_area(results):
    """Unconditionally (re)derive area and ensure an xyxy bbox, like the
    reference _get_area (inference_tracking.py) — results that carry
    'area' but no 'bbox' (bottom-up poses) get a keypoint-extent bbox."""
    for r in results:
        if r.get('bbox') is not None:
            b = r['bbox']
            r['area'] = float(max(0.0, b[2] - b[0])
                              * max(0.0, b[3] - b[1]))
        else:
            kp = np.asarray(r['keypoints'])
            xs = kp[:, 0][kp[:, 0] > 0]
            ys = kp[:, 1][kp[:, 1] > 0]
            xmin = xs.min() if xs.size else 1e10
            ymin = ys.min() if ys.size else 1e10
            xmax = kp[:, 0].max()
            ymax = kp[:, 1].max()
            r['area'] = float((xmax - xmin) * (ymax - ymin))
            r['bbox'] = np.array([xmin, ymin, xmax, ymax])
    return results


def _match(res, results_last, thr, use_oks):
    if not results_last:
        return -1, results_last, {}
    if use_oks:
        pose = np.asarray(res['keypoints']).reshape(-1)
        poses_last = np.stack([np.asarray(r['keypoints']).reshape(-1)
                               for r in results_last])
        areas_last = np.array([r['area'] for r in results_last])
        scores = oks_iou(pose, poses_last, res['area'], areas_last)
    else:
        scores = np.array([_compute_iou(list(res['bbox']),
                                        list(r['bbox']))
                           for r in results_last])
    best = int(np.argmax(scores))
    if scores[best] > thr:
        match = results_last[best]
        del results_last[best]
        return match['track_id'], results_last, match
    return -1, results_last, {}


def get_track_id(results, results_last, next_id, min_keypoints=3,
                 use_oks=False, tracking_thr=0.3, use_one_euro=False,
                 fps=None, bbox_format='xyxy'):
    """Assign track ids to `results` by matching against `results_last`.
    Returns (results with 'track_id', next_id). Parity:
    inference_tracking.py:167.

    ``bbox_format``: format of the incoming results' bbox ('xyxy' like
    the reference, or 'xywh' as returned by inference_top_down_pose_model
    with its default format). Boxes are converted to xyxy in place so IoU
    and area are computed on corner coordinates."""
    if bbox_format == 'xywh':
        for r in results:
            b = r.get('bbox')
            if b is not None:
                b = np.asarray(b, np.float32).copy()
                b[2] = b[0] + b[2]
                b[3] = b[1] + b[3]
                r['bbox'] = b
    elif bbox_format != 'xyxy':
        raise ValueError(f'bbox_format must be xyxy or xywh, '
                         f'got {bbox_format!r}')
    results = _fill_area(results)
    for res in results:
        track_id, results_last, match = _match(res, results_last,
                                               tracking_thr, use_oks)
        if track_id == -1:
            if np.count_nonzero(res['keypoints'][:, 1]) > min_keypoints:
                res['track_id'] = next_id
                next_id += 1
            else:
                res['keypoints'][:, 1] = -10
                res['bbox'] = np.asarray(res['bbox']) * 0
                res['track_id'] = -1
        else:
            res['track_id'] = track_id
        if use_one_euro:
            res['keypoints'] = _temporal_refine(res, match, fps=fps)
    return results, next_id


def _temporal_refine(result, match_result, fps=None):
    """Per-track One-Euro smoothing (inference_tracking.py:147)."""
    if 'one_euro' in match_result:
        result['keypoints'][:, :2] = match_result['one_euro'](
            result['keypoints'][:, :2])
        result['one_euro'] = match_result['one_euro']
    else:
        result['one_euro'] = OneEuroFilter(result['keypoints'][:, :2],
                                           fps=fps)
    return result['keypoints']


_TRACK_PALETTE = np.array(
    [[255, 128, 0], [255, 153, 51], [255, 178, 102], [230, 230, 0],
     [255, 153, 255], [153, 204, 255], [255, 102, 255], [255, 51, 255],
     [102, 178, 255], [51, 153, 255], [255, 153, 153], [255, 102, 102],
     [255, 51, 51], [153, 255, 153], [102, 255, 102], [51, 255, 51],
     [0, 255, 0], [0, 0, 255], [255, 0, 0], [255, 255, 255]])


def vis_pose_tracking_result(model, img, result, radius=4, thickness=1,
                             kpt_score_thr=0.3, dataset=None,
                             dataset_info=None, show=False, out_file=None):
    """Draw tracked poses, one palette color per track id (counterpart of
    reference inference_tracking.py:227 `vis_pose_tracking_result`).

    `result` items carry 'keypoints' [K, 3] and 'track_id'. Returns the
    BGR image (also written to `out_file` when given)."""
    import cv2

    info = dataset_info or getattr(model, 'dataset_info', None)
    if isinstance(img, str):
        img = cv2.imread(img)
    else:
        img = cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2BGR)

    for res in result:
        tid = int(res.get('track_id', 0))
        color = _TRACK_PALETTE[tid % len(_TRACK_PALETTE)]
        # vis_pose_result draws one pose list; override colors per track
        # by drawing directly (the reference does the same per-id loop)
        kpts = np.asarray(res['keypoints'])
        links = info.skeleton_links if info else []
        for a, b in links:
            if a < len(kpts) and b < len(kpts) \
                    and kpts[a, 2] > kpt_score_thr \
                    and kpts[b, 2] > kpt_score_thr:
                cv2.line(img, tuple(kpts[a, :2].astype(int)),
                         tuple(kpts[b, :2].astype(int)),
                         tuple(int(c) for c in color), thickness)
        for x, y, s in kpts:
            if s > kpt_score_thr:
                cv2.circle(img, (int(x), int(y)), radius,
                           tuple(int(c) for c in color), -1)
        bbox = res.get('bbox')
        if bbox is not None and np.asarray(bbox).size >= 4:
            x0, y0, x1, y1 = np.asarray(bbox[:4]).astype(int)
            cv2.rectangle(img, (x0, y0), (x1, y1),
                          tuple(int(c) for c in color), thickness)
            cv2.putText(img, str(tid), (x0, max(0, y0 - 4)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                        tuple(int(c) for c in color), 1)
    if out_file:
        cv2.imwrite(out_file, img)
    return img

"""COCO keypoint (OKS) evaluation in vectorized numpy — no pycocotools.

The port's own copy of vitpose_tpu/eval/cocoeval.py:18-350. A fresh
implementation of the published COCO keypoint evaluation protocol
(OKS thresholds 0.50:0.05:0.95, area ranges all/medium/large, maxDets=20,
101-point precision interpolation), producing the same 10 summary stats as
`COCOeval(iouType='keypoints')`. Golden-tested against the evaluator the
reference vendors (reference: mmpose/datasets/datasets/top_down/_cocoeval.py,
used by topdown_coco_dataset.py:573 `_do_python_keypoint_eval`).

Design: per-image OKS matrices and greedy matching are vectorized over the
10 OKS thresholds at once; accumulation concatenates per-image match flags
and does one global score sort per (threshold-set, area-range).
"""
from __future__ import annotations

import numpy as np

COCO_KPT_STAT_NAMES = ['AP', 'AP .5', 'AP .75', 'AP (M)', 'AP (L)',
                       'AR', 'AR .5', 'AR .75', 'AR (M)', 'AR (L)']

# one canonical COCO sigma table, shared with the OKS-NMS (drift between
# the two would score NMS and COCOeval with different uncertainty tables)
from ..ops.nms import COCO_SIGMAS as _COCO_SIGMAS
_DEFAULT_SIGMAS = np.asarray(_COCO_SIGMAS, np.float64)


def compute_oks_matrix(gts, dts, sigmas):
    """OKS between every (dt, gt) pair for one image.

    gts/dts: lists of annotation dicts with 'keypoints' (flat 3K) and, for
    gts, 'area' and 'bbox'. Returns [D, G] float array. Follows the COCO
    computeOks spec: distances at visible gt keypoints; if a gt has no
    labeled keypoints, distances fall back to the expanded-bbox clamp.
    """
    vars_ = (sigmas * 2.0) ** 2
    k = len(sigmas)
    ious = np.zeros((len(dts), len(gts)))
    for j, gt in enumerate(gts):
        g = np.asarray(gt['keypoints'], np.float64).reshape(k, 3)
        xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
        vis = vg > 0
        n_vis = int(vis.sum())
        bb = gt['bbox']
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        denom = vars_ * (gt['area'] + np.spacing(1)) * 2.0
        for i, dt in enumerate(dts):
            d = np.asarray(dt['keypoints'], np.float64).reshape(k, 3)
            xd, yd = d[:, 0], d[:, 1]
            if n_vis > 0:
                dx, dy = xd - xg, yd - yg
            else:
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = (dx ** 2 + dy ** 2) / denom
            if n_vis > 0:
                e = e[vis]
            ious[i, j] = np.mean(np.exp(-e)) if e.size else 0.0
    return ious


class CocoKeypointEval:
    """Evaluate keypoint detections against a CocoIndex ground truth."""

    def __init__(self, coco_gt, sigmas=None,
                 area_rngs=None, max_dets=20, use_area=True,
                 kpt_slice=None, gt_ignore_from_num_keypoints=False):
        # use_area=False: datasets without an 'area' field (CrowdPose, AIC)
        # normalize OKS by bbox w*h*0.53 (xtcocotools convention)
        #
        # kpt_slice=(start, end): evaluate only that keypoint range, the
        # WholeBody per-part protocol (reference _cocoeval.py:136-232,
        # 360-404 — gt/dt part slices, gt ignored when the PART has no
        # visible keypoints, dt dropped when the part prediction is
        # all-zero; OKS still normalizes by the full person area). WholeBody
        # gt anns split parts across foot/face/lefthand/righthand fields,
        # which are concatenated onto 'keypoints' before slicing.
        self.use_area = use_area
        self.kpt_slice = kpt_slice
        # CrowdPose: num_keypoints counts only vis==2 joints, and the
        # reference keypoints_crowd protocol ignores gts by that count
        # (_cocoeval.py:163-167), NOT by the v>0 vector count — a gt with
        # only labeled-invisible (v==1) joints is ignored there but would
        # be kept by the vector count
        self.gt_ignore_from_num_keypoints = gt_ignore_from_num_keypoints
        self.coco_gt = coco_gt
        self.sigmas = (np.asarray(sigmas, np.float64)
                       if sigmas is not None else _DEFAULT_SIGMAS)
        self.oks_thrs = np.linspace(0.5, 0.95, 10)
        self.rec_thrs = np.linspace(0.0, 1.00, 101)
        self.area_rngs = area_rngs or [
            ('all', [0.0, 1e10]),
            ('medium', [32 ** 2, 96 ** 2]),
            ('large', [96 ** 2, 1e10]),
        ]
        self.max_dets = max_dets

    # ------------------------------------------------------------------
    def _gather(self, coco_dt, img_ids=None, cat=None):
        """Group gt/dt per image for one category (default: first)."""
        img_ids = img_ids if img_ids is not None else \
            self.coco_gt.getImgIds()
        cat_ids = self.coco_gt.getCatIds() or [1]
        cat = cat if cat is not None else cat_ids[0]
        per_img = {}
        for img_id in img_ids:
            gts = [g for g in self.coco_gt.loadAnns(
                self.coco_gt.getAnnIds(imgIds=img_id))
                if g.get('category_id', cat) == cat]
            dts = [d for d in coco_dt.loadAnns(
                coco_dt.getAnnIds(imgIds=img_id))
                if d.get('category_id', cat) == cat]
            if self.kpt_slice is not None:
                gts = [self._slice_ann(g) for g in gts]
                dts = [self._slice_ann(d) for d in dts]
            else:
                # copies: _ignore/area are evaluation-local annotations
                # and must not leak into the caller's CocoIndex (a second
                # evaluation with different use_area would otherwise see
                # the mutated areas)
                gts = [dict(g) for g in gts]
            # a dt whose prediction is all-zero-confidence is dropped
            # (reference _cocoeval.py:221-223 — full-body and part alike)
            dts = [d for d in dts if np.count_nonzero(
                np.asarray(d['keypoints'])[2::3] > 0)]
            for g in gts:
                # ignore gts with no visible keypoints, counted from the
                # keypoint vector like the reference _prepare
                # (_cocoeval.py:170-173; num_keypoints alone misses
                # jsons that omit the field), except the CrowdPose
                # protocol which keys on num_keypoints (vis==2 only)
                if self.gt_ignore_from_num_keypoints:
                    vis = g.get('num_keypoints', 1)
                else:
                    vis = np.count_nonzero(
                        np.asarray(g['keypoints'])[2::3] > 0)
                g['_ignore'] = (g.get('iscrowd', 0) == 1 or vis == 0)
                if not self.use_area or 'area' not in g:
                    g['area'] = g['bbox'][2] * g['bbox'][3] * 0.53
            per_img[img_id] = (gts, dts)
        return per_img

    def _slice_ann(self, ann):
        """Copy `ann` with 'keypoints' = the kpt_slice range of the full
        (body+foot+face+lefthand+righthand) keypoint vector."""
        kp = list(ann.get('keypoints', []))
        for part in ('foot_kpts', 'face_kpts', 'lefthand_kpts',
                     'righthand_kpts'):
            if part in ann:
                kp = kp + list(ann[part])
        s, e = self.kpt_slice
        out = dict(ann)
        out['keypoints'] = kp[s * 3:e * 3]
        return out

    def _prep_image(self, gts, dts):
        """Area-range-independent per-image work, done ONCE and reused by
        every (area range) pass: score-sort/truncate dts and compute the
        OKS matrix (pycocotools likewise computes ious once per image)."""
        d_scores = np.array([d['score'] for d in dts])
        d_order = np.argsort(-d_scores, kind='stable')[:self.max_dets]
        dts = [dts[i] for i in d_order]
        d_scores = d_scores[d_order]
        n_d, n_g = len(dts), len(gts)
        ious = compute_oks_matrix(gts, dts, self.sigmas) if n_d * n_g else \
            np.zeros((n_d, n_g))
        return gts, dts, d_scores, ious

    def _match_image(self, prep, area_rng):
        """Greedy per-image matching over all OKS thresholds at once.

        Returns (dt_scores [D'], dt_matched [T, D'], dt_ignore [T, D'],
        n_valid_gt) where D' = min(D, max_dets) dts sorted by score.
        """
        gts, dts, d_scores, ious = prep
        t_n = len(self.oks_thrs)
        # closed interval [a0, a1], matching COCOeval's `area>aRng[1]` test
        gt_ignore = np.array(
            [g['_ignore'] or g['area'] < area_rng[0]
             or g['area'] > area_rng[1] for g in gts], bool)
        # non-ignored gts first (stable), as the protocol requires
        g_order = np.argsort(gt_ignore, kind='stable')
        gts = [gts[i] for i in g_order]
        gt_ignore = gt_ignore[g_order]
        ious = ious[:, g_order] if ious.size else ious

        n_d, n_g = len(dts), len(gts)

        dt_matched = np.zeros((t_n, n_d), bool)
        dt_ignore = np.zeros((t_n, n_d), bool)
        gt_matched = np.zeros((t_n, n_g), bool)
        for ti, thr in enumerate(self.oks_thrs):
            for di in range(n_d):
                best = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(n_g):
                    if gt_matched[ti, gi] and not gts[gi].get('iscrowd', 0):
                        continue
                    # stop at ignored gts once a non-ignored match was found
                    if best_g > -1 and not gt_ignore[best_g] \
                            and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    best_g = gi
                if best_g == -1:
                    continue
                gt_matched[ti, best_g] = True
                dt_matched[ti, di] = True
                dt_ignore[ti, di] = gt_ignore[best_g]
        # unmatched dts outside the area range are ignored
        d_areas = np.array([d.get('area', 0.0) for d in dts]) \
            if n_d else np.zeros(0)
        d_out = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
        dt_ignore |= (~dt_matched) & d_out[None, :]
        return d_scores, dt_matched, dt_ignore, int((~gt_ignore).sum())

    # ------------------------------------------------------------------
    def evaluate(self, coco_dt, img_ids=None):
        """coco_dt: CocoIndex from loadRes. Returns dict of the 10 stats.
        `img_ids` restricts evaluation to an image subset."""
        t_n, r_n = len(self.oks_thrs), len(self.rec_thrs)
        # per-category evaluation like COCOeval: precision/recall get a
        # category axis and the final means average over categories with
        # GT (multi-species datasets like AP-10K need this; single-cat
        # datasets reduce to the old behavior)
        cat_ids = self.coco_gt.getCatIds() or [1]
        stats = {}
        results = {}
        # gather + score-sort + OKS once per (image, category); only the
        # ignore flags differ between area ranges
        per_cat = {}
        for cat in cat_ids:
            per_img = self._gather(coco_dt, img_ids, cat=cat)
            per_cat[cat] = {i: self._prep_image(g, d)
                            for i, (g, d) in per_img.items()}
        for a_name, a_rng in self.area_rngs:
            precisions, recalls = [], []
            n_gt_total = 0
            for cat in cat_ids:
                scores_all, matched_all, ignore_all = [], [], []
                n_gt = 0
                for img_id, prep in per_cat[cat].items():
                    s, m, ig, ng = self._match_image(prep, a_rng)
                    scores_all.append(s)
                    matched_all.append(m)
                    ignore_all.append(ig)
                    n_gt += ng
                scores = (np.concatenate(scores_all) if scores_all
                          else np.zeros(0))
                matched = (np.concatenate(matched_all, axis=1)
                           if matched_all else np.zeros((t_n, 0), bool))
                ignored = (np.concatenate(ignore_all, axis=1)
                           if ignore_all else np.zeros((t_n, 0), bool))
                order = np.argsort(-scores, kind='mergesort')
                matched = matched[:, order]
                ignored = ignored[:, order]

                precision = -np.ones((t_n, r_n))
                recall = -np.ones(t_n)
                if n_gt > 0:
                    for ti in range(t_n):
                        keep = ~ignored[ti]
                        tp = np.cumsum(matched[ti][keep])
                        fp = np.cumsum(~matched[ti][keep])
                        nd = len(tp)
                        rc = tp / n_gt
                        pr = tp / np.maximum(tp + fp, np.spacing(1))
                        recall[ti] = rc[-1] if nd else 0.0
                        # monotone non-increasing precision envelope
                        pr = (np.maximum.accumulate(pr[::-1])[::-1]
                              if nd else pr)
                        inds = np.searchsorted(rc, self.rec_thrs,
                                               side='left')
                        q = np.zeros(r_n)
                        valid = inds < nd
                        q[valid] = pr[inds[valid]]
                        precision[ti] = q
                precisions.append(precision)
                recalls.append(recall)
                n_gt_total += n_gt
            precision = np.stack(precisions, axis=-1)   # [T, R, K]
            recall = np.stack(recalls, axis=-1)         # [T, K]
            results[a_name] = (precision, recall, n_gt_total)

        def _ap(a_name, thr=None):
            p, _, n_gt = results[a_name]
            if n_gt == 0:
                return -1.0
            if thr is not None:
                ti = int(np.argmin(np.abs(self.oks_thrs - thr)))
                p = p[ti:ti + 1]
            valid = p > -1
            return float(p[valid].mean()) if valid.any() else -1.0

        def _ar(a_name, thr=None):
            _, r, n_gt = results[a_name]
            if n_gt == 0:
                return -1.0
            if thr is not None:
                ti = int(np.argmin(np.abs(self.oks_thrs - thr)))
                r = r[ti:ti + 1]
            valid = r > -1
            return float(r[valid].mean()) if valid.any() else -1.0

        stats['AP'] = _ap('all')
        stats['AP .5'] = _ap('all', 0.5)
        stats['AP .75'] = _ap('all', 0.75)
        stats['AR'] = _ar('all')
        stats['AR .5'] = _ar('all', 0.5)
        stats['AR .75'] = _ar('all', 0.75)
        if 'medium' in results:
            stats['AP (M)'] = _ap('medium')
            stats['AR (M)'] = _ar('medium')
        if 'large' in results:
            stats['AP (L)'] = _ap('large')
            stats['AR (L)'] = _ar('large')
        return stats


CROWDPOSE_STAT_NAMES = ['AP', 'AP .5', 'AP .75', 'AR', 'AR .5', 'AR .75',
                        'AP (E)', 'AP (M)', 'AP (H)']


def evaluate_crowdpose(coco_gt, coco_dt, sigmas):
    """CrowdPose protocol (COCOeval iouType='keypoints_crowd'):
    the standard AP/AR over all images plus AP on easy/medium/hard image
    subsets partitioned by each image's `crowdIndex`
    ([0, 0.2) / [0.2, 0.8) / [0.8, 1] — the reference
    _summarizeKps_crowd calls get_type_result(first=0.2, second=0.8),
    _cocoeval.py:879).
    """
    ev = CocoKeypointEval(coco_gt, sigmas=sigmas, use_area=False,
                          area_rngs=[('all', [0.0, 1e10])],
                          gt_ignore_from_num_keypoints=True)
    base = ev.evaluate(coco_dt)
    easy, medium, hard = [], [], []
    for img_id, img in coco_gt.imgs.items():
        ci = img.get('crowdIndex', 0.0)
        (easy if ci < 0.2 else medium if ci < 0.8 else hard).append(img_id)
    stats = {
        'AP': base['AP'], 'AP .5': base['AP .5'], 'AP .75': base['AP .75'],
        'AR': base['AR'], 'AR .5': base['AR .5'], 'AR .75': base['AR .75'],
    }
    for name, subset in (('AP (E)', easy), ('AP (M)', medium),
                         ('AP (H)', hard)):
        stats[name] = (ev.evaluate(coco_dt, img_ids=subset)['AP']
                       if subset else -1.0)
    return stats

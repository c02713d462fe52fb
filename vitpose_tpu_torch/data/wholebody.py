"""COCO-WholeBody dataset: 133-kpt top-down records + per-part evaluation.

The port's own copy of vitpose_tpu/data/wholebody.py (`WholeBodyDataset`),
counterpart of the reference `TopDownCocoWholeBodyDataset`
(mmpose/datasets/datasets/top_down/topdown_coco_wholebody_dataset.py): the
record db reuses TopDownDataset (which already concatenates
body+foot+face+lefthand+righthand keypoints, topdown.py), and `evaluate`
runs SIX COCO evaluations — body/foot/face/lefthand/righthand slices with
their own OKS sigmas plus the full 133-kpt wholebody pass — mirroring
`_do_python_keypoint_eval` (:202-263). Like the reference, the returned
headline stats are the WHOLEBODY ones; the per-part stats are returned too,
prefixed 'body/', 'foot/', ... (the reference only prints them).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .topdown import TopDownDataset
from ..eval.cocoeval import CocoKeypointEval

# body 17 + foot 6 + face 68 + lefthand 21 + righthand 21 = 133
# (reference topdown_coco_wholebody_dataset.py:92-97)
PART_CUTS = OrderedDict([
    ('body', (0, 17)),
    ('foot', (17, 23)),
    ('face', (23, 91)),
    ('lefthand', (91, 112)),
    ('righthand', (112, 133)),
    ('wholebody', (0, 133)),
])


class WholeBodyDataset(TopDownDataset):
    def __init__(self, ann_file, img_prefix,
                 dataset_info='coco_wholebody', **kw):
        super().__init__(ann_file, img_prefix, dataset_info=dataset_info,
                         **kw)

    def _evaluate_map(self, results, res_folder=None, rle_score=False):
        detections = self._collect_detections(results, res_folder, rle_score)
        if 'annotations' not in self.coco.dataset:
            return OrderedDict()
        # the reference writes dt 'keypoints' = body slice only, so
        # xtcocotools.loadRes derives dt bbox/area from the BODY extent;
        # reproduce that by precomputing them here (loadRes keeps existing
        # fields).
        for det in detections:
            body = np.asarray(det['keypoints'][:17 * 3],
                              np.float64).reshape(-1, 3)
            xs, ys = body[:, 0], body[:, 1]
            det['bbox'] = [float(xs.min()), float(ys.min()),
                           float(xs.max() - xs.min()),
                           float(ys.max() - ys.min())]
            det['area'] = float((xs.max() - xs.min()) *
                                (ys.max() - ys.min()))
        coco_dt = self.coco.loadRes(detections)
        sigmas = np.asarray(self.sigmas, np.float64)
        stats = OrderedDict()
        for part, (s, e) in PART_CUTS.items():
            ev = CocoKeypointEval(self.coco, sigmas=sigmas[s:e],
                                  kpt_slice=(s, e))
            part_stats = ev.evaluate(coco_dt)
            if part == 'wholebody':
                stats.update(part_stats)      # headline, like the reference
            else:
                for k, v in part_stats.items():
                    stats[f'{part}/{k}'] = v
        return stats

"""Sub-JHMDB dataset: PCK (box-normalised) and tPCK (torso-normalised)
with the per-part table.

The port's own copy of vitpose_tpu/data/jhmdb.py (reference
`TopDownJhmdbDataset`, topdown_jhmdb_dataset.py:160-273): records load
through the COCO-format TopDownDataset (JHMDB clips boxes with w - 1 and
h - 1, as TopDownDataset does for it), and `evaluate` reports
Head/Sho/Elb/Wri/Hip/Knee/Ank and the mean PCK at 0.2 with the
reference's joint groups. The torso is the distance between joints 4 and
5 of the ground truth, or of the prediction where the ground truth's is
under one pixel. All host numpy.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .topdown import TopDownDataset
from ..ops.decode import keypoint_pck_accuracy

_PART_TABLE = (
    ('Head', lambda p: p[2]),
    ('Sho', lambda p: 0.5 * p[3] + 0.5 * p[4]),
    ('Elb', lambda p: 0.5 * p[7] + 0.5 * p[8]),
    ('Wri', lambda p: 0.5 * p[11] + 0.5 * p[12]),
    ('Hip', lambda p: 0.5 * p[5] + 0.5 * p[6]),
    ('Knee', lambda p: 0.5 * p[9] + 0.5 * p[10]),
    ('Ank', lambda p: 0.5 * p[13] + 0.5 * p[14]),
)


class JhmdbDataset(TopDownDataset):
    """Sub-JHMDB frames (COCO format) and their PCK and tPCK tables."""

    def __init__(self, ann_file, img_prefix, dataset_info='jhmdb', **kw):
        super().__init__(ann_file, img_prefix, dataset_info=dataset_info,
                         **kw)

    def evaluate(self, results, res_folder=None, metric='PCK',
                 pck_thr=0.2, **kw):
        """'PCK' (normalised by the box's longer side) and/or 'tPCK' (by the
        torso): per part and the mean, at `pck_thr`."""
        metrics = list(metric) if isinstance(metric, (list, tuple)) \
            else [metric]
        for m in metrics:
            if m not in ('PCK', 'tPCK'):
                raise KeyError(f'metric {m} is not supported')

        by_key = {}
        for result in results:
            preds = np.asarray(result['preds'])
            for i, (path, bid) in enumerate(zip(result['image_paths'],
                                                result['bbox_ids'])):
                by_key[(self._path_to_id(path), int(bid))] = preds[i]

        outputs, gts, masks, thr_bbox, thr_torso = [], [], [], [], []
        for rec in self.db:
            pred = by_key[(self._path_to_id(rec['image_file']),
                           int(rec['bbox_id']))]
            outputs.append(pred[:, :2])
            gts.append(rec['joints_3d'][:, :2])
            masks.append(rec['joints_3d_visible'][:, 0] > 0)
            t = np.max(rec['bbox'][2:4])
            thr_bbox.append([t, t])
            torso = np.linalg.norm(rec['joints_3d'][4, :2]
                                   - rec['joints_3d'][5, :2])
            if torso < 1:
                torso = np.linalg.norm(pred[4, :2] - pred[5, :2])
            thr_torso.append([torso, torso])
        outputs = np.asarray(outputs, np.float32)
        gts = np.asarray(gts, np.float32)
        masks = np.asarray(masks, bool)

        stats = OrderedDict()
        if 'PCK' in metrics:
            per, mean, _ = keypoint_pck_accuracy(
                outputs, gts, masks, pck_thr, np.asarray(thr_bbox))
            for name, fn in _PART_TABLE:
                stats[f'{name} PCK'] = float(fn(per))
            stats['Mean PCK'] = float(mean)
        if 'tPCK' in metrics:
            per, mean, _ = keypoint_pck_accuracy(
                outputs, gts, masks, pck_thr, np.asarray(thr_torso))
            for name, fn in _PART_TABLE:
                stats[f'{name} tPCK'] = float(fn(per))
            stats['Mean tPCK'] = float(mean)
        return stats

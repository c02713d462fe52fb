"""MPI-INF-3DHP 3D pose windows and the 3D PCK / AUC metrics.

The port's own copy of vitpose_tpu/data/mpi_inf_3dhp.py (reference
Body3DMpiInf3dhpDataset): H36M's npz sequence format with MPJPE, P-MPJPE,
3DPCK (150 mm) and 3DAUC (the mean PCK over 0..150 mm, 31 thresholds).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .body3d import Body3DH36MDataset, keypoint_mpjpe


def keypoint_3d_pck(pred, gt, mask, threshold=150.0):
    """Percentage of joints within `threshold` mm (3DPCK)."""
    err = np.linalg.norm(np.asarray(pred) - np.asarray(gt), axis=-1)
    m = np.asarray(mask, bool)
    return float(100.0 * (err[m] <= threshold).mean()) if m.any() else 0.0


def keypoint_3d_auc(pred, gt, mask):
    """AUC of 3DPCK over thresholds 0..150mm, 31 points (the standard
    MPI-INF-3DHP protocol)."""
    thrs = np.linspace(0.0, 150.0, 31)
    pcks = [keypoint_3d_pck(pred, gt, mask, t) for t in thrs]
    return float(np.mean(pcks))


class MpiInf3dhpDataset(Body3DH36MDataset):
    def evaluate(self, results, metric='3dpck'):
        metrics = metric if isinstance(metric, list) else [metric]
        preds, gts, masks = [], [], []
        for r in results:
            for p, ti in zip(np.asarray(r['preds']), r['target_idxs']):
                preds.append(p)
                gts.append(self.joints_3d[ti][..., :3])
                masks.append(self.joints_3d[ti][..., 3] > 0)
        preds, gts, masks = np.stack(preds), np.stack(gts), np.stack(masks)
        name_value = OrderedDict()
        for m in metrics:
            ml = m.lower()
            if ml == 'mpjpe':
                name_value['MPJPE'] = keypoint_mpjpe(preds, gts, masks)
            elif ml == 'p-mpjpe':
                name_value['P-MPJPE'] = keypoint_mpjpe(preds, gts, masks,
                                                       'procrustes')
            elif ml == '3dpck':
                name_value['3DPCK'] = keypoint_3d_pck(preds, gts, masks)
            elif ml == '3dauc':
                name_value['3DAUC'] = keypoint_3d_auc(preds, gts, masks)
            else:
                raise KeyError(m)
        return name_value

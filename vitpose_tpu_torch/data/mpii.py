"""MPII dataset (list-format json annotations + matlab PCKh evaluation)
and MPII-TRB.

The port's own copy of vitpose_tpu/data/mpii.py (`MpiiDataset`,
`MpiiTrbDataset`), counterpart of the reference `TopDownMpiiDataset`
(mmpose/datasets/datasets/top_down/topdown_mpii_dataset.py): records carry
center/scale directly (matlab 1-based, with the +15*scale center shift and
1.25 padding), and PCKh is evaluated against `mpii_gt_val.mat`
(dataset_joints / jnt_missing / pos_gt_src / headboxes_src) with
SC_BIAS=0.6 and threshold 0.5.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np

from .dataset_info import DatasetInfo


class MpiiDataset:
    def __init__(self, ann_file, img_prefix, dataset_info='mpii',
                 image_size=(192, 256), heatmap_size=(48, 64),
                 test_mode=False, dataset_idx=0, canvas_size=1280, **kw):
        self.info = (dataset_info if isinstance(dataset_info, DatasetInfo)
                     else DatasetInfo.load(dataset_info))
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.image_size = np.array(image_size)
        self.heatmap_size = np.array(heatmap_size)
        self.test_mode = test_mode
        self.dataset_idx = dataset_idx
        self.canvas_size = canvas_size   # MPII frames are up to 1280px wide
        self.db = self._load_db()

    @property
    def num_joints(self):
        return self.info.num_joints

    @property
    def sigmas(self):
        return None

    def __len__(self):
        return len(self.db)

    def _load_db(self):
        with open(self.ann_file) as f:
            anns = json.load(f)
        k = self.num_joints
        db = []
        for bbox_id, a in enumerate(anns):
            center = np.array(a['center'], np.float32)
            scale = np.array([a['scale'], a['scale']], np.float32)
            if center[0] != -1:
                center[1] = center[1] + 15 * scale[1]
                scale = scale * 1.25
            center = center - 1           # matlab 1-based -> 0-based
            joints = np.zeros((k, 3), np.float32)
            visible = np.zeros((k, 3), np.float32)
            if not self.test_mode:
                j = np.asarray(a['joints'], np.float32)
                v = np.asarray(a['joints_vis'], np.float32)
                joints[:, :2] = j[:, :2] - 1
                visible[:, :2] = v[:, None]
            db.append(dict(
                image_file=os.path.join(self.img_prefix, a['image']),
                bbox_id=bbox_id, center=center, scale=scale, rotation=0.0,
                joints_3d=joints, joints_3d_visible=visible,
                dataset=self.info.dataset_name,
                dataset_idx=self.dataset_idx, bbox_score=1.0,
                # synthesize a bbox for loader components that expect one
                bbox=np.array([center[0] - scale[0] * 100,
                               center[1] - scale[1] * 100,
                               scale[0] * 200, scale[1] * 200], np.float32),
            ))
        return db

    # ------------------------------------------------------------------
    def evaluate(self, results, res_folder=None, metric='PCKh'):
        """PCKh@0.5 against mpii_gt_val.mat (reference protocol)."""
        kpts = []
        for result in results:
            preds = np.asarray(result['preds'])
            for i, bid in enumerate(result['bbox_ids']):
                kpts.append(dict(keypoints=preds[i], bbox_id=bid))
        kpts.sort(key=lambda x: x['bbox_id'])
        seen = set()
        uniq = [x for x in kpts
                if not (x['bbox_id'] in seen or seen.add(x['bbox_id']))]
        preds = np.stack([x['keypoints'] for x in uniq])[..., :2] + 1.0

        gt_file = os.path.join(os.path.dirname(self.ann_file),
                               'mpii_gt_val.mat')
        if not os.path.exists(gt_file):
            raise FileNotFoundError(
                f'{gt_file} is required for the official MPII PCKh protocol')
        from scipy.io import loadmat
        gt = loadmat(gt_file)
        dataset_joints = gt['dataset_joints']
        jnt_missing = gt['jnt_missing']
        pos_gt_src = gt['pos_gt_src']
        headboxes_src = gt['headboxes_src']

        pos_pred_src = np.transpose(preds, [1, 2, 0])

        def jid(name):
            return np.where(dataset_joints == name)[1][0]

        sc_bias = 0.6
        threshold = 0.5
        jnt_visible = 1 - jnt_missing
        uv_err = np.linalg.norm(pos_pred_src - pos_gt_src, axis=1)
        headsizes = np.linalg.norm(
            headboxes_src[1] - headboxes_src[0], axis=0) * sc_bias
        scaled = uv_err / (headsizes * np.ones((len(uv_err), 1))) \
            * jnt_visible
        jnt_count = np.sum(jnt_visible, axis=1)
        pckh = 100.0 * np.sum((scaled <= threshold) * jnt_visible,
                              axis=1) / jnt_count

        pckh_m = np.ma.array(pckh, mask=False)
        pckh_m.mask[6:8] = True          # exclude pelvis/thorax
        jnt_count_m = np.ma.array(jnt_count, mask=False)
        jnt_count_m.mask[6:8] = True
        jnt_ratio = jnt_count_m / np.sum(jnt_count_m).astype(np.float64)
        pckh_01 = 100.0 * np.sum((scaled <= 0.1) * jnt_visible,
                                 axis=1) / jnt_count

        head, lsho, lelb = jid('head'), jid('lsho'), jid('lelb')
        lwri, lhip, lkne, lank = (jid('lwri'), jid('lhip'), jid('lkne'),
                                  jid('lank'))
        rsho, relb, rwri = jid('rsho'), jid('relb'), jid('rwri')
        rhip, rkne, rank = jid('rhip'), jid('rkne'), jid('rank')
        stats = OrderedDict([
            ('Head', pckh[head]),
            ('Shoulder', 0.5 * (pckh[lsho] + pckh[rsho])),
            ('Elbow', 0.5 * (pckh[lelb] + pckh[relb])),
            ('Wrist', 0.5 * (pckh[lwri] + pckh[rwri])),
            ('Hip', 0.5 * (pckh[lhip] + pckh[rhip])),
            ('Knee', 0.5 * (pckh[lkne] + pckh[rkne])),
            ('Ankle', 0.5 * (pckh[lank] + pckh[rank])),
            ('PCKh', float(np.sum(pckh_m * jnt_ratio))),
            ('PCKh@0.1', float(np.sum(pckh_01 * jnt_ratio))),
        ])
        return stats


class MpiiTrbDataset:
    """MPII-TRB: 40-keypoint triplet representation (14 skeleton + 26
    contour joints). Counterpart of the reference `TopDownMpiiTrbDataset`
    (mmpose/datasets/datasets/top_down/topdown_mpii_trb_dataset.py:40):
    records come from a COCO-format json but with the TRB conventions —
    ``center`` used as-is, ``scale = image_size / ann['scale'] / 200``,
    ``bbox_id = ann['id']`` (db sorted by it), annotations with all-zero
    keypoints skipped, optional ``headbox`` carried for evaluation
    (…:113-166). ``evaluate`` implements the TRB PCKh protocol: a joint is
    a hit when the prediction lies within ``0.3 * ||headbox diagonal||``
    of GT, reported as Skeleton_acc (first 14 joints) / Contour_acc
    (rest) / overall PCKh (…:168-300)."""

    def __init__(self, ann_file, img_prefix, dataset_info='mpii_trb',
                 image_size=(256, 256), heatmap_size=(64, 64),
                 test_mode=False, dataset_idx=0, canvas_size=1280, **kw):
        self.info = (dataset_info if isinstance(dataset_info, DatasetInfo)
                     else DatasetInfo.load(dataset_info))
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.image_size = np.array(image_size)
        self.heatmap_size = np.array(heatmap_size)
        self.test_mode = test_mode
        self.dataset_idx = dataset_idx
        self.canvas_size = canvas_size
        self.db = self._load_db()

    @property
    def num_joints(self):
        return self.info.num_joints

    @property
    def sigmas(self):
        return None

    def __len__(self):
        return len(self.db)

    def _load_db(self):
        with open(self.ann_file) as f:
            data = json.load(f)
        id2name = {im['id']: im['file_name'] for im in data['images']}
        k = self.num_joints
        db = []
        for ann in data['annotations']:
            if 'keypoints' not in ann or max(ann['keypoints']) == 0:
                continue
            kp = np.asarray(ann['keypoints'], np.float32).reshape(-1, 3)
            joints = np.zeros((k, 3), np.float32)
            visible = np.zeros((k, 3), np.float32)
            n = min(k, len(kp))
            joints[:n, :2] = kp[:n, :2]
            visible[:n, :2] = np.minimum(1, kp[:n, 2:3])
            center = np.asarray(ann['center'], np.float32)
            scale = np.asarray(self.image_size / float(ann['scale']) / 200.0,
                               np.float32)
            rec = dict(
                image_file=os.path.join(self.img_prefix,
                                        id2name[ann['image_id']]),
                center=center, scale=scale, rotation=0.0,
                joints_3d=joints, joints_3d_visible=visible,
                dataset=self.info.dataset_name,
                dataset_idx=self.dataset_idx, bbox_score=1.0,
                bbox_id=int(ann['id']),
                # synthesized xywh for loader components that expect one
                bbox=np.array([center[0] - scale[0] * 100,
                               center[1] - scale[1] * 100,
                               scale[0] * 200, scale[1] * 200], np.float32),
            )
            if 'headbox' in ann:
                rec['headbox'] = np.asarray(ann['headbox'], np.float32)
            db.append(rec)
        db.sort(key=lambda r: r['bbox_id'])
        return db

    def evaluate(self, results, res_folder=None, metric='PCKh', **kw):
        metrics = (list(metric) if isinstance(metric, (list, tuple))
                   else [metric])
        for m in metrics:
            if m != 'PCKh':
                raise KeyError(f'metric {m} is not supported')
        by_key = {}
        for result in results:
            preds = np.asarray(result['preds'])
            for i, (path, bid) in enumerate(zip(result['image_paths'],
                                                result['bbox_ids'])):
                by_key[(path, int(bid))] = preds[i]
        k = self.num_joints
        hit = np.zeros(k, np.float32)
        exist = np.zeros(k, np.float32)
        for rec in self.db:
            pred = by_key[(rec['image_file'], int(rec['bbox_id']))]
            headbox = np.asarray(rec['headbox'], np.float32)
            thr = np.linalg.norm(headbox[:2] - headbox[2:]) * 0.3
            vis = rec['joints_3d_visible'][:, 0] > 0
            dist = np.linalg.norm(
                np.asarray(pred)[:, :2] - rec['joints_3d'][:, :2], axis=1)
            hit += ((dist < thr) & vis).astype(np.float32)
            exist += vis.astype(np.float32)
        return OrderedDict([
            ('Skeleton_acc', float(np.sum(hit[:14]) / np.sum(exist[:14]))),
            ('Contour_acc', float(np.sum(hit[14:]) / np.sum(exist[14:]))),
            ('PCKh', float(np.sum(hit) / np.sum(exist))),
        ])

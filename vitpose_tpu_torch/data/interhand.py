"""InterHand2.6M 3D interacting-hand dataset, host numpy.

The port's own copy of vitpose_tpu/data/interhand.py (`InterHandDataset`
and its `evaluate` :124, `generate_rel_root_depth_target` :207,
`training_targets` :218; reference interhand3d_dataset.py): the annotation
json references each image's capture, camera and frame; the joint file's
world joints go through the capture's extrinsics (campos/camrot) and
intrinsics (focal/princpt) into 2.5D records (pixel x, y and depth relative
to each hand's wrist), with the hand type and the wrists' absolute depths.
Metrics: MPJPE, MRRPE (the left root relative to the right), Handedness_acc
and the AUC of PCK over 0-50 mm.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict

import numpy as np

from .coco_index import CocoIndex
from .dataset_info import DatasetInfo

R_WRIST, L_WRIST = 20, 41          # right/left hand roots (42-joint layout)


def world2cam(pts_world, rot, pos):
    """[K, 3] world -> camera coords with campos/camrot convention."""
    return (np.asarray(rot) @ (pts_world - np.asarray(pos)).T).T


def cam2pixel(pts_cam, focal, princpt):
    xy = pts_cam[:, :2] / pts_cam[:, 2:] * np.asarray(focal) \
        + np.asarray(princpt)
    return np.concatenate([xy, pts_cam[:, 2:]], axis=1)


def encode_handtype(ht):
    return {'right': np.array([1, 0], np.float32),
            'left': np.array([0, 1], np.float32),
            'interacting': np.array([1, 1], np.float32)}[ht]


class InterHandDataset:
    def __init__(self, ann_file, camera_file, joint_file, img_prefix='',
                 dataset_info='interhand3d', test_mode=False):
        self.info = (dataset_info if isinstance(dataset_info, DatasetInfo)
                     else DatasetInfo.load(dataset_info))
        self.coco = CocoIndex(ann_file)
        with open(camera_file) as f:
            self.cameras = json.load(f)
        with open(joint_file) as f:
            self.joints = json.load(f)
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.db = self._load_db()

    @property
    def num_joints(self):
        return self.info.num_joints

    def __len__(self):
        return len(self.db)

    def _load_db(self):
        k = self.num_joints
        db = []
        for img_id in self.coco.getImgIds():
            img = self.coco.imgs[img_id]
            anns = self.coco.loadAnns(self.coco.getAnnIds(imgIds=img_id))
            if not anns:
                continue
            # contiguous over KEPT records (enumerating getImgIds would
            # leave holes at ann-less images and misalign evaluate's
            # bbox_id -> record lookup)
            bbox_id = len(db)
            ann = anns[0]
            cap = str(img['capture'])
            cam = str(img['camera'])
            frame = str(img['frame_idx'])
            c = self.cameras[cap]
            pos = np.asarray(c['campos'][cam], np.float32)
            rot = np.asarray(c['camrot'][cam], np.float32)
            focal = np.asarray(c['focal'][cam], np.float32)
            princpt = np.asarray(c['princpt'][cam], np.float32)
            world = np.asarray(self.joints[cap][frame]['world_coord'],
                               np.float32)
            cam_pts = world2cam(world, rot, pos)
            pix = cam2pixel(cam_pts, focal, princpt)

            valid = np.asarray(ann['joint_valid'], np.float32).flatten()
            # root-invalid hands invalidate all their joints
            rel_root_valid = valid[R_WRIST] * valid[L_WRIST]
            valid[:R_WRIST] *= valid[R_WRIST]
            valid[R_WRIST + 1:] *= valid[L_WRIST]

            joints = np.zeros((k, 3), np.float32)
            joints[:, :2] = pix[:, :2]
            joints[:21, 2] = cam_pts[:21, 2] - cam_pts[R_WRIST, 2]
            joints[21:, 2] = cam_pts[21:, 2] - cam_pts[L_WRIST, 2]
            visible = np.minimum(1, valid.reshape(-1, 1)) * np.ones(
                (1, 3), np.float32)

            db.append(dict(
                image_file=os.path.join(self.img_prefix, img['file_name']),
                bbox=np.asarray(ann['bbox'], np.float32),
                rotation=0.0,
                joints_3d=joints,
                joints_3d_visible=visible,
                joints_cam=cam_pts,
                hand_type=encode_handtype(ann['hand_type']),
                hand_type_valid=float(ann['hand_type_valid']),
                rel_root_depth=float(cam_pts[L_WRIST, 2]
                                     - cam_pts[R_WRIST, 2]),
                rel_root_valid=rel_root_valid,
                abs_depth=(float(cam_pts[R_WRIST, 2]),
                           float(cam_pts[L_WRIST, 2])),
                focal=focal, princpt=princpt,
                bbox_score=1.0, bbox_id=bbox_id,
                dataset=self.info.dataset_name,
            ))
        return db

    # ------------------------------------------------------------------
    def evaluate(self, results, metric='MPJPE'):
        """results: list of dicts with preds [N, K, 3] (camera-space mm,
        root-relative per hand), hand_type [N, 2] probs, bbox_ids;
        MRRPE additionally needs keypoints_px [N, K, 3] (pixel-space
        decode output) and rel_root_depth [N] (predicted mm).
        Metrics: MPJPE | MRRPE | Handedness_acc | AUC (PCK 0..50mm).
        """
        metrics = metric if isinstance(metric, list) else [metric]
        preds, hand_types, ids = [], [], []
        preds_px, rel_roots = [], []
        for r in results:
            preds.extend(np.asarray(r['preds']))
            if 'hand_type' in r:
                hand_types.extend(np.asarray(r['hand_type']))
            if 'keypoints_px' in r:
                preds_px.extend(np.asarray(r['keypoints_px']))
                rel_roots.extend(np.asarray(r['rel_root_depth']))
            ids.extend(r['bbox_ids'])
        stats = OrderedDict()
        by_id = {g['bbox_id']: g for g in self.db}
        gts = [by_id[i] for i in ids]

        errs = []
        for p, g in zip(preds, gts):
            gt_rel_cam = g['joints_cam'].copy()
            gt_rel_cam[:21] -= gt_rel_cam[R_WRIST]
            gt_rel_cam[21:] -= gt_rel_cam[L_WRIST]
            m = g['joints_3d_visible'][:, 0] > 0
            if m.any():
                errs.append(np.linalg.norm(
                    (np.asarray(p) - gt_rel_cam)[m], axis=-1))
        all_err = np.concatenate(errs) if errs else np.zeros(1)
        if 'MPJPE' in metrics:
            stats['MPJPE'] = float(all_err.mean())
        if 'AUC' in metrics:
            thrs = np.linspace(0, 50, 101)
            pck = [(all_err <= t).mean() for t in thrs]
            stats['AUC'] = float(np.mean(pck))
        if 'Handedness_acc' in metrics and hand_types:
            correct, total = 0, 0
            for ht, g in zip(hand_types, gts):
                if g['hand_type_valid'] > 0:
                    total += 1
                    correct += int(((np.asarray(ht) > 0.5)
                                    == (g['hand_type'] > 0.5)).all())
            stats['Handedness_acc'] = correct / max(total, 1)
        if 'MRRPE' in metrics:
            if not preds_px:
                raise KeyError(
                    'metric MRRPE needs keypoints_px + rel_root_depth in '
                    'results (the pixel-space decode output; reference '
                    'interhand3d_dataset.py:313 requires rel_root_depth '
                    'the same way)')

            def pixel2cam(pix, focal, princpt):
                z = pix[..., 2]
                x = (pix[..., 0] - princpt[0]) / focal[0] * z
                y = (pix[..., 1] - princpt[1]) / focal[1] * z
                return np.stack([x, y, z], axis=-1)

            # reference MRRPE (interhand3d_dataset.py:404-431): 3D error
            # of the predicted left-root position relative to the right
            # root, using the predicted rel_root_depth, over interacting
            # samples with both wrists visible
            rr = []
            for px, rel, g in zip(preds_px, rel_roots, gts):
                ht = np.asarray(g['hand_type'])
                vis = g['joints_3d_visible'][:, 0]
                if not (ht.all() and vis[R_WRIST] > 0 and vis[L_WRIST] > 0):
                    continue
                left_img = np.asarray(px[L_WRIST], np.float64).copy()
                left_img[2] += g['abs_depth'][0] + float(rel)
                right_img = np.asarray(px[R_WRIST], np.float64).copy()
                right_img[2] += g['abs_depth'][0]
                left_cam = pixel2cam(left_img, g['focal'], g['princpt'])
                right_cam = pixel2cam(right_img, g['focal'], g['princpt'])
                gt_vec = g['joints_cam'][L_WRIST] - g['joints_cam'][R_WRIST]
                rr.append(np.linalg.norm(
                    (left_cam - right_cam) - gt_vec))
            stats['MRRPE'] = float(np.mean(rr)) if rr else -1.0
        return stats


def generate_rel_root_depth_target(rel_root_depth, rel_root_valid,
                                   depth_bins, root_depth_bound):
    """Relative-root-depth training target in bin units (reference
    hand_transform.py:41 `HandGenerateRelDepthTarget`): mm -> [0, D] with
    a zero weight when the target falls outside the bin range."""
    target = (rel_root_depth / root_depth_bound + 0.5) * depth_bins
    weight = rel_root_valid * (target >= 0) * (target <= depth_bins)
    return (np.float32(target) * np.ones(1, np.float32),
            np.float32(weight) * np.ones(1, np.float32))


def training_targets(rec, image_size=(256, 256), heatmap_size=(64, 64, 64),
                     depth_bound=400.0, root_depth_bins=64,
                     root_depth_bound=400.0, sigma=2.5):
    """One record's InterHand3D training targets (the reference
    res50_interhand3d_all_256x256.py pipeline: Generate3DHeatmapTarget,
    HandGenerateRelDepthTarget and the hand type, for
    `models.interhand3d.interhand3d_losses`).

    Returns dict(hm3d [K, D, H, W], hm_weight [K, 1], rel_root_target [1]
    (bin units), rel_root_weight [1], rel_root_depth_mm [1] (what
    `interhand3d_losses` consumes — it recomputes the bin target and the
    range window internally), hand_type [2], hand_type_weight [1]).
    """
    from ..ops.target import generate_3d_heatmaps
    hm3d, hm_w = generate_3d_heatmaps(
        rec['joints_3d'], rec['joints_3d_visible'], image_size,
        heatmap_size, depth_bound, sigma=sigma)
    root_t, root_w = generate_rel_root_depth_target(
        rec['rel_root_depth'], rec['rel_root_valid'], root_depth_bins,
        root_depth_bound)
    return dict(hm3d=hm3d, hm_weight=hm_w,
                rel_root_target=root_t, rel_root_weight=root_w,
                rel_root_depth_mm=np.float32(rec['rel_root_depth'])
                * np.ones(1, np.float32),
                hand_type=np.asarray(rec['hand_type'], np.float32),
                hand_type_weight=np.float32(rec['hand_type_valid'])
                * np.ones(1, np.float32))

"""CMU Panoptic multiview 3D dataset, host numpy.

The port's own copy of vitpose_tpu/data/panoptic_mview.py (reference
Body3DMviewDirectPanopticDataset): per-frame multi-person coco19 bodies and
per-camera calibration (each body cut to its first `num_joints`, as mmpose
reads them); Panoptic's world (cm, y down) goes through `M_CONV`
to the voxel pipeline's z-up millimetres. Frames carry `SimpleCamera`s
(with their sensor resolution); `evaluate` scores each prediction by its
smallest MPJPE to a GT person of its frame and matches by score: recall
and MPJPE at 500 mm, AP and AR at 25-150 mm.
"""
from __future__ import annotations

import glob
import json
import os
from collections import OrderedDict

import numpy as np

from ..ops.camera import SimpleCamera

# panoptic world (cm, y-down) -> pipeline world (mm-ish, z-up)
M_CONV = np.array([[1.0, 0.0, 0.0],
                   [0.0, 0.0, -1.0],
                   [0.0, 1.0, 0.0]])


class PanopticMviewDataset:
    def __init__(self, seq_dirs, cam_names=None, num_joints=19,
                 coord_scale=10.0):
        """seq_dirs: list of panoptic sequence dirs (each containing
        hdPose3d_stage1_coco19/ + calibration_*.json).
        cam_names: restrict to these camera names (default: all hd/vga)."""
        self.num_joints = num_joints
        self.coord_scale = coord_scale
        self.frames = []
        self.cameras = {}
        for seq in seq_dirs:
            calib_files = glob.glob(os.path.join(seq, 'calibration_*.json'))
            cams = []
            if calib_files:
                with open(calib_files[0]) as f:
                    calib = json.load(f)
                for cam in calib['cameras']:
                    if cam_names and cam['name'] not in cam_names:
                        continue
                    cams.append(self._make_camera(cam))
            self.cameras[seq] = cams
            for pose_file in sorted(glob.glob(os.path.join(
                    seq, 'hdPose3d_stage1_coco19', '*.json'))):
                self.frames.append((seq, pose_file))

    def _make_camera(self, cam):
        k_mat = np.asarray(cam['K'], np.float64)
        r = np.asarray(cam['R'], np.float64)
        t = np.asarray(cam['t'], np.float64).reshape(3)
        # panoptic extrinsics: X_cam = R @ X_world + t (world in cm, y-down)
        # convert to our convention: world' = M @ world * scale
        r_w2c = r @ M_CONV.T
        # camera position in converted world coords
        pos = -(M_CONV @ r.T @ t) * self.coord_scale
        param = dict(
            R=r_w2c.T,                         # camera-to-world rotation
            T=pos.reshape(3, 1),
            K=k_mat[:2, :3],
            k=np.asarray(cam.get('distCoef', [0] * 5))[[0, 1, 4]],
            p=np.asarray(cam.get('distCoef', [0] * 5))[[2, 3]],
        )
        out = SimpleCamera(param)
        # sensor resolution (w, h) from the calibration — the voxelpose
        # pipeline rescales intrinsics to heatmap pixels with it
        out.resolution = tuple(cam.get('resolution', (1920, 1080)))
        return out

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        seq, pose_file = self.frames[idx]
        with open(pose_file) as f:
            scene = json.load(f)
        people = []
        for body in scene.get('bodies', []):
            # the first num_joints of coco19, as mmpose reads them (JAX's
            # copy keeps all 19, which its 15-joint pose net cannot take)
            j = np.asarray(body['joints19'], np.float64).reshape(
                -1, 4)[:self.num_joints]
            xyz = (M_CONV @ j[:, :3].T).T * self.coord_scale
            people.append(dict(id=body['id'],
                               joints_3d=xyz.astype(np.float32),
                               joints_vis=(j[:, 3] > 0.1).astype(
                                   np.float32)))
        return dict(sequence=seq, pose_file=pose_file, people=people,
                    cameras=self.cameras[seq])

    # ------------------------------------------------------------------
    def evaluate(self, results, metric='mpjpe', mpjpe_threshold=500.0):
        """The reference VoxelPose panoptic protocol
        (body3d_mview_direct_panoptic_dataset.py:300-470).

        results: list over frames of lists of (joints_3d [K, 3], score).
        Every prediction is scored by its min MPJPE (over visible joints)
        against any GT person of its frame; matching is then score-ranked
        greedy, one detection per GT.

        metric='mpjpe' -> RECALL 500mm / MPJPE 500mm;
        metric='mAP'   -> AP/AR at thresholds 25..150mm (step 25) + means.
        """
        metrics = metric if isinstance(metric, (list, tuple)) else [metric]
        eval_list, total_gt = [], 0
        for idx, frame_preds in enumerate(results):
            gt = self[idx]['people']
            gt_people = [(p['joints_3d'], p['joints_vis'] > 0)
                         for p in gt if (p['joints_vis'] > 0).any()]
            if not gt_people:
                continue
            for pred_joints, score in frame_preds:
                pred = np.asarray(pred_joints, np.float64)
                mpjpes = [np.linalg.norm((pred[:len(vis)] - gt3d)[vis],
                                         axis=-1).mean()
                          for gt3d, vis in gt_people]
                min_gt = int(np.argmin(mpjpes))
                eval_list.append(dict(mpjpe=float(np.min(mpjpes)),
                                      score=float(score),
                                      gt_id=total_gt + min_gt))
            total_gt += len(gt_people)

        out = []
        for m in metrics:
            if m == 'mpjpe':
                out.append(('RECALL 500mm', self._recall(
                    eval_list, total_gt, mpjpe_threshold)))
                out.append(('MPJPE 500mm', self._matched_mpjpe(
                    eval_list, mpjpe_threshold)))
            elif m == 'mAP':
                thresholds = np.arange(25, 155, 25)
                aps, ars = zip(*[self._ap(eval_list, total_gt, t)
                                 for t in thresholds])
                for t, ap in zip(thresholds, aps):
                    out.append((f'AP {t}', ap))
                out.append(('mAP', float(np.mean(aps))))
                for t, ar in zip(thresholds, ars):
                    out.append((f'AR {t}', ar))
                out.append(('mAR', float(np.mean(ars))))
            else:
                raise ValueError(f'unsupported metric {m!r}; '
                                 "expected 'mpjpe' or 'mAP'")
        return OrderedDict(out)

    @staticmethod
    def _ap(eval_list, total_gt, threshold):
        """Score-ranked AP/AR with the reference's precision envelope."""
        ranked = sorted(eval_list, key=lambda e: -e['score'])
        tp = np.zeros(len(ranked))
        seen = set()
        for i, item in enumerate(ranked):
            if item['mpjpe'] < threshold and item['gt_id'] not in seen:
                tp[i] = 1
                seen.add(item['gt_id'])
        tpc = np.cumsum(tp)
        fpc = np.cumsum(1 - tp)
        recall = tpc / (total_gt + 1e-5)
        precision = tpc / (tpc + fpc + 1e-5)
        precision = np.maximum.accumulate(precision[::-1])[::-1]
        precision = np.concatenate(([0.0], precision, [0.0]))
        recall = np.concatenate(([0.0], recall, [1.0]))
        step = np.where(recall[1:] != recall[:-1])[0]
        ap = float(np.sum((recall[step + 1] - recall[step])
                          * precision[step + 1]))
        return ap, float(recall[-2]) if len(recall) > 1 else 0.0

    @staticmethod
    def _matched_mpjpe(eval_list, threshold=500.0):
        ranked = sorted(eval_list, key=lambda e: -e['score'])
        seen, errs = set(), []
        for item in ranked:
            if item['mpjpe'] < threshold and item['gt_id'] not in seen:
                errs.append(item['mpjpe'])
                seen.add(item['gt_id'])
        return float(np.mean(errs)) if errs else np.inf

    @staticmethod
    def _recall(eval_list, total_gt, threshold=500.0):
        ids = {e['gt_id'] for e in eval_list if e['mpjpe'] < threshold}
        return len(ids) / max(total_gt, 1)

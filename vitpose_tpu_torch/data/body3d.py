"""Human3.6M-style 3D pose windows and the MPJPE metrics, host numpy.

The port's own copy of vitpose_tpu/data/body3d.py (reference
Body3DH36MDataset, body3d_h36m_dataset.py, and `keypoint_mpjpe`): the npz
annotation format (imgname/center/scale/part[2D]/S[3D]), fixed-length
windows per target frame within each video sequence (causal or centred,
`seq_frame_interval` apart, clipped at the sequence's ends), detected 2D
keypoints in place of the GT's, the cameras' sizes and intrinsics
(`normalize_2d`, `normalized_intrinsics`), MPJPE / P-MPJPE (Procrustes) /
N-MPJPE (scale); `Body3DSemiSupervisionDataset`, `load_joint_normalize`
and `flip_relative_pose`.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict, defaultdict

import numpy as np


def procrustes_align(pred, gt):
    """Similarity-transform-align pred [K,3] to gt [K,3] (umeyama)."""
    mu_p, mu_g = pred.mean(0), gt.mean(0)
    p, g = pred - mu_p, gt - mu_g
    cov = g.T @ p / len(p)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    D = np.diag([1.0, 1.0, d])
    r = u @ D @ vt
    var_p = (p ** 2).sum() / len(p)
    scale = np.trace(np.diag(s) @ D) / var_p
    t = mu_g - scale * (r @ mu_p)
    return scale * pred @ r.T + t


def keypoint_mpjpe(pred, gt, mask, alignment='none'):
    """Mean per-joint position error over visible joints.

    alignment: 'none' | 'procrustes' (P-MPJPE) | 'scale' (N-MPJPE).
    pred/gt [N, K, 3], mask [N, K] bool.
    """
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    errs = []
    for p, g, m in zip(pred, gt, np.asarray(mask, bool)):
        if not m.any():
            continue
        if alignment == 'procrustes':
            p = procrustes_align(p, g)
        elif alignment == 'scale':
            denom = (p * p).sum()
            a = (p * g).sum() / denom if denom > 0 else 1.0
            p = a * p
        errs.append(np.linalg.norm((p - g)[m], axis=-1).mean())
    return float(np.mean(errs)) if errs else 0.0


def _seq_name(imgname):
    """'S1_Directions_1.54138969_000001.jpg' -> subject+action+camera key."""
    base = os.path.basename(imgname)
    return re.sub(r'_\d+\.(jpg|png)$', '', base)


def _subject_camera(imgname):
    """'S1_Directions_1.54138969_000001.jpg' -> ('S1', '54138969')
    (the key layout of the H36M cameras.pkl shipped with the reference)."""
    base = os.path.basename(str(imgname))
    subj = base.split('_', 1)[0]
    m = re.search(r'\.(\d+)_', base)
    return subj, (m.group(1) if m else None)


def normalize_screen_coordinates(pts, w, h):
    """Reference ImageCoordinateNormalization (pose3d_transform.py:125):
    map [0, w] -> [-1, 1] preserving aspect ratio: (x - [w/2, h/2]) / (w/2)."""
    pts = np.asarray(pts, np.float32)
    center = np.array([0.5 * w, 0.5 * h], np.float32)
    return (pts - center) / np.float32(0.5 * w)


def load_joint_normalize(cfg_entry):
    """Mean/std for NormalizeJointCoordinate (pose3d_transform.py:61):
    inline arrays or a stats .pkl ({'mean','std'}, the
    joint3d_rel_stats.pkl / joint2d_stats.pkl files the reference
    simplebaseline3d configs quote). Returns (mean, std) or None."""
    if not cfg_entry:
        return None
    if 'stats_file' in cfg_entry:
        import pickle
        with open(cfg_entry['stats_file'], 'rb') as f:
            d = pickle.load(f)
        return (np.asarray(d['mean'], np.float32),
                np.asarray(d['std'], np.float32))
    return (np.asarray(cfg_entry['mean'], np.float32),
            np.asarray(cfg_entry['std'], np.float32))


def flip_relative_pose(pose, flip_pairs, center_x=0.0):
    """Reference RelativeJointRandomFlip (pose3d_transform.py:229):
    mirror x around `center_x` and swap left/right joints. pose [..., K, D]."""
    out = np.asarray(pose, np.float32).copy()
    out[..., 0] = 2.0 * center_x - out[..., 0]
    idx = np.arange(out.shape[-2])
    for a, b in flip_pairs:
        idx[a], idx[b] = b, a
    return out[..., idx, :]


class Body3DH36MDataset:
    def __init__(self, ann_file, img_prefix='', seq_len=27,
                 seq_frame_interval=1, causal=False, det_file=None,
                 test_mode=False, camera_param_file=None):
        data = np.load(ann_file, allow_pickle=True)
        self.imgnames = data['imgname']
        self.centers = np.asarray(data['center'], np.float32)
        self.scales = np.asarray(data['scale'], np.float32)
        self.joints_2d = np.asarray(data['part'], np.float32)   # [N, K, 3]
        self.joints_3d = np.asarray(data['S'], np.float32)      # [N, K, 4]
        if det_file:
            det = np.load(det_file)
            self.joints_2d = np.asarray(det, np.float32)[:, :, :3]
        self.img_prefix = img_prefix
        self.seq_len = seq_len
        self.interval = seq_frame_interval
        self.causal = causal
        self.test_mode = test_mode
        self.num_joints = self.joints_2d.shape[1]
        self._load_cameras(camera_param_file)
        self.sample_indices = self._build_sequences()

    def _load_cameras(self, camera_param_file):
        """Per-frame camera w/h + intrinsics from the reference's
        cameras.pkl ({(subject, cam_id): {f, c, k, p, w, h, ...}},
        body3d_h36m_dataset.py:124 load_camera). Frames without a camera
        fall back to the nominal H36M 1000x1000 sensor."""
        n = len(self.imgnames)
        self.cam_wh = np.full((n, 2), 1000.0, np.float32)
        # raw intrinsics [f(2), c(2), k(3), p(2)] per frame (the layout of
        # the reference CollectCameraIntrinsics, pose3d_transform.py:185)
        self.cam_intr = None
        if not camera_param_file:
            return
        import pickle
        with open(camera_param_file, 'rb') as f:
            cams = pickle.load(f)
        self.cam_intr = np.zeros((n, 9), np.float32)
        self.cam_intr[:, :2] = 1000.0      # nominal focal fallback
        self.cam_intr[:, 2:4] = 500.0
        for i, name in enumerate(self.imgnames):
            cam = cams.get(_subject_camera(name))
            if cam is None:
                continue
            self.cam_wh[i] = (float(cam['w']), float(cam['h']))
            self.cam_intr[i] = np.concatenate([
                np.asarray(cam['f'], np.float32).ravel(),
                np.asarray(cam['c'], np.float32).ravel(),
                np.asarray(cam.get('k', np.zeros(3)), np.float32).ravel(),
                np.asarray(cam.get('p', np.zeros(2)), np.float32).ravel()])

    def normalize_2d(self, pts, frame_idx):
        """ImageCoordinateNormalization with the frame's camera size."""
        w, h = self.cam_wh[int(frame_idx)]
        return normalize_screen_coordinates(pts, w, h)

    def normalized_intrinsics(self, frame_idx):
        """Intrinsics in normalized image coordinates (reference
        ImageCoordinateNormalization(norm_camera=True),
        pose3d_transform.py:167-176): f/=w/2, c=(c-center)/(w/2)."""
        i = int(frame_idx)
        if self.cam_intr is None:
            intr = np.array([1000., 1000., 500., 500., 0, 0, 0, 0, 0],
                            np.float32)
        else:
            intr = self.cam_intr[i].copy()
        w, h = self.cam_wh[i]
        s = np.float32(0.5 * w)
        intr[0:2] /= s
        intr[2:4] = (intr[2:4] - np.array([0.5 * w, 0.5 * h],
                                          np.float32)) / s
        return intr

    def _build_sequences(self):
        """Per target frame, a padded window of frame indices from the same
        video (parity: body3d_h36m_dataset.py:184-205)."""
        by_seq = defaultdict(list)
        for i, name in enumerate(self.imgnames):
            by_seq[_seq_name(str(name))].append(i)
        samples = []
        for _, idxs in sorted(by_seq.items()):
            idxs = np.asarray(idxs)
            n = len(idxs)
            for t in range(n):
                if self.causal:
                    left, right = self.seq_len - 1, 0
                else:
                    left = (self.seq_len - 1) // 2
                    right = self.seq_len - 1 - left
                window = []
                for off in range(-left, right + 1):
                    j = int(np.clip(t + off * self.interval, 0, n - 1))
                    window.append(int(idxs[j]))
                samples.append(window)
        return samples

    def __len__(self):
        return len(self.sample_indices)

    def __getitem__(self, idx):
        window = self.sample_indices[idx]
        target = window[-1] if self.causal else window[len(window) // 2]
        return dict(
            input_2d=self.joints_2d[window][..., :2],          # [T, K, 2]
            input_2d_visible=self.joints_2d[window][..., 2],
            target_3d=self.joints_3d[target][..., :3],         # [K, 3]
            target_3d_visible=self.joints_3d[target][..., 3],
            target_image_path=os.path.join(self.img_prefix,
                                           str(self.imgnames[target])),
            target_idx=target,
        )

    def evaluate(self, results, metric='mpjpe'):
        """results: list of dicts with preds [M, K, 3] and target_idxs
        (list). Metrics: mpjpe | p-mpjpe | n-mpjpe."""
        metrics = metric if isinstance(metric, list) else [metric]
        preds, gts, masks = [], [], []
        for r in results:
            for p, ti in zip(np.asarray(r['preds']), r['target_idxs']):
                preds.append(p)
                gts.append(self.joints_3d[ti][..., :3])
                masks.append(self.joints_3d[ti][..., 3] > 0)
        preds, gts = np.stack(preds), np.stack(gts)
        masks = np.stack(masks)
        name_value = OrderedDict()
        for m in metrics:
            align = {'mpjpe': 'none', 'p-mpjpe': 'procrustes',
                     'n-mpjpe': 'scale'}[m.lower()]
            name_value[m.upper()] = keypoint_mpjpe(preds, gts, masks,
                                                   alignment=align)
        return name_value


class Body3DSemiSupervisionDataset:
    """Combine a labeled and an unlabeled 3D pose dataset for
    semi-supervised lifting (reference Body3DSemiSupervisionDataset,
    body3d_semi_supervision_dataset.py:9-41): iterates the unlabeled
    dataset and pairs each item with a randomly drawn labeled sample,
    returning one merged dict whose unlabeled keys are prefixed
    ``unlabeled_`` (the reference achieves the same renaming in its
    pipeline via RenameKeys; here it is part of the wrapper so the
    merged dict never collides). Deterministic given ``(seed, epoch)``;
    call ``set_epoch`` each epoch so the pairing is re-drawn (the
    reference redraws np.random per access — fresh pairs every epoch)."""

    def __init__(self, labeled_dataset, unlabeled_dataset, seed=0):
        self.labeled = labeled_dataset
        self.unlabeled = unlabeled_dataset
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.unlabeled)

    def __getitem__(self, i):
        data = {'unlabeled_' + k: v for k, v in self.unlabeled[i].items()}
        rng = np.random.RandomState(
            (self.seed * 1000003 + self.epoch * 7919 + i) % (2 ** 31))
        data.update(self.labeled[rng.randint(0, len(self.labeled))])
        return data

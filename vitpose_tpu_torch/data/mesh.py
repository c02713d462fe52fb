"""Mesh (SMPL) training data: datasets, SMPL-consistent transforms, the
adversarial loader; host numpy and cv2.

The port's own copy of vitpose_tpu/data/mesh.py (reference
datasets/mesh/*.py and pipelines/mesh_transform.py): npz record sets with
SMPL pose and shape and 24-joint 2D/3D keypoints (`MeshDataset`, its
joint_error evaluation), the Mosh prior (`MoshDataset`), the weighted
mixture (`MeshMixDataset`), the flips and rotations that keep the SMPL
parameters consistent with the image, the DensePose IUV maps (`load_iuv`,
`flip_iuv`, `iuv_to_arrays`), and `MeshAdvLoader`, whose batches
(imgs, joints, pose, beta, real_pose, real_shape) feed
`models.mesh.adversarial_step`; the same RandomState draws as JAX's.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

# 24-joint SMPL flip pairs (reference mesh_base_dataset.py:56)
MESH_FLIP_PAIRS = ((0, 5), (1, 4), (2, 3), (6, 11), (7, 10), (8, 9),
                   (20, 21), (22, 23))

# SMPL pose left/right parameter permutation
# (reference mesh_transform.py:12 _flip_smpl_pose)
_FLIPPED_PARTS = [
    0, 1, 2, 6, 7, 8, 3, 4, 5, 9, 10, 11, 15, 16, 17, 12, 13, 14, 18, 19,
    20, 24, 25, 26, 21, 22, 23, 27, 28, 29, 33, 34, 35, 30, 31, 32, 36, 37,
    38, 42, 43, 44, 39, 40, 41, 45, 46, 47, 51, 52, 53, 48, 49, 50, 57, 58,
    59, 54, 55, 56, 63, 64, 65, 60, 61, 62, 69, 70, 71, 66, 67, 68
]


def flip_smpl_pose(pose):
    """Horizontal flip of SMPL pose parameters."""
    out = np.asarray(pose, np.float32)[_FLIPPED_PARTS].copy()
    out[1::3] = -out[1::3]
    out[2::3] = -out[2::3]
    return out


def _rodrigues(vec):
    """Axis-angle [3] -> rotation matrix [3, 3] (cv2.Rodrigues)."""
    vec = np.asarray(vec, np.float64)
    theta = np.linalg.norm(vec)
    if theta < 1e-12:
        return np.eye(3)
    k = vec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _inv_rodrigues(R):
    """Rotation matrix -> axis-angle [3]."""
    import cv2
    vec, _ = cv2.Rodrigues(np.asarray(R, np.float64))
    return vec[:, 0]


def rotate_smpl_pose(pose, rot_deg):
    """In-plane rotate the SMPL global orientation
    (reference mesh_transform.py:110 _rotate_smpl_pose)."""
    pose = np.asarray(pose, np.float32).copy()
    if rot_deg == 0:
        return pose
    r = np.deg2rad(-rot_deg)
    sn, cs = np.sin(r), np.cos(r)
    rot_mat = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], np.float64)
    per = _rodrigues(pose[:3])
    pose[:3] = _inv_rodrigues(rot_mat @ per).astype(np.float32)
    return pose


def flip_joints_3d(joints_3d, visible, flip_pairs=MESH_FLIP_PAIRS):
    """reference mesh_transform.py:134 _flip_joints_3d."""
    j = np.asarray(joints_3d, np.float32).copy()
    v = np.asarray(visible, np.float32).copy()
    for a, b in flip_pairs:
        j[[a, b]] = j[[b, a]]
        v[[a, b]] = v[[b, a]]
    j[:, 0] = -j[:, 0]
    return j * v, v


def rotate_joints_3d(joints_3d, rot_deg):
    """reference mesh_transform.py:89 _rotate_joints_3d."""
    r = np.deg2rad(-rot_deg)
    sn, cs = np.sin(r), np.cos(r)
    rot = np.array([[cs, -sn, 0], [sn, cs, 0], [0, 0, 1]], np.float32)
    return np.einsum('ij,kj->ki', rot, np.asarray(joints_3d,
                                                  np.float32))


def load_iuv(iuv_file, has_iuv=True, use_iuv=True):
    """Read a DensePose-style IUV image in the reference's channel order
    (reference mesh_transform.py:171 `LoadIUVFromFile`: read as BGR, so
    the channels come out I, U, V). Returns (iuv [H, W, 3] uint8 or None,
    has_iuv); raises ValueError where cv2 cannot read the file."""
    if not (has_iuv and use_iuv):
        return None, 0
    import cv2
    iuv = cv2.imread(str(iuv_file), cv2.IMREAD_COLOR)
    if iuv is None:
        raise ValueError(f'Fail to read {iuv_file}')
    return iuv, has_iuv


def flip_iuv(iuv, uv_type='BF'):
    """Horizontal IUV flip (reference mesh_transform.py:35 `_flip_iuv`):
    only DecoMR's 'BF' map has a simple rule, the image and its U channel
    mirrored."""
    if uv_type != 'BF':
        raise NotImplementedError(
            f'The flip of {uv_type} UV map is not implemented yet.')
    out = np.ascontiguousarray(iuv[:, ::-1, :])
    out[:, :, 1] = 255 - out[:, :, 1]
    return out


def iuv_to_arrays(iuv, iuv_size=(256, 256)):
    """IUV image -> (part index [1, H, W] int64, uv [2, H, W] float32 in
    [0, 1]) (reference mesh_transform.py:199 `IUVToTensor`); zeros of
    `iuv_size` (h, w) where the sample has no IUV map."""
    if iuv is None:
        h, w = int(iuv_size[0]), int(iuv_size[1])
        return (np.zeros((1, h, w), np.int64),
                np.zeros((2, h, w), np.float32))
    part_index = np.asarray(iuv[:, :, 0], np.int64)[None]
    uv = np.asarray(iuv[:, :, 1:], np.float32).transpose(2, 0, 1) / 255.0
    return part_index, uv


class MeshDataset:
    """npz-backed SMPL mesh dataset (reference MeshBaseDataset db)."""

    def __init__(self, ann_file, img_prefix, image_size=(256, 256)):
        self.img_prefix = img_prefix
        self.image_size = np.array(image_size)
        data = np.load(ann_file)
        n = len(data['imgname'])
        kp = (data['part'].astype(np.float32) if 'part' in data
              else np.zeros((n, 24, 3), np.float32))
        j3d = (data['S'].astype(np.float32) if 'S' in data
               else np.zeros((n, 24, 4), np.float32))
        has_smpl = int('pose' in data and 'shape' in data)
        poses = (data['pose'].astype(np.float32) if has_smpl
                 else np.zeros((n, 72), np.float32))
        betas = (data['shape'].astype(np.float32) if has_smpl
                 else np.zeros((n, 10), np.float32))
        self.db = []
        for i in range(n):
            self.db.append(dict(
                image_file=os.path.join(img_prefix, str(data['imgname'][i])),
                center=data['center'][i].astype(np.float32),
                scale=np.array([data['scale'][i], data['scale'][i]],
                               np.float32),
                joints_2d=kp[i, :, :2], joints_2d_visible=kp[i, :, 2:3],
                joints_3d=j3d[i, :, :3], joints_3d_visible=j3d[i, :, 3:4],
                pose=poses[i], beta=betas[i], has_smpl=has_smpl))

    def __len__(self):
        return len(self.db)

    # 14 LSP evaluation joints out of the 24 SMPL-extended gt joints
    # (reference mesh_h36m_dataset.py:81 joint_mapper)
    EVAL_JOINTS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 18)

    def evaluate(self, outputs, res_folder=None, metric='joint_error'):
        """Reference MeshH36MDataset.evaluate (mesh_h36m_dataset.py:31):
        collect per-image keypoints_3d, select the 14 LSP joints,
        pelvis-center (mean of hips 2,3) both pred and gt, and report
        MPJPE / MPJPE-PA (procrustes-aligned) in millimetres.

        outputs: list of dicts with 'keypoints_3d' [M, 24, 3] and
        'image_path' (list of M paths) — the batch results the mesh
        inference path produces.
        """
        import json
        from .body3d import keypoint_mpjpe
        metrics = metric if isinstance(metric, list) else [metric]
        for m in metrics:
            if m != 'joint_error':
                raise KeyError(f'metric {m} is not supported')
        kpts = []
        for out in outputs:
            for keypoints, image_path in zip(np.asarray(out['keypoints_3d']),
                                             out['image_path']):
                kpts.append(dict(keypoints=np.asarray(keypoints, np.float64),
                                 image=image_path))
        if res_folder is not None:
            res_file = os.path.join(res_folder, 'result_keypoints.json')
            with open(res_file, 'w') as f:
                json.dump([dict(keypoints=k['keypoints'].tolist(),
                                image=k['image']) for k in kpts],
                          f, sort_keys=True, indent=4)
        assert len(kpts) == len(self.db)
        mapper = list(self.EVAL_JOINTS)
        pred = np.stack([k['keypoints'] for k in kpts])[:, mapper]
        gt = np.stack([r['joints_3d'] for r in self.db])[:, mapper]
        vis = np.stack([r['joints_3d_visible']
                        for r in self.db])[:, mapper, 0] > 0
        pred = pred - (pred[:, 2:3] + pred[:, 3:4]) / 2
        gt = gt - (gt[:, 2:3] + gt[:, 3:4]) / 2
        return {
            'MPJPE': keypoint_mpjpe(pred, gt, vis) * 1000,
            'MPJPE-PA': keypoint_mpjpe(pred, gt, vis,
                                       alignment='procrustes') * 1000,
        }


class MoshDataset:
    """Real SMPL parameters for the discriminator (reference
    mosh_dataset.py): each item is theta [85] = (3 zeros, pose 72,
    beta 10)."""

    def __init__(self, ann_file):
        data = np.load(ann_file)
        self.pose = data['pose'].astype(np.float32)
        self.beta = data['shape'].astype(np.float32)

    def __len__(self):
        return len(self.pose)

    def __getitem__(self, i):
        return np.concatenate([np.zeros(3, np.float32), self.pose[i],
                               self.beta[i]])


class MeshMixDataset:
    """Weighted mixture over MeshDatasets (reference mesh_mix_dataset.py):
    length = max single length; sampling follows per-dataset partitions."""

    def __init__(self, datasets: Sequence[MeshDataset],
                 partition: Sequence[float], seed=0):
        assert len(datasets) == len(partition) and min(partition) >= 0
        self.datasets = list(datasets)
        self.length = max(len(d) for d in datasets)
        w = np.concatenate([np.ones(len(d)) * p / len(d)
                            for d, p in zip(datasets, partition)])
        self.weights = w / w.sum()
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.length

    def sample_record(self, rng=None):
        rng = rng or self.rng
        idx = rng.choice(len(self.weights), p=self.weights)
        di = int(np.searchsorted(self.offsets, idx, side='right') - 1)
        return self.datasets[di].db[idx - self.offsets[di]]


class MeshAdvLoader:
    """Batches for adversarial SMPL training (reference MeshAdvDataset +
    mesh transforms): each record gets flip/scale/rot augmentation with
    SMPL-consistent parameter updates, a cv2 affine crop, and a randomly
    paired Mosh theta as the discriminator's real sample."""

    def __init__(self, dataset, mosh: MoshDataset, batch_size,
                 image_size=(256, 256), flip_prob=0.5, rot_factor=30,
                 scale_factor=0.25, rot_prob=0.6, noise_factor=0.4,
                 seed=0, is_train=True):
        self.ds = dataset
        self.mosh = mosh
        self.batch_size = batch_size
        self.image_size = image_size
        self.flip_prob = flip_prob
        self.rot_factor = rot_factor
        self.scale_factor = scale_factor
        self.rot_prob = rot_prob
        self.noise_factor = noise_factor
        self.seed = seed
        self.is_train = is_train
        self.epoch = 0

    def __len__(self):
        return max(1, len(self.ds) // self.batch_size)

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _prepare(self, rec, rng):
        import cv2
        from ..ops.geometry import affine_matrix
        img = cv2.cvtColor(cv2.imread(rec['image_file']),
                           cv2.COLOR_BGR2RGB)
        c = rec['center'].copy()
        s = rec['scale'].copy()
        j2d = rec['joints_2d'].copy()
        v2d = rec['joints_2d_visible'].copy()
        j3d = rec['joints_3d'].copy()
        v3d = rec['joints_3d_visible'].copy()
        pose = rec['pose'].copy()
        rot = 0.0
        if self.is_train:
            if rng.rand() <= self.flip_prob:
                img = img[:, ::-1].copy()
                pose = flip_smpl_pose(pose)
                w = img.shape[1]
                for a, b in MESH_FLIP_PAIRS:
                    j2d[[a, b]] = j2d[[b, a]]
                    v2d[[a, b]] = v2d[[b, a]]
                j2d[:, 0] = w - j2d[:, 0] - 1
                j3d, v3d = flip_joints_3d(j3d, v3d)
                c[0] = w - c[0] - 1
            sf, rf = self.scale_factor, self.rot_factor
            s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
            rot = (np.clip(rng.randn() * rf, -2 * rf, 2 * rf)
                   if rng.rand() <= self.rot_prob else 0.0)
            # channel noise (MeshRandomChannelNoise)
            img = img.astype(np.float32) * rng.uniform(
                1 - self.noise_factor, 1 + self.noise_factor, 3)
            img = np.clip(img, 0, 255)
        iw, ih = self.image_size
        mat = np.asarray(affine_matrix(c[None], s[None],
                                       np.float32(rot)[None],
                                       (iw, ih)))[0]
        crop = cv2.warpAffine(img.astype(np.float32), mat, (iw, ih),
                              flags=cv2.INTER_LINEAR)
        j2w = np.concatenate([j2d, np.ones((len(j2d), 1))], axis=1) @ mat.T
        j2d = np.where(v2d > 0, j2w[:, :2], j2d)
        j3d = rotate_joints_3d(j3d, rot)
        pose = rotate_smpl_pose(pose, rot)
        return dict(img=crop, joints_2d=j2d.astype(np.float32),
                    joints_2d_visible=v2d[:, 0], joints_3d=j3d,
                    joints_3d_visible=v3d[:, 0], pose=pose,
                    beta=rec['beta'],
                    has_smpl=np.float32(rec['has_smpl']))

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        if hasattr(self.ds, 'sample_record'):
            recs_iter = [self.ds.sample_record(rng)
                         for _ in range(len(self) * self.batch_size)]
        else:
            order = rng.permutation(len(self.ds.db)) if self.is_train \
                else np.arange(len(self.ds.db))
            recs_iter = [self.ds.db[i] for i in order]
        bs = self.batch_size
        for b in range(len(self)):
            recs = [self._prepare(r, rng)
                    for r in recs_iter[b * bs:(b + 1) * bs]]
            if len(recs) < bs:
                continue
            theta = np.stack([self.mosh[rng.randint(len(self.mosh))]
                              for _ in recs])
            batch = {k: np.stack([r[k] for r in recs])
                     for k in recs[0]}
            batch['imgs'] = batch.pop('img') / 255.0
            batch['real_pose'] = theta[:, 3:75]
            batch['real_shape'] = theta[:, 75:85]
            yield batch

"""Keypoint-index lookups for effect nodes.

The port's copy of vitpose_tpu/webcam/pose_utils.py (the reference
tools/webcam/webcam_apis/utils/pose.py, which resolves semantic keypoints
(eyes, wrists, face contour, hands) from the model config's dataset_info
with hard-coded per-dataset fallbacks). Here the
lookups take the port's DatasetInfo (every pose result carries one), so
the name-based path almost always succeeds; fallbacks cover metadata-free
custom infos.
"""
from __future__ import annotations

from typing import List, Tuple

from ..data.dataset_info import DatasetInfo


def _name2id(info: DatasetInfo) -> dict:
    return {n: i for i, n in enumerate(info.keypoint_names)}


def get_eye_keypoint_ids(info: DatasetInfo) -> Tuple[int, int]:
    """(left_eye, right_eye) indices (reference pose.py:9)."""
    ids = _name2id(info)
    le, re = ids.get('left_eye'), ids.get('right_eye')
    if le is None or re is None:
        # AP-10K / AnimalPose order their eyes first (reference pose.py:40)
        if info.num_joints in (17, 20) and 'left_eye' not in ids:
            return 0, 1
        raise ValueError('cannot determine eye keypoints for this dataset')
    return le, re


def get_wrist_keypoint_ids(info: DatasetInfo) -> Tuple[int, int]:
    """(left_wrist, right_wrist) indices (reference pose.py:85)."""
    ids = _name2id(info)
    lw, rw = ids.get('left_wrist'), ids.get('right_wrist')
    if lw is None or rw is None:
        lw, rw = ids.get('left_front_paw'), ids.get('right_front_paw')
    if lw is None or rw is None:
        raise ValueError('cannot determine wrist keypoints for this dataset')
    return lw, rw


def get_face_keypoint_ids(info: DatasetInfo) -> List[int]:
    """68-point face contour indices (reference pose.py:50): wholebody
    names them face_0..face_67; 68-point face datasets use kpt_0..;
    otherwise fail."""
    ids = _name2id(info)
    if 'face_0' in ids:
        return [ids[f'face_{i}'] for i in range(68)]
    if info.num_joints == 68:
        return list(range(68))
    raise ValueError('cannot determine face keypoints for this dataset')


def get_mouth_keypoint_ids(info: DatasetInfo) -> int:
    """Upper-mouth center index (reference pose.py:126: wholebody face-62,
    i.e. absolute index 85)."""
    ids = _name2id(info)
    if 'face_62' in ids:
        return ids['face_62']
    raise ValueError('cannot determine mouth keypoint for this dataset')


_HAND_FINGERS = ('thumb', 'forefinger', 'middle_finger', 'ring_finger',
                 'pinky_finger')


def get_hand_keypoint_ids(info: DatasetInfo) -> List[int]:
    """42 hand keypoint indices, left root+fingers then right
    (reference pose.py:155)."""
    ids = _name2id(info)
    out = []
    for side in ('left', 'right'):
        root = ids.get(f'{side}_hand_root')
        if root is None:
            raise ValueError('cannot determine hand keypoints for this '
                             'dataset')
        out.append(root)
        for finger in _HAND_FINGERS:
            out.extend(ids[f'{side}_{finger}{k}'] for k in range(1, 5))
    return out

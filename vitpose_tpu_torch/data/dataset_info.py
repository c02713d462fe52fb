"""Dataset metadata: keypoint names, mirror pairs, skeleton, OKS sigmas.

The port's own copy of vitpose_tpu/data/dataset_info.py (the port imports
nothing of the JAX package). The zoo's metadata lives in ``metadata/``, one
JSON file per dataset, byte for byte the JAX package's;
`DatasetInfo.from_mmpose_dict` also reads the reference's `dataset_info`
config dicts.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

_META_DIR = os.path.join(os.path.dirname(__file__), 'metadata')


@dataclasses.dataclass
class DatasetInfo:
    dataset_name: str
    keypoint_names: List[str]
    keypoint_swap: List[str]              # '' when self-symmetric
    keypoint_type: List[str]              # 'upper' | 'lower' | ''
    sigmas: np.ndarray                    # [K] OKS sigmas (may be empty)
    joint_weights: np.ndarray             # [K]
    skeleton: List[List[str]]             # pairs of keypoint names
    keypoint_colors: Optional[np.ndarray] = None
    skeleton_colors: Optional[np.ndarray] = None

    @property
    def num_joints(self) -> int:
        return len(self.keypoint_names)

    @property
    def flip_pairs(self) -> List[List[int]]:
        name2id = {n: i for i, n in enumerate(self.keypoint_names)}
        return [[i, name2id[swap]] for i, swap in enumerate(self.keypoint_swap)
                if swap and name2id[swap] > i]

    @property
    def flip_index(self) -> np.ndarray:
        idx = np.arange(self.num_joints)
        for a, b in self.flip_pairs:
            idx[a], idx[b] = b, a
        return idx

    @property
    def upper_body_ids(self) -> List[int]:
        return [i for i, t in enumerate(self.keypoint_type) if t == 'upper']

    @property
    def lower_body_ids(self) -> List[int]:
        return [i for i, t in enumerate(self.keypoint_type) if t == 'lower']

    @property
    def skeleton_links(self) -> List[List[int]]:
        name2id = {n: i for i, n in enumerate(self.keypoint_names)}
        return [[name2id[a], name2id[b]] for a, b in self.skeleton]

    @classmethod
    def load(cls, name: str) -> 'DatasetInfo':
        with open(os.path.join(_META_DIR, f'{name}.json')) as f:
            d = json.load(f)
        return cls(
            dataset_name=d['dataset_name'],
            keypoint_names=d['keypoint_names'],
            keypoint_swap=d['keypoint_swap'],
            keypoint_type=d['keypoint_type'],
            sigmas=np.asarray(d.get('sigmas', []), np.float32),
            joint_weights=np.asarray(d.get('joint_weights', []), np.float32),
            skeleton=d.get('skeleton', []),
            keypoint_colors=np.asarray(d.get('keypoint_colors', []),
                                       np.uint8),
            skeleton_colors=np.asarray(d.get('skeleton_colors', []),
                                       np.uint8),
        )

    @classmethod
    def from_mmpose_dict(cls, d: dict) -> 'DatasetInfo':
        """Parse the reference's `dataset_info` config-dict schema."""
        kp = d['keypoint_info']
        k = len(kp)
        sk = d.get('skeleton_info', {})
        return cls(
            dataset_name=d.get('dataset_name', 'custom'),
            keypoint_names=[kp[i]['name'] for i in range(k)],
            keypoint_swap=[kp[i].get('swap', '') for i in range(k)],
            keypoint_type=[kp[i].get('type', '') for i in range(k)],
            sigmas=np.asarray(d.get('sigmas', []), np.float32),
            joint_weights=np.asarray(d.get('joint_weights', [1.0] * k),
                                     np.float32),
            skeleton=[sk[i]['link'] for i in sorted(sk)],
        )


def available_datasets() -> List[str]:
    return sorted(f[:-5] for f in os.listdir(_META_DIR)
                  if f.endswith('.json'))

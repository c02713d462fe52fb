"""Shared helpers of the port's dataset-conversion tools.

The port's copy of tools/dataset/_coco.py: the conversion CLIs turn raw
public-dataset releases into the COCO-style jsons the data layer reads,
writing the same json as the JAX package's tools on the same inputs.
Keypoint names and skeletons come from the port's DatasetInfo metadata
(vitpose_tpu_torch/data/metadata/*.json, byte for byte the JAX package's).
"""
import json
import os
import time

import numpy as np

from ...data.dataset_info import DatasetInfo


def category_from_metadata(name, category_name=None, supercategory=None):
    """Build the single COCO `categories` entry from DatasetInfo metadata."""
    info = DatasetInfo.load(name)
    names = list(info.keypoint_names)
    idx = {n: i for i, n in enumerate(names)}
    # metadata skeletons are keypoint-name pairs; COCO wants 1-based ids
    return [{
        'supercategory': supercategory or 'person',
        'id': 1,
        'name': category_name or name,
        'keypoints': names,
        'skeleton': [[idx[a] + 1, idx[b] + 1] for a, b in info.skeleton],
    }]


def coco_dict(images, annotations, categories, description):
    now = time.localtime()
    return {
        'info': {
            'description': description,
            'version': '1.0',
            'year': time.strftime('%Y', now),
            'date_created': time.strftime('%Y/%m/%d', now),
        },
        'images': images,
        'annotations': annotations,
        'categories': categories,
    }


def save_json(obj, path, indent=4):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, indent=indent)
    print(f'done {path}')


def keypoint_bbox(keypoints):
    """Tight xywh box around visible keypoints [K,3] (reference's
    min/max +1 convention, parse_deepposekit_dataset.py:49-63)."""
    vis = keypoints[:, 2] > 0
    if not vis.any():
        return [0.0, 0.0, 0.0, 0.0]
    xs, ys = keypoints[vis, 0], keypoints[vis, 1]
    return [float(xs.min()), float(ys.min()),
            float(xs.max() - xs.min() + 1), float(ys.max() - ys.min() + 1)]


def poly_area(xy):
    """Shoelace area of one polygon [N,2] (parse_macaquepose:13-21)."""
    x, y = np.asarray(xy[:, 0]), np.asarray(xy[:, 1])
    return float(0.5 * abs(np.dot(x, np.roll(y, 1))
                           - np.dot(y, np.roll(x, 1))))


def keypoint_annotation(ann_id, img_id, keypoints, bbox=None, area=None,
                        category_id=1, **extra):
    """Assemble one COCO keypoint annotation from a [K,3] array."""
    keypoints = np.asarray(keypoints, np.float64)
    if bbox is None:
        bbox = keypoint_bbox(keypoints)
    if area is None:
        area = float(bbox[2] * bbox[3])
    ann = {
        'id': int(ann_id),
        'image_id': int(img_id),
        'category_id': category_id,
        'iscrowd': 0,
        'keypoints': keypoints.reshape(-1).tolist(),
        'num_keypoints': int((keypoints[:, 2] > 0).sum()),
        'bbox': [float(v) for v in bbox],
        'area': float(area),
    }
    ann.update(extra)
    return ann


def image_entry(img_id, file_name, height, width):
    return {'id': int(img_id), 'file_name': file_name,
            'height': int(height), 'width': int(width)}

"""Minimal COCO-style annotation index (pure json, no pycocotools).

The port's own copy of vitpose_tpu/data/coco_index.py:15-95: the subset of
the COCO API the evaluation needs (annotation lookup by image, category
filtering, `loadRes`), without xtcocotools or pycocotools.
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict

import numpy as np


class CocoIndex:
    """Index over a COCO-format dict or json path."""

    def __init__(self, annotation_file=None, dataset=None):
        self.anno_file = [annotation_file]  # xtcocotools-compat attribute
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self._build()

    def _build(self):
        self.anns, self.imgs, self.cats = {}, {}, {}
        self.img_to_anns = defaultdict(list)
        for img in self.dataset.get('images', []):
            self.imgs[img['id']] = img
        for ann in self.dataset.get('annotations', []):
            self.anns[ann['id']] = ann
            self.img_to_anns[ann['image_id']].append(ann)
        for cat in self.dataset.get('categories', []):
            self.cats[cat['id']] = cat

    # -- COCO-API-compatible subset -------------------------------------
    def getImgIds(self):
        return sorted(self.imgs.keys())

    def getCatIds(self, catNms=None):
        if catNms:
            return [cid for cid, c in self.cats.items()
                    if c.get('name') in catNms]
        return sorted(self.cats.keys())

    def getAnnIds(self, imgIds=None, catIds=None, iscrowd=None):
        if imgIds is not None:
            if not isinstance(imgIds, (list, tuple)):
                imgIds = [imgIds]
            anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        else:
            anns = list(self.anns.values())
        if catIds is not None:
            if not isinstance(catIds, (list, tuple)):
                catIds = [catIds]
            anns = [a for a in anns if a.get('category_id') in catIds]
        if iscrowd is not None:
            anns = [a for a in anns if bool(a.get('iscrowd', 0)) == iscrowd]
        return [a['id'] for a in anns]

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadRes(self, results):
        """Build a CocoIndex holding detection results (list of dicts or a
        json path), mirroring COCO.loadRes semantics for keypoints."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res_dataset = {
            'images': list(self.dataset.get('images', [])),
            'categories': copy.deepcopy(self.dataset.get('categories', [])),
            'annotations': [],
        }
        for i, ann in enumerate(copy.deepcopy(results)):
            ann['id'] = i + 1
            if 'keypoints' in ann and 'area' not in ann:
                kp = np.asarray(ann['keypoints']).reshape(-1, 3)
                xs, ys = kp[:, 0], kp[:, 1]
                x0, x1 = xs.min(), xs.max()
                y0, y1 = ys.min(), ys.max()
                ann['area'] = float((x1 - x0) * (y1 - y0))
                ann['bbox'] = [float(x0), float(y0),
                               float(x1 - x0), float(y1 - y0)]
            res_dataset['annotations'].append(ann)
        return CocoIndex(dataset=res_dataset)

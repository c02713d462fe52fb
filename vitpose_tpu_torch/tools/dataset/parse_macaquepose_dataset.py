"""Convert the MacaquePose annotations.csv release into COCO-style
train/test jsons (counterpart of the reference's
tools/dataset/parse_macaquepose_dataset.py).

Each csv row is (image name, keypoint json string, segmentation json
string); every instance yields one annotation whose bbox is the
segmentation extent (+1 convention) and whose area is the summed polygon
shoelace area.

The port's copy of the JAX package's
tools/dataset/parse_macaquepose_dataset.py: the same json, byte for byte, on
the same inputs.

Usage:
    python -m vitpose_tpu_torch.tools.dataset.parse_macaquepose_dataset \
        --data-root data/macaque
"""
import argparse
import csv
import json
import os

import numpy as np

from ._coco import (category_from_metadata, coco_dict, image_entry,
                   keypoint_annotation, poly_area, save_json)


def parse_instance(kp_list, seg_list, kpt_num=17):
    """One (keypoints, segments) instance -> ([K,3] kpts, polys, bbox, area).

    Returns None for instances with no segmentation extent.
    """
    kpts = np.zeros((kpt_num, 3))
    for ind, p in enumerate(kp_list[:kpt_num]):
        if p.get('position') is not None:
            kpts[ind, :2] = p['position']
            kpts[ind, 2] = 2

    polys = [np.asarray(s['segment'], np.float64)
             for s in seg_list if len(s.get('segment', []))]
    if not polys:
        return None
    allpts = np.concatenate(polys, axis=0)
    mn, mx = allpts.min(0), allpts.max(0)
    bbox = [float(mn[0]), float(mn[1]),
            float(mx[0] - mn[0] + 1), float(mx[1] - mn[1] + 1)]
    area = sum(poly_area(p) for p in polys)
    return kpts, polys, bbox, area


def convert_rows(rows, img_root, start_img_id=0, start_ann_id=0, kpt_num=17):
    import cv2
    images, annotations = [], []
    img_id, ann_id = start_img_id, start_ann_id
    for row in rows:
        image_name = row[0]
        img = cv2.imread(os.path.join(img_root, image_name))
        if img is None:
            print(f'skip unreadable {image_name}')
            continue
        for kp, seg in zip(json.loads(row[1]), json.loads(row[2])):
            inst = parse_instance(kp, seg, kpt_num)
            if inst is None:
                continue
            kpts, polys, bbox, area = inst
            annotations.append(keypoint_annotation(
                ann_id, img_id, kpts, bbox=bbox, area=area,
                segmentation=[p.reshape(-1).tolist() for p in polys]))
            ann_id += 1
        images.append(
            image_entry(img_id, image_name, img.shape[0], img.shape[1]))
        img_id += 1
    return images, annotations, img_id, ann_id


def convert(data_root, train_num=12500, seed=0):
    with open(os.path.join(data_root, 'annotations.csv')) as f:
        rows = list(csv.reader(f))[1:]
    np.random.RandomState(seed).shuffle(rows)

    img_root = os.path.join(data_root, 'images')
    cat = category_from_metadata('macaque', category_name='macaque',
                                 supercategory='animal')
    img_id = ann_id = 0
    for split_rows, json_name in [(rows[:train_num], 'macaque_train.json'),
                                  (rows[train_num:], 'macaque_test.json')]:
        images, annotations, img_id, ann_id = convert_rows(
            split_rows, img_root, img_id, ann_id)
        save_json(coco_dict(images, annotations, cat, 'MacaquePose'),
                  os.path.join(data_root, 'annotations', json_name))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--data-root', default='data/macaque')
    ap.add_argument('--train-num', type=int, default=12500)
    args = ap.parse_args(argv)
    convert(args.data_root, args.train_num)


if __name__ == '__main__':
    main()

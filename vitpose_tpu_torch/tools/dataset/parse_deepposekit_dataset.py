"""Convert the DeepPoseKit-Data releases (fly / locust / zebra
annotation_data_release.h5) into per-image jpgs + COCO-style train/test
jsons (counterpart of the reference's
tools/dataset/parse_deepposekit_dataset.py).

The h5 holds stacked images, [N,K,2] keypoints, [N,K] annotated flags and
a [K,·] skeleton whose first column is each joint's parent (-1 = root);
the COCO skeleton is the (joint, parent) edge list. Keypoint names come
from this repo's DatasetInfo metadata. The split is a seeded 90/10
shuffle like the reference (:155-165).

The port's copy of the JAX package's
tools/dataset/parse_deepposekit_dataset.py: the same json, byte for byte, on
the same inputs.

Usage:
    python -m vitpose_tpu_torch.tools.dataset.parse_deepposekit_dataset \
        --data-root data/DeepPoseKit-Data [--datasets fly locust zebra]
"""
import argparse
import os

import numpy as np

from ._coco import (category_from_metadata, coco_dict, image_entry,
                   keypoint_annotation, save_json)


def skeleton_edges(skeleton_info):
    """[K,·] parent table -> 1-based (joint, parent) edges (:82-86)."""
    parents = np.asarray(skeleton_info)[:, 0]
    joints = np.arange(len(parents))
    edges = np.stack([joints, parents], axis=1) + 1
    return edges[edges.min(axis=1) > 0].tolist()


def convert_split(kpts_all, annotated_all, imgs_all, img_root,
                  start_img_id=0, start_ann_id=0):
    import cv2
    images, annotations = [], []
    img_id, ann_id = start_img_id, start_ann_id
    for kpts2d, annotated, img in zip(kpts_all, annotated_all, imgs_all):
        kpts = np.concatenate(
            [np.asarray(kpts2d, np.float64),
             np.asarray(annotated, np.float64)[:, None] * 2], axis=1)
        name = f'{img_id}.jpg'
        cv2.imwrite(os.path.join(img_root, name), img)
        images.append(image_entry(img_id, name, img.shape[0], img.shape[1]))
        annotations.append(keypoint_annotation(ann_id, img_id, kpts))
        img_id += 1
        ann_id += 1
    return images, annotations


def convert(data_root, dataset, seed=0):
    import h5py
    ddir = os.path.join(data_root, 'datasets', dataset)
    img_root = os.path.join(ddir, 'images')
    os.makedirs(img_root, exist_ok=True)

    with h5py.File(os.path.join(ddir, 'annotation_data_release.h5'),
                   'r') as f:
        kpts = np.array(f['annotations'])
        annotated = np.array(f['annotated'])
        imgs = np.array(f['images'])
        skeleton_info = np.array(f['skeleton'])

    cat = category_from_metadata(dataset, category_name=dataset,
                                 supercategory='animal')
    cat[0]['skeleton'] = skeleton_edges(skeleton_info)

    order = np.arange(len(kpts))
    np.random.RandomState(seed).shuffle(order)
    n_val = len(order) // 10
    n_train = len(order) - n_val
    splits = [(order[:n_train], f'{dataset}_train.json', 0),
              (order[n_train:], f'{dataset}_test.json', n_train)]
    for sel, json_name, start in splits:
        images, annotations = convert_split(
            kpts[sel], annotated[sel], imgs[sel], img_root, start, start)
        save_json(
            coco_dict(images, annotations, cat, f'DeepPoseKit {dataset}'),
            os.path.join(ddir, 'annotations', json_name))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--data-root', default='data/DeepPoseKit-Data')
    ap.add_argument('--datasets', nargs='+',
                    default=['fly', 'locust', 'zebra'])
    args = ap.parse_args(argv)
    for dataset in args.datasets:
        convert(args.data_root, dataset)


if __name__ == '__main__':
    main()

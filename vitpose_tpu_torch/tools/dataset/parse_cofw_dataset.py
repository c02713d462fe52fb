"""Convert the COFW face-landmark release (COFW_train_color.mat /
COFW_test_color.mat, Matlab v7.3 = HDF5) into per-image jpgs + COCO-style
jsons (counterpart of the reference's tools/dataset/parse_cofw_dataset.py).

Conventions reproduced from the reference script: keypoints come as a
flat [3K] phis vector (x..., y..., occluded...); visibility = 2 -
occlusion flag; coordinates shift from Matlab 1-index to 0-index;
negative values clamp to 0; images are re-numbered 000001.jpg... across
both splits.

The port's copy of the JAX package's tools/dataset/parse_cofw_dataset.py:
the same json, byte for byte, on the same inputs.

Usage:
    python -m vitpose_tpu_torch.tools.dataset.parse_cofw_dataset \
        --data-root data/cofw
"""
import argparse
import os

import numpy as np

from ._coco import (category_from_metadata, coco_dict, image_entry,
                    keypoint_annotation, save_json)


def _cofw_category():
    return category_from_metadata('cofw', category_name='face')


def parse_phis(phis):
    """[3K] Matlab phis -> [K,3] 0-indexed keypoints (reference :43-52)."""
    kpts = np.asarray(phis, np.float64).reshape(3, -1).T.copy()
    kpts[:, 2] = 2 - kpts[:, 2]
    kpts[:, :2] -= 1
    kpts[kpts < 0] = 0
    return kpts


def convert_split(mat, img_key, pts_key, bbox_key, image_root, start_id):
    """One split of the HDF5 mat -> (images, annotations, next_id)."""
    import cv2
    imgs, pts, bboxes = mat[img_key], mat[pts_key], mat[bbox_key]
    images, annotations = [], []
    cnt = start_id
    for idx in range(pts.shape[1]):
        cnt += 1
        img = np.array(mat[imgs[0, idx]]).transpose()
        if img.ndim == 2:
            img = np.stack([img] * 3, axis=-1)
        kpts = parse_phis(pts[:, idx])
        bbox = np.asarray(bboxes[:, idx], np.float64).copy()
        bbox[bbox < 0] = 0

        name = f'{cnt:06d}.jpg'
        cv2.imwrite(os.path.join(image_root, name),
                    cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2BGR))
        images.append(image_entry(cnt, name, img.shape[0], img.shape[1]))
        annotations.append(
            keypoint_annotation(cnt, cnt, kpts, bbox=bbox.tolist()))
    return images, annotations, cnt


def convert(data_root):
    import h5py
    image_root = os.path.join(data_root, 'images')
    ann_root = os.path.join(data_root, 'annotations')
    os.makedirs(image_root, exist_ok=True)
    os.makedirs(ann_root, exist_ok=True)

    splits = [('COFW_train_color.mat', 'IsTr', 'phisTr', 'bboxesTr',
               'cofw_train.json'),
              ('COFW_test_color.mat', 'IsT', 'phisT', 'bboxesT',
               'cofw_test.json')]
    cnt = 0
    for mat_file, img_key, pts_key, bbox_key, json_name in splits:
        path = os.path.join(data_root, mat_file)
        if not os.path.exists(path):
            print(f'skip missing {path}')
            continue
        with h5py.File(path, 'r') as mat:
            images, annotations, cnt = convert_split(
                mat, img_key, pts_key, bbox_key, image_root, cnt)
        save_json(
            coco_dict(images, annotations, _cofw_category(), 'COFW faces'),
            os.path.join(ann_root, json_name))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--data-root', default='data/cofw')
    args = ap.parse_args(argv)
    convert(args.data_root)


if __name__ == '__main__':
    main()

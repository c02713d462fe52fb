"""Convert the Human3.6M npz annotation (imgname/part/S/center/scale) to a
COCO-style json with world-frame `keypoints_3d` (counterpart of the
reference's tools/dataset/h36m_to_coco.py:13-165).

The camera for each frame is recovered from the image name
('S1_Action_1.54138969_000001.jpg' -> key (subject, camera)) and the 3D
keypoints are lifted camera->world through the port's SimpleCamera
(ops/camera.py, numpy f32 as the JAX package's).

The port's copy of the JAX package's tools/dataset/h36m_to_coco.py: the same
json, byte for byte, on the same inputs.

Usage:
    python -m vitpose_tpu_torch.tools.dataset.h36m_to_coco \
        --ann-file h36m.npz \
        --camera-param-file cameras.pkl --img-root data/h36m \
        --out-file h36m_coco.json
"""
import argparse
import os.path as osp
import pickle

import numpy as np

from ...ops.camera import SimpleCamera
from ._coco import (category_from_metadata, coco_dict, image_entry,
                   keypoint_annotation, save_json)


def _camera_key(image_name):
    """'S1_Directions_1.54138969_000001.jpg' -> ('S1', '54138969')."""
    subj, rest = osp.basename(image_name).split('_', 1)
    _, rest = rest.split('.', 1)
    camera, _ = rest.split('_', 1)
    return subj, camera


def _bbox_from_cs(center, scale, pixel_std=200.0):
    w = h = float(scale) * pixel_std
    return [float(center[0]) - w / 2, float(center[1]) - h / 2, w, h]


def _image_size(path):
    try:
        import cv2
        img = cv2.imread(path)
        if img is None:
            return None
        return img.shape[0], img.shape[1]
    except ImportError:
        return None


def convert(ann_file, camera_param_file, img_root, full_img_name=False,
            default_size=(1000, 1000), require_images=True):
    """Returns the COCO dict. Frames whose image file is unreadable are
    dropped (reference h36m_to_coco.py:148-152) unless require_images is
    False, in which case default_size is recorded."""
    data = np.load(ann_file, allow_pickle=True)
    with open(camera_param_file, 'rb') as f:
        cameras = pickle.load(f)

    imgnames = [str(n) for n in data['imgname']]
    if not full_img_name:
        imgnames = [osp.basename(n) for n in imgnames]

    images, annotations = [], []
    for idx, name in enumerate(imgnames):
        size = _image_size(osp.join(img_root, name))
        if size is None:
            if require_images:
                continue
            size = default_size
        img_id = idx + 1
        images.append(image_entry(img_id, name, size[0], size[1]))

        cam = SimpleCamera(cameras[_camera_key(name)])
        kpt3d = np.asarray(data['S'][idx], np.float64)
        kpt3d_world = kpt3d.copy()
        kpt3d_world[..., :3] = np.asarray(
            cam.camera_to_world(kpt3d[..., :3]))
        kpt2d = np.asarray(data['part'][idx], np.float64)
        annotations.append(keypoint_annotation(
            img_id, img_id, kpt2d,
            bbox=_bbox_from_cs(data['center'][idx], data['scale'][idx]),
            keypoints_3d=kpt3d_world.reshape(-1).tolist()))

    return coco_dict(images, annotations,
                     category_from_metadata('h36m', category_name='person'),
                     'Human3.6M in COCO format')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--ann-file', required=True)
    ap.add_argument('--camera-param-file', required=True)
    ap.add_argument('--img-root', default='')
    ap.add_argument('--out-file', required=True)
    ap.add_argument('--full-img-name', action='store_true')
    args = ap.parse_args(argv)
    out = convert(args.ann_file, args.camera_param_file, args.img_root,
                  args.full_img_name)
    save_json(out, args.out_file)


if __name__ == '__main__':
    main()

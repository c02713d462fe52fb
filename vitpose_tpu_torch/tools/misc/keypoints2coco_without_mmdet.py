"""Pseudo-label a COCO-style json of person boxes with predicted keypoints.

    python -m vitpose_tpu_torch.tools.misc.keypoints2coco_without_mmdet \
        CONFIG CKPT --json-file boxes.json --img-root data/imgs \
        --out-json-file out.json [--kpt-thr 0.3] [--device cuda|cpu]

The port's copy of the JAX package's tools/misc/keypoints2coco_without_mmdet.py
(reference tools/misc/keypoints2coco_without_mmdet.py): the top-down API
(`inference_top_down_pose_model`, the flip test on the card; `--device
cuda`, the default, raises without CUDA) runs on every box of each image,
and the new json's annotations carry the predicted keypoints, those scored
at `--kpt-thr` or more marked visible (2), the others zeroed.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ...api.inference import inference_top_down_pose_model, init_pose_model
from ...data import CocoIndex


def pseudo_label(model, coco, img_root, kpt_thr=0.3):
    """COCO dict of `coco`'s images whose annotations are the model's
    keypoints on each of their boxes (ids from 0, image order, then box
    order)."""
    images, annotations = [], []
    ann_id = 0
    for image_id in sorted(coco.imgs):
        image = coco.loadImgs(image_id)[0]
        path = os.path.join(img_root, image['file_name'])
        person_results = [{'bbox': coco.anns[a]['bbox']}
                          for a in coco.getAnnIds(image_id)]
        pose_results, _ = inference_top_down_pose_model(
            model, path, person_results, bbox_thr=None, format='xywh')
        for res in pose_results:
            kpts = np.asarray(res['keypoints'], np.float64).copy()
            low = kpts[:, 2] < kpt_thr
            kpts[low] = 0
            kpts[~low, 2] = 2
            # the xywh input box, returned unchanged by the API
            x, y, w, h = (int(v) for v in res['bbox'][:4])
            annotations.append({
                'id': ann_id,
                'image_id': int(image_id),
                'category_id': 1,
                'iscrowd': 0,
                'keypoints': [int(v) for v in kpts.reshape(-1)],
                'num_keypoints': int((~low).sum()),
                'bbox': [x, y, w, h],
                'area': round(w * h, 0),
            })
            ann_id += 1
        images.append({
            'file_name': os.path.basename(image['file_name']),
            'height': image['height'],
            'width': image['width'],
            'id': int(image_id),
        })
    return {'images': images, 'annotations': annotations,
            'categories': [{'id': 1, 'name': 'person'}]}


def main(argv=None):
    """Write the pseudo-labelled json; returns its dict."""
    ap = argparse.ArgumentParser(description='Pseudo-label person boxes '
                                 'with predicted keypoints (PyTorch port)')
    ap.add_argument('pose_config')
    ap.add_argument('pose_checkpoint')
    ap.add_argument('--img-root', default='')
    ap.add_argument('--json-file', required=True)
    ap.add_argument('--out-json-file', required=True)
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)

    model = init_pose_model(args.pose_config, args.pose_checkpoint,
                            device=args.device)
    out = pseudo_label(model, CocoIndex(args.json_file), args.img_root,
                       args.kpt_thr)
    with open(args.out_json_file, 'w') as f:
        json.dump(out, f, indent=2)
    print(f'wrote {args.out_json_file}')
    return out


if __name__ == '__main__':
    main()

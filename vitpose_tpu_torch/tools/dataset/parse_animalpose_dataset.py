"""Convert the Animal-Pose VOC-style xml annotations into COCO jsons
(counterpart of the reference's tools/dataset/parse_animalpose_dataset.py,
using stdlib ElementTree instead of xmltodict).

Each xml holds one instance: an `image` stem (e.g. '2008_000123'), a
`visible_bounds` box and 20 named keypoints with a visibility flag.
Image ids follow the reference's stem-concatenation scheme
(parse_animalpose_dataset.py:114-115); invisible keypoints stay 0.

The port's copy of the JAX package's
tools/dataset/parse_animalpose_dataset.py: the same json, byte for byte, on
the same inputs.

Usage:
    python -m vitpose_tpu_torch.tools.dataset.parse_animalpose_dataset \
        --xml-root data/animalpose/PASCAL2011_animal_annotation \
        --img-root data/animalpose \
        --out data/animalpose/annotations/animalpose_trainval.json
"""
import argparse
import os
import xml.etree.ElementTree as ET

import numpy as np

from ._coco import (category_from_metadata, coco_dict, image_entry,
                   keypoint_annotation, save_json)

# joint name -> index, the animalpose metadata order
# (reference parse_animalpose_dataset.py:89-110)
NAME2ID = {
    'L_Eye': 0, 'R_Eye': 1, 'L_EarBase': 2, 'R_EarBase': 3, 'Nose': 4,
    'Throat': 5, 'TailBase': 6, 'Withers': 7, 'L_F_Elbow': 8,
    'R_F_Elbow': 9, 'L_B_Elbow': 10, 'R_B_Elbow': 11, 'L_F_Knee': 12,
    'R_F_Knee': 13, 'L_B_Knee': 14, 'R_B_Knee': 15, 'L_F_Paw': 16,
    'R_F_Paw': 17, 'L_B_Paw': 18, 'R_B_Paw': 19,
}


def list_xml_files(root_dir):
    files = []
    for dirpath, _, names in os.walk(root_dir):
        files.extend(os.path.join(dirpath, n) for n in names
                     if n.lower().endswith('.xml'))
    return sorted(files)


def parse_xml(path):
    """One annotation xml -> (image stem, [20,3] keypoints, xywh bbox)."""
    root = ET.parse(path).getroot()
    stem = root.findtext('image').strip()
    kpts = np.zeros((20, 3), np.float64)
    for kpt in root.find('keypoints').iter('keypoint'):
        if int(kpt.get('visible')) == 0:
            continue
        idx = NAME2ID[kpt.get('name')]
        kpts[idx] = [float(kpt.get('x')), float(kpt.get('y')), 2]
    vb = root.find('visible_bounds')
    # the release mixes 'xmin'/'ymin' and 'xmin'/'height' attr layouts
    ymin = vb.get('ymin')
    if ymin is None:
        ymin = vb.get('height')
    bbox = [float(vb.get('xmin')), float(ymin),
            float(vb.get('width')), float(vb.get('height'))]
    return stem, kpts, bbox


def convert(xml_root, img_root, start_ann_id=0, image_size=None):
    """All xmls under xml_root -> COCO dict. image_size (h, w) overrides
    reading each image (for fixtures / missing images)."""
    import cv2
    images, annotations = [], []
    seen = {}
    ann_id = start_ann_id
    for path in list_xml_files(xml_root):
        stem, kpts, bbox = parse_xml(path)
        parts = stem.split('_')
        img_id = int(parts[0] + parts[1]) if len(parts) >= 2 and \
            parts[0].isdigit() and parts[1].isdigit() else \
            abs(hash(stem)) % 10**9
        if img_id not in seen:
            file_name = os.path.join('VOC2012', 'JPEGImages', stem + '.jpg')
            if image_size is not None:
                h, w = image_size
            else:
                img = cv2.imread(os.path.join(img_root, file_name))
                if img is None:
                    print(f'skip unreadable {file_name}')
                    continue
                h, w = img.shape[:2]
            images.append(image_entry(img_id, file_name, h, w))
            seen[img_id] = True
        annotations.append(
            keypoint_annotation(ann_id, img_id, kpts, bbox=bbox))
        ann_id += 1
    cat = category_from_metadata('animalpose', category_name='animal',
                                 supercategory='animal')
    return coco_dict(images, annotations, cat, 'Animal-Pose dataset')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--xml-root', required=True)
    ap.add_argument('--img-root', required=True)
    ap.add_argument('--out', required=True)
    args = ap.parse_args(argv)
    save_json(convert(args.xml_root, args.img_root), args.out)


if __name__ == '__main__':
    main()

"""Single-image top-down demo: COCO-json person boxes -> pose ->
visualization (counterpart of demo/top_down_img_demo.py).

    python -m vitpose_tpu_torch.demo.top_down_img_demo IMG
        [--json-file ann.json] [--checkpoint ckpt.pth] [--variant s]
        [--out-img-root vis_results] [--kpt-thr 0.3] [--device cuda|cpu]

`--variant` is a variant name or a config file (the COCO-B config runs
ViTPose-B in bf16 with K1).
"""
import argparse
import json
import os

from ..api import (inference_top_down_pose_model, init_pose_model,
                   vis_pose_result)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('img')
    ap.add_argument('--json-file', default=None,
                    help='COCO json with person bboxes for this image')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--variant', default='s')
    ap.add_argument('--out-img-root', default='vis_results')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    model = init_pose_model(args.variant, checkpoint=args.checkpoint,
                            device=args.device)
    person_results = None
    if args.json_file:
        with open(args.json_file) as f:
            ann = json.load(f)
        name = os.path.basename(args.img)
        img_ids = {im['file_name']: im['id'] for im in ann['images']}
        if name in img_ids:
            person_results = [
                {'bbox': a['bbox']} for a in ann['annotations']
                if a['image_id'] == img_ids[name]]

    pose_results, _ = inference_top_down_pose_model(
        model, args.img, person_results)
    os.makedirs(args.out_img_root, exist_ok=True)
    out = os.path.join(args.out_img_root,
                       'vis_' + os.path.basename(args.img))
    vis_pose_result(model, args.img, pose_results,
                    kpt_score_thr=args.kpt_thr, out_file=out)
    print(f'{len(pose_results)} persons -> {out}')
    return pose_results, out


if __name__ == '__main__':
    main()

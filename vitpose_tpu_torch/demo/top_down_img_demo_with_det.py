"""Top-down image demo driven by detector output (counterpart of
demo/top_down_img_demo_with_det.py): any detector's COCO-format detection
json in place of mmdet.

    python -m vitpose_tpu_torch.demo.top_down_img_demo_with_det IMG
        --det-json dets.json [--image-id ID] [--det-cat-id 1]
        [--bbox-thr 0.3] [--checkpoint ckpt.pth] [--variant b]
        [--out-img-root vis_results] [--kpt-thr 0.3] [--device cuda|cpu]

det json: [{image_id, category_id, bbox (xywh), score}, ...] or
[[x, y, w, h, score], ...]. `--variant` is a variant name or a config file.
"""
import argparse
import json
import os

from ..api import (inference_top_down_pose_model, init_pose_model,
                   vis_pose_result)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('img')
    ap.add_argument('--det-json', required=True,
                    help='COCO det json: [{image_id, category_id, bbox '
                         '(xywh), score}, ...] or [[x,y,w,h,score], ...]')
    ap.add_argument('--image-id', type=int, default=None,
                    help='filter det entries to this image id')
    ap.add_argument('--det-cat-id', type=int, default=1,
                    help='person category id in the det json')
    ap.add_argument('--bbox-thr', type=float, default=0.3)
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--variant', default='b')
    ap.add_argument('--out-img-root', default='vis_results')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    import cv2
    with open(args.det_json) as f:
        dets = json.load(f)
    person_results = []
    for d in dets:
        if isinstance(d, dict):
            if d.get('category_id', 1) != args.det_cat_id:
                continue
            if (args.image_id is not None
                    and d.get('image_id') != args.image_id):
                continue
            box = list(d['bbox']) + [d.get('score', 1.0)]
        else:
            box = list(d)
        if len(box) > 4 and box[4] < args.bbox_thr:
            continue
        person_results.append({'bbox': box})

    model = init_pose_model(args.variant, checkpoint=args.checkpoint,
                            device=args.device)
    img = cv2.cvtColor(cv2.imread(args.img), cv2.COLOR_BGR2RGB)
    pose_results, _ = inference_top_down_pose_model(
        model, img, person_results, bbox_thr=args.bbox_thr)
    os.makedirs(args.out_img_root, exist_ok=True)
    out = os.path.join(args.out_img_root,
                       'vis_det_' + os.path.basename(args.img))
    vis_pose_result(model, img, pose_results, kpt_score_thr=args.kpt_thr,
                    out_file=out)
    print(f'{len(pose_results)} people -> {out}')
    return pose_results, out


if __name__ == '__main__':
    main()

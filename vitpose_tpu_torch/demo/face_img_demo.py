"""Face landmark demo: face boxes -> 2D landmarks with a face-dataset
metadata head (counterpart of demo/face_img_demo.py).

    python -m vitpose_tpu_torch.demo.face_img_demo IMG [--face-box x,y,w,h]
        [--dataset 300w] [--checkpoint ckpt.pth] [--variant s]
        [--out-img-root vis_results] [--kpt-thr 0.3] [--device cuda|cpu]

The model is the variant with the dataset's joint count, in f32 without
fused attention, as in JAX.
"""
import argparse
import os

from ..api import (inference_top_down_pose_model, init_pose_model,
                   vis_pose_result)
from ..data.dataset_info import DatasetInfo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('img')
    ap.add_argument('--face-box', default=None,
                    help='x,y,w,h (default: full image)')
    ap.add_argument('--dataset', default='300w')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--variant', default='s')
    ap.add_argument('--out-img-root', default='vis_results')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    import cv2
    info = DatasetInfo.load(args.dataset)
    model = init_pose_model(
        dict(variant=args.variant, dataset=args.dataset,
             out_channels=info.num_joints), checkpoint=args.checkpoint,
        device=args.device)
    img = cv2.cvtColor(cv2.imread(args.img), cv2.COLOR_BGR2RGB)
    if args.face_box:
        box = [float(v) for v in args.face_box.split(',')]
    else:
        box = [0, 0, img.shape[1], img.shape[0]]
    results, _ = inference_top_down_pose_model(model, img,
                                               [{'bbox': box}])
    os.makedirs(args.out_img_root, exist_ok=True)
    out = os.path.join(args.out_img_root,
                       'vis_face_' + os.path.basename(args.img))
    vis_pose_result(model, img, results, kpt_score_thr=args.kpt_thr,
                    out_file=out)
    print(f'{len(results)} faces -> {out}')
    return results, out


if __name__ == '__main__':
    main()

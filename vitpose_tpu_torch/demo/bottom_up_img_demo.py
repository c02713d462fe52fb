"""Bottom-up image demo: whole-image multi-person pose without boxes
(counterpart of demo/bottom_up_img_demo.py).

    python -m vitpose_tpu_torch.demo.bottom_up_img_demo IMG
        [--checkpoint ckpt.pth] [--base-size 256]
        [--out-img-root vis_results] [--kpt-thr 0.3] [--device cuda|cpu]

The estimator is the video demo's (`build_estimator`).
"""
import argparse
import os

from ..api import inference_bottom_up_pose_model, vis_pose_result
from ..api.inference import _rgb
from .bottom_up_video_demo import add_common_args, build_estimator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('img')
    add_common_args(ap)
    ap.add_argument('--out-img-root', default='vis_results')
    args = ap.parse_args(argv)

    est = build_estimator(args.base_size, args.checkpoint, args.device)
    img = _rgb(args.img)
    results, _ = inference_bottom_up_pose_model(est, img,
                                                base_size=args.base_size)
    os.makedirs(args.out_img_root, exist_ok=True)
    out = os.path.join(args.out_img_root,
                       'vis_bu_' + os.path.basename(args.img))
    vis_pose_result(None, img, results, kpt_score_thr=args.kpt_thr,
                    dataset_info=est.dataset_info, out_file=out)
    print(f'{len(results)} persons -> {out}')
    return results, out


if __name__ == '__main__':
    main()

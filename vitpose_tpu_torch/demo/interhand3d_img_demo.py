"""Interacting-hand 3D image demo: a hand box -> the 2.5D volumes -> 42 3D
hand keypoints with the hand type and the relative root depth, optionally
back-projected to camera millimetres (counterpart of
demo/interhand3d_img_demo.py).

    python -m vitpose_tpu_torch.demo.interhand3d_img_demo IMG
        [--config CONFIG] [--checkpoint w.pth|.npz] [--hand-box x,y,w,h]
        [--focal fx,fy --princpt cx,cy [--root-depth MM]]
        [--out-img-root vis_results] [--device cuda|cpu]

The model is the config's (default the zoo's InterNet ResNet-50 at
256x256) with seeded weights (torch.Generator 0) unless --checkpoint gives
them; the box defaults to the whole image. With --focal and --princpt the
keypoints are lifted to camera space with the right wrist at --root-depth
and the left at it plus the predicted relative depth. The drawing is
matplotlib's, written to OUT/ih3d_<image name>.png.
"""
import argparse
import os

from ..api import init_pose_model
from ..api.inference import vis_pose_result_3d
from ..api.inference_3d import inference_interhand_3d_model
from ..data import DatasetInfo
from ..data.bottomup import read_rgb
from ..models.interhand3d import backproject_to_camera

CONFIG = os.path.join(os.path.dirname(__file__), '..', '..', 'vitpose_tpu',
                      'configs', 'hand', 'res50_interhand3d_all_256x256.py')


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('img')
    ap.add_argument('--config', default=CONFIG)
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--hand-box', default=None, help='x,y,w,h')
    ap.add_argument('--focal', default=None, help='fx,fy (pixels)')
    ap.add_argument('--princpt', default=None, help='cx,cy')
    ap.add_argument('--root-depth', type=float, default=500.0,
                    help='the right wrist\'s depth (mm) for --focal')
    ap.add_argument('--out-img-root', default='vis_results')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    img = read_rgb(args.img)
    h, w = img.shape[:2]
    box = ([float(v) for v in args.hand_box.split(',')]
           if args.hand_box else [0, 0, w, h])
    model = init_pose_model(args.config, checkpoint=args.checkpoint,
                            device=args.device)
    results = inference_interhand_3d_model(model, img, [{'bbox': box}])
    res = results[0]
    print('hand type (right, left):', res['hand_type'])
    print('relative root depth (mm):', res['rel_root_depth'])
    if args.focal and args.princpt:
        focal = [float(v) for v in args.focal.split(',')]
        princpt = [float(v) for v in args.princpt.split(',')]
        kp = res['keypoints_3d'][None, :, :3].copy()
        kp[0, 21:, 2] -= res['rel_root_depth']      # back to per-hand
        res['keypoints_cam'] = backproject_to_camera(
            kp, focal, princpt, [args.root_depth,
                                 args.root_depth + res['rel_root_depth']])[0]
    os.makedirs(args.out_img_root, exist_ok=True)
    info = DatasetInfo.load('interhand3d')
    out = os.path.join(args.out_img_root,
                       'ih3d_' + os.path.basename(args.img) + '.png')
    vis_pose_result_3d([{'keypoints_3d': res['keypoints_3d']}],
                       skeleton=info.skeleton_links, out_file=out)
    print(f'{len(res["keypoints_3d"])} keypoints -> {out}')
    return results, out


if __name__ == '__main__':
    main()

"""Two-stage 3D video demo: top-down 2D poses per frame (the whole frame
as the box) -> temporal lifting over each frame's window -> one 3D
skeleton drawing per frame (counterpart of demo/body3d_video_demo.py).

    python -m vitpose_tpu_torch.demo.body3d_video_demo VIDEO
        [--checkpoint ckpt.pth] [--variant s]
        [--lifter-checkpoint lifter.pth|.npz]
        [--out-img-root vis_results] [--max-frames N] [--device cuda|cpu]

`--variant` is a variant name or a top-down config file (the COCO-B config
runs ViTPose-B in bf16 with K1), `--checkpoint` its weights. The lifter is
JAX's default PoseLifter for 17 joints (a 27-frame receptive field; the
window is padded at the video's ends) with seeded weights unless
--lifter-checkpoint gives them. Drawings go to OUT/3d_{frame:05d}.png.
"""
import argparse
import os

from ..api import inference_top_down_pose_model, init_pose_model
from ..api.inference import vis_pose_result_3d
from ..api.inference_3d import (extract_pose_sequence,
                                inference_pose_lifter_model)
from ..data import DatasetInfo
from ._video import open_video
from .body3d_two_stage_img_demo import build_lifter


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('video')
    ap.add_argument('--checkpoint', default=None,
                    help='2D pose model weights')
    ap.add_argument('--lifter-checkpoint', default=None,
                    help='PoseLifter weights (.pth or .npz)')
    ap.add_argument('--variant', default='s')
    ap.add_argument('--out-img-root', default='vis_results')
    ap.add_argument('--max-frames', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    model = init_pose_model(args.variant, checkpoint=args.checkpoint,
                            device=args.device)
    lifter = build_lifter(17, args.lifter_checkpoint, args.device)
    if not args.lifter_checkpoint:
        print('WARNING: no --lifter-checkpoint given: the 3D stage runs '
              'with random weights (the output is structural only)')
    cap, _, (w, h) = open_video(args.video)
    pose_2d_list = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (args.max_frames
                          and len(pose_2d_list) >= args.max_frames):
                break
            pose_results, _ = inference_top_down_pose_model(
                model, frame[..., ::-1], [{'bbox': [0, 0, w, h]}])
            pose_2d_list.append(pose_results)
    finally:
        cap.release()

    os.makedirs(args.out_img_root, exist_ok=True)
    links = DatasetInfo.load('h36m').skeleton_links
    outs = []
    for fi in range(len(pose_2d_list)):
        seq = extract_pose_sequence(pose_2d_list, fi, causal=False,
                                    seq_len=lifter.receptive_field)
        res3d = inference_pose_lifter_model(lifter, seq, image_size=(w, h))
        if res3d:
            out = os.path.join(args.out_img_root, f'3d_{fi:05d}.png')
            vis_pose_result_3d(res3d, skeleton=links, out_file=out)
            outs.append(out)
    print(f'{len(pose_2d_list)} frames, {len(outs)} 3D renders -> '
          f'{args.out_img_root}')
    return len(pose_2d_list), outs


if __name__ == '__main__':
    main()

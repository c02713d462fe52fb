"""Realtime pose demo over camera/video/image-dir input (counterpart of
demo/webcam_demo.py).

    python -m vitpose_tpu_torch.demo.webcam_demo --input VIDEO_OR_DIR
        [--variant s] [--checkpoint x.pth] [--out out.avi]
        [--max-frames N] [--effect sunglasses|bugeye] [--sync | --async]
        [--device cuda|cpu]

`--variant` is a variant name or a config file (the COCO-B config runs
ViTPose-B in bf16 with K1).
"""
import argparse

from ..api import init_pose_model
from ..api.webcam import (AsyncWebcamRunner, DetectorNode, EffectNode,
                          PoseNode, VideoSink, VisualizerNode,
                          WebcamRunner)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--input', default=0,
                    help='camera index, video file, or image directory')
    ap.add_argument('--variant', default='s')
    ap.add_argument('--checkpoint', default=None)
    ap.add_argument('--out', default=None)
    ap.add_argument('--max-frames', type=int, default=None)
    ap.add_argument('--effect', default=None,
                    choices=['sunglasses', 'bugeye'],
                    help='pose-anchored frame effect instead of the '
                         'skeleton overlay')
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument('--sync', action='store_true',
                      help='run inference synchronously per frame (the '
                           'default for video/dir inputs, where every '
                           'output frame should be annotated)')
    mode.add_argument('--async', dest='async_', action='store_true',
                      help='buffered async graph: display at source rate, '
                           'inference on the latest frame only (the '
                           'default for live cameras)')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    import cv2
    model = init_pose_model(args.variant, checkpoint=args.checkpoint,
                            device=args.device)
    # cv2.VideoCapture needs a device INDEX for cameras, not the string
    is_camera = str(args.input).isdigit()
    source = int(args.input) if is_camera else args.input
    # record at the source's real rate (video files report theirs; live
    # cameras often report 0 -> keep the 30fps default)
    probe = cv2.VideoCapture(source)
    src_fps = probe.get(cv2.CAP_PROP_FPS) or 0
    probe.release()
    sink = VideoSink(args.out, fps=src_fps if src_fps > 0 else 30)
    render = (EffectNode(model, kind=args.effect) if args.effect
              else VisualizerNode(model))
    # live cameras default to the async graph (keep the camera rate, drop
    # frames for inference); files/dirs default to per-frame sync so every
    # output frame is annotated
    if args.async_ or (is_camera and not args.sync):
        runner = AsyncWebcamRunner(
            source, [DetectorNode(), PoseNode(model)], [render, sink],
            max_frames=args.max_frames)
    else:
        runner = WebcamRunner(
            source, [DetectorNode(), PoseNode(model), render, sink],
            max_frames=args.max_frames)
    n = runner.run()
    print(f'processed {n} frames; ' + '; '.join(
        runner.stopwatch.report_strings()))
    return n, sink


if __name__ == '__main__':
    main()

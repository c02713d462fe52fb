"""Launch a webcam application from a config file.

    python -m vitpose_tpu_torch.tools.run_webcam
        [--config tools/webcam/configs/examples/pose_estimation.py]
        [--cfg-options runner.camera_id=video.avi runner.show=False ...]
        [--device cuda|cpu]

Counterpart of tools/webcam/run_webcam.py: the config's `runner` dict goes
to the port's WebcamRunner (vitpose_tpu_torch.webcam), after --cfg-options
key=value pairs override its entries (e.g. runner.camera_id=1). The configs
are the JAX package's files, read in place. `--device` (CUDA by default;
it raises without CUDA) sets the device of every model node.
"""
from __future__ import annotations

import argparse
import os

from ..utils.config import apply_options, load_config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser('Launch webcam runner')
    parser.add_argument(
        '--config',
        default=os.path.join(REPO, 'tools', 'webcam', 'configs', 'examples',
                             'pose_estimation.py'))
    parser.add_argument(
        '--cfg-options', nargs='+', default=[],
        help='key=value overrides merged into the config, e.g. '
             'runner.camera_id=1 runner.synchronous=True')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without CUDA) or "
                             "'cpu', for every model node")
    return parser.parse_args(argv)


def runner_config(args):
    """The `runner` dict of the config file, overridden by the options and
    with `--device` set on the pose nodes."""
    cfg = apply_options(load_config(args.config), args.cfg_options)
    runner = dict(cfg['runner'])
    runner['nodes'] = [
        dict(node, device=args.device)
        if node.get('type') == 'TopDownPoseEstimatorNode' else node
        for node in runner.get('nodes') or []]
    return runner


def main(argv=None):
    """Run the app; returns the runner, which holds `frame_count`."""
    from ..webcam import WebcamRunner
    runner = WebcamRunner(**runner_config(parse_args(argv)))
    runner.run()
    return runner


if __name__ == '__main__':
    main()

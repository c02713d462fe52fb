"""Training CLI of the port: a config -> a trained model in a work dir.

    python -m vitpose_tpu_torch.tools.train CONFIG [--work-dir DIR]
        [--resume] [--cfg-options k.x=v ...] [--max-steps N] [--seed S]
        [--autoscale-lr] [--device cuda|cpu]

Counterpart of tools/train.py: the config (with `--cfg-options`, and the
PATH_TO_DATA rewrite of its data paths) goes to `train.loop.train_model` on
the card (`--device cuda`, the default; it raises without CUDA) or on the CPU
with `--device cpu`. The work dir receives `train.log.json` and `ckpts/`
(see utils/checkpoint.py); `--resume` goes on from its latest checkpoint.
A bottom-up config (family 'bottomup') trains through
train/bottomup_loop.py's runner, a PoseWarper config through
train/posewarper_loop.py and a pose-lifter config through
train/lifter_loop.py (weights only: `final.pth`, `--resume` restarts the
optimizer), as JAX's `train_model` dispatches them.

Across processes, one per card:

    python -m torch.distributed.run --nproc-per-node N \
        -m vitpose_tpu_torch.tools.train CONFIG [...]

or one `srun` task per card under SLURM: `init_distributed` reads the
launcher's environment (parallel/distributed.py) and `train_model` lays the
processes out over the data axis (and the expert axis of a ViTPose+
mixture, runtime.n_expert); rank 0 writes the work dir.
"""
from __future__ import annotations

import argparse
import os

from ..api.inference import _device
from ..parallel.distributed import init_distributed
from ..train.loop import train_model
from ..utils.config import apply_options, load_config
from ..utils.env import setup_multi_processes


def _replace_path_in_dict(d, old, new):
    """Rewrite the path prefix `old` to `new` in every string of a config
    dict (the fork's raplace_path_in_dict, tools/train.py:80-87)."""
    items = d.items() if isinstance(d, dict) else enumerate(d)
    for k, v in items:
        if isinstance(v, (dict, list)):
            _replace_path_in_dict(v, old, new)
        elif isinstance(v, str) and (v == old or v.startswith(old + '/')):
            d[k] = new + v[len(old):]
    return d


def parser():
    """The CLI's argument parser (tools/train_comet.py reads the same
    arguments)."""
    ap = argparse.ArgumentParser(description='Train a pose model '
                                 '(PyTorch port)')
    ap.add_argument('config')
    ap.add_argument('--work-dir', default=None)
    ap.add_argument('--resume', action='store_true',
                    help='resume from the latest checkpoint in work_dir')
    ap.add_argument('--cfg-options', nargs='*', default=[],
                    help='dotted config overrides, e.g. '
                         'optimizer.base_lr=1e-4')
    ap.add_argument('--max-steps', type=int, default=None,
                    help='stop after N optimizer steps, without a checkpoint')
    ap.add_argument('--seed', type=int, default=None)
    ap.add_argument('--autoscale-lr', action='store_true',
                    help='scale base_lr linearly by the process count / 8 '
                         '(one process a card; reference tools/train.py:'
                         '134-136)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    return ap


def main(argv=None):
    """Train; returns the final TrainState."""
    args = parser().parse_args(argv)

    _device(args.device)
    # a no-op in one process; the launcher's contract otherwise
    _, world = init_distributed(device=args.device)
    cfg = apply_options(load_config(args.config), args.cfg_options)
    setup_multi_processes(cfg)
    if 'PATH_TO_DATA' in os.environ:
        # relocatable data roots: the prefix PATH_TO_DATA_OLD (default
        # 'data') becomes PATH_TO_DATA
        _replace_path_in_dict(cfg, os.environ.get('PATH_TO_DATA_OLD', 'data'),
                              os.environ['PATH_TO_DATA'])
    if args.seed is not None:
        cfg.setdefault('runtime', {})['seed'] = args.seed
    if args.autoscale_lr:
        opt = cfg.setdefault('optimizer', {})
        opt['base_lr'] = opt.get('base_lr', 5e-4) * world / 8
    return train_model(cfg, work_dir=args.work_dir, resume=args.resume,
                       max_steps=args.max_steps, device=args.device)


if __name__ == '__main__':
    main()

"""What the family training loops share: weight-only resume, the final and
best weights, and the validation log.

Counterpart of vitpose_tpu/train/interhand_loop.py:256-335
(`_resume_loop_weights`, `_save_loop_outputs`, `_log_val_stats`,
`_should_eval`, `_save_best_ckpt`), for the PoseWarper, pose-lifter,
InterHand3D, mesh and VoxelPose loops. These loops keep weights only: the
work dir holds `final.pth` (the model's state dict under the mmpose names,
BN statistics included, as the JAX loops' `final.npz` holds variables),
`best.pth` where `save_best` names a metric, and `train.log.json` (one
metrics line per run, one mode='val' line per evaluation). `--resume`
loads `final.pth` over the fresh model; the optimizer state restarts.
`adam` and `adam_step` are the loops' optax.adam under a schedule of the
update count. Across processes (parallel/) the loops run data-parallel as
JAX's `data_parallel_step` does: `data_parallel` sizes the data axis, each
rank steps its rows of the global batch, `adam_step` averages the
gradients, and rank 0 alone writes the work dir.
"""
from __future__ import annotations

import functools
import json
import os

import torch

from ..parallel.distributed import barrier, is_main_process
from ..parallel.mesh import (activate, average_metrics, data_axis_size,
                             make_mesh, reduce_gradients)
from ..utils.checkpoint import _LESS_IS_BETTER, _save


def adam(params, base_lr, lr_of_count, weight_decay=0.0):
    """(optimizer, scheduler): Adam (torch's defaults are optax.adam's:
    betas 0.9 / 0.999, eps 1e-8), AdamW where `weight_decay` is given
    (optax.adamw's decoupled decay), over `params`, its learning rate
    lr_of_count(c) for the c-th update (from 0)."""
    optimizer = (torch.optim.AdamW(params, lr=base_lr,
                                   weight_decay=weight_decay)
                 if weight_decay else torch.optim.Adam(params, lr=base_lr))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda c: lr_of_count(c) / base_lr)
    return optimizer, scheduler


def adam_step(optimizer, scheduler):
    """One update from the parameters' `.grad`: a parameter the loss did
    not reach gets a zero gradient (optax steps every leaf), the gradients
    are averaged over the data ranks where there is a data axis
    (parallel/mesh.py; JAX's data_parallel_step), then the step and the
    schedule."""
    params = [p for group in optimizer.param_groups for p in group['params']]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    reduce_gradients(params)
    optimizer.step()
    scheduler.step()


def data_parallel(default_batch_size):
    """Decorate a family runner `f(cfg, ...)` to run under the data axis
    of JAX's data_parallel_step: runtime.n_data, or the gcd of the
    config's batch size (default `default_batch_size`, the global batch)
    and the processes (`data_axis_size`; axes that do not cover every
    process raise ValueError). Each rank then takes its rows of every
    global batch (`shard_rows`)."""
    def wrap(run):
        @functools.wraps(run)
        def runner(cfg, *args, **kwargs):
            batch = cfg.get('data', {}).get('batch_size', default_batch_size)
            n = data_axis_size(batch,
                               n_data=cfg.get('runtime', {}).get('n_data'))
            with activate(make_mesh(n_data=n)):
                return run(cfg, *args, **kwargs)
        return runner
    return wrap


def final_metrics(metrics):
    """The last step's metrics as floats, the global batch's under a data
    axis (every rank calls it)."""
    return {k: float(v) for k, v in average_metrics(metrics).items()}


def _work_dir(cfg, work_dir):
    return work_dir or cfg.get('runtime', {}).get('work_dir')


def resume_loop_weights(cfg, work_dir, model, resume):
    """Load work_dir/final.pth into `model` when `resume` is given and the
    file exists. Returns whether it did."""
    work_dir = _work_dir(cfg, work_dir)
    if not resume or not work_dir:
        return False
    path = os.path.join(work_dir, 'final.pth')
    if not os.path.exists(path):
        return False
    print(f'resuming weights from {path} (optimizer state restarts)',
          flush=True)
    model.load_state_dict(torch.load(path, map_location='cpu',
                                     weights_only=True), strict=True)
    return True


def _cpu_state_dict(model):
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_loop_outputs(cfg, work_dir, model, metrics, n_steps):
    """work_dir/final.pth and a metrics line in train.log.json, from rank
    0; every process waits until they are written."""
    work_dir = _work_dir(cfg, work_dir)
    if not work_dir:
        return
    if is_main_process():
        os.makedirs(work_dir, exist_ok=True)
        _save(_cpu_state_dict(model), os.path.join(work_dir, 'final.pth'))
        with open(os.path.join(work_dir, 'train.log.json'), 'a') as f:
            f.write(json.dumps(dict(metrics, step=n_steps)) + '\n')
    barrier()


def log_val_stats(cfg, work_dir, stats, epoch):
    """A mode='val' line in train.log.json (rank 0)."""
    work_dir = _work_dir(cfg, work_dir)
    if not work_dir or not is_main_process():
        return
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, 'train.log.json'), 'a') as f:
        f.write(json.dumps(dict({k: float(v) for k, v in stats.items()},
                                mode='val', epoch=epoch)) + '\n')


def should_eval(cfg, epoch):
    """Whether `evaluation.interval` asks for validation after this
    (0-based) epoch and the config has a val set."""
    interval = cfg.get('evaluation', {}).get('interval', 0)
    return bool(interval) and 'val' in cfg.get('data', {}) \
        and (epoch + 1) % interval == 0


def save_best_ckpt(cfg, work_dir, stats, model, best):
    """Keep the best-scoring weights in work_dir/best.pth when `save_best`
    (in runtime or evaluation) names a metric of `stats`; smaller is better
    for the metrics of _LESS_IS_BETTER unless `save_best_mode` says.
    Returns the best value so far."""
    rcfg = cfg.get('runtime', {})
    ecfg = cfg.get('evaluation', {})
    key = rcfg.get('save_best') or ecfg.get('save_best')
    work_dir = _work_dir(cfg, work_dir)
    if not key or key not in stats or not work_dir:
        return best
    mode = rcfg.get('save_best_mode') or ecfg.get('save_best_mode')
    if mode is None:
        mode = 'min' if any(m in key for m in _LESS_IS_BETTER) else 'max'
    v = float(stats[key])
    better = best is None or (v < best if mode == 'min' else v > best)
    if better and is_main_process():
        os.makedirs(work_dir, exist_ok=True)
        _save(_cpu_state_dict(model), os.path.join(work_dir, 'best.pth'))
    # every process waits, whatever its own reading of the metric
    barrier()
    return v if better else best

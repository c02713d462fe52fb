"""Training checkpoints: save and restore the train state, keep the newest
few, track the best metric, resume.

Counterpart of vitpose_tpu/utils/checkpoint.py:41-157 (`CheckpointManager`)
in PyTorch's idiom: one `torch.save` file per epoch, `epoch_{e}.pth`,
holding the model's state dict (parameters and BN buffers), the optimizer's
and the LR scheduler's state dicts, `step` and `epoch`. Beside them, as in
the JAX package: `info_{e}.json` ({'epoch', 'meta', 'metrics'}; `meta` says
completed=False for a preemption save), `meta.json` (the best value, its
epoch, the metric and its mode) and the best epoch's weights, here
`best.pth`: a plain state dict under the mmpose names, which
`torch.load(weights_only=True)` and both packages' `init_pose_model` read.
Files are written to a temporary name and renamed, so a preempted save never
leaves a torn checkpoint.

Across processes (parallel/), every rank calls `save` and `restore`: the
state is gathered whole (the parameters split over the expert or model
axis, the ZeRO-1 moments from their owners), rank 0 alone writes, as JAX's
manager does (vitpose_tpu/utils/checkpoint.py:34-37), and every rank waits
at a barrier until it has; every rank restores from the files and keeps
its part.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Optional

import torch

from ..parallel.distributed import barrier, is_main_process
from ..parallel.mesh import full_state_dict, load_full_state_dict
from ..parallel.zero import (full_optimizer_state_dict,
                             load_full_optimizer_state_dict)

# metrics where smaller is better (reference eval_hooks.py:7-10)
_LESS_IS_BETTER = ('NME', 'EPE', 'MPJPE', 'P-MPJPE', 'N-MPJPE', 'loss')
_EPOCH_FILE = re.compile(r'epoch_(\d+)\.pth')


def _save(obj, path):
    tmp = path + '.tmp'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_json(obj, path):
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory, max_to_keep=3, save_best_metric='AP',
                 mode=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_best_metric = save_best_metric
        if mode is None:
            mode = ('min' if any(save_best_metric.startswith(m)
                                 for m in _LESS_IS_BETTER) else 'max')
        self.mode = mode
        self.best_value = math.inf if mode == 'min' else -math.inf
        self._meta_path = os.path.join(self.directory, 'meta.json')
        self._best_path = os.path.join(self.directory, 'best.pth')
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            # adopt a stored best only when it tracked the same metric: a
            # work dir switched from AP (max) to NME (min) starts afresh
            if meta.get('metric', save_best_metric) == save_best_metric:
                self.best_value = meta.get('best_value', self.best_value)

    def path(self, epoch):
        return os.path.join(self.directory, f'epoch_{epoch}.pth')

    def epochs(self):
        """The epochs that have a checkpoint, oldest first."""
        found = (_EPOCH_FILE.fullmatch(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, epoch, state, metrics: Optional[dict] = None, meta=None):
        """Save `state` (a TrainState) as epoch `epoch`, drop the oldest
        checkpoints beyond `max_to_keep`, write info_{epoch}.json, and
        when `metrics` improve on the best, best.pth and meta.json. Every
        process calls it; rank 0 writes."""
        model_sd = full_state_dict(state.model)
        optim_sd = full_optimizer_state_dict(state.optimizer)
        main = is_main_process()
        if main:
            _save({'model': model_sd, 'optimizer': optim_sd,
                   'scheduler': state.scheduler.state_dict(),
                   'step': state.step, 'epoch': epoch}, self.path(epoch))
            for old in self.epochs()[:-self.max_to_keep]:
                os.remove(self.path(old))
            _write_json({'epoch': epoch, 'meta': meta or {},
                         'metrics': {k: float(v)
                                     for k, v in (metrics or {}).items()}},
                        os.path.join(self.directory, f'info_{epoch}.json'))
        if metrics and self.save_best_metric in metrics:
            v = float(metrics[self.save_best_metric])
            if (v < self.best_value if self.mode == 'min'
                    else v > self.best_value):
                self.best_value = v
                if main:
                    # persisted apart from the epoch files, which
                    # max_to_keep removes
                    _save({k: t.detach().cpu() for k, t in model_sd.items()},
                          self._best_path)
                    _write_json({'best_value': v, 'best_epoch': epoch,
                                 'metric': self.save_best_metric,
                                 'mode': self.mode,
                                 'best_weights': self._best_path},
                                self._meta_path)
        barrier()

    def latest_epoch(self):
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def load_info(self, epoch):
        """The info json of checkpoint `epoch`, or None."""
        path = os.path.join(self.directory, f'info_{epoch}.json')
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def restore_best(self):
        """The best weights (a state dict under the mmpose names), or None
        if no best was recorded yet."""
        if not os.path.exists(self._best_path):
            return None
        return torch.load(self._best_path, map_location='cpu',
                          weights_only=True)

    def restore(self, state, epoch=None):
        """Load checkpoint `epoch` (default: the latest) into `state` in
        place: the model's parameters and buffers, the optimizer's state
        (AdamW's moments and step counts, on the parameters' device), the
        scheduler's position and the step. Returns (state, epoch), epoch
        None when there is no checkpoint."""
        epoch = self.latest_epoch() if epoch is None else epoch
        if epoch is None:
            return state, None
        ckpt = torch.load(self.path(epoch), map_location='cpu',
                          weights_only=True)
        load_full_state_dict(state.model, ckpt['model'])
        load_full_optimizer_state_dict(state.optimizer, ckpt['optimizer'])
        state.scheduler.load_state_dict(ckpt['scheduler'])
        state.step = ckpt['step']
        return state, epoch

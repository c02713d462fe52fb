"""Train state: the model (parameters and BN statistics), the optimizer and
its schedule, and the step count.

Counterpart of vitpose_tpu/train/state.py:12-61. PyTorch updates in place,
so `apply_gradients` mutates the state where the JAX one returns a new
pytree.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_clip_norm: float
    step: int = 0

    def apply_gradients(self):
        """Clip the gradients in the parameters' `.grad` to the global norm
        `grad_clip_norm` (optax.clip_by_global_norm), take the AdamW step
        and advance the schedule. Returns the global norm before clipping
        as a 0-dim tensor on the parameters' device."""
        grads = [p.grad for group in self.optimizer.param_groups
                 for p in group['params'] if p.grad is not None]
        norm = torch.nn.utils.get_total_norm(grads)
        coef = torch.where(norm < self.grad_clip_norm, 1.0,
                           self.grad_clip_norm / norm)
        torch._foreach_mul_(grads, coef)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return norm


def create_train_state(model, tx, grad_clip_norm):
    """TrainState of an initialised model; `tx` is the (optimizer,
    scheduler) pair of `layer_decay_adamw`."""
    optimizer, scheduler = tx
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      grad_clip_norm=grad_clip_norm)

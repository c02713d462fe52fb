"""Train state: the model (parameters and BN statistics), the optimizer and
its schedule, and the step count.

Counterpart of vitpose_tpu/train/state.py:12-61. PyTorch updates in place,
so `apply_gradients` mutates the state where the JAX one returns a new
pytree.
"""
from __future__ import annotations

import dataclasses

import torch

from ..parallel.mesh import global_norm, reduce_gradients
from ..parallel.zero import optimizer_params, zero1_sync


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    grad_clip_norm: float
    step: int = 0

    def apply_gradients(self):
        """Clip the optimizer's gradients (in the parameters' `.grad`) to
        the global norm `grad_clip_norm` (optax.clip_by_global_norm), take
        the AdamW step and advance the schedule. Returns the global norm of
        every gradient of the model before clipping, frozen parameters'
        too (JAX logs optax.global_norm of all grads), as a 0-dim tensor on
        the parameters' device. The clip's own norm covers the optimizer's
        parameters only, as the clip inside JAX's freeze_tx does.

        A parameter that the loss does not reach (Lite-HRNet's last fusion
        of its lower branches, a ViTPose+ head without a sample of its
        dataset) gets a zero gradient: JAX differentiates every leaf, and
        optax steps it (the moments, AdamW's decay) where torch's
        optimizers skip a parameter without a gradient.

        Under a data axis (parallel/mesh.py) the gradients are then
        averaged over the data ranks, in the model's parameter order, so
        the norm, the clip and the step see the global batch's gradient;
        the norm sums the blocks of parameters split over the expert and
        model axes; a ZeRO-1 optimizer steps the parameters this rank owns
        and broadcasts them."""
        every_p = [p for p in self.model.parameters() if p.requires_grad]
        for p in every_p:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        reduce_gradients(every_p)
        opt_p = optimizer_params(self.optimizer)
        for p in opt_p:
            if p.grad is None:      # a parameter that requires no gradient
                p.grad = torch.zeros_like(p)
        norm = global_norm(every_p)
        clip_norm = (norm if len(every_p) == len(opt_p)
                     else global_norm(opt_p))
        coef = torch.where(clip_norm < self.grad_clip_norm, 1.0,
                           self.grad_clip_norm / clip_norm)
        torch._foreach_mul_([p.grad for p in opt_p], coef)
        self.optimizer.step()
        zero1_sync(self.optimizer)
        self.scheduler.step()
        self.step += 1
        return norm


def create_train_state(model, tx, grad_clip_norm):
    """TrainState of an initialised model; `tx` is the (optimizer,
    scheduler) pair of `layer_decay_adamw`."""
    optimizer, scheduler = tx
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      grad_clip_norm=grad_clip_norm)

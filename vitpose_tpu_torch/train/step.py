"""The top-down train step (counterpart of vitpose_tpu/train/step.py:28-102
`make_train_step` for GaussianHeatmap targets and the joints MSE).

One step: forward in training mode (BN batch statistics, DropPath from the
caller's generator), joints MSE, backward (through K3: the K2 kernel on
CUDA), the global-norm clip and layer-decay AdamW. The metrics stay on the
device as 0-dim tensors, and nothing in the step reads back to the host; PCK
is computed on the device as in the JAX step.
"""
from __future__ import annotations

from ..models.losses import joints_mse_loss
from ..models.topdown import forward
from ..ops.decode import pose_pck_accuracy


def make_train_step(model, target_type='GaussianHeatmap'):
    """Single-dataset step: train_step(state, batch, generator) -> metrics.

    `model` is taken for the JAX signature only: the step trains
    `state.model`. batch: dict with imgs [N, H, W, 3], target
    [N, K, Hh, Wh] and target_weight [N, K] on the model's device;
    `generator` is a torch.Generator on that device (DropPath). The state
    is updated in place; metrics are {'heatmap_loss' (the joints MSE),
    'grad_norm' (before clipping, as optax.global_norm(grads)),
    'acc_pose'}.
    """
    if target_type.lower() != 'gaussianheatmap':
        raise NotImplementedError(
            f'target_type {target_type!r}: only GaussianHeatmap with the '
            'joints MSE is ported (regression, CombinedTarget, awing and the '
            'MoE step: ROADMAP.md queue 1 items 7 and 10)')

    def train_step(state, batch, generator):
        out = forward(state.model, batch['imgs'], train=True,
                      generator=generator)
        loss = joints_mse_loss(out, batch['target'], batch['target_weight'])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = state.apply_gradients()
        acc, _ = pose_pck_accuracy(out.detach(), batch['target'],
                                   batch['target_weight'] > 0)
        return {'heatmap_loss': loss.detach(), 'grad_norm': grad_norm,
                'acc_pose': acc}

    return train_step

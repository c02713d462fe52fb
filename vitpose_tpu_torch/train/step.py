"""The top-down train steps (counterpart of vitpose_tpu/train/step.py:
`make_train_step` :48-102 with the joints MSE, the CombinedTarget MSE or
the adaptive wing loss, `_make_regression_train_step` :105-137 for
DeepPose, and `make_moe_train_step` :140-176, the ViTPose+ multi-dataset
step).

One step: forward in training mode (BN batch statistics, DropPath from the
caller's generator), the loss (a multi-stage model's summed over its
stages' maps, :41-46 and :75-83), backward (through K3: the K2 kernel on
CUDA), the global-norm clip and layer-decay AdamW. The metrics stay on the
device as 0-dim tensors, and nothing in the step reads back to the host; PCK
is computed on the device as in the JAX step.
"""
from __future__ import annotations

import torch

from ..models.bottomup import resize_bilinear
from ..models.losses import (REGRESSION_LOSSES, adaptive_wing_loss,
                             combined_target_mse_loss, joints_mse_loss)
from ..models.topdown import forward
from ..ops.decode import pose_pck_accuracy, regression_pck_accuracy


def match_target(target, out):
    """The NCHW `target` resized to `out`'s map size where they differ
    (jax.image.resize's 'bilinear': `bottomup.resize_bilinear`)."""
    if target.shape[2:] == out.shape[2:]:
        return target
    return resize_bilinear(target, out.shape[2:])


def make_train_step(model, target_type='GaussianHeatmap',
                    reg_loss='smooth_l1', heatmap_loss='mse'):
    """Single-dataset step: train_step(state, batch, generator) -> metrics.

    `model` is taken for the JAX signature only: the step trains
    `state.model`. batch: dict with imgs [N, H, W, 3], target
    [N, K, Hh, Wh] (CombinedTarget: [N, 3K, Hh, Wh]) and target_weight
    [N, K] on the model's device; `generator` is a torch.Generator on that
    device (DropPath). The state is updated in place; metrics are
    {'heatmap_loss' (the joints MSE, the CombinedTarget MSE, or with
    heatmap_loss='awing' the adaptive wing loss), 'grad_norm' (before
    clipping, as optax.global_norm(grads)), 'acc_pose' (not for
    CombinedTarget, whose offset channels argmax cannot read)}.
    target_type 'Regression' gives the DeepPose step
    (make_regression_train_step) with the `reg_loss` criterion.
    """
    kind = target_type.lower()
    if kind == 'regression':
        return make_regression_train_step(model, reg_loss)
    if kind == 'combinedtarget':
        loss_f = combined_target_mse_loss
    elif heatmap_loss == 'awing':
        loss_f = adaptive_wing_loss
    else:
        loss_f = joints_mse_loss

    def train_step(state, batch, generator):
        out = forward(state.model, batch['imgs'], train=True,
                      generator=generator)
        if isinstance(out, list):
            # a multi-stage model: the sum of every stage's (or unit's) loss
            # against the target resized to its map; PCK on the last
            loss = sum(loss_f(o, match_target(batch['target'], o),
                              batch['target_weight']) for o in out)
            out = out[-1]
        else:
            if kind == 'combinedtarget' and \
                    out.shape[1] != 3 * batch['target_weight'].shape[1]:
                raise ValueError(
                    f'a CombinedTarget head gives 3 maps per joint: '
                    f'{out.shape[1]} channels for '
                    f'{batch["target_weight"].shape[1]} joints (a config\'s '
                    'out_channels counts joints)')
            loss = loss_f(out, batch['target'], batch['target_weight'])
        # the model's, not the optimizer's: frozen parameters take
        # gradients too (they count in grad_norm)
        state.model.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = state.apply_gradients()
        metrics = {'heatmap_loss': loss.detach(), 'grad_norm': grad_norm}
        if kind != 'combinedtarget':
            metrics['acc_pose'], _ = pose_pck_accuracy(
                out.detach(), batch['target'], batch['target_weight'] > 0)
        return metrics

    return train_step


def make_regression_train_step(model, reg_loss='smooth_l1'):
    """The DeepPose step: train_step(state, batch, generator) -> metrics,
    batch target [N, K, 2] normalised coordinates and target_weight
    [N, K, 2]; the `reg_loss` criterion ('smooth_l1', 'wing' or
    'soft_wing'); metrics {'reg_loss' and 'heatmap_loss' (the loss, under
    both names as in JAX), 'acc_pose' (PCK at 0.05 of the normalised
    coordinates), 'grad_norm'} (reference deeppose_regression_head.py:
    48-95)."""
    loss_f = REGRESSION_LOSSES[reg_loss]

    def train_step(state, batch, generator):
        out = forward(state.model, batch['imgs'], train=True,
                      generator=generator)
        loss = loss_f(out, batch['target'], batch['target_weight'])
        state.model.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = state.apply_gradients()
        loss = loss.detach()
        return {'reg_loss': loss, 'heatmap_loss': loss,
                'acc_pose': regression_pck_accuracy(
                    out.detach(), batch['target'], batch['target_weight']),
                'grad_norm': grad_norm}

    return train_step


def make_moe_train_step(model, num_datasets):
    """ViTPose+ multi-dataset step: train_step(state, batch, generator) ->
    metrics, as make_train_step's, where the batch also carries
    `dataset_idx`, one int per sample on the host (numpy), and the targets
    are padded to the mixture's largest joint count.

    Every sample takes the expert of its dataset, and every head runs on
    the whole batch in training mode (so every head's BN statistics move).
    loss_d is head d's joints MSE over its first K_d target channels, its
    weights masked to the samples of dataset d (0 when the batch holds none:
    its parameters then get zero gradients); heatmap_loss is their sum
    (reference top_down_moe.py:166-203). Metrics: every loss_d,
    heatmap_loss and grad_norm. Raises if the model's head count is not
    `num_datasets`.
    """
    def train_step(state, batch, generator):
        ds_idx = batch['dataset_idx']
        outs = forward(state.model, batch['imgs'], train=True,
                       generator=generator, expert_idx=ds_idx,
                       all_heads=True)
        if len(outs) != num_datasets:
            raise ValueError(
                f'model has {len(outs)} heads but num_datasets='
                f'{num_datasets}: samples of unmatched datasets would '
                'silently contribute no loss')
        idx = torch.as_tensor(ds_idx, device=batch['imgs'].device)
        losses = {}
        for d, out in enumerate(outs):
            k = out.shape[1]
            weight = batch['target_weight'][:, :k] \
                * (idx == d).float()[:, None]
            losses[f'loss_{d}'] = joints_mse_loss(
                out, batch['target'][:, :k], weight)
        loss = sum(losses.values())
        state.model.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = state.apply_gradients()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(heatmap_loss=loss.detach(), grad_norm=grad_norm)
        return metrics

    return train_step

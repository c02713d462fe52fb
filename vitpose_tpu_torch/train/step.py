"""The top-down train steps (counterpart of vitpose_tpu/train/step.py:28-102
`make_train_step` for GaussianHeatmap targets and the joints MSE, and
:140-176 `make_moe_train_step`, the ViTPose+ multi-dataset step).

One step: forward in training mode (BN batch statistics, DropPath from the
caller's generator), joints MSE (a multi-stage model's summed over its
stages' maps, :41-46 and :75-83), backward (through K3: the K2 kernel on
CUDA), the global-norm clip and layer-decay AdamW. The metrics stay on the
device as 0-dim tensors, and nothing in the step reads back to the host; PCK
is computed on the device as in the JAX step.
"""
from __future__ import annotations

import torch

from ..models.bottomup import resize_bilinear
from ..models.losses import joints_mse_loss
from ..models.topdown import forward
from ..ops.decode import pose_pck_accuracy


def match_target(target, out):
    """The NCHW `target` resized to `out`'s map size where they differ
    (jax.image.resize's 'bilinear': `bottomup.resize_bilinear`)."""
    if target.shape[2:] == out.shape[2:]:
        return target
    return resize_bilinear(target, out.shape[2:])


def make_train_step(model, target_type='GaussianHeatmap',
                    heatmap_loss='mse'):
    """Single-dataset step: train_step(state, batch, generator) -> metrics.

    `model` is taken for the JAX signature only: the step trains
    `state.model`. batch: dict with imgs [N, H, W, 3], target
    [N, K, Hh, Wh] and target_weight [N, K] on the model's device;
    `generator` is a torch.Generator on that device (DropPath). The state
    is updated in place; metrics are {'heatmap_loss' (the joints MSE),
    'grad_norm' (before clipping, as optax.global_norm(grads)),
    'acc_pose'}.
    """
    if target_type.lower() != 'gaussianheatmap' or heatmap_loss != 'mse':
        raise NotImplementedError(
            f'target_type {target_type!r} with heatmap_loss {heatmap_loss!r}:'
            ' only GaussianHeatmap with the joints MSE is ported '
            '(regression, CombinedTarget and awing: ROADMAP.md queue 1 '
            'item 7)')

    def train_step(state, batch, generator):
        out = forward(state.model, batch['imgs'], train=True,
                      generator=generator)
        if isinstance(out, list):
            # a multi-stage model: the sum of every stage's (or unit's) loss
            # against the target resized to its map; PCK on the last
            loss = sum(joints_mse_loss(o, match_target(batch['target'], o),
                                       batch['target_weight']) for o in out)
            out = out[-1]
        else:
            loss = joints_mse_loss(out, batch['target'],
                                   batch['target_weight'])
        # the model's, not the optimizer's: frozen parameters take
        # gradients too (they count in grad_norm)
        state.model.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = state.apply_gradients()
        acc, _ = pose_pck_accuracy(out.detach(), batch['target'],
                                   batch['target_weight'] > 0)
        return {'heatmap_loss': loss.detach(), 'grad_norm': grad_norm,
                'acc_pose': acc}

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

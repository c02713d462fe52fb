"""Keypoint losses (counterpart of vitpose_tpu/models/losses.py: the joints
MSE of the GaussianHeatmap target; and of the bottom-up losses of
vitpose_tpu/models/losses_regression.py:139-196, `ae_heatmap_loss` and
`ae_tag_loss`)."""
from __future__ import annotations

import torch


def joints_mse_loss(pred, target, target_weight=None, loss_weight=1.0):
    """Weighted per-joint MSE over [N, K, H, W] heatmaps, target_weight
    [N, K] or None: (1/K) * sum_k mean_{N,H,W}((w_nk * (pred - target))^2)
    (reference mse_loss.py:9-44, as one masked reduction)."""
    k = pred.shape[1]
    diff = pred - target
    if target_weight is not None:
        diff = diff * target_weight[:, :, None, None]
    return (diff ** 2).mean((0, 2, 3)).sum() / k * loss_weight


def ae_heatmap_loss(pred, gt, mask, supervise_empty=True, loss_weight=1.0):
    """Masked heatmap MSE for bottom-up (multi_loss_factory.py:30
    `HeatmapLoss`): pred and gt [N, K, H, W], mask [N, H, W]; per-sample mean
    over (K, H, W), then the batch mean. Without `supervise_empty`, the
    channels whose GT is empty are masked out."""
    loss = (pred - gt) ** 2 * mask[:, None].to(pred.dtype)
    if not supervise_empty:
        empty = gt.amax(dim=(2, 3), keepdim=True) > 0
        loss = loss * empty.to(pred.dtype)
    return loss.mean(dim=(1, 2, 3)).mean() * loss_weight


def ae_tag_loss(tags, joints, loss_type='exp'):
    """Associative-embedding grouping loss (multi_loss_factory.py:70
    `AELoss.singleTagLoss`, vectorised over a padded person axis).

    tags: [N, KHW, 1] flattened per-pixel tag map. joints: [N, M, K, 2]
    integers; [..., 0] the flat pixel index, [..., 1] the visibility (1/0);
    M = max persons (padded).

    Returns (push, pull), each [N]: pull is the mean over the people with a
    visible joint of their tags' variance; push the mean over the ordered
    pairs of such people of exp(-d^2) ('exp') or max(0, 1 - |d|) ('max')
    of their mean tags' distance d, halved; each 0 where it has no person
    (no pair).
    """
    n, m, k, _ = joints.shape
    idx = joints[..., 0].long()
    vis = joints[..., 1].to(tags.dtype)
    tag_vals = torch.gather(tags[..., 0], 1,
                            idx.reshape(n, -1)).reshape(n, m, k)
    cnt = vis.sum(dim=2)
    has = (cnt > 0).to(tags.dtype)
    denom_cnt = cnt.clamp(min=1.0)
    mean_tag = (tag_vals * vis).sum(dim=2) / denom_cnt

    pull_per = (((tag_vals - mean_tag[..., None]) ** 2) * vis).sum(dim=2) \
        / denom_cnt
    num_people = has.sum(dim=1)
    pull = (pull_per * has).sum(dim=1) / num_people.clamp(min=1.0)

    diff = mean_tag[:, :, None] - mean_tag[:, None, :]
    pair_mask = has[:, :, None] * has[:, None, :]
    eye = torch.eye(m, dtype=tags.dtype, device=tags.device)
    pair_mask = pair_mask * (1.0 - eye)
    if loss_type == 'exp':
        push_mat = torch.exp(-diff ** 2)
    else:
        push_mat = torch.clamp(1.0 - diff.abs(), min=0.0)
    denom = (num_people * (num_people - 1.0)).clamp(min=1.0)
    push = (push_mat * pair_mask).sum(dim=(1, 2)) * 0.5 / denom
    zero = torch.zeros((), dtype=tags.dtype, device=tags.device)
    push = torch.where(num_people > 1, push, zero)
    pull = torch.where(num_people > 0, pull, zero)
    return push, pull

"""Keypoint losses (counterpart of vitpose_tpu/models/losses.py: the joints
MSE of the GaussianHeatmap target, the CombinedTarget MSE and the
adaptive wing loss; and of vitpose_tpu/models/losses_regression.py: the
DeepPose criteria `smooth_l1_loss`, `wing_loss` and `soft_wing_loss`
(:27, :45, :55) and the bottom-up losses `ae_heatmap_loss` and
`ae_tag_loss` (:139-196))."""
from __future__ import annotations

import math

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


def combined_target_mse_loss(pred, target, target_weight, loss_weight=1.0):
    """UDP CombinedTarget loss over [N, 3K, H, W] maps (response, x and y
    offsets per joint), target_weight [N, K]: the response channel weighted
    by visibility, the offsets gated by the weighted target response
    (reference
    mse_loss.py:48 `CombinedTargetMSELoss`)."""
    n, c3, h, w = pred.shape
    k = c3 // 3
    p = pred.reshape(n, k, 3, h * w)
    t = target.reshape(n, k, 3, h * w)
    wgt = target_weight[:, :, None]
    hm_t = t[:, :, 0] * wgt
    loss = 0.5 * ((p[:, :, 0] * wgt - hm_t) ** 2).mean((0, 2))
    loss = loss + 0.5 * ((hm_t * p[:, :, 1] - hm_t * t[:, :, 1]) ** 2
                         ).mean((0, 2))
    loss = loss + 0.5 * ((hm_t * p[:, :, 2] - hm_t * t[:, :, 2]) ** 2
                         ).mean((0, 2))
    return loss.sum() / k * loss_weight


def adaptive_wing_loss(pred, target, target_weight=None, alpha=2.1,
                       omega=14.0, epsilon=1.0, theta=0.5, loss_weight=1.0):
    """Adaptive wing loss on [N, K, H, W] heatmaps in f32 (reference
    heatmap_loss.py:9 `AdaptiveWingLoss`): omega * log1p((d / epsilon) **
    (alpha - y)) where d = |y - pred| < theta, A * d - C beyond; the
    target_weight [N, K] (or [N, K, 1]) multiplies pred and target first."""
    pred, target = pred.float(), target.float()
    if target_weight is not None:
        w = target_weight.reshape(pred.shape[0], pred.shape[1], 1, 1)
        pred, target = pred * w, target * w
    delta = (target - pred).abs()
    ratio = theta / epsilon
    a = (omega * (1.0 / (1.0 + ratio ** (alpha - target)))
         * (alpha - target) * ratio ** (alpha - target - 1.0) / epsilon)
    c = theta * a - omega * torch.log1p(ratio ** (alpha - target))
    small = omega * torch.log1p((delta / epsilon) ** (alpha - target))
    return torch.where(delta < theta, small, a * delta - c).mean() \
        * loss_weight


def _weighted(pred, target, target_weight):
    """pred and target [N, K, D] times target_weight ([N, K, D] or
    [N, K])."""
    if target_weight is None:
        return pred, target
    w = target_weight
    if w.ndim == pred.ndim - 1:
        w = w[..., None]
    return pred * w, target * w


def smooth_l1_loss(pred, target, target_weight=None, loss_weight=1.0):
    """Huber (beta 1), the elementwise mean (regression_loss.py:12)."""
    pred, target = _weighted(pred, target, target_weight)
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean() * loss_weight


def wing_loss(pred, target, target_weight=None, omega=10.0, epsilon=2.0,
              loss_weight=1.0):
    """Wing loss (Feng et al., CVPR 2018; regression_loss.py:52): the batch
    mean of each sample's sum."""
    pred, target = _weighted(pred, target, target_weight)
    c = omega * (1.0 - math.log(1.0 + omega / epsilon))
    d = (target - pred).abs()
    loss = torch.where(d < omega, omega * torch.log(1.0 + d / epsilon),
                       d - c)
    return loss.sum((1, 2)).mean() * loss_weight


def soft_wing_loss(pred, target, target_weight=None, omega1=2.0,
                   omega2=20.0, epsilon=0.5, loss_weight=1.0):
    """Soft wing loss (Lin et al., TIP 2021; regression_loss.py:122): the
    batch mean of each sample's sum."""
    pred, target = _weighted(pred, target, target_weight)
    b = omega1 - omega2 * math.log(1.0 + omega1 / epsilon)
    d = (target - pred).abs()
    loss = torch.where(d < omega1, d,
                       omega2 * torch.log(1.0 + d / epsilon) + b)
    return loss.sum((1, 2)).mean() * loss_weight


REGRESSION_LOSSES = {'smooth_l1': smooth_l1_loss, 'wing': wing_loss,
                     'soft_wing': soft_wing_loss}


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

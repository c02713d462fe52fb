"""Keypoint losses (counterpart of vitpose_tpu/models/losses.py; this slice
carries the joints MSE of the GaussianHeatmap target)."""
from __future__ import annotations


def joints_mse_loss(pred, target, target_weight=None, loss_weight=1.0):
    """Weighted per-joint MSE over [N, K, H, W] heatmaps, target_weight
    [N, K] or None: (1/K) * sum_k mean_{N,H,W}((w_nk * (pred - target))^2)
    (reference mse_loss.py:9-44, as one masked reduction)."""
    k = pred.shape[1]
    diff = pred - target
    if target_weight is not None:
        diff = diff * target_weight[:, :, None, None]
    return (diff ** 2).mean((0, 2, 3)).sum() / k * loss_weight

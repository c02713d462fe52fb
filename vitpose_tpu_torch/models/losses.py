"""Keypoint losses (counterpart of vitpose_tpu/models/losses.py: the joints
MSE of the GaussianHeatmap target, the CombinedTarget MSE, the online hard
keypoint mining MSE and the adaptive wing loss; and of
vitpose_tpu/models/losses_regression.py: the DeepPose criteria
`smooth_l1_loss`, `wing_loss` and `soft_wing_loss` (:27, :45, :55), the
flow-free RLE loss `rle_loss` (:112), the bottom-up losses
`ae_heatmap_loss` and `ae_tag_loss` (:139-196), and the pose lifters'
`mse_loss`,
`mpjpe_loss`, `bone_loss`, `project_joints` and `semi_supervision_loss`
(:40-98, :241-300)), InterHand3D's `l1_loss` and `bce_loss` (:35, :99)
and the mesh losses `gan_loss`, `mesh_joint_loss` and `smpl_param_loss`
(:197-238))."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import global_batch_mean


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


def joints_ohkm_mse_loss(pred, target, target_weight, topk=8,
                         loss_weight=1.0):
    """Online hard keypoint mining MSE over [N, K, H, W] heatmaps
    (reference mse_loss.py:97 `JointsOHKMMSELoss`): each sample keeps its
    `topk` largest per-joint losses, mean_{H,W}((w_nk * (pred -
    target))^2); the mean over samples of their kept sums over `topk`."""
    diff = (pred - target) * target_weight[:, :, None, None]
    per_joint = (diff ** 2).mean((2, 3))                   # [N, K]
    kept = per_joint.topk(topk, dim=1).values
    return (kept.sum(1) / topk).mean() * loss_weight


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


def rle_loss(pred, sigma, target, target_weight=None,
             q_distribution='laplace', loss_weight=1.0):
    """Residual log-likelihood estimation loss (Li et al., ICCV 2021) in
    its flow-free form, as JAX's (losses_regression.py:112): -log Q of the
    error scaled by the predicted `sigma` [N, K, D] (floored at 1e-9),
    with a Laplace ('laplace') or Gaussian base density, plus log sigma;
    weighted as `_weighted` weights, the elementwise mean."""
    sigma = sigma.clamp_min(1e-9)
    error = (pred - target) / sigma
    if q_distribution == 'laplace':
        log_q = error.abs() + math.log(2.0)
    else:
        log_q = 0.5 * error ** 2 + 0.5 * math.log(2.0 * math.pi)
    loss = torch.log(sigma) + log_q
    if target_weight is not None:
        w = target_weight
        if w.ndim == loss.ndim - 1:
            w = w[..., None]
        loss = loss * w
    return loss.mean() * loss_weight


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


def mse_loss(pred, target, target_weight=None, loss_weight=1.0):
    """The elementwise mean of the squared error (regression_loss.py)."""
    pred, target = _weighted(pred, target, target_weight)
    return ((pred - target) ** 2).mean() * loss_weight


def mpjpe_loss(pred, target, target_weight=None, loss_weight=1.0):
    """Mean per-joint position error (regression_loss.py:200)."""
    pred, target = _weighted(pred, target, target_weight)
    return torch.linalg.vector_norm(pred - target, dim=-1).mean() \
        * loss_weight


def bone_loss(pred, target, joint_parents, target_weight=None,
              loss_weight=1.0):
    """Bone-length consistency (regression_loss.py:306): each bone's length
    (self-parented roots left out) averaged over the batch first, then the
    L1 between the means; `target_weight` weights bones [N, B]."""
    parents = np.asarray(joint_parents)
    keep = np.arange(len(parents)) != parents
    child = torch.as_tensor(np.arange(len(parents))[keep])
    par = torch.as_tensor(parents[keep])
    bone_pred = torch.linalg.vector_norm(pred[:, child] - pred[:, par],
                                         dim=-1)
    bone_gt = torch.linalg.vector_norm(target[:, child] - target[:, par],
                                       dim=-1)
    if target_weight is not None:
        bone_pred = bone_pred * target_weight
        bone_gt = bone_gt * target_weight
    # the global batch's means under a data axis (parallel/mesh.py)
    return (global_batch_mean(bone_pred) - global_batch_mean(bone_gt)
            ).abs().mean() * loss_weight


def project_joints(x, intrinsics):
    """Camera-space joints [N, K, 3] -> image-plane [N, K, 2] through
    intrinsics [N, 4] (f, c) or [N, 9] (f, c, k1 k2 k3, p1 p2) with radial
    and tangential distortion (regression_loss.py:395-424). A depth within
    1e-4 of 0 is held at +-1e-4 (an untrained trajectory head can put the
    root there), and x / z is clipped to [-1, 1]."""
    intr = torch.as_tensor(intrinsics, dtype=x.dtype, device=x.device)
    while intr.ndim < x.ndim:
        intr = intr[:, None]
    f = intr[..., :2]
    c = intr[..., 2:4]
    z = x[..., 2:]
    z = torch.where(z.abs() < 1e-4,
                    torch.where(z < 0, -1e-4, 1e-4).to(z.dtype), z)
    xy = torch.clamp(x[..., :2] / z, -1.0, 1.0)
    if intr.shape[-1] == 9:
        k = intr[..., 4:7]
        p = intr[..., 7:9]
        r2 = (xy ** 2).sum(-1, keepdim=True)
        radial = 1 + (k * torch.cat((r2, r2 ** 2, r2 ** 3), -1)).sum(
            -1, keepdim=True)
        tan = (p * xy).sum(-1, keepdim=True)
        xy = xy * (radial + tan) + p * r2
    return f * xy + c


def semi_supervision_loss(labeled_pose, unlabeled_pose, unlabeled_traj,
                          unlabeled_target_2d, intrinsics, joint_parents,
                          projection_loss_weight=1.0, bone_loss_weight=1.0,
                          warmup=None):
    """VideoPose3D's semi-supervision on unlabelled windows
    (regression_loss.py:360-449): the MPJPE between the re-projected pose +
    trajectory and the 2D detections, and the bone-length consistency
    between the unlabelled and the labelled poses. `warmup` is the host's
    0/1 gate (n_steps >= warmup iterations): at 0 neither term is computed
    and both are zeros, as JAX's lax.cond skips the branch (a product with
    0 would carry an untrained trajectory head's inf into NaN). Returns
    {'proj_loss', 'bone_loss'}."""
    if warmup is not None and not float(warmup) > 0.5:
        zero = torch.zeros((), dtype=torch.float32,
                           device=unlabeled_pose.device)
        return {'proj_loss': zero, 'bone_loss': zero.clone()}
    proj = project_joints(unlabeled_pose + unlabeled_traj, intrinsics)
    loss_proj = mpjpe_loss(proj, unlabeled_target_2d,
                           loss_weight=projection_loss_weight)
    loss_bone = bone_loss(unlabeled_pose, labeled_pose, joint_parents,
                          loss_weight=bone_loss_weight)
    return {'proj_loss': loss_proj.float(), 'bone_loss': loss_bone.float()}


def l1_loss(pred, target, target_weight=None, loss_weight=1.0):
    """The elementwise mean absolute error, weighted as `_weighted`."""
    pred, target = _weighted(pred, target, target_weight)
    return (pred - target).abs().mean() * loss_weight


def bce_loss(pred, target, target_weight=None, loss_weight=1.0):
    """Binary cross-entropy on probabilities clipped to [1e-7, 1 - 1e-7]
    (reference classfication_loss.py:9), target_weight broadcast over the
    trailing axes."""
    p = pred.clamp(1e-7, 1.0 - 1e-7)
    loss = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    if target_weight is not None:
        w = target_weight
        while w.ndim < loss.ndim:
            w = w[..., None]
        loss = loss * w
    return loss.mean() * loss_weight


def gan_loss(pred, target_is_real, gan_type='vanilla', loss_weight=1.0):
    """The SMPL discriminator's objective (reference mesh_loss.py
    `GANLoss`): 'vanilla' BCE on logits, 'lsgan' MSE, 'wgan' +-mean."""
    if gan_type == 'wgan':
        loss = -pred.mean() if target_is_real else pred.mean()
        return loss * loss_weight
    target = torch.ones_like(pred) if target_is_real \
        else torch.zeros_like(pred)
    if gan_type == 'vanilla':
        loss = (pred.clamp_min(0) - pred * target
                + torch.log1p(torch.exp(-pred.abs()))).mean()
    elif gan_type == 'lsgan':
        loss = ((pred - target) ** 2).mean()
    else:
        raise ValueError(gan_type)
    return loss * loss_weight


def mesh_joint_loss(pred_joints_3d, gt_joints_3d, joints_3d_visible,
                    loss_weight=1.0, pelvis_ids=None):
    """L1 joint loss of mesh training (reference mesh_loss.py
    `joints_3d_loss` / `joints_2d_loss`); with `pelvis_ids` (the hips) both
    poses are first centred on the hips' midpoint."""
    pred, gt = pred_joints_3d, gt_joints_3d
    if pelvis_ids is not None:
        i, j = pelvis_ids
        pred = pred - (pred[:, i:i + 1] + pred[:, j:j + 1]) / 2
        gt = gt - (gt[:, i:i + 1] + gt[:, j:j + 1]) / 2
    conf = joints_3d_visible[..., None]
    return ((pred - gt).abs() * conf).mean() * loss_weight


def smpl_param_loss(pred_params, gt_params, has_smpl, loss_weight=1.0):
    """MSE over SMPL parameters on the samples that have them."""
    return (((pred_params - gt_params) ** 2) * has_smpl[..., None]).mean() \
        * loss_weight

"""PoseLifter (VideoPose3D, SimpleBaseline3D) training loop, config-driven.

Counterpart of vitpose_tpu/train/lifter_loop.py:35-267: windows of
Body3DH36MDataset ([N, T, K, 2] 2D keypoints) -> the TCN lifter -> the
loss on root-relative 3D -> Adam with a per-epoch staircase exponential
decay (`lr_decay`).

Inputs follow the reference pipelines: the 2D window normalised by the
frame's camera sensor (ImageCoordinateNormalization), the 3D target
root-centred, and RelativeJointRandomFlip at 50% (input mirrored about
x = 0, target about the root); or, with `joint_2d_normalize` /
`joint_3d_normalize` (SimpleBaseline3D), mean/std-normalised inputs and
targets, `remove_root` and the MSE, without flips. With
`data.semi_supervised` and `model.with_traj` each step is VideoPose3D's
semi-supervised one: a labelled pass (pose MPJPE and the trajectory head's
MPJPE on the global root), then an unlabelled pass on the BN statistics the
labelled pass left (the running statistics move twice per step, in that
order), and the projection and bone losses on it once the step count
reaches the warm-up (`loss_semi.warmup_iterations`, or `warmup_epochs` x
the steps per epoch). Dropout draws from a torch.Generator seeded per step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.body3d import (Body3DH36MDataset, flip_relative_pose,
                           load_joint_normalize)
from ..data.dataset_info import DatasetInfo
from ..models.losses import mpjpe_loss, mse_loss, semi_supervision_loss
from .family_loop import (adam, adam_step, log_val_stats,
                          resume_loop_weights, save_best_ckpt,
                          save_loop_outputs, should_eval)
from .loop import build_model_from_cfg, step_seed

H36M_PARENTS = [0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15]


def _build_dataset(dcfg, entry):
    return Body3DH36MDataset(
        entry['ann_file'], seq_len=dcfg.get('seq_len', 27),
        seq_frame_interval=dcfg.get('seq_frame_interval', 1),
        causal=dcfg.get('causal', False), det_file=entry.get('det_file'),
        camera_param_file=entry.get('camera_param_file'))


def labeled_batch(ds, idxs, flip_pairs, rng, norm2d=None, norm3d=None,
                  remove_root=False):
    """(input_2d [B, T, K, 2], root-centred target [B, K', 3], root [B, 1,
    3]) as numpy, flipped at 50% when `rng` is given. `norm2d`/`norm3d` are
    (mean, std): the 2D input normalised in pixels instead of by the camera,
    the target normalised after `remove_root`; norm2d turns the flip off
    (the reference's normalised recipe has none)."""
    if norm2d is not None:
        rng = None
    xs, ys, roots = [], [], []
    for i in idxs:
        s = ds[int(i)]
        if norm2d is not None:
            x = ((np.asarray(s['input_2d'], np.float32) - norm2d[0])
                 / norm2d[1])
        else:
            x = ds.normalize_2d(s['input_2d'], s['target_idx'])
        y = np.asarray(s['target_3d'], np.float32)
        root = y[:1].copy()
        y = y - root
        if rng is not None and rng.rand() < 0.5:
            x = flip_relative_pose(x, flip_pairs)
            y = flip_relative_pose(y, flip_pairs)
        if remove_root:
            y = y[1:]
        if norm3d is not None:
            y = (y - norm3d[0]) / norm3d[1]
        xs.append(x)
        ys.append(y)
        roots.append(root)
    return np.stack(xs), np.stack(ys), np.stack(roots)


def unlabeled_batch(ds, idxs, flip_pairs, rng):
    """(input_2d, the target frame's normalised 2D detections, normalised
    intrinsics [B, 9]) as numpy; a flip also negates c_x (flip_camera)."""
    xs, t2ds, intrs = [], [], []
    for i in idxs:
        s = ds[int(i)]
        ti = s['target_idx']
        x = ds.normalize_2d(s['input_2d'], ti)
        t2d = ds.normalize_2d(np.asarray(s['input_2d'])[
            -1 if ds.causal else len(s['input_2d']) // 2], ti)
        intr = ds.normalized_intrinsics(ti)
        if rng is not None and rng.rand() < 0.5:
            x = flip_relative_pose(x, flip_pairs)
            t2d = flip_relative_pose(t2d, flip_pairs)
            intr = intr.copy()
            intr[2] = -intr[2]
        xs.append(x)
        t2ds.append(t2d)
        intrs.append(intr)
    return np.stack(xs), np.stack(t2ds), np.stack(intrs)


def lifter_step(model, optimizer, scheduler, x, y_rel, generator,
                loss='mpjpe'):
    """One supervised step in place; returns {'mpjpe_loss'} (the
    configured loss, MSE for SimpleBaseline3D, under JAX's name)."""
    model.train()
    out = model(x, generator)
    value = (mse_loss if loss == 'mse' else mpjpe_loss)(out, y_rel)
    optimizer.zero_grad(set_to_none=True)
    value.backward()
    adam_step(optimizer, scheduler)
    return dict(mpjpe_loss=value.detach())


def lifter_semi_step(model, optimizer, scheduler, x, y_rel, root, xu, t2d,
                     intr, warm, generator, scfg):
    """One semi-supervised step in place: the labelled pass, then the
    unlabelled one (BN on its own batch, its running statistics moving
    after the labelled pass's), pose and trajectory MPJPE plus the gated
    projection and bone losses. Returns the four losses."""
    model.train()
    pose, traj = model(x, generator)
    upose, utraj = model(xu, generator)
    l_pose = mpjpe_loss(pose, y_rel)
    l_traj = mpjpe_loss(traj, root)
    sl = semi_supervision_loss(
        pose, upose, utraj, t2d, intr,
        scfg.get('joint_parents', H36M_PARENTS),
        projection_loss_weight=scfg.get('projection_loss_weight', 1.0),
        bone_loss_weight=scfg.get('bone_loss_weight', 1.0), warmup=warm)
    total = l_pose + l_traj + sl['proj_loss'] + sl['bone_loss']
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    adam_step(optimizer, scheduler)
    return dict(mpjpe_loss=l_pose.detach(), traj_loss=l_traj.detach(),
                proj_loss=sl['proj_loss'].detach(),
                bone_loss=sl['bone_loss'].detach())


def train_pose_lifter_model(cfg: dict, work_dir: Optional[str] = None,
                            resume: bool = False,
                            max_steps: Optional[int] = None, device='cuda'):
    """Train a pose_lifter config (configs/body3d/) on `device` (CUDA
    unless the caller passes 'cpu'). Returns (model, last step's
    metrics)."""
    from ..api.inference import _device
    dev = _device(device)
    seed = cfg.get('seed', 0)
    model = build_model_from_cfg(cfg['model'],
                                 torch.Generator().manual_seed(seed))
    dcfg = cfg['data']
    semi = bool(dcfg.get('semi_supervised')) and \
        bool(cfg['model'].get('with_traj'))
    norm2d = load_joint_normalize(cfg.get('joint_2d_normalize'))
    norm3d = load_joint_normalize(cfg.get('joint_3d_normalize'))
    remove_root = bool(cfg['model'].get('remove_root'))
    loss_name = cfg['model'].get('loss', 'mpjpe')
    ds = _build_dataset(dcfg, dcfg['train'])
    ds_unlabeled = (_build_dataset(dcfg, dcfg.get('train_unlabeled',
                                                  dcfg['train']))
                    if semi else None)
    flip_pairs = DatasetInfo.load(dcfg.get('dataset', 'h36m')).flip_pairs
    batch_size = dcfg.get('batch_size', 128)
    ocfg = cfg.get('optimizer', {})
    base_lr = ocfg.get('base_lr', 1e-3)
    lr_decay = ocfg.get('lr_decay', 1.0)
    steps_per_epoch = max(1, len(ds) // batch_size)
    scfg = cfg.get('loss_semi', {})
    warmup_iters = (scfg['warmup_iterations'] if 'warmup_iterations' in scfg
                    else scfg.get('warmup_epochs', 5) * steps_per_epoch)
    resume_loop_weights(cfg, work_dir, model, resume)
    model.to(dev)
    # Adam over the parameters: JAX steps the BN statistics too, with zero
    # gradients and so zero updates
    optimizer, scheduler = adam(
        model.parameters(), base_lr,
        lambda c: base_lr * lr_decay ** (c // steps_per_epoch))
    generator = torch.Generator(device=dev)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    metrics = {}
    n_steps = 0
    best = None
    order = np.arange(len(ds))
    for epoch in range(ocfg.get('total_epochs', 160)):
        ep_rng = np.random.RandomState(seed + epoch)
        ep_rng.shuffle(order)
        for b in range(steps_per_epoch):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            if len(idxs) < batch_size:
                idxs = np.concatenate([idxs, order[:batch_size
                                                   - len(idxs)]])
            flip_rng = ep_rng if dcfg.get('flip_aug', True) else None
            x, y_rel, roots = labeled_batch(
                ds, idxs, flip_pairs, flip_rng, norm2d=norm2d,
                norm3d=norm3d, remove_root=remove_root)
            generator.manual_seed(step_seed(seed, n_steps))
            if semi:
                u_idxs = ep_rng.randint(0, len(ds_unlabeled), batch_size)
                xu, t2d, intr = unlabeled_batch(ds_unlabeled, u_idxs,
                                                flip_pairs, flip_rng)
                metrics = lifter_semi_step(
                    model, optimizer, scheduler, put(x), put(y_rel),
                    put(roots), put(xu), put(t2d), put(intr),
                    float(n_steps >= warmup_iters), generator, scfg)
            else:
                metrics = lifter_step(model, optimizer, scheduler, put(x),
                                      put(y_rel), generator, loss_name)
            n_steps += 1
            if max_steps is not None and n_steps >= max_steps:
                break
        else:
            if should_eval(cfg, epoch):
                from ..eval.families import evaluate_pose_lifter
                stats = evaluate_pose_lifter(cfg, model)
                log_val_stats(cfg, work_dir, stats, epoch + 1)
                best = save_best_ckpt(cfg, work_dir, stats, model, best)
            continue
        break
    metrics = {k: float(v) for k, v in metrics.items()}
    save_loop_outputs(cfg, work_dir, model, metrics, n_steps)
    return model, metrics

"""PoseWarper (video top-down) training loop, config-driven.

Counterpart of vitpose_tpu/train/posewarper_loop.py:25-252 (`load_window`,
`train_posewarper_model`): windows of PoseTrackVideoDataset records (the
key frame first) share the key frame's affine; the key frame's joints make
the MSRA heatmap target; each step runs the backbone over every frame, the
deformable temporal aggregation with the train frame weights, the heatmap
head, the joints MSE and Adam under a piecewise-constant schedule (x 0.1 at
each of `decay_epochs`). The neck's `trans_layer` stays frozen unless
`model.neck.freeze_trans_layer=False` (its update is exactly zero, as JAX's
optax.masked(set_to_zero()) gives). The work dir gets `final.pth` and
`train.log.json`, and `best.pth` where `save_best` names a metric;
`resume` loads `final.pth` and restarts the optimizer
(train/family_loop.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..data.posetrack import PoseTrackVideoDataset
from ..models.losses import joints_mse_loss
from ..ops.geometry import affine_matrix, bbox_xywh2cs
from ..ops.target import generate_msra_heatmaps
from .bottomup_loop import piecewise_constant_lr
from ..parallel.mesh import shard_rows
from .family_loop import (adam, adam_step, data_parallel, final_metrics,
                          log_val_stats, resume_loop_weights, save_best_ckpt,
                          save_loop_outputs, should_eval)


def load_window(rec, image_size, flip_pairs=(), rng=None, flip_prob=0.5,
                scale_factor=0.35, rot_factor=45, rot_prob=0.6, info=None,
                half_body_prob=0.0, num_joints_half_body=8):
    """One record -> (frames [T, H, W, 3] normalised f32, joints [K, 2] in
    crop pixels, visible [K], center [2], scale [2]).

    Every frame takes the key frame's affine. rng=None is the test
    pipeline; with `rng`, the draws in JAX's order: flip, half-body (with
    `info`, at `half_body_prob`), scale, rotation."""
    import cv2
    iw, ih = int(image_size[0]), int(image_size[1])
    imgs = [cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2RGB)
            for f in rec['image_files']]
    joints = rec['joints_3d'][:, :2].astype(np.float32).copy()
    vis = (rec['joints_3d_visible'][:, 0] > 0).astype(np.float32)
    if 'center' in rec and 'scale' in rec:
        c = np.asarray(rec['center'], np.float32).copy()
        s = np.asarray(rec['scale'], np.float32).copy()
    else:
        c, s = bbox_xywh2cs(rec['bbox'], aspect_ratio=iw / ih)
        c, s = c.numpy().copy(), s.numpy().copy()
    rot = 0.0
    if rng is not None:
        if rng.rand() <= flip_prob and len(flip_pairs):
            w = imgs[0].shape[1]
            imgs = [im[:, ::-1].copy() for im in imgs]
            for a, b in flip_pairs:
                joints[[a, b]] = joints[[b, a]]
                vis[[a, b]] = vis[[b, a]]
            joints[:, 0] = w - joints[:, 0] - 1
            c[0] = w - c[0] - 1
        if (info is not None and vis.sum() > num_joints_half_body
                and rng.rand() < half_body_prob):
            upper = [j for j in info.upper_body_ids if vis[j] > 0]
            lower = [j for j in range(info.num_joints)
                     if j not in info.upper_body_ids and vis[j] > 0]
            sel = (upper if (rng.randn() < 0.5 and len(upper) > 2)
                   else lower if len(lower) > 2 else upper)
            if len(sel) >= 2:
                pts = joints[sel]
                lt, rb = pts.min(axis=0), pts.max(axis=0)
                w2, h2 = rb[0] - lt[0], rb[1] - lt[1]
                ar = iw / ih
                if w2 > ar * h2:
                    h2 = w2 / ar
                elif w2 < ar * h2:
                    w2 = h2 * ar
                c = pts.mean(axis=0).astype(np.float32)
                s = np.array([w2 / 200.0, h2 / 200.0], np.float32) * 1.5
        sf, rf = scale_factor, rot_factor
        s = s * np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
        rot = (np.clip(rng.randn() * rf, -rf * 2, rf * 2)
               if rng.rand() <= rot_prob else 0.0)
    mat = affine_matrix(c[None], s[None], np.asarray([rot], np.float32),
                        (iw, ih)).numpy()[0]
    crops = [cv2.warpAffine(im.astype(np.float32), mat, (iw, ih),
                            flags=cv2.INTER_LINEAR) for im in imgs]
    frames = np.stack(crops) / 255.0
    frames = (frames - IMAGENET_MEAN) / IMAGENET_STD
    jw = np.concatenate([joints, np.ones((len(joints), 1), np.float32)],
                        axis=1) @ mat.T
    return frames.astype(np.float32), jw[:, :2].astype(np.float32), \
        vis, c, s


def trainable_parameters(model, cfg: dict):
    """The parameters the optimizer steps: all but the neck's trans_layer
    unless the config sets neck.freeze_trans_layer=False (reference
    posewarper_neck.py freeze_trans_layer, True by default)."""
    freeze = cfg['model'].get('neck', {}).get('freeze_trans_layer', True)
    return [p for name, p in model.named_parameters()
            if not (freeze and name.startswith('neck.trans_layer.'))]


def posewarper_step(model, optimizer, scheduler, frames, target, weight,
                    frame_weight):
    """One step in place: the training-mode forward of [N, T, H, W, 3]
    windows (the key frame first), the joints MSE against the key frame's
    targets, Adam. Returns {'heatmap_loss'}."""
    model.train()
    out = model(frames, frame_weight=frame_weight, key_index=0)
    loss = joints_mse_loss(out, target, weight)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    adam_step(optimizer, scheduler)
    return dict(heatmap_loss=loss.detach())


@data_parallel(16)
def train_posewarper_model(cfg: dict, work_dir: Optional[str] = None,
                           resume: bool = False,
                           max_steps: Optional[int] = None, device='cuda'):
    """Train a posewarper config (configs/posetrack/
    posewarper_hrnet_w48_posetrack18.py) on `device` (CUDA unless the
    caller passes 'cpu'). Returns (model, last step's metrics)."""
    from ..api.inference import _device
    from .loop import build_model_from_cfg
    dev = _device(device)
    seed = cfg.get('seed', 0)
    model = build_model_from_cfg(cfg['model'],
                                 torch.Generator().manual_seed(seed))
    dcfg = cfg['data']
    image_size = tuple(dcfg.get('image_size', (288, 384)))
    heatmap_size = tuple(dcfg.get('heatmap_size', (72, 96)))
    # the stage-2 recipe: one random adjacent support per record unless
    # frame_indices_train pins them; data.frame_indices is the test window
    tr = dcfg['train']
    ds = PoseTrackVideoDataset(
        tr['ann_file'], tr.get('img_prefix', ''), image_size=image_size,
        heatmap_size=heatmap_size,
        frame_indices_train=(list(dcfg['frame_indices_train'])
                             if dcfg.get('frame_indices_train') else None),
        frame_index_rand=dcfg.get('frame_index_rand', True),
        frame_index_range=dcfg.get('frame_index_range', (-2, 2)),
        num_adj_frames=dcfg.get('num_adj_frames', 1),
        frame_weight_train=tuple(dcfg.get('frame_weight_train',
                                          (0.0, 1.0))),
        seed=seed)
    batch_size = dcfg.get('batch_size', 16)
    sigma = cfg.get('target', {}).get('sigma', 3.0)
    aug = dcfg.get('aug', {})
    ocfg = cfg.get('optimizer', {})
    steps_per_epoch = max(1, len(ds) // batch_size)
    base_lr = ocfg.get('base_lr', 1e-4)
    lr = piecewise_constant_lr(base_lr, [e * steps_per_epoch for e in
                                         ocfg.get('decay_epochs', ())])
    resume_loop_weights(cfg, work_dir, model, resume)
    model.to(dev)
    optimizer, scheduler = adam(trainable_parameters(model, cfg), base_lr,
                                lr)
    t = ds.num_frames
    train_fw = torch.as_tensor(ds.db[0]['frame_weight'] if len(ds.db)
                               else np.full((t,), 1.0 / t, np.float32),
                               device=dev)

    metrics = {}
    n_steps = 0
    best = None
    order = np.arange(len(ds))
    for epoch in range(ocfg.get('total_epochs', 20)):
        prng = np.random.RandomState(seed + epoch)
        prng.shuffle(order)
        for b in range(steps_per_epoch):
            idxs = order[b * batch_size:(b + 1) * batch_size]
            if len(idxs) < batch_size:
                idxs = np.concatenate([idxs,
                                       order[:batch_size - len(idxs)]])
            windows = [load_window(
                ds.db[int(i)], image_size, flip_pairs=ds.info.flip_pairs,
                rng=prng, flip_prob=aug.get('flip_prob', 0.5),
                scale_factor=aug.get('scale_factor', 0.35),
                rot_factor=aug.get('rot_factor', 45),
                rot_prob=aug.get('rot_prob', 0.6), info=ds.info,
                half_body_prob=aug.get('half_body_prob', 0.3))
                for i in idxs]
            # every rank loads the global batch (one augmentation stream)
            # and keeps its rows
            frames, joints, vis = shard_rows(tuple(
                np.stack([w[j] for w in windows]) for j in range(3)))
            frames = torch.from_numpy(frames)
            target, weight = generate_msra_heatmaps(
                torch.from_numpy(joints).to(dev),
                torch.from_numpy(vis).to(dev),
                image_size, heatmap_size, sigma=sigma)
            metrics = posewarper_step(model, optimizer, scheduler,
                                      frames.to(dev), target, weight,
                                      train_fw)
            n_steps += 1
            if max_steps is not None and n_steps >= max_steps:
                break
        else:
            if should_eval(cfg, epoch):
                from ..eval.families import evaluate_posewarper
                stats = evaluate_posewarper(cfg, model)
                log_val_stats(cfg, work_dir, stats, epoch + 1)
                best = save_best_ckpt(cfg, work_dir, stats, model, best)
            continue
        break
    metrics = final_metrics(metrics)
    save_loop_outputs(cfg, work_dir, model, metrics, n_steps)
    return model, metrics

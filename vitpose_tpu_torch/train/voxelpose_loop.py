"""VoxelPose training: Panoptic multiview frames -> the centre and pose
nets.

Counterpart of vitpose_tpu/train/voxelpose_loop.py
(`heatmap_frame_cameras`, `gt_projected_heatmaps`, `train_voxelpose_model`
:69; reference multiview_pose.py `VoxelCenterDetector.forward_train` and
`VoxelSinglePose.forward_train`): per frame the views' 2D heatmaps are
Gaussians painted at the GT projections (the frozen-2D regime; or a
callable `heatmap_source(frame, cameras)`), the centre target is the roots'
voxel Gaussians over the space grid, and the pose net trains on cubes at the
GT roots (candidates padded to `max_people_train` with the space centre,
masked out of the loss). `data.batch_size` frames make one step
(`DetectAndRegress.training_losses_batched`), Adam over the parameters.
Host numpy builds every array; the step runs on the device.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..data.panoptic_mview import PanopticMviewDataset
from ..models.voxelpose import camera_tensors, stack_camera_params
from ..ops.target import generate_voxel_3d_targets
from ..parallel.mesh import shard_rows
from .family_loop import (adam, adam_step, data_parallel, final_metrics,
                          log_val_stats, resume_loop_weights, save_best_ckpt,
                          save_loop_outputs, should_eval)
from .loop import build_model_from_cfg


def heatmap_frame_cameras(cameras, heatmap_size):
    """Each camera rescaled from its sensor resolution to heatmap pixels
    (h, w) = heatmap_size."""
    h, w = heatmap_size
    out = []
    for cam in cameras:
        rw, rh = getattr(cam, 'resolution', (1920, 1080))
        out.append(cam.scaled(w / float(rw), h / float(rh)))
    return out


def gt_projected_heatmaps(frame, cameras, num_joints, heatmap_size,
                          sigma_px=2.0):
    """[V, K, H, W] Gaussians at each camera's projections of the frame's
    GT joints (people max-combined); `cameras` in the heatmap pixel
    frame."""
    h, w = heatmap_size
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    maps = np.zeros((len(cameras), num_joints, h, w), np.float32)
    for vi, cam in enumerate(cameras):
        for person in frame['people']:
            pts = np.asarray(cam.camera_to_pixel(cam.world_to_camera(
                person['joints_3d'])))
            vis = person['joints_vis'] > 0
            for k in range(min(num_joints, pts.shape[0])):
                if not vis[k]:
                    continue
                g = np.exp(-((xs - pts[k, 0]) ** 2 + (ys - pts[k, 1]) ** 2)
                           / (2 * sigma_px ** 2))
                maps[vi, k] = np.maximum(maps[vi, k], g)
    return maps


def frame_arrays(model, frame, hm_size, max_p, root_id, sigma_mm,
                 heatmap_source='gt'):
    """One frame -> fixed-shape numpy arrays (people padded to `max_p`):
    heatmaps, cam (stack_camera_params), candidates, cand_mask, gt_joints,
    gt_vis, targets_3d; None for a frame without cameras or people."""
    cameras = heatmap_frame_cameras(frame['cameras'], hm_size)
    people = [p for p in frame['people']
              if (p['joints_vis'] > 0).any()][:max_p]
    if not cameras or not people:
        return None
    gt_joints = np.stack([p['joints_3d'] for p in people])
    gt_vis = np.stack([(p['joints_vis'] > 0).astype(np.float32)
                       for p in people])
    # the body centre (Panoptic coco19 joint 2, the config's root_id)
    roots = gt_joints[:, root_id]
    if callable(heatmap_source):
        heatmaps = heatmap_source(frame, cameras)
    else:
        heatmaps = gt_projected_heatmaps(frame, cameras, model.num_joints,
                                         hm_size)
    targets_3d = generate_voxel_3d_targets(
        roots[:, None], np.ones(roots.shape[:1] + (1, 1)),
        model.space_size, model.space_center, model.space_resolution,
        sigma=sigma_mm, joint_indices=[0])
    npad = max_p - len(people)
    k = gt_joints.shape[1]
    pad_root = np.tile(np.asarray(model.space_center, np.float32),
                       (npad, 1))
    return dict(
        heatmaps=np.asarray(heatmaps, np.float32),
        cam=stack_camera_params(cameras),
        candidates=np.concatenate([roots, pad_root]).astype(np.float32),
        cand_mask=np.concatenate([np.ones(len(people)),
                                  np.zeros(npad)]).astype(np.float32),
        gt_joints=np.concatenate([gt_joints, np.zeros((npad, k, 3))])
        .astype(np.float32),
        gt_vis=np.concatenate([gt_vis, np.zeros((npad, k))])
        .astype(np.float32),
        targets_3d=np.asarray(targets_3d, np.float32))


def stack_frames(frames, dev):
    """A list of frame_arrays -> the step's tensors on `dev`, a leading
    frame axis on every array (the cameras' too)."""
    out = {k: torch.from_numpy(np.stack([f[k] for f in frames])).to(dev)
           for k in frames[0] if k != 'cam'}
    out['cam'] = camera_tensors({k: np.stack([f['cam'][k] for f in frames])
                                 for k in frames[0]['cam']}, dev)
    return out


def voxelpose_step(model, optimizer, scheduler, batch):
    """One step in place on stack_frames' batch: the training-mode losses
    (BN statistics move in place), Adam. Returns the losses and their sum
    (tensors)."""
    model.train()
    losses = model.training_losses_batched(
        batch['heatmaps'], batch['cam'], batch['candidates'],
        batch['cand_mask'], batch['gt_joints'], batch['gt_vis'],
        batch['targets_3d'])
    total = losses['loss_center'] + losses['loss_pose']
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    adam_step(optimizer, scheduler)
    return dict({k: v.detach() for k, v in losses.items()},
                total_loss=total.detach())


@data_parallel(1)
def train_voxelpose_model(cfg: dict, work_dir: Optional[str] = None,
                          resume: bool = False,
                          max_steps: Optional[int] = None,
                          heatmap_source: Union[str, Callable] = 'gt',
                          device='cuda'):
    """Train a voxelpose config (configs/body3d/voxelpose_prn64x64x64_
    cpn80x80x20_panoptic_cam5.py) on `device` (CUDA unless the caller
    passes 'cpu'). Returns (model, last step's losses)."""
    from ..api.inference import _device
    dev = _device(device)
    mcfg = cfg['model']
    model = build_model_from_cfg(
        mcfg, torch.Generator().manual_seed(cfg.get('seed', 0)))
    dcfg = cfg['data']
    train_cfg = dcfg.get('train', {})
    seq_dirs = train_cfg.get('seq_dirs') or [
        str(p) for p in train_cfg.get('seq_list', [])]
    ds = PanopticMviewDataset(seq_dirs, cam_names=train_cfg.get('cam_names'),
                              num_joints=mcfg.get('num_joints', 15))
    hm_size = tuple(train_cfg.get('heatmap_size',
                                  dcfg.get('heatmap_size', (64, 64))))[::-1]
    sigma_mm = cfg.get('target', {}).get('sigma', 200.0)
    resume_loop_weights(cfg, work_dir, model, resume)
    model.to(dev)
    ocfg = cfg.get('optimizer', {})
    lr = ocfg.get('base_lr', 1e-4)
    optimizer, scheduler = adam(model.parameters(), lr, lambda c: lr)
    root_id = mcfg.get('root_id', 2)
    g_frames = dcfg.get('batch_size', 1)
    max_p = mcfg.get('max_people_train', mcfg.get('max_people', 10))
    metrics = {}
    n_steps = 0
    best = None
    pending = []
    for epoch in range(ocfg.get('total_epochs', 15)):
        for idx in range(len(ds)):
            fa = frame_arrays(model, ds[idx], hm_size, max_p, root_id,
                              sigma_mm, heatmap_source)
            if fa is None:
                continue
            if pending and fa['heatmaps'].shape != \
                    pending[0]['heatmaps'].shape:
                continue          # mixed view counts do not stack
            pending.append(fa)
            if len(pending) < g_frames:
                continue
            batch = stack_frames(shard_rows(pending), dev)
            pending = []
            metrics = voxelpose_step(model, optimizer, scheduler, batch)
            n_steps += 1
            if max_steps is not None and n_steps >= max_steps:
                metrics = final_metrics(metrics)
                save_loop_outputs(cfg, work_dir, model, metrics, n_steps)
                return model, metrics
        if should_eval(cfg, epoch):
            from ..eval.families import evaluate_voxelpose
            stats = evaluate_voxelpose(cfg, model)
            log_val_stats(cfg, work_dir, stats, epoch + 1)
            best = save_best_ckpt(cfg, work_dir, stats, model, best)
    metrics = final_metrics(metrics)
    save_loop_outputs(cfg, work_dir, model, metrics, n_steps)
    return model, metrics

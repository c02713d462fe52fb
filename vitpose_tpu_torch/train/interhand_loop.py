"""InterHand3D (InterNet) training: the loader, the step and the loop.

Counterpart of vitpose_tpu/train/interhand_loop.py (`InterHandLoader` :22,
`make_interhand_train_step` :127, `train_interhand3d_model` :172;
reference res50_interhand3d_all_256x256.py): the host crops each record
with cv2 (training: the hand flip with the joint, hand-type and root-depth
swaps, the random translation, scale and rotation, JAX's RandomState
draws) and paints the whole target group (the 2.5D volumes, the root depth
and the hand type); the step runs the forward in training mode (BN
statistics move in place), the three losses and AdamW (optax.adamw at the
config's weight decay, 0 by default, and a constant lr, as JAX's). The
loop keeps weights only (`family_loop`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.interhand import InterHandDataset, training_targets
from ..models.interhand3d import interhand3d_losses
from ..ops.geometry import (affine_matrix, apply_affine_to_points,
                            bbox_xywh2cs)
from .family_loop import (adam, adam_step, log_val_stats,
                          resume_loop_weights, save_best_ckpt,
                          save_loop_outputs, should_eval)
from .loop import build_model_from_cfg


class InterHandLoader:
    """Batches (numpy) of imgs [N, H, W, 3] in [0, 1], hm3d, hm_weight,
    rel_root_mm, root_weight, hand_type and type_weight from an
    InterHandDataset; a short last batch is padded from the epoch's
    start."""

    def __init__(self, dataset: InterHandDataset, batch_size,
                 image_size=(256, 256), heatmap_size=(64, 64, 64),
                 depth_bound=400.0, root_depth_bins=64,
                 root_depth_bound=400.0, sigma=2.5, seed=0, is_train=True):
        self.ds = dataset
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        self.heatmap_size = tuple(heatmap_size)
        self.depth_bound = depth_bound
        self.root_depth_bins = root_depth_bins
        self.root_depth_bound = root_depth_bound
        self.sigma = sigma
        self.seed = seed
        self.is_train = is_train
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return max(1, len(self.ds.db) // self.batch_size)

    def _prepare(self, rec, rng=None):
        """(crop [H, W, 3] f32 in [0, 1], targets) of one record; `rng`
        draws the training augmentations."""
        import cv2
        w, h = self.image_size
        img = cv2.imread(rec['image_file'])
        if img is None:                      # fixture sets without images
            img = np.zeros((256, 256, 3), np.uint8)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        center, scale = bbox_xywh2cs(rec['bbox'], aspect_ratio=w / h)
        center = np.asarray(center, np.float32).copy()
        scale = np.asarray(scale, np.float32).copy()
        rec2 = dict(rec)
        joints = np.asarray(rec['joints_3d'], np.float32).copy()
        vis = np.asarray(rec['joints_3d_visible'], np.float32).copy()
        rot = 0.0
        if rng is not None:
            if rng.rand() < 0.5:             # HandRandomFlip(0.5)
                img = img[:, ::-1].copy()
                width = img.shape[1]
                fi = self.ds.info.flip_index
                joints = joints[fi]
                vis = vis[fi]
                joints[:, 0] = width - 1 - joints[:, 0]
                center[0] = width - 1 - center[0]
                ht = np.asarray(rec['hand_type'], np.float32)
                rec2['hand_type'] = ht[::-1].copy()
                rec2['rel_root_depth'] = -rec['rel_root_depth']
            # TopDownRandomTranslation(0.15), then
            # TopDownGetRandomScaleRotation(rot 45, scale 0.25, prob 0.6)
            center += 0.15 * rng.uniform(-1, 1, 2).astype(np.float32) \
                * scale * 200.0
            scale *= np.clip(rng.randn() * 0.25 + 1, 0.75, 1.25)
            if rng.rand() <= 0.6:
                rot = float(np.clip(rng.randn() * 45.0, -90.0, 90.0))
        mat = np.asarray(affine_matrix(center, scale, rot, (w, h)))
        crop = cv2.warpAffine(img, mat[:2], (w, h), flags=cv2.INTER_LINEAR)
        joints[:, :2] = np.asarray(apply_affine_to_points(
            joints[:, :2], torch.from_numpy(mat)))
        rec2['joints_3d'] = joints
        rec2['joints_3d_visible'] = vis
        tg = training_targets(
            rec2, image_size=self.image_size,
            heatmap_size=self.heatmap_size, depth_bound=self.depth_bound,
            root_depth_bins=self.root_depth_bins,
            root_depth_bound=self.root_depth_bound, sigma=self.sigma)
        return crop.astype(np.float32) / 255.0, tg

    def __iter__(self):
        order = np.arange(len(self.ds.db))
        rng = None
        if self.is_train:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(order)
        bs = self.batch_size
        for b in range(len(self)):
            idxs = order[b * bs:(b + 1) * bs]
            if len(idxs) < bs:
                idxs = np.concatenate([idxs, order[:bs - len(idxs)]])
            crops, tgs = zip(*[self._prepare(self.ds.db[i], rng)
                               for i in idxs])
            yield dict(
                imgs=np.stack(crops),
                hm3d=np.stack([t['hm3d'] for t in tgs]),
                hm_weight=np.stack([t['hm_weight'][:, 0] for t in tgs]),
                rel_root_mm=np.stack([t['rel_root_depth_mm'][0]
                                      for t in tgs]),
                root_weight=np.stack([t['rel_root_weight'][0]
                                      for t in tgs]),
                hand_type=np.stack([t['hand_type'] for t in tgs]),
                type_weight=np.stack([t['hand_type_weight'][0]
                                      for t in tgs]))


def batch_to_device(batch, dev):
    """A loader batch's arrays as f32 tensors on `dev`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
            for k, v in batch.items()}


def interhand_step(model, optimizer, scheduler, batch, root_depth_bins=64,
                   root_depth_bound=400.0):
    """One step in place on a device batch: the training-mode forward, the
    three losses, AdamW. Returns the losses and their sum (tensors)."""
    model.train()
    out = model(batch['imgs'])
    losses = interhand3d_losses(
        out, batch['hm3d'], batch['hm_weight'], batch['rel_root_mm'],
        batch['root_weight'], batch['hand_type'], batch['type_weight'],
        root_depth_bins=root_depth_bins,
        root_depth_range_mm=root_depth_bound)
    total = (losses['hand_loss'] + losses['rel_root_loss']
             + losses['hand_type_loss'])
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    adam_step(optimizer, scheduler)
    return dict({k: v.detach() for k, v in losses.items()},
                total_loss=total.detach())


def interhand_loader(cfg, split='train', is_train=True):
    """The config's InterHandDataset of `split` and its loader."""
    dcfg = cfg['data']
    tcfg = cfg.get('target', {})
    entry = dcfg[split]
    ds = InterHandDataset(entry['ann_file'], entry['camera_file'],
                          entry['joint_file'],
                          img_prefix=entry.get('img_prefix', ''))
    hm_wh = tuple(dcfg.get('heatmap_size', (64, 64)))
    return InterHandLoader(
        ds, dcfg.get('batch_size', 16),
        image_size=tuple(dcfg.get('image_size', (256, 256))),
        heatmap_size=(hm_wh[0], hm_wh[1],
                      cfg['model'].get('depth_size', 64)),
        depth_bound=tcfg.get('depth_bound', 400.0),
        root_depth_bins=tcfg.get('root_depth_bins', 64),
        root_depth_bound=tcfg.get('root_depth_bound', 400.0),
        sigma=tcfg.get('sigma', 2.5), is_train=is_train)


def train_interhand3d_model(cfg: dict, work_dir: Optional[str] = None,
                            resume: bool = False,
                            max_steps: Optional[int] = None, device='cuda'):
    """Train an interhand3d config (configs/hand/res50_interhand3d_all_
    256x256.py) on `device` (CUDA unless the caller passes 'cpu'). Returns
    (model, last step's metrics)."""
    from ..api.inference import _device
    dev = _device(device)
    tcfg = cfg.get('target', {})
    model = build_model_from_cfg(
        cfg['model'], torch.Generator().manual_seed(cfg.get('seed', 0)))
    loader = interhand_loader(cfg)
    resume_loop_weights(cfg, work_dir, model, resume)
    model.to(dev)
    ocfg = cfg.get('optimizer', {})
    lr = ocfg.get('base_lr', 2e-4)
    optimizer, scheduler = adam(model.parameters(), lr, lambda c: lr,
                                weight_decay=ocfg.get('weight_decay', 0.0))
    metrics = {}
    n_steps = 0
    best = None
    for epoch in range(ocfg.get('total_epochs', 20)):
        loader.set_epoch(epoch)
        for batch in loader:
            metrics = interhand_step(
                model, optimizer, scheduler, batch_to_device(batch, dev),
                root_depth_bins=tcfg.get('root_depth_bins', 64),
                root_depth_bound=tcfg.get('root_depth_bound', 400.0))
            n_steps += 1
            if max_steps is not None and n_steps >= max_steps:
                break
        else:
            if should_eval(cfg, epoch):
                from ..eval.families import evaluate_interhand3d
                stats = evaluate_interhand3d(cfg, model)
                log_val_stats(cfg, work_dir, stats, epoch + 1)
                best = save_best_ckpt(cfg, work_dir, stats, model, best)
            continue
        break
    metrics = {k: float(v) for k, v in metrics.items()}
    save_loop_outputs(cfg, work_dir, model, metrics, n_steps)
    return model, metrics

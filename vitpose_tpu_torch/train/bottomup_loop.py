"""Bottom-up (associative embedding) training: loader, step and runner.

Counterpart of vitpose_tpu/train/bottomup_loop.py (the reference
AssociativeEmbedding detector with MultiLossFactory,
mmpose/models/detectors/associative_embedding.py and
losses/multi_loss_factory.py:164):

  * `BottomUpLoader`: seeded batches from a BottomUpCocoDataset on the
    host (cv2): the reference pipeline's random affine, applied per output
    scale so every target is painted at its own resolution, then the random
    flip, then the heatmap painter and the AE joint indices per scale;
  * `make_bottomup_train_step`: forward in training mode (BN batch
    statistics), the masked heatmap MSE of every output against its
    scale's target, the push/pull tag loss of the first output that carries
    tags (factor 0.001 each), the global-norm clip and Adam;
  * `train_bottomup_model`: clip 1.0 + Adam with the piecewise-constant
    x0.1 decays at `decay_epochs`, json-lines logs, a checkpoint of the
    weights, optimizer and schedule every epoch (utils/checkpoint.py, a
    temporary file renamed), `resume` from the latest one.

As in JAX, the configs' `warmup_iters` is not read. Across processes the
runner is data-parallel as JAX's (`data_parallel_step` over the gcd of
the batch and the devices, :372-378): `data.batch_size` is the global
batch, each rank steps its rows of it and BatchNorm sees all of them
(train/family_loop.py `data_parallel`).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..data.bottomup import (BottomUpCocoDataset, bottomup_random_affine,
                             bottomup_random_flip, generate_ae_targets,
                             generate_heatmap_targets, read_rgb)
from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..models.bottomup import resize_bilinear
from ..models.losses import ae_heatmap_loss, ae_tag_loss
from ..parallel.mesh import average_metrics, shard_rows
from ..utils.checkpoint import CheckpointManager
from .family_loop import data_parallel
from .state import TrainState


class BottomUpAugConfig:
    """Reference train recipe knobs (BottomUpRandomAffine +
    BottomUpRandomFlip, e.g. higherhrnet_w32_coco_512x512.py:122-128:
    rot 30, scale [0.75, 1.5], scale_type 'short', trans 40, flip 0.5)."""

    def __init__(self, rot_factor=30.0, scale_factor=(0.75, 1.5),
                 scale_type='short', trans_factor=40, flip_prob=0.5):
        self.rot_factor = rot_factor
        self.scale_factor = tuple(scale_factor)
        self.scale_type = scale_type
        self.trans_factor = trans_factor
        self.flip_prob = flip_prob


def encode_ae_joints(joints, out_size, max_people):
    """JointsEncoder (bottom_up_transform.py:237): [P, K, 3] joints in the
    output map's pixels -> [max_people, K, 2] int32 (truncated-int flat
    index, visibility inside the map)."""
    xi = np.trunc(joints[..., 0]).astype(np.int64)
    yi = np.trunc(joints[..., 1]).astype(np.int64)
    inside = (xi >= 0) & (xi < out_size) & (yi >= 0) & (yi < out_size)
    ae = np.zeros(joints.shape[:2] + (2,), np.int32)
    ae[..., 0] = (np.clip(yi, 0, out_size - 1) * out_size
                  + np.clip(xi, 0, out_size - 1))
    ae[..., 1] = ((joints[..., 2] > 0) & inside).astype(np.int32)
    if ae.shape[0] < max_people:
        ae = np.pad(ae, [(0, max_people - ae.shape[0]), (0, 0), (0, 0)])
    return ae[:max_people]


class BottomUpLoader:
    """Batches of (imgs [N,S,S,3] uint8, per-scale painted heatmap targets
    and masks, AE joint indices [N, M, K, 2]) from a BottomUpCocoDataset,
    as numpy. Epoch e shuffles and augments from
    np.random.RandomState(seed + e), drawing in JAX's order."""

    def __init__(self, dataset: BottomUpCocoDataset, batch_size,
                 output_size=None, output_sizes=None, sigma=2.0, seed=0,
                 is_train=True, use_udp=False,
                 aug: Optional[BottomUpAugConfig] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.input_size = dataset.input_size
        self.output_sizes = tuple(
            output_sizes if output_sizes is not None
            else ([output_size] if output_size is not None
                  else dataset.output_sizes))
        self.sigma = sigma
        self.seed = seed
        self.is_train = is_train
        self.use_udp = use_udp
        self.aug = aug or BottomUpAugConfig()
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return max(1, len(self.ds) // self.batch_size)

    def _train_sample(self, rec, rng):
        """One augmented training record, in the reference pipeline's
        order."""
        img = read_rgb(rec['image_file'])
        mask = self.ds.build_loss_mask(rec)
        joints = rec['joints'].copy()
        a = self.aug
        img, masks, joints_s, _ = bottomup_random_affine(
            img, [mask.copy() for _ in self.output_sizes],
            [joints.copy() for _ in self.output_sizes],
            self.input_size, self.output_sizes, rng,
            rot_factor=a.rot_factor, scale_factor=a.scale_factor,
            scale_type=a.scale_type, trans_factor=a.trans_factor,
            use_udp=self.use_udp)
        img, masks, joints_s, _ = bottomup_random_flip(
            img, masks, joints_s, self.ds.info.flip_index,
            self.output_sizes, rng, flip_prob=a.flip_prob)
        hms = [generate_heatmap_targets(j, o, sigma=self.sigma,
                                        use_udp=self.use_udp)
               for j, o in zip(joints_s, self.output_sizes)]
        ae = encode_ae_joints(joints_s[0], self.output_sizes[0],
                              self.ds.max_people)
        return img, hms, masks, ae

    def _eval_sample(self, rec):
        """Deterministic path: the long side resized onto the square
        canvas, pasted top-left."""
        import cv2
        s = self.input_size
        img = read_rgb(rec['image_file'])
        f = s / max(img.shape[:2])
        resized = cv2.resize(img, (int(round(img.shape[1] * f)),
                                   int(round(img.shape[0] * f))))
        canvas = np.zeros((s, s, 3), np.uint8)
        canvas[:resized.shape[0], :resized.shape[1]] = resized
        joints = rec['joints'].copy()
        joints[..., :2] *= f
        mask = self.ds.build_loss_mask(rec)
        mask = cv2.resize(mask, (resized.shape[1], resized.shape[0]))
        mask_c = np.zeros((s, s), np.float32)
        mask_c[:resized.shape[0], :resized.shape[1]] = mask
        targets = [generate_ae_targets(joints, mask_c, s, o,
                                       sigma=self.sigma,
                                       max_people=self.ds.max_people,
                                       use_udp=self.use_udp)
                   for o in self.output_sizes]
        return (canvas, [t['heatmaps'] for t in targets],
                [t['mask'] for t in targets], targets[0]['ae_joints'])

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        order = np.arange(len(self.ds))
        if self.is_train:
            rng.shuffle(order)
        bs = self.batch_size
        n_scales = len(self.output_sizes)
        for b in range(len(self)):
            imgs, aes = [], []
            hms = [[] for _ in range(n_scales)]
            masks = [[] for _ in range(n_scales)]
            for i in order[b * bs:(b + 1) * bs]:
                rec = self.ds.record(int(i))
                if self.is_train:
                    img, h, m, ae = self._train_sample(rec, rng)
                else:
                    img, h, m, ae = self._eval_sample(rec)
                imgs.append(img)
                aes.append(ae)
                for si in range(n_scales):
                    hms[si].append(h[si])
                    masks[si].append(m[si])
            yield dict(
                imgs=np.stack(imgs),
                heatmaps=np.stack(hms[0]), masks=np.stack(masks[0]),
                multi_heatmaps=tuple(np.stack(h) for h in hms),
                multi_masks=tuple(np.stack(m) for m in masks),
                ae_joints=np.stack(aes))


def batch_to_device(batch, device):
    """A loader batch -> tensors on `device` (tuples stay tuples)."""
    def move(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device, non_blocking=True)
    return {k: (tuple(move(x) for x in v) if isinstance(v, tuple)
                else move(v)) for k, v in batch.items()}


def bottomup_losses(model, batch, push_loss_factor=0.001,
                    pull_loss_factor=0.001, heatmap_loss_factor=1.0,
                    ae_loss_type='exp'):
    """The forward in the model's current mode and the AE losses of a
    device batch: (total, {'heatmap_loss', 'push_loss', 'pull_loss',
    'total_loss'}), each a 0-dim tensor.

    Output i is held to the target painted at scale i (reference
    MultiLossFactory with_heatmaps_loss), a target of another size resized
    to it; the tag loss reads the first output with tag channels, the
    joints' flat indices rescaled to its size.
    """
    k = model.num_joints
    dev = batch['imgs'].device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    x = (batch['imgs'].float() / 255.0 - mean) / std
    outs = model(x)
    tgt_hms = batch.get('multi_heatmaps', (batch['heatmaps'],))
    tgt_masks = batch.get('multi_masks', (batch['masks'],))
    hm_loss = 0.0
    hm = tags = None
    for si, o in enumerate(outs):
        o_hm = o[:, :k]
        size = tuple(o_hm.shape[2:])
        t = tgt_hms[min(si, len(tgt_hms) - 1)]
        m = tgt_masks[min(si, len(tgt_masks) - 1)]
        if tuple(t.shape[2:]) != size:
            t = resize_bilinear(t, size)
        if tuple(m.shape[1:]) != size:
            m = F.interpolate(m[:, None], size=size,
                              mode='nearest-exact')[:, 0]
        hm_loss = hm_loss + ae_heatmap_loss(o_hm, t, m) * heatmap_loss_factor
        if hm is None and o.shape[1] > k:
            hm, tags = o_hm, o[:, k:]
    if hm is None:           # no tag channels anywhere (a no-AE config)
        hm = outs[0][:, :k]
        tags = torch.zeros_like(hm)
    n, th, tw = hm.shape[0], hm.shape[2], hm.shape[3]
    s_t = batch['heatmaps'].shape[2]
    ae = batch['ae_joints']
    ys = (ae[..., 0] // s_t).float() * th / s_t
    xs = (ae[..., 0] % s_t).float() * tw / s_t
    flat = (ys.to(torch.int32).clamp(0, th - 1) * tw
            + xs.to(torch.int32).clamp(0, tw - 1))
    joint_off = torch.arange(k, device=dev, dtype=torch.int32) * th * tw
    ae_flat = torch.stack([flat + joint_off, ae[..., 1]], dim=-1)
    push, pull = ae_tag_loss(tags.reshape(n, k * th * tw, 1), ae_flat,
                             loss_type=ae_loss_type)
    push_loss = push.mean() * push_loss_factor
    pull_loss = pull.mean() * pull_loss_factor
    total = hm_loss + push_loss + pull_loss
    return total, dict(heatmap_loss=hm_loss, push_loss=push_loss,
                       pull_loss=pull_loss, total_loss=total)


def make_bottomup_train_step(model, push_loss_factor=0.001,
                             pull_loss_factor=0.001, heatmap_loss_factor=1.0,
                             ae_loss_type='exp'):
    """train_step(state, batch) -> metrics: one step of `state.model` (a
    BottomUpEstimator; `model` is taken for JAX's signature) on a device
    batch (see batch_to_device): training mode, the AE losses, backward, the
    clip and Adam, in place. Metrics: heatmap_loss, push_loss, pull_loss,
    total_loss and grad_norm (before the clip), 0-dim tensors on the
    device."""
    def train_step(state: TrainState, batch):
        state.model.train(True)
        total, metrics = bottomup_losses(
            state.model, batch, push_loss_factor, pull_loss_factor,
            heatmap_loss_factor, ae_loss_type)
        state.model.zero_grad(set_to_none=True)
        total.backward()
        grad_norm = state.apply_gradients()
        out = {k: v.detach() for k, v in metrics.items()}
        out['grad_norm'] = grad_norm
        return out

    return train_step


def piecewise_constant_lr(base_lr, boundaries):
    """count -> lr: base_lr x 0.1 per boundary the count has reached
    (optax.piecewise_constant_schedule with a scale of 0.1 at each)."""
    return lambda count: base_lr * 0.1 ** sum(count >= b for b in boundaries)


def bottomup_train_state(model, base_lr, boundaries):
    """TrainState of `model` with Adam (torch's defaults are optax.adam's:
    betas 0.9 / 0.999, eps 1e-8) under the piecewise-constant schedule, and
    the global-norm clip at 1.0."""
    optimizer = torch.optim.Adam(model.parameters(), lr=base_lr)
    sched = piecewise_constant_lr(base_lr, boundaries)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda c: sched(c) / base_lr)
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      grad_clip_norm=1.0)


def build_bottomup_loader(cfg: dict):
    """The config's train loader (dataset, augmentation, sigma, seed)."""
    dcfg = cfg['data']
    output_sizes = tuple(dcfg.get('output_sizes', (128,)))
    ds = BottomUpCocoDataset(
        dcfg['train']['ann_file'], dcfg['train']['img_prefix'],
        dataset_info=dcfg.get('dataset', 'coco'),
        input_size=dcfg.get('input_size', 512), output_sizes=output_sizes,
        max_people=dcfg.get('max_people', 30))
    acfg = dcfg.get('aug', {})
    aug = BottomUpAugConfig(
        rot_factor=acfg.get('rot_factor', 30.0),
        scale_factor=tuple(acfg.get('scale_factor', (0.75, 1.5))),
        scale_type=acfg.get('scale_type', 'short'),
        trans_factor=acfg.get('trans_factor', 40),
        flip_prob=acfg.get('flip_prob', 0.5))
    return BottomUpLoader(ds, dcfg.get('batch_size', 24),
                          output_sizes=output_sizes,
                          sigma=cfg.get('target', {}).get('sigma', 2.0),
                          seed=cfg.get('runtime', {}).get('seed', 0),
                          use_udp=dcfg.get('use_udp', False), aug=aug)


@data_parallel(24)
def train_bottomup_model(cfg: dict, work_dir=None, resume=False,
                         max_steps=None, device='cuda'):
    """Epoch loop for the bottom-up AE configs (family 'bottomup') on
    `device`. Logs json lines (train.log.json; `step` is the global step,
    which JAX restarts from 0 on resume) and saves ckpts/epoch_{e}.pth
    after every epoch, also the one that `max_steps` (the steps of this
    call) cuts short, as JAX's runner does; `resume` goes on after the
    latest. Returns the final TrainState."""
    from ..api.inference import _device
    from .loop import _log, build_model_from_cfg
    dev = _device(device)
    rt = cfg.get('runtime', {})
    work_dir = work_dir or rt.get('work_dir', 'work_dirs/bottomup')
    os.makedirs(work_dir, exist_ok=True)
    seed = rt.get('seed', 0)
    model = build_model_from_cfg(cfg['model'],
                                 torch.Generator().manual_seed(seed)).to(dev)
    loader = build_bottomup_loader(cfg)
    ocfg = cfg.get('optimizer', {})
    total_epochs = ocfg.get('total_epochs', 300)
    steps_per_epoch = max(1, len(loader))
    state = bottomup_train_state(
        model, ocfg.get('base_lr', 1.5e-3),
        [e * steps_per_epoch for e in ocfg.get('decay_epochs', (200, 260))])
    ckpt = CheckpointManager(os.path.join(work_dir, 'ckpts'))
    start_epoch = 0
    if resume:
        state, ep = ckpt.restore(state)
        if ep is not None:
            start_epoch = ep + 1
            _log(work_dir, {'mode': 'resume', 'epoch': start_epoch})
    train_step = make_bottomup_train_step(model)
    log_interval = rt.get('log_interval', 50)
    done = 0
    for epoch in range(start_epoch, total_epochs):
        loader.set_epoch(epoch)
        t_epoch = time.time()
        t_data = 0.0
        t_last = time.time()
        for it, batch in enumerate(loader):
            t_data += time.time() - t_last
            # every rank loads the global batch (one augmentation stream)
            # and keeps its rows
            metrics = train_step(state,
                                 batch_to_device(shard_rows(batch), dev))
            done += 1
            if it % log_interval == 0:
                # the one read-back of the step's metrics, the global
                # batch's under a data axis
                metrics = average_metrics(metrics)
                _log(work_dir, dict(
                    mode='train', epoch=epoch, iter=it, step=state.step,
                    data_time=t_data, time=time.time() - t_epoch,
                    **{k: float(v) for k, v in metrics.items()}))
            t_last = time.time()
            if max_steps and done >= max_steps:
                break
        ckpt.save(epoch, state)
        _log(work_dir, {'mode': 'epoch_done', 'epoch': epoch,
                        'secs': time.time() - t_epoch})
        if max_steps and done >= max_steps:
            break
    return state

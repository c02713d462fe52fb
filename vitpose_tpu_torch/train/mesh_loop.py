"""HMR mesh training with the adversarial prior, config-driven.

Counterpart of vitpose_tpu/train/mesh_loop.py (`train_mesh_model` :23;
reference ParametricMesh.train_step with MeshMixDataset and the Mosh
prior): `MeshAdvLoader` batches of the mixed sets with a Mosh sample per
crop, then `models.mesh.adversarial_step` (the generator's Adam, then the
discriminator's, each at its config lr). The work dir's `final.pth` holds
the mesh's state dict and the discriminator's under `discriminator.`;
`best.pth` the same; `--resume` loads both (the optimizers restart).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.mesh import MeshAdvLoader, MeshDataset, MeshMixDataset, \
    MoshDataset
from ..models.mesh import SMPLDiscriminator, adversarial_step
from .family_loop import (adam, log_val_stats, resume_loop_weights,
                          save_best_ckpt, save_loop_outputs, should_eval)
from .loop import build_model_from_cfg

DISC_PREFIX = 'discriminator.'


class MeshPair:
    """The generator and the discriminator as one state dict (the
    discriminator's entries under `discriminator.`), for the loop's
    weights."""

    def __init__(self, mesh, disc):
        self.mesh, self.disc = mesh, disc

    def state_dict(self):
        sd = dict(self.mesh.state_dict())
        sd.update({DISC_PREFIX + k: v
                   for k, v in self.disc.state_dict().items()})
        return sd

    def load_state_dict(self, sd, strict=True):
        n = len(DISC_PREFIX)
        self.disc.load_state_dict({k[n:]: v for k, v in sd.items()
                                   if k.startswith(DISC_PREFIX)}, strict)
        self.mesh.load_state_dict({k: v for k, v in sd.items()
                                   if not k.startswith(DISC_PREFIX)},
                                  strict)


def mesh_batch_to_device(batch, dev):
    """The step's arrays of a loader batch as f32 tensors on `dev` (the
    SMPL ground truth, which the step does not read, stays behind)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
            for k, v in batch.items() if k not in ('pose', 'beta',
                                                   'has_smpl')}


def train_mesh_model(cfg: dict, work_dir: Optional[str] = None,
                     resume: bool = False, max_steps: Optional[int] = None,
                     device='cuda'):
    """Train a mesh config (configs/mesh/hmr_res50_mixed_224x224.py) on
    `device` (CUDA unless the caller passes 'cpu'). Returns (MeshPair,
    last step's losses)."""
    from ..api.inference import _device
    dev = _device(device)
    seed = cfg.get('seed', 0)
    gen = torch.Generator().manual_seed(seed)
    mesh = build_model_from_cfg(cfg['model'], gen)
    disc = SMPLDiscriminator(hidden=cfg['model'].get('disc_hidden', 1024),
                             generator=gen)
    dcfg = cfg['data']
    tr = dcfg['train']
    image_size = tuple(dcfg.get('image_size', (224, 224)))
    parts = [MeshDataset(c['ann_file'], c.get('img_prefix', ''),
                         image_size=image_size) for c in tr['configs']]
    mix = MeshMixDataset(parts, partition=tr.get(
        'partition', [1.0 / len(parts)] * len(parts)))
    loader = MeshAdvLoader(mix, MoshDataset(tr['adv_ann_file']),
                           batch_size=dcfg.get('batch_size', 64),
                           image_size=image_size, seed=seed)
    pair = MeshPair(mesh, disc)
    resume_loop_weights(cfg, work_dir, pair, resume)
    mesh.to(dev)
    disc.to(dev)
    ocfg = cfg.get('optimizer', {})
    lr, disc_lr = ocfg.get('base_lr', 2.5e-4), ocfg.get('disc_lr', 1e-4)
    gen_opt, gen_sched = adam(mesh.parameters(), lr, lambda c: lr)
    disc_opt, disc_sched = adam(disc.parameters(), disc_lr,
                                lambda c: disc_lr)
    metrics = {}
    n_steps = 0
    best = None
    for epoch in range(ocfg.get('total_epochs', 100)):
        loader.set_epoch(epoch)
        for batch in loader:
            metrics = adversarial_step(
                mesh, disc, gen_opt, disc_opt,
                mesh_batch_to_device(batch, dev), gen_sched=gen_sched,
                disc_sched=disc_sched)
            n_steps += 1
            if max_steps is not None and n_steps >= max_steps:
                break
        else:
            if should_eval(cfg, epoch):
                from ..eval.families import evaluate_mesh
                stats = evaluate_mesh(cfg, mesh)
                log_val_stats(cfg, work_dir, stats, epoch + 1)
                best = save_best_ckpt(cfg, work_dir, stats, pair, best)
            continue
        break
    metrics = {k: float(v) for k, v in metrics.items()}
    save_loop_outputs(cfg, work_dir, pair, metrics, n_steps)
    return pair, metrics

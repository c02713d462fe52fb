"""Validation loop: batches of canvases -> decoded keypoints -> the results
list that `TopDownDataset.evaluate` scores.

Counterpart of vitpose_tpu/eval/loop.py:21-172 (`make_val_step`,
`run_validation`). The val step runs on the model's device: the uint8
canvases are warped there in canvas coordinates (`center`/`scale`), the
model runs with the flip test (K1 attention on CUDA), and the heatmaps (or
DeepPose's coordinates) are decoded in original-image coordinates
(`center_orig`/`scale_orig`); the two frames differ where the loader shrank
a large source image onto the canvas.

JAX stacks `group_size` batches into one `lax.scan` to amortise its dispatch
latency. PyTorch launches asynchronously already, so the port runs one batch
at a time: batch b's canvases go to the card from pinned memory, and its
keypoints are read back only after batch b+1 is launched, so the host's
decode of b+1 overlaps the card's work on b. `group_size` is accepted and
has no effect.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..models.topdown import TopDownModel, infer
from ..ops.decode import keypoints_from_heatmaps, keypoints_from_regression
from ..ops.geometry import affine_matrix, udp_warp_matrix
from ..ops.warp import warp_affine_batch


def make_val_step(model: TopDownModel, image_size, use_udp=True,
                  post_process='default', modulate_kernel=11,
                  flip_index=None, target_type='GaussianHeatmap',
                  head_idx=None, expert_idx=None):
    """The val step: (imgs [N,S,S,3] uint8, center, scale, center_orig,
    scale_orig [N,2] f32), all on the model's device -> (preds [N,K,2],
    maxvals [N,K,1]) there. `center`/`scale` drive the crop warp (canvas
    coords), `center_orig`/`scale_orig` the decode (original-image
    coords). A ViTPose+ model runs expert `expert_idx` and head `head_idx`
    (0 or None: the main head). target_type 'Regression' decodes DeepPose's
    coordinates (maxvals of ones)."""
    iw, ih = image_size
    dev = next(model.parameters()).device
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    flip = (None if flip_index is None
            else torch.as_tensor(np.asarray(flip_index), device=dev))

    @torch.inference_mode()
    def val_step(imgs, center, scale, center_orig, scale_orig):
        x = imgs.float() / 255.0
        rot = torch.zeros(center.shape[0], device=center.device)
        if use_udp:
            mat = udp_warp_matrix(rot, center, scale, (iw, ih))
        else:
            mat = affine_matrix(center, scale, rot, (iw, ih))
        crops = warp_affine_batch(x, mat, (iw, ih))
        crops = (crops - mean) / std
        hm = infer(model, crops, flip_index=flip, expert_idx=expert_idx,
                   head_idx=head_idx)
        if target_type.lower() == 'regression':
            return keypoints_from_regression(hm, center_orig, scale_orig,
                                             (iw, ih), use_udp=use_udp)
        return keypoints_from_heatmaps(
            hm, center_orig, scale_orig, post_process=post_process,
            kernel=modulate_kernel, use_udp=use_udp, target_type=target_type)

    return val_step


def _results_of(batch, preds, maxvals):
    """One results entry of a batch, its padding rows dropped (the JAX
    package's `decode_group`)."""
    valid = batch['valid']
    kp = np.concatenate([preds, maxvals], axis=-1)[valid]
    c = batch['center_orig'][valid]
    s = batch['scale_orig'][valid]
    area = np.prod(s * 200.0, axis=1, keepdims=True)
    boxes = np.concatenate(
        [c, s, area, batch['bbox_score'][valid][:, None]], axis=1)
    return dict(
        preds=kp, boxes=boxes,
        image_paths=[p for p, v in zip(batch['image_paths'], valid) if v],
        bbox_ids=[int(b) for b, v in zip(batch['bbox_id'], valid) if v])


class PinnedStaging:
    """Pinned host buffers for batches of canvases, used in turn. A
    buffer is written again only after the card has finished the copy out
    of it (an event recorded behind each copy), so the host may run ahead of
    the card: the val loop by one batch, the training loop by as many
    steps as the card queues."""

    def __init__(self):
        self._bufs = [None, None]
        self._copied = [None, None]
        self._turn = 0

    def to_device(self, imgs: np.ndarray, dev):
        i, self._turn = self._turn, 1 - self._turn
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        buf = self._bufs[i]
        if buf is None or buf.shape != imgs.shape:
            buf = self._bufs[i] = torch.empty(imgs.shape, dtype=torch.uint8,
                                              pin_memory=True)
        buf.numpy()[...] = imgs
        out = buf.to(dev, non_blocking=True)
        self._copied[i] = torch.cuda.Event()
        self._copied[i].record(torch.cuda.current_stream(dev))
        return out


def run_validation(model: TopDownModel, loader, use_udp=True,
                   post_process='default', modulate_kernel=11,
                   expert_idx: Optional[int] = None, progress=False,
                   target_type='GaussianHeatmap', head_idx=None,
                   group_size: int = 4):
    """Run the val loop on the model's device and return the results list
    consumed by TopDownDataset.evaluate: one dict per batch with preds
    [n, K, 3], boxes [n, 6] (center, scale, area, score; original-image
    coords), image_paths and bbox_ids, padding rows dropped. A ViTPose+
    model runs every box through expert `expert_idx` and head `head_idx`.
    `group_size` is accepted for the JAX signature and has no effect."""
    dev = next(model.parameters()).device
    val_step = make_val_step(
        model, loader.image_size, use_udp=use_udp, post_process=post_process,
        modulate_kernel=modulate_kernel, flip_index=loader.ds.info.flip_index,
        target_type=target_type, head_idx=head_idx, expert_idx=expert_idx)
    staging = PinnedStaging() if dev.type == 'cuda' else None

    def launch(batch):
        if staging is not None:
            imgs = staging.to_device(batch['imgs'], dev)
        else:
            imgs = torch.from_numpy(np.ascontiguousarray(batch['imgs']))
        geo = [torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
               .to(dev, non_blocking=True)
               for k in ('center', 'scale', 'center_orig', 'scale_orig')]
        return val_step(imgs, *geo)

    results = []
    in_flight = None
    for bi, batch in enumerate(loader):
        out = launch(batch)
        if in_flight is not None:
            results.append(_results_of(in_flight[0], *(
                t.cpu().numpy() for t in in_flight[1])))
        in_flight = (batch, out)
        if progress and bi % 50 == 0:
            print(f'  val batch {bi}/{len(loader)}', flush=True)
    if in_flight is not None:
        results.append(_results_of(in_flight[0], *(
            t.cpu().numpy() for t in in_flight[1])))
    return results


def collect_results(results, tmpdir):
    """Gather every process's result list onto rank 0 (JAX eval/loop.py:191
    `collect_results`; the reference's `collect_results_cpu`,
    mmpose/apis/test.py:119): each rank pickles its part into `tmpdir`
    (on a filesystem every process sees), a barrier, rank 0 merges the
    parts in rank order and removes the folder, a second barrier so that no
    writer exits before rank 0 has read its part. Returns the merged list
    on rank 0 and None elsewhere; in one process, `results` unchanged."""
    import os
    import pickle
    import shutil

    from ..parallel.distributed import barrier, rank_and_world
    rank, world = rank_and_world()
    if world == 1:
        return results
    os.makedirs(tmpdir, exist_ok=True)
    with open(os.path.join(tmpdir, f'part_{rank}.pkl'), 'wb') as f:
        pickle.dump(results, f)
    barrier()
    merged = None
    if rank == 0:
        merged = []
        for r in range(world):
            with open(os.path.join(tmpdir, f'part_{r}.pkl'), 'rb') as f:
                merged.extend(pickle.load(f))
        shutil.rmtree(tmpdir, ignore_errors=True)
    barrier()
    return merged

"""Batched top-down data loading on the host.

Counterpart of vitpose_tpu/data/loader.py (`_load_canvas`, `TopDownLoader`,
and for ViTPose+ `MultiDatasetLoader`, `RepeatDataset`, `ConcatPoseDataset`),
with the same batches for the same datasets, seeds and epoch:

  * worker threads (or the native C++ pool, `data.native`) decode JPEGs and
    paste them onto ONE static uint8 canvas [S, S, 3]; a larger source image
    is scaled down to fit, and its records' center/scale are scaled with it,
  * numpy batch assembly with deterministic epoch+seed shuffling and
    per-process sharding (each process takes
    records[process_index::process_count], every shard padded to the same
    size),
  * in training, the configured image-level augmentations change each
    record's canvas in place, from the record's own RandomState,
  * the crop, normalisation and targets happen later, on the device.

The last batch of an epoch keeps the full batch size, padded with copies of
its last record, and carries a `valid` mask; `center_orig`/`scale_orig` are
the decode's original-image center/scale, `center`/`scale` the warp's canvas
ones.
"""
from __future__ import annotations

import concurrent.futures as futures
from typing import Iterator, Optional

import numpy as np

from .native import decode_batch_native, native_available
from .pipeline import (AugmentConfig, apply_image_augmentations,
                       sample_augmentations)


def _bbox_xywh2cs(bbox, aspect_ratio, padding=1.25, pixel_std=200.0):
    """`ops.geometry.bbox_xywh2cs` for one record, in numpy, as the JAX
    package's loader computes it: the aspect ratio comes from the dataset's
    int64 `image_size` as a float64 scalar, so numpy fits the box in float64
    before the caller rounds to float32, where a tensor call stays in
    float32 and differs in the last bit for some boxes."""
    bbox = np.asarray(bbox, np.float32)
    x, y, w, h = bbox[..., 0], bbox[..., 1], bbox[..., 2], bbox[..., 3]
    center = np.stack([x + w * 0.5, y + h * 0.5], axis=-1)
    h_fit = np.where(w > aspect_ratio * h, w / aspect_ratio, h)
    w_fit = np.where(w < aspect_ratio * h, h * aspect_ratio, w)
    scale = np.stack([w_fit, h_fit], axis=-1) / pixel_std * padding
    return center, scale


def _load_canvas(path, canvas_size):
    """Decode an image onto a static canvas with cv2; returns (canvas,
    scale_factor). Images larger than the canvas are uniformly
    downscaled."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f'no JPEG decoder for {path}: the loader needs cv2 where the '
            'native loader (a C++ compiler and jpeglib.h) is missing') from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    h, w = img.shape[:2]
    s = min(1.0, canvas_size / max(h, w))
    if s < 1.0:
        img = cv2.resize(img, (int(round(w * s)), int(round(h * s))),
                         interpolation=cv2.INTER_LINEAR)
        h, w = img.shape[:2]
    canvas = np.zeros((canvas_size, canvas_size, 3), np.uint8)
    canvas[:h, :w] = img
    return canvas, np.float32(s)


class TopDownLoader:
    """Iterate host batch dicts over a TopDownDataset.

    Batch keys: imgs [N,S,S,3] uint8, center, scale, center_orig,
    scale_orig, rot, flip, joints, vis, bbox_score, bbox_id, dataset_idx
    [N] int32, scale_factor, valid [N] bool, image_paths (list).
    """

    def __init__(self, dataset, batch_size, is_train=True, canvas_size=None,
                 padding=1.25, aug: Optional[AugmentConfig] = None,
                 seed=0, num_workers=8, process_index=0, process_count=1,
                 drop_last=None):
        self.ds = dataset
        self.batch_size = batch_size
        self.is_train = is_train
        # dataset-driven by default: COCO sources are <= 640 px
        self.canvas_size = (canvas_size if canvas_size is not None
                            else getattr(dataset, 'canvas_size', 640))
        self.padding = padding
        self.aug = aug or AugmentConfig()
        self.seed = seed
        # JPEG decode releases the GIL (libjpeg, cv2), so threads overlap
        self.num_workers = max(1, min(num_workers, 16))
        self.use_native = native_available()
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = is_train if drop_last is None else drop_last
        self.epoch = 0
        self.image_size = tuple(dataset.image_size)
        self._pool = None

    def _shard_len(self):
        # every shard padded to the same (ceil) size, like the reference
        # DistributedSampler: a floor would drop the larger shards' tails
        return -(-len(self.ds.db) // self.process_count)

    def __len__(self):
        per = self._shard_len()
        if self.drop_last:
            return per // self.batch_size
        return (per + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.ds.db)
        idx = np.arange(n)
        if self.is_train:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.process_count > 1:
            total = self._shard_len() * self.process_count
            if total > n:
                # wrap-around padding to divisibility; np.resize tiles, so
                # even more processes than records leave no shard empty
                idx = np.resize(idx, total)
            idx = idx[self.process_index::self.process_count]
        return idx

    def _decode_chunk(self, recs):
        """Decode a chunk of records' images -> (canvases, scale_factors),
        with the native C++ pool where it is built, else threaded cv2."""
        paths = [r['image_file'] for r in recs]
        if self.use_native and all(p.lower().endswith(('.jpg', '.jpeg'))
                                   for p in paths):
            return decode_batch_native(paths, self.canvas_size,
                                       self.num_workers)
        canvases = np.empty((len(paths), self.canvas_size,
                             self.canvas_size, 3), np.uint8)
        sfacs = np.empty(len(paths), np.float32)
        if self.num_workers > 1:
            if self._pool is None:      # one pool for the loader's lifetime
                self._pool = futures.ThreadPoolExecutor(self.num_workers)
            outs = list(self._pool.map(
                lambda p: _load_canvas(p, self.canvas_size), paths))
        else:
            outs = [_load_canvas(p, self.canvas_size) for p in paths]
        for j, (c, s) in enumerate(outs):
            canvases[j] = c
            sfacs[j] = s
        return canvases, sfacs

    def _prepare_record(self, i, rec_rng, canvas, sfac):
        rec = self.ds.db[i]
        if 'center' in rec and 'scale' in rec:
            # records that carry center/scale directly (e.g. MPII)
            center = np.asarray(rec['center'], np.float32) * sfac
            scale = np.asarray(rec['scale'], np.float32) * sfac
        else:
            bbox = rec['bbox'] * sfac
            aspect = self.image_size[0] / self.image_size[1]
            center, scale = _bbox_xywh2cs(bbox, aspect, padding=self.padding)
            center = np.asarray(center, np.float32)
            scale = np.asarray(scale, np.float32)
            if self.is_train and rec_rng.rand() < 0.3:
                # reference _xywh2cs train-time center jitter
                # (kpt_2d_sview_rgb_img_top_down_dataset.py:147-148)
                center = center + (0.4 * (rec_rng.rand(2) - 0.5)
                                   * bbox[2:4]).astype(np.float32)
        joints = rec['joints_3d'][:, :2] * sfac
        vis = rec['joints_3d_visible'][:, 0]

        flipped = False
        if self.is_train and self.aug.has_image_augs():
            # the image-level augmentations change this record's canvas in
            # place, from its own RandomState, before its geometry is drawn
            # (JAX's loader, vitpose_tpu/data/loader.py:168-176); the crop
            # then samples the changed pixels
            canvas[...] = apply_image_augmentations(rec_rng, canvas,
                                                    self.aug)
        if self.is_train:
            r = dict(rec, center=center, scale=scale,
                     joints_3d=np.concatenate(
                         [joints, rec['joints_3d'][:, 2:]], axis=1),
                     joints_3d_visible=rec['joints_3d_visible'])
            center, scale, rot, joints, vis, flipped = sample_augmentations(
                rec_rng, r, self.ds.info, self.canvas_size, self.aug,
                self.image_size)
        else:
            rot = np.float32(0.0)

        return dict(center=center, scale=scale, rot=rot,
                    flip=bool(flipped),
                    joints=joints.astype(np.float32),
                    vis=vis.astype(np.float32),
                    bbox_score=np.float32(rec['bbox_score']),
                    bbox_id=rec['bbox_id'],
                    dataset_idx=np.int32(rec.get('dataset_idx', 0)),
                    scale_factor=sfac,
                    image_path=rec['image_file'])

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        bs = self.batch_size
        rng = np.random.RandomState(self.seed * 1000 + self.epoch)
        for b in range(len(self)):
            chunk = idx[b * bs:(b + 1) * bs]
            valid = np.zeros(bs, bool)
            valid[:len(chunk)] = True
            # deterministic per-record rngs
            seeds = rng.randint(0, 2 ** 31, size=len(chunk))
            canvases, sfacs = self._decode_chunk(
                [self.ds.db[i] for i in chunk])
            recs = [self._prepare_record(i, np.random.RandomState(s),
                                         canvases[j], sfacs[j])
                    for j, (i, s) in enumerate(zip(chunk, seeds))]
            while len(recs) < bs:          # pad the final batch
                recs.append(recs[-1])
            # the flip and the warp happen on the device, so the decode
            # buffer (changed in place by any image-level augmentation) is
            # the batch
            if len(chunk) == bs:
                imgs = canvases
            else:
                pad = np.broadcast_to(canvases[-1:],
                                      (bs - len(chunk),) + canvases.shape[1:])
                imgs = np.concatenate([canvases, pad])
            batch = dict(
                imgs=imgs,
                center=np.stack([r['center'] for r in recs]),
                scale=np.stack([r['scale'] for r in recs]),
                rot=np.stack([r['rot'] for r in recs]),
                flip=np.array([r['flip'] for r in recs], bool),
                joints=np.stack([r['joints'] for r in recs]),
                vis=np.stack([r['vis'] for r in recs]),
                bbox_score=np.stack([r['bbox_score'] for r in recs]),
                bbox_id=np.array([r['bbox_id'] for r in recs]),
                dataset_idx=np.array([r['dataset_idx'] for r in recs],
                                     np.int32),
                scale_factor=np.stack([r['scale_factor'] for r in recs]),
                valid=valid,
                image_paths=[r['image_path'] for r in recs],
            )
            # the decode's center/scale are in ORIGINAL image coords
            batch['center_orig'] = (batch['center']
                                    / batch['scale_factor'][:, None])
            batch['scale_orig'] = (batch['scale']
                                   / batch['scale_factor'][:, None])
            yield batch


class MultiDatasetLoader:
    """ViTPose+ multi-dataset mixture: the child loaders' whole batches
    interleaved in a seeded order that changes every epoch, each batch of
    one dataset (reference ConcatDataset training, datasets/builder.py:
    75-79). A child that runs out early is skipped; `len` is the sum of
    the child lengths."""

    def __init__(self, loaders, seed=0):
        self.loaders = loaders
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        """Set every child's epoch and re-seed the interleave order (JAX's
        runner sets the children's itself); a fixed order would bias the
        tail of every epoch toward one dataset."""
        self.epoch = int(epoch)
        for loader in self.loaders:
            loader.set_epoch(epoch)

    def __len__(self):
        return sum(len(l) for l in self.loaders)

    def __iter__(self):
        iters = [iter(l) for l in self.loaders]
        counts = [len(l) for l in self.loaders]
        order = np.concatenate([np.full(c, i) for i, c in enumerate(counts)])
        np.random.RandomState(self.seed * 9973 + self.epoch).shuffle(order)
        for i in order:
            try:
                yield next(iters[i])
            except StopIteration:
                continue


class RepeatDataset:
    """A dataset repeated `times` times per epoch (reference
    dataset_wrappers.py:6 RepeatDataset): the record db is tiled, so the
    loader's shuffle sees `times` copies."""

    def __init__(self, dataset, times):
        self._ds = dataset
        self.times = times
        self.db = list(dataset.db) * times

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def __len__(self):
        return len(self.db)


class ConcatPoseDataset:
    """Same-format datasets as one (reference builder.py:29
    `_concat_dataset` for ann_file lists): the records are merged, the
    metadata is the first dataset's."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError('ConcatPoseDataset needs at least one dataset')
        self._ds = datasets[0]
        self.datasets = list(datasets)
        self.db = [r for d in datasets for r in d.db]

    def __getattr__(self, name):
        return getattr(self._ds, name)

    def __len__(self):
        return len(self.db)

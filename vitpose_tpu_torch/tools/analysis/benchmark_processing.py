"""Throughput of the training input pipeline: the host loader and the
preprocess on the card, timed apart.

    python -m vitpose_tpu_torch.tools.analysis.benchmark_processing
        --ann ANN.json --prefix IMG_DIR/ [--batch 16] [--iters 20]
        [--num-workers 4] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/benchmark_processing.py
(reference tools/analysis/benchmark_processing.py, which times mmpose's cv2
transforms):

  * the host loader: `TopDownLoader` over the COCO-format set in training
    mode (JPEG decode, canvas placement, the augmentation draws), `--iters`
    epochs, by the host clock;
  * the preprocess: up to 16 of those batches copied to the card and
    through `make_preprocess_fn` (batched warp, normalisation, UDP
    targets), between CUDA events on the card (the host clock on the CPU).

Both rates are printed beside the card's name and power limit. JAX's
default fixture path is the reference checkout's, which this repository
does not hold: the set is an argument here.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ...api.inference import _device
from ...data import TopDownDataset
from ...data.loader import TopDownLoader
from ...data.pipeline import make_preprocess_fn
from ._common import timed_ms, where

_KEYS = ('imgs', 'center', 'scale', 'rot', 'joints', 'vis', 'flip')


def main(argv=None):
    """Print and return {'host_img_s', 'device_img_s', ...}."""
    ap = argparse.ArgumentParser(description='input pipeline throughput '
                                 '(PyTorch port)')
    ap.add_argument('--ann', required=True)
    ap.add_argument('--prefix', required=True)
    ap.add_argument('--batch', type=int, default=16)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--num-workers', type=int, default=4)
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)

    ds = TopDownDataset(args.ann, args.prefix, dataset_info='coco')
    loader = TopDownLoader(ds, args.batch, is_train=True,
                           num_workers=args.num_workers, seed=0)
    pre = make_preprocess_fn(image_size=(192, 256), heatmap_size=(48, 64),
                             use_udp=True, sigma=2.0)
    sample = []                  # a bounded sample for the device pass
    n_img = 0
    t0 = time.perf_counter()
    for it in range(args.iters):
        loader.set_epoch(it)
        for batch in loader:
            if len(sample) < 16:
                sample.append(batch)
            n_img += len(batch['imgs'])
    host_s = time.perf_counter() - t0
    if not sample:
        raise ValueError(f'{args.ann}: no training batch of {args.batch}')
    host_img_s = n_img / host_s
    print(f'host loader: {host_img_s:.1f} imgs/s ({args.num_workers} '
          'workers: JPEG decode, canvas, augmentation draws; host clock, '
          f'the host of the run {where(dev)})')

    def device_pass(batch):
        args_ = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
                 for k in _KEYS]
        pre(*args_)

    device_pass(sample[0])
    ms = timed_ms(device_pass, sample, len(sample), dev)
    device_img_s = sum(len(b['imgs']) for b in sample) / sum(ms) * 1e3
    print(f'preprocess (copy to the device, warp, normalise, UDP targets): '
          f'{device_img_s:.1f} imgs/s {where(dev)}')
    return {'host_img_s': host_img_s, 'device_img_s': device_img_s,
            'host_images': n_img, 'device_batches': len(sample)}


if __name__ == '__main__':
    main()

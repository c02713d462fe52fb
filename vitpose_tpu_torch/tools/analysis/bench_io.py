"""Input-pipeline throughput: JPEG decode and canvas assembly on the host.

    python -m vitpose_tpu_torch.tools.analysis.bench_io [--n 256]
        [--batch 64] [--canvas 640] [--iters 3] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/bench_io.py: whether the
host keeps the card fed. On `--n` synthetic 640x480 JPEGs (`make_jpegs`:
smooth seeded random fields, quality 90):

  1. the port's native decoder (csrc/loader.cpp through data/native.py)
     onto fixed canvases at 1, 4, 8 and 16 threads; where it is not built
     (no C++ compiler or no jpeglib.h) the reason is printed instead, as JAX
     prints "not built": the loader then decodes with cv2;
  2. cv2.imread on one thread;
  3. the port's TopDownLoader (decode, record preparation, collation) over
     synthetic COCO records of those files (JAX's, but for the joints:
     `synthetic_records`), in training and evaluation mode.

Every rate is on the host (the best of `--iters` passes by the host clock)
and is printed beside the name and power limit of the card this host
serves; nothing runs on the card (`--device cpu` names the CPU instead).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from ...api.inference import _device
from ...data.dataset_info import DatasetInfo
from ...data.loader import TopDownLoader
from ...data.native import decode_batch_native, native_available
from ...kernels import _build
from ._common import where


def make_jpegs(tmpdir, n, w=640, h=480, quality=90):
    """`n` JPEGs of smooth random fields (cubic upsampling of seeded noise,
    a realistic JPEG entropy) in `tmpdir`; returns their paths. The same
    files as the JAX package's make_jpegs."""
    import cv2
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        small = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
        img = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
        p = os.path.join(tmpdir, f'{i:05d}.jpg')
        cv2.imwrite(p, img, [cv2.IMWRITE_JPEG_QUALITY, quality])
        paths.append(p)
    return paths


# a standing COCO person's 17 joints as fractions (x, y) of its box
PERSON = np.array([
    [.50, .08], [.55, .06], [.45, .06], [.60, .08], [.40, .08],
    [.70, .22], [.30, .22], [.78, .38], [.22, .38], [.80, .52], [.20, .52],
    [.62, .55], [.38, .55], [.63, .75], [.37, .75], [.64, .95], [.36, .95]],
    np.float32)
BOX = np.asarray([200.0, 120.0, 240.0, 320.0], np.float32)


def synthetic_records(paths):
    """One COCO-style person record per image, JAX's bench record but for
    its joints: JAX stacks all 17 on one point (300, 200), so that in
    training mode a half-body draw makes a box of zero size and its crop
    NaN (JAX's preprocess as this one), and every later step trains on NaN
    weights; here they are spread over the box as a person's are."""
    joints = np.concatenate([PERSON * BOX[2:] + BOX[:2],
                             np.zeros((17, 1), np.float32)], 1)
    return [dict(
        image_file=p, bbox=BOX.copy(), rotation=0, joints_3d=joints.copy(),
        joints_3d_visible=np.tile(np.asarray([[1.0, 1.0, 0.0]], np.float32),
                                  (17, 1)),
        bbox_score=1.0, bbox_id=i, image_id=i, dataset_idx=0)
        for i, p in enumerate(paths)]


class SyntheticSet:
    """The dataset a TopDownLoader reads: the records and COCO's
    metadata. `image_size` is (w, h)."""
    num_joints = 17
    dataset_idx = 0
    name = 'synthetic'

    def __init__(self, paths, image_size, heatmap_size):
        self.db = synthetic_records(paths)
        self.image_size = image_size
        self.heatmap_size = heatmap_size
        self.info = DatasetInfo.load('coco')


def native_missing():
    """Why the native decoder is not built here, or None where it is."""
    if native_available():
        return None
    if _build.cxx() is None:
        return 'no C++ compiler (set CXX)'
    return 'the C++ compiler finds no jpeglib.h'


def main(argv=None):
    """Print the rates; returns {'native': {threads: img/s} or the reason,
    'cv2_img_s', 'loader_img_s': {'train', 'eval'}, 'kib_per_image'}."""
    ap = argparse.ArgumentParser(description='input pipeline throughput '
                                 '(PyTorch port)')
    ap.add_argument('--n', type=int, default=256)
    ap.add_argument('--batch', type=int, default=64)
    ap.add_argument('--canvas', type=int, default=640)
    ap.add_argument('--iters', type=int, default=3)
    ap.add_argument('--device', default='cuda',
                    help="the card whose host is measured: 'cuda' "
                         "(default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    out = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        paths = make_jpegs(tmpdir, args.n)
        kib = sum(os.path.getsize(p) for p in paths) / len(paths) / 1024
        out['kib_per_image'] = kib
        print(f'{args.n} JPEGs, 640x480, avg {kib:.0f} KiB')

        reason = native_missing()
        if reason is None:
            out['native'] = {}
            for threads in (1, 4, 8, 16):
                ts = []
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    decode_batch_native(paths, args.canvas,
                                        n_threads=threads)
                    ts.append(time.perf_counter() - t0)
                rate = args.n / min(ts)
                out['native'][threads] = rate
                print(f'native decode, {threads:2d} threads: {rate:8.1f} '
                      f'imgs/s (host of the run {where(dev)})')
        else:
            out['native'] = reason
            print(f'native loader not built ({reason}); the loader decodes '
                  'with cv2')

        import cv2
        cv2.setNumThreads(0)
        ts = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            for p in paths:
                cv2.imread(p)
            ts.append(time.perf_counter() - t0)
        out['cv2_img_s'] = args.n / min(ts)
        print(f'cv2.imread single-thread : {out["cv2_img_s"]:8.1f} imgs/s '
              f'(host of the run {where(dev)})')

        out['loader_img_s'] = {}
        for train in (True, False):
            loader = TopDownLoader(SyntheticSet(paths, (256, 192), (64, 48)),
                                   args.batch, is_train=train,
                                   canvas_size=args.canvas, seed=0)
            n_img = 0
            t0 = time.perf_counter()
            for b in loader:
                n_img += int(b['imgs'].shape[0])
            rate = n_img / (time.perf_counter() - t0)
            mode = 'train' if train else 'eval '
            out['loader_img_s'][mode.strip()] = rate
            print(f'TopDownLoader {mode} batches : {rate:8.1f} imgs/s '
                  f'(decode+prep+collate, single process; host of the run '
                  f'{where(dev)})', flush=True)
    return out


if __name__ == '__main__':
    main()

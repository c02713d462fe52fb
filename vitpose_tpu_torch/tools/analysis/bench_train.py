"""Training throughput: the ViTPose-{BENCH_VARIANT} 256x192 train step (bf16,
K1 + K2, remat, the COCO layer-decay AdamW).

    python -m vitpose_tpu_torch.tools.analysis.bench_train [--device cuda|cpu]
    BENCH_E2E=1 python -m vitpose_tpu_torch.tools.analysis.bench_train

Counterpart of the JAX package's tools/analysis/bench_train.py, with its
environment knobs, read when `main` runs: BENCH_VARIANT (b), BENCH_BATCH
(64), BENCH_TRAIN_GROUP (4), BENCH_TRAIN_ITERS (3), BENCH_REMAT (1),
BENCH_REMAT_POLICY (full), BENCH_E2E (0), BENCH_E2E_IMGS (768),
BENCH_E2E_STEPS (40), BENCH_E2E_MODE (canvas), BENCH_E2E_CACHE (0).

`main`: GROUP steps back to back per timed call on synthetic batches drawn
on the card before timing (JAX scans them in one dispatch and draws them
inside it), one warm-up call (the kernel builds), then ITERS calls, each
between CUDA events (the host clock on the CPU); prints {metric,
imgs_per_sec, ms_per_step} and the card, and logs the peak memory (f32
weights, gradients and both AdamW moments are 16 bytes a parameter:
about 5 GB at ViT-L, 10 GB at ViT-H).

`main_e2e` (BENCH_E2E=1): the fed loop. Synthetic JPEGs (bench_io's
make_jpegs) through the port's TopDownLoader in training mode in a
prefetch thread (a queue of 4), then on the card the preprocess and the
step. BENCH_E2E_MODE 'canvas' ships the uint8 canvases and warps on the
card (`make_preprocess_fn`); 'crop' warps on the host and ships uint8
crops (`make_host_crop_fn` there, `make_device_finish_fn` on the card).
BENCH_E2E_CACHE=1 decodes once and replays the wire batches. It prints the
sustained end-to-end rate (host clock, from the first step's end to the
last step's), the loader's own rate (its second pass) and the step's own
(20 steps on one wire batch, between CUDA events), whether one host
process keeps the card fed and how many it would take. The uint8 batches
go to the card through pinned staging (eval/loop.py `PinnedStaging`).

JAX's `_setup_cache` (its persistent compile cache) has no counterpart:
nothing is compiled but the two kernels, built once at first use into
kernels/build/. JAX syncs on host readbacks of the loss; this waits for
the card instead. `--backbone KEY=VALUE ...` (ViTConfig fields) shrinks the
model for a run on the CPU.
"""
from __future__ import annotations

import argparse
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ...api.inference import _device
from ...data.loader import TopDownLoader
from ...data.pipeline import (make_device_finish_fn, make_host_crop_fn,
                              make_preprocess_fn)
from ...eval.loop import PinnedStaging
from ...train import (OptimConfig, create_train_state, layer_decay_adamw,
                      make_train_step)
from ._common import (Launches, backbone_options, json_line, sync, timed_ms,
                      vit_model)
from .bench_io import SyntheticSet, make_jpegs

WARMUP = 1
CROP = (192, 256)                 # (w, h)
HEATMAP = (48, 64)
STEP_ONLY_STEPS = 20

_T0 = time.perf_counter()


def log(msg):
    """Progress to stderr, as JAX's tool logs every long phase."""
    print(f'[bench_train +{time.perf_counter() - _T0:6.1f}s] {msg}',
          file=sys.stderr, flush=True)


def settings(env=None):
    """The BENCH_* knobs, with JAX's names and defaults."""
    env = os.environ if env is None else env
    return {'variant': env.get('BENCH_VARIANT', 'b'),
            'batch': int(env.get('BENCH_BATCH', '64')),
            'group': int(env.get('BENCH_TRAIN_GROUP', '4')),
            'iters': int(env.get('BENCH_TRAIN_ITERS', '3')),
            'remat': env.get('BENCH_REMAT', '1') == '1',
            'policy': env.get('BENCH_REMAT_POLICY', 'full'),
            'e2e': env.get('BENCH_E2E', '0') == '1',
            'e2e_imgs': int(env.get('BENCH_E2E_IMGS', '768')),
            'e2e_steps': int(env.get('BENCH_E2E_STEPS', '40')),
            'e2e_mode': env.get('BENCH_E2E_MODE', 'canvas'),
            'e2e_cache': env.get('BENCH_E2E_CACHE', '0') == '1'}


def train_setup(s, device, backbone=None, dtype='bfloat16',
                img_size=(CROP[1], CROP[0]), **make_kw):
    """(train state, step) of ViTPose-{variant} in `dtype` with K1 + K2 and
    the knobs' remat, under the COCO layer-decay AdamW (lr 5e-4); `make_kw`
    (make_config's TopDownConfig fields) and `img_size` for small runs."""
    model = vit_model(s['variant'], device, img_size, dtype, True, backbone,
                      remat=s['remat'], remat_policy=s['policy'], **make_kw)
    ocfg = OptimConfig(base_lr=5e-4, num_layers=model.cfg.backbone.depth)
    state = create_train_state(
        model, layer_decay_adamw(model, ocfg, steps_per_epoch=1000),
        ocfg.grad_clip_norm)
    return state, make_train_step(model)


def run_group(state, step, group, gen):
    """The steps of one timed call: one step per batch of `group` ({imgs
    [G, N, ...], target, target_weight}); returns the G losses."""
    return torch.stack([
        step(state, {k: v[j] for k, v in group.items()}, gen)['heatmap_loss']
        for j in range(group['imgs'].shape[0])])


def synthetic_group(seed, s, device):
    """GROUP batches of random crops and targets, drawn on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    g, n = s['group'], s['batch']
    return {'imgs': torch.randn((g, n, CROP[1], CROP[0], 3), generator=gen,
                                device=device),
            'target': torch.rand((g, n, 17, HEATMAP[1], HEATMAP[0]),
                                 generator=gen, device=device),
            'target_weight': torch.ones((g, n, 17), device=device)}


def peak_gib(device):
    if device.type != 'cuda':
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def bench_steps(s, device, backbone=None):
    """The synthetic-batch measurement; returns the JSON record with
    'peak_gib' and 'launches'."""
    log(f"variant={s['variant']} batch={s['batch']} remat={s['remat']} "
        f"policy={s['policy']}")
    if device.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
    state, step = train_setup(s, device, backbone)
    gen = torch.Generator(device=device).manual_seed(0)
    log('state ready')
    with Launches() as counted:
        for i in range(WARMUP):
            log(f'warmup {i} (builds the kernels on first use)')
            run_group(state, step, synthetic_group(i, s, device), gen)
            sync(device)
        groups = [synthetic_group(i, s, device)
                  for i in range(WARMUP, WARMUP + s['iters'])]
        log('measuring')
        ms = sum(timed_ms(lambda g: run_group(state, step, g, gen), groups,
                          s['iters'], device))
    steps = s['group'] * s['iters']
    rec = json_line({'metric': f"vitpose_{s['variant']}_256x192_train",
                     'imgs_per_sec': round(s['batch'] * steps / ms * 1e3, 1),
                     'ms_per_step': round(ms / steps, 1)}, device)
    peak = peak_gib(device)
    if peak is not None:
        log(f'peak memory {peak:.2f} GiB')
    return {**rec, 'peak_gib': peak, 'launches': counted.counts()}


def _wire_to_device(w, keys, staging, device):
    """The wire batch's arrays on `device`: the uint8 images or crops
    through pinned staging on the card, the rest copied."""
    out = {}
    for k in keys:
        x = w.get(k)
        if x is None:
            out[k] = None
        elif k in ('imgs', 'crops') and device.type == 'cuda':
            out[k] = staging.to_device(np.asarray(x), device)
        else:
            out[k] = torch.as_tensor(np.asarray(x)).to(device)
    return out


def main_e2e(s, device, backbone=None):
    """The fed loop; prints JAX's JSON keys and the card; returns them
    with 'first_loss' and 'launches'."""
    log(f"e2e: generating {s['e2e_imgs']} synthetic JPEGs")
    with tempfile.TemporaryDirectory() as tmpdir:
        paths = make_jpegs(tmpdir, s['e2e_imgs'])
        loader = TopDownLoader(SyntheticSet(paths, CROP, HEATMAP),
                               s['batch'], is_train=True, canvas_size=640,
                               seed=0)
        for _ in loader:                   # warm page cache
            pass
        t0 = time.perf_counter()
        n = sum(int(b['imgs'].shape[0]) for b in loader)
        loader_ips = n / (time.perf_counter() - t0)
        with Launches() as counted:
            rec = _fed_loop(s, device, backbone, loader, loader_ips)
    return {**rec, 'launches': counted.counts()}


def _fed_loop(s, device, backbone, loader, loader_ips):
    state, step = train_setup(s, device, backbone)
    gen = torch.Generator(device=device).manual_seed(0)
    staging = PinnedStaging()
    mode, use_cache = s['e2e_mode'], s['e2e_cache']
    if mode == 'crop':
        host_crop = make_host_crop_fn(image_size=CROP)
        finish = make_device_finish_fn(image_size=CROP, heatmap_size=HEATMAP)

        def to_wire(b):
            crops, joints_c = host_crop(b['imgs'], b['center'], b['scale'],
                                        b['rot'], b['joints'], b.get('flip'))
            return {'crops': crops.numpy(), 'joints_c': joints_c.numpy(),
                    'vis': b['vis']}

        def device_batch(w):
            d = _wire_to_device(w, ('crops', 'joints_c', 'vis'), staging,
                                device)
            return finish(d['crops'], d['joints_c'], d['vis'])
    elif mode == 'canvas':
        preprocess = make_preprocess_fn(image_size=CROP,
                                        heatmap_size=HEATMAP)

        def to_wire(b):
            return b

        def device_batch(w):
            d = _wire_to_device(w, ('imgs', 'center', 'scale', 'rot',
                                    'joints', 'vis', 'flip'), staging, device)
            return preprocess(d['imgs'], d['center'], d['scale'], d['rot'],
                              d['joints'], d['vis'], d['flip'])
    else:
        raise ValueError(f"BENCH_E2E_MODE {mode!r}: 'canvas' or 'crop'")

    q = queue.Queue(maxsize=4)
    stop = threading.Event()
    failed = []

    def put(w):
        while not stop.is_set():
            try:
                q.put(w, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def feed():
        try:
            if use_cache:
                cached = [to_wire(b) for b in loader]    # decode once
                while all(put(w) for w in cached):
                    pass
                return
            epoch = 0
            while not stop.is_set():
                loader.set_epoch(epoch)
                for b in loader:
                    if not put(to_wire(b)):
                        return
                epoch += 1
        except Exception as e:                 # raised again by get()
            failed.append(e)

    def get():
        while True:
            try:
                return q.get(timeout=1.0)
            except queue.Empty:
                if not th.is_alive():
                    raise RuntimeError('the loader thread ended') from (
                        failed[0] if failed else None)

    def one(w):
        pre = device_batch(w)
        return step(state, {'imgs': pre['imgs'], 'target': pre['target'],
                            'target_weight': pre['target_weight']}, gen)

    th = threading.Thread(target=feed, daemon=True)
    th.start()
    try:
        log('e2e: first step (builds the kernels on first use)')
        first_loss = float(one(get())['heatmap_loss'])
        log(f"e2e: measuring {s['e2e_steps']} steps")
        t0 = time.perf_counter()
        for _ in range(s['e2e_steps']):
            one(get())
        sync(device)
        e2e_ips = s['e2e_steps'] * s['batch'] / (time.perf_counter() - t0)
    finally:
        stop.set()
        th.join()

    # the step's own rate under the same program, one loaded batch replayed
    w0 = to_wire(next(iter(loader)))
    one(w0)
    sync(device)
    ms = timed_ms(lambda w: [one(w) for _ in range(STEP_ONLY_STEPS)], [w0],
                  1, device)[0]
    step_ips = STEP_ONLY_STEPS * s['batch'] / ms * 1e3
    rec = json_line({
        'metric': f"vitpose_{s['variant']}_256x192_train_e2e",
        'mode': mode, 'cache': use_cache,
        'e2e_imgs_per_sec': round(e2e_ips, 1),
        'loader_imgs_per_sec': round(loader_ips, 1),
        'step_imgs_per_sec': round(step_ips, 1),
        'fed': bool(loader_ips >= step_ips),
        'host_processes_needed': max(1, int(np.ceil(step_ips
                                                    / loader_ips)))}, device)
    return {**rec, 'first_loss': first_loss, 'peak_gib': peak_gib(device)}


def main(argv=None):
    """The synthetic-batch bench, or with BENCH_E2E=1 the fed loop; returns
    the printed record with 'launches' (and 'peak_gib')."""
    ap = argparse.ArgumentParser(description='training throughput (PyTorch '
                                 'port); knobs in BENCH_* variables')
    ap.add_argument('--backbone', nargs='*', default=[],
                    help='ViTConfig fields as KEY=VALUE (small CPU runs)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    s = settings()
    over = backbone_options(args.backbone)
    if s['e2e']:
        return main_e2e(s, dev, over)
    return bench_steps(s, dev, over)


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vitpose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repo root; one card, nvcc, no args

Phases, each printing its own line(s); any failure exits non-zero and prints
no result:

  env       card name and power limit (nvidia-smi), torch and CUDA versions
  build     every csrc/*.cu built by nvcc for sm_90a, one process each; one
            line per kernel with ptxas's registers, static shared memory and
            spills (any spill fails)
  kernel    K1 (attention_fwd) against its plain version on the card at the
            shapes the serving and training paths give it, the other head
            dims and both sides of the whole-pair boundary (T = 192, 193),
            in every design that takes each shape; median times of each
            design (the whole pair and the tiled one in turns: tiled, pair,
            pair, tiled), back to back and on the device alone (CUDA graph),
            of the plain version and of one PyTorch library call, and the
            card's bound for the same work
  serve     full-width ViTPose-B 256x192 (bf16, K1 attention, flip test, UDP
            decode) through init_pose_model + inference_top_down_pose_model
            on a seeded 480x640 image with 8 boxes: exactly 12 blocks x 2
            passes = 24 K1 launches, all of the whole-pair design, every
            tensor on the card, every keypoint finite and inside its padded
            box; then img/s of a 256-crop batch
  serve-ref the same weights on CUDA (K1) and on the CPU (plain attention),
            2 boxes, in f32 (TF32 off) and in bf16: f32 heatmaps and decisive
            keypoints agree; the bf16 CUDA path is as close to the f32 CPU
            answer as the bf16 CPU path is (within BF16_FACTOR)
  int8      Int8Linear (W8A8, torch._int_mm) on the card against its CPU
            path at the four ViT-B products (qkv, proj, fc1, fc2; bf16 in
            and out, one 8-box pass of rows): equal weight and activation
            codes, an exact int32 product, equal outputs; at a 256-crop
            pass's rows the times of _int_mm, the bf16 matmul it replaces,
            the quantise + dequantise passes alone and the whole layer
  serve-int8 full-width ViTPose-B 256x192 through int8_serving_config (W8A8
            MLP, qkv and proj; bf16, K1, tanh GELU as the server's --fast)
            at skip 0 and 1, scales calibrated on the scene's crops: 24 K1
            launches per 8-box call (all whole-pair) and 96 / 80 _int_mm,
            keypoints finite, inside their padded boxes and near the --fast
            bf16 path's; the 256-crop batch of int8 and of --fast bf16 timed
            in turns
  deploy    the HTTP server (vitpose_tpu_torch.tools.serve, build_server on
            port 0) on the card: the COCO-B config in its default mode,
            --fast and --int8-qkv (--calib-dir of the scene's person crops),
            and the default --variant s with --fast (K1 at head dim 32),
            each from shaped weights saved as a .pth; 1-box and 8-box
            requests answer exactly what the direct API call gives, K1 and
            _int_mm launches per request, p50/p99 latency beside the
            direct call's median
  eval      the evaluation CLI (vitpose_tpu_torch.tools.test) on the COCO-B
            config file (ViTPose-B 256x192 bf16, K1, flip test, UDP, batch
            64, canvas 640), pointed by --cfg-options at a synthetic COCO val
            set written to a temporary directory (248 JPEGs, 8 of them
            larger than the canvas; 992 detection boxes, so 16 batches with
            a ragged last one; GT joints at each box's peak plus seeded
            jitter) and at the shaped weights saved as a .pth: exactly 24 K1
            launches per batch, all whole-pair, and no K2; the ten COCO
            stats, AP in (0, 1); then the same run timed: every val-step
            tensor on the card, one finite result per box, boxes/s (decode
            included), the host's decode and batch time alone, the card's
            busy time (torch.profiler) and peak memory; after eval-ref,
            the CLI once more with --int8 --int8-skip 1 --show-dir: K1 and
            _int_mm launches, AP beside the bf16 AP, one drawing per image
  eval-ref  16 of those boxes through the same config on CUDA in f32 (TF32
            off) and bf16 and on the CPU in f32: f32 keypoints agree as
            serve-ref's do and f32 AP within EVAL_REF_AP_TOL; bf16 AP beside
            the f32 AP, within EVAL_REF_BF16_AP_TOL
  kernel-bwd K2 (attention_bwd) in the same way at the training shapes and
            the other head dims and lengths (the library call is SDPA's
            backward, timed as fwd+bwd minus fwd); then one K3 check:
            gradients through `attention` on CUDA equal the plain backward
  train     full-width ViTPose-B 256x192 training steps (bf16, K1 + K2
            attention, drop_path 0.3, the COCO-B optimizer, batch 64) from
            seeded synthetic records on 640x640 canvases, augmented on the
            host (flip, half-body, scale, rotation) and cropped with UDP
            targets on the card: exactly 12 K1 and 12 K2 launches per step,
            all of the whole-pair designs, every tensor on the card, finite
            loss and gradients, parameters
            and BN statistics changed, acc_pose in [0, 1]; ms per step, and
            a torch.profiler view of two more steps: kernel time per step,
            the card's idle share and the kernels that take the most time
  train-ref the same seeded weights and batch of 2 crops, drop_path 0, on
            CUDA (K1 + K2) and on the CPU (plain attention): in f32 (TF32
            off) loss, grad_norm, every gradient, and every parameter
            tensor and BN statistic after 2 steps agree; in bf16 CUDA is as close to the
            f32 CPU answer as the bf16 CPU path is (within BF16_FACTOR)
  train-loop the training CLI (vitpose_tpu_torch.tools.train) on the COCO-B
            config file at full width (ViTPose-B 256x192 bf16, K1 + K2,
            drop_path 0.3, batch 64, UDP targets), pointed by --cfg-options
            at a synthetic COCO train set (1050 persons: 16 steps per epoch)
            and val set (256 boxes: 4 batches), starting from the shaped
            weights (load_from), 2 epochs with an evaluation and a
            checkpoint after each, logging every step: exactly 12 K1 + 12
            K2 launches per step and 24 K1 per val batch, all whole-pair;
            finite metrics, best.pth written; step wall time and img/s, the
            data_time share, the card's idle share (the train phase's kernel
            time over the step), AP per epoch, checkpoint bytes, peak memory
  train-resume the epoch-0 checkpoint restored into a fresh runner state
            equals the saved one bit for bit (parameters, BN statistics,
            AdamW moments and step counts on the card, lr, schedule, step);
            restore and save times; epoch 1 redone with --resume in a copy of
            the work dir gives the uninterrupted run's losses, final weights
            and AP exactly; best.pth loads through init_pose_model and the
            evaluation CLI scores it to the AP the runner logged
  remat     ViTPose-B bf16 train steps at batch 64 without remat and under
            remat 'full', 'attn' and 'dots', from the same weights, batch and
            DropPath seeds: K1 launches 12/24/12/24 and K2 12 in a step,
            gradients within REMAT_GRAD_TOL of no remat, the peak memory
            above the resident state, and step times in turns
  moe-train the training CLI on the ViTPose+-B config file (6 experts of
            part_dim 192, 6 heads of 17/14/16/17/17/133 channels, bf16, UDP,
            batch 128, K1 + K2 turned on by --cfg-options) over six seeded
            synthetic train sets in their own formats (COCO, AIC, MPII,
            AP-10K, APT-36K, COCO-WholeBody; 2 batches each, 12 steps in one
            epoch) and a COCO val set, `pretrained` the shaped dense ViT-B
            backbone: every expert's features first equal the dense
            backbone's; exactly 12 K1 + 12 K2 launches per step and 24 K1
            per val batch, all whole-pair; every dataset in the log, every
            other head's loss exactly 0, finite metrics, best.pth under the
            mmpose names; model_split of best.pth and the evaluation CLI on
            its COCO part with the COCO-B config give the runner's AP; step
            wall time, img/s, data_time share, kernel time per step, peak
            memory, checkpoint bytes and phase times
  moe-ref   two ViTPose+ MoE steps (make_moe_train_step) at full ViTPose+-B
            width and depth on 3 crops whose datasets mix within each batch
            (so the blocks route rows per expert), drop_path 0, on CUDA
            (K1 + K2) and on the CPU (plain attention): f32 (TF32 off)
            losses, grad_norm, gradients, parameters, every expert's rows
            and BN statistics within MOE_REF_TOL, printed beside the CPU's
            own spread on one thread; bf16 CUDA as close to the f32 CPU
            answer as the bf16 CPU path is (within BF16_FACTOR)

Then the kernels JSON line (per kernel: the design the main path takes, its
times, the tiled design's times from the same run, bound, library time,
launches in a train step and `launches_per_path`: per serve call, int8
serve call, server request per mode, eval run, int8 eval run, train step,
train-loop run, remat step and moe-train run; beside the kernels, the
int8 product's launches per path and times, the server's latencies and the
int8 AP), the nvidia-smi card line and the result line.

The weights are random (torch.Generator seed 0, inside init_pose_model).
Random heatmaps make the UDP Newton step ill conditioned, so the smoke makes
each person box hold one clear peak: it paints a bright square at every box
centre of a dim random image, turns channel 0 of the patch embedding into a
brightness detector, and carries channel 0 through bump-shaped deconv kernels
onto every joint (`shape_peaks`). Every other weight stays random.
"""
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense bf16 tensor cores
              torch.float32: 67e12}     # f32 outside the tensor cores
# (atol, rtol). f32: summation order. bf16: the output is rounded to bf16 on
# both sides (one step is at most 2^-7 of |o|, inside rtol) and the tiled
# design rounds P to bf16 at a different point (unnormalised; normalised in
# the plain version and the whole-pair design), a few 1e-3 at |o| < 0.5
# (atol)
TOLS = {torch.float32: (1e-5, 1e-5),
        torch.bfloat16: (4e-3, 1e-2)}
# (shape [N,T,H,d], dtype, role). Every bf16 case up to T = 192 runs in both
# designs (the whole pair per block, and the tiled one); T = 192 and 193 are
# the two sides of the plan's boundary (PAIR_MAX_T)
KERNEL_CASES = [
    ((256, 192, 12, 64), torch.bfloat16, 'serving batch 256, ViT-B'),
    ((256, 192, 12, 64), torch.float32, 'serving batch 256, f32'),
    ((8, 192, 12, 64), torch.bfloat16, 'serve call, 8 boxes'),
    ((64, 192, 12, 64), torch.bfloat16, 'training batch 64, ViT-B'),
    ((128, 192, 12, 64), torch.bfloat16, 'ViTPose+ batch 128'),
    ((16, 192, 16, 80), torch.bfloat16, 'ViT-H head dim'),
    ((32, 192, 6, 32), torch.bfloat16, 'ViT-S head dim'),
    ((4, 193, 12, 64), torch.bfloat16, 'one token past the whole pair'),
    ((2, 972, 16, 80), torch.bfloat16, '576x432 inputs'),
    ((4, 72, 12, 64), torch.bfloat16, 'last key tile holds 8 of 64 keys'),
    ((3, 48, 5, 32), torch.float32, 'ragged'),
]
BWD_CASES = [
    ((64, 192, 12, 64), torch.bfloat16, 'training batch 64, ViT-B'),
    ((64, 192, 12, 64), torch.float32, 'training batch 64, f32'),
    ((128, 192, 12, 64), torch.bfloat16, 'ViTPose+ batch 128'),
    ((16, 192, 16, 80), torch.bfloat16, 'ViT-H head dim'),
    ((32, 192, 6, 32), torch.bfloat16, 'ViT-S head dim'),
    ((4, 193, 12, 64), torch.bfloat16, 'one token past the whole pair'),
    ((2, 972, 16, 80), torch.bfloat16, '576x432 inputs'),
    ((4, 72, 12, 64), torch.bfloat16, 'last tile holds 8 of 64 rows'),
    ((3, 48, 5, 32), torch.float32, 'ragged'),
]
# K2 against its plain version, per output: |err| <= atol * max|ref| +
# rtol * |ref|. f32: summation order. bf16: the outputs are rounded to bf16
# on both sides (one step is 2^-8 of |x|, inside rtol), and K2 rounds P and
# dS to bf16 (2^-9 relative) as operands of the products dV = P^T g,
# dQ = dS k, dK = dS^T q; a CPU emulation of exactly those roundings needs
# atol 0.6e-3 to 1.4e-3 of max|ref| at these shapes (rtol 1e-2), so atol is
# twice that
BWD_TOLS = {torch.float32: (1e-5, 1e-5),
            torch.bfloat16: (3e-3, 1e-2)}
SERVE_CFG = {'variant': 'b', 'dtype': 'bfloat16',
             'backbone_overrides': {'fused_attention': True}}
TRAIN_BATCH = 64                     # configs/base/coco_data.py
CANVAS = 640                         # configs/base/coco_data.py canvas_size
STEPS_PER_EPOCH = 2340               # COCO train2017: 149,813 people / 64
TIMED_STEPS = 5
HM_TOL = (1e-3, 1e-4)               # CUDA vs CPU f32 heatmaps (atol, rtol)
KP_TOL_PX = 0.05                     # CUDA vs CPU keypoints, image pixels
# bf16: max |CUDA bf16 - CPU f32| over heatmaps (and decisive keypoints, plus
# KP_TOL_PX) may be at most this many times max |CPU bf16 - CPU f32|, the
# error of bf16 itself: two bf16 paths that round at different points each
# land about that far from the f32 answer
BF16_FACTOR = 2.0


class Failure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Failure(msg)


def card_line():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, calls=10, rounds=7, warmup=3):
    """Time of one fn() on the card: median over `rounds` of a CUDA-event
    timing of `calls` back-to-back calls, divided by `calls`, after warm-up.
    Back to back, the host enqueues the next call while the card runs this
    one, so a call's host overhead shows only where it exceeds its device
    time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_ms(fn, calls=10, rounds=7):
    """Device time of one fn(): `calls` calls captured in one CUDA graph,
    replayed after a warm-up; the median over `rounds` replays, each timed
    by CUDA events, divided by `calls`. No host time enters, unlike
    time_ms, where a call's host time shows wherever it exceeds the
    kernel's."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def attention_bound(shape, dtype):
    """Least time for the work: q, k, v read once, O written once, against
    QK^T and PV at the card's peak rate for the dtype."""
    n, t, h, d = shape
    esize = torch.finfo(dtype).bits // 8
    bytes_ms = 4 * n * t * h * d * esize / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * n * h * t * t * d / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def designs_of(shape, dtype, backward):
    """(the design `_plan` picks, every design that takes the shape): the
    tiled design takes every shape, the whole pair only what _plan gives
    it."""
    from vitpose_tpu_torch.ops.attention import _plan
    planned = _plan(shape[1], shape[3], dtype, backward)[0]
    return planned, ('tiled', 'pair') if planned == 'pair' else ('tiled',)


def time_designs(run, designs, timer=time_ms):
    """ms of run(design) for each design by `timer`. Two designs are timed
    in turns on this card (old, new, new, old) and each gets the mean of
    its two turns; returns ({design: ms}, [the four turns])."""
    if len(designs) == 1:
        return {designs[0]: timer(lambda: run(designs[0]))}, []
    old, new = designs
    turns = [(d, timer(lambda d=d: run(d))) for d in (old, new, new, old)]
    return {d: statistics.mean(ms for dd, ms in turns if dd == d)
            for d in designs}, turns


def design_note(planned, ms, turns, dev):
    """The part of a kernel line that names the designs and their times:
    back to back (kernel_ms; tiled_ms for the old design) and on the device
    alone (device_ms, CUDA graph)."""
    note = f'design {planned}, kernel_ms {ms[planned]:.4f}'
    if turns:
        note += f', tiled_ms {ms["tiled"]:.4f} (turns ' + ', '.join(
            f'{d} {t:.4f}' for d, t in turns) + ')'
    return note + ', device_ms ' + ', '.join(
        f'{d} {t:.4f}' for d, t in dev.items())


def phase_kernel():
    from vitpose_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False     # true f32 reference
    gen = torch.Generator(device='cuda').manual_seed(0)
    records = []
    for shape, dtype, role in KERNEL_CASES:
        n, t, h, d = shape
        # strided q/k/v views of one qkv tensor, as the ViT gives them
        qkv = torch.randn(n, t, 3, h, d, generator=gen, device='cuda',
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv.unbind(2)
        ref = attn.reference_attention(q, k, v)
        atol, rtol = TOLS[dtype]
        planned, designs = designs_of(shape, dtype, False)
        errs = {}
        for design in designs:
            before = attn.fused_attention.design_launches[design]
            out = attn.fused_attention(q, k, v, _design=design)
            torch.cuda.synchronize()
            check(attn.fused_attention.design_launches[design] == before + 1,
                  f'K1 {design} did not count its launch')
            diff = (out.float() - ref.float()).abs()
            errs[design] = diff.max().item()
            bad = (diff > atol + rtol * ref.float().abs()).sum().item()
            check(torch.isfinite(out).all().item(),
                  f'K1 {design} non-finite at {shape}')
            check(bad == 0, f'K1 {design} disagrees with plain at {shape} '
                  f'{dtype}: {bad} elements, max abs err {errs[design]}')
            del out, diff
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms, turns = time_designs(
            lambda dsg: attn.fused_attention(q, k, v, _design=dsg), designs)
        dev, _ = time_designs(
            lambda dsg: attn.fused_attention(q, k, v, _design=dsg), designs,
            device_ms)
        plain_ms = time_ms(lambda: attn.reference_attention(q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound_ms, bound_by = attention_bound(shape, dtype)
        dt = str(dtype).replace('torch.', '')
        print(f'kernel attention_fwd {shape} {dt} ({role}): max_abs_err '
              + ', '.join(f'{dsg} {e:.3e}' for dsg, e in errs.items())
              + f' (tol {atol:g} + {rtol:g}|ref|), '
              f'{design_note(planned, ms, turns, dev)}, plain_ms {plain_ms:.4f}, '
              f'library_ms {lib_ms:.4f} (sdpa), bound_ms {bound_ms:.4f} '
              f'({bound_by})', flush=True)
        records.append(dict(shape=shape, dtype=dtype, design=planned,
                            err=errs[planned], ms=ms[planned],
                            old_ms=ms['tiled'] if turns else None,
                            device_ms=dev,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
        del qkv, q, k, v, ref
    print(f'kernels: attention_fwd built, launched and matched its plain '
          f'version at {len(records)} shapes, in every design that takes '
          f'each', flush=True)
    return records[0]


def shape_peaks(model):
    """Heatmaps with one smooth peak per joint at bright image patches."""
    bump = torch.tensor([1.0, 3.0, 3.0, 1.0])
    bump = torch.outer(bump, bump) / 8
    with torch.no_grad():
        proj = model.backbone.patch_embed.proj
        proj.weight[0] = 20.0 / proj.weight[0].numel()
        head = model.keypoint_head
        for i in (0, 3):
            head.deconv_layers[i].weight[0, 0] = bump
        head.final_layer.weight[:, 0] = 1.0


def scene(seed, boxes):
    """A dim random 480x640 image with a bright 24x24 square at each box
    centre."""
    img = np.random.RandomState(seed).randint(0, 60, (480, 640, 3), np.uint8)
    for x, y, w, h in boxes[:, :4]:
        cx, cy = int(x + w / 2), int(y + h / 2)
        img[cy - 12:cy + 12, cx - 12:cx + 12] = 255
    return img


def grid_boxes(rng, cols, rows):
    """Boxes on a grid, far enough apart that no padded crop holds a second
    square."""
    xs, ys = np.meshgrid(10 + 160 * np.arange(cols),
                         10 + 240 * np.arange(rows))
    n = xs.size
    return np.stack([xs.ravel() + rng.uniform(0, 20, n),
                     ys.ravel() + rng.uniform(0, 20, n),
                     rng.uniform(100, 130, n), rng.uniform(190, 215, n),
                     np.full(n, 0.9)], 1).astype(np.float32)


def padded_boxes(boxes, model):
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    iw, ih = model.image_size
    c, s = bbox_xywh2cs(boxes[:, :4], iw / ih, padding=model.padding)
    return c.numpy(), s.numpy() * 200.0


class DeviceAudit(TorchDispatchMode):
    """Records every tensor an op takes or returns that is not on CUDA."""

    def __init__(self):
        super().__init__()
        self.off_device = set()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        leaves = tree_flatten((args, kwargs, out))[0]
        for x in leaves:
            if isinstance(x, torch.Tensor) and x.device.type != 'cuda':
                self.off_device.add(f'{func} {x.device} {tuple(x.shape)}')
        return out


def reset_counts():
    """Every kernel wrapper's launch counts to 0, per design too, and the
    int8 product's (torch._int_mm) count."""
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    for fn in (fused_attention, fused_attention_bwd):
        fn.launches = 0
        fn.design_launches = dict.fromkeys(fn.design_launches, 0)
    int8_matmul.launches = 0


def phase_serve():
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    model = init_pose_model(SERVE_CFG, device='cuda')
    shape_peaks(model.model)
    check(all(p.is_cuda for p in model.model.parameters()),
          'a parameter is off the card')
    rng = np.random.RandomState(0)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(0, boxes)
    persons = [{'bbox': b} for b in boxes]

    reset_counts()
    t0 = time.perf_counter()
    results, _ = inference_top_down_pose_model(model, img, persons)
    call_s = time.perf_counter() - t0
    launches = fused_attention.launches
    bwd_launches = fused_attention_bwd.launches
    depth = model.cfg.backbone.depth
    check(launches == depth * 2, f'K1 launched {launches} times in the '
          f'serve call, expected {depth} blocks x 2 passes')
    check(fused_attention.design_launches == {'pair': depth * 2, 'tiled': 0},
          f'K1 designs in the serve call: {fused_attention.design_launches}, '
          'expected the whole pair every time')
    check(bwd_launches == 0, f'K2 launched {bwd_launches} times in the '
          'serve call, expected none')

    kp = np.stack([r['keypoints'] for r in results])          # [8, 17, 3]
    check(kp.shape == (8, 17, 3) and np.isfinite(kp).all(),
          f'keypoints not finite or of shape {kp.shape}')
    center, size = padded_boxes(boxes, model)
    inside = np.abs(kp[..., :2] - center[:, None]) <= size[:, None] / 2
    check(inside.all(), f'{(~inside).sum()} keypoint coordinates outside '
          'their padded boxes')

    # warp to decode once more, recording every tensor that is not on CUDA
    dev = model.device
    iw, ih = model.image_size
    image = torch.from_numpy(img).to(dev)
    c, s = bbox_xywh2cs(boxes[:, :4], iw / ih)
    c, s = c.to(dev), s.to(dev)
    audit = DeviceAudit()
    with audit:
        model.infer_batch(image[None].expand(8, *image.shape), c, s)
    torch.cuda.synchronize()
    check(not audit.off_device, f'off-card tensors on the serving path: '
          f'{sorted(audit.off_device)[:5]}')
    print(f'serve: ViTPose-B 256x192 bf16, 8 boxes, {launches} K1 launches '
          f'(12 blocks x 2, all whole-pair) and {bwd_launches} K2, keypoints '
          f'finite and inside their padded boxes, '
          f'{audit.ops} ops all on CUDA, first call {call_s:.2f} s',
          flush=True)

    n = 256
    big = np.stack([rng.uniform(0, 480, n), rng.uniform(0, 260, n),
                    rng.uniform(60, 160, n), rng.uniform(120, 220, n)], 1)
    c, s = bbox_xywh2cs(big.astype(np.float32), iw / ih)
    c, s = c.to(dev), s.to(dev)
    imgs = image[None].expand(n, *image.shape)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _ = model.infer_batch(imgs, c, s)
        torch.cuda.synchronize()
        if i:                                            # first is warm-up
            times.append(time.perf_counter() - t0)
        check(torch.isfinite(preds).all().item(), 'non-finite batch preds')
    med = statistics.median(times)
    return model, launches, med, n / med


def phase_serve_ref():
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    boxes = grid_boxes(np.random.RandomState(1), 2, 1)
    img = scene(1, boxes)
    persons = [{'bbox': b} for b in boxes]
    out = {}
    for dtype in ('float32', 'bfloat16'):
        cfg = {'variant': 'b', 'dtype': dtype,
               'backbone_overrides': {'fused_attention': True}}
        for dev in ('cuda', 'cpu'):
            model = init_pose_model(cfg, device=dev)
            shape_peaks(model.model)
            res, hm = inference_top_down_pose_model(model, img, persons,
                                                    return_heatmap=True)
            out[dev, dtype] = (np.stack([r['keypoints'][:, :2] for r in res]),
                               hm[0]['heatmap'])
            del model
    kp_ref, hm_ref = out['cpu', 'float32']

    kp_g, hm_g = out['cuda', 'float32']
    atol, rtol = HM_TOL
    hm_err = np.abs(hm_g - hm_ref).max()
    check(np.all(np.abs(hm_g - hm_ref) <= atol + rtol * np.abs(hm_ref)),
          f'f32 CUDA and CPU heatmaps differ by {hm_err}')
    top2 = np.sort(hm_ref.reshape(*hm_ref.shape[:2], -1), axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 100 * atol
    check(decisive.mean() >= 0.5, f'only {decisive.sum()} decisive joints')

    def kp_err(kp):
        return np.abs(kp - kp_ref).max(-1)[decisive].max()

    check(kp_err(kp_g) <= KP_TOL_PX, f'f32 keypoints differ by '
          f'{kp_err(kp_g)} px')
    print(f'serve-ref: f32 (TF32 off) CUDA+K1 vs CPU plain, 2 boxes: heatmap '
          f'max abs diff {hm_err:.3e} (tol {atol:g} + {rtol:g}|ref|), '
          f'keypoints max diff {kp_err(kp_g):.3e} px (tol {KP_TOL_PX}) over '
          f'{decisive.sum()}/{decisive.size} decisive joints', flush=True)

    (kp_gb, hm_gb), (kp_cb, hm_cb) = out['cuda', 'bfloat16'], out['cpu',
                                                                'bfloat16']
    errs = {'heatmap': (np.abs(hm_gb - hm_ref).max(),
                        np.abs(hm_cb - hm_ref).max(), 0.0),
            'keypoint px': (kp_err(kp_gb), kp_err(kp_cb), KP_TOL_PX)}
    for what, (cuda_err, cpu_err, floor) in errs.items():
        check(cuda_err <= BF16_FACTOR * cpu_err + floor,
              f'bf16 CUDA {what}s are {cuda_err} from the f32 answer, the '
              f'bf16 CPU path {cpu_err}: more than {BF16_FACTOR}x + '
              f'{floor}')
    print(f'serve-ref: bf16 against the f32 CPU answer, 2 boxes: CUDA+K1 / '
          f'CPU plain heatmap max abs diff {errs["heatmap"][0]:.3e} / '
          f'{errs["heatmap"][1]:.3e}, decisive keypoints '
          f'{errs["keypoint px"][0]:.3e} / {errs["keypoint px"][1]:.3e} px '
          f'(CUDA at most {BF16_FACTOR}x CPU, + {KP_TOL_PX} px for '
          f'keypoints); CUDA vs CPU bf16 heatmaps '
          f'{np.abs(hm_gb - hm_cb).max():.3e}; max |f32 heatmap| '
          f'{np.abs(hm_ref).max():.3e}', flush=True)


# int8: the four ViT-B products (in, out) and the rows of one 8-box call's
# pass (checked against the CPU) and of a 256-crop batch's (timed)
INT8_SHAPES = (('qkv', 768, 2304), ('proj', 768, 768), ('fc1', 768, 3072),
               ('fc2', 3072, 768))
INT8_CHECK_ROWS = 8 * 192
INT8_TIME_ROWS = 256 * 192
INT8_PEAK_OPS = 1979e12              # dense int8 tensor-core rate


def int8_bound(m, k, n):
    """Least time of the int8 product: x_q and w_q read once, the int32
    output written once, against 2mnk operations at the int8 peak."""
    bytes_ms = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * n * k / INT8_PEAK_OPS * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def phase_int8(card):
    """Int8Linear on the card against its CPU path at the four ViT-B
    shapes, bf16 in and out as the serve path runs it: equal weight and
    activation codes, an exact int32 product, equal outputs; then the
    times of torch._int_mm, the bf16 product it replaces, and the
    quantise + dequantise passes alone."""
    from vitpose_tpu_torch.models.vit import Int8Linear, int8_matmul
    gen = torch.Generator().manual_seed(3)
    records = {}
    for name, k, n in INT8_SHAPES:
        x = torch.randn(INT8_CHECK_ROWS, k, generator=gen).to(torch.bfloat16)
        a = float(x.float().abs().amax())
        cpu = Int8Linear(k, n, act_scale=a)
        with torch.no_grad():
            cpu.weight.copy_(torch.randn(n, k, generator=gen) * k ** -0.5)
            cpu.bias.copy_(0.1 * torch.randn(n, generator=gen))
        card_layer = Int8Linear(k, n, act_scale=a).cuda()
        card_layer.load_state_dict(cpu.state_dict())
        xc = x.cuda()
        w_q, _ = cpu.quantized_weight()
        w_qc, _ = card_layer.quantized_weight()
        x_q, _ = cpu.quantize_input(x)
        x_qc, _ = card_layer.quantize_input(xc)
        check(torch.equal(w_qc.cpu(), w_q) and torch.equal(x_qc.cpu(), x_q),
              f'int8 {name}: codes differ between the card and the CPU')
        y = int8_matmul(x_q, w_q)
        yc = int8_matmul(x_qc, w_qc)
        check(torch.equal(yc.cpu(), y), f'int8 {name}: the int32 product '
              'differs between the card and the CPU')
        with torch.no_grad():
            out = cpu(x, torch.bfloat16).float()
            outc = card_layer(xc, torch.bfloat16).float().cpu()
        err = (outc - out).abs().max().item()
        check(err == 0.0, f'int8 {name}: outputs differ by {err}')

        m = INT8_TIME_ROWS
        xt = torch.randn(m, k, device='cuda', dtype=torch.bfloat16)
        card_layer.act_scale = float(xt.float().abs().amax())
        w_qc, s_w = card_layer.quantized_weight()
        x_qt, s_x = card_layer.quantize_input(xt)
        yt = int8_matmul(x_qt, w_qc)
        w16, b16 = (t.detach().to(torch.bfloat16) for t in (
            card_layer.weight, card_layer.bias))
        bias = card_layer.bias.detach()

        def quant_dequant():
            card_layer.quantize_input(xt)
            ((yt.float() * s_x) * s_w + bias).to(torch.bfloat16)

        with torch.no_grad():
            ms = {'int_mm': time_ms(lambda: int8_matmul(x_qt, w_qc)),
                  'bf16': time_ms(lambda: F.linear(xt, w16, b16)),
                  'quant_dequant': time_ms(quant_dequant),
                  'int8_linear': time_ms(
                      lambda: card_layer(xt, torch.bfloat16))}
        bound_ms, bound_by = int8_bound(m, k, n)
        print(f'int8 {name} [{INT8_CHECK_ROWS}x{k}] x [{k}x{n}]: codes, '
              f'int32 product and bf16 outputs equal the CPU path\'s '
              f'(tol 0); at {m} rows: _int_mm {ms["int_mm"]:.4f} ms '
              f'(bound {bound_ms:.4f}, {bound_by}), bf16 matmul '
              f'{ms["bf16"]:.4f} ms, quantise + dequantise '
              f'{ms["quant_dequant"]:.4f} ms, Int8Linear '
              f'{ms["int8_linear"]:.4f} ms on {card}', flush=True)
        records[name] = dict(ms, bound_ms=bound_ms, bound_by=bound_by,
                             max_abs_err=err)
        del xt, x_qt, yt
    torch.cuda.empty_cache()
    return records


def scene_crops(pm, img, boxes):
    """The normalised crops of `boxes` on `img`, as the serve path cuts
    them, on the card: representative calibration inputs for the shaped
    weights (the server's --calib-dir)."""
    from vitpose_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs, udp_warp_matrix
    from vitpose_tpu_torch.ops.warp import warp_affine_batch
    iw, ih = pm.image_size
    c, s = bbox_xywh2cs(boxes[:, :4], iw / ih, padding=pm.padding)
    n = len(boxes)
    x = (torch.from_numpy(img).cuda().float() / 255.0)[None].expand(
        n, -1, -1, -1)
    mat = udp_warp_matrix(torch.zeros(n, device='cuda'), c.cuda(), s.cuda(),
                          (iw, ih))
    crops = warp_affine_batch(x, mat, (iw, ih))
    return ((crops - torch.as_tensor(IMAGENET_MEAN, device='cuda'))
            / torch.as_tensor(IMAGENET_STD, device='cuda'))


FAST_CFG = {'variant': 'b', 'dtype': 'bfloat16',
            'backbone_overrides': {'fused_attention': True,
                                   'gelu_approx': True}}
# serve-int8: the int8 path's keypoints (qkv on, skip 0 and 1) may lie at
# most this far from the --fast bf16 path's, in image pixels. The first
# chip run read 0.076 px (skip 0) and 0.070 px (skip 1); the bound is about
# three times that, a twelfth of the eval set's GT jitter
SERVE_INT8_KP_PX = 0.25
INT8_TURN_CALLS = 4


def batch_ms(pm, imgs, c, s, calls=INT8_TURN_CALLS):
    """Median ms of `calls` 256-crop infer_batch calls after one warm-up."""
    times = []
    for i in range(calls + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, _ = pm.infer_batch(imgs, c, s)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        check(torch.isfinite(preds).all().item(), 'non-finite batch preds')
    return statistics.median(times)


def phase_serve_int8(card):
    """Full-width ViTPose-B 256x192 through int8_serving_config (W8A8 MLP,
    qkv and proj; bf16, K1, tanh GELU as --fast) at skip 0 and 1, scales
    calibrated on the scene's crops: launches per 8-box call, keypoints
    against the --fast bf16 path's, and the 256-crop batch of int8 and of
    --fast bf16 timed in turns (bf16, int8, int8, bf16)."""
    import dataclasses
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    from vitpose_tpu_torch.utils.quantize import (calibrate_act_scales,
                                                  first_last_skip,
                                                  int8_serving_config,
                                                  rebuild)
    fast = init_pose_model(FAST_CFG, device='cuda')
    shape_peaks(fast.model)
    rng = np.random.RandomState(0)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(0, boxes)
    persons = [{'bbox': b} for b in boxes]
    scales = calibrate_act_scales(fast.model, [scene_crops(fast, img, boxes)],
                                  attn=True)
    ref, _ = inference_top_down_pose_model(fast, img, persons)
    kp_ref = np.stack([r['keypoints'] for r in ref])
    center, size = padded_boxes(boxes, fast)
    int8_models, out = {}, {}
    depth = fast.cfg.backbone.depth
    for skip in (0, 1):
        cfg = int8_serving_config(fast.cfg, scales, qkv=True,
                                  skip_blocks=first_last_skip(depth, skip,
                                                              skip))
        pm = dataclasses.replace(fast, model=rebuild(fast.model, cfg),
                                 cfg=cfg)
        reset_counts()
        results, _ = inference_top_down_pose_model(pm, img, persons)
        k1, mm = fused_attention.launches, int8_matmul.launches
        check(k1 == 2 * depth and fused_attention.design_launches
              == {'pair': k1, 'tiled': 0}, f'serve-int8 skip {skip}: K1 '
              f'{fused_attention.design_launches}, expected 24 whole-pair')
        check(mm == 8 * (depth - 2 * skip), f'serve-int8 skip {skip}: '
              f'_int_mm launched {mm} times, expected 4 products x '
              f'{depth - 2 * skip} blocks x 2 passes')
        kp = np.stack([r['keypoints'] for r in results])
        check(kp.shape == (8, 17, 3) and np.isfinite(kp).all(),
              f'serve-int8 keypoints not finite or of shape {kp.shape}')
        inside = np.abs(kp[..., :2] - center[:, None]) <= size[:, None] / 2
        check(inside.all(), f'serve-int8: {(~inside).sum()} keypoint '
              'coordinates outside their padded boxes')
        dist = np.abs(kp[..., :2] - kp_ref[..., :2]).max(-1)
        out[skip] = dict(k1=k1, int_mm=mm, kp_px=float(dist.max()),
                         score=float(np.abs(kp[..., 2]
                                            - kp_ref[..., 2]).max()))
        print(f'serve-int8: ViTPose-B 256x192 int8 (qkv on, skip {skip}), '
              f'8 boxes: {k1} K1 launches (all whole-pair), {mm} _int_mm; '
              f'keypoints finite and inside their padded boxes, max '
              f'{dist.max():.4f} px (median {np.median(dist):.4f}; bound '
              f'{SERVE_INT8_KP_PX}) and score {out[skip]["score"]:.4f} from '
              f'the --fast bf16 path\'s', flush=True)
        check(dist.max() <= SERVE_INT8_KP_PX, f'serve-int8 skip {skip}: '
              f'keypoints {dist.max()} px from bf16, bound '
              f'{SERVE_INT8_KP_PX}')
        int8_models[skip] = pm
    n = 256
    big = np.stack([rng.uniform(0, 480, n), rng.uniform(0, 260, n),
                    rng.uniform(60, 160, n), rng.uniform(120, 220, n)], 1)
    iw, ih = fast.image_size
    c, s = (t.cuda() for t in bbox_xywh2cs(big.astype(np.float32), iw / ih))
    imgs = torch.from_numpy(img).cuda()[None].expand(n, -1, -1, -1)
    turns = [(name, batch_ms(pm, imgs, c, s)) for name, pm in (
        ('bf16', fast), ('int8', int8_models[0]), ('int8', int8_models[0]),
        ('bf16', fast))]
    ms = {name: statistics.mean(t for nn, t in turns if nn == name)
          for name in ('bf16', 'int8')}
    print(f'serve-int8: 256-crop batch (warp, ViT-B + K1, tanh GELU, flip '
          f'test, UDP decode) bf16 {ms["bf16"]:.1f} ms, int8 qkv skip 0 '
          f'{ms["int8"]:.1f} ms = {ms["int8"] / ms["bf16"]:.2f}x (turns ' +
          ', '.join(f'{nn} {t:.1f}' for nn, t in turns) + f') on {card}',
          flush=True)
    del fast, int8_models
    torch.cuda.empty_cache()
    return out, ms


DEPLOY_REQUESTS = 30                 # timed requests per mode and box count
DEPLOY_DIRECT_CALLS = 10             # timed direct API calls of the same


def phase_deploy(card, root):
    """tools/serve.py on the card, as a user starts it: the COCO-B config
    (bf16, K1) in its default mode, --fast and --int8-qkv (calibrated on
    the scene's person crops through --calib-dir), and the default
    --variant s with --fast (K1 at head dim 32), each from shaped weights
    saved as a .pth. Every response equals the direct API call on the
    server's model; K1 (and _int_mm) launches per request; p50/p99
    latency of 1-box and 8-box requests, beside the median of the direct
    call alone."""
    import base64
    import http.client
    import os
    import threading
    import cv2
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.tools import serve
    rng = np.random.RandomState(2)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(2, boxes)
    body = {n: json.dumps({'image': base64.b64encode(cv2.imencode(
        '.png', img[..., ::-1])[1].tobytes()).decode(),
        'bboxes': boxes[:n].tolist()}).encode() for n in (1, 8)}
    ckpts = {}
    for variant, cfg in (('b', COCO_B), ('s', 's')):
        pm = init_pose_model(cfg, device='cuda')
        shape_peaks(pm.model)
        ckpts[variant] = os.path.join(root, f'vitpose_{variant}_peaks.pth')
        torch.save(pm.model.state_dict(), ckpts[variant])
        del pm
    calib = os.path.join(root, 'calib')
    os.makedirs(calib)
    for i, (x, y, w, h, _) in enumerate(boxes.astype(int)):
        cv2.imwrite(os.path.join(calib, f'{i}.png'),
                    img[y:y + h, x:x + w, ::-1])
    modes = {
        'b default': ['--config', COCO_B, '--checkpoint', ckpts['b']],
        'b --fast': ['--config', COCO_B, '--checkpoint', ckpts['b'],
                     '--fast'],
        'b --int8-qkv': ['--config', COCO_B, '--checkpoint', ckpts['b'],
                         '--int8-qkv', '--calib-dir', calib],
        's --fast': ['--variant', 's', '--checkpoint', ckpts['s'], '--fast']}
    report = {}
    for mode, argv in modes.items():
        server = serve.build_server(argv + ['--port', '0', '--device',
                                            'cuda'])
        pm = server.pose_model
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]

        def post(n):
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
            try:
                conn.request('POST', '/predict', body=body[n],
                             headers={'Content-Type': 'application/json'})
                resp = conn.getresponse()
                return resp.status, json.loads(resp.read())
            finally:
                conn.close()

        try:
            lat, launches = {}, {}
            for n in (1, 8):
                status, got = post(n)
                check(status == 200, f'deploy {mode}: status {status} '
                      f'{got}')
                direct, _ = inference_top_down_pose_model(
                    pm, img, [{'bbox': b} for b in boxes[:n]])
                want = [{'bbox': np.asarray(r['bbox']).tolist(),
                         'keypoints': np.asarray(r['keypoints']).tolist()}
                        for r in direct]
                check(got['pose_results'] == want, f'deploy {mode}: the '
                      f'{n}-box response differs from the direct call')
                kp = np.array([r['keypoints'] for r in want])
                check(np.isfinite(kp).all(), f'deploy {mode}: non-finite '
                      'keypoints')
                reset_counts()
                times = []
                for _ in range(DEPLOY_REQUESTS):
                    t0 = time.perf_counter()
                    status, _ = post(n)
                    times.append((time.perf_counter() - t0) * 1e3)
                    check(status == 200, f'deploy {mode}: status {status}')
                launches[n] = (fused_attention.launches / DEPLOY_REQUESTS,
                               int8_matmul.launches / DEPLOY_REQUESTS)
                check(fused_attention.design_launches['tiled'] == 0,
                      f'deploy {mode}: K1 took the tiled design')
                # the same call without HTTP, base64, PNG and JSON
                direct_ms = []
                for _ in range(DEPLOY_DIRECT_CALLS):
                    t0 = time.perf_counter()
                    inference_top_down_pose_model(
                        pm, img, [{'bbox': b} for b in boxes[:n]])
                    direct_ms.append((time.perf_counter() - t0) * 1e3)
                lat[n] = (float(np.percentile(times, 50)),
                          float(np.percentile(times, 99)),
                          float(np.median(direct_ms)))
        finally:
            server.shutdown()
            server.server_close()
            thread.join(60)
        depth = pm.cfg.backbone.depth
        int8 = 'int8' in mode
        for n, (k1, mm) in launches.items():
            check(k1 == 2 * depth and mm == (8 * depth if int8 else 0),
                  f'deploy {mode}, {n} boxes: {k1} K1 and {mm} _int_mm per '
                  'request')
        report[mode] = dict(latency_ms=lat, k1_per_request=2 * depth,
                            int_mm_per_request=8 * depth if int8 else 0)
        print(f'deploy: tools/serve.py {mode}: responses equal the direct '
              f'call; {2 * depth} K1 launches (whole-pair) and '
              f'{8 * depth if int8 else 0} _int_mm per request; latency '
              f'p50/p99 over {DEPLOY_REQUESTS} requests (median direct API '
              f'call): 1 box {lat[1][0]:.1f}/{lat[1][1]:.1f} '
              f'({lat[1][2]:.1f}) ms, 8 boxes {lat[8][0]:.1f}/'
              f'{lat[8][1]:.1f} ({lat[8][2]:.1f}) ms on {card}', flush=True)
        del server, pm
        torch.cuda.empty_cache()
    return report


COCO_B = 'vitpose_tpu/configs/coco/vitpose_b_coco_256x192.py'
EVAL_BATCH = 64                      # the COCO-B config's batch size
EVAL_SMALL, EVAL_BIG = 240, 8        # 480x640 images, and 960x1280 ones
BOXES_PER_IMAGE = 4                  # 992 boxes: 15 full batches + 32
EVAL_REF_IMAGES = 4                  # eval-ref: their 16 boxes
GT_JITTER_PX = 3.0                   # GT joints: box centre + this sigma


def eval_scene(rng, boxes, scale):
    """A dim random (480, 640) * scale image with a bright square of
    24 * scale pixels at each box centre."""
    h, w, half = 480 * scale, 640 * scale, 12 * scale
    img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
    for x, y, bw, bh in boxes[:, :4]:
        cx, cy = int(x + bw / 2), int(y + bh / 2)
        img[cy - half:cy + half, cx - half:cx + half] = 255
    return img


def write_eval_set(root, seed, n_small=EVAL_SMALL, n_big=EVAL_BIG):
    """A synthetic COCO set in `root`: `n_small` 480x640 and `n_big`
    960x1280 JPEGs written with cv2, a person_keypoints json whose GT joints
    lie at each box centre (where `shape_peaks` puts the peak) plus
    GT_JITTER_PX of seeded jitter, one box in eight without a GT person, and
    a detection json of every box. The first EVAL_REF_IMAGES images also get
    a json pair of their own. Returns {name: path} and the number of
    boxes."""
    import os
    import cv2
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for i in range(n_small + n_big):
        scale = 2 if i >= n_small else 1
        boxes = grid_boxes(rng, 2, 2)
        boxes[:, 0] += rng.uniform(0, 300)
        boxes[:, :4] *= scale
        name = f'{i + 1:012d}.jpg'
        cv2.imwrite(os.path.join(root, name),
                    eval_scene(rng, boxes, scale)[..., ::-1])
        images.append(dict(id=i + 1, file_name=name, width=640 * scale,
                           height=480 * scale))
        for x, y, w, h, _ in boxes:
            dets.append(dict(image_id=i + 1, category_id=1,
                             bbox=[float(x), float(y), float(w), float(h)],
                             score=float(rng.uniform(0.5, 1.0))))
            if len(dets) % 8 == 0:
                continue                             # a false positive
            xy = np.array([x + w / 2, y + h / 2]) + rng.normal(
                0, GT_JITTER_PX * scale, (17, 2))
            v = np.where(rng.rand(17) < 0.9, 2, 0)
            anns.append(dict(
                id=len(anns) + 1, image_id=i + 1, category_id=1,
                bbox=[float(x), float(y), float(w), float(h)],
                area=float(w * h), iscrowd=0,
                num_keypoints=int((v > 0).sum()),
                keypoints=np.concatenate([xy, v[:, None]], 1).ravel()
                .tolist()))
    cats = [dict(id=1, name='person')]
    files = {}
    ref_ids = set(range(1, EVAL_REF_IMAGES + 1))
    for tag, keep in (('', lambda a: True),
                      ('_ref', lambda a: a['image_id'] in ref_ids)):
        files['ann' + tag] = os.path.join(root, f'ann{tag}.json')
        files['det' + tag] = os.path.join(root, f'det{tag}.json')
        with open(files['ann' + tag], 'w') as f:
            json.dump(dict(images=[im for im in images
                                   if keep(dict(image_id=im['id']))],
                           annotations=[a for a in anns if keep(a)],
                           categories=cats), f)
        with open(files['det' + tag], 'w') as f:
            json.dump([d for d in dets if keep(d)], f)
    return files, len(dets)


def eval_options(root, files, tag=''):
    """--cfg-options that point the config's val set at the synthetic
    files, as a user points it at COCO."""
    return [f'data.val.ann_file={files["ann" + tag]}',
            f'data.val.img_prefix={root}/',
            f'data.val.bbox_file={files["det" + tag]}']


def eval_objects(options, checkpoint, device, batch_size=None):
    """The CLI's model (checkpoint loaded, on `device`), dataset and loader
    for the COCO-B config with `options`."""
    from vitpose_tpu_torch.api.inference import load_checkpoint
    from vitpose_tpu_torch.tools.test import build_eval_objects
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    cfg = apply_options(load_config(COCO_B), options)
    model, ds, loader = build_eval_objects(cfg, batch_size)
    load_checkpoint(model, checkpoint)
    return model.to(device).eval(), ds, loader


def validate(model, loader):
    from vitpose_tpu_torch.eval.loop import run_validation
    c = model.cfg
    return run_validation(model, loader, use_udp=c.use_udp,
                          post_process=c.post_process,
                          modulate_kernel=c.modulate_kernel,
                          target_type=c.target_type)


def device_busy_ms(run):
    """(CUDA time of all device events of one run(), by torch.profiler,
    copies included; the profiled run's wall ms), or (None, wall) where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    busy = sum(e.device_time_total for e in events) / 1e3
    if busy == 0:
        return None, wall_ms
    check(busy <= wall_ms, f'profiler device time {busy:.1f} ms exceeds the '
          f'profiled run\'s wall time {wall_ms:.1f} ms')
    return busy, wall_ms


def phase_eval(card):
    import contextlib
    import io
    import os
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.eval import COCO_KPT_STAT_NAMES
    from vitpose_tpu_torch.eval.loop import make_val_step
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.tools import test as cli
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files, n_boxes = write_eval_set(root, 0)
        pm = init_pose_model(COCO_B, device='cuda')
        shape_peaks(pm.model)
        ckpt = os.path.join(root, 'vitpose_b_peaks.pth')
        torch.save(pm.model.state_dict(), ckpt)
        del pm
        print(f'eval: wrote {EVAL_SMALL + EVAL_BIG} JPEGs ({EVAL_BIG} of '
              f'960x1280, larger than the 640 canvas), {n_boxes} detection '
              f'boxes and the shaped weights in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
        options = eval_options(root, files)
        n_batches = -(-n_boxes // EVAL_BATCH)

        # the main path: the CLI, as a user runs it on COCO val
        out_json = os.path.join(root, 'stats.json')
        reset_counts()
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            stats = cli.main([COCO_B, ckpt, '--out', out_json,
                              '--cfg-options', *options])
        cli_s = time.perf_counter() - t0
        launches = fused_attention.launches
        bwd_launches = fused_attention_bwd.launches
        check(launches == 24 * n_batches, f'K1 launched {launches} times in '
              f'the eval run, expected 24 per batch x {n_batches}')
        check(fused_attention.design_launches == {'pair': launches,
                                                  'tiled': 0},
              f'K1 designs in the eval run: '
              f'{fused_attention.design_launches}, expected the whole pair')
        check(bwd_launches == 0, f'K2 launched {bwd_launches} times in the '
              'eval run, expected none')
        with open(out_json) as f:
            written = json.load(f)
        check(sorted(written) == sorted(COCO_KPT_STAT_NAMES)
              and written == {k: float(v) for k, v in stats.items()},
              f'the CLI wrote {written}, returned {dict(stats)}')
        check(json.loads(printed.getvalue()[printed.getvalue().index('{'):])
              == written, 'the CLI printed other stats than it wrote')
        check(0 < stats['AP'] < 1, f'AP {stats["AP"]} not in (0, 1)')
        print(f'eval: CLI (vitpose_tpu_torch.tools.test) on the COCO-B config '
              f'(ViTPose-B 256x192 bf16, flip test, UDP, batch {EVAL_BATCH}), '
              f'{n_boxes} boxes in {n_batches} batches: {launches} K1 '
              f'launches ({launches // n_batches} per batch, all whole-pair) '
              f'and {bwd_launches} K2; {cli_s:.1f} s with model build and '
              f'checkpoint load; stats ' + ', '.join(
                  f'{k} {v:.4f}' for k, v in stats.items()), flush=True)

        model, ds, loader = eval_objects(options, ckpt, 'cuda')
        decoder = ('native (csrc/loader.cpp)' if loader.use_native
                   else 'cv2')
        t0 = time.perf_counter()
        for batch in loader:
            pass
        host_s = time.perf_counter() - t0

        step = make_val_step(model, loader.image_size,
                             use_udp=model.cfg.use_udp,
                             post_process=model.cfg.post_process,
                             flip_index=ds.info.flip_index)
        args = [torch.from_numpy(np.ascontiguousarray(batch[k])).cuda()
                for k in ('imgs', 'center', 'scale', 'center_orig',
                          'scale_orig')]
        audit = DeviceAudit()
        with audit:
            step(*args)
        torch.cuda.synchronize()
        check(not audit.off_device, f'off-card tensors in the val step: '
              f'{sorted(audit.off_device)[:5]}')
        del args

        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = validate(model, loader)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ids = sorted(i for r in results for i in r['bbox_ids'])
        check(ids == list(range(n_boxes)), 'not one result per box')
        kp = np.concatenate([r['preds'] for r in results])
        check(kp.shape == (n_boxes, 17, 3) and np.isfinite(kp).all(),
              f'keypoints not finite or of shape {kp.shape}')
        rescored = ds.evaluate(results)
        drift = max(abs(rescored[k] - stats[k]) for k in stats)
        check(drift <= EVAL_REF_AP_TOL, f'the timed run scored stats '
              f'{drift} away from the CLI run')
        busy_ms, prof_ms = device_busy_ms(lambda: validate(model, loader))
        busy = ('not measured (the profiler saw no device time)'
                if busy_ms is None else
                f'{busy_ms:.1f} ms ({busy_ms / n_batches:.2f} per batch) of '
                f'the profiled run\'s {prof_ms:.1f} ms, idle share '
                f'{1 - busy_ms / prof_ms:.3f}')
        print(f'eval: decoder {decoder}, {loader.num_workers} threads; '
              f'{n_boxes} boxes through run_validation in {run_s * 1e3:.1f} '
              f'ms = {n_boxes / run_s:.1f} boxes/s (decode included), '
              f'{run_s * 1e3 / n_batches:.2f} ms per batch; the host alone '
              f'(decode + batch assembly, no model) {host_s * 1e3:.1f} ms = '
              f'{host_s * 1e3 / n_batches:.2f} ms per batch; card busy '
              f'{busy}; peak device memory {peak_gb:.2f} GB; every val-step '
              f'tensor on CUDA ({audit.ops} ops); on {card}', flush=True)
        del model, loader, results
        torch.cuda.empty_cache()
        phase_eval_ref(root, files, ckpt)
        int8 = phase_eval_int8(card, root, options, ckpt, stats, n_batches)
    return launches, int8


def phase_eval_int8(card, root, options, ckpt, bf16_stats, n_batches):
    """The evaluation CLI with --int8 --int8-skip 1 --show-dir on the same
    set and weights: K1 and _int_mm launches (calibration on the first two
    batches without the flip test, then W8A8 in blocks 1-10 of every
    batch), AP beside the bf16 run's, one drawing per val image."""
    import contextlib
    import io
    import os
    from vitpose_tpu_torch.models.vit import int8_matmul
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.tools import test as cli
    show_dir = os.path.join(root, 'show')
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stats = cli.main([COCO_B, ckpt, '--int8', '--int8-skip', '1',
                          '--show-dir', show_dir, '--cfg-options',
                          *options])
    run_s = time.perf_counter() - t0
    k1, mm = fused_attention.launches, int8_matmul.launches
    check(k1 == 24 * n_batches + 2 * 12 and fused_attention.design_launches
          == {'pair': k1, 'tiled': 0}, f'eval --int8: K1 '
          f'{fused_attention.design_launches}, expected 24 per batch x '
          f'{n_batches} + 12 per calibration batch x 2, all whole-pair')
    check(mm == 8 * 10 * n_batches, f'eval --int8: _int_mm launched {mm} '
          f'times, expected 4 products x 10 blocks x 2 passes x '
          f'{n_batches} batches')
    check(0 < stats['AP'] < 1, f'int8 AP {stats["AP"]} not in (0, 1)')
    drawn = sorted(os.listdir(show_dir))
    check(len(drawn) == EVAL_SMALL + EVAL_BIG and drawn[0] == '000000000001'
          '.jpg', f'--show-dir wrote {len(drawn)} files, expected one per '
          f'val image ({EVAL_SMALL + EVAL_BIG})')
    print(f'eval: CLI --int8 --int8-skip 1 --show-dir on the same set: '
          f'{k1} K1 launches (24 per batch + 2 x 12 calibrating, all '
          f'whole-pair), {mm} _int_mm; AP {stats["AP"]:.4f} beside bf16 '
          f'{bf16_stats["AP"]:.4f} (difference '
          f'{stats["AP"] - bf16_stats["AP"]:+.4f}), AR {stats["AR"]:.4f} '
          f'beside {bf16_stats["AR"]:.4f}; {len(drawn)} drawings; '
          f'{run_s:.1f} s with calibration and drawing on {card}',
          flush=True)
    return dict(k1=k1, int_mm=mm, ap=stats['AP'], bf16_ap=bf16_stats['AP'])


# eval-ref, f32 CUDA (K1) against the f32 CPU port on the same 16 boxes:
# AP may differ by at most this much (the keypoints agree as serve-ref's do)
EVAL_REF_AP_TOL = 1e-3
# eval-ref, bf16 CUDA against the f32 CPU answer. The first chip run read
# 0.070 px between the two on the shaped peaks (and 3.05e-5 px for f32
# CUDA), and the same AP. The keypoint bound is 3.5x that spread, a
# twelfth of the GT jitter. AP on these boxes moves in steps of about
# 1 / (10 OKS thresholds x 14 GT persons) = 0.007 when one match changes,
# and 0.25 px moves an OKS by at most about 0.016 here (the steepest
# joint, sigma 0.025, on a 23,000 px^2 box at GT_JITTER_PX): the AP bound
# allows three such changes
EVAL_REF_BF16_KP_PX = 0.25
EVAL_REF_BF16_AP_TOL = 0.02


def phase_eval_ref(root, files, ckpt):
    from vitpose_tpu_torch.api.inference import PoseModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    options = eval_options(root, files, '_ref')
    out = {}
    for dtype, dev in (('float32', 'cpu'), ('float32', 'cuda'),
                       ('bfloat16', 'cuda')):
        model, ds, loader = eval_objects(
            options + [f'model.dtype={dtype}'], ckpt, dev,
            batch_size=BOXES_PER_IMAGE * EVAL_REF_IMAGES)
        results = validate(model, loader)
        check(len(results) == 1, 'eval-ref boxes span more than one batch')
        out[dtype, dev] = (results[0]['preds'][..., :2],
                           ds.evaluate(results)['AP'])
        if dev == 'cpu':
            # the f32 CPU heatmaps of the same crops pick the decisive joints
            batch = next(iter(loader))
            pm = PoseModel(model=model, cfg=model.cfg,
                           dataset_info=ds.info, image_size=loader.image_size,
                           heatmap_size=tuple(ds.heatmap_size),
                           device=torch.device('cpu'))
            hm = pm.infer_batch(*(torch.from_numpy(batch[k]) for k in
                                  ('imgs', 'center', 'scale')),
                                return_heatmap=True)[2].numpy()
        del model
    kp_ref, ap_ref = out['float32', 'cpu']
    top2 = np.sort(hm.reshape(*hm.shape[:2], -1), axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 100 * HM_TOL[0]
    check(decisive.mean() >= 0.5, f'only {decisive.sum()} decisive joints')
    kp_f32, ap_f32 = out['float32', 'cuda']
    kp_bf16, ap_bf16 = out['bfloat16', 'cuda']
    err = np.abs(kp_f32 - kp_ref).max(-1)
    err_bf16 = np.abs(kp_bf16 - kp_ref).max(-1)
    print(f'eval-ref: {len(kp_ref)} boxes, f32 (TF32 off) CUDA+K1 vs CPU '
          f'plain: keypoints max diff {err[decisive].max():.3e} px over '
          f'{decisive.sum()}/{decisive.size} decisive joints (tol '
          f'{KP_TOL_PX}), {err.max():.3e} px over all; AP CUDA '
          f'{ap_f32:.6f} / CPU {ap_ref:.6f} (tol {EVAL_REF_AP_TOL})', flush=True)
    print(f'eval-ref: bf16 CUDA+K1 against the f32 CPU answer: AP '
          f'{ap_bf16:.6f} beside f32 {ap_ref:.6f} (tol '
          f'{EVAL_REF_BF16_AP_TOL}), decisive keypoints max diff '
          f'{err_bf16[decisive].max():.3e} px (tol {EVAL_REF_BF16_KP_PX}), '
          f'{err_bf16.max():.3e} px over all', flush=True)
    check(err[decisive].max() <= KP_TOL_PX, f'f32 eval keypoints differ by '
          f'{err[decisive].max()} px')
    check(abs(ap_f32 - ap_ref) <= EVAL_REF_AP_TOL, f'f32 AP CUDA {ap_f32} '
          f'vs CPU {ap_ref}')
    check(err_bf16[decisive].max() <= EVAL_REF_BF16_KP_PX, f'bf16 eval '
          f'keypoints are {err_bf16[decisive].max()} px from the f32 answer')
    check(abs(ap_bf16 - ap_ref) <= EVAL_REF_BF16_AP_TOL, f'bf16 AP '
          f'{ap_bf16} vs f32 {ap_ref}')


def attention_bwd_bound(shape, dtype):
    """Least time for K2's work: q, k, v, g read once and dq, dk, dv written
    once, against the five [T, T] x d products at the card's peak rate."""
    n, t, h, d = shape
    esize = torch.finfo(dtype).bits // 8
    bytes_ms = 7 * n * t * h * d * esize / HBM_BYTES_PER_S * 1e3
    ops_ms = 10 * n * h * t * t * d / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def bwd_error(outs, refs, dtype):
    """Max abs error over (dq, dk, dv) and whether each is inside
    BWD_TOLS."""
    atol, rtol = BWD_TOLS[dtype]
    err, ok = 0.0, True
    for o, r in zip(outs, refs):
        o, r = o.float(), r.float()
        diff = (o - r).abs()
        err = max(err, diff.max().item())
        ok &= bool(torch.isfinite(o).all().item())
        ok &= bool((diff <= atol * r.abs().max() + rtol * r.abs()).all()
                   .item())
    return err, ok


def phase_kernel_bwd():
    from vitpose_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False     # true f32 reference
    gen = torch.Generator(device='cuda').manual_seed(1)
    records = []
    for shape, dtype, role in BWD_CASES:
        n, t, h, d = shape
        qkv = torch.randn(n, t, 3, h, d, generator=gen, device='cuda',
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv.unbind(2)
        g = torch.randn(n, t, h, d, generator=gen, device='cuda',
                        dtype=torch.float32).to(dtype)
        refs = attn.reference_attention_bwd(q, k, v, g)
        atol, rtol = BWD_TOLS[dtype]
        planned, designs = designs_of(shape, dtype, True)
        errs = {}
        for design in designs:
            before = attn.fused_attention_bwd.design_launches[design]
            outs = attn.fused_attention_bwd(q, k, v, g, _design=design)
            torch.cuda.synchronize()
            check(attn.fused_attention_bwd.design_launches[design]
                  == before + 1, f'K2 {design} did not count its launch')
            errs[design], ok = bwd_error(outs, refs, dtype)
            check(ok, f'K2 {design} disagrees with plain at {shape} {dtype}: '
                  f'max abs err {errs[design]}')
            del outs
        ms, turns = time_designs(
            lambda dsg: attn.fused_attention_bwd(q, k, v, g, _design=dsg),
            designs)
        dev, _ = time_designs(
            lambda dsg: attn.fused_attention_bwd(q, k, v, g, _design=dsg),
            designs, device_ms)
        plain_ms = time_ms(lambda: attn.reference_attention_bwd(q, k, v, g))
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        gt = g.transpose(1, 2)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(o, (qt, kt, vt), gt)

        lib_ms = (time_ms(sdpa_fwd_bwd) - time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt)))
        bound_ms, bound_by = attention_bwd_bound(shape, dtype)
        dt = str(dtype).replace('torch.', '')
        print(f'kernel-bwd attention_bwd {shape} {dt} ({role}): max_abs_err '
              + ', '.join(f'{dsg} {e:.3e}' for dsg, e in errs.items())
              + f' (tol {atol:g} max|ref| + {rtol:g}|ref|), '
              f'{design_note(planned, ms, turns, dev)}, plain_ms {plain_ms:.4f}, '
              f'library_ms {lib_ms:.4f} (sdpa bwd = fwd+bwd - fwd), '
              f'bound_ms {bound_ms:.4f} ({bound_by})', flush=True)
        records.append(dict(shape=shape, dtype=dtype, design=planned,
                            err=errs[planned], ms=ms[planned],
                            old_ms=ms['tiled'] if turns else None,
                            device_ms=dev,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
        del qkv, q, k, v, g, refs, qt, kt, vt, gt

    # K3 at the training shape: gradients through `attention` on CUDA are
    # K2's, and the plain backward's within BWD_TOLS
    n, t, h, d = TRAIN_BATCH, 192, 12, 64
    qkv = torch.randn(n, t, 3, h, d, generator=gen, device='cuda').to(
        torch.bfloat16).requires_grad_()
    g = torch.randn(n, t, h, d, generator=gen, device='cuda').to(
        torch.bfloat16)
    f0, b0 = attn.fused_attention.launches, attn.fused_attention_bwd.launches
    attn.attention(*qkv.unbind(2)).backward(g)
    torch.cuda.synchronize()
    check((attn.fused_attention.launches - f0,
           attn.fused_attention_bwd.launches - b0) == (1, 1),
          'K3 did not launch K1 and K2 once each')
    refs = attn.reference_attention_bwd(*qkv.detach().unbind(2), g)
    err, ok = bwd_error(qkv.grad.unbind(2), refs, torch.bfloat16)
    check(ok, f'K3 gradients differ from the plain backward by {err}')
    with torch.no_grad():
        attn.attention(*qkv.unbind(2))
    check(attn.fused_attention_bwd.launches - b0 == 1,
          'K3 launched K2 under no_grad')
    print(f'kernel-bwd: attention_bwd built, launched and matched its plain '
          f'version at {len(records)} shapes; K3 on CUDA at {(n, t, h, d)} '
          f'bf16 (1 K1 + 1 K2 launch) gives the plain backward within '
          f'{err:.3e}', flush=True)
    return records[0]


# COCO template of a standing person, (x, y) as fractions of its box
TEMPLATE = np.array([
    [.50, .08], [.55, .06], [.45, .06], [.60, .08], [.40, .08],
    [.70, .22], [.30, .22], [.78, .38], [.22, .38], [.80, .52], [.20, .52],
    [.62, .55], [.38, .55], [.63, .75], [.37, .75], [.64, .95], [.36, .95]],
    np.float32)


def synthetic_records(seed, n):
    """`n` dim random CANVAS x CANVAS images, each with one person: 17
    jittered COCO joints painted as bright 9x9 squares (a colour per joint),
    some of them invisible and unpainted, and the record a top-down loader
    gives for it (joints_3d, joints_3d_visible, center, scale)."""
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 40, (n, CANVAS, CANVAS, 3)).astype(np.uint8)
    colours = rng.randint(120, 256, (17, 3))
    records = []
    for i in range(n):
        bh = rng.uniform(200, 480)
        bw = bh * rng.uniform(0.4, 0.6)
        x0 = rng.uniform(10, CANVAS - 10 - bw)
        y0 = rng.uniform(10, CANVAS - 10 - bh)
        joints = TEMPLATE * [bw, bh] + [x0, y0] \
            + rng.normal(0, 0.03 * bh, (17, 2))
        joints = np.clip(joints, 5, CANVAS - 6).astype(np.float32)
        vis = (rng.rand(17) > 0.15).astype(np.float32)
        for (x, y), c, v in zip(joints.astype(int), colours, vis):
            if v:
                imgs[i, y - 4:y + 5, x - 4:x + 5] = c
        c, s = bbox_xywh2cs(np.array([x0, y0, bw, bh], np.float32),
                            192 / 256)
        records.append({
            'joints_3d': np.concatenate([joints, np.zeros((17, 1),
                                                          np.float32)], 1),
            'joints_3d_visible': np.repeat(vis[:, None], 3, 1),
            'center': c.numpy(), 'scale': s.numpy()})
    return imgs, records


def train_inputs(seed, n, info, device):
    """Canvases and host augmentation draws (COCO's AugmentConfig: flip,
    half-body, scale, rotation) of `n` synthetic records, on `device`."""
    from vitpose_tpu_torch.data.pipeline import (AugmentConfig,
                                                 sample_augmentations)
    imgs, records = synthetic_records(seed, n)
    rng = np.random.RandomState(seed)
    aug = AugmentConfig()
    draws = [sample_augmentations(rng, r, info, CANVAS, aug, (192, 256))
             for r in records]
    cols = [torch.from_numpy(np.stack(x)).to(device) for x in zip(*draws)]
    return [torch.from_numpy(imgs).to(device)] + cols


def train_setup(cfg, device):
    """(train state, step, preprocess, inputs) of ViTPose-B on `device`
    with the COCO-B optimizer; weights from init_pose_model's seed."""
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    from vitpose_tpu_torch.train import (OptimConfig, create_train_state,
                                         layer_decay_adamw, make_train_step)
    pm = init_pose_model(cfg, device=device)
    ocfg = OptimConfig()
    state = create_train_state(
        pm.model, layer_decay_adamw(pm.model, ocfg, STEPS_PER_EPOCH),
        ocfg.grad_clip_norm)
    preprocess = make_preprocess_fn((192, 256), (48, 64), use_udp=True,
                                    sigma=2.0)
    return state, make_train_step(pm.model), preprocess, pm.dataset_info


def snapshot(model):
    """Every parameter and BN running statistic, cloned."""
    out = {n: p.detach().clone() for n, p in model.named_parameters()}
    out.update({n: b.clone() for n, b in model.named_buffers()
                if 'running' in n})
    return out


def phase_train():
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    state, step, preprocess, info = train_setup(SERVE_CFG, 'cuda')
    model = state.model
    check(model.cfg.backbone.drop_path_rate == 0.3, 'drop_path is not 0.3')
    inputs = train_inputs(0, TRAIN_BATCH, info, 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = snapshot(model)
    t0 = time.perf_counter()
    m = step(state, preprocess(*inputs), gen)                 # warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    reset_counts()
    audit = DeviceAudit()
    with audit:
        m = step(state, preprocess(*inputs), gen)
    torch.cuda.synchronize()
    launches = (fused_attention.launches, fused_attention_bwd.launches)
    check(launches == (12, 12), f'one step launched K1, K2 {launches} '
          'times, expected 12 blocks each')
    designs = (fused_attention.design_launches,
               fused_attention_bwd.design_launches)
    check(designs == ({'pair': 12, 'tiled': 0},) * 2, f'K1, K2 designs in '
          f'one step: {designs}, expected the whole pair every time')
    check(not audit.off_device, f'off-card tensors in the train step: '
          f'{sorted(audit.off_device)[:5]}')
    grads = [p.grad for p in model.parameters()]
    check(all(g is not None and torch.isfinite(g).all().item()
              for g in grads), 'a gradient is missing or not finite')

    reset_counts()
    times = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, preprocess(*inputs), gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        vals = {k: v.item() for k, v in m.items()}
        check(all(np.isfinite(x) for x in vals.values()),
              f'non-finite metrics {vals}')
        check(0.0 <= vals['acc_pose'] <= 1.0, f'acc_pose {vals}')
    check((fused_attention.launches, fused_attention_bwd.launches)
          == (12 * TIMED_STEPS, 12 * TIMED_STEPS),
          'timed steps did not launch K1 and K2 12 times each')
    med = statistics.median(times)
    print(f'train: step times {", ".join(f"{t * 1e3:.1f}" for t in times)} '
          f'ms', flush=True)
    busy_ms = profile_steps(lambda: step(state, preprocess(*inputs), gen),
                            med)
    after = snapshot(model)
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    check(not unchanged, f'unchanged after {state.step} steps: '
          f'{unchanged[:5]}')
    print(f'train: ViTPose-B 256x192 bf16, drop_path 0.3, batch '
          f'{TRAIN_BATCH}: {launches[0]} K1 + {launches[1]} K2 launches per '
          f'step (all whole-pair), {audit.ops} ops all on CUDA, gradients finite, every '
          f'parameter and BN statistic changed; last timed step: '
          f'heatmap_loss {vals["heatmap_loss"]:.6f}, grad_norm '
          f'{vals["grad_norm"]:.6f}, acc_pose {vals["acc_pose"]:.4f}; '
          f'first step {first_s:.2f} s', flush=True)
    return launches, med, TRAIN_BATCH / med, busy_ms


def profile_steps(run_step, step_s, steps=2, label='train'):
    """Device time of `steps` profiled steps by torch.profiler: CUDA kernel
    time per step, the idle share against the unprofiled median step time
    `step_s` (unclamped), and the kernels that take the most time. Fails if
    the kernel time exceeds the profiled steps' own wall time, which only a
    miscount (a kernel summed twice) can give. Returns the kernel ms per
    step, or None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device events, less the ranges that annotate the device timeline
    # (Optimizer.step#...), which would count their kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False)
               and not e.key.startswith('Optimizer.')]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3 / steps
    if busy_ms == 0:
        print(f'{label}: device time not measured (the profiler saw no '
              'CUDA kernels)', flush=True)
        return None
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    check(busy_ms <= wall_ms, f'profiler kernel time {busy_ms:.3f} ms per '
          f'step exceeds the profiled steps\' wall time {wall_ms:.3f} ms: '
          'kernels counted twice')
    print(f'{label}: profiler, {steps} steps: kernels busy {busy_ms:.1f} ms '
          f'per step of the {step_s * 1e3:.1f} ms median step, idle share '
          f'{1 - busy_ms / (step_s * 1e3):.3f} (profiled steps: '
          f'{wall_ms:.1f} ms each); top kernels (ms '
          f'per step, launches per step): ' + '; '.join(
              f'{e.key[:70]} {e.device_time_total / 1e3 / steps:.2f} '
              f'{e.count // steps}' for e in top), flush=True)
    return busy_ms


def train_run(cfg, device, batch):
    """Two steps on `batch`: (metrics of step 1, gradients of step 1 after
    the clip, the 2-step change of every parameter and BN statistic), all
    on the CPU in f32."""
    state, step, _, _ = train_setup(cfg, device)
    batch = {k: v.to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    before = snapshot(state.model)
    m = step(state, batch, gen)
    metrics = {k: v.item() for k, v in m.items()}
    grads = {n: p.grad.float().cpu()
             for n, p in state.model.named_parameters()}
    step(state, batch, gen)
    after = snapshot(state.model)
    delta = {n: (after[n] - before[n]).float().cpu() for n in after}
    return metrics, grads, delta


def ref_distances(run, ref):
    """Distances of a train_run from the reference run: relative |loss| and
    |grad_norm|; for the gradients and the 2-step change of the BN
    statistics the max over tensors of max|x - ref| / max|ref|; for the
    2-step change of the parameters the max over tensors of the RMS of
    x - ref over the RMS of ref. Also returns that RMS ratio per parameter
    tensor."""
    (m, g, d), (mr, gr, dr) = run, ref
    rel = {k: abs(m[k] - mr[k]) / abs(mr[k])
           for k in ('heatmap_loss', 'grad_norm')}
    rel['grads'] = max(((g[n] - gr[n]).abs().max() / gr[n].abs().max())
                       .item() for n in gr)
    params = {n: ((d[n] - dr[n]).norm() / dr[n].norm()).item() for n in gr}
    rel['params'] = max(params.values())
    rel['bn_stats'] = max(((d[n] - dr[n]).abs().max() / dr[n].abs().max())
                          .item() for n in dr if n not in gr)
    return rel, params


def worst(dist, k=3):
    return ', '.join(f'{n} {v:.3e}' for n, v in
                     sorted(dist.items(), key=lambda x: -x[1])[:k])


# train-ref f32, CUDA against the CPU, in the units of ref_distances:
# summation order through 12 blocks and a BN over 2 crops. Measured 0 /
# 1.5e-4 / 1.5e-4 / 1.5e-3 / 3.3e-7; the largest parameter distances are in
# the first blocks' attn.proj and mlp.fc2 weights, where the step-2 update
# m_hat / sqrt(v_hat) turns the gradients' 1.5e-4 into about ten times that
TRAIN_REF_TOL = {'heatmap_loss': 1e-4, 'grad_norm': 1e-3, 'grads': 1e-3,
                 'params': 3e-3, 'bn_stats': 1e-5}


def phase_train_ref():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vitpose_tpu_torch.data.dataset_info import DatasetInfo
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    inputs = train_inputs(1, 2, DatasetInfo.load('coco'), 'cpu')
    batch = make_preprocess_fn((192, 256), (48, 64))(*inputs)
    runs = {}
    for dtype in ('float32', 'bfloat16'):
        cfg = {'variant': 'b', 'dtype': dtype, 'backbone_overrides': {
            'fused_attention': True, 'drop_path_rate': 0.0}}
        for dev in ('cuda', 'cpu'):
            runs[dev, dtype] = train_run(cfg, dev, batch)
    ref = runs['cpu', 'float32']
    f32, f32_params = ref_distances(runs['cuda', 'float32'], ref)
    print('train-ref: f32 (TF32 off) CUDA+K1+K2 vs CPU plain, ViT-B full '
          'depth, batch 2, drop_path 0: ' + ', '.join(
              f'{k} {v:.3e} (tol {TRAIN_REF_TOL[k]:g})'
              for k, v in f32.items()) + '; loss '
          f'{ref[0]["heatmap_loss"]:.6f}, grad_norm '
          f'{ref[0]["grad_norm"]:.6f}; largest per-tensor parameter '
          f'distances: {worst(f32_params)}', flush=True)
    for k, tol in TRAIN_REF_TOL.items():
        check(f32[k] <= tol, f'train-ref f32: {k} differs by {f32[k]} '
              f'(tol {tol})')
    gpu, gpu_params = ref_distances(runs['cuda', 'bfloat16'], ref)
    cpu, cpu_params = ref_distances(runs['cpu', 'bfloat16'], ref)
    print('train-ref: bf16 against the f32 CPU answer, CUDA+K1+K2 / CPU '
          'plain: ' + ', '.join(f'{k} {gpu[k]:.3e} / {cpu[k]:.3e}'
                                for k in gpu)
          + f' (CUDA at most {BF16_FACTOR}x CPU, + 2^-8 for the scalars); '
          f'largest per-tensor parameter distances, CUDA: '
          f'{worst(gpu_params)}; CPU: {worst(cpu_params)}', flush=True)
    for k in gpu:
        # one bf16 step of a scalar as a floor for loss and grad_norm
        floor = 2.0 ** -8 if k in ('heatmap_loss', 'grad_norm') else 0.0
        check(gpu[k] <= BF16_FACTOR * cpu[k] + floor,
              f'train-ref bf16: CUDA {k} is {gpu[k]} from the f32 answer, '
              f'the bf16 CPU path {cpu[k]}')


# train-loop: the training CLI on the COCO-B config. The train set: 292
# 480x640 and 8 960x1280 images of 4 boxes, 1050 GT persons, so 16 steps of
# 64 per epoch (drop_last); the val set: 60 + 4 images, 256 detection
# boxes, 4 batches of 64. The run starts from the shaped weights
# (`load_from`), so that AP is not 0 on the synthetic GT.
LOOP_TRAIN_IMAGES = (292, 8)
LOOP_VAL_IMAGES = (60, 4)
LOOP_EPOCHS = 2


def loop_options(root, files, ckpt):
    return [f'data.train.ann_file={files["train"]["ann"]}',
            f'data.train.img_prefix={root}/train/',
            f'data.val.ann_file={files["val"]["ann"]}',
            f'data.val.img_prefix={root}/val/',
            f'data.val.bbox_file={files["val"]["det"]}',
            f'load_from={ckpt}', f'optimizer.total_epochs={LOOP_EPOCHS}',
            'runtime.eval_interval=1', 'runtime.ckpt_interval=1',
            'runtime.log_interval=1']


def run_train_cli(args):
    """The training CLI in this process, its printed records kept out of
    the smoke's output; returns (final state, the log records)."""
    import contextlib
    import io
    import os
    from vitpose_tpu_torch.tools import train as train_cli
    work_dir = args[args.index('--work-dir') + 1]
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(args)
    with open(os.path.join(work_dir, 'train.log.json')) as f:
        return state, [json.loads(line) for line in f]


def step_times(records):
    """Wall seconds of each logged step but an epoch's first: the runner
    logs (and so reads the metrics back) after every step here."""
    out = []
    for a, b in zip(records, records[1:]):
        if a['mode'] == b['mode'] == 'train' and a['epoch'] == b['epoch']:
            out.append(b['time'] - a['time'])
    return out


def check_launches(what, steps, val_batches):
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    want = (12 * steps + 24 * val_batches, 12 * steps)
    got = (fused_attention.launches, fused_attention_bwd.launches)
    check(got == want, f'{what}: K1, K2 launched {got} times, expected '
          f'{want} (12 + 12 per step of {steps}, 24 K1 per val batch of '
          f'{val_batches})')
    designs = (fused_attention.design_launches,
               fused_attention_bwd.design_launches)
    check(designs == ({'pair': want[0], 'tiled': 0},
                      {'pair': want[1], 'tiled': 0}),
          f'{what}: K1, K2 designs {designs}, expected the whole pair')
    return got


def phase_train_loop(card, busy_ms):
    """The training CLI on the COCO-B config, 2 epochs with an evaluation
    and a checkpoint after each; then train-resume on its work dir."""
    import os
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        files = {}
        for name, (small, big), seed in (('train', LOOP_TRAIN_IMAGES, 1),
                                         ('val', LOOP_VAL_IMAGES, 2)):
            os.makedirs(os.path.join(root, name))
            files[name] = write_eval_set(os.path.join(root, name), seed,
                                         small, big)[0]
        pm = init_pose_model(COCO_B, device='cuda')
        shape_peaks(pm.model)
        ckpt = os.path.join(root, 'vitpose_b_peaks.pth')
        torch.save(pm.model.state_dict(), ckpt)
        del pm
        print(f'train-loop: wrote the synthetic train and val sets and the '
              f'shaped weights in {time.perf_counter() - t0:.1f} s',
              flush=True)
        work_dir = os.path.join(root, 'work')
        options = loop_options(root, files, ckpt)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, log = run_train_cli([COCO_B, '--work-dir', work_dir,
                                    '--cfg-options', *options])
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        train = [r for r in log if r['mode'] == 'train']
        epochs = [r for r in log if r['mode'] == 'epoch']
        steps = len(train)
        per_epoch = steps // LOOP_EPOCHS
        check(state.step == steps == LOOP_EPOCHS * per_epoch == 32,
              f'{steps} logged steps, state at step {state.step}, expected '
              f'{LOOP_EPOCHS} epochs of 16')
        check(all(np.isfinite(r[k]) for r in train
                  for k in ('heatmap_loss', 'grad_norm', 'acc_pose')),
              'a non-finite training metric')
        val_batches = -(-(LOOP_VAL_IMAGES[0] + LOOP_VAL_IMAGES[1]) * 4
                        // EVAL_BATCH)
        launches = check_launches('train-loop', steps,
                                  val_batches * LOOP_EPOCHS)
        ckpts = os.path.join(work_dir, 'ckpts')
        check(os.path.exists(os.path.join(ckpts, 'best.pth')),
              'no best.pth in the work dir')
        check(len(epochs) == LOOP_EPOCHS and all(
            0 <= r['AP'] <= 1 for r in epochs), f'epoch records {epochs}')
        times = step_times(log)
        med = statistics.median(times)
        last = train[-1]
        share = last['data_time'] / last['time']
        idle = ('not measured' if busy_ms is None
                else f'{1 - busy_ms / (med * 1e3):.3f}')
        ckpt_bytes = os.path.getsize(os.path.join(ckpts, 'epoch_0.pth'))
        print(f'train-loop: CLI (vitpose_tpu_torch.tools.train) on the COCO-B '
              f'config, batch {TRAIN_BATCH}, {LOOP_EPOCHS} epochs of '
              f'{per_epoch} steps ({steps} steps) from the shaped weights '
              f'(load_from), logging every step: {launches[0]} K1 + '
              f'{launches[1]} K2 launches (12 + 12 per step, 24 K1 per val '
              f'batch x {val_batches} x {LOOP_EPOCHS}, all whole-pair); '
              f'step wall time median {med * 1e3:.1f} ms '
              f'({min(times) * 1e3:.1f}-{max(times) * 1e3:.1f}) = '
              f'{TRAIN_BATCH / med:.1f} img/s; data_time share of epoch 1 '
              f'{share:.3f} ({last["data_time"]:.2f} of {last["time"]:.2f} '
              f's); card idle share {idle} (the train phase\'s kernel time '
              f'per step over this median); AP per epoch ' + ', '.join(
                  f'{r["AP"]:.4f}' for r in epochs) + f'; epoch times '
              + ', '.join(f'{r["epoch_time"]:.2f} s' for r in epochs)
              + f'; last heatmap_loss {last["heatmap_loss"]:.6f}; '
              f'checkpoint {ckpt_bytes / 1e9:.3f} GB per epoch; whole run '
              f'{run_s:.1f} s; peak device memory {peak_gb:.2f} GB; on '
              f'{card}', flush=True)
        del state
        torch.cuda.empty_cache()
        phase_train_resume(root, work_dir, options, log, card)
    return launches, steps, val_batches * LOOP_EPOCHS


def phase_train_resume(root, work_dir, options, log, card):
    """Restore the epoch-0 checkpoint into a fresh runner state bit for bit;
    redo epoch 1 with --resume in a copy of the work dir and hold it to the
    uninterrupted epoch exactly (the step is deterministic on the card);
    score best.pth with the evaluation CLI."""
    import contextlib
    import io
    import os
    import shutil
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.train.loop import build_train_state
    from vitpose_tpu_torch.utils.checkpoint import CheckpointManager
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    ckpts = os.path.join(work_dir, 'ckpts')
    saved = torch.load(os.path.join(ckpts, 'epoch_0.pth'),
                       map_location='cpu', weights_only=True)
    cfg = apply_options(load_config(COCO_B), options)
    per_epoch = saved['step']
    state = build_train_state(cfg, per_epoch, 'cuda')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, epoch = CheckpointManager(ckpts).restore(state, 0)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(epoch == 0 and state.step == saved['step'], 'restored step')
    for k, v in state.model.state_dict().items():
        check(v.is_cuda and torch.equal(v.cpu(), saved['model'][k]),
              f'restored {k} differs from the saved one')
    opt = state.optimizer.state_dict()
    check(opt['param_groups'] == saved['optimizer']['param_groups'],
          'restored optimizer groups (lr, decay) differ')
    n_moments = 0
    for i, st in opt['state'].items():
        for k, v in st.items():
            check(v.is_cuda and torch.equal(v.cpu(),
                                            saved['optimizer']['state'][i][k]),
                  f'restored AdamW {k} of parameter {i} differs or is off '
                  'the card')
            n_moments += 1
    check(state.scheduler.state_dict() == saved['scheduler'],
          'restored schedule differs')
    resave = os.path.join(root, 'resave')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(resave).save(0, state)
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(os.path.join(resave, 'epoch_0.pth'))
    del state
    torch.cuda.empty_cache()
    print(f'train-resume: the epoch-0 checkpoint restored into a fresh '
          f'runner state bit for bit (parameters, BN statistics, '
          f'{n_moments} AdamW tensors on the card, groups and lr, schedule, '
          f'step {saved["step"]}) in {restore_s:.2f} s; saving it took '
          f'{save_s:.2f} s for {nbytes / 1e9:.3f} GB', flush=True)

    copy = os.path.join(root, 'resumed')
    shutil.copytree(work_dir, copy)
    os.remove(os.path.join(copy, 'ckpts', 'epoch_1.pth'))
    os.remove(os.path.join(copy, 'ckpts', 'info_1.json'))
    reset_counts()
    t0 = time.perf_counter()
    _, relog = run_train_cli([COCO_B, '--work-dir', copy, '--resume',
                              '--cfg-options', *options])
    resume_s = time.perf_counter() - t0
    new = relog[len(log):]
    check(new[0] == {'mode': 'resume', 'epoch': 1}, f'resume record {new[0]}')
    got = [(r['step'], r['heatmap_loss']) for r in new
           if r['mode'] == 'train']
    want = [(r['step'], r['heatmap_loss']) for r in log
            if r['mode'] == 'train' and r['epoch'] == 1]
    val_batches = -(-(LOOP_VAL_IMAGES[0] + LOOP_VAL_IMAGES[1]) * 4
                    // EVAL_BATCH)
    check_launches('train-resume', len(got), val_batches)
    check(got == want, f'resumed epoch 1 losses {got[:3]}... differ from '
          f'the uninterrupted {want[:3]}...')
    a = torch.load(os.path.join(copy, 'ckpts', 'epoch_1.pth'),
                   map_location='cpu', weights_only=True)
    b = torch.load(os.path.join(work_dir, 'ckpts', 'epoch_1.pth'),
                   map_location='cpu', weights_only=True)
    differ = [k for k in b['model'] if not torch.equal(a['model'][k],
                                                       b['model'][k])]
    check(not differ, f'final weights differ from the uninterrupted run: '
          f'{differ[:5]}')
    ap_resumed = [r['AP'] for r in new if r['mode'] == 'epoch']
    ap_ref = [r['AP'] for r in log if r['mode'] == 'epoch'][1:]
    check(ap_resumed == ap_ref, f'resumed AP {ap_resumed} vs {ap_ref}')

    with open(os.path.join(work_dir, 'ckpts', 'meta.json')) as f:
        meta = json.load(f)
    best = os.path.join(work_dir, 'ckpts', 'best.pth')
    init_pose_model(COCO_B, checkpoint=best, device='cuda')
    val = [o for o in options if o.startswith('data.val.')]
    with contextlib.redirect_stdout(io.StringIO()):
        stats = test_cli.main([COCO_B, best, '--cfg-options', *val])
    check(stats['AP'] == meta['best_value'], f'the evaluation CLI scores '
          f'best.pth {stats["AP"]}, the runner logged {meta["best_value"]}')
    print(f'train-resume: epoch 1 redone with --resume (epoch-1 checkpoint '
          f'removed in a copy of the work dir) in {resume_s:.1f} s: '
          f'{len(got)} steps with the uninterrupted heatmap_loss exactly, '
          f'final weights and AP equal bit for bit (bound: exact; the step '
          f'is deterministic on the card); best.pth (epoch '
          f'{meta["best_epoch"]}) loads through init_pose_model and the '
          f'evaluation CLI scores it AP {stats["AP"]:.6f}, the AP the '
          f'runner logged; on {card}', flush=True)


REMAT_POLICIES = ('none', 'full', 'attn', 'dots')
REMAT_K1 = {'none': 12, 'full': 24, 'attn': 12, 'dots': 24}
REMAT_STEPS = 3                      # timed steps per turn, two turns each
# remat against no remat, in the units of ref_distances' 'grads': one bf16
# rounding step (2^-8 of a value). A recompute runs the same kernels on the
# same inputs: every policy read 0 on an H100 80GB HBM3 at 700 W.
REMAT_GRAD_TOL = 2.0 ** -8


def phase_remat(card):
    """ViTPose-B bf16 train steps at batch 64 in each remat policy, each
    from the same weights, batch and DropPath seed: K1 and K2 launches and
    gradients of the first step against no remat; the second step's peak
    memory above the resident weights and optimizer state; step times in
    turns (none, full, attn, dots, then back), all four states resident."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    batch, runs, grads, launches, extra = None, {}, {}, {}, {}
    gen = torch.Generator(device='cuda')
    for policy in REMAT_POLICIES:
        cfg = dict(SERVE_CFG)
        if policy != 'none':
            cfg.update(remat=True, remat_policy=policy)
        state, step, preprocess, info = train_setup(cfg, 'cuda')
        if batch is None:
            batch = preprocess(*train_inputs(0, TRAIN_BATCH, info, 'cuda'))
        reset_counts()
        step(state, batch, gen.manual_seed(0))
        torch.cuda.synchronize()
        launches[policy] = (fused_attention.launches,
                            fused_attention_bwd.launches)
        check(launches[policy] == (REMAT_K1[policy], 12), f'remat {policy}: '
              f'K1, K2 launched {launches[policy]} times in one step, '
              f'expected ({REMAT_K1[policy]}, 12)')
        grads[policy] = {n: p.grad.float().clone()
                         for n, p in state.model.named_parameters()}
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(state, batch, gen.manual_seed(1))
        torch.cuda.synchronize()
        extra[policy] = (torch.cuda.max_memory_allocated() - resident) / 1e9
        runs[policy] = (state, step)
    ref = grads['none']
    dist = {p: max(((grads[p][n] - ref[n]).abs().max()
                    / ref[n].abs().max()).item() for n in ref)
            for p in REMAT_POLICIES[1:]}
    del grads
    times = {p: [] for p in REMAT_POLICIES}
    for policy in REMAT_POLICIES + REMAT_POLICIES[::-1]:
        state, step = runs[policy]
        for i in range(REMAT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch, gen.manual_seed(i + 2))
            torch.cuda.synchronize()
            times[policy].append(time.perf_counter() - t0)
    del runs
    torch.cuda.empty_cache()
    med = {p: statistics.median(t) for p, t in times.items()}
    print('remat: ViTPose-B 256x192 bf16, batch 64, drop_path 0.3, the same '
          'weights, batch and DropPath seeds: ' + '; '.join(
              f'{p}: K1 {launches[p][0]} + K2 {launches[p][1]}, step '
              f'{med[p] * 1e3:.1f} ms (median of {len(times[p])} in two '
              f'turns, {min(times[p]) * 1e3:.1f}-'
              f'{max(times[p]) * 1e3:.1f}), peak {extra[p]:.2f} GB above '
              f'the resident state' + ('' if p == 'none' else
                                       f', grads {dist[p]:.3e} from no remat')
              for p in REMAT_POLICIES) + f' (tol {REMAT_GRAD_TOL:.3e}); on '
          f'{card}', flush=True)
    for p, d in dist.items():
        check(d <= REMAT_GRAD_TOL, f'remat {p}: gradients {d} from no remat')
    return {p: launches[p][0] for p in REMAT_POLICIES}


# moe-train: ViTPose+-B on six seeded synthetic train sets, each in its own
# dataset's format, sharing one folder of 480x640 JPEGs with four persons
# each (COCO and COCO-WholeBody share COCO's images in the real config too):
# 80 images, so 320 persons per set and 2 batches of 128 (the loader drops
# the ragged rest), 12 steps per epoch (the real mixture has some 9,000).
# The val set is COCO-format, 512 detection boxes: 4 batches of 128.
PLUS_B = 'vitpose_tpu/configs/coco/vitpose_plus_b_6datasets_256x192.py'
MOE_BATCH = 128                      # the ViTPose+-B config's batch size
MOE_SETS = (('coco', 17), ('aic', 14), ('mpii', 16), ('ap10k', 17),
            ('ap10k', 17), ('coco_wholebody', 17))       # the config's order
MOE_PARTS = (('foot_kpts', 6), ('face_kpts', 68), ('lefthand_kpts', 21),
             ('righthand_kpts', 21))
MOE_IMAGES = 80
MOE_VAL_IMAGES = (124, 4)
MOE_AP_TOL = 0.002                   # split checkpoint vs the runner's AP
MOE_FEATURE_TOL = 2.0 ** -8          # one bf16 step of the largest output


def moe_joints(rng, box, k):
    """`k` joints spread over a person box, about 85% of them visible."""
    x, y, w, h = box
    xy = np.stack([rng.uniform(x + 0.1 * w, x + 0.9 * w, k),
                   rng.uniform(y + 0.05 * h, y + 0.95 * h, k)], 1)
    v = np.where(rng.rand(k) < 0.85, 2, 0)
    return np.concatenate([xy, v[:, None]], 1)


def write_moe_sets(root, seed):
    """The six train sets of the ViTPose+ config in `root`: COCO-format
    jsons for COCO, AIC, AP-10K and APT-36K, COCO-WholeBody's with its
    foot, face and hand fields, and MPII's list json (1-based center,
    scale, joints, joints_vis). Returns the config's `data.train` list."""
    import os
    import cv2
    rng = np.random.RandomState(seed)
    images, boxes = [], []
    for i in range(MOE_IMAGES):
        b = grid_boxes(rng, 2, 2)
        b[:, 0] += rng.uniform(0, 300)
        name = f'{i + 1:012d}.jpg'
        cv2.imwrite(os.path.join(root, name),
                    eval_scene(rng, b, 1)[..., ::-1])
        images.append(dict(id=i + 1, file_name=name, width=640, height=480))
        boxes += [(i + 1, name, [float(v) for v in box[:4]]) for box in b]
    train = []
    for idx, (name, k) in enumerate(MOE_SETS):
        ann = os.path.join(root, f'train_{idx}.json')
        if name == 'mpii':
            recs = []
            for _, file, (x, y, w, h) in boxes:
                kp = moe_joints(rng, (x, y, w, h), k)
                recs.append(dict(image=file, joints=(kp[:, :2] + 1).tolist(),
                                 joints_vis=(kp[:, 2] > 0).astype(int)
                                 .tolist(),
                                 center=[x + w / 2 + 1, y + h / 2 + 1],
                                 scale=h / 200.0))
            data = recs
        else:
            anns = []
            for image_id, _, box in boxes:
                kp = moe_joints(rng, box, k)
                a = dict(id=len(anns) + 1, image_id=image_id, category_id=1,
                         bbox=box, area=box[2] * box[3], iscrowd=0,
                         num_keypoints=int((kp[:, 2] > 0).sum()),
                         keypoints=kp.ravel().tolist())
                if name == 'coco_wholebody':
                    for field, n in MOE_PARTS:
                        a[field] = moe_joints(rng, box, n).ravel().tolist()
                anns.append(a)
            data = dict(images=images, annotations=anns,
                        categories=[dict(id=1, name='person')])
        with open(ann, 'w') as f:
            json.dump(data, f)
        train.append(dict(dataset=name, dataset_idx=idx, ann_file=ann,
                          img_prefix=f'{root}/'))
    return train


def moe_step_profile(cfg, step_s, card):
    """The kernel time of a ViTPose+-B step: a runner's train state for
    `cfg` on the card, one COCO and one WholeBody batch of the synthetic
    sets through the MoE step, then two steps under torch.profiler."""
    from vitpose_tpu_torch.eval.loop import PinnedStaging
    from vitpose_tpu_torch.train.loop import (_batch_to_device, _train_data,
                                              build_train_state)
    from vitpose_tpu_torch.train.step import make_moe_train_step
    loader, preprocess, n = _train_data(cfg, 0)
    state = build_train_state(cfg, len(loader), 'cuda')
    step = make_moe_train_step(state.model, n)
    batches, staging = [], PinnedStaging()
    for child in (loader.loaders[0], loader.loaders[-1]):
        b = next(iter(child))
        pre = preprocess(*_batch_to_device(b, torch.device('cuda'), staging))
        pre['dataset_idx'] = b['dataset_idx']
        batches.append(pre)
    gen = torch.Generator(device='cuda').manual_seed(0)
    turn = [0]

    def run_step():
        step(state, batches[turn[0] % 2], gen)
        turn[0] += 1
    for _ in range(2):
        run_step()
    busy_ms = profile_steps(run_step, step_s, label='moe-train')
    del state, batches
    torch.cuda.empty_cache()
    return busy_ms


def phase_moe_train(card):
    """ViTPose+-B multi-dataset MoE training through the training CLI on the
    shipped config, one epoch of 12 steps on six synthetic train sets, with
    `pretrained` the shaped dense ViT-B backbone (so its fc2 is split into
    the experts) and the shaped classic head by `load_from`; then
    model_split of its best.pth and the evaluation CLI on the COCO part
    with the plain COCO-B config."""
    import contextlib
    import io
    import os
    import tempfile
    from vitpose_tpu_torch.api import init_pose_model
    from vitpose_tpu_torch.tools import test as test_cli
    from vitpose_tpu_torch.train.loop import (build_model_from_cfg,
                                              load_pretrained)
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    times = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        os.makedirs(os.path.join(root, 'train'))
        os.makedirs(os.path.join(root, 'val'))
        train = write_moe_sets(os.path.join(root, 'train'), 3)
        val = write_eval_set(os.path.join(root, 'val'), 4,
                             *MOE_VAL_IMAGES)[0]
        val_options = eval_options(os.path.join(root, 'val'), val)
        dense = init_pose_model(COCO_B, device='cuda')
        shape_peaks(dense.model)
        sd = dense.model.state_dict()
        pretrained = os.path.join(root, 'vitpose_b_backbone.pth')
        torch.save({'state_dict': {k[len('backbone.'):]: v.cpu()
                                   for k, v in sd.items()
                                   if k.startswith('backbone.')}},
                   pretrained)
        head = os.path.join(root, 'vitpose_b_head.pth')
        torch.save({k: v.cpu() for k, v in sd.items()
                    if k.startswith('keypoint_head.')}, head)
        # the ViTPose+ configs leave the fused attention off, as JAX's do;
        # the COCO-B config turns it on in its file, this run on the
        # command line
        options = [f'data.train={train!r}', *val_options,
                   'model.backbone_overrides.fused_attention=True',
                   f'pretrained={pretrained}', f'load_from={head}',
                   'optimizer.total_epochs=1', 'runtime.eval_interval=1',
                   'runtime.ckpt_interval=1', 'runtime.log_interval=1']
        cfg = apply_options(load_config(PLUS_B), options)
        times['data'] = time.perf_counter() - t0

        # the split `pretrained`: every expert's features are the dense
        # backbone's, before any step
        t0 = time.perf_counter()
        moe = build_model_from_cfg(cfg['model'])
        load_pretrained(moe, pretrained)
        moe = moe.to('cuda').eval()
        bb = moe.cfg.backbone
        check((bb.num_experts, bb.part_dim, bb.embed_dim, bb.depth,
               bb.dtype) == (6, 192, 768, 12, 'bfloat16'),
              f'the ViTPose+-B config built {bb}')
        x = torch.randn(8, 256, 192, 3, device='cuda',
                        generator=torch.Generator('cuda').manual_seed(5))
        with torch.inference_mode():
            want = dense.model.backbone(x).float()
            dist = [((moe.backbone(x, expert_idx=e).float() - want).abs()
                     .max() / want.abs().max()).item()
                    for e in range(bb.num_experts)]
        n_params = sum(p.numel() for p in moe.parameters())
        del moe, dense, sd
        torch.cuda.empty_cache()
        times['features'] = time.perf_counter() - t0
        check(max(dist) <= MOE_FEATURE_TOL, f'moe-train: the split '
              f'experts\' features differ from the dense backbone\'s by '
              f'{dist} of its largest value (tol {MOE_FEATURE_TOL})')
        print(f'moe-train: pretrained (the shaped dense ViT-B backbone) '
              f'split into {bb.num_experts} experts of part_dim '
              f'{bb.part_dim}: every expert\'s bf16 features on the card '
              f'equal the dense backbone\'s within ' + ', '.join(
                  f'{d:.3e}' for d in dist) + f' of its largest value (tol '
              f'{MOE_FEATURE_TOL:.3e}, one bf16 step); {n_params / 1e6:.1f} M '
              f'parameters', flush=True)

        work_dir = os.path.join(root, 'work')
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, log = run_train_cli([PLUS_B, '--work-dir', work_dir,
                                    '--cfg-options', *options])
        times['train'] = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        train_recs = [r for r in log if r['mode'] == 'train']
        (epoch,) = [r for r in log if r['mode'] == 'epoch']
        steps = len(train_recs)
        val_batches = -(-sum(MOE_VAL_IMAGES) * 4 // MOE_BATCH)
        check(state.step == steps == 2 * len(MOE_SETS), f'{steps} logged '
              f'steps, state at step {state.step}, expected 2 per set')
        launches = check_launches('moe-train', steps, val_batches)
        del state
        torch.cuda.empty_cache()
        seen = sorted({r['dataset'] for r in train_recs})
        check(seen == list(range(len(MOE_SETS))), f'datasets in the log '
              f'{seen}')
        losses = [f'loss_{d}' for d in range(len(MOE_SETS))]
        for r in train_recs:
            check(all(np.isfinite(r[k]) for k in
                      losses + ['heatmap_loss', 'grad_norm']),
                  f'a non-finite metric in {r}')
            others = [r[k] for d, k in enumerate(losses) if d != r['dataset']]
            check(others == [0.0] * (len(MOE_SETS) - 1) and
                  r[f"loss_{r['dataset']}"] > 0, f'step {r["step"]} '
                  f'(dataset {r["dataset"]}) has the other heads\' losses '
                  f'{others}')
        ckpts = os.path.join(work_dir, 'ckpts')
        best = os.path.join(ckpts, 'best.pth')
        check(os.path.exists(best), 'no best.pth in the work dir')
        best_sd = torch.load(best, map_location='cpu', weights_only=True)
        mmpose = ('backbone.blocks.11.mlp.experts.5.weight',
                  'associate_keypoint_heads.4.final_layer.weight')
        check(all(k in best_sd for k in mmpose)
              and not any('expert_weight' in k or 'expert_bias' in k
                          for k in best_sd)
              and best_sd[mmpose[1]].shape[0] == 133
              and best_sd[mmpose[0]].shape == (192, 3072),
              'best.pth is not under the mmpose names')
        del best_sd
        step_s = statistics.median(step_times(log))
        first = [r for r in train_recs if r['epoch'] == 0][-1]
        share = first['data_time'] / first['time']
        ckpt_bytes = os.path.getsize(os.path.join(ckpts, 'epoch_0.pth'))
        best_bytes = os.path.getsize(best)
        print(f'moe-train: CLI (vitpose_tpu_torch.tools.train) on the '
              f'ViTPose+-B config (6 experts of part_dim 192, 6 heads of '
              f'17/14/16/17/17/133 channels, bf16, UDP, max_num_joints 133), '
              f'batch {MOE_BATCH}, 1 epoch of {steps} steps over six '
              f'synthetic sets (datasets {[r["dataset"] for r in train_recs]}'
              f'), logging every step: {launches[0]} K1 + {launches[1]} K2 '
              f'launches (12 + 12 per step, 24 K1 per val batch x '
              f'{val_batches}, all whole-pair); every other head\'s loss '
              f'exactly 0 in every step; step wall time median '
              f'{step_s * 1e3:.1f} ms = {MOE_BATCH / step_s:.1f} img/s; '
              f'data_time share {share:.3f} ({first["data_time"]:.2f} of '
              f'{first["time"]:.2f} s); AP {epoch["AP"]:.4f} (expert 0, '
              f'main head); epoch {epoch["epoch_time"]:.2f} s; last '
              f'heatmap_loss {train_recs[-1]["heatmap_loss"]:.6f}; '
              f'checkpoint {ckpt_bytes / 1e9:.3f} GB, best.pth '
              f'{best_bytes / 1e9:.3f} GB; peak device memory '
              f'{peak_gb:.2f} GB; whole run {times["train"]:.1f} s; on '
              f'{card}', flush=True)

        t0 = time.perf_counter()
        split_dir = os.path.join(root, 'split')
        subprocess.run([sys.executable, '-m',
                        'vitpose_tpu_torch.tools.model_split', best,
                        '--out-dir', split_dir], check=True,
                       capture_output=True, timeout=600)
        names = sorted(os.listdir(split_dir))
        check(names == sorted(f'{n}.pth' for n in (
            'coco', 'aic', 'mpii', 'ap10k', 'apt36k', 'wholebody')),
            f'model_split wrote {names}')
        times['split'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            stats = test_cli.main([COCO_B, os.path.join(split_dir,
                                                        'coco.pth'),
                                   '--cfg-options', *val_options])
        times['eval'] = time.perf_counter() - t0
        diff = abs(stats['AP'] - epoch['AP'])
        check(diff <= MOE_AP_TOL, f'moe-train: the split COCO checkpoint '
              f'scores AP {stats["AP"]} with the COCO-B config, the runner '
              f'logged {epoch["AP"]} (tol {MOE_AP_TOL})')
        print(f'moe-train: model_split (python -m '
              f'vitpose_tpu_torch.tools.model_split) wrote {len(names)} '
              f'single-task checkpoints in {times["split"]:.1f} s; coco.pth '
              f'through the evaluation CLI with the plain COCO-B config: AP '
              f'{stats["AP"]:.6f} against the runner\'s {epoch["AP"]:.6f}, '
              f'difference {diff:.6f} (tol {MOE_AP_TOL})', flush=True)
        t0 = time.perf_counter()
        busy_ms = moe_step_profile(cfg, step_s, card)
        times['profile'] = time.perf_counter() - t0
    print('moe-train: kernel time per step '
          + ('not measured' if busy_ms is None else f'{busy_ms:.1f} ms')
          + ' (torch.profiler, two MoE steps alone), card idle share of the '
          'runner\'s median step '
          + ('not measured' if busy_ms is None
             else f'{1 - busy_ms / (step_s * 1e3):.3f}')
          + '; phase times ' + ', '.join(f'{k} {v:.1f} s'
                                         for k, v in times.items())
          + f'; on {card}', flush=True)
    return launches, steps, val_batches


# moe-ref: two ViTPose+ steps at full ViTPose+-B width and depth on 3 crops
# whose datasets mix within each batch, so every block routes rows per
# expert (the runner's batches hold one dataset each and never do). Expert
# 5 is selected in step 1 only (step 2 moves it by its Adam moments and
# decay), experts 1, 3 and 4 never (decay alone), and heads 1, 3 and 4 see
# no sample (loss exactly 0, gradients exactly 0, BN statistics moving).
# The config's optimizer, warmup included, as train-ref's
MOE_REF_ROUTES = (np.array([5, 0, 5]), np.array([2, 2, 0]))
MOE_REF_JOINTS = 133                 # the mixture's max_num_joints
# moe-ref f32, CUDA against the CPU, in the units of moe_ref_distances:
# summation order. Head 0 trains on one sample of the three while its BN
# statistics take all three, so its gradients cancel more than train-ref's
# (batch 2, one head), and the first Adam steps turn them into sign flips of
# the tiny-gradient elements (the LayerNorm weights). Measured on the card
# (heatmap_loss / grad_norm / losses / grads / params / experts / bn_stats):
# CUDA vs CPU 8.8e-8 / 1.6e-4 / 3.0e-7 / 5.1e-3 / 3.0e-2 / 8.8e-3 /
# 1.3e-5; the CPU against itself on one thread instead of eight, which the
# phase prints beside them, 8.8e-8 / 7.7e-6 / 2.4e-7 / 2.4e-3 / 4.0e-2 /
# 5.5e-3 / 9.2e-6. The bounds are about twice the larger of the two
MOE_REF_TOL = {'heatmap_loss': 1e-6, 'grad_norm': 1e-3, 'losses': 1e-6,
               'grads': 1e-2, 'params': 8e-2, 'experts': 2e-2,
               'bn_stats': 3e-5}


def moe_ref_batch():
    """3 crops of the synthetic canvases with MOE_REF_JOINTS random joints
    inside each person box, so that every head's channels carry targets,
    preprocessed on the CPU as the runner does (UDP)."""
    from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
    imgs, records = synthetic_records(6, len(MOE_REF_ROUTES[0]))
    rng = np.random.RandomState(6)
    center = np.stack([r['center'] for r in records])
    scale = np.stack([r['scale'] for r in records])
    half = scale * 200 / 1.25 / 2           # the box, without the padding
    joints = center[:, None] + half[:, None] * rng.uniform(
        -0.9, 0.9, (len(records), MOE_REF_JOINTS, 2))
    vis = (rng.rand(len(records), MOE_REF_JOINTS) > 0.15)
    args = [torch.from_numpy(x) for x in (
        imgs, center, scale, np.zeros(len(records), np.float32),
        joints.astype(np.float32), vis.astype(np.float32))]
    return make_preprocess_fn((192, 256), (48, 64),
                              pad_num_joints=MOE_REF_JOINTS)(*args)


def moe_ref_run(cfg, device, batch):
    """Two make_moe_train_step steps of the runner's train state for `cfg`
    on `device`, step i with dataset_idx MOE_REF_ROUTES[i]: (the metrics of
    each step, the gradients of step 1 after the clip, the 2-step change of
    every parameter and BN statistic), on the CPU in f32."""
    from vitpose_tpu_torch.train.loop import build_train_state
    from vitpose_tpu_torch.train.step import make_moe_train_step
    state = build_train_state(cfg, 1, device)
    step = make_moe_train_step(state.model, len(cfg['data']['train']))
    batch = {k: v.to(device) for k, v in batch.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    before = snapshot(state.model)
    metrics, grads = [], None
    for idx in MOE_REF_ROUTES:
        m = step(state, dict(batch, dataset_idx=idx), gen)
        metrics.append({k: v.item() for k, v in m.items()})
        if grads is None:
            grads = {n: p.grad.float().cpu()
                     for n, p in state.model.named_parameters()}
    after = snapshot(state.model)
    delta = {n: (after[n] - before[n]).float().cpu() for n in after}
    del state
    return metrics, grads, delta


def _rel(x, ref, rms):
    """|x - ref| over |ref|, as the max of each (rms False) or as RMS (rms
    True); 0 where both are 0, inf where only `ref` is."""
    diff, scale = ((x - ref).norm(), ref.norm()) if rms else \
        ((x - ref).abs().max(), ref.abs().max())
    if scale == 0:
        return 0.0 if diff == 0 else float('inf')
    return (diff / scale).item()


def moe_ref_distances(run, ref):
    """Distances of a moe_ref_run from the reference run, as
    ref_distances's: relative heatmap_loss and grad_norm (the larger of the
    two steps) and `losses`, every loss_d of a dataset in its step's batch;
    `grads`, `bn_stats` and `params` as there; `experts` the RMS ratio of
    each expert's rows (weight and bias) of every block. Returns those and
    {'grads', 'params', 'experts', 'bn'}: the distances per tensor (per
    expert)."""
    (ms, g, d), (mrs, gr, dr) = run, ref
    rel = {k: max(abs(m[k] - mr[k]) / abs(mr[k]) for m, mr in zip(ms, mrs))
           for k in ('heatmap_loss', 'grad_norm')}
    rel['losses'] = max(abs(m[f'loss_{e}'] - mr[f'loss_{e}'])
                        / abs(mr[f'loss_{e}'])
                        for m, mr, idx in zip(ms, mrs, MOE_REF_ROUTES)
                        for e in set(idx.tolist()))
    grads = {n: _rel(g[n], gr[n], False) for n in gr}
    rel['grads'] = max(grads.values())
    params = {n: _rel(d[n], dr[n], True) for n in gr}
    rel['params'] = max(params.values())
    experts = {}
    for n in gr:
        if n.endswith('mlp.expert_weight'):
            b = n[:-len('weight')] + 'bias'
            for e in range(dr[n].shape[0]):
                experts[f'{n[:-len("expert_weight")]}experts.{e}'] = _rel(
                    torch.cat([d[n][e].ravel(), d[b][e]]),
                    torch.cat([dr[n][e].ravel(), dr[b][e]]), True)
    rel['experts'] = max(experts.values())
    bn = {n: _rel(d[n], dr[n], False) for n in dr if n not in gr}
    rel['bn_stats'] = max(bn.values())
    return rel, dict(grads=grads, params=params, experts=experts, bn=bn)


def check_moe_run(run, what):
    """Each step's absent datasets: loss exactly 0; step 1's absent heads:
    gradients exactly 0; every metric finite."""
    metrics, grads, _ = run
    for i, (m, idx) in enumerate(zip(metrics, MOE_REF_ROUTES)):
        check(all(np.isfinite(v) for v in m.values()),
              f'{what}: non-finite metrics in step {i + 1}: {m}')
        absent = [f'loss_{e}' for e in range(6) if e not in idx]
        check(all(m[k] == 0.0 for k in absent), f'{what}: step {i + 1} '
              f'(datasets {idx.tolist()}) has losses {m}')
    heads = ['keypoint_head.' if e == 0 else f'associate_keypoint_heads.'
             f'{e - 1}.' for e in range(6) if e not in MOE_REF_ROUTES[0]]
    nonzero = [n for n, g in grads.items()
               if n.startswith(tuple(heads)) and g.abs().max() > 0]
    check(not nonzero, f'{what}: heads of no sample in step 1 have '
          f'gradients in {nonzero[:4]}')


def phase_moe_ref(card):
    """make_moe_train_step at full ViTPose+-B width and depth (fused
    attention on, drop_path 0) from the runner's seeded weights, on CUDA
    (K1 + K2, the experts' per-row products) and on the CPU (plain
    attention): f32 (TF32 off) within MOE_REF_TOL, bf16 CUDA as close to
    the f32 CPU answer as the bf16 CPU path is (within BF16_FACTOR)."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    from vitpose_tpu_torch.utils.config import apply_options, load_config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    batch = moe_ref_batch()
    runs, cfgs = {}, {}
    for dtype in ('float32', 'bfloat16'):
        cfgs[dtype] = apply_options(load_config(PLUS_B), [
            f'model.dtype={dtype}',
            'model.backbone_overrides.fused_attention=True',
            'model.backbone_overrides.drop_path_rate=0.0'])
        for dev in ('cuda', 'cpu'):
            reset_counts()
            runs[dev, dtype] = moe_ref_run(cfgs[dtype], dev, batch)
            check_moe_run(runs[dev, dtype], f'moe-ref {dev} {dtype}')
            if dev == 'cuda':
                n = (fused_attention.launches, fused_attention_bwd.launches)
                check(n == (24, 24), f'moe-ref: two CUDA steps launched K1, '
                      f'K2 {n} times, expected 24 each')
    ref = runs['cpu', 'float32']
    # the spread of summation order alone: the CPU on one thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        spread = moe_ref_distances(
            moe_ref_run(cfgs['float32'], 'cpu', batch), ref)[0]
    finally:
        torch.set_num_threads(threads)
    f32, f32_per = moe_ref_distances(runs['cuda', 'float32'], ref)
    print('moe-ref: f32 (TF32 off) CUDA+K1+K2 vs CPU plain, ViTPose+-B full '
          f'width and depth, batch {len(MOE_REF_ROUTES[0])}, datasets '
          f'{[r.tolist() for r in MOE_REF_ROUTES]} in two steps, drop_path '
          '0: ' + ', '.join(f'{k} {v:.3e} (tol {MOE_REF_TOL[k]:g})'
                            for k, v in f32.items())
          + '; losses ' + ', '.join(
              f'step {i + 1} ' + ' '.join(
                  f'{k} {v:.6f}' for k, v in m.items() if k.startswith('loss'))
              for i, m in enumerate(ref[0]))
          + '; largest distances: ' + '; '.join(
              f'{k} {worst(v)}' for k, v in f32_per.items())
          + f'; the CPU on one thread against {threads}: ' + ', '.join(
              f'{k} {v:.3e}' for k, v in spread.items()), flush=True)
    for k, tol in MOE_REF_TOL.items():
        check(f32[k] <= tol, f'moe-ref f32: {k} differs by {f32[k]} '
              f'(tol {tol})')
    gpu, gpu_per = moe_ref_distances(runs['cuda', 'bfloat16'], ref)
    cpu, cpu_per = moe_ref_distances(runs['cpu', 'bfloat16'], ref)
    print('moe-ref: bf16 against the f32 CPU answer, CUDA+K1+K2 / CPU '
          'plain: ' + ', '.join(f'{k} {gpu[k]:.3e} / {cpu[k]:.3e}'
                                for k in gpu)
          + f' (CUDA at most {BF16_FACTOR}x CPU, + 2^-8 for the scalars); '
          f'largest expert distances, CUDA: {worst(gpu_per["experts"])}; '
          f'CPU: {worst(cpu_per["experts"])}; '
          f'{time.perf_counter() - t0:.1f} s on {card}', flush=True)
    for k in gpu:
        floor = 2.0 ** -8 if k in ('heatmap_loss', 'grad_norm', 'losses') \
            else 0.0
        check(gpu[k] <= BF16_FACTOR * cpu[k] + floor,
              f'moe-ref bf16: CUDA {k} is {gpu[k]} from the f32 answer, '
              f'the bf16 CPU path {cpu[k]}')


def kernel_name(mangled):
    """attn_fwd_pair<64,3> for the mangled name of a kernel template in an
    anonymous namespace; the mangled name where it is not one."""
    m = re.match(r'_ZN(\d+)_GLOBAL__N_', mangled)
    if not m:
        return mangled
    rest = mangled[m.start(1) + len(m.group(1)) + int(m.group(1)):]
    m = re.match(r'(\d+)', rest)
    if not m:
        return mangled
    name = rest[m.end():m.end() + int(m.group(1))]
    args = re.match(r'I((?:Li\d+E)+)E', rest[m.end() + len(name):])
    if args:
        name += '<' + ','.join(re.findall(r'Li(\d+)E', args.group(1))) + '>'
    return name


def ptxas_report(logs):
    """One line per kernel from ptxas -v: registers, static shared memory
    and spill bytes (the whole-pair kernels take dynamic shared memory, the
    size `_plan` gives). Fails if any kernel spills."""
    spilled = []
    for src, log in logs.items():
        func, spill = None, (0, 0)
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                func = kernel_name(m.group(1))
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill '
                          r'loads', line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r'Used (\d+) registers', line)
            if m:
                smem = re.search(r'(\d+) bytes smem', line)
                print(f'build {src}: {func}: {m.group(1)} registers, '
                      f'{smem.group(1) if smem else 0} bytes static smem, '
                      f'spill stores/loads {spill[0]}/{spill[1]} bytes')
                if spill != (0, 0):
                    spilled.append(func)
        if not log:
            print(f'build {src}: built before this run, no ptxas report')
    check(not spilled, f'kernels that spill registers: {spilled}')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    try:
        from vitpose_tpu_torch.kernels import _build
    except ImportError as e:
        print(f'chip_smoke: run from the repo root ({e})', file=sys.stderr)
        return 1
    try:
        card = card_line()
        print(f'env: {card}; torch {torch.__version__}, CUDA '
              f'{torch.version.cuda}, python {sys.version.split()[0]}',
              flush=True)

        t0 = time.perf_counter()
        logs = _build.build_all()
        build_s = time.perf_counter() - t0
        ptxas_report(logs)
        print(f'build: {", ".join(logs)} built by nvcc (sm_90a) in '
              f'{build_s:.1f} s', flush=True)

        k1 = phase_kernel()
        model, serve_launches, batch_s, img_s = phase_serve()
        print(f'serve: 256-crop batch (warp, bf16 ViT-B + K1, flip test, UDP '
              f'decode) median {batch_s * 1e3:.1f} ms = {img_s:.1f} img/s on '
              f'{card}', flush=True)
        del model
        torch.cuda.empty_cache()
        phase_serve_ref()
        int8 = phase_int8(card)
        serve_int8, int8_batch_ms = phase_serve_int8(card)
        with tempfile.TemporaryDirectory() as root:
            deploy = phase_deploy(card, root)
        eval_launches, eval_int8 = phase_eval(card)
        k2 = phase_kernel_bwd()
        train_launches, step_s, train_img_s, busy_ms = phase_train()
        print(f'train: step (preprocess on the card, forward, backward, '
              f'clip, AdamW) median {step_s * 1e3:.1f} ms over '
              f'{TIMED_STEPS} steps = {train_img_s:.1f} img/s on {card}',
              flush=True)
        torch.cuda.empty_cache()
        phase_train_ref()
        torch.cuda.empty_cache()
        loop_launches, loop_steps, loop_val = phase_train_loop(card, busy_ms)
        remat_k1 = phase_remat(card)
        torch.cuda.empty_cache()
        moe_launches, moe_steps, moe_val = phase_moe_train(card)
        torch.cuda.empty_cache()
        phase_moe_ref(card)
    except Failure as e:
        print(f'chip_smoke: FAIL {e}', file=sys.stderr)
        return 1

    kernels = []
    loop_k1, loop_k2 = loop_launches
    per_path = {'attention_fwd': {'serve': serve_launches,
                                  'serve_int8': {f'skip_{k}': v['k1']
                                                 for k, v in
                                                 serve_int8.items()},
                                  'deploy_per_request': {
                                      m: r['k1_per_request']
                                      for m, r in deploy.items()},
                                  'eval': eval_launches,
                                  'eval_int8': eval_int8['k1'],
                                  'train': train_launches[0],
                                  'train_loop': loop_k1,
                                  'train_loop_steps': loop_steps,
                                  'train_loop_val_batches': loop_val,
                                  'remat_step': remat_k1,
                                  'moe_train': moe_launches[0],
                                  'moe_train_steps': moe_steps,
                                  'moe_train_val_batches': moe_val},
                'attention_bwd': {'serve': 0, 'eval': 0,
                                  'train': train_launches[1],
                                  'train_loop': loop_k2,
                                  'train_loop_steps': loop_steps,
                                  'remat_step': dict.fromkeys(remat_k1, 12),
                                  'moe_train': moe_launches[1],
                                  'moe_train_steps': moe_steps}}
    for name, line, rec, n in (('attention_fwd', 22, k1, train_launches[0]),
                               ('attention_bwd', 94, k2, train_launches[1])):
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'vitpose_tpu_torch/csrc/{name}.cu',
            'replaces': f'vitpose_tpu/ops/attention.py:{line}',
            'launches': n, 'max_abs_err': rec['err'], 'ms': rec['ms'],
            'plain_ms': rec['plain_ms'], 'bound_ms': rec['bound_ms'],
            'bound_by': rec['bound_by'], 'library_ms': rec['library_ms'],
            'design': rec['design'], 'old_design': 'tiled',
            'old_ms': rec['old_ms'],
            'device_ms': rec['device_ms'][rec['design']],
            'old_device_ms': rec['device_ms'].get('tiled'),
            'launches_per_path': per_path[name]})
    # the int8 product is a library call (torch._int_mm), as XLA's
    # dot_general is in JAX: not a kernel of the repo, listed beside them
    int8_matmul = {
        'name': 'int8_matmul', 'route': 'library (torch._int_mm)',
        'replaces': 'vitpose_tpu/models/vit.py:87',
        'launches_per_path': {
            'serve_int8': {f'skip_{k}': v['int_mm']
                           for k, v in serve_int8.items()},
            'deploy_per_request': {m: r['int_mm_per_request']
                                   for m, r in deploy.items()},
            'eval_int8': eval_int8['int_mm']},
        'shapes': int8,
        'serve_batch_ms': int8_batch_ms}
    print(json.dumps({'kernels': kernels, 'int8_matmul': int8_matmul,
                      'deploy_latency_ms': {
                          m: r['latency_ms'] for m, r in deploy.items()},
                      'eval_int8_ap': eval_int8['ap'],
                      'eval_bf16_ap': eval_int8['bf16_ap']}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

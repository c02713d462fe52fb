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

Then the kernels JSON line (per kernel: the design the main path takes, its
times, the tiled design's times from the same run, bound, library time and
launches), the nvidia-smi card line and the result line.

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
    """Every kernel wrapper's launch counts to 0, per design too."""
    from vitpose_tpu_torch.ops.attention import (fused_attention,
                                                 fused_attention_bwd)
    for fn in (fused_attention, fused_attention_bwd):
        fn.launches = 0
        fn.design_launches = dict.fromkeys(fn.design_launches, 0)


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
    profile_steps(lambda: step(state, preprocess(*inputs), gen), med)
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
    return launches, med, TRAIN_BATCH / med


def profile_steps(run_step, step_s, steps=2):
    """Device time of `steps` profiled steps by torch.profiler: CUDA kernel
    time per step, the idle share against the unprofiled median step time
    `step_s` (unclamped), and the kernels that take the most time. Fails if
    the kernel time exceeds the profiled steps' own wall time, which only a
    miscount (a kernel summed twice) can give."""
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
        print('train: device time not measured (the profiler saw no CUDA '
              'kernels)', flush=True)
        return
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    check(busy_ms <= wall_ms, f'profiler kernel time {busy_ms:.3f} ms per '
          f'step exceeds the profiled steps\' wall time {wall_ms:.3f} ms: '
          'kernels counted twice')
    print(f'train: profiler, {steps} steps: kernels busy {busy_ms:.1f} ms '
          f'per step of the {step_s * 1e3:.1f} ms median step, idle share '
          f'{1 - busy_ms / (step_s * 1e3):.3f} (profiled steps: '
          f'{wall_ms:.1f} ms each); top kernels (ms '
          f'per step, launches per step): ' + '; '.join(
              f'{e.key[:70]} {e.device_time_total / 1e3 / steps:.2f} '
              f'{e.count // steps}' for e in top), flush=True)


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
        model, launches, batch_s, img_s = phase_serve()
        print(f'serve: 256-crop batch (warp, bf16 ViT-B + K1, flip test, UDP '
              f'decode) median {batch_s * 1e3:.1f} ms = {img_s:.1f} img/s on '
              f'{card}', flush=True)
        del model
        torch.cuda.empty_cache()
        phase_serve_ref()
        k2 = phase_kernel_bwd()
        train_launches, step_s, train_img_s = phase_train()
        print(f'train: step (preprocess on the card, forward, backward, '
              f'clip, AdamW) median {step_s * 1e3:.1f} ms over '
              f'{TIMED_STEPS} steps = {train_img_s:.1f} img/s on {card}',
              flush=True)
        torch.cuda.empty_cache()
        phase_train_ref()
    except Failure as e:
        print(f'chip_smoke: FAIL {e}', file=sys.stderr)
        return 1

    kernels = []
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
            'old_device_ms': rec['device_ms'].get('tiled')})
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vitpose_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the repo root; one card, nvcc, no args

Phases, each printing its own line(s); any failure exits non-zero and prints
no result:

  env       card name and power limit (nvidia-smi), torch and CUDA versions
  build     every csrc/*.cu built by nvcc for sm_90a, one process each
  kernel    K1 (attention_fwd) against its plain version on the card at the
            shapes the serving path gives it, with median times of the
            kernel, the plain version and one PyTorch library call, and the
            card's bound for the same work
  serve     full-width ViTPose-B 256x192 (bf16, K1 attention, flip test, UDP
            decode) through init_pose_model + inference_top_down_pose_model
            on a seeded 480x640 image with 8 boxes: exactly 12 blocks x 2
            passes = 24 K1 launches, every tensor on the card, every keypoint
            finite and inside its padded box; then img/s of a 256-crop batch
  serve-ref the same weights on CUDA (K1) and on the CPU (plain attention),
            2 boxes, in f32 (TF32 off) and in bf16: f32 heatmaps and decisive
            keypoints agree; the bf16 CUDA path is as close to the f32 CPU
            answer as the bf16 CPU path is (within BF16_FACTOR)

Then the kernels JSON line, the nvidia-smi card line and the result line.

The weights are random (torch.Generator seed 0, inside init_pose_model).
Random heatmaps make the UDP Newton step ill conditioned, so the smoke makes
each person box hold one clear peak: it paints a bright square at every box
centre of a dim random image, turns channel 0 of the patch embedding into a
brightness detector, and carries channel 0 through bump-shaped deconv kernels
onto every joint (`shape_peaks`). Every other weight stays random.
"""
import json
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
# both sides (one step is at most 2^-7 of |o|, inside rtol) and P is rounded
# to bf16 at a different point (unnormalised in K1, normalised in the plain
# version), a few 1e-3 at |o| < 0.5 (atol)
TOLS = {torch.float32: (1e-5, 1e-5),
        torch.bfloat16: (4e-3, 1e-2)}
KERNEL_CASES = [                         # (shape [N,T,H,d], dtype, role)
    ((256, 192, 12, 64), torch.bfloat16, 'serving batch 256, ViT-B'),
    ((256, 192, 12, 64), torch.float32, 'serving batch 256, f32'),
    ((8, 192, 12, 64), torch.bfloat16, 'serve call, 8 boxes'),
    ((16, 192, 16, 80), torch.bfloat16, 'ViT-H head dim'),
    ((2, 972, 16, 80), torch.bfloat16, '576x432 inputs'),
    ((4, 72, 12, 64), torch.bfloat16, 'last key tile holds 8 of 64 keys'),
    ((3, 48, 5, 32), torch.float32, 'ragged'),
]
SERVE_CFG = {'variant': 'b', 'dtype': 'bfloat16',
             'backbone_overrides': {'fused_attention': True}}
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


def time_ms(fn, reps=20, warmup=3):
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
        before = attn.fused_attention.launches
        out = attn.fused_attention(q, k, v)
        torch.cuda.synchronize()
        ref = attn.reference_attention(q, k, v)
        atol, rtol = TOLS[dtype]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        bad = (diff > atol + rtol * ref.float().abs()).sum().item()
        check(torch.isfinite(out).all().item(), f'K1 non-finite at {shape}')
        check(bad == 0, f'K1 disagrees with plain at {shape} {dtype}: '
              f'{bad} elements, max abs err {err}')
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = time_ms(lambda: attn.fused_attention(q, k, v))
        plain_ms = time_ms(lambda: attn.reference_attention(q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound_ms, bound_by = attention_bound(shape, dtype)
        launched = attn.fused_attention.launches - before
        dt = str(dtype).replace('torch.', '')
        print(f'kernel attention_fwd {shape} {dt} ({role}): max_abs_err '
              f'{err:.3e} (tol {atol:g} + {rtol:g}|ref|), kernel_ms '
              f'{ms:.4f}, plain_ms {plain_ms:.4f}, library_ms {lib_ms:.4f} '
              f'(sdpa), bound_ms {bound_ms:.4f} ({bound_by}), launches '
              f'{launched}', flush=True)
        records.append(dict(shape=shape, dtype=dtype, err=err, ms=ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bound_ms, bound_by=bound_by))
        del qkv, q, k, v, out, ref, diff
    print(f'kernels: attention_fwd built, launched and matched its plain '
          f'version at {len(records)} shapes', flush=True)
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


def phase_serve():
    from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                       init_pose_model)
    from vitpose_tpu_torch.ops.attention import fused_attention
    from vitpose_tpu_torch.ops.geometry import bbox_xywh2cs
    model = init_pose_model(SERVE_CFG, device='cuda')
    shape_peaks(model.model)
    check(all(p.is_cuda for p in model.model.parameters()),
          'a parameter is off the card')
    rng = np.random.RandomState(0)
    boxes = grid_boxes(rng, 4, 2)
    img = scene(0, boxes)
    persons = [{'bbox': b} for b in boxes]

    fused_attention.launches = 0
    t0 = time.perf_counter()
    results, _ = inference_top_down_pose_model(model, img, persons)
    call_s = time.perf_counter() - t0
    launches = fused_attention.launches
    depth = model.cfg.backbone.depth
    check(launches == depth * 2, f'K1 launched {launches} times in the '
          f'serve call, expected {depth} blocks x 2 passes')

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
          f'(12 blocks x 2), keypoints finite and inside their padded boxes, '
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
        for name, log in logs.items():
            for line in log.splitlines():
                if 'registers' in line or 'spill' in line:
                    print(f'build {name}: {line.strip()}')
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
    except Failure as e:
        print(f'chip_smoke: FAIL {e}', file=sys.stderr)
        return 1

    print(json.dumps({'kernels': [{
        'name': 'attention_fwd', 'route': 'cuda',
        'source': 'vitpose_tpu_torch/csrc/attention_fwd.cu',
        'replaces': 'vitpose_tpu/ops/attention.py:22',
        'launches': launches, 'max_abs_err': k1['err'], 'ms': k1['ms'],
        'plain_ms': k1['plain_ms'], 'bound_ms': k1['bound_ms'],
        'bound_by': k1['bound_by'], 'library_ms': k1['library_ms']}]}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

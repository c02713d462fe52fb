"""Selective int8 sweep at ViTPose-B geometry: the per-instance OKS floor
and the AP change of the int8 serving path when the first and last k blocks
stay in the float path.

    python -m vitpose_tpu_torch.tools.analysis.int8_selective_sweep
        --ann ANN.json --img-root IMG_DIR/ [--grid 0,0 1,1 ...]
        [--per-block] [--device cuda|cpu]

Counterpart of the JAX package's tools/analysis/int8_selective_sweep.py,
with its own copy of the harness that JAX's loads from
tests/test_int8_realscale_neutrality.py (`fixture_crops`,
`fit_final_conv`): random-init ViT-B at 256x192 (seeded) with the simple
decoder, whose final 3x3 conv is fitted in closed form (ridge regression,
lambda 1e-3 of the mean eigenvalue, both flip orientations) to the set's
UDP targets, so that the heatmaps peak where a trained model's would. The
exact model's validation (flip test, UDP) is the reference; static scales
are calibrated on the set's crops (attention products included); then for
each (k_first, k_last) of the grid (JAX's eight by default) the int8 model
(W8A8 MLP and qkv/proj, tanh GELU, those blocks in the float path) is
validated, and one JSON row gives the AP change and the OKS of each
instance against the exact prediction (min, mean), with the card's name
and power limit. `--per-block`
quantises one block at a time instead. The last line names the largest
quantised subset with an OKS floor of 0.95 or more.

The ViT runs its attention on K1 (f32; JAX's sweep runs the plain
attention), every forward in batches of the val loader's 7 boxes, a short
last batch filled with repeats of its rows. JAX's script reads the
reference checkout's COCO fixture, which this repository does not hold:
the set is an argument here. Every figure is printed beside the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ...api.inference import _device
from ...data import DatasetInfo, TopDownDataset
from ...data.loader import TopDownLoader
from ...data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ...eval.loop import run_validation
from ...models import TopDownModel, make_config
from ...ops.geometry import apply_affine_to_points, udp_warp_matrix
from ...ops.nms import oks_iou
from ...ops.target import generate_udp_heatmaps
from ...ops.warp import warp_affine_batch
from ...utils.env import card_line
from ...utils.quantize import (calibrate_act_scales, first_last_skip,
                               int8_serving_config, rebuild)
from ._common import where

JAX_GRID = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (0, 2), (2, 2), (3, 3))
BATCH = 7                         # JAX's val loader batch
IMAGE_SIZE = (192, 256)           # (w, h)
HEATMAP_SIZE = (48, 64)


def sweep_config(**backbone):
    """JAX's subject: ViT-B 256x192 with the simple decoder (the released
    ViTPose_base_simple config), flip test, UDP, the default decode, K1;
    `backbone` overrides its ViT fields (the tests' small width)."""
    cfg = make_config('b', img_size=(256, 192), head='simple',
                      out_channels=17, flip_test=True, use_udp=True,
                      post_process='default', shift_heatmap=False)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, fused_attention=True, **backbone))


def chunks(x, n=BATCH):
    """`x` [M, ...] in batches of `n` rows, the last filled with repeats of
    its own rows; yields (batch, number of real rows)."""
    for i in range(0, x.shape[0], n):
        part = x[i:i + n]
        k = part.shape[0]
        if k < n:
            part = part[torch.arange(n, device=x.device) % k]
        yield part, k


def fixture_crops(loader, device):
    """The eval pipeline's normalised crops [M, h, w, 3], the crop-space
    joints [M, K, 2] and visibility [M, K] of every real box of `loader`,
    on `device` (the val step's UDP warp)."""
    iw, ih = loader.image_size
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)
    crops, joints, vis = [], [], []
    for b in loader:
        valid = torch.from_numpy(np.asarray(b['valid'], bool)).to(device)
        center, scale = (torch.from_numpy(np.ascontiguousarray(
            b[k], np.float32)).to(device) for k in ('center', 'scale'))
        mat = udp_warp_matrix(torch.zeros(center.shape[0], device=device),
                              center, scale, (iw, ih))
        x = torch.from_numpy(np.ascontiguousarray(b['imgs'])).to(device)
        c = (warp_affine_batch(x.float() / 255.0, mat, (iw, ih)) - mean) / std
        j = apply_affine_to_points(torch.from_numpy(np.ascontiguousarray(
            b['joints'][..., :2], np.float32)).to(device), mat)
        v = torch.from_numpy(np.ascontiguousarray(b['vis'], np.float32))
        v = v[..., 0] if v.ndim == 3 else v
        crops.append(c[valid])
        joints.append(j[valid])
        vis.append(v.to(device)[valid])
    return torch.cat(crops), torch.cat(joints), torch.cat(vis)


def _head_inputs(model, crops):
    """The simple decoder's final conv input, relu(features) upsampled by
    4, [M, D, H, W] in f32, in batches of BATCH."""
    out = []
    with torch.inference_mode():
        for part, k in chunks(crops):
            f = model.backbone(part)[:k].float().permute(0, 3, 1, 2)
            out.append(F.interpolate(F.relu(f), scale_factor=4,
                                     mode='bilinear', align_corners=False))
    return torch.cat(out)


def fit_final_conv(model, crops, joints, vis, flip_index, lam=1e-3):
    """Fit the simple decoder's final 3x3 conv (in place) to the UDP targets
    of `joints` for `crops` and their mirror images, by ridge regression on
    the frozen backbone's features, in float64 on the model's device:
    (X^T X + lam * mean eigenvalue * I) W = X^T Y over every heatmap pixel
    of both orientations, X the pixel's 3x3 neighbourhood of features and
    a 1. Returns the fitted weight's norm."""
    iw, ih = IMAGE_SIZE
    jf = joints.clone()
    jf[..., 0] = (iw - 1.0) - jf[..., 0]
    fi = torch.as_tensor(flip_index, device=joints.device)
    tgt, _ = generate_udp_heatmaps(joints, vis, (iw, ih), HEATMAP_SIZE)
    tgt_f, _ = generate_udp_heatmaps(jf[:, fi], vis[:, fi], (iw, ih),
                                     HEATMAP_SIZE)
    a = b = None
    for x, y in ((crops, tgt), (crops.flip(2), tgt_f)):
        u = _head_inputs(model, x).double()
        for i in range(u.shape[0]):
            cols = F.unfold(u[i:i + 1], 3, padding=1)[0].T    # [HW, 9D]
            cols = torch.cat([cols, cols.new_ones(cols.shape[0], 1)], 1)
            yi = y[i].double().flatten(1).T                  # [HW, K]
            ata, atb = cols.T @ cols, cols.T @ yi
            a = ata if a is None else a + ata
            b = atb if b is None else b + atb
    a += lam * torch.trace(a) / a.shape[0] * torch.eye(
        a.shape[0], dtype=a.dtype, device=a.device)
    w = torch.linalg.solve(a, b)                             # [9D + 1, K]
    final = model.keypoint_head.final_layer
    d = final.in_channels
    with torch.no_grad():
        final.weight.copy_(w[:-1].T.reshape(-1, d, 3, 3).float())
        final.bias.copy_(w[-1].float())
    return float(w.norm())


def _validate(model, loader):
    return run_validation(model, loader, use_udp=True,
                          post_process='default')


def oks_against(exact_results, results, sigmas):
    """Per-instance OKS of `results`' keypoints against the exact ones
    (each exact joint taken as visible, the box area as the scale)."""
    exact = np.concatenate([r['preds'] for r in exact_results])
    boxes = np.concatenate([r['boxes'] for r in exact_results])
    preds = np.concatenate([r['preds'] for r in results])
    out = []
    for i in range(exact.shape[0]):
        g = exact[i].copy()
        g[:, 2] = 1.0
        area = float(boxes[i, 4])
        out.append(float(oks_iou(g.flatten(), preds[i][:, :3].reshape(1, -1),
                                 area, np.asarray([area]),
                                 sigmas=sigmas)[0]))
    return np.asarray(out)


def sweep(ann, img_root, grid=JAX_GRID, per_block=False, device='cuda',
          cfg=None):
    """Run the sweep (see the module docstring) on the COCO-format set; `cfg`
    replaces the ViT-B subject (a TopDownConfig with the simple head).
    Returns {'exact': stats, 'rows': [...], 'best': row or None}."""
    t0 = time.perf_counter()
    dev = _device(device)
    cfg = cfg or sweep_config()
    model = TopDownModel(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    ds = TopDownDataset(ann, img_root, dataset_info='coco',
                        image_size=IMAGE_SIZE, heatmap_size=HEATMAP_SIZE,
                        test_mode=True, use_gt_bbox=True)
    loader = TopDownLoader(ds, batch_size=BATCH, is_train=False)
    info = DatasetInfo.load('coco')
    crops, joints, vis = fixture_crops(loader, dev)
    norm = fit_final_conv(model, crops, joints, vis, info.flip_index)
    exact_results = _validate(model, loader)
    exact = ds.evaluate(exact_results)
    print(f'# exact AP={exact["AP"]:.4f} (head |W| {norm:.2f}; '
        f'{time.perf_counter() - t0:.0f} s) {where(dev)}')
    scales = calibrate_act_scales(
        model, [part for part, _ in chunks(crops)], attn=True)
    depth = cfg.backbone.depth
    plan = ([('only', b) for b in range(depth)] if per_block
            else [tuple(kk) for kk in grid])
    card = card_line(dev)
    rows = []
    for kf, kl in plan:
        skip = (tuple(i for i in range(depth) if i != kl) if kf == 'only'
                else first_last_skip(depth, kf, kl))
        fast = int8_serving_config(model.cfg, scales, qkv=True,
                                   skip_blocks=skip)
        fast = dataclasses.replace(fast, backbone=dataclasses.replace(
            fast.backbone, gelu_approx=True))
        res = _validate(rebuild(model, fast), loader)
        stats = ds.evaluate(res)
        oks = oks_against(exact_results, res, info.sigmas)
        row = dict(k_first=kf, k_last=kl,
                   quantized=[i for i in range(depth) if i not in skip]
                   if kf == 'only' else None,
                   quantized_blocks=depth - len(skip),
                   dAP=round(float(stats['AP'] - exact['AP']), 4),
                   oks_min=round(float(oks.min()), 4),
                   oks_mean=round(float(oks.mean()), 4), card=card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r for r in rows if r['oks_min'] >= 0.95]
    best = max(ok, key=lambda r: r['quantized_blocks']) if ok else None
    print(json.dumps({'summary': 'largest quantized subset with OKS floor '
                               '>= 0.95', 'best': best, 'card': card}))
    return {'exact': dict(exact), 'rows': rows, 'best': best}


def _pair(text):
    kf, kl = (int(v) for v in text.split(','))
    return kf, kl


def main(argv=None):
    ap = argparse.ArgumentParser(description='selective int8 OKS sweep '
                                 '(PyTorch port)')
    ap.add_argument('--ann', required=True)
    ap.add_argument('--img-root', required=True)
    ap.add_argument('--grid', nargs='+', type=_pair, default=list(JAX_GRID),
                    metavar='KF,KL',
                    help='(k_first, k_last) pairs; default JAX\'s eight')
    ap.add_argument('--per-block', action='store_true',
                    help='quantise one block at a time instead')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)
    return sweep(args.ann, args.img_root, args.grid, args.per_block,
                 args.device)


if __name__ == '__main__':
    main()

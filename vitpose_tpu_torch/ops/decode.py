"""Heatmap -> keypoint decoding on the device, vectorised over (N, K).

Counterpart of vitpose_tpu/ops/decode.py: argmax, the default +-0.25
shift, megvii's Gaussian modulation, DARK (unbiased) and UDP Newton
refinement of GaussianHeatmap targets, the UDP CombinedTarget decode
(`decode_combined_target`), the un-crop back to image space, and the
DeepPose coordinates' (`keypoints_from_regression`).

cv2 compatibility, as in the JAX package:
  * `cv2.getGaussianKernel(k, 0)` uses a fixed table for k in {1, 3, 5, 7}
    and sigma = 0.3*((k-1)*0.5 - 1) + 0.8 otherwise
    (:func:`gaussian_kernel1d`);
  * `cv2.GaussianBlur` pads with BORDER_REFLECT_101, jnp.pad's 'reflect'
    (:func:`gaussian_blur_reflect`, by index, so that a pad wider than the
    map reflects again as jnp.pad does).

The separable blur is a sum of shifted, weighted copies in f32, so it is a
true f32 computation on every device whatever the TF32 settings are; the
JAX package runs the same product as band-matrix einsums at HIGHEST
precision. The two sum in different orders, which shows at f32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import transform_preds

_CV2_SMALL_GAUSSIAN = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}
_F32_EPS = float(np.finfo(np.float32).eps)


def gaussian_kernel1d(ksize: int) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, 0) as a float32 numpy array."""
    if ksize in _CV2_SMALL_GAUSSIAN:
        return np.asarray(_CV2_SMALL_GAUSSIAN[ksize], np.float32)
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _sep_blur(heatmaps, kernel1d):
    """Separable zero-padded cross-correlation over the last two axes."""
    taps = [float(c) for c in np.asarray(kernel1d, np.float32)]
    pad = (len(taps) - 1) // 2
    h, w = heatmaps.shape[-2:]
    x = F.pad(heatmaps, (0, 0, pad, pad))
    x = sum(c * x[..., j:j + h, :] for j, c in enumerate(taps))
    x = F.pad(x, (pad, pad))
    return sum(c * x[..., j:j + w] for j, c in enumerate(taps))


def _reflect_index(n, pad, device):
    """Indices of an axis of length n padded by `pad` on each side with
    BORDER_REFLECT_101, reflected again where the pad exceeds the axis
    (numpy's and jnp.pad's 'reflect'; F.pad refuses pad >= n)."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = idx % period
    return torch.where(idx >= n, period - idx, idx)


def gaussian_blur_reflect(heatmaps, ksize: int):
    """cv2.GaussianBlur(ksize, sigma=0) with BORDER_REFLECT_101."""
    pad = (ksize - 1) // 2
    h, w = heatmaps.shape[-2:]
    x = heatmaps.index_select(-2, _reflect_index(h, pad, heatmaps.device))
    x = x.index_select(-1, _reflect_index(w, pad, heatmaps.device))
    return _sep_blur(x, gaussian_kernel1d(ksize))[..., pad:-pad, pad:-pad]


def gaussian_modulate(heatmaps, ksize: int):
    """Zero-pad blur rescaled to keep each map's max (reference
    top_down_eval.py:399 `_gaussian_blur`)."""
    orig_max = heatmaps.amax(dim=(-2, -1), keepdim=True)
    blurred = _sep_blur(heatmaps, gaussian_kernel1d(ksize))
    new_max = blurred.amax(dim=(-2, -1), keepdim=True)
    return blurred * (orig_max / new_max.clamp_min(1e-20))


def heatmaps_to_coords(heatmaps):
    """Argmax decode: [N, K, H, W] -> (coords [N, K, 2] xy, maxvals
    [N, K, 1]). Ties go to the first (row-major) max; coords are -1 where
    maxval <= 0 (reference top_down_eval.py:63)."""
    n, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(n, k, h * w)
    maxvals = flat.amax(dim=-1, keepdim=True)
    idx = flat.argmax(dim=-1)
    coords = torch.stack([(idx % w).float(), (idx // w).float()], dim=-1)
    coords = torch.where(maxvals > 0.0, coords, -1.0)
    return coords, maxvals


def _gather_hm(heatmaps, px, py):
    """heatmaps[n, k, py, px] with clipped integer coords."""
    n, k, h, w = heatmaps.shape
    px = px.clamp(0, w - 1)
    py = py.clamp(0, h - 1)
    flat = heatmaps.reshape(n, k, h * w)
    return torch.gather(flat, 2, (py * w + px)[..., None])[..., 0]


def _default_shift(heatmaps, coords, extra=0.0):
    """+-0.25 shift toward the larger neighbour, with megvii's `extra` +0.5
    inside the same border guard (top_down_eval.py:598-612)."""
    _, _, h, w = heatmaps.shape
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)
    dx = _gather_hm(heatmaps, px + 1, py) - _gather_hm(heatmaps, px - 1, py)
    dy = _gather_hm(heatmaps, px, py + 1) - _gather_hm(heatmaps, px, py - 1)
    ok = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25 \
        + extra
    return coords + torch.where(ok[..., None], shift, 0.0)


def _taylor_refine(log_heatmaps, coords):
    """DARK Taylor-expansion step (top_down_eval.py:298 `_taylor`)."""
    _, _, h, w = log_heatmaps.shape
    px = coords[..., 0].to(torch.int64)
    py = coords[..., 1].to(torch.int64)

    def g(x, y):
        return _gather_hm(log_heatmaps, x, y)

    dx = 0.5 * (g(px + 1, py) - g(px - 1, py))
    dy = 0.5 * (g(px, py + 1) - g(px, py - 1))
    dxx = 0.25 * (g(px + 2, py) - 2 * g(px, py) + g(px - 2, py))
    dxy = 0.25 * (g(px + 1, py + 1) - g(px - 1, py + 1)
                  - g(px + 1, py - 1) + g(px - 1, py - 1))
    dyy = 0.25 * (g(px, py + 2) - 2 * g(px, py) + g(px, py - 2))
    det = dxx * dyy - dxy * dxy
    inside = (px > 1) & (px < w - 2) & (py > 1) & (py < h - 2) & (det != 0)
    safe = torch.where(det == 0, 1.0, det)
    off_x = -(dyy * dx - dxy * dy) / safe
    off_y = -(-dxy * dx + dxx * dy) / safe
    offset = torch.stack([off_x, off_y], dim=-1)
    return coords + torch.where(inside[..., None], offset, 0.0)


def post_dark_udp(coords, heatmaps, kernel=3):
    """UDP/DARK refinement (top_down_eval.py:335): reflect-101 blur, clip,
    log, then one Newton step from the gradient and Hessian on the 3x3
    neighbourhood of the edge-padded map."""
    n, k, h, w = heatmaps.shape
    hm = gaussian_blur_reflect(heatmaps, kernel)
    hm = torch.log(hm.clamp(0.001, 50.0))
    hm = F.pad(hm, (1, 1, 1, 1), mode='replicate')
    px = coords[..., 0].to(torch.int64) + 1
    py = coords[..., 1].to(torch.int64) + 1
    hp, wp = h + 2, w + 2
    flat = hm.reshape(n, k, hp * wp)

    def g(dx, dy):
        idx = ((py + dy) * wp + (px + dx)).clamp(0, hp * wp - 1)
        return torch.gather(flat, 2, idx[..., None])[..., 0]

    i_ = g(0, 0)
    ix1, ix1_ = g(1, 0), g(-1, 0)
    iy1, iy1_ = g(0, 1), g(0, -1)
    ix1y1 = g(1, 1)
    ix1_y1_ = g(-1, -1)

    dx = 0.5 * (ix1 - ix1_)
    dy = 0.5 * (iy1 - iy1_)
    dxx = ix1 - 2.0 * i_ + ix1_
    dyy = iy1 - 2.0 * i_ + iy1_
    dxy = 0.5 * (ix1y1 - ix1 - iy1 + 2.0 * i_ - ix1_ - iy1_ + ix1_y1_)

    a, b, c, d = dxx + _F32_EPS, dxy, dxy, dyy + _F32_EPS
    det = a * d - b * c
    off_x = d / det * dx + (-b / det) * dy
    off_y = (-c / det) * dx + a / det * dy
    return coords - torch.stack([off_x, off_y], dim=-1)


def decode_combined_target(heatmaps, kernel=11,
                           valid_radius_factor=0.0546875):
    """UDP CombinedTarget maps [N, 3K, H, W] -> (coords [N, K, 2], maxvals
    [N, K, 1]): the response blurred with 2 * kernel + 1, the offsets with
    `kernel`, and the offset at the response's argmax, in radius units,
    added to it (top_down_eval.py:571-585)."""
    n, c3, h, w = heatmaps.shape
    hm = heatmaps.reshape(n, c3 // 3, 3, h, w)
    resp = gaussian_blur_reflect(hm[:, :, 0], 2 * kernel + 1)
    off_x = gaussian_blur_reflect(hm[:, :, 1], kernel)
    off_y = gaussian_blur_reflect(hm[:, :, 2], kernel)
    valid_radius = valid_radius_factor * h
    coords, maxvals = heatmaps_to_coords(resp)
    px, py = coords[..., 0].long(), coords[..., 1].long()
    off = torch.stack([_gather_hm(off_x, px, py), _gather_hm(off_y, px, py)],
                      dim=-1)
    return coords + off * valid_radius, maxvals


def keypoints_from_heatmaps(heatmaps, center, scale, post_process='default',
                            unbiased=False, kernel=11, use_udp=False,
                            target_type='GaussianHeatmap',
                            valid_radius_factor=0.0546875):
    """Full decode: heatmaps [N, K, H, W] -> (preds [N, K, 2] image coords,
    maxvals [N, K, 1]), for post_process in {None, 'default', 'unbiased',
    'megvii'} and UDP, whose CombinedTarget maps are [N, 3K, H, W]
    (reference top_down_eval.py:474)."""
    heatmaps = torch.as_tensor(heatmaps, dtype=torch.float32)
    if unbiased:
        post_process = 'unbiased'

    if use_udp:
        if target_type.lower() == 'gaussianheatmap':
            coords, maxvals = heatmaps_to_coords(heatmaps)
            coords = post_dark_udp(coords, heatmaps, kernel=kernel)
        elif target_type.lower() == 'combinedtarget':
            coords, maxvals = decode_combined_target(
                heatmaps, kernel=kernel,
                valid_radius_factor=valid_radius_factor)
        else:
            raise ValueError(f'bad target_type {target_type}')
    else:
        if post_process == 'megvii':
            heatmaps = gaussian_modulate(heatmaps, kernel)
        coords, maxvals = heatmaps_to_coords(heatmaps)
        if post_process == 'unbiased':
            log_hm = torch.log(gaussian_modulate(heatmaps, kernel)
                               .clamp_min(1e-10))
            coords = _taylor_refine(log_hm, coords)
        elif post_process is not None:
            coords = _default_shift(
                heatmaps, coords,
                extra=0.5 if post_process == 'megvii' else 0.0)

    hm_h, hm_w = heatmaps.shape[2], heatmaps.shape[3]
    preds = transform_preds(coords, center, scale, (hm_w, hm_h),
                            use_udp=use_udp)
    if post_process == 'megvii':
        maxvals = maxvals / 255.0 + 0.5
    return preds, maxvals


def keypoints_from_regression(coords, center, scale, img_size,
                              use_udp=False):
    """DeepPose outputs [N, K, 2] (normalised to the crop) -> (preds
    [N, K, 2] image coords, maxvals [N, K, 1] of ones: a regression has no
    confidence), on the outputs' device; the crop maps back as
    `transform_preds` does with `use_udp` (the JAX val step and API,
    vitpose_tpu/eval/loop.py:56-63; reference top_down_eval.py:441)."""
    iw, ih = img_size
    coords = torch.as_tensor(coords, dtype=torch.float32)
    size = torch.tensor([iw, ih], dtype=torch.float32, device=coords.device)
    preds = transform_preds(coords * size, center, scale, (iw, ih),
                            use_udp=use_udp)
    return preds, torch.ones(*coords.shape[:2], 1, device=coords.device)


def regression_pck_accuracy(output, target, target_weight, thr=0.05):
    """PCK at `thr` of normalised coordinates [N, K, 2] against the
    target, over the joints whose weight [N, K, 2] is positive, on the
    device (the JAX regression step's keypoint_pck_accuracy with unit
    normalisation, vitpose_tpu/train/step.py:122-127)."""
    vis = target_weight[..., 0] > 0
    hits = ((output - target).norm(dim=-1) < thr) & vis
    return hits.sum() / vis.sum().clamp(min=1)


def pose_pck_accuracy(output, target, mask, thr=0.05):
    """PCK of argmax-decoded heatmaps on the device, for train-time
    monitoring (reference top_down_eval.py:136; vitpose_tpu/ops/decode.py
    :287). output, target [N, K, H, W]; mask [N, K] bool.

    Returns (avg_acc, valid_count) as 0-dim tensors: per-keypoint accuracies
    averaged over keypoints with at least one valid sample. Distances are
    normalised by (h, w) in that order for (x, y), the reference's quirk.
    """
    n, k, h, w = output.shape
    pred, _ = heatmaps_to_coords(output)
    gt, _ = heatmaps_to_coords(target)
    d = pred - gt
    dist = torch.sqrt((d[..., 0] / h) ** 2 + (d[..., 1] / w) ** 2)
    valid = mask.bool()
    hit = (dist < thr) & valid
    per_kpt_valid = valid.sum(0)
    per_kpt_acc = torch.where(
        per_kpt_valid > 0, hit.sum(0) / per_kpt_valid.clamp(min=1), -1.0)
    has_valid = per_kpt_acc >= 0
    cnt = has_valid.sum()
    avg = torch.where(cnt > 0, torch.where(has_valid, per_kpt_acc, 0.0).sum()
                      / cnt.clamp(min=1), 0.0)
    return avg, cnt


# ---------------------------------------------------------------------------
# host-side keypoint metrics, numpy on the host as in the JAX package
# (vitpose_tpu/ops/decode.py:344-395; reference top_down_eval.py:179-295)
# ---------------------------------------------------------------------------

def _normalized_distances(pred, gt, mask, normalize):
    """[N,K,D] preds/gts, [N,K] mask, [N,D] normalize -> [K,N] distances
    with -1 for invisible (parity: top_down_eval.py:10 `_calc_distances`)."""
    pred = np.asarray(pred, np.float32)
    gt = np.asarray(gt, np.float32)
    mask = np.asarray(mask, bool)
    normalize = np.asarray(normalize, np.float32).copy()
    n, k, _ = pred.shape
    _mask = mask.copy()
    _mask[np.where((normalize == 0).sum(1))[0], :] = False
    dists = np.full((n, k), -1, np.float32)
    normalize[normalize <= 0] = 1e6
    dists[_mask] = np.linalg.norm(
        ((pred - gt) / normalize[:, None, :])[_mask], axis=-1)
    return dists.T


def keypoint_pck_accuracy(pred, gt, mask, thr, normalize):
    """-> (per-kpt acc [K] with -1 for empty, avg_acc, n_valid_kpts)."""
    dists = _normalized_distances(pred, gt, mask, normalize)
    accs = []
    for d in dists:
        valid = d != -1
        accs.append((d[valid] < thr).mean() if valid.any() else -1.0)
    accs = np.asarray(accs, np.float32)
    valid_accs = accs[accs >= 0]
    return accs, (valid_accs.mean() if len(valid_accs) else 0.0), \
        len(valid_accs)


def keypoint_auc(pred, gt, mask, normalize, num_step=20):
    """Area under the PCK curve over thresholds [0, 1) (top_down_eval:218)."""
    nor = np.tile(np.array([[normalize, normalize]]), (len(pred), 1))
    ys = [keypoint_pck_accuracy(pred, gt, mask, 1.0 * i / num_step, nor)[1]
          for i in range(num_step)]
    return float(np.mean(ys))


def keypoint_nme(pred, gt, mask, normalize_factor):
    """Normalized mean error (top_down_eval.py:250)."""
    dists = _normalized_distances(pred, gt, mask, normalize_factor)
    valid = dists[dists != -1]
    return float(valid.sum() / max(1, len(valid)))


def keypoint_epe(pred, gt, mask):
    """End-point error in pixels (top_down_eval.py:273)."""
    ones = np.ones((len(pred), np.asarray(pred).shape[2]), np.float32)
    dists = _normalized_distances(pred, gt, mask, ones)
    valid = dists[dists != -1]
    return float(valid.sum() / max(1, len(valid)))

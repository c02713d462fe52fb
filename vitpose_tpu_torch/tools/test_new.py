"""Diagnostic evaluation CLI of the port: the evaluation of tools/test.py
with per-sample OKS diagnostics.

    python -m vitpose_tpu_torch.tools.test_new CONFIG CHECKPOINT
        [--cfg-options ...] [--save-dir DIR] [--num-images 100 | --draw-all]
        [--kpt-thr 0.3] [--metric mAP] [--per-kpt] [--out stats.json]
        [--batch-size N] [--device cuda|cpu]

Counterpart of the JAX package's tools/test_new.py (the fork's
tools/test_new.py:244-504). The val set runs through the port's
`eval/loop.py` `run_validation` on the card (`--device cuda`, the default;
it raises without CUDA) or on the CPU; then, beyond tools/test.py:

  * `match_predictions`: each image's ground-truth persons paired with its
    predictions by the optimal assignment on the OKS matrix of
    `eval/cocoeval.py` (scipy's linear_sum_assignment), worst OKS first,
    an unmatched person with OKS 0;
  * the OKS histogram, `test_score_histogram.png` in the save dir: 100
    bins over [0, 1], drawn with cv2 (JAX draws it with matplotlib, which
    the card machine does not have);
  * overlays of a geometrically spaced sample of the matches, biased to the
    worst (`--num-images`, or every match with `--draw-all`): the ground
    truth dashed green, the prediction solid in the dataset's colours with
    its joints scored above `--kpt-thr` marked, the OKS in the corner,
    `{rank:04d}_vis_{image}-{ann id}.png`;
  * the metrics of the dataset's evaluate, printed and with `--out`
    written as JSON; `--per-kpt` also prints each joint's AP sensitivity
    (`evaluate_per_kpts`).

The save dir defaults to work_dirs/test_visualization/<config name>.
"""
from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

import numpy as np

from ..api.inference import _device, load_checkpoint
from ..eval.cocoeval import compute_oks_matrix
from ..eval.loop import run_validation
from ..utils.config import apply_options, load_config
from .test import build_eval_objects

HISTOGRAM = 'test_score_histogram.png'


def _draw_pose(img, kpts, skeleton, kpt_color, link_color, kpt_thr=0.0,
               dashed=False, radius=4, thickness=1, markers=True):
    """Draw one pose [K, 3] on `img` (BGR, in place): its links between
    joints scored above `kpt_thr`, dashed (8-pixel dashes, the fork's
    ground-truth style) or solid, and with `markers` its joints."""
    import cv2
    kpts = np.asarray(kpts, np.float64)
    for idx, (a, b) in enumerate(skeleton):
        if a >= len(kpts) or b >= len(kpts):
            continue
        if kpts[a, 2] <= kpt_thr or kpts[b, 2] <= kpt_thr:
            continue
        p0, p1 = kpts[a, :2], kpts[b, :2]
        color = tuple(int(c) for c in link_color[idx % len(link_color)])
        if dashed:
            n = max(2, int(float(np.hypot(*(p1 - p0))) // 8))
            for t in range(0, n, 2):
                q0 = p0 + (p1 - p0) * (t / n)
                q1 = p0 + (p1 - p0) * (min(t + 1, n) / n)
                cv2.line(img, tuple(q0.astype(int)), tuple(q1.astype(int)),
                         color, thickness)
        else:
            cv2.line(img, tuple(p0.astype(int)), tuple(p1.astype(int)),
                     color, thickness)
    if markers:
        for j, (x, y, s) in enumerate(kpts):
            if s <= kpt_thr:
                continue
            color = tuple(int(c) for c in kpt_color[j % len(kpt_color)])
            cv2.circle(img, (int(x), int(y)), radius, color, -1)
    return img


def match_predictions(ds, results):
    """[(prediction dict or None, ground-truth annotation, OKS)] sorted by
    OKS, worst first, or None for a dataset without a COCO index (the MPII
    family).

    Per image, the non-crowd ground truths are paired with the
    predictions (highest score first) by the optimal assignment on the
    OKS matrix, so that a junk detection cannot take another's person; a
    person left without a prediction gets OKS 0 and None. A prediction
    dict holds image_id, keypoints (flat 3K), center, scale and score.
    Predictions on paths the dataset does not index are left out."""
    from scipy.optimize import linear_sum_assignment
    if not hasattr(ds, 'coco') or not hasattr(ds, '_path_to_id'):
        return None
    sigmas = np.asarray(
        ds.sigmas if getattr(ds, 'sigmas', None) is not None
        else np.full(ds.num_joints, 0.05), np.float64)
    by_img = defaultdict(list)
    for r in results:
        preds = np.asarray(r['preds'])
        boxes = np.asarray(r['boxes'])
        for i, path in enumerate(r['image_paths']):
            try:
                img_id = ds._path_to_id(path)
            except KeyError:
                continue
            by_img[img_id].append({
                'image_id': img_id,
                'keypoints': preds[i].reshape(-1).tolist(),
                'center': boxes[i, 0:2].tolist(),
                'scale': boxes[i, 2:4].tolist(),
                'score': float(boxes[i, 5]),
            })
    matches = []
    for img_id, gts in ds.coco.img_to_anns.items():
        gts = [g for g in gts if not g.get('iscrowd', 0)]
        if not gts:
            continue
        dts = sorted(by_img.get(img_id, []), key=lambda d: -d['score'])
        pairs = {}
        if dts:
            ious = compute_oks_matrix(gts, dts, sigmas)
            for i, j in zip(*linear_sum_assignment(-ious)):
                pairs[int(j)] = (dts[i], float(ious[i, j]))
        for j, gt in enumerate(gts):
            dt, oks = pairs.get(j, (None, 0.0))
            matches.append((dt, gt, oks))
    matches.sort(key=lambda m: m[2])
    return matches


def oks_histogram(oks, path, bins=100, size=(640, 480)):
    """Write the histogram of `oks` (clipped to [0, 1], `bins` bins over
    [0, 1]) as a png of `size` (w, h) with cv2; returns the counts."""
    import cv2
    counts, _ = np.histogram(np.clip(oks, 0, 1), bins=bins, range=(0, 1))
    w, h = size
    margin = 40
    img = np.full((h, w, 3), 255, np.uint8)
    x0, y0, x1, y1 = margin, margin, w - margin, h - margin
    top = max(int(counts.max()), 1)
    bar = (x1 - x0) / bins
    for i, c in enumerate(counts):
        if c:
            cv2.rectangle(img, (int(x0 + i * bar), int(y1 - (y1 - y0)
                                                      * c / top)),
                          (int(x0 + (i + 1) * bar) - 1, y1), (180, 119, 31),
                          -1)
    cv2.line(img, (x0, y1), (x1, y1), (0, 0, 0), 1)
    cv2.line(img, (x0, y0), (x0, y1), (0, 0, 0), 1)
    font = cv2.FONT_HERSHEY_SIMPLEX
    cv2.putText(img, 'OKS', ((x0 + x1) // 2 - 15, h - 10), font, 0.5,
                (0, 0, 0), 1)
    for v in (0.0, 0.5, 1.0):
        cv2.putText(img, f'{v:.1f}', (int(x0 + v * (x1 - x0)) - 10, y1 + 18),
                    font, 0.4, (0, 0, 0), 1)
    cv2.putText(img, f'count (max {top})', (x0, y0 - 10), font, 0.5,
                (0, 0, 0), 1)
    if not cv2.imwrite(path, img):
        raise OSError(f'cv2 could not write {path}')
    return counts


def sample_indices(n, num_images, draw_all=False):
    """The matches to draw: all with `draw_all`, else `num_images` spaced
    geometrically from the worst (np.geomspace(1, n) - 1, deduplicated)."""
    if draw_all or n == 0:
        return np.arange(n)
    return np.unique((np.geomspace(1, n, num=min(num_images, n)) - 1)
                     .astype(int))


def draw_matches(matches, indices, ds, save_dir, kpt_thr):
    """One overlay png per index of `indices` into `matches`; returns the
    number written (images cv2 cannot read are skipped)."""
    import cv2
    info = ds.info
    skeleton = info.skeleton_links
    k = ds.num_joints
    green = [(0, 255, 0)] * max(len(skeleton), k)
    drawn = 0
    for i in indices:
        dt, gt, oks = matches[i]
        img_name = ds.id2name[gt['image_id']]
        img = cv2.imread(os.path.join(str(ds.img_prefix), img_name))
        if img is None:
            continue
        gt_kpt = np.asarray(gt['keypoints'], np.float64).reshape(k, 3)
        gt_kpt[:, 2] = (gt_kpt[:, 2] > 0).astype(np.float64)
        img = _draw_pose(img, gt_kpt, skeleton, green, green, dashed=True,
                         markers=False)
        if dt is not None:
            img = _draw_pose(img, np.asarray(dt['keypoints'],
                                             np.float64).reshape(k, 3),
                             skeleton, info.keypoint_colors,
                             info.skeleton_colors, kpt_thr=kpt_thr)
        cv2.putText(img, f'{oks:.2f}', (10, 30), cv2.FONT_HERSHEY_SIMPLEX,
                    1, (0, 255, 0), 2)
        base = os.path.splitext(os.path.basename(img_name))[0]
        cv2.imwrite(os.path.join(save_dir, f'{i:04d}_vis_{base}-{gt["id"]}'
                                           '.png'), img)
        drawn += 1
    return drawn


def main(argv=None):
    """Evaluate with the diagnostics; returns (stats, matches)."""
    ap = argparse.ArgumentParser(
        description='Evaluate a pose model with per-sample OKS diagnostics '
                    '(PyTorch port)')
    ap.add_argument('config')
    ap.add_argument('checkpoint')
    ap.add_argument('--cfg-options', nargs='*', default=[])
    ap.add_argument('--out', default=None)
    ap.add_argument('--batch-size', type=int, default=None)
    ap.add_argument('--metric', nargs='*', default=None)
    ap.add_argument('--save-dir', default=None,
                    help='default work_dirs/test_visualization/<config>')
    ap.add_argument('--num-images', type=int, default=100)
    ap.add_argument('--draw-all', action='store_true')
    ap.add_argument('--kpt-thr', type=float, default=0.3)
    ap.add_argument('--per-kpt', action='store_true',
                    help="also print each joint's AP sensitivity (fork "
                         'evaluate_per_kpts, topdown_coco_dataset.py:391)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = apply_options(load_config(args.config), args.cfg_options)
    family = cfg['model'].get('family', 'topdown')
    if family != 'topdown':
        raise NotImplementedError(
            f'test_new diagnoses top-down models (OKS per person); a {family} '
            'config is evaluated by tools/test.py')
    dev = _device(args.device)
    model, ds, loader = build_eval_objects(cfg, args.batch_size)
    load_checkpoint(model, args.checkpoint)
    model = model.to(dev).eval()
    mcfg = model.cfg
    results = run_validation(model, loader, use_udp=mcfg.use_udp,
                             post_process=mcfg.post_process,
                             modulate_kernel=mcfg.modulate_kernel,
                             target_type=mcfg.target_type, progress=True)

    config_name = os.path.splitext(os.path.basename(args.config))[0]
    save_dir = args.save_dir or os.path.join(
        'work_dirs', 'test_visualization', config_name)
    os.makedirs(save_dir, exist_ok=True)

    matches = match_predictions(ds, results)
    if matches is None:
        print('per-sample OKS diagnostics need a COCO-format dataset; '
              f'{type(ds).__name__} is not one: skipping to the evaluation')
        matches = []
    print(f'Number of sorted matches: {len(matches)}')
    if matches:
        oks_histogram(np.array([m[2] for m in matches]),
                      os.path.join(save_dir, HISTOGRAM))
    indices = sample_indices(len(matches), args.num_images, args.draw_all)
    print(f'Drawing {len(indices)} images ({len(matches)} available)')
    drawn = draw_matches(matches, indices, ds, save_dir, args.kpt_thr)
    print(f'saved {drawn} visualizations to {save_dir}')

    metric = args.metric or cfg.get('evaluation', {}).get('metric')
    stats = ds.evaluate(results, metric=metric) if metric \
        else ds.evaluate(results)
    if args.per_kpt and hasattr(ds, 'evaluate_per_kpts'):
        for name, per in zip(ds.info.keypoint_names,
                             ds.evaluate_per_kpts(results)):
            # sigma_i inflated to 10: the AP change shows joint i's weight
            print(f'{name} -> {100 * float(per.get("AP", 0.0)):.1f}')
    for key in sorted(stats):
        print(f'{key}: {stats[key]}')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({k: float(v) for k, v in stats.items()}, f)
    return stats, matches


if __name__ == '__main__':
    main()

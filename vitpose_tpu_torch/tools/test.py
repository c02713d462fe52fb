"""Evaluation CLI of the port: a config and a checkpoint -> COCO keypoint AP.

    python -m vitpose_tpu_torch.tools.test CONFIG CHECKPOINT
        [--cfg-options data.val.ann_file=... data.val.img_prefix=...]
        [--out stats.json] [--batch-size N] [--metric mAP ...]
        [--device cuda|cpu]

Counterpart of the top-down path of tools/test.py (`build_eval_objects`,
`_emit_stats`, `main`): the config builds the model and the COCO val
dataset and loader; the val step runs on the card (`--device cuda`, the
default; it raises without CUDA) or on the CPU with `--device cpu`; then the
dataset rescores, applies OKS NMS and computes COCO AP. CHECKPOINT is a
torch .pth (mmpose names; pos embed regridded, patch kernel padded) or an
.npz written by the JAX package.
"""
from __future__ import annotations

import argparse
import json

from ..api.inference import _device, load_checkpoint
from ..data import topdown_dataset_cls
from ..data.loader import TopDownLoader
from ..eval.loop import run_validation
from ..train.loop import build_model_from_cfg
from ..utils.config import apply_options, load_config


def build_eval_objects(cfg, batch_size=None, shard_by_process=False):
    """Model (on the CPU, seeded random weights) + val dataset + loader from
    a config."""
    if shard_by_process:
        raise NotImplementedError('multi-process evaluation is not ported '
                                  'yet (ROADMAP.md queue 1 item 11)')
    model = build_model_from_cfg(cfg['model'])
    dcfg = cfg['data']
    name = dcfg.get('dataset', 'coco')
    ds = topdown_dataset_cls(name)(
        dcfg['val']['ann_file'], dcfg['val']['img_prefix'],
        dataset_info=name,
        image_size=tuple(dcfg['image_size']),
        heatmap_size=tuple(dcfg['heatmap_size']),
        test_mode=True, use_gt_bbox=dcfg['val'].get('use_gt_bbox', True),
        bbox_file=dcfg['val'].get('bbox_file'))
    loader = TopDownLoader(
        ds, batch_size or dcfg.get('batch_size', 64), is_train=False,
        canvas_size=dcfg.get('canvas_size'),
        padding=dcfg.get('padding', 1.25),
        num_workers=dcfg.get('num_workers', 8))
    return model, ds, loader


def _emit_stats(stats, args):
    print(json.dumps({k: float(v) for k, v in stats.items()}, indent=2))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump({k: float(v) for k, v in stats.items()}, f)


def _refuse_unported(cfg, args):
    family = cfg['model'].get('family', 'topdown')
    if family != 'topdown':
        raise NotImplementedError(f'evaluation of the {family!r} family is '
                                  'not ported yet (ROADMAP.md queue 1 '
                                  'item 12)')
    for flag, item in (('int8', 8), ('show_dir', 9), ('tmpdir', 11)):
        if getattr(args, flag):
            raise NotImplementedError(
                f'--{flag.replace("_", "-")} is not ported yet (ROADMAP.md '
                f'queue 1 item {item})')


def main(argv=None):
    """Run the evaluation; prints the stats as JSON and returns them."""
    ap = argparse.ArgumentParser(description='Evaluate a top-down pose model '
                                 '(PyTorch port)')
    ap.add_argument('config')
    ap.add_argument('checkpoint')
    ap.add_argument('--cfg-options', nargs='*', default=[])
    ap.add_argument('--out', default=None)
    ap.add_argument('--batch-size', type=int, default=None)
    ap.add_argument('--metric', nargs='*', default=None,
                    help='e.g. mAP PCK AUC EPE NME (dataset-dependent)')
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (default; raises without CUDA) or 'cpu'")
    ap.add_argument('--show-dir', default=None)
    ap.add_argument('--tmpdir', default=None)
    ap.add_argument('--int8', action='store_true')
    args = ap.parse_args(argv)

    cfg = apply_options(load_config(args.config), args.cfg_options)
    _refuse_unported(cfg, args)
    dev = _device(args.device)
    model, ds, loader = build_eval_objects(cfg, args.batch_size)
    load_checkpoint(model, args.checkpoint)
    model = model.to(dev).eval()
    mcfg = model.cfg
    results = run_validation(model, loader, use_udp=mcfg.use_udp,
                             post_process=mcfg.post_process,
                             modulate_kernel=mcfg.modulate_kernel,
                             target_type=mcfg.target_type, progress=True)
    # CLI --metric wins; else the config's evaluation.metric; else the
    # dataset default
    metric = args.metric or cfg.get('evaluation', {}).get('metric')
    stats = ds.evaluate(results, metric=metric) if metric \
        else ds.evaluate(results)
    _emit_stats(stats, args)
    return stats


if __name__ == '__main__':
    main()

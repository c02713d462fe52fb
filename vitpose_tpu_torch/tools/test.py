"""Evaluation CLI of the port: a config and a checkpoint -> COCO keypoint AP.

    python -m vitpose_tpu_torch.tools.test CONFIG CHECKPOINT
        [--cfg-options data.val.ann_file=... data.val.img_prefix=...]
        [--out stats.json] [--batch-size N] [--metric mAP ...]
        [--int8 [--int8-skip K]] [--show-dir DIR] [--device cuda|cpu]

Counterpart of the top-down path of tools/test.py (`build_eval_objects`,
`_emit_stats`, `main`): the config builds the model and the COCO val
dataset and loader; the val step runs on the card (`--device cuda`, the
default; it raises without CUDA) or on the CPU with `--device cpu`; then the
dataset rescores, applies OKS NMS and computes COCO AP. The config's model
is the ViT or a CNN (a single-stage `backbone_type` of the port's
`train.loop.build_backbone`, with the classic or the ViPNAS head).
CHECKPOINT is a torch .pth (mmpose names; a ViT's pos embed regridded and
patch kernel padded) or an .npz written by the JAX package, routed by the
backbone type as JAX's tools/test.py:250-256 routes it.

A bottom-up config (family 'bottomup') is evaluated per image through the
multi-scale test protocol (`run_bottomup_eval`, JAX tools/test.py:69); a
PoseWarper config over PoseTrack18 frame windows, a pose-lifter config
over H36M or MPI-INF-3DHP windows, an InterHand3D, mesh or VoxelPose config
over its val set (`run_family_eval`, JAX
tools/test.py:147-170; PoseWarper writes its per-video jsons to
`--tmpdir`, as JAX's does). `--int8`, `--show-dir` and `--batch-size`
(but PoseWarper's), which those paths do not read, raise there.

`--int8` evaluates the int8 serving path, as JAX's does: static scales
calibrated on the first two val batches (`calibrate_from_loader`, with
attention), W8A8 MLP and qkv/proj products, tanh GELU; `--int8-skip K`
keeps the first and last K blocks in the float path. `--show-dir` writes
one drawing of the predicted keypoints per val image, named by its path
under the image prefix with '/' turned into '_'.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from collections import defaultdict

import numpy as np

from ..api.inference import _device, load_checkpoint, vis_pose_result
from ..data import topdown_dataset_cls
from ..data.loader import TopDownLoader
from ..eval.loop import run_validation
from ..train.loop import build_model_from_cfg
from ..utils.config import apply_options, load_config
from ..utils.quantize import (calibrate_from_loader, first_last_skip,
                              int8_serving_config, rebuild)


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


FAMILY_EVALS = ('bottomup', 'posewarper', 'pose_lifter', 'interhand3d',
                'mesh', 'voxelpose')


def _refuse_unported(cfg, args):
    family = cfg['model'].get('family', 'topdown')
    if family not in ('topdown',) + FAMILY_EVALS:
        raise KeyError(f'unknown model family {family!r}; expected one of '
                       f"{('topdown',) + FAMILY_EVALS}")
    if family in FAMILY_EVALS:
        # options JAX's family paths never read (PoseWarper's takes the
        # batch size, and --tmpdir as its result folder)
        for flag, given in (('--int8', args.int8),
                            ('--show-dir', args.show_dir),
                            ('--batch-size', args.batch_size
                             if family != 'posewarper' else None)):
            if given:
                raise NotImplementedError(
                    f'{flag} with a {family} config: its evaluation does '
                    'not take it')
    if args.tmpdir and family != 'posewarper':
        raise NotImplementedError('--tmpdir is not ported yet (ROADMAP.md '
                                  'queue 1 item 11)')
    if args.int8 and cfg['model'].get('backbone_type', 'vit') != 'vit':
        raise NotImplementedError(
            '--int8 quantises the ViT blocks; a '
            f"{cfg['model']['backbone_type']!r} backbone has none (JAX's "
            'int8 path is the ViT\'s)')
    if args.int8 and cfg['model'].get('num_experts', 0) > 0:
        raise NotImplementedError(
            'int8 serving is not implemented for MoE (num_experts > 0) '
            'backbones: MoEMlp has no int8 path')


def int8_model(model, loader, skip):
    """The deployed int8 path of `model` (JAX tools/test.py:258-273):
    scales calibrated on the loader's first batches with attention, W8A8
    MLP and qkv/proj, the first and last `skip` blocks in the float path,
    tanh GELU."""
    depth = model.cfg.backbone.depth
    skip_blocks = first_last_skip(depth, skip, skip)
    scales = calibrate_from_loader(model, loader, attn=True)
    cfg = int8_serving_config(model.cfg, scales, qkv=True,
                              skip_blocks=skip_blocks)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, gelu_approx=True))
    return rebuild(model, cfg)


def show_results(results, ds, img_prefix, show_dir):
    """One drawing per val image of its predicted keypoints (JAX
    tools/test.py:285-315). Returns the number written."""
    os.makedirs(show_dir, exist_ok=True)
    img_prefix = str(img_prefix)
    by_img = defaultdict(list)
    for r in results:
        for i, path in enumerate(r['image_paths']):
            by_img[path].append(dict(keypoints=np.asarray(r['preds'][i])))
    for path, poses in by_img.items():
        # relative to img_prefix, so that frames of the same name in two
        # sequence directories do not collide
        rel = (path[len(img_prefix):].lstrip('/')
               if path.startswith(img_prefix) else os.path.basename(path))
        vis_pose_result(None, path, poses, dataset_info=ds.info,
                        out_file=os.path.join(show_dir,
                                              rel.replace('/', '_')))
    return len(by_img)


def run_bottomup_eval(cfg, args, dev):
    """The bottom-up evaluation (JAX tools/test.py:69): per val image the
    reference test protocol, multi-scale resize-align + flip aggregation on
    the device and grouping on the host (associative_embedding.py:201
    forward_test, with the config's test_scale_factor and use_udp), then
    the dataset's evaluate with its use_nms (no pose NMS in the API)."""
    from ..api.inference import inference_bottom_up_multi_scale
    from ..data.bottomup import BottomUpCocoDataset
    model = build_model_from_cfg(cfg['model'])
    load_checkpoint(model, args.checkpoint)
    model = model.to(dev).eval()
    dcfg = cfg['data']
    vcfg = dcfg['val']
    ds = BottomUpCocoDataset(vcfg['ann_file'], vcfg.get('img_prefix', ''),
                             dataset_info=dcfg.get('dataset', 'coco'),
                             input_size=dcfg.get('base_size', 512),
                             test_mode=True)
    results = []
    for idx in range(len(ds)):
        rec = ds.record(idx)
        pose_results, _ = inference_bottom_up_multi_scale(
            model, rec['image_file'],
            test_scale_factor=tuple(dcfg.get('test_scale_factor', (1.0,))),
            base_size=dcfg.get('input_size', 512),
            use_udp=dcfg.get('use_udp', False), pose_nms_thr=None)
        results.append(dict(
            preds=[p['keypoints'] for p in pose_results],
            scores=[p['score'] for p in pose_results],
            image_paths=[rec['image_file']]))
    metric = args.metric or cfg.get('evaluation', {}).get('metric')
    nms_kw = dict(use_nms=vcfg.get('use_nms', False),
                  soft_nms=vcfg.get('soft_nms', False),
                  oks_thr=vcfg.get('oks_thr', 0.9))
    stats = (ds.evaluate(results, metric=metric, **nms_kw) if metric
             else ds.evaluate(results, **nms_kw))
    _emit_stats(stats, args)
    return stats


def run_family_eval(cfg, args, dev):
    """PoseWarper (PoseTrack18 mAP over frame windows with the flip test),
    the pose lifters (MPJPE, P-MPJPE, N-MPJPE; 3DPCK and 3DAUC on
    MPI-INF-3DHP), InterHand3D (MPJPE, MRRPE, Handedness_acc), the mesh
    (joint_error: MPJPE, MPJPE-PA) and VoxelPose (recall and MPJPE at 500
    mm, mAP): eval/families.py, as JAX tools/test.py:147-170 runs them, on
    a checkpoint that is the port's .pth, a reference .pth or the JAX
    package's .npz."""
    from ..eval import families
    model = build_model_from_cfg(cfg['model'])
    load_checkpoint(model, args.checkpoint)
    model = model.to(dev).eval()
    family = cfg['model']['family']
    if family == 'posewarper':
        stats = families.evaluate_posewarper(
            cfg, model, batch_size=args.batch_size, res_folder=args.tmpdir,
            metric=args.metric)
    else:
        stats = getattr(families, f'evaluate_{family}')(
            cfg, model, metric=args.metric)
    _emit_stats(stats, args)
    return stats


def main(argv=None):
    """Run the evaluation; prints the stats as JSON and returns them."""
    ap = argparse.ArgumentParser(description='Evaluate a pose model '
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
    ap.add_argument('--show-dir', default=None,
                    help='write one drawing of the predictions per val '
                         'image here')
    ap.add_argument('--tmpdir', default=None)
    ap.add_argument('--int8', action='store_true',
                    help='evaluate the int8 serving path: static scales '
                         'calibrated on the first val batches, W8A8 MLP '
                         'and qkv/proj, tanh GELU')
    ap.add_argument('--int8-skip', type=int, default=0, metavar='K',
                    help='with --int8: keep the first and last K blocks in '
                         'the float path')
    args = ap.parse_args(argv)

    cfg = apply_options(load_config(args.config), args.cfg_options)
    _refuse_unported(cfg, args)
    dev = _device(args.device)
    if cfg['model'].get('family') == 'bottomup':
        return run_bottomup_eval(cfg, args, dev)
    if cfg['model'].get('family') in FAMILY_EVALS:
        return run_family_eval(cfg, args, dev)
    model, ds, loader = build_eval_objects(cfg, args.batch_size)
    load_checkpoint(model, args.checkpoint)
    model = model.to(dev).eval()
    if args.int8:
        model = int8_model(model, loader, args.int8_skip)
    mcfg = model.cfg
    results = run_validation(model, loader, use_udp=mcfg.use_udp,
                             post_process=mcfg.post_process,
                             modulate_kernel=mcfg.modulate_kernel,
                             target_type=mcfg.target_type, progress=True)
    if args.show_dir:
        n = show_results(results, ds, cfg['data']['val']['img_prefix'],
                         args.show_dir)
        print(f'saved {n} visualizations to {args.show_dir}')
    # CLI --metric wins; else the config's evaluation.metric; else the
    # dataset default
    metric = args.metric or cfg.get('evaluation', {}).get('metric')
    stats = ds.evaluate(results, metric=metric) if metric \
        else ds.evaluate(results)
    _emit_stats(stats, args)
    return stats


if __name__ == '__main__':
    main()

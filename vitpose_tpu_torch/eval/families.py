"""Validation of the model families other than top-down and bottom-up.

Counterpart of vitpose_tpu/eval/families.py (`evaluate_pose_lifter` :16-66,
`evaluate_mesh` :69, `evaluate_posewarper` :110-176,
`evaluate_interhand3d` :179, `evaluate_voxelpose` :222), shared by the evaluation CLI and the
family training loops. Each takes the config dict and a model whose
parameters sit on the device to run on, and returns the dataset's metrics.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _device_of(model):
    return next(model.parameters()).device


def lifter_dataset(cfg: dict):
    """The config's val windows: MpiInf3dhpDataset for data.dataset
    'mpi_inf_3dhp' (as mmpose's dataset type selects it), Body3DH36MDataset
    otherwise. JAX builds the H36M class for every config, so the 3DHP
    configs' '3dpck' and '3dauc' raise KeyError there (ROADMAP §3)."""
    from ..data.body3d import Body3DH36MDataset
    from ..data.mpi_inf_3dhp import MpiInf3dhpDataset
    dcfg = cfg['data']
    vcfg = dcfg['val']
    cls = (MpiInf3dhpDataset if dcfg.get('dataset') == 'mpi_inf_3dhp'
           else Body3DH36MDataset)
    return cls(vcfg['ann_file'], seq_len=dcfg.get('seq_len', 27),
               seq_frame_interval=dcfg.get('seq_frame_interval', 1),
               causal=dcfg.get('causal', False),
               det_file=vcfg.get('det_file'),
               camera_param_file=vcfg.get('camera_param_file'),
               test_mode=True)


@torch.no_grad()
def evaluate_pose_lifter(cfg: dict, model, metric=None):
    """Lifting over the val windows in batches of data.batch_size ->
    MPJPE / P-MPJPE / N-MPJPE (3DHP: also 3DPCK and 3DAUC). Inputs are
    camera-normalised, or with joint_2d_normalize stats-normalised; the
    outputs are un-normalised with joint_3d_normalize, get back a zero root
    row where the model drops it (remove_root) and are re-anchored at the
    GT root before the root-inclusive comparison."""
    from ..data.body3d import load_joint_normalize
    ds = lifter_dataset(cfg)
    norm2d = load_joint_normalize(cfg.get('joint_2d_normalize'))
    norm3d = load_joint_normalize(cfg.get('joint_3d_normalize'))
    remove_root = bool(cfg['model'].get('remove_root'))
    bs = cfg['data'].get('batch_size', 128)
    dev = _device_of(model)
    model.eval()
    results = []
    for start in range(0, len(ds), bs):
        samples = [ds[i] for i in range(start, min(start + bs, len(ds)))]
        if norm2d is not None:
            x = np.stack([(np.asarray(s['input_2d'], np.float32)
                           - norm2d[0]) / norm2d[1] for s in samples])
        else:
            x = np.stack([ds.normalize_2d(s['input_2d'], s['target_idx'])
                          for s in samples])
        out = model(torch.from_numpy(x).to(dev))
        if isinstance(out, tuple):        # with_traj: (pose, traj)
            out = out[0]
        out = out.float().cpu().numpy()
        if norm3d is not None:
            out = out * norm3d[1] + norm3d[0]
        if remove_root:
            out = np.concatenate(
                [np.zeros((out.shape[0], 1, 3), out.dtype), out], axis=1)
        roots = np.stack([np.asarray(s['target_3d'])[:1] for s in samples])
        results.append(dict(preds=out + roots,
                            target_idxs=[s['target_idx'] for s in samples]))
    metric = metric or cfg.get('evaluation', {}).get('metric', ['mpjpe'])
    return ds.evaluate(results, metric=metric)


def posewarper_heatmaps(model, frames, frame_weight, flip_index=None,
                        shift_heatmap=True):
    """PoseWarper's test-time heatmaps of [N, T, H, W, 3] windows (the key
    frame first): with `flip_index`, the flip test averages the pass over
    width-flipped frames, its maps reordered by `flip_index` and mirrored
    (shifted right by one pixel with `shift_heatmap`), as JAX's
    evaluate_posewarper and the reference's forward_test do."""
    heat = model(frames, frame_weight=frame_weight, key_index=0)
    if flip_index is None:
        return heat
    hm_f = model(frames.flip(3), frame_weight=frame_weight, key_index=0)
    hm_f = hm_f[:, flip_index].flip(-1)
    if shift_heatmap:
        hm_f = torch.cat([hm_f[..., :1], hm_f[..., :-1]], dim=-1)
    return (heat + hm_f) * 0.5


@torch.no_grad()
def evaluate_posewarper(cfg: dict, model, batch_size: Optional[int] = None,
                        res_folder: Optional[str] = None, metric=None):
    """Windows (key frame first, the test frame weights) -> the temporal
    aggregation with the flip test of test_cfg (the width axis of every
    frame flipped, maps reordered by flip_index and mirrored, shifted one
    pixel with shift_heatmap) -> keypoints_from_heatmaps on the model's
    device -> PoseTrack18's poseval mAP."""
    from ..data.posetrack import PoseTrackVideoDataset
    from ..ops.decode import keypoints_from_heatmaps
    from ..train.posewarper_loop import load_window
    dcfg = cfg['data']
    vcfg = dcfg['val']
    image_size = tuple(dcfg.get('image_size', (288, 384)))
    heatmap_size = tuple(dcfg.get('heatmap_size', (72, 96)))
    bbox_file = vcfg.get('bbox_file')
    ds = PoseTrackVideoDataset(
        vcfg['ann_file'], vcfg.get('img_prefix', ''),
        image_size=image_size, heatmap_size=heatmap_size,
        frame_indices_test=list(dcfg.get('frame_indices',
                                         (-2, -1, 0, 1, 2))),
        test_mode=True, use_gt_bbox=bbox_file is None, bbox_file=bbox_file,
        det_bbox_thr=dcfg.get('det_bbox_thr', 0.0))
    bs = batch_size or dcfg.get('batch_size', 8)
    tcfg = cfg.get('test_cfg', {})
    post = tcfg.get('post_process', 'default')
    dev = _device_of(model)
    flip_index = torch.as_tensor(ds.info.flip_index, device=dev)
    model.eval()
    results = []
    for start in range(0, len(ds), bs):
        recs = ds.db[start:start + bs]
        windows = [load_window(rec, image_size, rng=None) for rec in recs]
        fw = torch.as_tensor(recs[0]['frame_weight'], device=dev)
        x = torch.from_numpy(np.stack([w[0] for w in windows])).to(dev)
        heat = posewarper_heatmaps(
            model, x, fw, flip_index if tcfg.get('flip_test', False)
            else None, tcfg.get('shift_heatmap', True))
        c = np.stack([w[3] for w in windows])
        s = np.stack([w[4] for w in windows])
        preds, maxvals = keypoints_from_heatmaps(
            heat.float(), torch.from_numpy(c).to(dev),
            torch.from_numpy(s).to(dev), post_process=post)
        kp = np.concatenate([preds.cpu().numpy(), maxvals.cpu().numpy()],
                            axis=-1)
        area = np.prod(s * 200.0, axis=1, keepdims=True)
        boxes = np.concatenate(
            [c, s, area, np.asarray([[r['bbox_score']] for r in recs])],
            axis=1)
        results.append(dict(preds=kp, boxes=boxes,
                            image_paths=[r['image_file'] for r in recs],
                            bbox_ids=[r['bbox_id'] for r in recs]))
    metric = metric or cfg.get('evaluation', {}).get('metric', 'mAP')
    return ds.evaluate(results, res_folder=res_folder, metric=metric)


@torch.no_grad()
def evaluate_mesh(cfg: dict, model, metric=None):
    """HMR over the val MeshDataset (cv2 crops of each record's centre and
    scale, /255) in batches of data.batch_size -> the joint_error protocol
    (14 LSP joints, hip-centred MPJPE and MPJPE-PA in mm)."""
    import cv2
    from ..data.mesh import MeshDataset
    from ..ops.geometry import affine_matrix
    dcfg = cfg['data']
    vcfg = dcfg['val']
    image_size = tuple(dcfg.get('image_size', (224, 224)))
    iw, ih = image_size
    ds = MeshDataset(vcfg['ann_file'], vcfg.get('img_prefix', ''),
                     image_size=image_size)
    bs = dcfg.get('batch_size', 32)
    dev = _device_of(model)
    model.eval()
    results = []
    for start in range(0, len(ds), bs):
        recs = ds.db[start:start + bs]
        crops = []
        for rec in recs:
            img = cv2.cvtColor(cv2.imread(rec['image_file']),
                               cv2.COLOR_BGR2RGB)
            mat = np.asarray(affine_matrix(
                rec['center'][None], rec['scale'][None],
                np.zeros((1,), np.float32), (iw, ih)))[0]
            crops.append(cv2.warpAffine(img.astype(np.float32), mat,
                                        (iw, ih), flags=cv2.INTER_LINEAR))
        x = torch.from_numpy(np.stack(crops) / np.float32(255.0)).to(dev)
        out = model(x)
        results.append(dict(keypoints_3d=out['joints_3d'].float().cpu()
                            .numpy(),
                            image_path=[r['image_file'] for r in recs]))
    metric = metric or cfg.get('evaluation', {}).get('metric',
                                                     'joint_error')
    return ds.evaluate(results, metric=metric)


@torch.no_grad()
def evaluate_interhand3d(cfg: dict, model, metric=None):
    """Per-crop 2.5D inference in batches of data.batch_size -> the decode
    -> camera-space back-projection at each record's camera and root depths
    -> MPJPE / MRRPE / Handedness_acc / AUC."""
    from ..models.interhand3d import backproject_to_camera
    from ..ops.geometry import bbox_xywh2cs
    from ..train.interhand_loop import interhand_loader
    loader = interhand_loader(cfg, 'val', is_train=False)
    ds = loader.ds
    w, h = loader.image_size
    dev = _device_of(model)
    results = []
    n = len(ds.db)
    for start in range(0, n, loader.batch_size):
        recs = ds.db[start:start + loader.batch_size]
        crops = np.stack([loader._prepare(r)[0] for r in recs])
        out = model.infer(torch.from_numpy(crops).to(dev))
        cs = [bbox_xywh2cs(r['bbox'], aspect_ratio=w / h) for r in recs]
        dec = model.decode(*out, torch.stack([c for c, _ in cs]),
                           torch.stack([s for _, s in cs]))
        cam = backproject_to_camera(
            dec['keypoints_3d'], np.stack([r['focal'] for r in recs]),
            np.stack([r['princpt'] for r in recs]),
            np.stack([r['abs_depth'] for r in recs]))
        results.append(dict(preds=cam, hand_type=dec['hand_type'],
                            keypoints_px=dec['keypoints_3d'],
                            rel_root_depth=dec['rel_root_depth'],
                            bbox_ids=[r['bbox_id'] for r in recs]))
    metric = metric or cfg.get('evaluation', {}).get('metric', ['MPJPE'])
    return ds.evaluate(results, metric=metric)


@torch.no_grad()
def evaluate_voxelpose(cfg: dict, model, metric=None):
    """Per frame: the GT-projection heatmaps in each camera's heatmap frame
    (as training paints them), the model's people -> the Panoptic protocol
    (recall and MPJPE at 500 mm, AP and AR at 25-150 mm)."""
    from ..data.panoptic_mview import PanopticMviewDataset
    from ..train.voxelpose_loop import (gt_projected_heatmaps,
                                        heatmap_frame_cameras)
    dcfg = cfg['data']
    vcfg = dcfg.get('val', dcfg.get('train', {}))
    ds = PanopticMviewDataset(
        [str(p) for p in vcfg['seq_dirs']], cam_names=vcfg.get('cam_names'),
        num_joints=cfg['model'].get('num_joints', 15))
    hm_size = tuple(dcfg.get('heatmap_size', (64, 64)))[::-1]
    dev = _device_of(model)
    results = []
    for idx in range(len(ds)):
        frame = ds[idx]
        cameras = heatmap_frame_cameras(frame['cameras'], hm_size)
        heatmaps = gt_projected_heatmaps(frame, cameras, model.num_joints,
                                         hm_size)
        people = model(torch.from_numpy(heatmaps).to(dev), cameras)
        results.append([(np.asarray(j), float(s)) for j, s in people])
    metric = metric or cfg.get('evaluation', {}).get('metric', ['mpjpe'])
    metric = [{'MPJPE': 'mpjpe'}.get(m, m) for m in (
        metric if isinstance(metric, list) else [metric])]
    return ds.evaluate(results, metric=metric)

"""3D pose-lifting inference API, in PyTorch.

Counterpart of vitpose_tpu/api/inference_3d.py:15-121 and :278-295
(reference mmpose/apis/inference_3d.py): `extract_pose_sequence` gathers a
padded window of per-frame 2D results around a frame; `_normalize_sequence`
maps pixels to VideoPose3D's normalised frame; `inference_pose_lifter_model`
lifts each person of the window's target frame (the middle one, or the last
with `causal`), matched by track id in the other frames, optionally
rescaled from its box to the dataset's average box (`norm_pose_2d`), in one
batch on the model's device, and keeps a trajectory lifter's global root
(`traj`); `vis_3d_pose_result` draws them with matplotlib. The model is a
PoseLifter whose weights live in it (JAX passes `variables` beside it).

`inference_interhand_3d_model` and `inference_mesh_model` (JAX :176 and
:232, reference apis/inference_3d.py:469 and :621) crop each box (the
padded centre and scale, one batched affine warp on the model's device,
plain /255 inputs as the family's training feeds) and run the
Interhand3DEstimator (its decode: keypoints with the relative root depth
added to the left hand's, per-hand scores gated by the hand type) or the
ParametricMesh; `vis_3d_mesh_result` (:297) renders meshes with
`api.inference.imshow_mesh_3d`.
"""
from __future__ import annotations

import numpy as np
import torch


def extract_pose_sequence(pose_results_list, frame_idx, causal=False,
                          seq_len=27, step=1):
    """The window of per-frame results around `frame_idx`, padded at both
    ends with the first and last frame it reaches."""
    if causal:
        frames_left, frames_right = seq_len - 1, 0
    else:
        frames_left = (seq_len - 1) // 2
        frames_right = seq_len - 1 - frames_left
    num_frames = len(pose_results_list)
    pad_left = max(0, frames_left - frame_idx // step)
    pad_right = max(0, frames_right - (num_frames - 1 - frame_idx) // step)
    start = frame_idx - (frames_left - pad_left) * step
    end = frame_idx + (frames_right - pad_right) * step + 1
    seq = pose_results_list[start:end:step]
    return [seq[0]] * pad_left + seq + [seq[-1]] * pad_right


def _normalize_sequence(kp_seq, image_size=None):
    """[T, K, C >= 2] pixels -> ((x - w/2) / (w/2), (y - h/2) / (w/2)) with
    `image_size` (w, h); the raw coordinates without."""
    kp = np.asarray(kp_seq, np.float32)[..., :2].copy()
    if image_size is not None:
        w, h = image_size
        kp[..., 0] = (kp[..., 0] - w / 2) / (w / 2)
        kp[..., 1] = (kp[..., 1] - h / 2) / (w / 2)
    return kp


def _renorm(person, kp, bbox_center, bbox_scale):
    """`kp` rescaled from the person's box to the average box (reference
    inference_3d.py:104-110)."""
    if 'bbox' not in person:
        raise KeyError('norm_pose_2d=True needs a bbox per person '
                       '(reference _gather_pose_lifter_inputs)')
    b = np.asarray(person['bbox'], np.float32)
    c = np.array([(b[0] + b[2]) / 2, (b[1] + b[3]) / 2], np.float32)
    s = max(b[2] - b[0], b[3] - b[1])
    out = kp.copy()
    out[:, :2] = (kp[:, :2] - c) / s * bbox_scale \
        + np.asarray(bbox_center, np.float32)
    return out


@torch.no_grad()
def inference_pose_lifter_model(model, pose_results_2d, image_size=None,
                                with_track_id=True, norm_pose_2d=False,
                                causal=False, bbox_center=(528.0, 427.0),
                                bbox_scale=400.0):
    """Lift a window of 2D poses to 3D.

    Args:
      model: a PoseLifter (models/pose3d.py) on its device.
      pose_results_2d: a list over the receptive field's T frames of lists
        of person dicts with 'keypoints' [K, 3] (and 'track_id', 'bbox').
      image_size: (w, h): normalise the 2D coordinates as the lifters train.
      norm_pose_2d: rescale each person from its box ([x1, y1, x2, y2]) to
        the dataset's average box (`bbox_center`, `bbox_scale`: the
        reference's H36M fallback) before the normalisation.
      causal: the target frame is the window's last, not its middle.

    Returns one dict per person of the target frame, the input's keys with
    'keypoints_3d' [K, 3] and, for a trajectory lifter, 'traj' [1, 3].
    """
    t_len = model.receptive_field
    if len(pose_results_2d) != t_len:
        raise ValueError(f'need a {t_len}-frame window, got '
                         f'{len(pose_results_2d)}')
    center = pose_results_2d[-1 if causal else len(pose_results_2d) // 2]
    if not center:
        return []
    seqs = []
    for person in center:
        tid = person.get('track_id', None)
        seq = []
        for frame in pose_results_2d:
            match = None
            if with_track_id and tid is not None:
                match = next((p for p in frame if p.get('track_id') == tid),
                             None)
            if match is None and frame:
                match = frame[0]
            src = match if match is not None else person
            kp = np.asarray(src['keypoints'], np.float32)
            seq.append(_renorm(src, kp, bbox_center, bbox_scale)
                       if norm_pose_2d else kp)
        seqs.append(_normalize_sequence(np.stack(seq), image_size))
    dev = next(model.parameters()).device
    model.eval()
    out = model(torch.from_numpy(np.stack(seqs)).to(dev))
    pose, traj = out if isinstance(out, tuple) else (out, None)
    pose = pose.float().cpu().numpy()
    traj = None if traj is None else traj.float().cpu().numpy()
    results = []
    for i, person in enumerate(center):
        res = dict(person)
        res['keypoints_3d'] = pose[i]
        if traj is not None:
            res['traj'] = traj[i]
        results.append(res)
    return results


def vis_3d_pose_result(model, result, img=None, out_file=None,
                       dataset_info=None, kpt_score_thr=0.3, radius=8,
                       thickness=2, num_instances=-1, axis_azimuth=70,
                       axis_elev=15, **kwargs):
    """The reference-named wrapper (apis/inference_3d.py:359) over
    `api.inference.vis_pose_result_3d`: skeleton and colours from
    `dataset_info` (or the model's, where it has one)."""
    from .inference import vis_pose_result_3d
    info = dataset_info or getattr(model, 'dataset_info', None)
    return vis_pose_result_3d(
        result, skeleton=info.skeleton_links if info else None,
        out_file=out_file, img=img, kpt_score_thr=kpt_score_thr,
        pose_kpt_color=info.keypoint_colors if info else None,
        pose_link_color=info.skeleton_colors if info else None,
        num_instances=num_instances, azimuth=axis_azimuth,
        elevation=axis_elev)


def _select_boxes(det_results, bbox_thr, fmt):
    """(xywh boxes [N, 5] with scores, xyxy boxes, indices kept by
    `bbox_thr`) of detection dicts; a missing score is 1."""
    if len(det_results) == 0:
        empty = np.zeros((0, 5), np.float32)
        return empty, empty.copy(), np.zeros(0, np.int64)
    bboxes = np.stack([
        np.pad(np.asarray(p['bbox'], np.float32)[:5],
               (0, max(0, 5 - len(np.asarray(p['bbox'])[:5]))),
               constant_values=1.0) for p in det_results])
    xyxy = bboxes.copy()
    if fmt == 'xyxy':
        bboxes = bboxes.copy()
        bboxes[:, 2:4] = xyxy[:, 2:4] - xyxy[:, :2]
    else:
        xyxy[:, 2:4] = bboxes[:, :2] + bboxes[:, 2:4]
    keep = np.arange(len(bboxes)) if bbox_thr is None else \
        np.where(bboxes[:, 4] > bbox_thr)[0]
    return bboxes, xyxy, keep


def _read_rgb(img_or_path):
    if isinstance(img_or_path, str):
        import cv2
        return cv2.cvtColor(cv2.imread(img_or_path), cv2.COLOR_BGR2RGB)
    return np.asarray(img_or_path)


def _crops(img, bboxes_xywh, out_size, device, padding=1.25):
    """An RGB image and xywh boxes -> (crops [N, h, w, 3] in [0, 1] on
    `device`, center [N, 2], scale [N, 2]): the padded box geometry and the
    training pipeline's affine warp."""
    from ..ops.geometry import affine_matrix, bbox_xywh2cs
    from ..ops.warp import warp_affine_batch
    w, h = out_size
    center, scale = bbox_xywh2cs(bboxes_xywh[:, :4], w / h, padding=padding)
    n = len(bboxes_xywh)
    src = torch.from_numpy(np.ascontiguousarray(img)).to(device)
    imgs = (src.float() / 255.0)[None].expand(n, -1, -1, -1)
    mat = affine_matrix(center, scale, torch.zeros(n), (w, h)).to(device)
    return warp_affine_batch(imgs, mat, (w, h)), center, scale


def inference_interhand_3d_model(model, img_or_path, det_results,
                                 bbox_thr=None, format='xywh',
                                 dataset='interhand3d'):
    """Interacting-hand 3D pose for hand boxes: det_results a list of
    {'bbox': [x, y, w, h(, score)]} (or xyxy with `format`). Returns the
    kept dicts extended with 'keypoints_3d' [K, 4] (image x, y, depth mm
    with the relative root depth added to the left hand's, score times the
    hand-type probability), 'rel_root_depth', 'hand_type' and the xyxy
    'bbox'."""
    assert format in ('xyxy', 'xywh')
    bboxes, xyxy, keep = _select_boxes(det_results, bbox_thr, format)
    if len(keep) == 0:
        return []
    dev = next(model.parameters()).device
    crops, center, scale = _crops(_read_rgb(img_or_path), bboxes[keep],
                                  model.image_size, dev)
    res = model.decode(*model.infer(crops), center, scale)
    kp = np.asarray(res['keypoints_3d'], np.float64)
    scores = np.asarray(res['scores'], np.float64)
    half = kp.shape[1] // 2
    kp[:, half:, 2] += np.asarray(res['rel_root_depth'])[:, None]
    scores[:, :half, 0] *= res['hand_type'][:, [0]]
    scores[:, half:, 0] *= res['hand_type'][:, [1]]
    poses = np.concatenate([kp, scores], axis=-1)
    out = []
    for row, i in enumerate(keep):
        r = dict(det_results[i])
        r['keypoints_3d'] = poses[row]
        r['bbox'] = xyxy[i, :4]
        r['rel_root_depth'] = float(res['rel_root_depth'][row])
        r['hand_type'] = res['hand_type'][row]
        out.append(r)
    return out


@torch.no_grad()
def inference_mesh_model(model, img_or_path, det_results, bbox_thr=None,
                         format='xywh', image_size=(224, 224), faces=None):
    """SMPL mesh recovery for person boxes with a ParametricMesh (eval
    mode). Returns the kept dicts extended with 'keypoints_3d', 'camera',
    'vertices', 'faces' (`faces`, else the model's `faces` attribute),
    'center', 'scale' and the xyxy 'bbox'."""
    assert format in ('xyxy', 'xywh')
    faces = faces if faces is not None else getattr(model, 'faces', None)
    bboxes, xyxy, keep = _select_boxes(det_results, bbox_thr, format)
    if len(keep) == 0:
        return []
    dev = next(model.parameters()).device
    crops, center, scale = _crops(_read_rgb(img_or_path), bboxes[keep],
                                  image_size, dev)
    model.eval()
    out = {k: v.float().cpu().numpy() for k, v in model(crops).items()}
    results = []
    for row, i in enumerate(keep):
        r = dict(det_results[i])
        r['bbox'] = xyxy[i, :4]
        r['center'] = center[row].numpy()
        r['scale'] = scale[row].numpy()
        r['keypoints_3d'] = out['joints_3d'][row]
        r['camera'] = out['cam'][row]
        r['vertices'] = out['vertices'][row]
        r['faces'] = faces
        results.append(r)
    return results


def vis_3d_mesh_result(model, result, img=None, show=False, out_file=None,
                       focal_length=None):
    """Render mesh results (inference_mesh_model's: 'vertices', 'faces',
    'camera', 'bbox') onto the image: each mesh placed by its box and
    weak-perspective scale under one pinhole camera, depth 2f / (s * box
    size), shifted to project into the box centre. `img` a BGR path or an
    RGB array (None: a white canvas over the boxes). Returns the BGR
    rendering, written to `out_file` when given."""
    import cv2
    from .inference import imshow_mesh_3d
    if isinstance(img, str):
        img = cv2.imread(img)
    elif img is not None:
        img = cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2BGR)
    if img is None:
        extent = max([int(np.asarray(r['bbox'][:4]).max()) for r in result]
                     + [256])
        img = np.full((extent, extent, 3), 255, np.uint8)
    h, w = img.shape[:2]
    f = focal_length or max(h, w)
    verts, faces = [], []
    for r in result:
        if r.get('faces') is None:
            raise ValueError('result has faces=None: pass faces= to '
                             'inference_mesh_model or set .faces on the '
                             'model')
        s, tx, ty = np.asarray(r['camera'], np.float64)
        x0, y0, x1, y1 = np.asarray(r['bbox'][:4], np.float64)
        bb = max(x1 - x0, y1 - y0, 1.0)
        cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
        z = 2.0 * f / max(abs(s) * bb, 1e-6)
        v = np.asarray(r['vertices'], np.float64) + np.array([tx, ty, 0.0])
        v = v + np.array([(cx - w / 2) * z / f, (cy - h / 2) * z / f, z])
        verts.append(v)
        faces.append(r['faces'])
    rendered = imshow_mesh_3d(img, verts, faces, (w / 2, h / 2), (f, f))
    if out_file:
        cv2.imwrite(out_file, rendered)
    return rendered

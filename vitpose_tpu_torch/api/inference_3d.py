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

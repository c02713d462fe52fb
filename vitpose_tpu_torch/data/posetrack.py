"""PoseTrack18 dataset: frames grouped per video and poseval's mAP.

The port's own copy of vitpose_tpu/data/posetrack.py:15-218 (reference
`TopDownPoseTrack18Dataset`, topdown_posetrack18_video_dataset.py:338
evaluate, :448 _write_keypoint_results, :515 _do_keypoint_eval): frame
records load through TopDownDataset; `evaluate` rescores and OKS-NMSes the
predictions, regroups them per video, writes one prediction json per video
in poseval's layout (images and annotations with keypoints, per-joint
scores, score and track_id), and scores every labelled frame with
`evaluate_posetrack_ap`, a copy of poseval's evaluateAP (per-frame greedy
matching of poses by PCKh at 0.5 of 0.6 x the head box's diagonal,
per-joint average precision, the Head/Shou/Elb/Wri/Hip/Knee/Ankl/Total
table in percent). `PoseTrackVideoDataset` (:220-297) gives PoseWarper its
windows: the key frame first, then the supporting frames' paths and the
per-frame weights. All host numpy.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict, defaultdict

import numpy as np

from .topdown import TopDownDataset

# poseval's printed part groups over the PoseTrack joint order
# (nose, head_bottom, head_top, ears, shoulders, elbows, wrists, hips,
# knees, ankles)
PART_GROUPS = OrderedDict([
    ('Head AP', (0, 1, 2)),
    ('Shou AP', (5, 6)),
    ('Elb AP', (7, 8)),
    ('Wri AP', (9, 10)),
    ('Hip AP', (11, 12)),
    ('Knee AP', (13, 14)),
    ('Ankl AP', (15, 16)),
])


def _head_size(bbox_head):
    """poseval eval_helpers.getHeadSize: 0.6 * diagonal of the head box."""
    x1, y1, w, h = bbox_head
    return 0.6 * float(np.linalg.norm([w, h]))


def _voc_ap(scores, tp, n_gt):
    """Average precision over score-ranked detections (poseval
    computeMetrics PR accumulation)."""
    if n_gt == 0:
        return np.nan
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores), kind='mergesort')
    tp = np.asarray(tp, np.float64)[order]
    fp = 1.0 - tp
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    # precision envelope + area under PR
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    ap = 0.0
    prev_r = 0.0
    for r, p in zip(recall, precision):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)


def evaluate_posetrack_ap(gt_frames, pred_frames, dist_thresh=0.5,
                          num_joints=17):
    """poseval-style per-frame multi-person AP (evaluateAP).

    Args:
      gt_frames: list over frames; each a list of dicts
        {joints [K, 3] (x, y, vis), head_size float}.
      pred_frames: list over frames; each a list of dicts
        {joints [K, 3] (x, y, per-joint score)}.

    Per frame, predictions are greedily matched to GT poses by PCKh score
    (fraction of annotated joints within dist_thresh * head_size); matched
    visible joints are TPs for their keypoint class, everything else a FP.
    Returns OrderedDict of grouped APs (%) + 'Total AP'.
    """
    scores = [[] for _ in range(num_joints)]
    tps = [[] for _ in range(num_joints)]
    n_gt = np.zeros(num_joints, np.int64)

    for gts, preds in zip(gt_frames, pred_frames):
        for g in gts:
            vis = np.asarray(g['joints'])[:, 2] > 0
            n_gt[:len(vis)] += vis.astype(np.int64)
        if not preds:
            continue
        P, G = len(preds), len(gts)
        # per (pred, gt): joint matches + pose-level pck
        match = np.zeros((P, G, num_joints), bool)
        pck = np.zeros((P, G))
        for pi, p in enumerate(preds):
            pj = np.asarray(p['joints'], np.float64)
            for gi, g in enumerate(gts):
                gj = np.asarray(g['joints'], np.float64)
                vis = gj[:, 2] > 0
                if not vis.any():
                    continue
                d = np.linalg.norm(pj[:, :2] - gj[:, :2], axis=1)
                m = (d <= dist_thresh * max(g['head_size'], 1e-6)) & vis
                match[pi, gi] = m
                pck[pi, gi] = m.sum() / vis.sum()
        # greedy assignment by descending pck
        assigned_g = set()
        assign = {}
        order = np.dstack(np.unravel_index(
            np.argsort(-pck, axis=None), pck.shape))[0]
        for pi, gi in order:
            if pck[pi, gi] <= 0:
                break
            if pi in assign or gi in assigned_g:
                continue
            assign[pi] = gi
            assigned_g.add(gi)
        for pi, p in enumerate(preds):
            pj = np.asarray(p['joints'], np.float64)
            gi = assign.get(pi)
            for j in range(num_joints):
                if pj[j, 2] <= 0:          # joint not predicted
                    continue
                if gi is not None and np.asarray(
                        gts[gi]['joints'])[j, 2] > 0:
                    scores[j].append(pj[j, 2])
                    tps[j].append(bool(match[pi, gi, j]))
                else:
                    scores[j].append(pj[j, 2])
                    tps[j].append(False)

    per_joint = np.array([_voc_ap(scores[j], tps[j], n_gt[j])
                          for j in range(num_joints)])
    stats = OrderedDict()
    valid_all = []
    for name, idxs in PART_GROUPS.items():
        vals = [per_joint[i] for i in idxs if not np.isnan(per_joint[i])]
        stats[name] = float(np.mean(vals) * 100) if vals else 0.0
        valid_all.extend(vals)
    stats['Total AP'] = float(np.mean(valid_all) * 100) if valid_all else 0.0
    return stats


class PoseTrackDataset(TopDownDataset):
    """PoseTrack18 frames (COCO format, on a 1920-pixel canvas by default)
    and their sequence evaluation."""

    def __init__(self, ann_file, img_prefix, dataset_info='posetrack18',
                 canvas_size=1920, **kw):
        super().__init__(ann_file, img_prefix, dataset_info=dataset_info,
                         canvas_size=canvas_size, **kw)

    def evaluate(self, results, res_folder=None, metric='mAP',
                 rle_score=False, **kw):
        """Rescoring + OKS-NMS, per-video json writing, poseval-style AP."""
        metrics = (list(metric) if isinstance(metric, (list, tuple))
                   else [metric])
        for m in metrics:
            if m != 'mAP':
                raise KeyError(f'metric {m} is not supported '
                               '(PoseTrack evaluates poseval mAP)')
        detections = self._collect_detections(results, None, rle_score)
        by_image = defaultdict(list)
        for det in detections:
            by_image[det['image_id']].append(det)

        # group images per video (vid_id field of the PoseTrack jsons)
        videos = defaultdict(list)
        for img_id, img in self.coco.imgs.items():
            videos[img.get('vid_id', 'seq')].append(img_id)

        if res_folder is not None:
            os.makedirs(res_folder, exist_ok=True)
            for vid, img_ids in videos.items():
                out = dict(images=[], annotations=[])
                for img_id in sorted(img_ids):
                    im = self.coco.imgs[img_id]
                    out['images'].append(dict(
                        id=img_id, file_name=im['file_name']))
                    for tid, det in enumerate(by_image.get(img_id, [])):
                        kp = np.asarray(det['keypoints']).reshape(-1, 3)
                        out['annotations'].append(dict(
                            image_id=img_id,
                            keypoints=kp.flatten().tolist(),
                            scores=kp[:, 2].tolist(),
                            score=det['score'], track_id=tid))
                with open(os.path.join(res_folder, f'{vid}.json'), 'w') as f:
                    json.dump(out, f)

        # build gt/pred frame lists over all labeled frames
        gt_frames, pred_frames = [], []
        k = self.num_joints
        for vid, img_ids in videos.items():
            for img_id in sorted(img_ids):
                if not self.coco.imgs[img_id].get('is_labeled', True):
                    continue
                gts = []
                for ann in self.coco.loadAnns(
                        self.coco.getAnnIds(imgIds=img_id)):
                    if 'keypoints' not in ann or 'bbox_head' not in ann:
                        continue
                    kp = np.asarray(ann['keypoints'],
                                    np.float32).reshape(-1, 3)
                    if kp.shape[0] != k or (kp[:, 2] > 0).sum() == 0:
                        continue
                    gts.append(dict(joints=kp,
                                    head_size=_head_size(ann['bbox_head'])))
                preds = [dict(joints=np.asarray(det['keypoints'],
                                                np.float32).reshape(-1, 3))
                         for det in by_image.get(img_id, [])]
                gt_frames.append(gts)
                pred_frames.append(preds)
        return evaluate_posetrack_ap(gt_frames, pred_frames,
                                     num_joints=k)


class PoseTrackVideoDataset(PoseTrackDataset):
    """PoseTrack18 video dataset for PoseWarper: each record carries the
    key frame plus supporting-frame paths and per-frame weights
    (reference TopDownPoseTrack18VideoDataset,
    topdown_posetrack18_video_dataset.py:25; frame selection :197-227).

    Supporting frames are ``ref_idx + index`` clipped to [0, nframes-1]
    and zero-filled to ``ph_fill_len`` digits; a missing frame file falls
    back to the key frame (reference :216-222). In test mode index 0 is
    skipped because the key frame is always first in ``image_files``.
    """

    def __init__(self, ann_file, img_prefix, dataset_info='posetrack18',
                 frame_indices_test=(-2, -1, 0, 1, 2),
                 frame_indices_train=None, frame_index_rand=True,
                 frame_index_range=(-2, 2), num_adj_frames=1,
                 frame_weight_train=(0.0, 1.0),
                 frame_weight_test=(0.3, 0.1, 0.25, 0.25, 0.1),
                 ph_fill_len=6, seed=0, **kw):
        # frame-selection state must exist before super().__init__ builds
        # the db (it calls back into _load_db -> _attach_frames)
        self.frame_indices_test = sorted(frame_indices_test)
        self.frame_indices_train = (sorted(frame_indices_train)
                                    if frame_indices_train else None)
        self.frame_index_rand = frame_index_rand
        self.frame_index_range = frame_index_range
        self.num_adj_frames = num_adj_frames
        self.frame_weight_train = tuple(frame_weight_train)
        self.frame_weight_test = tuple(frame_weight_test)
        self.ph_fill_len = ph_fill_len
        self._frame_rng = np.random.RandomState(seed)
        super().__init__(ann_file, img_prefix, dataset_info=dataset_info,
                         **kw)

    @property
    def num_frames(self):
        """Static window length T (key frame + supports)."""
        return len(self.db[0]['image_files']) if self.db else 1

    def _load_db(self):
        db = super()._load_db()
        for rec in db:
            self._attach_frames(rec)
        return db

    def _attach_frames(self, rec):
        key_file = rec['image_file']
        rel = key_file[len(self.img_prefix):].lstrip('/')
        img_id = (self.name2id[rel] if rel in self.name2id
                  else self.name2id[os.path.basename(rel)])
        img = self.coco.imgs[img_id]
        nframes = int(img.get('nframes', 1))
        cur_name = os.path.basename(key_file)
        ref_idx = int(os.path.splitext(cur_name)[0])
        if not self.test_mode and self.frame_indices_train is not None:
            indices = self.frame_indices_train
        elif not self.test_mode and self.frame_index_rand:
            low, high = self.frame_index_range
            indices = self._frame_rng.randint(low, high + 1,
                                              self.num_adj_frames)
        else:
            indices = self.frame_indices_test
        files = [key_file]
        for index in indices:
            if self.test_mode and index == 0:
                continue
            sup_idx = int(np.clip(ref_idx + index, 0, nframes - 1))
            sup_file = key_file.replace(
                cur_name, str(sup_idx).zfill(self.ph_fill_len) + '.jpg')
            files.append(sup_file if os.path.exists(sup_file) else key_file)
        rec['image_files'] = files
        rec['nframes'] = nframes
        rec['frame_id'] = img.get('frame_id', img_id)
        fw = np.asarray(self.frame_weight_test if self.test_mode
                        else self.frame_weight_train, np.float32)
        if len(fw) != len(files):   # window length diverges from the
            fw = np.full((len(files),), 1.0 / len(files), np.float32)
        rec['frame_weight'] = fw

"""Top-down COCO-style keypoint dataset: record db + evaluation.

The port's own copy of vitpose_tpu/data/topdown.py:31-489 `TopDownDataset`
(reference mmpose/datasets/datasets/top_down/topdown_coco_dataset.py:169 and
its base, kpt_2d_sview_rgb_img_top_down_dataset.py:17): the GT and detection
record dbs with the reference's bbox clip conventions, and `evaluate` (COCO
OKS mAP through rescoring, OKS NMS and `CocoKeypointEval`; the PCK, PCKh,
AUC, EPE and NME protocols), all host numpy. Records carry bbox geometry and
joints; the crop, normalisation and targets happen on the device.

Record fields mirror the reference db entries (image_file, center, scale,
bbox, rotation, joints_3d, joints_3d_visible, bbox_score, bbox_id,
dataset_idx).
"""
from __future__ import annotations

import copy
import json
import os
from collections import OrderedDict, defaultdict
from typing import List, Optional

import numpy as np

from .coco_index import CocoIndex
from .dataset_info import DatasetInfo
from ..ops.nms import oks_nms, soft_oks_nms
from ..ops.decode import (keypoint_pck_accuracy, keypoint_auc, keypoint_epe,
                          keypoint_nme)
from ..eval.cocoeval import CocoKeypointEval

# NME normalization landmark pairs (inter-ocular / nose-eye distance) per
# dataset (reference face_300w_dataset.py:122, face_cofw_dataset.py:121,
# face_wflw_dataset.py:121, animal_horse10_dataset.py:105). AFLW and other
# datasets normalize by the per-record `box_size` instead
# (face_aflw_dataset.py:130; the base class default factor is 1).
_NME_LANDMARKS = {'300w': (36, 45), 'coco_wholebody_face': (36, 45),
                  'cofw': (8, 9), 'wflw': (60, 72), 'horse10': (0, 1)}

# bbox clip conventions (see _load_gt_db): datasets whose reference
# kernels clip with x1+max(0, w-1)
_CLIP_W_MINUS1 = {'coco_wholebody', 'posetrack18', 'jhmdb', 'macaque',
                  'animalpose', 'atrw', 'ap10k', 'apt36k'}
# datasets whose reference loaders use obj['bbox'] unclipped
_CLIP_NONE = {'300w', 'aflw', 'cofw', 'wflw', 'coco_wholebody_face',
              'coco_wholebody_hand', 'onehand10k', 'freihand2d', 'rhd2d',
              'panoptic_hand2d', 'interhand2d', 'deepfashion_upper',
              'deepfashion_lower', 'deepfashion_full', 'horse10', 'fly',
              'locust', 'zebra', 'mpii_trb'}


class TopDownDataset:
    """COCO-format top-down dataset.

    Args:
      ann_file: COCO json path.
      img_prefix: image directory.
      dataset_info: DatasetInfo or metadata name (e.g. 'coco').
      image_size: (w, h) network input.
      heatmap_size: (w, h) heatmap.
      use_gt_bbox: use GT boxes (else `bbox_file` detections).
      bbox_file: detection json (list of {image_id, bbox xywh, score,
        category_id}).
      det_bbox_thr: score threshold for detection boxes.
      test_mode: disables train-only filtering.
      dataset_idx: expert id for ViTPose+ multi-dataset training.
    """

    def __init__(self, ann_file, img_prefix, dataset_info='coco',
                 image_size=(192, 256), heatmap_size=(48, 64),
                 use_gt_bbox=True, bbox_file=None, det_bbox_thr=0.0,
                 test_mode=False, dataset_idx=0, max_num_joints=None,
                 soft_nms=False, nms_thr=1.0, oks_thr=0.9, vis_thr=0.2,
                 use_nms=True, canvas_size=640):
        # nms_thr is accepted for reference data_cfg compatibility but,
        # exactly like the reference TopDownCocoDataset, evaluation only
        # consumes oks_thr (oks_nms) — nms_thr belongs to the upstream
        # person detector.
        self.info = (dataset_info if isinstance(dataset_info, DatasetInfo)
                     else DatasetInfo.load(dataset_info))
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.image_size = np.array(image_size)
        self.heatmap_size = np.array(heatmap_size)
        self.use_gt_bbox = use_gt_bbox
        self.bbox_file = bbox_file
        self.det_bbox_thr = det_bbox_thr
        self.test_mode = test_mode
        self.dataset_idx = dataset_idx
        self.max_num_joints = max_num_joints
        self.soft_nms = soft_nms
        self.nms_thr = nms_thr
        self.oks_thr = oks_thr
        self.vis_thr = vis_thr
        self.use_nms = use_nms
        # static loader canvas; COCO images are <=640px, other sources set
        # a larger canvas so crops are sampled at native resolution
        self.canvas_size = canvas_size

        self.coco = CocoIndex(ann_file)
        self.id2name = {i: im['file_name'] for i, im in self.coco.imgs.items()}
        self.name2id = {v: k for k, v in self.id2name.items()}
        self.db = self._load_db()

    # ------------------------------------------------------------------
    @property
    def num_joints(self):
        return self.info.num_joints

    @property
    def sigmas(self):
        s = self.info.sigmas
        return s if len(s) else None

    def __len__(self):
        return len(self.db)

    def __getitem__(self, idx):
        return copy.deepcopy(self.db[idx])

    # ------------------------------------------------------------------
    def _load_db(self):
        if (not self.test_mode) or self.use_gt_bbox:
            return self._load_gt_db()
        return self._load_det_db()

    def _load_gt_db(self):
        k = self.num_joints
        db = []
        for img_id in self.coco.getImgIds():
            img = self.coco.imgs[img_id]
            width, height = img['width'], img['height']
            bbox_id = 0
            for ann in self.coco.loadAnns(
                    self.coco.getAnnIds(imgIds=img_id, iscrowd=False)):
                if 'bbox' not in ann or 'keypoints' not in ann:
                    continue
                # clip box to the image, drop degenerate/empty ones.
                # Three reference conventions:
                #   * COCO's kernel clips with x1+max(0,w)
                #     (topdown_coco_dataset.py:303), inherited by aic/
                #     crowdpose/ochuman/halpe/mhp/h36m;
                #   * wholebody/jhmdb/posetrack18(video)/macaque/
                #     animalpose/atrw/ap10k re-define it with
                #     x1+max(0,w-1) (grep "max(0, w - 1)");
                #   * face/hand/fashion/lab-animal datasets do NOT clip —
                #     obj['bbox'] feeds _xywh2cs directly
                #     (e.g. face_300w_dataset.py:91).
                name = self.info.dataset_name
                # COCO-WholeBody part subsets read the part's OWN keypoints
                # and box (reference face_coco_wholebody_dataset.py /
                # hand_coco_wholebody_dataset.py: face_valid + face_box,
                # {left,right}hand_valid + boxes — one record per valid
                # hand); every other dataset reads ann['bbox'] +
                # ann['keypoints']
                if name == 'coco_wholebody_face':
                    variants = [(list(ann['face_kpts']), ann['face_box'])] \
                        if (ann.get('face_valid')
                            and max(ann.get('face_kpts', [0])) > 0) else []
                elif name == 'coco_wholebody_hand':
                    variants = [
                        (list(ann[f'{s}hand_kpts']), ann[f'{s}hand_box'])
                        for s in ('left', 'right')
                        if (ann.get(f'{s}hand_valid')
                            and max(ann.get(f'{s}hand_kpts', [0])) > 0)]
                else:
                    if max(ann['keypoints']) == 0:
                        continue
                    if ann.get('num_keypoints', 1) == 0:
                        continue
                    kp_list = list(ann['keypoints'])
                    # COCO-WholeBody splits keypoints across part fields
                    # (reference topdown_coco_wholebody_dataset.py
                    # concatenates body+foot+face+lefthand+righthand)
                    if len(kp_list) // 3 < k:
                        for part in ('foot_kpts', 'face_kpts',
                                     'lefthand_kpts', 'righthand_kpts'):
                            if part in ann:
                                kp_list = kp_list + list(ann[part])
                    variants = [(kp_list, ann['bbox'])]
                for kp_list, box in variants:
                    x, y, w, h = box
                    if name in _CLIP_NONE:
                        if w <= 0 or h <= 0:
                            continue
                        x1, y1, x2, y2 = x, y, x + w, y + h
                    else:
                        m1 = 1 if name in _CLIP_W_MINUS1 else 0
                        x1, y1 = max(0, x), max(0, y)
                        x2 = min(width - 1, x1 + max(0, w - m1))
                        y2 = min(height - 1, y1 + max(0, h - m1))
                        if ann.get('area', 1) <= 0 or x2 <= x1 or y2 <= y1:
                            continue
                    if len(kp_list) // 3 != k:
                        continue
                    kp = np.asarray(kp_list, np.float32).reshape(-1, 3)
                    joints = np.zeros((k, 3), np.float32)
                    visible = np.zeros((k, 3), np.float32)
                    joints[:, :2] = kp[:, :2]
                    visible[:, :2] = np.minimum(1, kp[:, 2:3])
                    rec = dict(
                        image_file=os.path.join(self.img_prefix,
                                                self.id2name[img_id]),
                        bbox=np.array([x1, y1, x2 - x1, y2 - y1],
                                      np.float32),
                        rotation=0.0,
                        joints_3d=joints,
                        joints_3d_visible=visible,
                        dataset=self.info.dataset_name,
                        dataset_idx=self.dataset_idx,
                        bbox_score=1.0,
                        bbox_id=bbox_id,
                        category_id=ann.get('category_id', 1),
                    )
                    # face-zoo annotations carry an explicit center/
                    # scale (reference face_300w_dataset.py:87-89: center
                    # as-is, scalar scale -> [s, s] * 1.25); records with
                    # center/scale bypass the loader's bbox->cs
                    # derivation. The 1.25 padding is a FACE convention —
                    # other mmpose jsons that carry center/scale (e.g.
                    # mpii_trb) store it pre-padded and are used as-is.
                    if 'center' in ann and 'scale' in ann:
                        pad = (1.25 if self.info.dataset_name in
                               ('300w', 'aflw', 'cofw', 'wflw',
                                'coco_wholebody_face') else 1.0)
                        rec['center'] = np.asarray(ann['center'],
                                                   np.float32)
                        rec['scale'] = (np.asarray(
                            [ann['scale'], ann['scale']]
                            if np.isscalar(ann['scale'])
                            else ann['scale'], np.float32) * pad)
                    # PCKh / AFLW-NME normalizers when annotated
                    if 'head_size' in ann:
                        rec['head_size'] = float(ann['head_size'])
                    if 'box_size' in ann:
                        rec['box_size'] = float(ann['box_size'])
                    db.append(rec)
                    bbox_id += 1
        return db

    def _load_det_db(self):
        with open(self.bbox_file) as f:
            boxes = json.load(f)
        if isinstance(boxes, dict):
            boxes = boxes['annotations']
        k = self.num_joints
        db = []
        bbox_id = 0
        for det in boxes:
            if det.get('category_id', 1) != 1:
                continue
            score = det.get('score', 1.0)
            if score < self.det_bbox_thr:
                continue
            db.append(dict(
                image_file=os.path.join(self.img_prefix,
                                        self.id2name[det['image_id']]),
                bbox=np.asarray(det['bbox'][:4], np.float32),
                rotation=0.0,
                joints_3d=np.zeros((k, 3), np.float32),
                joints_3d_visible=np.ones((k, 3), np.float32),
                dataset=self.info.dataset_name,
                dataset_idx=self.dataset_idx,
                bbox_score=float(score),
                bbox_id=bbox_id,
            ))
            bbox_id += 1
        return db

    # ------------------------------------------------------------------
    # evaluation (reference: topdown_coco_dataset.py:406 `evaluate`)
    # ------------------------------------------------------------------
    def evaluate(self, results, res_folder=None, metric='mAP',
                 rle_score=False, pck_thr=0.2, pckh_thr=0.7, auc_nor=30):
        """results: list of dicts with
          preds [N, K, 3], boxes [N, 6] (c0, c1, s0, s1, area, score),
          image_paths (list[str]), bbox_ids (list[int]).

        metric: 'mAP' (COCO OKS AP via rescoring+NMS+COCOeval) and/or the
        reference _report_metric protocols 'PCK'/'PCKh'/'AUC'/'EPE'/'NME'
        serving the face/hand/fashion/animal zoo
        (kpt_2d_sview_rgb_img_top_down_dataset.py:191). A string or list.

        rle_score: RLE-style rescoring box + mean + max keypoint confidence
        (reference topdown_coco_dataset.py:483-486) instead of the default
        mean-over-visible rescoring.
        Returns OrderedDict of metric values.
        """
        metrics = list(metric) if isinstance(metric, (list, tuple)) \
            else [metric]
        allowed = {'mAP', 'PCK', 'PCKh', 'AUC', 'EPE', 'NME'}
        for m in metrics:
            if m not in allowed:
                raise KeyError(f'metric {m} is not supported')
        stats = OrderedDict()
        if 'mAP' in metrics:
            stats.update(self._evaluate_map(results, res_folder, rle_score))
        kp_metrics = [m for m in metrics if m != 'mAP']
        if kp_metrics:
            stats.update(self._report_metric(
                results, kp_metrics, pck_thr=pck_thr, pckh_thr=pckh_thr,
                auc_nor=auc_nor))
        return stats

    def _path_to_id(self, path):
        # full relative path FIRST (the reference keys on
        # path[len(img_prefix):]); the basename fallback only serves
        # flat-file jsons — trying it first would let a colliding flat
        # file_name shadow a nested one
        rel = path[len(self.img_prefix):].lstrip('/')
        if rel in self.name2id:
            return self.name2id[rel]
        return self.name2id[os.path.basename(rel)]

    def _report_metric(self, results, metrics, pck_thr=0.2, pckh_thr=0.7,
                       auc_nor=30):
        """PCK/PCKh/AUC/EPE/NME over db-ordered predictions (reference
        kpt_2d_sview_rgb_img_top_down_dataset.py:191-268)."""
        by_key = {}
        for result in results:
            preds = np.asarray(result['preds'])
            for i, (path, bid) in enumerate(zip(result['image_paths'],
                                                result['bbox_ids'])):
                by_key[(self._path_to_id(path), int(bid))] = preds[i]

        outputs, gts, masks = [], [], []
        thr_bbox, thr_head, box_sizes = [], [], []
        for rec in self.db:
            key = (self._path_to_id(rec['image_file']), int(rec['bbox_id']))
            pred = by_key[key]
            outputs.append(pred[:, :2])
            gts.append(rec['joints_3d'][:, :2])
            masks.append(rec['joints_3d_visible'][:, 0] > 0)
            if 'PCK' in metrics:
                t = np.max(rec['bbox'][2:4])
                thr_bbox.append([t, t])
            if 'PCKh' in metrics:
                t = rec['head_size']
                thr_head.append([t, t])
            box_sizes.append(rec.get('box_size', 1))
        outputs = np.asarray(outputs, np.float32)
        gts = np.asarray(gts, np.float32)
        masks = np.asarray(masks, bool)
        box_sizes = np.asarray(box_sizes, np.float32).reshape(-1, 1)

        info = OrderedDict()
        if 'PCK' in metrics:
            _, pck, _ = keypoint_pck_accuracy(
                outputs, gts, masks, pck_thr, np.asarray(thr_bbox))
            info['PCK'] = float(pck)
        if 'PCKh' in metrics:
            _, pckh, _ = keypoint_pck_accuracy(
                outputs, gts, masks, pckh_thr, np.asarray(thr_head))
            info['PCKh'] = float(pckh)
        if 'AUC' in metrics:
            info['AUC'] = float(keypoint_auc(outputs, gts, masks, auc_nor))
        if 'EPE' in metrics:
            info['EPE'] = float(keypoint_epe(outputs, gts, masks))
        if 'NME' in metrics:
            name = self.info.dataset_name
            if name in _NME_LANDMARKS:
                a, b = _NME_LANDMARKS[name]
                inter = np.linalg.norm(gts[:, a] - gts[:, b], axis=1,
                                       keepdims=True)
                factor = np.tile(inter, [1, 2])
            else:
                # box_size normalization (AFLW protocol) — hard-fail when
                # the annotations don't carry it: a silent 1.0 fallback
                # would report raw pixel error as "NME"
                if not all('box_size' in rec for rec in self.db):
                    raise KeyError(
                        f"NME for dataset '{name}' normalizes by the "
                        f"per-record 'box_size' annotation, which is "
                        f"missing from this json (reference "
                        f"face_aflw_dataset.py:130)")
                factor = np.tile(box_sizes, [1, 2])
            info['NME'] = float(keypoint_nme(outputs, gts, masks, factor))
        return info

    def _collect_detections(self, results, res_folder=None, rle_score=False):
        """results -> rescoring + oks-nms'd detection dicts (the shared
        front half of the reference evaluate, topdown_coco_dataset.py:449)."""
        kpts = defaultdict(list)
        for result in results:
            preds = np.asarray(result['preds'])
            boxes = np.asarray(result['boxes'])
            paths = result['image_paths']
            bbox_ids = result['bbox_ids']
            for i in range(len(paths)):
                image_id = self._path_to_id(paths[i])
                kpts[image_id].append(dict(
                    keypoints=preds[i],
                    center=boxes[i][0:2], scale=boxes[i][2:4],
                    area=boxes[i][4], score=boxes[i][5],
                    image_id=image_id, bbox_id=bbox_ids[i]))
        # de-dup by bbox_id, sort
        for image_id, items in kpts.items():
            items.sort(key=lambda x: x['bbox_id'])
            seen, uniq = set(), []
            for it in items:
                if it['bbox_id'] not in seen:
                    seen.add(it['bbox_id'])
                    uniq.append(it)
            kpts[image_id] = uniq

        # keypoint-confidence rescoring + oks nms
        valid = []
        for image_id, items in kpts.items():
            for p in items:
                conf = p['keypoints'][:, 2]
                if rle_score:
                    p['score'] = float(p['score'] + conf.mean()
                                       + conf.max())
                else:
                    sel = conf > self.vis_thr
                    kpt_score = conf[sel].mean() if sel.any() else 0.0
                    p['score'] = float(kpt_score * p['score'])
            if self.use_nms:
                nms = soft_oks_nms if self.soft_nms else oks_nms
                keep = nms(items, self.oks_thr, sigmas=self.sigmas)
                valid.append([items[i] for i in keep])
            else:
                valid.append(items)

        cat_by_key = {(self._path_to_id(r['image_file']),
                       int(r['bbox_id'])): int(r.get('category_id', 1))
                      for r in self.db}
        detections = []
        for items in valid:
            for p in items:
                kp = np.asarray(p['keypoints'], np.float64)
                detections.append(dict(
                    image_id=int(p['image_id']),
                    # per-record category (multi-species datasets like
                    # AP-10K evaluate per category, reference
                    # animal_ap10k_dataset.py:329)
                    category_id=cat_by_key.get(
                        (int(p['image_id']), int(p['bbox_id'])), 1),
                    keypoints=kp.flatten().tolist(),
                    score=float(p['score']),
                    center=np.asarray(p['center']).tolist(),
                    scale=np.asarray(p['scale']).tolist(),
                ))
        if res_folder is not None:
            os.makedirs(res_folder, exist_ok=True)
            with open(os.path.join(res_folder,
                                   'result_keypoints.json'), 'w') as f:
                json.dump(detections, f)
        return detections

    def _evaluate_map(self, results, res_folder=None, rle_score=False):
        detections = self._collect_detections(results, res_folder, rle_score)
        if 'annotations' not in self.coco.dataset:
            return OrderedDict()
        coco_dt = self.coco.loadRes(detections)
        if self.info.dataset_name == 'crowdpose':
            # CrowdPose protocol: no-area OKS + AP over easy/medium/hard
            # crowdIndex subsets (reference topdown_crowdpose_dataset.py:95
            # iouType='keypoints_crowd')
            from ..eval.cocoeval import evaluate_crowdpose
            return OrderedDict(evaluate_crowdpose(self.coco, coco_dt,
                                                  sigmas=self.sigmas))
        # AIC/MHP evaluate with use_area=False (OKS normalized by
        # bbox w*h*0.53 even when an 'area' field is present — reference
        # topdown_aic_dataset.py / topdown_mhp_dataset.py
        # _do_python_keypoint_eval pass use_area=False)
        use_area = self.info.dataset_name not in ('aic', 'mhp')
        evaluator = CocoKeypointEval(self.coco, sigmas=self.sigmas,
                                     use_area=use_area)
        stats = evaluator.evaluate(coco_dt)
        return OrderedDict(stats)

    def evaluate_per_kpts(self, results):
        """Per-keypoint AP sensitivity: re-evaluate with each keypoint's OKS
        sigma inflated to 10.0 in turn (fork's evaluate_per_kpts,
        topdown_coco_dataset.py:391). Returns a list of stats dicts, one per
        keypoint."""
        base = np.asarray(self.sigmas if self.sigmas is not None
                          else np.full(self.num_joints, 0.05), np.float64)
        out = []
        saved = self.info.sigmas
        try:
            for i in range(self.num_joints):
                s = base.copy()
                s[i] = 10.0
                self.info.sigmas = s
                out.append(self.evaluate(results))
        finally:
            self.info.sigmas = saved
        return out

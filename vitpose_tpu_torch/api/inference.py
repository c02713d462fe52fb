"""User-facing top-down inference API, in PyTorch.

Counterpart of the top-down part of vitpose_tpu/api/inference.py
(`PoseModel`, `init_pose_model`, `inference_top_down_pose_model` with its
deprecated `dataset=` selector and `outputs=` capture, `_bucket`,
`process_mmdet_results`, `vis_pose_result`, `imshow_bboxes`) with the same
call signatures, minus the JAX-only parts (jit caches, the `variables`
argument). Drawing runs on the host with cv2, as in the JAX package.

Entry points run on CUDA unless the caller passes ``device='cpu'``; asking
for CUDA on a machine without it raises. Person boxes are cropped in one
batched warp on the device, the flip test and the UDP decode run there too,
and box batches are padded to bucket sizes as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..data.dataset_info import DatasetInfo
from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..models.topdown import TopDownConfig, TopDownModel, infer, make_config
from ..models.vit import VIT_VARIANTS, compute_dtype
from ..ops.decode import keypoints_from_heatmaps
from ..ops.geometry import (affine_matrix, bbox_xywh2cs, bbox_xyxy2xywh,
                            udp_warp_matrix)
from ..ops.warp import warp_affine_batch
from ..train.loop import topdown_config
from ..utils.config import load_config
from ..utils.torch_ckpt import checkpoint_state_dict

_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _bucket(n):
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device!r} was asked for but CUDA is not '
                           "available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class PoseModel:
    """Bundle returned by init_pose_model: the module, its config, the
    dataset metadata and the crop geometry, all on one device."""
    model: TopDownModel
    cfg: TopDownConfig
    dataset_info: DatasetInfo
    image_size: tuple                # (w, h)
    heatmap_size: tuple
    device: torch.device
    padding: float = 1.25

    def __post_init__(self):
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self._flip_index = {}

    def flip_index_tensor(self, flip_index=None):
        """The flip permutation as a tensor on the model's device."""
        if flip_index is None:
            flip_index = self.dataset_info.flip_index
        key = tuple(int(i) for i in flip_index)
        if key not in self._flip_index:
            self._flip_index[key] = torch.tensor(key, device=self.device)
        return self._flip_index[key]

    @torch.inference_mode()
    def infer_batch(self, imgs, center, scale, return_heatmap=False,
                    flip_index=None, flip=True):
        """Warp, normalise, model (+ flip test unless `flip` is False) and
        decode, on the device.

        Counterpart of the JAX `infer_fn(n, ...)(variables, imgs, center,
        scale)`. imgs: [N, H, W, 3] uint8 on the model's device, where the N
        rows may alias one image (an `expand` view, stride 0), which is then
        converted once; center, scale: [N, 2] float32 on the same device.
        Returns (preds [N, K, 2], maxvals [N, K, 1]) and, with
        `return_heatmap`, the [N, K, h, w] heatmaps.
        """
        cfg = self.cfg
        iw, ih = self.image_size
        n = center.shape[0]
        if imgs.stride(0) == 0:
            x = (imgs[:1].float() / 255.0).expand(n, -1, -1, -1)
        else:
            x = imgs.float() / 255.0
        rot = torch.zeros(n, device=center.device)
        if cfg.use_udp:
            mat = udp_warp_matrix(rot, center, scale, (iw, ih))
        else:
            mat = affine_matrix(center, scale, rot, (iw, ih))
        crops = warp_affine_batch(x, mat, (iw, ih))
        crops = (crops - self._mean) / self._std
        hm = infer(self.model, crops,
                   flip_index=self.flip_index_tensor(flip_index)
                   if flip else None)
        preds, maxvals = keypoints_from_heatmaps(
            hm, center, scale, post_process=cfg.post_process,
            kernel=cfg.modulate_kernel, use_udp=cfg.use_udp,
            target_type=cfg.target_type)
        if return_heatmap:
            return preds, maxvals, hm
        return preds, maxvals


def load_checkpoint(model: TopDownModel, checkpoint: str):
    """Load weights into `model`: an .npz written by the JAX package, or a
    .pth (mmpose names; a {'state_dict' | 'model' | 'module'} container and
    a 'module.' prefix are taken off) whose pos embed is regridded and whose
    patch kernel is padded to the model's geometry (counterpart of the JAX
    `load_checkpoint_variables`, vitpose_tpu/api/inference.py:97-120)."""
    model.load_state_dict(
        checkpoint_state_dict(checkpoint, model.cfg.backbone), strict=True)


def init_pose_model(config, checkpoint: Optional[str] = None,
                    device: str = 'cuda') -> PoseModel:
    """Build a PoseModel from a config and an optional checkpoint.

    `config` may be a config FILE path (a top-down config of the zoo, read
    with `utils.config.load_config`; its `model` dict builds the model and
    its `data.dataset` names the metadata), a variant string ('s', 'b', 'l',
    'h'), a dict such as {'variant': 'b', 'image_size': (192, 256), 'dtype':
    'bfloat16', 'backbone_overrides': {'fused_attention': True}}, a config
    file's `model` dict (one that names 'backbone_type' or 'family';
    `img_size` is (h, w) there), or a TopDownConfig. Without a checkpoint
    the weights are random, drawn on the CPU from a torch.Generator seeded
    with 0, so every device gets the same ones.
    """
    dev = _device(device)
    dataset_name, padding = 'coco', 1.25
    model_dict = None
    if isinstance(config, str) and config.endswith('.py') \
            and os.path.exists(config):
        full = load_config(config)
        model_dict = full['model']
        dataset_name = full.get('data', {}).get('dataset', 'coco')
    elif isinstance(config, dict) and ('backbone_type' in config
                                       or 'family' in config):
        model_dict = dict(config)
        dataset_name = model_dict.pop('dataset', 'coco')
        padding = model_dict.pop('padding', 1.25)

    if model_dict is not None:
        cfg = topdown_config(model_dict)
    elif isinstance(config, str) and config in VIT_VARIANTS:
        cfg = make_config(config, img_size=(256, 192), out_channels=17)
    elif isinstance(config, dict):
        c = dict(config)
        dataset_name = c.pop('dataset', 'coco')
        padding = c.pop('padding', 1.25)
        variant = c.pop('variant', 'b')
        wh = c.pop('image_size', (192, 256))
        overrides = c.pop('backbone_overrides', None)
        cfg = make_config(variant, img_size=(wh[1], wh[0]), **c)
        if overrides:
            cfg = dataclasses.replace(
                cfg, backbone=dataclasses.replace(cfg.backbone, **overrides))
    elif isinstance(config, TopDownConfig):
        cfg = config
    else:
        raise ValueError(f'unsupported config {config!r}: expected a config '
                         'file, a variant name, a dict or a TopDownConfig')

    model = TopDownModel(cfg, generator=torch.Generator().manual_seed(0))
    if checkpoint is not None:
        load_checkpoint(model, checkpoint)
    model = model.to(dev).eval()
    ih, iw = cfg.backbone.img_size
    return PoseModel(model=model, cfg=cfg,
                     dataset_info=DatasetInfo.load(dataset_name),
                     image_size=(iw, ih), heatmap_size=(iw // 4, ih // 4),
                     device=dev, padding=padding)


def _select_boxes(person_results, bbox_thr, fmt):
    """[M, 5] xywh+score boxes and the indices that pass `bbox_thr`
    (vitpose_tpu/api/inference_3d.py:131-149)."""
    if len(person_results) == 0:
        return np.zeros((0, 5), np.float32), np.zeros(0, np.int64)
    bboxes = np.stack([
        np.pad(np.asarray(p['bbox'], np.float32)[:5],
               (0, max(0, 5 - len(np.asarray(p['bbox'])[:5]))),
               constant_values=1.0) for p in person_results])
    if fmt == 'xyxy':
        bboxes = bbox_xyxy2xywh(bboxes).numpy()
    keep = (np.arange(len(bboxes)) if bbox_thr is None
            else np.where(bboxes[:, 4] > bbox_thr)[0])
    return bboxes, keep


# deprecated reference dataset-class names -> metadata names (JAX
# vitpose_tpu/api/inference.py:194-225)
_DATASET_CLASS_TO_NAME = {
    'TopDownCocoDataset': 'coco',
    'TopDownOCHumanDataset': 'ochuman',
    'AnimalMacaqueDataset': 'macaque',
    'TopDownCocoWholeBodyDataset': 'coco_wholebody',
    'TopDownAicDataset': 'aic',
    'TopDownMpiiDataset': 'mpii',
    'TopDownMpiiTrbDataset': 'mpii_trb',
    'OneHand10KDataset': 'onehand10k',
    'FreiHandDataset': 'freihand2d',
    'PanopticDataset': 'panoptic_hand2d',
    'InterHand2DDataset': 'interhand2d',
    'Face300WDataset': '300w',
    'FaceAFLWDataset': 'aflw',
    'FaceCOFWDataset': 'cofw',
    'FaceWFLWDataset': 'wflw',
    'AnimalHorse10Dataset': 'horse10',
    'AnimalFlyDataset': 'fly',
    'AnimalLocustDataset': 'locust',
    'AnimalZebraDataset': 'zebra',
    'AnimalPoseDataset': 'animalpose',
    'AnimalAP10KDataset': 'ap10k',
    'TopDownCrowdPoseDataset': 'crowdpose',
    'TopDownJhmdbDataset': 'jhmdb',
    'TopDownHalpeDataset': 'halpe',
    'TopDownMhpDataset': 'mhp',
    'TopDownPoseTrack18Dataset': 'posetrack18',
    'TopDownH36MDataset': 'h36m',
    'DeepFashionDataset': 'deepfashion_full',
}

# a ViT block's modules, under the same paths in flax and in the port
_BLOCK_PARTS = ('norm1', 'attn', 'attn.qkv', 'attn.proj', 'norm2', 'mlp',
                'mlp.fc1', 'mlp.fc2')


def _flax_modules(model: TopDownModel):
    """{flax path: (torch module, NCHW output)} of the modules whose outputs
    `outputs=` captures."""
    bb = model.backbone
    mods = {'backbone': (bb, False), 'head': (model.keypoint_head, True),
            'backbone.last_norm': (bb.last_norm, False)}
    for i, blk in enumerate(bb.blocks):
        mods[f'backbone.blocks_{i}'] = (blk, False)
        for path in _BLOCK_PARTS:
            mods[f'backbone.blocks_{i}.{path}'] = (blk.get_submodule(path),
                                                   False)
    return mods


def _capture_intermediates(model: PoseModel, imgs_b, center, scale, outputs,
                           n):
    """The outputs of the modules named in `outputs` during one plain
    forward (no flip test) of the crops, the counterpart of the JAX
    `_capture_intermediates` (flax `capture_intermediates`): {flax path:
    array}, each with its first n rows. See inference_top_down_pose_model
    for the names and layouts."""
    names = set(outputs)
    every = _flax_modules(model.model)
    unknown = names - {path.split('.')[-1] for path in every}
    if unknown:
        parts = ', '.join(p.split('.')[-1] for p in _BLOCK_PARTS)
        raise ValueError(f'outputs {sorted(unknown)}: the port captures '
                         f'backbone, head, blocks_{{i}}, last_norm and '
                         f'{parts}, not flax\'s patch_embed or the head\'s '
                         'layers')
    mods = {path: m for path, m in every.items()
            if path.split('.')[-1] in names}
    dtype = compute_dtype(model.cfg.backbone.dtype)
    captured = {}

    def hook(path, nchw):
        def fn(module, args, out):
            out = out.to(dtype).float()
            if nchw:
                out = out.permute(0, 2, 3, 1)
            captured[path] = out[:n].cpu().numpy()
        return fn

    handles = [m.register_forward_hook(hook(path, nchw))
               for path, (m, nchw) in mods.items()]
    try:
        model.infer_batch(imgs_b, center, scale, flip=False)
    finally:
        for h in handles:
            h.remove()
    return captured


def inference_top_down_pose_model(model: PoseModel, img, person_results=None,
                                  bbox_thr: Optional[float] = None,
                                  format: str = 'xywh',
                                  dataset: Optional[str] = None,
                                  dataset_info: Optional[DatasetInfo] = None,
                                  return_heatmap: bool = False,
                                  outputs=None):
    """Top-down pose on one image given person boxes.

    `img` is an HWC uint8 RGB array or an image file path. `person_results`
    is a list of {'bbox': [x, y, w, h(, score)]} (or xyxy with
    format='xyxy'); None means one box over the whole image. `dataset` is
    the deprecated reference dataset-class selector (e.g.
    'TopDownCocoDataset'; it warns, and `dataset_info` wins).

    Returns (pose_results, returned_outputs): the input dicts extended with
    'keypoints' [K, 3]; returned_outputs is [] unless `return_heatmap` or
    `outputs` asks for one dict. `return_heatmap` adds 'heatmap' [N, K, h,
    w] (the flip-tested heatmaps). `outputs` names modules by their flax
    names, as the JAX package takes them; each captured output comes from
    one more forward without the flip test, as JAX's does, under the flax
    path as its key, in float32 (JAX returns the module dtype, bf16 for a
    bf16 model: the port's values are those bf16 values), with JAX's
    layout:
      * 'backbone' [N, Hp, Wp, D] NHWC;
      * 'head' [N, h, w, K] NHWC, the head's output before the model
        turns it to NCHW;
      * 'blocks_{i}' -> 'backbone.blocks_{i}' and 'last_norm' ->
        'backbone.last_norm', [N, T, D];
      * 'norm1', 'attn', 'norm2', 'mlp' ([N, T, D]), 'qkv' [N, T, 3D],
        'proj', 'fc1' [N, T, hidden], 'fc2': every block's, under
        'backbone.blocks_{i}.norm1', '...attn.qkv', '...mlp.fc1' and so on.
    Other names (flax's 'patch_embed', the head's layers) raise ValueError.
    """
    if format not in ('xywh', 'xyxy'):
        raise ValueError(f"format {format!r}: expected 'xywh' or 'xyxy'")
    if isinstance(img, str):
        import cv2
        img = cv2.cvtColor(cv2.imread(img), cv2.COLOR_BGR2RGB)
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f'img must be HWC uint8 RGB, got {img.shape} '
                         f'{img.dtype}')
    if person_results is None:
        h, w = img.shape[:2]
        person_results = [{'bbox': np.array([0, 0, w, h], np.float32)}]

    bboxes, sel = _select_boxes(person_results, bbox_thr, format)
    if len(sel) == 0:
        return [], []
    if dataset is not None and dataset_info is None:
        warnings.warn('dataset is deprecated; use dataset_info instead',
                      DeprecationWarning)
        dataset_info = DatasetInfo.load(_DATASET_CLASS_TO_NAME.get(
            dataset, dataset))
    info = dataset_info or model.dataset_info
    iw, ih = model.image_size
    center, scale = bbox_xywh2cs(bboxes[sel, :4], iw / ih,
                                 padding=model.padding)
    n = len(sel)
    nb = _bucket(n)
    center_p = torch.cat([center, center[-1:].expand(nb - n, 2)])
    scale_p = torch.cat([scale, scale[-1:].expand(nb - n, 2)])
    dev = model.device
    image = torch.from_numpy(img).to(dev)
    # every box gathers from the one shared image: a view, not nb copies
    imgs_b = image[None].expand(nb, *image.shape)
    out = model.infer_batch(imgs_b, center_p.to(dev), scale_p.to(dev),
                            return_heatmap=return_heatmap,
                            flip_index=info.flip_index)
    preds = out[0][:n].cpu().numpy()
    maxvals = out[1][:n].cpu().numpy()

    returned_outputs = []
    if return_heatmap or outputs:
        captured = {}
        if return_heatmap:
            captured['heatmap'] = out[2][:n].cpu().numpy()
        if outputs:
            captured.update(_capture_intermediates(
                model, imgs_b, center_p.to(dev), scale_p.to(dev), outputs,
                n))
        returned_outputs.append(captured)
    pose_results = []
    for i, si in enumerate(sel):
        res = dict(person_results[si])
        res['keypoints'] = np.concatenate([preds[i], maxvals[i]], axis=1)
        pose_results.append(res)
    return pose_results, returned_outputs


def process_mmdet_results(mmdet_results, cat_id: int = 1):
    """Person boxes from a detector's output, per class (an mmdet result
    list, or a (bbox, segm) tuple): [{'bbox': box}] of class `cat_id`."""
    det_results = (mmdet_results[0] if isinstance(mmdet_results, tuple)
                   else mmdet_results)
    return [{'bbox': bbox} for bbox in det_results[cat_id - 1]]


def _bgr(img):
    """A BGR copy of `img`: an image file path (read as cv2 reads it) or an
    RGB array."""
    import cv2
    if isinstance(img, str):
        return cv2.imread(img)
    return cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2BGR)


def vis_pose_result(model: Optional[PoseModel], img, result,
                    kpt_score_thr: float = 0.3, radius: int = 4,
                    thickness: int = 1,
                    dataset_info: Optional[DatasetInfo] = None,
                    show: bool = False, out_file: Optional[str] = None):
    """Draw each result's keypoints (score >= kpt_score_thr) and skeleton
    links in the dataset's colours on the image (an RGB array or a file
    path), with cv2 on the host as the JAX function does (JAX
    vitpose_tpu/api/inference.py:377-413). `dataset_info` defaults to the
    model's. Returns the BGR image and writes it to `out_file` if given;
    `show` is accepted and does nothing, as in JAX."""
    import cv2
    info = dataset_info or model.dataset_info
    img = _bgr(img).copy()
    links = info.skeleton_links
    kp_colors = info.keypoint_colors
    sk_colors = info.skeleton_colors
    for res in result:
        kpts = np.asarray(res['keypoints'])
        for j, (x, y, s) in enumerate(kpts):
            if s < kpt_score_thr:
                continue
            color = tuple(int(c) for c in (kp_colors[j] if len(kp_colors)
                                           else (0, 255, 0)))
            cv2.circle(img, (int(x), int(y)), radius, color, -1)
        for li, (a, b) in enumerate(links):
            if kpts[a, 2] < kpt_score_thr or kpts[b, 2] < kpt_score_thr:
                continue
            color = tuple(int(c) for c in (sk_colors[li] if len(sk_colors)
                                           else (255, 128, 0)))
            cv2.line(img, (int(kpts[a, 0]), int(kpts[a, 1])),
                     (int(kpts[b, 0]), int(kpts[b, 1])), color, thickness)
    if out_file:
        cv2.imwrite(out_file, img)
    return img


def imshow_bboxes(img, bboxes, labels=None, colors=(0, 255, 0), thickness=1,
                  out_file=None):
    """Draw xyxy boxes and optional labels on an image (an RGB array or a
    file path) with cv2 (JAX vitpose_tpu/api/inference.py:592). Returns the
    BGR image and writes it to `out_file` if given."""
    import cv2
    img = _bgr(img).copy()
    if isinstance(colors[0], int):
        colors = [colors] * len(bboxes)
    for i, bbox in enumerate(np.asarray(bboxes)):
        x0, y0, x1, y1 = bbox[:4].astype(int)
        cv2.rectangle(img, (x0, y0), (x1, y1), tuple(colors[i]), thickness)
        if labels is not None:
            cv2.putText(img, str(labels[i]), (x0, max(y0 - 2, 0)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, tuple(colors[i]), 1)
    if out_file:
        cv2.imwrite(out_file, img)
    return img

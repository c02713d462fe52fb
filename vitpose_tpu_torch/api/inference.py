"""User-facing top-down inference API, in PyTorch.

Counterpart of vitpose_tpu/api/inference.py (`PoseModel`, `init_pose_model`,
`inference_top_down_pose_model`, `_bucket`) with the same call signatures,
minus the JAX-only parts (jit caches, the `variables` argument, the
deprecated `dataset` selector and the `outputs=` capture).

Entry points run on CUDA unless the caller passes ``device='cpu'``; asking
for CUDA on a machine without it raises. Person boxes are cropped in one
batched warp on the device, the flip test and the UDP decode run there too,
and box batches are padded to bucket sizes as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..data.dataset_info import DatasetInfo
from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..models.topdown import TopDownConfig, TopDownModel, infer, make_config
from ..models.vit import VIT_VARIANTS
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
                    flip_index=None):
        """Warp, normalise, model (+ flip test) and decode, on the device.

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
                   flip_index=self.flip_index_tensor(flip_index))
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


def inference_top_down_pose_model(model: PoseModel, img, person_results=None,
                                  bbox_thr: Optional[float] = None,
                                  format: str = 'xywh',
                                  dataset_info: Optional[DatasetInfo] = None,
                                  return_heatmap: bool = False):
    """Top-down pose on one HWC uint8 RGB image given person boxes.

    `person_results` is a list of {'bbox': [x, y, w, h(, score)]} (or xyxy
    with format='xyxy'); None means one box over the whole image. Returns
    (pose_results, returned_outputs): the input dicts extended with
    'keypoints' [K, 3], and [{'heatmap': [N, K, h, w]}] with
    `return_heatmap`.
    """
    if format not in ('xywh', 'xyxy'):
        raise ValueError(f"format {format!r}: expected 'xywh' or 'xyxy'")
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
    if return_heatmap:
        returned_outputs.append({'heatmap': out[2][:n].cpu().numpy()})
    pose_results = []
    for i, si in enumerate(sel):
        res = dict(person_results[si])
        res['keypoints'] = np.concatenate([preds[i], maxvals[i]], axis=1)
        pose_results.append(res)
    return pose_results, returned_outputs

"""User-facing top-down and bottom-up inference API, in PyTorch.

Counterpart of vitpose_tpu/api/inference.py (`PoseModel`,
`init_pose_model`, `inference_top_down_pose_model` with its deprecated
`dataset=` selector and `outputs=` capture, `_bucket`,
`process_mmdet_results`, `vis_pose_result`, `imshow_bboxes`, and the
bottom-up `inference_bottom_up_pose_model` and
`inference_bottom_up_multi_scale`) with the same call signatures, minus the
JAX-only parts (jit caches, the `variables` argument). Drawing runs on the
host with cv2, as in the JAX package; so does bottom-up grouping, after the
model, the flip pass and the aggregation on the device.

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

from ..data.bottomup import read_rgb
from ..data.dataset_info import DatasetInfo
from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from ..models.bottomup import (BottomUpEstimator, aggregate_scale,
                               aggregate_stage_flip, flip_feature_maps,
                               split_ae_outputs)
from ..models.topdown import TopDownConfig, TopDownModel, infer, make_config
from ..models.vit import VIT_VARIANTS, compute_dtype
from ..ops.decode import keypoints_from_heatmaps, keypoints_from_regression
from ..ops.geometry import (affine_matrix, bbox_xywh2cs, bbox_xyxy2xywh,
                            udp_warp_matrix)
from ..ops.nms import oks_nms
from ..ops.warp import warp_affine_batch
from ..train.loop import build_model_from_cfg
from ..utils.config import load_config
from ..utils.convert import FLAX_NAMED_BACKBONES
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
        `return_heatmap`, the [N, K, h, w] heatmaps (a DeepPose model: its
        [N, K, 2] normalised coordinates, maxvals of ones).
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
        if cfg.head_type == 'regression':
            preds, maxvals = keypoints_from_regression(
                hm, center, scale, (iw, ih), use_udp=cfg.use_udp)
        else:
            preds, maxvals = keypoints_from_heatmaps(
                hm, center, scale, post_process=cfg.post_process,
                kernel=cfg.modulate_kernel, use_udp=cfg.use_udp,
                target_type=cfg.target_type)
        if return_heatmap:
            return preds, maxvals, hm
        return preds, maxvals


def load_checkpoint(model, checkpoint: str):
    """Load weights into `model`: an .npz written by the JAX package, or a
    .pth (mmpose names; a {'state_dict' | 'model' | 'module'} container and
    a 'module.' prefix are taken off) whose pos embed is regridded and whose
    patch kernel is padded to a ViT's geometry; a CNN's (GenericTopDown)
    routed by its backbone type (counterpart of the JAX
    `load_checkpoint_variables`, vitpose_tpu/api/inference.py:97-120); a
    BottomUpEstimator's .npz holds JAX's {'backbone', 'head'} variables."""
    if isinstance(model, BottomUpEstimator):
        vit = model.backbone_type == 'vit'
        model.load_state_dict(checkpoint_state_dict(
            checkpoint, model.backbone.cfg if vit else None,
            model.backbone_type, family='bottomup'), strict=True)
        return
    sd = checkpoint_state_dict(checkpoint, model.cfg.backbone,
                               model.backbone_type)
    if model.cfg.head_type == 'msmu':
        _check_prm(sd, model.cfg.use_prm)
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        if model.backbone_type not in FLAX_NAMED_BACKBONES:
            raise
        raise RuntimeError(
            f'{checkpoint}: the port names a {model.backbone_type!r} '
            "backbone's modules after the JAX package's flax paths, as the "
            'JAX package has no converter from mmpose\'s names for it: a '
            "reference mmpose .pth does not load; load the port's own .pth "
            "or the JAX package's .npz") from e


def _check_prm(sd, use_prm):
    """The MSMU head's refinement must be in the checkpoint exactly when
    the config sets use_prm (JAX's convert_msmu_head, cnn_ckpt.py:755)."""
    has_prm = any('.prm.' in k for k in sd if k.startswith('keypoint_head.'))
    if has_prm and not use_prm:
        raise ValueError(
            'checkpoint contains PRM (Pose Refine Machine) weights but the '
            'model config has use_prm=False — set model.use_prm=True or '
            'the refinement would be silently dropped')
    if use_prm and not has_prm:
        raise ValueError(
            'model config has use_prm=True but the checkpoint carries no '
            'predict_layers.*.prm weights')


def init_pose_model(config, checkpoint: Optional[str] = None,
                    device: str = 'cuda') -> PoseModel:
    """Build a PoseModel from a config and an optional checkpoint.

    `config` may be a config FILE path (a top-down config of the zoo, read
    with `utils.config.load_config`; its `model` dict builds the model and
    its `data.dataset` names the metadata), a variant string ('s', 'b', 'l',
    'h'), a dict such as {'variant': 'b', 'image_size': (192, 256), 'dtype':
    'bfloat16', 'backbone_overrides': {'fused_attention': True}}, a config
    file's `model` dict (one that names 'backbone_type' or 'family';
    `img_size` is (h, w) there), or a TopDownConfig. A config file or model
    dict of a CNN (a single-stage backbone of `train.loop.build_backbone`)
    builds a GenericTopDown. A bottom-up config (family
    'bottomup') gives its BottomUpEstimator itself, on the device in eval
    mode, for the bottom-up functions below (JAX refuses those configs
    here). Without a checkpoint the weights are random, drawn on the CPU
    from a torch.Generator seeded with 0, so every device gets the same
    ones.
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

    model = None
    if model_dict is not None:
        model = build_model_from_cfg(model_dict)
        if isinstance(model, BottomUpEstimator):
            if checkpoint is not None:
                load_checkpoint(model, checkpoint)
            return model.to(dev).eval()
        cfg = model.cfg
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

    if model is None:
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
    `outputs=` captures; of a CNN model the backbone's and the head's."""
    bb = model.backbone
    if model.backbone_type != 'vit':
        return {'backbone': (bb, True), 'head': (model.keypoint_head, True)}
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

    def to_numpy(out, nchw):
        # a multi-stage backbone or head gives a (nested) list of maps
        if isinstance(out, (list, tuple)):
            return [to_numpy(o, nchw) for o in out]
        out = out.to(dtype).float()
        if nchw:
            out = out.permute(0, 2, 3, 1)
        return out[:n].cpu().numpy()

    def hook(path, nchw):
        def fn(module, args, out):
            captured[path] = to_numpy(out, nchw)
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
    # a channel-reversed view (frame[..., ::-1]) has negative strides,
    # which torch.from_numpy refuses
    img = np.ascontiguousarray(img)
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


def _rgb(img):
    """An RGB array of `img`: an image file path (read with cv2) or an RGB
    array."""
    return read_rgb(img) if isinstance(img, str) else np.asarray(img)


def _normalised(estimator, img_np):
    """[H, W, 3] uint8 host image -> [1, H, W, 3] normalised f32 on the
    estimator's device."""
    dev = estimator.device
    x = torch.from_numpy(np.ascontiguousarray(img_np)).to(dev)[None]
    mean = torch.as_tensor(IMAGENET_MEAN, device=dev)
    std = torch.as_tensor(IMAGENET_STD, device=dev)
    return (x.float() / 255.0 - mean) / std


def _pose_results(preds, scores, info, pose_nms_thr):
    """Grouped poses -> [{'keypoints', 'score', 'area'}], the area the
    keypoints' box, then OKS NMS at `pose_nms_thr` unless it is None."""
    results = [dict(keypoints=np.asarray(p)[:, :3], score=float(s))
               for p, s in zip(preds, scores)]
    for r in results:
        kp = r['keypoints']
        r['area'] = float((kp[:, 0].max() - kp[:, 0].min())
                          * (kp[:, 1].max() - kp[:, 1].min()))
    if results and pose_nms_thr is not None:
        keep = oks_nms(results, pose_nms_thr,
                       sigmas=info.sigmas if info is not None
                       and len(info.sigmas) else None)
        results = [results[i] for i in keep]
    return results


def bottom_up_maps(estimator: BottomUpEstimator, img, dataset_info=None,
                   base_size=512):
    """The device half of `inference_bottom_up_pose_model`: (heatmaps
    [1, K, s, s], tags [1, K, s, s, 2] on the estimator's device, center,
    scale) of the image pasted top-left on the square base canvas."""
    import cv2
    img = _rgb(img)
    h, w = img.shape[:2]
    info = dataset_info or estimator.dataset_info
    scale_f = base_size / max(h, w)
    resized = cv2.resize(img, (int(round(w * scale_f)),
                               int(round(h * scale_f))))
    canvas = np.zeros((base_size, base_size, 3), img.dtype)
    canvas[:resized.shape[0], :resized.shape[1]] = resized
    flip_index = (info.flip_index if info is not None
                  else np.arange(estimator.num_joints))
    heatmaps, tags = estimator.infer(_normalised(estimator, canvas),
                                     flip_index)
    # the square canvas covers [0, max(h, w)] on BOTH axes of the image
    # (top-left paste), so decode around the canvas centre
    m = float(max(h, w))
    center = np.array([m / 2.0, m / 2.0], np.float32)
    scale = np.array([m / 200.0, m / 200.0], np.float32)
    return heatmaps, tags, center, scale


def inference_bottom_up_pose_model(estimator: BottomUpEstimator, img,
                                   dataset_info=None, pose_nms_thr=0.9,
                                   base_size=512):
    """Bottom-up inference on one image (JAX vitpose_tpu/api/inference.py:
    416, reference apis/inference.py:425): resize onto a square base canvas
    on the host, the model with the flip pass on the estimator's device,
    grouping on the host, keypoints back in image coords, OKS NMS at
    `pose_nms_thr` (None: none, the evaluation protocol).

    Returns (pose_results, []): a list of {'keypoints': [K, 3], 'score',
    'area'}.
    """
    info = dataset_info or estimator.dataset_info
    maps = bottom_up_maps(estimator, img, info, base_size)
    return group_bottom_up(estimator, *maps, info,
                           pose_nms_thr=pose_nms_thr), []


def group_bottom_up(estimator: BottomUpEstimator, heatmaps, tags, center,
                    scale, dataset_info=None, use_udp=False,
                    pose_nms_thr=0.9):
    """The host half of both bottom-up functions: the parser's candidates
    (on the maps' device) and grouping, the poses in image coords, OKS NMS
    at `pose_nms_thr` unless it is None. Returns the pose results."""
    preds, scores = estimator.parse(heatmaps, tags, center, scale,
                                    use_udp=use_udp)
    return _pose_results(preds, scores, dataset_info, pose_nms_thr)


def multi_scale_maps(estimator: BottomUpEstimator, img, dataset_info=None,
                     test_scale_factor=(1.0,), base_size=512, use_udp=False,
                     with_flip=True, align_corners=None):
    """The device half of `inference_bottom_up_multi_scale`: (heatmaps
    [1, K, h, w], tags [1, K, h, w, L] on the estimator's device, center,
    scale) aggregated over the scales and the flip."""
    from ..data.bottomup import get_multi_scale_size, resize_align_multi_scale
    if align_corners is None:
        # the reference configs: plain AE configs align_corners=False, UDP
        # ones True (higherhrnet_w32_*.py:106)
        align_corners = bool(use_udp)
    img = _rgb(img)
    info = dataset_info or estimator.dataset_info
    flip_index = (info.flip_index if info is not None
                  else np.arange(estimator.num_joints))
    k = estimator.num_joints
    min_scale = min(test_scale_factor)
    head = estimator.keypoint_head
    wa = getattr(head, 'with_ae_loss', None)
    estimator.eval()

    def apply_split(inp):
        """Model outputs -> (heatmap list, tag list) in NCHW; per-output
        tag presence follows the head's with_ae_loss."""
        outs = estimator(inp)
        with_ae = (list(wa)[:len(outs)]
                   if isinstance(wa, (list, tuple)) and len(wa) >= len(outs)
                   else [o.shape[1] > k for o in outs])
        # the multi-stage protocol keeps the last stage (reference
        # hourglass_ae_coco_512x512.py select_output_index=[3])
        select = ([len(outs) - 1] if estimator.multi_stage
                  else list(range(len(outs))))
        return split_ae_outputs(outs, k, [True] * len(outs), with_ae, select)

    heatmaps_list, tags_list = [], []
    # every scale projects to the scale-1 base size, and the decode's
    # center/scale are those of scale 1 too (reference BottomUpGetImgSize,
    # bottom_up_transform.py:706)
    base_wh, center, scale = get_multi_scale_size(
        img, (base_size, base_size), 1.0, min_scale, use_udp=use_udp)
    with torch.no_grad():
        for s in sorted(test_scale_factor, reverse=True):
            resized, _, _ = resize_align_multi_scale(
                img, (base_size, base_size), s, min_scale, use_udp=use_udp)
            x = _normalised(estimator, resized)
            hms, tags_o = apply_split(x)
            if with_flip:
                hms_f, tags_f = apply_split(x.flip(2))
                hms_f = flip_feature_maps(hms_f, flip_index=flip_index)
                tags_f = flip_feature_maps(tags_f, flip_index=flip_index)
            else:
                hms_f = tags_f = None
            heatmaps_list.append(aggregate_stage_flip(
                hms, hms_f, project2image=True,
                size_projected=tuple(base_wh), align_corners=align_corners,
                aggregate_stage='average', aggregate_flip='average')[0])
            if s == 1.0 or len(test_scale_factor) == 1:
                # tags only at the base scale (reference
                # associative_embedding.py:188-199); stages and flip both
                # concatenate along L
                tags_list.extend(aggregate_stage_flip(
                    tags_o, tags_f, project2image=True,
                    size_projected=tuple(base_wh),
                    align_corners=align_corners,
                    aggregate_stage='concat', aggregate_flip='concat'))
        heatmaps = aggregate_scale(heatmaps_list, align_corners=align_corners)
        tags = aggregate_scale(tags_list, align_corners=align_corners,
                               aggregate_scale_mode='unsqueeze_concat')
    return heatmaps, tags, center, scale


def inference_bottom_up_multi_scale(estimator: BottomUpEstimator, img,
                                    dataset_info=None,
                                    test_scale_factor=(1.0,),
                                    base_size=512, use_udp=False,
                                    pose_nms_thr=0.9, with_flip=True,
                                    align_corners=None):
    """Multi-scale (optionally UDP-aligned) bottom-up inference, the
    reference's test protocol (JAX vitpose_tpu/api/inference.py:474,
    associative_embedding.py:28 `forward_test`): per scale,
    `resize_align_multi_scale(_udp)` the image on the host, the model on the
    original and the flipped view on the estimator's device, both projected
    to the base image size (`aggregate_stage_flip`), the per-scale heatmaps
    averaged (`aggregate_scale`), the tags of scale 1 only; then grouping on
    the host and image coords under the same UDP convention, OKS NMS at
    `pose_nms_thr` unless it is None. Returns (pose_results, [])."""
    info = dataset_info or estimator.dataset_info
    maps = multi_scale_maps(estimator, img, info, test_scale_factor,
                            base_size, use_udp, with_flip, align_corners)
    return group_bottom_up(estimator, *maps, info, use_udp,
                           pose_nms_thr), []


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

"""The config-driven training runner and models from a config file.

Counterpart of vitpose_tpu/train/loop.py: `build_model_from_cfg`,
`build_backbone` and `build_generic_topdown` (:84-157, :222-236: the ViT
and the CNN top-down models of every backbone of JAX's registry, with
the classic, the ViPNAS, the DeepPose regression or a multi-stage head),
`_log` (:33-45), `_pop_freeze_options` and the freezing
of `_apply_freeze` (:67-81), `train_model` (the top-down ViT branch of
:239-479), `train_model_moe` (:520-706, the ViTPose+ runner) and the
`pretrained` / `load_from` merges (:330-353, :482-517), and every branch of
`build_family_model` (:160-219: bottom-up, pose lifter, mesh, PoseWarper,
InterHand3D, VoxelPose) and of `train_model` (:248-281, the runners in
train/{bottomup,posewarper,lifter,interhand,mesh,voxelpose}_loop.py).

One epoch of `train_model`: the host loader -> pinned staging -> the device
crop and targets (`make_preprocess_fn`) -> the train step -> json-lines
log; every `eval_interval` epochs `run_validation` + `ds.evaluate`; a
checkpoint every `ckpt_interval` epochs and at the last one; `max_steps`
returns without saving; SIGTERM saves the state as an incomplete epoch and
returns, and `resume` redoes that epoch. A list of train sets is ViTPose+
multi-dataset training, which JAX runs in `train_model_moe`: one loader per
set in one mixture of single-dataset batches, targets padded to
`max_num_joints`, the MoE step (`make_moe_train_step`), the dataset logged
per step, evaluation through expert 0 and the main head. The port runs
both in this one loop, so the MoE run also gets what JAX's
`train_model_moe` lacks: `load_from`, the preemption save and the
`data_time` log. TensorBoard is not ported and raises.

Across processes (parallel/; one per card, started by torchrun or SLURM
and `init_distributed`) the runner lays the processes out as JAX's does
(:365-377, :614-626): `data.batch_size` is the step's global batch, the
data axis is runtime.n_data or the gcd of the batch and the processes
(`parallel.mesh.data_axis_size`), and a ViTPose+ mixture adds
runtime.n_expert (its experts split over that axis, `shard_params`).
Each data rank loads its shard of the train set (the loader's
process_index / process_count) at batch_size / n_data, the gradients are
averaged over the data group in the train state, BatchNorm and DropPath
see the global batch, runtime.zero1 splits AdamW's moments over the data
group (`parallel.zero.zero1`), and rank 0 alone writes the log and the
checkpoints. Validation runs whole on every rank, as JAX's does.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data import DatasetInfo, topdown_dataset_cls
from ..data.loader import MultiDatasetLoader, TopDownLoader
from ..data.pipeline import AugmentConfig, make_preprocess_fn
from ..eval.loop import PinnedStaging, run_validation
from ..models.bottomup import BottomUpEstimator
from ..models.heads_extra import (AEHead, AEHigherResolutionHead,
                                  AEMultiStageHead)
from ..models.classic_cnns import CPM, VGG, AlexNet, SEResNet
from ..models.hrformer import HRFormer
from ..models.hrnet import HRNet, HRNetConfig
from ..models.lightweight import (Hourglass, HourglassAE, MobileNetV2,
                                  ShuffleNetV2)
from ..models.more_cnns import (MobileNetV3, RegNet, ResNeSt, SCNet,
                                ShuffleNetV1, ViPNASMobileNetV3, ViPNASResNet)
from ..models.interhand3d import Interhand3DEstimator
from ..models.mesh import build_parametric_mesh
from ..models.multistage_nets import MSPN, RSN, LiteHRNet
from ..models.pose3d import PoseLifter
from ..models.posewarper import build_posewarper
from ..models.resnet import ResNet, ResNetV1d
from ..models.resnext import ResNeXt, SEResNeXt
from ..models.topdown import (GenericMultiStageTopDown, GenericTopDown,
                              TopDownConfig, TopDownModel, make_config)
from ..models.vit import ViT, ViTConfig
from ..models.voxelpose import DetectAndRegress
from ..parallel.distributed import PreemptionGuard, is_main_process
from ..parallel.mesh import (activate, any_process, average_metrics,
                             data_axis_size, make_mesh, shard_params)
from ..parallel.zero import zero1
from ..utils.checkpoint import CheckpointManager
from ..utils.torch_ckpt import (checkpoint_state_dict,
                                convert_backbone_checkpoint)
from .optim import OptimConfig, layer_decay_adamw, make_freeze_mask
from .state import create_train_state
from .step import make_moe_train_step, make_train_step


# the heads of GenericMultiStageTopDown
MULTI_STAGE_HEADS = ('multistage', 'msmu', 'identity')


# the JAX package's BACKBONES registry: name -> constructor taking
# `generator` and the config's backbone options
BACKBONES = {
    'resnet': ResNet,
    'resnet_v1d': ResNetV1d,
    'hrnet': lambda generator, **kw: HRNet(HRNetConfig(**kw), generator),
    'hrnetv2': lambda generator, **kw: HRNet(
        HRNetConfig(multiscale_concat=True, **kw), generator),
    'resnext': ResNeXt,
    'seresnet': SEResNet,
    'seresnext': SEResNeXt,
    'scnet': SCNet,
    'resnest': ResNeSt,
    'regnet': RegNet,
    'vgg': VGG,
    'alexnet': AlexNet,
    'mobilenet_v3': MobileNetV3,
    'shufflenet_v1': ShuffleNetV1,
    'vipnas_mbv3': ViPNASMobileNetV3,
    'vipnas_resnet': ViPNASResNet,
    'mobilenet_v2': MobileNetV2,
    'shufflenet_v2': ShuffleNetV2,
    'litehrnet': LiteHRNet,
    'hrformer': HRFormer,
    # the multi-stage backbones (GenericMultiStageTopDown, or for
    # hourglass_ae the bottom-up AEMultiStageHead)
    'cpm': CPM,
    'hourglass': Hourglass,
    'hourglass_ae': HourglassAE,
    'mspn': MSPN,
    'rsn': RSN,
}


def _known_backbone(backbone_type):
    if backbone_type not in BACKBONES:
        raise KeyError(f'unknown backbone_type {backbone_type}: '
                       f'{sorted(BACKBONES)}')


def build_backbone(backbone_type: str, generator=None, **bb_kwargs):
    """Name -> NCHW feature backbone with random weights drawn from
    `generator`: the JAX package's BACKBONES registry. The multi-stage ones
    return a list (per stage or stack; MSPN and RSN per stage a list of
    units)."""
    _known_backbone(backbone_type)
    return BACKBONES[backbone_type](generator=generator, **bb_kwargs)


def backbone_takes(backbone_type: str, option: str) -> bool:
    """Whether `backbone_type` takes the config option `option` (e.g.
    'dtype'), from its constructor's signature (HRNet's from HRNetConfig's
    fields): where JAX's flax module raises TypeError on an unknown field,
    this answers before anything is built."""
    _known_backbone(backbone_type)
    if backbone_type in ('hrnet', 'hrnetv2'):
        return option in {f.name for f in dataclasses.fields(HRNetConfig)}
    return option in inspect.signature(BACKBONES[backbone_type]).parameters


def _model_parts(mcfg: dict):
    """A config file's `model` dict -> (backbone_type, backbone overrides,
    TopDownConfig). For a CNN the config's backbone is JAX's placeholder
    ViT-S config: only its `img_size` and `dtype` (the head's) are read."""
    mcfg = dict(mcfg)
    family = mcfg.pop('family', 'topdown')
    if family != 'topdown':
        raise ValueError(f'model family {family!r} has no top-down config: '
                         'build it with build_model_from_cfg')
    backbone_type = mcfg.pop('backbone_type', 'vit')
    variant = mcfg.pop('variant', 'b')
    hw = tuple(mcfg.pop('img_size', (256, 192)))
    if str(mcfg.get('target_type', '')).lower() == 'combinedtarget':
        # a config's out_channels counts joints; a CombinedTarget head
        # predicts a response and two offset maps per joint (mmpose's
        # out_channels=3 * num_output_channels). JAX's udp_regress config
        # inherits 17 from its base and gives its head 17 channels, on
        # which JAX's loss and decode fail
        mcfg['out_channels'] = 3 * mcfg.get('out_channels', 17)
    bb_over = dict(mcfg.pop('backbone_overrides', None) or {})
    if backbone_type == 'vit':
        cfg = make_config(variant, img_size=hw, **mcfg)
        if bb_over:
            cfg = dataclasses.replace(
                cfg, backbone=dataclasses.replace(cfg.backbone, **bb_over))
        return backbone_type, {}, cfg
    return backbone_type, bb_over, make_config('s', img_size=hw, **mcfg)


def topdown_config(mcfg: dict) -> TopDownConfig:
    """A config file's `model` dict -> TopDownConfig (`img_size` is (h, w)
    there). Another `family` raises."""
    return _model_parts(mcfg)[2]


def build_generic_topdown(backbone_type: str, bb_kwargs: dict,
                          cfg: TopDownConfig, generator=None):
    """A CNN top-down model: the backbone, then its head, both drawn from
    `generator`; GenericMultiStageTopDown for the multi-stage heads."""
    backbone = build_backbone(backbone_type, generator, **bb_kwargs)
    cls = (GenericMultiStageTopDown if cfg.head_type in MULTI_STAGE_HEADS
           else GenericTopDown)
    return cls(backbone, cfg, backbone_type, generator)


def build_family_model(family: str, mcfg: dict, generator=None):
    """The non-top-down families of a config's `model` dict (JAX
    vitpose_tpu/train/loop.py:160-219 `build_family_model`), weights drawn
    from `generator`: 'posewarper' (models/posewarper.py), 'pose_lifter'
    (models/pose3d.py, whose 2D input has num_joints joints, one more with
    `remove_root`), 'mesh' (models/mesh.py ParametricMesh), 'interhand3d'
    (models/interhand3d.py on `backbone_type`, default the ViT of
    `backbone_overrides`), 'voxelpose' (models/voxelpose.py
    DetectAndRegress), and 'bottomup': the backbone of
    `backbone_type` (default 'hrnet'), the AE head ('ae': AEHead,
    'ae_higher': AEHigherResolutionHead, 'ae_multi': Hourglass-AE's
    AEMultiStageHead, whose config sets its out_channels), the dataset's
    metadata and the parser options. Another family raises KeyError."""
    if family == 'posewarper':
        return build_posewarper(mcfg, build_backbone, generator)
    if family == 'pose_lifter':
        mcfg = dict(mcfg)
        mcfg.pop('family', None)
        mcfg.pop('loss', None)
        remove_root = bool(mcfg.pop('remove_root', False))
        num_joints = mcfg.pop('num_joints', 17)
        return PoseLifter(num_joints=num_joints,
                          in_joints=num_joints + remove_root,
                          generator=generator, **mcfg)
    if family == 'mesh':
        return build_parametric_mesh(mcfg, build_backbone, generator)
    if family == 'interhand3d':
        mcfg = dict(mcfg)
        mcfg.pop('family', None)
        backbone_type = mcfg.pop('backbone_type', 'vit')
        bb_over = dict(mcfg.pop('backbone_overrides', None) or {})
        bb = (ViT(ViTConfig(**bb_over), generator) if backbone_type == 'vit'
              else build_backbone(backbone_type, generator, **bb_over))
        return Interhand3DEstimator(bb, backbone_type=backbone_type,
                                    generator=generator, **mcfg)
    if family == 'voxelpose':
        mcfg = dict(mcfg)
        for key in ('family', 'root_id', 'max_people_train'):
            mcfg.pop(key, None)     # the loop's options
        return DetectAndRegress(generator=generator, **mcfg)
    if family != 'bottomup':
        raise KeyError(f'unknown model family {family!r}; expected '
                       'topdown, bottomup, pose_lifter, mesh, posewarper, '
                       'interhand3d or voxelpose')
    mcfg = dict(mcfg)
    backbone_type = mcfg.pop('backbone_type', 'hrnet')
    if backbone_type == 'vit':
        raise NotImplementedError(
            'a bottom-up config with the ViT backbone: JAX builds none from '
            'a config (its registry has no vit); build BottomUpEstimator '
            'from a ViTConfig')
    head_kind = mcfg.pop('head', 'ae')
    bb = build_backbone(backbone_type, generator,
                        **(mcfg.pop('backbone_overrides', None) or {}))
    num_joints = mcfg.pop('num_joints', 17)
    head_kw = dict(mcfg.pop('head_overrides', None) or {})
    if head_kind == 'ae_multi':
        head = AEMultiStageHead(bb.out_channels, generator=generator,
                                **head_kw)
    else:
        head_cls = (AEHigherResolutionHead if head_kind == 'ae_higher'
                    else AEHead)
        head = head_cls(bb.out_channels, num_joints, generator=generator,
                        **head_kw)
    info = DatasetInfo.load(mcfg.pop('dataset_info', 'coco'))
    return BottomUpEstimator(bb, num_joints=num_joints, head=head,
                             dataset_info=info,
                             parser_cfg=mcfg.pop('parser', None),
                             backbone_type=backbone_type)


def build_model_from_cfg(mcfg: dict, generator=None):
    """A config file's `model` dict -> TopDownModel (ViT), GenericTopDown
    or GenericMultiStageTopDown (CNN) or, for families 'bottomup',
    'posewarper', 'pose_lifter', 'mesh', 'interhand3d' and 'voxelpose',
    BottomUpEstimator, PoseWarper, PoseLifter, ParametricMesh,
    Interhand3DEstimator and DetectAndRegress, with random weights, drawn on the CPU from
    `generator` (default: a torch.Generator seeded with 0, as in
    `init_pose_model`)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    family = mcfg.get('family', 'topdown')
    if family != 'topdown':
        return build_family_model(family, mcfg, generator)
    backbone_type, bb_over, cfg = _model_parts(mcfg)
    if backbone_type == 'vit':
        return TopDownModel(cfg, generator=generator)
    return build_generic_topdown(backbone_type, bb_over, cfg, generator)


def _log(work_dir, record):
    """Print one json record and append it to work_dir/train.log.json, on
    rank 0 alone (JAX's `_log`: every process would otherwise append to the
    same file)."""
    if not is_main_process():
        return
    line = json.dumps(record)
    print(line, flush=True)
    if work_dir:
        with open(os.path.join(work_dir, 'train.log.json'), 'a') as f:
            f.write(line + '\n')


def _pop_freeze_options(ocfg_d: dict):
    """The backbone-freezing keys of an optimizer config dict (reference
    vit.py:249 `_freeze_stages` options, in the config as
    optimizer.frozen_stages / freeze_attn / freeze_ffn)."""
    return dict(frozen_stages=ocfg_d.pop('frozen_stages', -1),
                freeze_attn=ocfg_d.pop('freeze_attn', False),
                freeze_ffn=ocfg_d.pop('freeze_ffn', False))


def _freeze_mask(model, freeze_kw):
    """make_freeze_mask's {name: trainable}, or None when nothing is
    frozen."""
    if freeze_kw['frozen_stages'] < 0 and not freeze_kw['freeze_attn'] \
            and not freeze_kw['freeze_ffn']:
        return None
    return make_freeze_mask(model, **freeze_kw)


def load_pretrained(model: TopDownModel, path):
    """`pretrained`: a backbone-only (MAE) checkpoint over the fresh
    backbone (JAX `_merge_trees`); what it does not hold keeps its init.
    A CNN raises: JAX would read its checkpoint with the ViT converter
    (:330-339), and no CNN config of the zoo sets `pretrained`."""
    if model.backbone_type != 'vit':
        raise NotImplementedError(
            f'pretrained on a {model.backbone_type!r} backbone: only ViT '
            'backbone checkpoints are read (JAX reads any with the ViT '
            'converter); use load_from with a whole-model checkpoint')
    model.backbone.load_state_dict(
        convert_backbone_checkpoint(path, model.cfg.backbone), strict=False)


def load_from(model: TopDownModel, path):
    """`load_from`: a whole-model checkpoint (.npz exported by the JAX
    package, or .pth) over the fresh model, skipping, with a printed
    message, every entry the model does not have or has in another shape
    (mmcv load_checkpoint(strict=False), JAX `_merge_trees_checked`), e.g.
    a head of another number of keypoints."""
    own = model.state_dict()
    keep = {}
    for k, v in checkpoint_state_dict(path, model.cfg.backbone,
                                      model.backbone_type).items():
        if k not in own:
            print(f'load_from: skipping unexpected key {k}', flush=True)
        elif tuple(v.shape) != tuple(own[k].shape):
            print(f'load_from: skipping {k} (ckpt {tuple(v.shape)} != '
                  f'model {tuple(own[k].shape)})', flush=True)
        else:
            keep[k] = v
    model.load_state_dict(keep, strict=False)


PORTED_FAMILIES = ('topdown', 'bottomup', 'posewarper', 'pose_lifter',
                   'interhand3d', 'mesh', 'voxelpose')


def _refuse_unported(cfg):
    family = cfg['model'].get('family', 'topdown')
    if family not in PORTED_FAMILIES:
        raise KeyError(f'unknown model family {family!r}; expected one of '
                       f'{PORTED_FAMILIES}')
    rt = cfg.get('runtime', {})
    if rt.get('tensorboard'):
        raise NotImplementedError('runtime.tensorboard is not ported: the '
                                  'card machine has no tensorboard package '
                                  '(ROADMAP.md "Not queued")')


def step_seed(seed: int, step: int) -> int:
    """The DropPath generator's seed for global step `step`: the port's
    jax.random.fold_in(rng, step), one stream per (seed, step), so a
    resumed run draws the masks the uninterrupted one drew."""
    return int(np.random.SeedSequence((seed, step))
               .generate_state(1, np.uint64)[0])


def _batch_to_device(batch, dev, staging):
    """The loader's numpy batch -> the preprocess arguments on `dev`; the
    canvases through pinned staging on CUDA."""
    if staging is not None:
        imgs = staging.to_device(batch['imgs'], dev)
    else:
        imgs = torch.from_numpy(np.ascontiguousarray(batch['imgs']))
    rest = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(dev)
            for k in ('center', 'scale', 'rot', 'joints', 'vis', 'flip')]
    return [imgs] + rest


def build_train_state(cfg: dict, steps_per_epoch: int, device, layout=None):
    """The runner's model and train state for `cfg`, on `device`: random
    weights from runtime.seed, then `pretrained` (its fc2 split into the
    experts of a ViTPose+ backbone) and `load_from`, then, under a
    `layout` with expert or model axes, the FFNs split over them
    (`shard_params`), then the layer-decay AdamW with the optimizer
    config's freezing, its moments split over the data axis where
    runtime.zero1 asks (`zero1`, under the active layout). Returns the
    state; its model is `state.model`."""
    seed = cfg.get('runtime', {}).get('seed', 0)
    model = build_model_from_cfg(cfg['model'],
                                 torch.Generator().manual_seed(seed))
    if cfg.get('pretrained'):
        load_pretrained(model, cfg['pretrained'])
    if cfg.get('load_from'):
        load_from(model, cfg['load_from'])
    model.to(device)
    if layout is not None and layout.n_expert * layout.n_model > 1:
        shard_params(model, layout)
    ocfg_d = dict(cfg.get('optimizer', {}))
    ocfg_d.pop('total_epochs', None)
    freeze_kw = _pop_freeze_options(ocfg_d)
    ocfg = OptimConfig(num_layers=model.cfg.backbone.depth, **ocfg_d)
    tx = layer_decay_adamw(model, ocfg, steps_per_epoch,
                           trainable=_freeze_mask(model, freeze_kw))
    if cfg.get('runtime', {}).get('zero1'):
        zero1(tx[0])
    return create_train_state(model, tx, ocfg.grad_clip_norm)


def _train_data(cfg: dict, seed: int, layout=None):
    """(loader, preprocess, number of datasets) of the config's train set;
    the number is None for one train set, and for a list (ViTPose+) the
    loader is the mixture of one loader per set, with its dataset_idx and
    seed + i, and the targets are padded to data.max_num_joints. Under a
    `layout` with a data axis each loader yields this data rank's shard of
    the set, batch_size / n_data rows a batch."""
    dcfg = cfg['data']
    image_size = tuple(dcfg.get('image_size', (192, 256)))
    heatmap_size = tuple(dcfg.get('heatmap_size', (48, 64)))
    tcfg = cfg.get('target', {})
    target = dict(image_size=image_size, heatmap_size=heatmap_size,
                  use_udp=tcfg.get('encoding', 'UDP') == 'UDP',
                  sigma=tcfg.get('sigma', 2.0))
    multi = isinstance(dcfg['train'], (list, tuple))
    if multi:
        max_k = dcfg.get('max_num_joints', 133)
        entries = dcfg['train']
        preprocess = make_preprocess_fn(**target, pad_num_joints=max_k)
    else:
        entries = [dict(dcfg['train'], dataset=dcfg.get('dataset', 'coco'))]
        preprocess = make_preprocess_fn(
            **target, unbiased=tcfg.get('unbiased', False),
            target_type=cfg['model'].get('target_type', 'GaussianHeatmap'))
    n_data = layout.n_data if layout is not None else 1
    batch_size = dcfg.get('batch_size', 64)
    if batch_size % n_data:
        raise ValueError(f'data.batch_size {batch_size} does not split over '
                         f'{n_data} data ranks')
    shard = (dict(process_index=layout.index('data'), process_count=n_data)
             if n_data > 1 else {})
    loaders = []
    for i, entry in enumerate(entries):
        name = entry.get('dataset', 'coco')
        kw = (dict(dataset_idx=entry.get('dataset_idx', i),
                   max_num_joints=max_k) if multi else {})
        ds = topdown_dataset_cls(name)(
            entry['ann_file'], entry['img_prefix'], dataset_info=name,
            image_size=image_size, heatmap_size=heatmap_size,
            use_gt_bbox=entry.get('use_gt_bbox', True), **kw)
        loaders.append(TopDownLoader(
            ds, batch_size // n_data, is_train=True,
            canvas_size=dcfg.get('canvas_size'),
            padding=dcfg.get('padding', 1.25),
            aug=AugmentConfig(**dcfg.get('aug', {})),
            seed=seed + i, num_workers=dcfg.get('num_workers', 8),
            **shard))
    if multi:
        return MultiDatasetLoader(loaders), preprocess, len(loaders)
    return loaders[0], preprocess, None


def train_model(cfg: dict, work_dir: Optional[str] = None,
                resume: bool = False, max_steps: Optional[int] = None,
                device='cuda'):
    """Train from a config dict (see vitpose_tpu/configs/) on `device`
    (CUDA unless the caller passes 'cpu'; it raises without CUDA). Returns
    the final TrainState. `max_steps` stops after that many optimizer
    steps, without a checkpoint. A list-valued data.train trains ViTPose+
    on the mixture of its datasets."""
    from ..api.inference import _device
    _refuse_unported(cfg)
    family = cfg['model'].get('family')
    if family == 'bottomup':
        from .bottomup_loop import train_bottomup_model
        return train_bottomup_model(cfg, work_dir=work_dir, resume=resume,
                                    max_steps=max_steps, device=device)
    if family == 'posewarper':
        from .posewarper_loop import train_posewarper_model
        return train_posewarper_model(cfg, work_dir=work_dir, resume=resume,
                                      max_steps=max_steps, device=device)
    if family == 'pose_lifter':
        from .lifter_loop import train_pose_lifter_model
        return train_pose_lifter_model(cfg, work_dir=work_dir,
                                       resume=resume, max_steps=max_steps,
                                       device=device)
    if family == 'interhand3d':
        from .interhand_loop import train_interhand3d_model
        return train_interhand3d_model(cfg, work_dir=work_dir,
                                       resume=resume, max_steps=max_steps,
                                       device=device)
    if family == 'mesh':
        from .mesh_loop import train_mesh_model
        return train_mesh_model(cfg, work_dir=work_dir, resume=resume,
                                max_steps=max_steps, device=device)
    if family == 'voxelpose':
        from .voxelpose_loop import train_voxelpose_model
        return train_voxelpose_model(cfg, work_dir=work_dir, resume=resume,
                                     max_steps=max_steps, device=device)
    dev = _device(device)
    rt = cfg.get('runtime', {})
    # the expert axis is the ViTPose+ mixture's (JAX's train_model_moe)
    n_expert = (rt.get('n_expert', 1)
                if isinstance(cfg['data']['train'], (list, tuple)) else 1)
    layout = make_mesh(
        n_data=data_axis_size(cfg['data'].get('batch_size', 64), n_expert,
                              n_data=rt.get('n_data')),
        n_expert=n_expert)
    with activate(layout):
        return _train_topdown(cfg, work_dir, resume, max_steps, dev, layout)


def _train_topdown(cfg, work_dir, resume, max_steps, dev, layout):
    """train_model's top-down runner (ViT, CNN, ViTPose+) under `layout`,
    which is active."""
    rt = cfg.get('runtime', {})
    work_dir = work_dir or rt.get('work_dir', 'work_dir')
    os.makedirs(work_dir, exist_ok=True)
    seed = rt.get('seed', 0)

    # ---- data -------------------------------------------------------
    dcfg = cfg['data']
    image_size = tuple(dcfg.get('image_size', (192, 256)))
    heatmap_size = tuple(dcfg.get('heatmap_size', (48, 64)))
    loader, preprocess, num_datasets = _train_data(cfg, seed, layout)

    # ---- model + optimizer -----------------------------------------
    total_epochs = cfg.get('optimizer', {}).get('total_epochs', 210)
    steps_per_epoch = max(1, len(loader))
    state = build_train_state(cfg, steps_per_epoch, dev, layout)
    model = state.model
    if num_datasets is None:
        train_step = make_train_step(
            model, target_type=cfg['model'].get('target_type',
                                                'GaussianHeatmap'),
            reg_loss=cfg['model'].get('reg_loss', 'smooth_l1'),
            heatmap_loss=cfg['model'].get('heatmap_loss', 'mse'))
        val_route = {}
    else:
        if model.cfg.num_extra_heads != num_datasets - 1:
            raise ValueError(
                f'{num_datasets} train sets need {num_datasets - 1} '
                f'associate heads; the model has '
                f'{model.cfg.num_extra_heads}')
        train_step = make_moe_train_step(model, num_datasets)
        val_route = dict(expert_idx=0, head_idx=0)

    # ---- checkpointing / resume ------------------------------------
    save_best = (rt.get('save_best')
                 or cfg.get('evaluation', {}).get('save_best', 'AP'))
    ckpt = CheckpointManager(os.path.join(work_dir, 'ckpts'),
                             save_best_metric=save_best)
    start_epoch = 0
    if resume:
        state, ep = ckpt.restore(state)
        if ep is not None:
            start_epoch = ep + 1
            info = ckpt.load_info(ep)
            if info and info.get('meta', {}).get('completed') is False:
                start_epoch = ep    # preempted mid-epoch: redo that epoch
            _log(work_dir, {'mode': 'resume', 'epoch': start_epoch})

    # ---- val loader -------------------------------------------------
    val_loader = None
    if 'val' in dcfg:
        val_name = dcfg['val'].get('dataset', dcfg.get('dataset', 'coco'))
        val_ds = topdown_dataset_cls(val_name)(
            dcfg['val']['ann_file'], dcfg['val']['img_prefix'],
            dataset_info=val_name, image_size=image_size,
            heatmap_size=heatmap_size, test_mode=True,
            use_gt_bbox=dcfg['val'].get('use_gt_bbox', True),
            bbox_file=dcfg['val'].get('bbox_file'))
        val_loader = TopDownLoader(
            val_ds, dcfg.get('val_batch_size', dcfg.get('batch_size', 64)),
            is_train=False, canvas_size=dcfg.get('canvas_size'),
            padding=dcfg.get('padding', 1.25),
            num_workers=dcfg.get('num_workers', 8))

    log_interval = rt.get('log_interval', 50)
    eval_interval = cfg.get('evaluation', {}).get(
        'interval', rt.get('eval_interval', 10))
    ckpt_interval = rt.get('ckpt_interval', 10)
    mcfg = model.cfg
    # a resumed run goes on from the saved step, so the per-step DropPath
    # streams (step_seed) do not replay from zero
    global_step = state.step
    generator = torch.Generator(device=dev)
    staging = PinnedStaging() if dev.type == 'cuda' else None
    guard = PreemptionGuard().install()
    try:
        for epoch in range(start_epoch, total_epochs):
            loader.set_epoch(epoch)
            t_epoch = time.time()
            t_data = 0.0
            t_last = time.time()
            for it, batch in enumerate(loader):
                t_data += time.time() - t_last
                pre = preprocess(*_batch_to_device(batch, dev, staging))
                if num_datasets is not None:
                    pre['dataset_idx'] = batch['dataset_idx']
                generator.manual_seed(step_seed(seed, global_step))
                metrics = train_step(state, pre, generator)
                global_step += 1
                if it % log_interval == 0:
                    record = dict(mode='train', epoch=epoch, iter=it)
                    if num_datasets is not None:
                        record['dataset'] = int(batch['dataset_idx'][0])
                    # the one read-back of the step's metrics, the global
                    # batch's under a data axis
                    metrics = average_metrics(metrics)
                    record.update(step=global_step, data_time=t_data,
                                  time=time.time() - t_epoch,
                                  **{k: float(v) for k, v in metrics.items()})
                    _log(work_dir, record)
                t_last = time.time()
                # every rank stops where any was preempted
                if any_process(guard.should_stop):
                    _log(work_dir, {'mode': 'preempt', 'epoch': epoch,
                                    'step': global_step})
                    # marked incomplete, so resume redoes this epoch
                    ckpt.save(epoch, state, meta={'completed': False})
                    return state
                if max_steps and global_step >= max_steps:
                    return state
            record = dict(mode='epoch', epoch=epoch,
                          epoch_time=time.time() - t_epoch)

            stats = None
            if val_loader is not None and eval_interval \
                    and (epoch + 1) % eval_interval == 0:
                results = run_validation(
                    model, val_loader, use_udp=mcfg.use_udp,
                    post_process=mcfg.post_process,
                    modulate_kernel=mcfg.modulate_kernel,
                    target_type=mcfg.target_type, **val_route)
                eval_metric = cfg.get('evaluation', {}).get('metric')
                stats = (val_loader.ds.evaluate(results, metric=eval_metric)
                         if eval_metric else val_loader.ds.evaluate(results))
                record.update({k: float(v) for k, v in stats.items()})
            _log(work_dir, record)

            if (ckpt_interval and (epoch + 1) % ckpt_interval == 0) \
                    or epoch == total_epochs - 1:
                ckpt.save(epoch, state, metrics=stats)
    finally:
        guard.uninstall()
    return state

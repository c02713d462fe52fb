"""The port's entry points on CNN configs against the JAX package on the CPU:
the evaluation CLI on the zoo's HRNet-W32 config, `init_pose_model` with a
.pth and an .npz, and the training CLI's runner on the zoo's ResNet-50
config, each cut to a tiny size by `--cfg-options`-style overrides.

  * Evaluation: HRNet of width 8 with two exchange stages, 64x48 crops, f32,
    MSRA decode ('default', no UDP) with the config's shift_heatmap, on the
    COCO fixture of tests/test_torch_data.py (10 detections, batches of 4).
    The GT is rewritten from the port's predictions of the same weights, so
    that AP lies strictly between 0 and 1; JAX's run_validation + evaluate
    on the same weights, read from the same .npz, give the reference stats,
    held to 1e-6 as tests/test_torch_eval.py holds the ViT's.
  * init_pose_model: a .pth of the port's state_dict (mmpose names) and an
    .npz of JAX's converted variables give the source model's heatmaps
    exactly.
  * Runner: ResNet-18 with three deconvs of 16, 64x64 crops (2x2 features,
    16x16 heatmaps), batch 8 (one step per epoch), MSRA targets with the
    config's augmentation, both runners `load_from` the same .npz, two
    steps with the first epoch's evaluation between them, held to the
    runner tolerance (tests/test_torch_loop.py): metrics 1e-4 relative
    (measured 5.5e-5), BN statistics 1e-4 relative plus 5e-5 absolute,
    parameters per tensor an RMS difference at most 1e-2 of the RMS update
    (measured 4.7e-3), the epoch-end stats 1e-6; the elementwise parameter
    bound as tests/test_torch_cnn.py holds it (FLIPPED_SHARE). JAX's model
    init gives zeros of its shapes, which load_from replaces, and its
    checkpoint manager is stubbed, as there; and it
    trains on the port's crops and targets: Adam's first step moves every
    element by about lr whatever the size of its gradient, and of ResNet's
    many near-zero gradients a difference of 1e-6 in the inputs, as the two
    packages' warps and targets leave, flips the sign. (At 128x96 JAX's f32
    training gradients lie up to 9% of a tensor's largest value from an f64
    run where the crops hold constant padding, the port's within 1e-5: its
    BN variance E[x^2] - E[x]^2 loses the digits in XLA's f32 reductions.)
JAX references compile once per module, at XLA's default level inside
JAX's own runners.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.eval.loop import run_validation as jax_run_validation
from vitpose_tpu.models.topdown import GenericTopDown as JaxGenericTopDown
from vitpose_tpu.train import loop as jax_loop
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.cnn_ckpt import convert_generic_topdown_checkpoint
from vitpose_tpu.utils.config import apply_options as jax_apply_options
from vitpose_tpu.utils.config import load_config as jax_load_config

from test_torch_cnn import randomize_bn
from test_torch_data import ROOT, dataset_pair, write_coco_fixture
from test_torch_eval import (AP_TOL, _jax_loader, _port_loader,
                             _write_gt_from, assert_stats_close)
from test_torch_loop import _NoCheckpoints, data_options, read_log
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.data import TopDownDataset
from vitpose_tpu_torch.data.pipeline import (
    make_preprocess_fn as port_make_preprocess_fn)
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.models import infer
from vitpose_tpu_torch.tools import test as cli
from vitpose_tpu_torch.train import loop
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils import config
from vitpose_tpu_torch.utils.convert import cnn_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

COCO_CFG = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'coco')
HRNET = os.path.join(COCO_CFG, 'hrnet_w32_coco_256x192.py')
RES50 = os.path.join(COCO_CFG, 'res50_coco_256x192.py')
HRNET_OPTIONS = [
    'model.img_size=(64, 48)', 'model.dtype=float32',
    'model.backbone_overrides.width=8',
    'model.backbone_overrides.stage_modules=(1, 1)',
    'model.backbone_overrides.stage_blocks=1',
    'model.backbone_overrides.dtype=float32',
    'data.image_size=(48, 64)', 'data.heatmap_size=(12, 16)',
    'data.batch_size=4', 'data.num_workers=2']
RES18_OPTIONS = [
    'model.img_size=(64, 64)', 'model.backbone_overrides.depth=18',
    'model.deconv_filters=(16, 16, 16)',
    'data.image_size=(64, 64)', 'data.heatmap_size=(16, 16)',
    'data.batch_size=8', 'data.num_workers=2',
    'optimizer.base_lr=1e-3', 'optimizer.warmup_iters=2',
    'optimizer.warmup_ratio=0.1', 'optimizer.decay_epochs=(1,)',
    'optimizer.total_epochs=2', 'optimizer.grad_clip_norm=0.05',
    'runtime.log_interval=1', 'runtime.eval_interval=1',
    'runtime.ckpt_interval=10']
METRIC_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
PARAM_RMS_RATIO = 1e-2
# as in tests/test_torch_cnn.py: the share of the model's elements whose
# Adam step f32 noise may turn (measured 443 of 11,316,161, 3.9e-5), each
# within the two steps' lr (1e-4 + 5.5e-4)
FLIPPED_SHARE = 1e-4
MAX_LR = 6.5e-4
METRICS = ('heatmap_loss', 'grad_norm', 'acc_pose')


def val_options(coco):
    return [f"data.val.ann_file={coco['ann']}",
            f"data.val.img_prefix={coco['prefix']}",
            f"data.val.bbox_file={coco['det']}"]


def seeded_model(path, options, seed):
    """The config's port model from a seeded generator, BN redrawn; its
    JAX variables through JAX's converter, as numpy."""
    mcfg = config.apply_options(config.load_config(path), options)['model']
    model = randomize_bn(build_model_from_cfg(
        mcfg, torch.Generator().manual_seed(seed)), seed + 100).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, convert_generic_topdown_checkpoint(sd,
                                                     model.backbone_type)


# --- evaluation ----------------------------------------------------------------

@pytest.fixture(scope='module')
def hrnet_eval(tmp_path_factory):
    """(COCO fixture with GT from the port's predictions, port model, .npz
    of its weights, JAX's results on the same weights)."""
    root = tmp_path_factory.mktemp('cnn_eval')
    coco = write_coco_fixture(str(root / 'val'), seed=3)
    model, variables = seeded_model(HRNET, HRNET_OPTIONS, seed=40)
    npz = str(root / 'hrnet.npz')
    save_params_npz(npz, variables)
    cfg = model.cfg
    _write_gt_from(run_validation(model, _port_loader(coco),
                                  use_udp=cfg.use_udp,
                                  post_process=cfg.post_process),
                   coco, seed=4)
    jcfg = jax_apply_options(jax_load_config(HRNET), HRNET_OPTIONS)
    jm = jax_build(jcfg['model'])
    ref = jax_run_validation(jm, jax.tree.map(np.asarray, variables),
                             _jax_loader(coco), use_udp=jm.cfg.use_udp,
                             post_process=jm.cfg.post_process)
    return coco, model, npz, ref


def test_eval_cli_on_hrnet_config_matches_jax(hrnet_eval, tmp_path):
    """tools/test.py main() on the HRNet-W32 zoo config (cut by
    --cfg-options) and the .npz writes the stats of JAX's run_validation +
    evaluate; --int8 on a CNN raises."""
    coco, _, npz, ref = hrnet_eval
    out = str(tmp_path / 'stats.json')
    args = [HRNET, npz, '--device', 'cpu', '--cfg-options',
            *HRNET_OPTIONS, *val_options(coco)]
    stats = cli.main(args[:2] + ['--out', out] + args[2:])
    ref_ds, _ = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                             bbox_file=coco['det'])
    with open(out) as f:
        written = json.load(f)
    assert_stats_close(written, ref_ds.evaluate(ref), AP_TOL)
    assert written == {k: float(v) for k, v in stats.items()}
    assert 0 < written['AP'] < 1
    with pytest.raises(NotImplementedError, match='--int8'):
        cli.main(args + ['--int8'])


@pytest.mark.parametrize('kind', ['pth', 'npz'])
def test_init_pose_model_loads_cnn_checkpoints(hrnet_eval, tmp_path, kind):
    """A .pth in mmpose names (the port's state_dict, loaded strictly) and
    the JAX package's .npz export both give the source weights."""
    _, model, npz, _ = hrnet_eval
    if kind == 'pth':
        ckpt = str(tmp_path / 'hrnet.pth')
        torch.save({'state_dict': model.state_dict()}, ckpt)
    else:
        ckpt = npz
    pm = init_pose_model(dict(config.apply_options(
        config.load_config(HRNET), HRNET_OPTIONS)['model']), ckpt,
        device='cpu')
    assert pm.model.backbone_type == 'hrnet' and pm.image_size == (48, 64)
    for k, v in model.state_dict().items():
        assert torch.equal(pm.model.state_dict()[k], v), k
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 64, 48, 3)
                         .astype(np.float32))
    fi = pm.flip_index_tensor()
    with torch.no_grad():
        assert torch.equal(infer(pm.model, x, flip_index=fi),
                           infer(model, x, flip_index=fi))


# --- the runner ----------------------------------------------------------------

_eager_init = JaxGenericTopDown.init


def _zeros_init(self, rngs, *args, **kwargs):
    """Zeros of model.init's shapes, traced but not compiled: load_from
    replaces every value."""
    shapes = jax.eval_shape(functools.partial(_eager_init, self, **kwargs),
                            rngs, *args)
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _port_preprocess(**kw):
    """JAX's runner given the port's device preprocessing (crops and
    targets; tests/test_torch_train.py holds them to JAX's within 1e-5), so
    that both runners train on the same inputs."""
    fn = port_make_preprocess_fn(**kw)

    def preprocess(*args):
        out = fn(*(None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)) for a in args))
        return {k: jnp.asarray(v.numpy()) for k, v in out.items()}

    return preprocess


@pytest.fixture(scope='module')
def res18_runs(tmp_path_factory):
    """(JAX log, JAX final variables, port log, port final state, the
    initial state dict) of both runners on the cut ResNet-50 config."""
    root = tmp_path_factory.mktemp('cnn_loop')
    train = write_coco_fixture(str(root / 'train'), seed=0)
    val = write_coco_fixture(str(root / 'val'), seed=1)
    model, variables = seeded_model(RES50, RES18_OPTIONS, seed=50)
    ds = TopDownDataset(val['ann'], val['prefix'], image_size=(64, 64),
                        heatmap_size=(16, 16), test_mode=True,
                        use_gt_bbox=False, bbox_file=val['det'])
    _write_gt_from(run_validation(
        model, TopDownLoader(ds, 8, is_train=False, num_workers=2),
        use_udp=False), val, seed=5)
    npz = str(root / 'init.npz')
    save_params_npz(npz, variables)
    options = RES18_OPTIONS + data_options(train, val) + [f'load_from={npz}']
    # JAX's runner in f64 (its parameters f32, as loaded): see the module
    # docstring
    jcfg = jax_apply_options(jax_load_config(RES50), options)
    jax_dir = str(root / 'jax_run')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxGenericTopDown, 'init', _zeros_init)
        mp.setattr(jax_loop, 'CheckpointManager', _NoCheckpoints)
        mp.setattr(jax_loop, 'make_preprocess_fn', _port_preprocess)
        jstate = jax_loop.train_model(jcfg, work_dir=jax_dir, max_steps=2)
    jvars = {'params': jax.tree.map(np.asarray, jstate.params),
             'batch_stats': jax.tree.map(np.asarray, jstate.batch_stats)}
    port_cfg = config.apply_options(config.load_config(RES50), options)
    port_dir = str(root / 'port_run')
    state = loop.train_model(port_cfg, work_dir=port_dir, max_steps=2,
                             device='cpu')
    init = model.state_dict()
    return read_log(jax_dir), jvars, read_log(port_dir), state, init


def test_runner_on_resnet_config_matches_jax(res18_runs):
    jlog, jvars, log, state, init = res18_runs
    assert state.model.backbone_type == 'resnet'
    jtrain = [r for r in jlog if r['mode'] == 'train']
    train = [r for r in log if r['mode'] == 'train']
    assert [r['step'] for r in train] == [r['step'] for r in jtrain] \
        == [1, 2]
    for r, jr in zip(train, jtrain):
        for key in METRICS:
            np.testing.assert_allclose(r[key], jr[key], rtol=METRIC_RTOL,
                                       err_msg=f"step {r['step']} {key}")
    (jrec,) = [r for r in jlog if r['mode'] == 'epoch']
    (rec,) = [r for r in log if r['mode'] == 'epoch']
    assert 0 < rec['AP'] < 1
    for key, value in jrec.items():
        if key not in ('mode', 'epoch', 'epoch_time'):
            assert abs(rec[key] - value) <= AP_TOL, key
    expected = cnn_state_dict_from_flax(jvars, 'resnet')
    params = dict(state.model.named_parameters())
    flipped = 0
    for name, value in state.model.state_dict().items():
        if 'num_batches' in name:
            continue
        got, want = value.numpy(), expected[name].numpy()
        if name not in params:                       # BN running statistics
            np.testing.assert_allclose(got, want, **PARAM_TOL, err_msg=name)
            continue
        flipped += int((np.abs(got - want) > PARAM_TOL['atol']
                        + PARAM_TOL['rtol'] * np.abs(want)).sum())
        assert np.abs(got - want).max() <= 2 * MAX_LR, name
        update = want - init[name].numpy()
        assert np.sqrt(np.mean((got - want) ** 2)) <= PARAM_RMS_RATIO \
            * np.sqrt(np.mean(update ** 2)) + 1e-12, name
    assert flipped <= FLIPPED_SHARE * sum(p.numel() for p in params.values())

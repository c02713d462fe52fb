"""The port's ViTPose+ multi-dataset runner against the JAX package's on the
CPU, its resume, and the split of its `best.pth` scored by the evaluation
CLI.

The config is the shipped ViTPose+-B file, read in place, cut by
`--cfg-options`-style overrides to the small model of
tests/test_torch_models.py (64x48 crops, width 32, depth 2, 4 heads) with 3
experts of part_dim 8 and three train sets: COCO (17 joints, the main
head), MPII (16) and COCO-WholeBody (133), so every target is padded to
max_num_joints 133. The sets are the synthetic fixtures of
tests/test_torch_{data,zoo_data}.py, batch 3; the val set is COCO's whose
GT is rewritten from the port's predictions of the initial weights, so
that AP lies strictly between 0 and 1.

Both runners start from the same numpy variables (peaked as in
tests/test_torch_eval.py, drop_path 0): a stand-in for JAX's `model.init`
returns them, and one for the port's `build_model_from_cfg` loads them.
Then both apply `pretrained`, a dense backbone (the variables' fc2 with
expert 0's rows appended), so the run goes through the expert split.
JAX's CheckpointManager, which the run returns before using (max_steps),
is a stub that fails if it saves, and its programs compile at XLA CPU
optimisation level 0, as the other tests' JAX references do.

Tolerances, those of tests/test_torch_loop.py, at its base lr 1e-3:
per-step losses and grad_norm 1e-4 relative; the epoch-end COCO stats
1e-6; every parameter and BN statistic after the run 5e-5 absolute plus
1e-4 relative, and per tensor the RMS of the difference at most 1e-2 of
the RMS of the run's update. Rotation and scale augmentation are off: the
two libraries' warps leave the crops up to 1e-4 apart under the config's
rotations, and in a mixture a head's first gradient comes some steps in,
where Adam's bias correction makes its first update nearly lr * sign(g),
so an element whose gradient is as small as that difference would step
the other way (with both on, a few elements of the main head's deconv
kernels ended 1.9e-3 apart). Without them the largest difference is 3e-6.
Flips and half-body crops stay on. Resume is the port's own and exact: on
the CPU a resumed run equals the uninterrupted one bit for bit.
"""
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.train import loop as jax_loop

from test_torch_data import ROOT, write_coco_fixture
from test_torch_eval import _port_loader, _write_gt_from
from test_torch_loop import (COCO_B, PARAM_RMS_RATIO, PARAM_TOL,
                             _NoCheckpoints, assert_same, read_log)
from test_torch_models import SMALL, _peaked
from test_torch_moe import _moe_variables
from test_torch_zoo_data import write_kpt_fixture, write_mpii_fixture
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.tools import model_split
from vitpose_tpu_torch.tools import test as test_cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train import loop
from vitpose_tpu_torch.utils import config
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from vitpose_tpu_torch.utils.torch_ckpt import merge_moe_expert
from test_torch_threads import torch_test_threads  # noqa: F401

PLUS_B = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'coco',
                      'vitpose_plus_b_6datasets_256x192.py')
METRIC_RTOL = 1e-4
AP_TOL = 1e-6
HEADS = (17, 16, 133)
SMALL_GEOMETRY = [
    'model.img_size=(64, 48)', 'model.dtype=float32',
    'model.deconv_filters=(16, 16)',
    *(f'model.backbone_overrides.{k}={v}' for k, v in SMALL.items()),
    'model.backbone_overrides.drop_path_rate=0.0',
    'data.image_size=(48, 64)', 'data.heatmap_size=(12, 16)',
    'data.batch_size=3', 'data.num_workers=2']
MOE_OPTIONS = SMALL_GEOMETRY + [
    'model.num_experts=3', 'model.part_dim=8',
    f'model.extra_head_channels={HEADS[1:]}', 'model.num_extra_heads=2',
    'data.aug.rot_prob=0.0', 'data.aug.scale_factor=0.0',
    'optimizer.base_lr=1e-3', 'optimizer.warmup_iters=2',
    'optimizer.warmup_ratio=0.1', 'optimizer.decay_epochs=(1,)',
    'optimizer.total_epochs=2', 'optimizer.grad_clip_norm=0.05',
    'runtime.log_interval=1', 'runtime.eval_interval=1',
    'runtime.ckpt_interval=1']


def _moe_peaked(v):
    """`_peaked` for the ViTPose+ variables: the experts damped as fc2."""
    v = _peaked(v)
    for i in range(SMALL['depth']):
        v['params']['backbone'][f'blocks_{i}']['mlp']['expert_kernel'] *= 0.05
    return v


def _port_init(variables):
    """A `build_model_from_cfg` that loads `variables`."""
    build = loop.build_model_from_cfg

    def build_loaded(mcfg, generator=None):
        model = build(mcfg, generator)
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
        return model
    return build_loaded


def _cfg(options):
    return config.apply_options(config.load_config(PLUS_B), options)


@pytest.fixture(scope='module')
def fixture(tmp_path_factory):
    """{'root', 'variables' (the initial ones, numpy), 'options' (the
    config overrides), 'val' (the COCO val fixture)}."""
    root = tmp_path_factory.mktemp('moe_loop')
    coco = write_coco_fixture(str(root / 'coco'), seed=0)
    mpii = write_mpii_fixture(str(root / 'mpii'), seed=1)
    wb = write_kpt_fixture(str(root / 'wb'), seed=2, k=17, wholebody=True)
    val = write_coco_fixture(str(root / 'val'), seed=1)
    train = [dict(dataset=name, dataset_idx=i, ann_file=s['ann'],
                  img_prefix=s['prefix'])
             for i, (name, s) in enumerate((('coco', coco), ('mpii', mpii),
                                            ('coco_wholebody', wb)))]
    variables = _moe_peaked(_moe_variables(51, HEADS, drop_path_rate=0.0))
    # the dense backbone of `pretrained`: fc2 with expert 0 appended
    model = _port_init(variables)(_cfg(MOE_OPTIONS)['model'])
    dense = merge_moe_expert(model.state_dict(), 0, SMALL['depth'])
    pretrained = str(root / 'dense_backbone.pth')
    torch.save({'model': {k[len('backbone.'):]: t for k, t in dense.items()
                          if k.startswith('backbone.')}}, pretrained)
    loop.load_pretrained(model, pretrained)
    _write_gt_from(run_validation(model.eval(), _port_loader(val),
                                  expert_idx=0, head_idx=0), val, seed=2)
    options = MOE_OPTIONS + [
        f'data.train={train!r}', f"data.val.ann_file={val['ann']}",
        f"data.val.img_prefix={val['prefix']}",
        f"data.val.bbox_file={val['det']}", f'pretrained={pretrained}']
    return dict(root=root, variables=variables, options=options, val=val)


def make_cfg(fixture, *options):
    return _cfg(fixture['options'] + list(options))


def _jax_init(variables):
    def init(self, *args, **kwargs):
        return jax.tree.map(jnp.asarray, variables)
    return init


STEPS_PER_EPOCH = 6                   # 2 batches of each set
MAX_STEPS = STEPS_PER_EPOCH + 1       # an epoch and its evaluation, a step
RUN_OPTIONS = ('runtime.ckpt_interval=10',)


@pytest.fixture(scope='module')
def runs(fixture):
    """(JAX log, JAX final variables, port log, port final state)."""
    cfg = make_cfg(fixture, *RUN_OPTIONS)
    jax_dir = str(fixture['root'] / 'jax_run')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxTopDown, 'init', _jax_init(fixture['variables']))
        mp.setattr(jax_loop, 'CheckpointManager', _NoCheckpoints)
        mp.setattr(jax, 'jit', functools.partial(jax.jit, compiler_options={
            'xla_backend_optimization_level': 0}))
        jstate = jax_loop.train_model(cfg, work_dir=jax_dir,
                                      max_steps=MAX_STEPS)
    jvars = {'params': jax.tree.map(np.asarray, jstate.params),
             'batch_stats': jax.tree.map(np.asarray, jstate.batch_stats)}
    port_dir = str(fixture['root'] / 'port_run')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, 'build_model_from_cfg',
                   _port_init(fixture['variables']))
        state = loop.train_model(cfg, work_dir=port_dir,
                                 max_steps=MAX_STEPS, device='cpu')
    return read_log(jax_dir), jvars, read_log(port_dir), state


def test_moe_runner_trajectory_matches_jax(fixture, runs):
    """Every logged step's dataset and losses, every parameter and BN
    statistic after the run; every dataset of the mixture is trained, and
    each step's other heads have a loss of exactly 0."""
    jlog, jvars, log, state = runs
    jtrain = [r for r in jlog if r['mode'] == 'train']
    train = [r for r in log if r['mode'] == 'train']
    assert [r['step'] for r in train] == [r['step'] for r in jtrain] \
        == list(range(1, MAX_STEPS + 1))
    assert [(r['epoch'], r['iter'], r['dataset']) for r in train] == \
        [(r['epoch'], r['iter'], r['dataset']) for r in jtrain]
    assert {r['dataset'] for r in train} == {0, 1, 2}
    for r, jr in zip(train, jtrain):
        # the port logs the loader's wait and the time too
        assert set(r) == set(jr) | {'data_time', 'time'}
        for d in range(len(HEADS)):
            if d != r['dataset']:
                assert r[f'loss_{d}'] == jr[f'loss_{d}'] == 0.0
        for key in ('heatmap_loss', 'grad_norm', f"loss_{r['dataset']}"):
            np.testing.assert_allclose(r[key], jr[key], rtol=METRIC_RTOL,
                                       err_msg=f"step {r['step']} {key}")
    assert state.step == MAX_STEPS
    expected = state_dict_from_flax(jvars)
    own = state.model.state_dict()
    assert set(own) == set(expected)
    init = state_dict_from_flax(fixture['variables'])
    for name, value in own.items():
        if 'num_batches' in name:
            continue
        got, want = value.numpy(), expected[name].numpy()
        np.testing.assert_allclose(got, want, **PARAM_TOL, err_msg=name)
        if 'experts' not in name and 'mlp.fc2' not in name:
            # (the split replaces the initial experts and fc2)
            update = want - init[name].numpy()
            assert np.sqrt(np.mean((got - want) ** 2)) <= PARAM_RMS_RATIO \
                * np.sqrt(np.mean(update ** 2)), name


def test_moe_epoch_end_evaluation_matches_jax(runs):
    """Expert 0 and the main head, as JAX's runner evaluates."""
    jlog, _, log, _ = runs
    (jrec,) = [r for r in jlog if r['mode'] == 'epoch']
    (rec,) = [r for r in log if r['mode'] == 'epoch']
    assert set(rec) == set(jrec)
    assert 0 < rec['AP'] < 1
    for key, value in jrec.items():
        if key not in ('mode', 'epoch', 'epoch_time'):
            assert abs(rec[key] - value) <= AP_TOL, key


# resume, the CLI and model_split: drop_path 0.3 (the per-step DropPath
# seeds must replay)
OWN_OPTIONS = ('model.backbone_overrides.drop_path_rate=0.3',)


@pytest.fixture(scope='module')
def uninterrupted(fixture):
    """Two epochs through the training CLI, with an evaluation and a
    checkpoint after each."""
    work_dir = str(fixture['root'] / 'two_epochs')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, 'build_model_from_cfg',
                   _port_init(fixture['variables']))
        state = train_cli.main([PLUS_B, '--work-dir', work_dir, '--device',
                                'cpu', '--cfg-options', *fixture['options'],
                                *OWN_OPTIONS])
    return work_dir, state


def test_moe_resume_equals_the_uninterrupted_run(fixture, uninterrupted):
    work_dir, state = uninterrupted
    resumed = str(fixture['root'] / 'resumed')
    shutil.copytree(work_dir, resumed)
    os.remove(os.path.join(resumed, 'ckpts', 'epoch_1.pth'))
    os.remove(os.path.join(resumed, 'ckpts', 'info_1.json'))
    log_len = len(read_log(resumed))
    state2 = loop.train_model(make_cfg(fixture, *OWN_OPTIONS),
                              work_dir=resumed, resume=True, device='cpu')
    new = read_log(resumed)[log_len:]
    assert new[0] == {'mode': 'resume', 'epoch': 1}
    keys = ('step', 'dataset', 'heatmap_loss', 'loss_0', 'loss_1', 'loss_2',
            'grad_norm')
    ref = [r for r in read_log(work_dir) if r['mode'] == 'train'
           and r['epoch'] == 1]
    got = [r for r in new if r['mode'] == 'train']
    assert [[r[k] for k in keys] for r in got] == \
        [[r[k] for k in keys] for r in ref]
    assert state2.step == state.step == 2 * STEPS_PER_EPOCH
    ckpt = torch.load(os.path.join(resumed, 'ckpts', 'epoch_1.pth'),
                      map_location='cpu', weights_only=True)
    assert_same(ckpt, torch.load(os.path.join(work_dir, 'ckpts',
                                              'epoch_1.pth'),
                                 map_location='cpu', weights_only=True))
    assert 'backbone.blocks.0.mlp.experts.2.weight' in ckpt['model']


def test_model_split_of_best_pth_scores_the_logged_ap(fixture, uninterrupted,
                                                      tmp_path):
    """best.pth (mmpose names) split per dataset: the COCO checkpoint
    through the evaluation CLI with the plain COCO-B config scores the AP
    the runner logged for expert 0 and the main head."""
    work_dir, _ = uninterrupted
    with open(os.path.join(work_dir, 'ckpts', 'meta.json')) as f:
        meta = json.load(f)
    best = os.path.join(work_dir, 'ckpts', 'best.pth')
    out_dir = str(tmp_path / 'split')
    paths = model_split.main([best, '--out-dir', out_dir, '--datasets',
                              'coco', 'mpii', 'wholebody'])
    assert [os.path.basename(p) for p in paths] == \
        ['coco.pth', 'mpii.pth', 'wholebody.pth']
    for path, k in zip(paths, HEADS):
        sd = torch.load(path, map_location='cpu', weights_only=True)
        assert sd['keypoint_head.final_layer.weight'].shape[0] == k
        assert sd['backbone.blocks.1.mlp.fc2.weight'].shape[0] == \
            SMALL['embed_dim']
        assert not any('experts' in n or 'associate' in n for n in sd)
    val = fixture['val']
    stats = test_cli.main([
        COCO_B, paths[0], '--device', 'cpu', '--cfg-options',
        *SMALL_GEOMETRY, f"data.val.ann_file={val['ann']}",
        f"data.val.img_prefix={val['prefix']}",
        f"data.val.bbox_file={val['det']}"])
    assert 0 < stats['AP'] < 1
    assert abs(stats['AP'] - meta['best_value']) <= AP_TOL

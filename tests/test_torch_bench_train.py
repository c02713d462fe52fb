"""The port's bench_train (vitpose_tpu_torch/tools/analysis/bench_train.py)
on the CPU at a small size, held to the JAX package's
tools/analysis/bench_train.py:

  * the BENCH_* knobs read with JAX's names and defaults;
  * the grouped loop (2 steps of the tool's state: remat 'full', K1's path,
    the COCO layer-decay AdamW) against JAX's make_train_step on the same
    weights and numpy batches: losses and parameters after each step;
  * `main` prints {metric, imgs_per_sec, ms_per_step}; `main_e2e` in the
    canvas and crop modes prints JAX's keys (:305-315), and both wire
    formats give the same first-step loss;
  * the synthetic records: JAX's stack all 17 joints on one point, so a
    half-body draw gives a zero scale and JAX's preprocess a NaN crop; the
    port's spread them over the box (bench_io `synthetic_records`).

The model is the small ViT of tests/test_torch_models.py (width 32, depth
2, 64x48 crops for the step, the tool's 256x192 for main and main_e2e),
f32 with drop_path 0 where it is held to JAX. Tolerances: as
tests/test_torch_train.py, losses 1e-4 relative, parameters 1e-5 absolute
plus 1e-4 relative; the two wire formats' first losses 1e-4 relative (the
crop format rounds the warped crop to uint8, at most half a grey level a
pixel). JAX references compile at XLA optimisation level 0.
"""
import importlib.util
import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from vitpose_tpu.data import DatasetInfo as JaxDatasetInfo
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.data.pipeline import make_preprocess_fn as jax_preprocess_fn
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.train import optim as joptim
from vitpose_tpu.train.state import create_train_state as jax_create_state
from vitpose_tpu.train.step import make_train_step as jax_make_train_step

from test_torch_models import SMALL, _random_variables, _small
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.data.pipeline import make_preprocess_fn
from vitpose_tpu_torch.tools.analysis import bench_io, bench_train
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_F32 = dict(SMALL, drop_path_rate=0.0)
TINY = ['--device', 'cpu', '--backbone',
        *(f'{k}={v}' for k, v in SMALL_F32.items())]
STEPS = 2
BATCH = 2
KNOBS = ('BENCH_VARIANT', 'BENCH_BATCH', 'BENCH_TRAIN_GROUP',
         'BENCH_TRAIN_ITERS', 'BENCH_REMAT', 'BENCH_REMAT_POLICY',
         'BENCH_E2E', 'BENCH_E2E_IMGS', 'BENCH_E2E_STEPS', 'BENCH_E2E_MODE',
         'BENCH_E2E_CACHE')


@pytest.fixture
def bench_env(monkeypatch):
    """A clean BENCH_* environment; returns monkeypatch.setenv."""
    for key in KNOBS:
        monkeypatch.delenv(key, raising=False)
    return monkeypatch.setenv


def _jax_bench_train():
    path = os.path.join(ROOT, 'tools', 'analysis', 'bench_train.py')
    spec = importlib.util.spec_from_file_location('jax_bench_train', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('env', [{}, {'BENCH_VARIANT': 'h',
                                      'BENCH_BATCH': '32',
                                      'BENCH_TRAIN_GROUP': '2',
                                      'BENCH_TRAIN_ITERS': '5'}],
                         ids=['defaults', 'set'])
def test_knobs_read_as_jax_reads_them(bench_env, env):
    for key, value in env.items():
        bench_env(key, value)
    ref = _jax_bench_train()
    s = bench_train.settings()
    assert (s['variant'], s['batch'], s['group'], s['iters']) == (
        ref.VARIANT, ref.BATCH, ref.GROUP, ref.ITERS)
    assert (s['remat'], s['policy'], s['e2e_mode'], s['e2e_imgs'],
            s['e2e_steps'], s['e2e_cache']) == (True, 'full', 'canvas', 768,
                                                40, False)


def _batches():
    rng = np.random.RandomState(31)
    return {'imgs': rng.randn(STEPS, BATCH, 64, 48, 3).astype(np.float32),
            'target': rng.uniform(size=(STEPS, BATCH, 17, 16, 12)).astype(
                np.float32),
            'target_weight': np.ones((STEPS, BATCH, 17), np.float32)}


@pytest.fixture(scope='module')
def jax_steps():
    """(variables, [(loss, variables) after each step]) of JAX's
    make_train_step under the tool's optimizer."""
    jm = JaxTopDown(_small(jax_make_config, out_channels=17,
                           drop_path_rate=0.0))
    v = _random_variables(seed=32, out_channels=17)
    batches = _batches()
    first = {k: x[0] for k, x in batches.items()}
    tx = joptim.layer_decay_adamw(
        v['params'], joptim.OptimConfig(base_lr=5e-4, num_layers=2), 1000)
    state = jax_create_state(jm, jax.random.PRNGKey(0), first['imgs'], tx,
                             variables=v)
    step = jax.jit(jax_make_train_step(jm)).lower(
        state, first, jax.random.PRNGKey(1)).compile(
            compiler_options={'xla_backend_optimization_level': 0})
    out = []
    for i in range(STEPS):
        state, metrics = step(state, {k: x[i] for k, x in batches.items()},
                              jax.random.PRNGKey(1))
        out.append((float(metrics['heatmap_loss']),
                    {'params': jax.tree.map(np.asarray, state.params),
                     'batch_stats': jax.tree.map(np.asarray,
                                                 state.batch_stats)}))
    return v, out


def test_grouped_loop_matches_jax_steps(jax_steps):
    v, ref = jax_steps
    s = dict(bench_train.settings({}), group=STEPS, batch=BATCH)
    state, step = bench_train.train_setup(
        s, torch.device('cpu'), SMALL_F32, dtype='float32',
        img_size=(64, 48), deconv_filters=(16, 16))
    state.model.load_state_dict(state_dict_from_flax(v))
    group = {k: torch.from_numpy(x) for k, x in _batches().items()}
    losses = bench_train.run_group(state, step, group, torch.Generator())
    np.testing.assert_allclose(losses.detach().numpy(),
                               [loss for loss, _ in ref], rtol=1e-4)
    expected = state_dict_from_flax(ref[-1][1])
    for name, value in state.model.state_dict().items():
        if 'num_batches' not in name:
            np.testing.assert_allclose(value.numpy(), expected[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
    assert state.step == STEPS


def test_main_prints_the_step_rate(bench_env, capsys):
    for key, value in (('BENCH_BATCH', '2'), ('BENCH_TRAIN_GROUP', '2'),
                       ('BENCH_TRAIN_ITERS', '1')):
        bench_env(key, value)
    out = bench_train.main(TINY)
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert list(rec) == ['metric', 'imgs_per_sec', 'ms_per_step', 'card']
    assert rec['metric'] == 'vitpose_b_256x192_train'
    assert rec['imgs_per_sec'] > 0 and rec['ms_per_step'] > 0
    assert out['launches'] == {'k1': 0, 'k2': 0}


E2E_KEYS = ['metric', 'mode', 'cache', 'e2e_imgs_per_sec',
            'loader_imgs_per_sec', 'step_imgs_per_sec', 'fed',
            'host_processes_needed', 'card']


def test_main_e2e_modes_print_jaxs_keys_and_agree(bench_env, capsys):
    for key, value in (('BENCH_E2E', '1'), ('BENCH_E2E_IMGS', '8'),
                       ('BENCH_BATCH', '4'), ('BENCH_E2E_STEPS', '1')):
        bench_env(key, value)
    first = {}
    for mode in ('canvas', 'crop'):
        bench_env('BENCH_E2E_MODE', mode)
        out = bench_train.main(TINY)
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert list(rec) == E2E_KEYS
        assert rec['metric'] == 'vitpose_b_256x192_train_e2e'
        assert rec['mode'] == mode and rec['cache'] is False
        assert rec['host_processes_needed'] >= 1
        assert all(rec[k] > 0 for k in E2E_KEYS[3:6])
        first[mode] = out['first_loss']
    assert np.isfinite(first['canvas'])
    np.testing.assert_allclose(first['crop'], first['canvas'], rtol=1e-4)


def _jax_records(paths):
    """JAX's bench records (tools/analysis/bench_train.py:150-160): every
    joint at (300, 200)."""
    return [dict(
        image_file=p, bbox=np.asarray([200.0, 120.0, 240.0, 320.0],
                                      np.float32),
        rotation=0,
        joints_3d=np.tile(np.asarray([[300.0, 200.0, 0.0]], np.float32),
                          (17, 1)),
        joints_3d_visible=np.tile(np.asarray([[1.0, 1.0, 0.0]], np.float32),
                                  (17, 1)),
        bbox_score=1.0, bbox_id=i, image_id=i, dataset_idx=0)
        for i, p in enumerate(paths)]


def test_jaxs_stacked_joints_give_a_nan_crop_the_ports_do_not():
    """The first training batch of 4 of 8 images: on JAX's records a
    half-body draw makes a zero scale, which JAX's own preprocess turns
    into a NaN crop; on the port's records no scale is zero and no crop
    NaN."""
    keys = ('imgs', 'center', 'scale', 'rot', 'joints', 'vis', 'flip')
    with tempfile.TemporaryDirectory() as tmp:
        paths = bench_io.make_jpegs(tmp, 8)

        class JaxSet:
            db = _jax_records(paths)
            num_joints = 17
            image_size = bench_train.CROP
            heatmap_size = bench_train.HEATMAP
            info = JaxDatasetInfo.load('coco')
            dataset_idx = 0
            name = 'synthetic'

        jb = next(iter(JaxTopDownLoader(JaxSet(), 4, is_train=True,
                                        canvas_size=640, seed=0)))
        pb = next(iter(TopDownLoader(
            bench_io.SyntheticSet(paths, bench_train.CROP,
                                  bench_train.HEATMAP),
            4, is_train=True, canvas_size=640, seed=0)))
    jpre = jax.jit(jax_preprocess_fn(image_size=bench_train.CROP,
                                     heatmap_size=bench_train.HEATMAP))
    jimgs = np.asarray(jpre(*(np.asarray(jb[k]) for k in keys))['imgs'])
    zero = (np.asarray(jb['scale']) == 0).all(1)
    assert zero.any()
    assert np.isnan(jimgs).reshape(4, -1).any(1).tolist() == zero.tolist()
    pre = make_preprocess_fn(image_size=bench_train.CROP,
                             heatmap_size=bench_train.HEATMAP)
    pimgs = pre(*(torch.as_tensor(np.asarray(pb[k])) for k in keys))['imgs']
    assert (np.asarray(pb['scale']) > 0).all()
    assert torch.isfinite(pimgs).all()

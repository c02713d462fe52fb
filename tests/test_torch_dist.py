"""Training and evaluation across processes on the CPU
(vitpose_tpu_torch/parallel/): the top-down steps of two gloo ranks against
the one-process step over the same global batch and against the JAX
package, and the training and evaluation CLIs on two ranks.

One two-rank group (tests/torch_dist_worker.py, started by the module
fixture; a file store in tmp_path, every collective limited to the group's
timeout, a failed rank kills both) runs every case of this file while the
test process compiles the JAX references. The small ViTPose of
tests/test_torch_models.py (64x48, width 32, depth 2) and an HRNet-W8 with
one exchange stage; global batches of 4 rows, 2 a rank (the global batch's
rows r, r + 2 on rank r).

  * the data axis: the ViT step with ZeRO-1 (2 steps, drop path 0, against
    JAX's one-device step), the same without ZeRO-1 (equal to it), the ViT
    with stochastic depth (the masks are the global batch's), ViTPose+ with
    four datasets mixed in each batch, and HRNet in float64, whose BN
    statistics are the global batch's (also as tests/test_bn_mesh.py pins
    them for JAX);
  * the expert and model axes: ViTPose+ on (data 1, expert 2) and (data 1,
    expert 1, model 2), held to JAX's shard_train_step on the same meshes,
    and the plain ViT's FFN split over the model axis against one process;
  * the CLIs: the training CLI with ZeRO-1 and --autoscale-lr (rank-0 logs
    and checkpoints, an exact resume), the ViTPose+ runner with
    runtime.n_expert=2 (an exact resume), and the evaluation CLI's gather
    through --tmpdir against one process's AP.

Tolerances: between the two ranks and one process the metrics agree within
1e-5 relative and the parameters within 1e-6 absolute plus 1e-5 relative
(f32 sums in another order; float64: 1e-10 and 1e-9); against JAX the
repo's: metrics 1e-4 (1e-5 for ViTPose+), parameters 1e-5 absolute plus
1e-4 relative. Where a parameter's gradient is near zero, Adam's first
step moves it by about +-lr on either side whatever its noise, so the
parameters are held by the repo's rule (tests/test_torch_bottomup.py
FLIPPED_SHARE: at most that share outside the tolerance, none beyond two
steps' lr). chip_smoke.py's `dist` phase holds two ranks on the card to one
process by the same kind of rule: HRNet-W32 in float64 within
DIST_F64_RTOL, ViTPose-B in bf16 within DIST_GRAD_RTOL.
"""
import dataclasses
import json
from concurrent import futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.parallel import mesh as jmesh
from vitpose_tpu.train import optim as joptim
from vitpose_tpu.train.state import create_train_state as jax_create_state
from vitpose_tpu.train.step import make_moe_train_step as jax_moe_step
from vitpose_tpu.train.step import make_train_step as jax_train_step
from vitpose_tpu.utils.checkpoint import save_params_npz

from test_torch_bottomup import FLIPPED_SHARE
from test_torch_cnn import TRAIN_OPTIM, jax_train_steps, port_model
from test_torch_cnn import jax_variables as cnn_jax_variables
from test_torch_data import COCO_B, write_coco_fixture
from test_torch_eval import _port_loader, _write_gt_from
from test_torch_loop import SMALL_OPTIONS, data_options, read_log
from test_torch_moe_loop import PLUS_B, SMALL_GEOMETRY
from test_torch_models import (_fill, _peaked, _port_model,
                               _random_variables, _small)
from test_torch_train import TRAJ_OPTIM, _joints, _t
from test_torch_zoo_data import write_mpii_fixture
from torch_dist_worker import DistRun
from vitpose_tpu_torch.models import TopDownModel, make_config
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.ops import target as ttarget
from vitpose_tpu_torch.tools import test as eval_cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.utils.convert import (cnn_state_dict_from_flax,
                                             state_dict_from_flax)
from test_torch_threads import torch_test_threads  # noqa: F401

ONE_TOL = dict(rtol=1e-5, atol=1e-6)     # two ranks against one process
JAX_TOL = dict(rtol=1e-4, atol=1e-5)     # against the JAX package
HEADS = (5, 3, 6, 4)                     # ViTPose+: four datasets, experts
EXPERTS, PART = 4, 8
MOE_IDX = (np.array([0, 3, 1, 2]), np.array([2, 0, 3, 0]))
MOE_OPTIM = dict(TRAJ_OPTIM, weight_decay=0.5)
# HRNet-W8 with one exchange stage (two branches) and the simple head
HR = dict(backbone_type='hrnet', backbone_overrides=dict(
    width=8, stage_modules=(1,), stage_blocks=1), deconv_filters=(),
    img_size=(64, 48), out_channels=17)
# the lrs of the two steps of TRAJ_OPTIM and TRAIN_OPTIM (warmup from 1e-4)
LR_SUM = 1e-4 + 5.5e-4


def _moe_cfg(make, **backbone):
    cfg = _small(make, out_channels=HEADS[0], num_experts=EXPERTS,
                 part_dim=PART, **backbone)
    return dataclasses.replace(cfg, num_extra_heads=len(HEADS) - 1,
                               extra_head_channels=HEADS[1:])


def _heatmap_batch(seed, n=4, k=5, hw=(64, 48), hm=(16, 12), idx=None):
    rng = np.random.RandomState(seed)
    imgs = rng.randn(n, *hw, 3).astype(np.float32)
    joints, vis = _joints(seed + 1, n=n, k=k, lo=0.0, hi=float(hw[1]))
    target, weight = ttarget.generate_udp_heatmaps(
        _t(joints), _t(vis), hw[::-1], hm[::-1])
    b = {'imgs': imgs, 'target': target.numpy(),
         'target_weight': weight.numpy()}
    if idx is not None:
        b['dataset_idx'] = idx
    return b


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """The weights (.pt files for the ranks), the global batches and the
    JAX variables of every case."""
    d = tmp_path_factory.mktemp('dist_inputs')
    out = {'dir': d}
    v = _random_variables(seed=11)
    out['vit'] = (v, [_heatmap_batch(40), _heatmap_batch(41)])
    torch.save(state_dict_from_flax(v), d / 'vit.pt')
    module = JaxTopDown(_moe_cfg(jax_make_config))
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)),
        expert_idx=jnp.zeros(1, jnp.int32), all_heads=True))
    mv = _fill(shapes, 32)
    out['moe'] = (mv, [_heatmap_batch(50 + i, k=max(HEADS), idx=idx)
                       for i, idx in enumerate(MOE_IDX)])
    torch.save(state_dict_from_flax(mv), d / 'moe.pt')
    mdict = HR
    model = port_model(mdict, seed=20)
    with torch.no_grad():
        hm = tuple(model(torch.zeros(1, 64, 48, 3)).shape[2:])
    out['hrnet'] = (model, [_heatmap_batch(60, k=17, hm=hm)])
    torch.save(model.state_dict(), d / 'hrnet.pt')
    # tests/test_bn_mesh.py's batch: each rank's rows offset by its rank
    rng = np.random.RandomState(0)
    imgs = rng.rand(4, 64, 48, 3).astype(np.float32)
    imgs += (np.arange(4) % 2)[:, None, None, None].astype(np.float32)
    out['bn'] = dict(imgs=imgs,
                     target=rng.rand(4, 5, 16, 12).astype(np.float32),
                     weight=np.ones((4, 5), np.float32))
    # the CLIs: tests/test_torch_loop.py's COCO fixtures and small config,
    # a global batch of 4
    train = write_coco_fixture(str(d / 'train'), seed=0)
    val = write_coco_fixture(str(d / 'val'), seed=1)
    variables = _peaked(_random_variables(1, out_channels=17))
    model = _port_model(_small(make_config, out_channels=17), variables)
    _write_gt_from(run_validation(model, _port_loader(val)), val, seed=2)
    out['npz'] = str(d / 'init.npz')
    save_params_npz(out['npz'], variables)
    out['options'] = (SMALL_OPTIONS + data_options(train, val)
                      + ['data.batch_size=4', f"load_from={out['npz']}"])
    # a ViTPose+ mixture of COCO and MPII, two experts over two ranks
    mpii = write_mpii_fixture(str(d / 'mpii'), seed=1)
    sets = [dict(dataset=name, dataset_idx=i, ann_file=x['ann'],
                 img_prefix=x['prefix'])
            for i, (name, x) in enumerate((('coco', train), ('mpii', mpii)))]
    out['moe_options'] = SMALL_GEOMETRY + [
        'model.num_experts=2', 'model.part_dim=8',
        'model.extra_head_channels=(16,)', 'model.num_extra_heads=1',
        'data.max_num_joints=17', 'data.batch_size=2', 'runtime.n_expert=2',
        'optimizer.total_epochs=2', 'runtime.log_interval=1',
        'runtime.eval_interval=1', 'runtime.ckpt_interval=1',
        f'data.train={sets!r}', f"data.val.ann_file={val['ann']}",
        f"data.val.img_prefix={val['prefix']}",
        f"data.val.bbox_file={val['det']}"]
    return out


@pytest.fixture(scope='module')
def group(inputs, tmp_path_factory):
    """The two ranks, running every case of this file."""
    d = inputs['dir']
    vit = dict(model_path=str(d / 'vit.pt'), batches=inputs['vit'][1],
               optim=TRAJ_OPTIM, cfg_kw=dict(drop_path_rate=0.0))
    moe = dict(model_path=str(d / 'moe.pt'), batches=inputs['moe'][1],
               optim=MOE_OPTIM, moe_heads=len(HEADS),
               cfg_kw=dict(heads=HEADS[1:], out_channels=HEADS[0],
                           num_experts=EXPERTS, part_dim=PART,
                           drop_path_rate=0.0))
    hrnet = dict(mdict=HR, model_path=str(d / 'hrnet.pt'),
                 batches=inputs['hrnet'][1] * 2, optim=TRAIN_OPTIM)
    cases = [
        ('topdown_steps:vit_zero1', dict(vit, zero1=True)),
        ('topdown_steps:vit', vit),
        ('topdown_steps:droppath', dict(vit, cfg_kw=dict(
            drop_path_rate=0.5))),
        ('topdown_steps:vit_model', dict(vit, layout=(1, 1, 2))),
        ('topdown_steps:moe', moe),
        ('topdown_steps:moe_expert', dict(moe, layout=(1, 2, 1))),
        ('topdown_steps:moe_model', dict(moe, layout=(1, 1, 2))),
        ('cnn_steps:hrnet_f64', dict(hrnet, f64=True)),
        ('bn_stats', dict(model_path=str(d / 'vit.pt'), **inputs['bn'])),
    ]
    opts = inputs['options']

    def train(work_dir, *extra, resume=False):
        return dict(args=[COCO_B, '--work-dir', str(d / work_dir),
                          '--device', 'cpu', '--autoscale-lr']
                    + ['--resume'] * resume
                    + ['--cfg-options', *opts, 'runtime.zero1=True',
                       *extra])
    def moe(work_dir, *extra, resume=False):
        return dict(args=[PLUS_B, '--work-dir', str(d / work_dir),
                          '--device', 'cpu'] + ['--resume'] * resume
                    + ['--cfg-options', *inputs['moe_options'], *extra])
    cases += [
        ('train_cli:moe_whole', moe('moe_whole')),
        ('train_cli:moe_part', moe('moe_resumed',
                                   'optimizer.total_epochs=1')),
        ('train_cli:moe_resumed', moe('moe_resumed', resume=True)),
        ('train_cli:whole', train('whole')),
        ('train_cli:part', train('resumed', 'optimizer.total_epochs=1')),
        ('train_cli:resumed', train('resumed', resume=True)),
        ('eval_cli', dict(args=[COCO_B, inputs['npz'], '--device', 'cpu',
                                '--tmpdir', str(d / 'gather'), '--out',
                                str(d / 'stats.json'), '--cfg-options',
                                *opts])),
    ]
    run = DistRun(tmp_path_factory.mktemp('dist_group'), cases)
    yield run
    run.close()


def _jax_steps(module, step_fn, variables, batches, optim, mesh=None):
    """[(metrics, variables)] after each of JAX's steps over `batches` from
    `variables`: one device, or `mesh` through shard_train_step; compiled
    at XLA level 0."""
    tx = joptim.layer_decay_adamw(variables['params'],
                                  joptim.OptimConfig(**optim), 1)
    state = jax_create_state(module, jax.random.PRNGKey(0),
                             batches[0]['imgs'], tx, variables=variables)
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    rng = jax.random.PRNGKey(1)
    if mesh is None:
        step = jax.jit(step_fn)
        place = lambda b: b  # noqa: E731
    else:
        state = jax.tree.map(
            lambda x: np.asarray(x) if hasattr(x, 'shape') else x, state)
        step, state, place = jmesh.shard_train_step(step_fn, mesh, state,
                                                    jb[0])
    step = step.lower(state, place(jb[0]), rng).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    out = []
    for b in jb:
        state, metrics = step(state, place(b), rng)
        out.append((jax.tree.map(np.asarray, metrics),
                    {'params': jax.tree.map(np.asarray, state.params),
                     'batch_stats': jax.tree.map(np.asarray,
                                                 state.batch_stats)}))
    return out


@pytest.fixture(scope='module')
def jax_refs(group, inputs):
    """JAX's steps, computed while the ranks run (XLA compiles without the
    GIL: three at a time)."""
    v, vit_batches = inputs['vit']
    vit = JaxTopDown(_small(jax_make_config, drop_path_rate=0.0))
    mv, moe_batches = inputs['moe']
    moe = JaxTopDown(_moe_cfg(jax_make_config, drop_path_rate=0.0))
    step = jax_moe_step(moe, len(HEADS))
    devs = jax.devices()[:2]
    model, hr_batches = inputs['hrnet']
    runs = {
        'hrnet': lambda: jax_train_steps(
            HR, cnn_jax_variables(model, HR['backbone_type']),
            hr_batches[0], f64=True),
        'vit': lambda: _jax_steps(vit, jax_train_step(vit), v, vit_batches,
                                  TRAJ_OPTIM),
        'moe': lambda: _jax_steps(moe, step, mv, moe_batches, MOE_OPTIM),
        'moe_expert': lambda: _jax_steps(
            moe, step, mv, moe_batches, MOE_OPTIM,
            jmesh.make_mesh(n_data=1, n_expert=2, devices=devs)),
        'moe_model': lambda: _jax_steps(
            moe, step, mv, moe_batches, MOE_OPTIM,
            jmesh.make_mesh(n_data=1, n_expert=1, n_model=2, devices=devs)),
    }
    with futures.ThreadPoolExecutor(3) as pool:
        runs = {k: pool.submit(f) for k, f in runs.items()}
        return {k: f.result() for k, f in runs.items()}


def _assert_sd_close(got, want, tol, what, lr_sum=None,
                     share=FLIPPED_SHARE):
    """Every entry of the state dict `want` in `got` within `tol`; with
    `lr_sum` (the lrs of the steps) the repo's rule for Adam's first step
    (tests/test_torch_bottomup.py): a parameter element whose gradient is
    near zero moves by about +-lr on either side whatever its f32 noise,
    so at most `share` of the parameters' elements may lie outside `tol`,
    none farther than 2 * lr_sum. BN statistics are held to `tol`."""
    off, size = 0, 0
    for name, w in want.items():
        if 'num_batches' in name:
            continue
        g, w = got[name], np.asarray(w)
        if lr_sum is None or 'running_' in name:
            np.testing.assert_allclose(g, w, **tol, err_msg=f'{what}: {name}')
            continue
        assert np.abs(g - w).max() <= 2 * lr_sum, (what, name)
        off += int((np.abs(g - w) > tol['atol']
                    + tol['rtol'] * np.abs(w)).sum())
        size += w.size
    assert off <= share * size, (what, off, size)


def _assert_metrics_close(got, want, rtol, what, keys=None):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys or w:
            np.testing.assert_allclose(g[k], float(w[k]), rtol=rtol,
                                       atol=1e-7,
                                       err_msg=f'{what} step {i} {k}')


def _results(group, case):
    r0, r1 = group.results()
    return r0[case], r1[case]


def test_vit_zero1_step_matches_one_process_and_jax(group, jax_refs):
    """Two ViT steps on two ranks with ZeRO-1 equal the one-process steps
    over the global batch and JAX's; both ranks hold the same parameters."""
    r0, r1 = _results(group, 'topdown_steps:vit_zero1')
    one, dist = r0['one'], r0['dist']
    _assert_metrics_close(dist['metrics'], one['metrics'], 1e-5, 'one')
    _assert_sd_close(dist['sd'], one['sd'], ONE_TOL, 'one process', LR_SUM)
    for k, v in dist['sd'].items():
        np.testing.assert_array_equal(v, r1['dist']['sd'][k], err_msg=k)
    ref = jax_refs['vit']
    _assert_metrics_close(dist['metrics'], [m for m, _ in ref], 1e-4, 'jax',
                          keys=('heatmap_loss', 'grad_norm', 'acc_pose'))
    _assert_sd_close(dist['sd'], state_dict_from_flax(ref[-1][1]), JAX_TOL,
                     'jax', LR_SUM)


def test_zero1_splits_the_moments_and_keeps_the_step(group):
    """ZeRO-1: each rank holds AdamW's state of a part of the parameters
    (together every one, once), and the step equals the replicated one."""
    z0, z1 = _results(group, 'topdown_steps:vit_zero1')
    owned0, owned1 = set(z0['dist']['owned']), set(z1['dist']['owned'])
    every = set(z0['one']['owned'])
    assert owned0 and owned1 and not owned0 & owned1
    assert owned0 | owned1 == every
    plain = _results(group, 'topdown_steps:vit')[0]['dist']
    assert set(plain['owned']) == every
    _assert_sd_close(z0['dist']['sd'], plain['sd'],
                     dict(rtol=0, atol=0), 'replicated')
    assert z0['dist']['metrics'] == plain['metrics']


def test_droppath_masks_are_the_global_batchs(group):
    """Stochastic depth at 0.5: each rank keeps its rows of the global
    batch's masks, so two ranks train as one process does."""
    r0, _ = _results(group, 'topdown_steps:droppath')
    _assert_metrics_close(r0['dist']['metrics'], r0['one']['metrics'], 1e-5,
                          'droppath')
    _assert_sd_close(r0['dist']['sd'], r0['one']['sd'], ONE_TOL, 'droppath',
                     LR_SUM)
    plain = _results(group, 'topdown_steps:vit')[0]['one']
    assert plain['metrics'][0]['heatmap_loss'] != \
        r0['one']['metrics'][0]['heatmap_loss']      # the masks dropped


def test_vitpose_plus_mixed_datasets_match(group, jax_refs):
    """ViTPose+ with four datasets mixed in each batch (rank 0's rows hold
    datasets 0 and 1, then 2 and 3): both steps equal one process and
    JAX's."""
    r0, _ = _results(group, 'topdown_steps:moe')
    _assert_metrics_close(r0['dist']['metrics'], r0['one']['metrics'], 1e-5,
                          'one')
    _assert_sd_close(r0['dist']['sd'], r0['one']['sd'], ONE_TOL, 'one', LR_SUM)
    ref = jax_refs['moe']
    _assert_metrics_close(r0['dist']['metrics'], [m for m, _ in ref], 1e-5,
                          'jax')
    _assert_sd_close(r0['dist']['sd'], state_dict_from_flax(ref[-1][1]),
                     JAX_TOL, 'jax', LR_SUM)


@pytest.mark.parametrize('axis', ['expert', 'model'])
def test_expert_and_model_axes_match_jax_mesh(group, jax_refs, axis):
    """ViTPose+ with its experts (expert axis: two of the four a rank) or
    its FFNs (model axis: half of fc1's outputs, fc2's inputs and the
    experts' hidden dimension a rank) split over the two ranks: the
    gathered weights after two steps equal JAX's shard_train_step on the
    same mesh, and each rank held its block only."""
    r0, r1 = _results(group, f'topdown_steps:moe_{axis}')
    ref = jax_refs[f'moe_{axis}']
    for r in (r0, r1):
        _assert_metrics_close(r['dist']['metrics'], [m for m, _ in ref],
                              1e-5, axis)
    _assert_sd_close(r0['dist']['sd'], state_dict_from_flax(ref[-1][1]),
                     JAX_TOL, axis, LR_SUM)
    _assert_sd_close(r0['dist']['sd'], r0['one']['sd'], ONE_TOL, 'one', LR_SUM)
    # the optimizer's moments have the blocks' shapes: nothing whole
    assert r0['dist']['owned'] == r0['one']['owned']


def test_plain_vit_model_axis_matches_one_process(group):
    """The plain ViT's Mlp split over the model axis (Megatron's f and g
    around it, fc2's bias added once) trains as one process."""
    r0, r1 = _results(group, 'topdown_steps:vit_model')
    for r in (r0, r1):
        _assert_metrics_close(r['dist']['metrics'], r0['one']['metrics'],
                              1e-5, 'model axis')
    _assert_sd_close(r0['dist']['sd'], r0['one']['sd'], ONE_TOL, 'model',
                     LR_SUM)


def test_hrnet_global_bn_steps_match(group, jax_refs):
    """HRNetV2 (BN after every conv, each over the global batch's rows of
    both ranks), in float64 as tests/test_torch_cnn_more_paths.py holds
    deep random BN nets (in f32 they amplify rounding): two steps equal one
    process, and JAX's float64 steps under the repo's rule for Adam's first
    step."""
    r0, _ = _results(group, 'cnn_steps:hrnet_f64')
    one, dist = r0['one'], r0['dist']
    _assert_metrics_close(dist['metrics'], one['metrics'], 1e-10, 'one')
    _assert_sd_close(dist['sd'], one['sd'], dict(rtol=1e-9, atol=1e-12),
                     'one', LR_SUM)
    ref = jax_refs['hrnet']
    _assert_metrics_close(dist['metrics'], [m for m, _, _ in ref], 1e-5,
                          'jax', keys=('heatmap_loss', 'grad_norm',
                                       'acc_pose'))
    _assert_sd_close(dist['sd'], cnn_state_dict_from_flax(ref[-1][1],
                                                          'hrnet'),
                     dict(rtol=1e-5, atol=1e-6), 'jax', LR_SUM)


def test_bn_statistics_are_the_global_batchs(group):
    """tests/test_bn_mesh.py for the port: after a training-mode step
    on two ranks whose rows differ by 1.0, the running statistics equal
    those of one process over the global batch and differ from either
    rank's own rows'."""
    r0, r1 = _results(group, 'bn_stats')
    assert r0['one']
    for r in (r0, r1):
        _assert_sd_close(r['dist'], r0['one'], dict(rtol=1e-4, atol=1e-5),
                         'sync-BN')
        assert any(not np.allclose(r['local'][k], r0['one'][k], atol=1e-3)
                   for k in r0['one'] if 'running_mean' in k)


# --- no group ---------------------------------------------------------------

def test_make_mesh_refuses_axes_that_do_not_factor_the_world():
    from vitpose_tpu_torch.parallel import make_mesh
    with pytest.raises(ValueError, match='must factor'):
        make_mesh(n_data=2)
    layout = make_mesh()
    assert (layout.n_data, layout.n_expert, layout.n_model) == (1, 1, 1)
    assert not layout.groups


def test_init_distributed_reads_three_contracts(monkeypatch):
    """A no-op in one process; torchrun's, the JAX package's and SLURM's
    environments parsed into the rank, the world, the card and the
    rendezvous."""
    from vitpose_tpu_torch.parallel import distributed as d
    assert d.cluster_env({}) is None
    assert d.init_distributed(device='cpu') == (0, 1)
    assert d.cluster_env(dict(RANK='3', WORLD_SIZE='8', LOCAL_RANK='1',
                              MASTER_ADDR='10.0.0.1', MASTER_PORT='1234')) \
        == dict(rank=3, world=8, local_rank=1, source='torchrun',
                init_method='tcp://10.0.0.1:1234')
    assert d.cluster_env(dict(RANK='0', WORLD_SIZE='1')) is None
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert d.cluster_env(dict(COORDINATOR_ADDRESS='host:9999',
                              NUM_PROCESSES='8', PROCESS_ID='6')) \
        == dict(rank=6, world=8, local_rank=2, source='coordinator',
                init_method='tcp://host:9999')
    assert d.cluster_env(dict(SLURM_NTASKS='16', SLURM_PROCID='9',
                              SLURM_LOCALID='1',
                              SLURM_JOB_NODELIST='gpu[03-05,07],cpu1')) \
        == dict(rank=9, world=16, local_rank=1, source='slurm',
                init_method='tcp://gpu03:29500')
    assert d.cluster_env(dict(SLURM_NTASKS='1')) is None
    with pytest.raises(KeyError):
        d.cluster_env(dict(RANK='0', WORLD_SIZE='2'))   # no master


def test_unknown_vit_head_raises_value_error_as_jax():
    """An unknown head_type of a ViT raises ValueError(head_type) in both
    packages."""
    with pytest.raises(ValueError, match='bogus'):
        JaxTopDown(dataclasses.replace(_small(jax_make_config),
                                       head_type='bogus')).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)))
    with pytest.raises(ValueError, match='bogus'):
        TopDownModel(dataclasses.replace(_small(make_config),
                                         head_type='bogus'))


# --- the CLIs across the two ranks -------------------------------------------

def test_train_cli_logs_and_saves_from_rank_0_and_resumes_exactly(group,
                                                                   inputs):
    """The training CLI on two ranks with ZeRO-1 (COCO fixtures, a global
    batch of 4, two epochs with validation): iteration 0 of each epoch is
    logged once, only rank 0 writes checkpoints, which hold AdamW's state
    whole, --autoscale-lr scales by 2 / 8, and a run stopped after epoch 0
    and resumed ends where the whole run does, bit for bit, on both
    ranks."""
    r0, r1 = group.results()
    whole0, whole1 = r0['train_cli:whole'], r1['train_cli:whole']
    assert whole0['lr'] == pytest.approx(1e-3 * 2 / 8)
    assert whole0['writes'] > 0 and whole1['writes'] == 0
    log = read_log(str(inputs['dir'] / 'whole'))
    firsts = [r for r in log if r['mode'] == 'train' and r['iter'] == 0]
    assert [r['epoch'] for r in firsts] == [0, 1]
    assert sum(r['mode'] == 'epoch' for r in log) == 2
    assert all('AP' in r for r in log if r['mode'] == 'epoch')
    for r in (r0, r1):
        resumed = r['train_cli:resumed']
        assert r['train_cli:part']['step'] < resumed['step'] \
            == whole0['step']
        for k, v in whole0['sd'].items():
            np.testing.assert_array_equal(resumed['sd'][k], v, err_msg=k)
    rlog = read_log(str(inputs['dir'] / 'resumed'))
    assert [r['epoch'] for r in rlog if r['mode'] == 'resume'] == [1]
    ckpt = torch.load(inputs['dir'] / 'whole' / 'ckpts' / 'epoch_1.pth',
                      weights_only=True)
    groups = ckpt['optimizer']['param_groups']
    assert sorted(ckpt['optimizer']['state']) == sorted(
        i for g in groups for i in g['params'])
    assert len(ckpt['optimizer']['state']) == len(whole0['sd']) - sum(
        'running_' in k or 'num_batches' in k for k in whole0['sd'])


def test_eval_cli_gathers_every_record_and_scores_as_one_process(
        group, inputs):
    """The evaluation CLI on two ranks with --tmpdir: rank 0 merges every
    box once (the padding to equal shards repeats at most one) and its AP
    equals one process's; the other rank returns None."""
    r0, r1 = group.results()
    got = r0['eval_cli']
    assert r1['eval_cli']['stats'] is None and got['stats'] is not None
    args = [COCO_B, inputs['npz'], '--device', 'cpu', '--cfg-options',
            *inputs['options']]
    want = eval_cli.main(args)
    loader = eval_cli.build_eval_objects(
        eval_cli.apply_options(eval_cli.load_config(COCO_B),
                               inputs['options']))[2]
    ids = [int(rec['bbox_id']) for rec in loader.ds.db]
    assert sorted(set(got['bbox_ids'])) == sorted(ids)
    assert len(got['bbox_ids']) - len(ids) == len(ids) % 2
    assert got['stats'] == {k: float(v) for k, v in want.items()}
    assert not os.path.exists(inputs['dir'] / 'gather')
    with open(inputs['dir'] / 'stats.json') as f:
        assert json.load(f) == got['stats']


@pytest.mark.parametrize('world', [1, 2])
def test_autoscale_lr_scales_by_the_process_count(monkeypatch, tmp_path,
                                                  world):
    """--autoscale-lr multiplies base_lr by the process count / 8 (JAX's
    tools/train.py:68-71)."""
    seen = {}
    monkeypatch.setattr(train_cli, 'init_distributed',
                        lambda device: (0, world))
    monkeypatch.setattr(train_cli, 'train_model',
                        lambda cfg, **kw: seen.update(cfg=cfg))
    train_cli.main([COCO_B, '--device', 'cpu', '--autoscale-lr',
                    '--cfg-options', 'optimizer.base_lr=1e-3'])
    assert seen['cfg']['optimizer']['base_lr'] == pytest.approx(
        1e-3 * world / 8)


def test_vitpose_plus_cli_splits_the_experts_and_resumes_exactly(group,
                                                                inputs):
    """The ViTPose+ runner on two ranks with runtime.n_expert=2 (a COCO and
    MPII mixture, two experts, one a rank): checkpoints written by rank 0
    hold both experts under the mmpose names and AdamW's state whole, and a
    run stopped after epoch 0 and resumed ends where the whole run does,
    bit for bit, with the experts gathered whole on both ranks."""
    r0, r1 = group.results()
    whole = r0['train_cli:moe_whole']
    assert whole['writes'] > 0 and r1['train_cli:moe_whole']['writes'] == 0
    names = [k for k in whole['sd'] if '.mlp.experts.' in k]
    assert {k.split('.mlp.experts.')[1] for k in names} == {
        '0.weight', '0.bias', '1.weight', '1.bias'}
    for r in (r0, r1):
        resumed = r['train_cli:moe_resumed']
        assert resumed['step'] == whole['step'] > r['train_cli:moe_part'][
            'step']
        for k, v in whole['sd'].items():
            np.testing.assert_array_equal(resumed['sd'][k], v, err_msg=k)
        np.testing.assert_array_equal(
            r['train_cli:moe_whole']['sd'][names[0]], whole['sd'][names[0]])
    ckpt = torch.load(inputs['dir'] / 'moe_whole' / 'ckpts' / 'epoch_1.pth',
                      weights_only=True)
    assert set(names) <= set(ckpt['model'])
    w = ckpt['model']['backbone.blocks.0.mlp.experts.1.weight']
    assert tuple(w.shape) == (8, 128)
    state = ckpt['optimizer']['state']
    assert any(tuple(st['exp_avg'].shape) == (2, 8, 128)
               for st in state.values())
    log = read_log(str(inputs['dir'] / 'moe_whole'))
    assert [r['epoch'] for r in log
            if r['mode'] == 'train' and r['iter'] == 0] == [0, 1]

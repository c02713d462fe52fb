"""The family runners' steps across processes on the CPU: each family's loop
step on two gloo ranks against the one-process step over the same global
batch and against the JAX package's one-device step.

One two-rank group (tests/torch_dist_worker.py `family_step`, started by
the module fixture; collectives limited to its timeout, a failed rank kills
both) runs one step of each family while this process computes JAX's. Each
family's model, batch and JAX step are those of its own test file (tests/
test_torch_{bottomup,posewarper,lifter,interhand3d,mesh,voxelpose}.py),
at a global batch of 4 (VoxelPose: 2 frames), in float64 where that file
runs float64:

  * bottom-up (HigherHRNet, BN and the AE losses), f32;
  * PoseWarper (deformable aggregation, trans_layer frozen), float64;
  * the pose lifter's supervised step (and with dropout 0.25 against one
    process: the masks are the global batch's) and its semi-supervised
    step (the bone loss compares the global batch's mean bone lengths),
    f32;
  * InterHand3D (AdamW) and the HMR mesh's adversarial step (the
    generator's update, then the discriminator's), the ResNet-10 trunk in
    float64;
  * VoxelPose, whose pose loss divides by the global batch's count of
    valid candidates: f32 against JAX, float64 against one process.

Against one process: float64 steps agree within 1e-9 relative (losses) and
1e-9 relative plus 1e-12 absolute (weights); the f32 steps within the
tolerances each family's file holds JAX to. Against JAX, each file's
tolerances for step 1: the losses, Adam's first moment (0.1 times the
gradient) relative to each tensor's largest, every weight within 2 lr and
all but a share of them close (Adam's first step turns noise on
near-zero gradients into +-lr), the BN statistics.
"""
from concurrent import futures

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from vitpose_tpu.models import mesh as jmesh
from vitpose_tpu.train import bottomup_loop as jbu
from vitpose_tpu.train.interhand_loop import make_interhand_train_step

import test_torch_bottomup as bu
import test_torch_interhand3d as ih
import test_torch_lifter as lf
import test_torch_mesh as ms
import test_torch_posewarper as pw
import test_torch_voxelpose as vp
from test_torch_interhand3d import resnet10  # noqa: F401
from torch_dist_worker import DistRun
from vitpose_tpu_torch.models.mesh import SMPLDiscriminator
from vitpose_tpu_torch.ops.target import generate_msra_heatmaps
from vitpose_tpu_torch.train import interhand_loop as pih_loop
from vitpose_tpu_torch.train import voxelpose_loop as pvp_loop
from vitpose_tpu_torch.train.mesh_loop import DISC_PREFIX
from vitpose_tpu_torch.utils import convert
from test_torch_threads import torch_test_threads  # noqa: F401

F64_ONE = dict(rtol=1e-9, atol=1e-12)
IH_MDICT = dict(ih.MDICT, backbone_overrides=dict(depth=ih.DEPTH,
                                                  dtype='float64'),
                heatmap_size=(4, 4))
MS_MDICT = dict(ms.MDICT, backbone_overrides=dict(depth=ih.DEPTH,
                                                  dtype='float64'))
LIFT = dict(family='pose_lifter', stem_channels=lf.WIDTH, dropout=0.0,
            kernel_sizes=(3, 3, 3))
SEMI = dict(LIFT, with_traj=True)
SCFG = dict(projection_loss_weight=1.0, bone_loss_weight=1.0,
            joint_parents=lf.PARENTS)

# name -> (float64, the JAX holds: losses' rtol, Adam's first moment's
# tolerance as a share of each tensor's largest, the share of weights
# allowed outside `close`, `close`, the BN statistics' tolerance as a
# share of each one's largest or an absolute one)
HOLDS = {
    'bottomup': (False, bu.METRIC_RTOL, 1e-4, bu.FLIPPED_SHARE,
                 bu.PARAM_TOL['atol'], bu.BN_TOL),
    'posewarper': (True, 1e-6, 1e-5, 1e-4, 1e-6, 1e-6),
    'lifter': (False, 1e-4, 1e-5, 1e-3, 1e-6, 1e-4),
    'lifter_semi': (False, 1e-4, 1e-5, 1e-3, 1e-6, 1e-4),
    'interhand3d': (True, 1e-5, 1e-5, 1e-3, 1e-8, 1e-6),
    'mesh': (True, 1e-5, 1e-5, 1e-3, 1e-8, 1e-6),
    'voxelpose': (False, 2e-4, 2e-2, 1e-2, 1e-6, 1e-4),
}
# the gradients' floor, a share of the largest of all (each file's: BN
# biases and convs' biases before a BN have gradients of rounding size)
MU_FLOOR = {'bottomup': 1e-6, 'voxelpose': 1e-3}
LRS = {'bottomup': bu.LR, 'posewarper': pw.LR, 'lifter': 1e-3,
       'lifter_semi': 1e-3, 'interhand3d': 1e-5, 'mesh': 1e-5,
       'voxelpose': 1e-3}


def _lifter_batch(model, seed, semi):
    """A random global batch of the lifter's shapes: (x, y) or the semi
    step's (x, y_rel, root, xu, t2d, intrinsics)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 27, 17, 2).astype(np.float32) * 0.3
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    pose = (out[0] if semi else out).numpy()
    y = rng.randn(*pose.shape).astype(np.float32) * 0.2
    if not semi:
        return x, y
    root = rng.randn(4, *out[1].shape[1:]).astype(np.float32) + np.float32(
        [0, 0, 4])
    xu = rng.randn(4, 27, 17, 2).astype(np.float32) * 0.3
    t2d = rng.randn(4, 17, 2).astype(np.float32) * 0.3
    intr = np.tile(np.float32([1.0, 1.0, 0.05, -0.05, 0.01, 0.0, 0.0,
                               0.001, 0.0]), (4, 1))
    return x, y, root, xu, t2d, intr


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """Per family: the model's weights (a .pt file for the ranks, the
    model for JAX's converter), the global batch, the case's options."""
    d = tmp_path_factory.mktemp('dist_families')
    out = {}

    def keep(name, model, batch, mdict, **kw):
        sd = model if isinstance(model, dict) else model.state_dict()
        torch.save(sd, d / f'{name}.pt')
        out[name] = dict(model=model, batch=batch, mdict=mdict,
                         path=str(d / f'{name}.pt'), kw=kw)

    # bottom-up at its file's batch of 2 (one row a rank): at 4, JAX's f32
    # BN gradients leave the port's by 1% in the stem
    keep('bottomup', bu.port_model('higher', seed=60),
         bu.train_batch(40, n=2), bu.mdict('higher'))
    model = pw.shaped_model(1)
    rng = np.random.RandomState(3)
    joints = rng.uniform(0, 48, (4, 17, 2)).astype(np.float32)
    vis = (rng.rand(4, 17) > 0.2).astype(np.float32)
    target, weight = generate_msra_heatmaps(
        torch.from_numpy(joints), torch.from_numpy(vis), (48, 64), (12, 16),
        sigma=2.0)
    keep('posewarper', model, dict(
        frames=rng.randn(4, 3, *pw.IMAGE_HW, 3), target=target.numpy()
        .astype(np.float64), weight=weight.numpy().astype(np.float64)),
        pw.F64, frame_weight=pw.FRAME_WEIGHT.astype(np.float64))
    model = lf.shaped_lifter(LIFT, 10)
    keep('lifter', model, _lifter_batch(model, 4, False), LIFT,
         loss='mpjpe')
    keep('lifter_drop', model, out['lifter']['batch'],
         dict(LIFT, dropout=0.25), loss='mpjpe')
    model = lf.shaped_lifter(SEMI, 11)
    keep('lifter_semi', model, _lifter_batch(model, 5, True), SEMI,
         semi=True, scfg=SCFG)
    root = str(d / 'interhand')
    ih_sets = (root, {'train': ih.write_interhand_set(root, 'train', 0)})
    ds = ih.datasets(ih_sets, 'train')[0]
    batch = next(iter(pih_loop.InterHandLoader(
        ds, 4, image_size=(32, 32), heatmap_size=(4, 4, 8))))
    keep('interhand3d', ih.shaped_model(0, IH_MDICT), batch, IH_MDICT,
         weight_decay=1e-2, root_depth_bins=64)
    ms_root = str(d)
    ms_sets = {'root': ms_root,
               'h36m': ms.write_mesh_set(ms_root, 'h36m', 0),
               'coco': ms.write_mesh_set(ms_root, 'coco', 1, n=4,
                                         with_smpl=False),
               'mosh': str(d / 'mosh.npz')}
    r = np.random.RandomState(3)
    np.savez(ms_sets['mosh'], pose=r.randn(7, 72) * 0.2,
             shape=r.randn(7, 10))
    batch = next(iter(ms.loaders(ms_sets, batch_size=4,
                                 image_size=(32, 32))[0]))
    mesh = ms.shaped_mesh(0, MS_MDICT)
    disc = SMPLDiscriminator(64, generator=torch.Generator().manual_seed(3))
    sd = dict(mesh.state_dict())
    sd.update({DISC_PREFIX + k: v for k, v in disc.state_dict().items()})
    keep('mesh', sd, batch, MS_MDICT, disc_hidden=64)
    out['mesh'].update(mesh=mesh, disc=disc)
    seq = vp.write_sequence(str(d / 'panoptic'), 'train_seq', 0)
    ds = vp.datasets(seq)[0]
    model = vp.shaped_model(0)
    frames = [pvp_loop.frame_arrays(model, ds[i], vp.HM, 3, 2, 400.0)
              for i in range(2)]
    keep('voxelpose', model, frames, vp.MDICT)
    keep('voxelpose_f64', model, frames, vp.MDICT)
    return out


@pytest.fixture(scope='module')
def group(inputs, tmp_path_factory):
    cases = []
    for name, x in inputs.items():
        f64 = name in ('posewarper', 'interhand3d', 'mesh', 'voxelpose_f64')
        family = {'lifter_drop': 'lifter', 'lifter_semi': 'lifter',
                  'voxelpose_f64': 'voxelpose'}.get(name, name)
        cases.append((f'family_step:{name}', dict(
            family=family, mdict=x['mdict'], model_path=x['path'],
            batch=x['batch'], lr=LRS.get(name, 1e-3), f64=f64,
            resnet10=family in ('interhand3d', 'mesh'), **x['kw'])))
    run = DistRun(tmp_path_factory.mktemp('dist_families_group'), cases)
    yield run
    run.close()


def _mu_tree(opt_state):
    return next(st.mu for st in jax.tree.leaves(
        opt_state, is_leaf=lambda st: hasattr(st, 'mu'))
        if hasattr(st, 'mu'))


def _bottomup_ref(x):
    v = bu.jax_variables(x['model'], 'higher')
    _, step = jbu.make_bottomup_train_step(bu.jax_build(x['mdict']))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(bu.LR))
    params, stats = jbu.split_bottomup_variables(v)
    opt = jax.jit(tx.init)(params)
    jb = jax.tree.map(jnp.asarray, x['batch'])
    fn = jax.jit(lambda p, s, o, b: step(p, s, o, b, tx=tx)).lower(
        params, stats, opt, jb).compile(
            compiler_options={'xla_backend_optimization_level': 0})
    params, stats, opt, m = jax.device_get(fn(params, stats, opt, jb))
    bt = x['mdict']['backbone_type']
    mu = convert.bottomup_state_dict_from_flax(
        {part: {'params': tree} for part, tree in
         bu._adam_mu(opt).items()}, bt)
    sd = convert.bottomup_state_dict_from_flax(
        jax.tree.map(np.asarray, jbu.join_bottomup_variables(params, stats)),
        bt)
    return {k: float(v) for k, v in m.items()}, mu, sd


def _posewarper_ref(x):
    b = x['batch']
    loss, params, stats, mu = pw.jax_posewarper_steps(
        pw.jax_variables(x['model']), b['frames'], b['target'],
        b['weight'], n=1)[0]
    return ({'heatmap_loss': loss},
            convert.posewarper_state_dict_from_flax({'params': mu}),
            convert.posewarper_state_dict_from_flax(
                {'params': params, 'batch_stats': stats}))


def _lifter_ref(x):
    v = lf.jax_variables(x['model'], x['mdict'])
    if x['kw'].get('semi'):
        mets, variables, mu = lf.jax_semi_steps(
            x['mdict'], v, x['batch'], 1e-3, SCFG, (1.0,))[0]
    else:
        loss, variables, mu = lf.jax_lifter_steps(
            x['mdict'], v, *x['batch'], 1e-3, 'mpjpe', n=1)[0]
        mets = {'mpjpe_loss': loss}
    return (mets, convert.pose_lifter_state_dict_from_flax(mu),
            convert.pose_lifter_state_dict_from_flax(variables))


def _interhand_ref(x):
    from vitpose_tpu.utils.family_ckpt import convert_interhand3d_checkpoint
    lr = LRS['interhand3d']
    sd = {k: t.numpy() for k, t in x['model'].state_dict().items()}
    with jax.enable_x64(True):
        est = ih.jax_estimator(IH_MDICT)
        v = jax.tree.map(lambda a: np.asarray(a, np.float64),
                         convert_interhand3d_checkpoint(sd, ih.CFG))
        tx = optax.adamw(lr, weight_decay=1e-2)
        step = make_interhand_train_step(est, tx)
        params = {k: v[k]['params'] for k in v}
        stats = {k: {c: a for c, a in v[k].items() if c != 'params'}
                 for k in v}
        opt_state = jax.jit(tx.init)(params)
        jb = {k: np.asarray(a, np.float64) for k, a in x['batch'].items()}
        params, stats, opt_state, mets = jax.device_get(ih.compiled(
            step, params, stats, opt_state, jb)(params, stats, opt_state,
                                                jb))
        mu = ih.adam_moments(opt_state)[0]
    mu_sd = convert.interhand3d_state_dict_from_flax(
        {k: {'params': mu[k]} for k in mu}, 'resnet')
    return ({k: float(a) for k, a in mets.items()}, mu_sd,
            convert.interhand3d_state_dict_from_flax(
                {k: {**stats[k], 'params': params[k]} for k in params},
                'resnet'))


def _disc_sd(tree):
    return {f'{DISC_PREFIX}{m}.{"weight" if leaf == "kernel" else "bias"}':
            torch.from_numpy(np.array(a, np.float64).T if leaf == 'kernel'
                             else np.array(a, np.float64))
            for m, d in tree['params'].items() for leaf, a in d.items()}


def _mesh_ref(x):
    lr = LRS['mesh']
    v = ms.jax_variables(x['mesh'], np.float64)
    dv = ms.disc_to_flax(x['disc'])
    with jax.enable_x64(True):
        gen_tx, disc_tx = optax.adam(lr), optax.adam(lr)
        step = jmesh.make_adversarial_train_step(
            ms.jax_mesh(dtype=jnp.float64), jmesh.SMPLDiscriminator(64),
            gen_tx, disc_tx)
        state = (v, dv, jax.jit(gen_tx.init)(v), jax.jit(disc_tx.init)(dv))
        jb = {k: np.asarray(a, np.float64 if k == 'imgs' else np.float32)
              for k, a in x['batch'].items()
              if k not in ('pose', 'beta', 'has_smpl')}
        gv, dvv, gopt, dopt, mets = jax.device_get(
            ih.compiled(step, *state, jb)(*state, jb))
    mu = convert.mesh_state_dict_from_flax(_mu_tree(gopt), 'resnet')
    mu.update(_disc_sd({'params': _mu_tree(dopt)['params']}))
    sd = convert.mesh_state_dict_from_flax(gv, 'resnet')
    sd.update(_disc_sd(dvv))
    return {k: float(a) for k, a in mets.items()}, mu, sd


def _voxelpose_ref(x):
    lr = LRS['voxelpose']
    jm = vp.jvp.DetectAndRegress(**vp.GEOM)
    v = vp.jax_variables(x['model'])
    tx = optax.adam(lr)
    trainable = {k: v[k]['params'] for k in v}
    stats = {k: {c: a for c, a in v[k].items() if c != 'params'} for k in v}
    jb = jax.tree.map(lambda *a: np.stack(a), *x['batch'])

    def step(trainable, stats, opt_state, batch):
        def loss_fn(t):
            losses, new_vars = jm.training_losses_batched(
                {k: {**stats[k], 'params': t[k]} for k in t},
                batch['heatmaps'], batch['cam'], batch['candidates'],
                batch['cand_mask'], batch['gt_joints'], batch['gt_vis'],
                batch['targets_3d'], train=True)
            return losses['loss_center'] + losses['loss_pose'], (
                losses, new_vars)
        (_, (losses, new_vars)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(trainable)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        new_stats = {k: {c: a for c, a in new_vars[k].items()
                         if c != 'params'} for k in new_vars}
        return (optax.apply_updates(trainable, updates), new_stats,
                opt_state, losses)
    opt_state = jax.jit(tx.init)(trainable)
    trainable, stats, opt_state, losses = jax.device_get(ih.compiled(
        step, trainable, stats, opt_state, jb)(trainable, stats, opt_state,
                                               jb))
    mu = convert.voxelpose_state_dict_from_flax(
        {k: {'params': m} for k, m in ih.adam_moments(opt_state)[0].items()})
    sd = convert.voxelpose_state_dict_from_flax(
        {k: {'params': trainable[k], **stats[k]} for k in trainable})
    return {k: float(a) for k, a in losses.items()}, mu, sd


# the longest compiles first
REFS = {'voxelpose': _voxelpose_ref, 'bottomup': _bottomup_ref,
        'posewarper': _posewarper_ref, 'mesh': _mesh_ref,
        'interhand3d': _interhand_ref, 'lifter_semi': _lifter_ref,
        'lifter': _lifter_ref}


@pytest.fixture(scope='module')
def jax_refs(group, inputs):
    """JAX's one-device step of each family, computed while the ranks run;
    the trees read back in float64 (JAX's float64 runs keep their digits)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, '_t', lambda a: torch.from_numpy(
            np.array(a, np.float64)))
        # XLA compiles without the GIL: three at a time
        with futures.ThreadPoolExecutor(3) as pool:
            runs = {name: pool.submit(ref, inputs[name])
                    for name, ref in REFS.items()}
            return {name: run.result() for name, run in runs.items()}


def _result(group, name):
    return group.results()[0][f'family_step:{name}']


# the two ranks against one process: (losses' rtol, the weights' and BN
# statistics' tolerance, the share of weights allowed outside it within
# 2 lr): float64 throughout, float64 trunks under f32 heads (InterHand3D,
# HMR), f32; VoxelPose's V2VNet biases before a BN have gradients of
# rounding size (Adam moves them +-lr), and its f32 gradients sit up to
# 1e-2 of a tensor's largest from its float64 run
# (tests/test_torch_voxelpose.py), hence its file's share of 1e-2
ONE_RULES = {'f64': (1e-9, dict(rtol=1e-9, atol=1e-12), 1e-3),
             'f64vp': (1e-9, dict(rtol=1e-9, atol=1e-12), 1e-2),
             'trunk64': (1e-6, dict(rtol=1e-6, atol=1e-9), 1e-3),
             'f32': (1e-4, bu.PARAM_TOL, 1e-3),
             'voxelpose': (1e-4, bu.PARAM_TOL, 1e-2)}
ONE_RULE = {'posewarper': 'f64', 'voxelpose_f64': 'f64vp',
            'interhand3d': 'trunk64', 'mesh': 'trunk64',
            'voxelpose': 'voxelpose'}


def _assert_close_to_one(r, name, lr):
    """The two ranks' step against one process's, by ONE_RULES."""
    rtol, tol, share = ONE_RULES[ONE_RULE.get(name, 'f32')]
    for k, v in r['one']['metrics'].items():
        np.testing.assert_allclose(r['dist']['metrics'][k], v, rtol=rtol,
                                   atol=1e-12, err_msg=f'{name} {k}')
    off = size = 0
    for k, w in r['one']['sd'].items():
        if 'num_batches' in k:
            continue
        g = r['dist']['sd'][k]
        if 'running_' in k:
            np.testing.assert_allclose(
                g, w, **(bu.BN_TOL if tol is bu.PARAM_TOL else tol),
                err_msg=f'{name} {k}')
            continue
        assert np.abs(g - w).max() <= 2 * lr, (name, k)
        off += int((np.abs(g - w) > tol['atol'] + tol['rtol']
                    * np.abs(w)).sum())
        size += w.size
    assert off <= share * size, (name, off, size)


@pytest.mark.parametrize('name', ['bottomup', 'posewarper', 'lifter',
                                  'lifter_semi', 'interhand3d', 'mesh',
                                  'voxelpose'])
def test_family_step_matches_one_process_and_jax(group, jax_refs, name):
    _, loss_rtol, mu_tol, share, near, stat_tol = HOLDS[name]
    lr = LRS[name]
    r = _result(group, name)
    _assert_close_to_one(r, name, lr)
    if name == 'voxelpose':
        _assert_close_to_one(_result(group, 'voxelpose_f64'),
                             'voxelpose_f64', lr)
    mets, mu, sd = jax_refs[name]
    dist = r['dist']
    for k, v in mets.items():
        np.testing.assert_allclose(dist['metrics'][k], v, rtol=loss_rtol,
                                   atol=1e-12, err_msg=k)
    floor = MU_FLOOR.get(name, 0.0) * max(np.abs(m.numpy()).max()
                                          for m in mu.values())
    for k, m in mu.items():
        if k not in dist['mu']:
            continue            # a parameter the step does not update
        m = m.numpy()
        np.testing.assert_allclose(
            dist['mu'][k], m, rtol=0,
            atol=max(mu_tol * np.abs(m).max(), floor) + 1e-30,
            err_msg=f'grad {k}')
    moved = total = 0
    for k, w in sd.items():
        if 'num_batches' in k:
            continue
        g, w = dist['sd'][k], w.numpy()
        if 'running_' in k:
            if isinstance(stat_tol, dict):
                np.testing.assert_allclose(g, w, **stat_tol, err_msg=k)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=stat_tol * np.abs(w).max(),
                    err_msg=k)
            continue
        assert np.abs(g - w).max() <= 2 * lr + 1e-12, k
        moved += int((np.abs(g - w) > near).sum())
        total += w.size
    assert moved <= share * total, (moved, total)


def test_lifter_dropout_masks_are_the_global_batchs(group):
    """The lifter with dropout 0.25: each rank keeps its rows of the global
    batch's masks, so the two ranks step as one process does."""
    r = _result(group, 'lifter_drop')
    _assert_close_to_one(r, 'lifter_drop', 1e-3)
    assert r['one']['metrics'] != _result(group, 'lifter')['one']['metrics']

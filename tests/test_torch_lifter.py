"""The 3D pose lifters in the port (ROADMAP item 12e) against the JAX
package on the CPU, at a small size (TCNs 32 wide, synthetic Human3.6M- and
MPI-INF-3DHP-style npz sets with a cameras .pkl and normalisation stats).

  * TCN and PoseLifter at kernel sizes (1, 1, 1) and (3, 3, 3), with and
    without the trajectory branch (JAX's variables by JAX's converter from
    the port's state dict, seeded BN statistics): outputs in eval and
    training mode within 1e-5 of the largest, the BN statistics after a
    training pass 1e-5; dropout draws from the caller's generator alone.
  * The losses and their gradients within 1e-6 relative: MPJPE, MSE, the
    bone loss, `project_joints` with 4 and 9 intrinsics (a depth within
    1e-4 of 0, the [-1, 1] clip), and `semi_supervision_loss`, whose
    warm-up of 0 gives zeros where the inputs would give NaN.
  * The datasets: every window (centred, causal, seq_frame_interval 2,
    detections), the cameras' normalisations, the metrics, the
    semi-supervised pairing, equal to JAX's.
  * Two supervised steps (27 frames with MPJPE; SimpleBaseline3D's MSE)
    and two semi-supervised ones (the warm-up gate 0, then 1) against
    JAX's steps as its loop builds them, compiled at XLA level 0, their
    batches equal to JAX's; dropout 0; the losses 1e-4 relative, every
    parameter within the steps' lr (Adam's first step turns f32 noise on
    near-zero gradients into +-lr), the BN statistics 1e-4. The training
    CLI on the semi-supervised config, then --resume.
  * The evaluation CLI on H36M (27 frames) and on 3DHP (SimpleBaseline3D:
    stats normalisation, remove_root), against JAX's evaluate_pose_lifter;
    JAX raises KeyError '3dpck' on the 3DHP config (it builds the H36M
    dataset), so the 3DHP table is held to JAX's own MpiInf3dhpDataset
    .evaluate on JAX's predictions.
  * `extract_pose_sequence` and `inference_pose_lifter_model` (track ids,
    norm_pose_2d, causal, the trajectory); both body3d demos on the CPU;
    the converters' round trips; the zoo: all 493 configs pass the
    runners' checks (the test's name keeps the earlier count of 490).
"""
import glob
import json
import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.api import inference_3d as jinf3d
from vitpose_tpu.data import body3d as jbody3d
from vitpose_tpu.data import mpi_inf_3dhp as j3dhp
from vitpose_tpu.eval.families import evaluate_pose_lifter as jax_evaluate
from vitpose_tpu.models import losses_regression as jreg
from vitpose_tpu.models.pose3d import PoseLifter as JaxPoseLifter
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.config import load_config as jax_load_config
from vitpose_tpu.utils.family_ckpt import convert_pose_lifter_checkpoint

from test_torch_data import assert_same_tree
from vitpose_tpu_torch.api.inference_3d import (extract_pose_sequence,
                                                inference_pose_lifter_model)
from vitpose_tpu_torch.data import body3d as pbody3d
from vitpose_tpu_torch.data import mpi_inf_3dhp as p3dhp
from vitpose_tpu_torch.demo import (body3d_two_stage_img_demo,
                                    body3d_video_demo)
from vitpose_tpu_torch.models import losses as plosses
from vitpose_tpu_torch.models.pose3d import PoseLifter
from vitpose_tpu_torch.tools import test as test_cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train.loop import (_refuse_unported,
                                          build_model_from_cfg)
from vitpose_tpu_torch.utils.config import load_config
from vitpose_tpu_torch.utils.convert import pose_lifter_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BODY3D = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'body3d')
WIDTH = 32
# (sequence name, frames): the first has a camera in the .pkl, the second
# takes the nominal 1000x1000 fallback
SEQS = (('S1_Directions_1.54138969', 14), ('S5_Walking.55011271', 10))
CAMERA = dict(w=1000, h=1002, f=[[1145.0], [1143.8]], c=[[512.5], [515.4]],
              k=[[-0.207], [0.247], [-0.003]], p=[[-0.0009], [-0.0004]])
PARENTS = [0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15]


def write_body3d_set(root, name, seed, seqs=SEQS):
    """An npz of the H36M annotation layout (imgname, center, scale, part
    [N, 17, 3] pixels and visibility, S [N, 17, 4] camera-space mm and
    visibility) and a detections .npy beside it."""
    rng = np.random.RandomState(seed)
    names = [f'{s}_{i:06d}.jpg' for s, n in seqs for i in range(1, n + 1)]
    n = len(names)
    pose = rng.randn(n, 17, 3) * 250 + [0, 0, 4500]
    part = np.concatenate([rng.uniform(150, 850, (n, 17, 2)),
                           (rng.rand(n, 17, 1) > 0.1)], -1)
    s3d = np.concatenate([pose, (rng.rand(n, 17, 1) > 0.1)], -1)
    path = os.path.join(root, f'{name}.npz')
    np.savez(path, imgname=np.array(names), center=rng.uniform(
        400, 600, (n, 2)), scale=rng.uniform(1, 3, n), part=part, S=s3d)
    det = os.path.join(root, f'{name}_det.npy')
    np.save(det, part + rng.randn(n, 17, 3) * [3, 3, 0])
    return path, det


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('body3d'))
    out = {}
    for i, name in enumerate(('train', 'unlabeled', 'val', 'hp_train',
                              'hp_val')):
        out[name], out[name + '_det'] = write_body3d_set(root, name, i)
    out['cameras'] = os.path.join(root, 'cameras.pkl')
    with open(out['cameras'], 'wb') as f:
        pickle.dump({('S1', '54138969'): CAMERA}, f)
    rng = np.random.RandomState(9)
    for name, k, d in (('stats2d', 17, 2), ('stats3d', 16, 3)):
        out[name] = os.path.join(root, f'{name}.pkl')
        with open(out[name], 'wb') as f:
            pickle.dump(dict(mean=rng.randn(k, d) * 10,
                             std=rng.uniform(50, 150, (k, d))), f)
    out['root'] = root
    return out


def small_config(root, sets, base, name, **extra):
    """A config file of `base` (configs/body3d/) at TCN width 32, dropout
    0, batch 4, on the synthetic sets."""
    hp = 'hp' in name
    cams = '' if hp else f", camera_param_file='{sets['cameras']}'"
    lines = [
        f"_base_ = ['{os.path.join(BODY3D, base)}']",
        f"model = dict(stem_channels={WIDTH}, dropout=0.0)",
        "data = dict(batch_size=4, "
        f"train=dict(ann_file='{sets['hp_train' if hp else 'train']}'{cams}),"
        f" train_unlabeled=dict(ann_file='{sets['unlabeled']}'{cams}),"
        f" val=dict(ann_file='{sets['hp_val' if hp else 'val']}'{cams}))",
        "evaluation = dict(interval=0)"]
    if 'joint' in extra or 'simplebaseline' in base:
        lines += [f"joint_2d_normalize = dict(stats_file='{sets['stats2d']}')",
                  f"joint_3d_normalize = dict(stats_file='{sets['stats3d']}')"]
    lines += [f'{k} = {v!r}' for k, v in extra.items()]
    path = os.path.join(root, f'{name}.py')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def shaped_lifter(mdict, seed):
    """The port's lifter of `mdict` with seeded BN statistics and affine."""
    model = build_model_from_cfg(mdict, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith('running_var'):
            sd[name] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)
                                        .astype(np.float32))
        elif name.endswith('running_mean') or name.endswith('bn.bias'):
            sd[name] = torch.from_numpy(0.1 * rng.standard_normal(t.shape)
                                        .astype(np.float32))
    model.load_state_dict(sd)
    return model


def jax_variables(model, mdict):
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return jax.tree.map(jnp.asarray, convert_pose_lifter_checkpoint(
        sd, {'model': mdict}))


def jax_lifter(mdict):
    kw = {k: v for k, v in mdict.items()
          if k not in ('family', 'remove_root', 'loss')}
    return JaxPoseLifter(**kw)


# --- model and losses -------------------------------------------------------

CASES = {'k111': dict(kernel_sizes=(1, 1, 1)),
         'k333': dict(kernel_sizes=(3, 3, 3)),
         'k333_traj': dict(kernel_sizes=(3, 3, 3), with_traj=True),
         'simplebaseline': dict(kernel_sizes=(1, 1, 1), num_joints=16,
                                remove_root=True)}


@pytest.mark.parametrize('case', list(CASES))
@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_lifter_matches_jax(case, train):
    mdict = dict(family='pose_lifter', stem_channels=WIDTH, dropout=0.0,
                 **CASES[case])
    model = shaped_lifter(mdict, len(case))
    v = jax_variables(model, mdict)
    rf = int(np.prod(mdict['kernel_sizes']))
    x = np.random.RandomState(3).randn(4, rf, 17, 2).astype(np.float32)
    model.train(train)
    got = model(torch.from_numpy(x))
    out = jax.jit(lambda v, x: jax_lifter(mdict).apply(
        v, x, train=train, mutable=['batch_stats'] if train else False))(
            v, jnp.asarray(x))
    want, new = (out if train else (out, None))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == (2 if mdict.get('with_traj') else 1)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    if train:
        after = pose_lifter_state_dict_from_flax(
            {'params': jax.tree.map(np.asarray, v['params']),
             'batch_stats': jax.tree.map(np.asarray, new['batch_stats'])})
        for name, t in model.state_dict().items():
            if 'running_' in name:
                np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=name)


def test_dropout_draws_from_the_callers_generator():
    model = PoseLifter(num_joints=17, stem_channels=WIDTH, dropout=0.5,
                       generator=torch.Generator().manual_seed(0)).train()
    x = torch.randn(2, 27, 17, 2)
    state = torch.get_rng_state()
    outs = [model(x, torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(torch.get_rng_state(), state)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    with pytest.raises(ValueError, match='Generator'):
        model(x)
    assert torch.equal(model.eval()(x), model(x))


def _grads(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return float(out.detach()), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize('loss', ['mpjpe', 'mse', 'mse_weighted', 'bone',
                                  'project4', 'project9', 'semi'])
def test_losses_match_jax(loss):
    rng = np.random.RandomState(len(loss))
    a = rng.randn(3, 17, 3).astype(np.float32)
    b = rng.randn(3, 17, 3).astype(np.float32)
    w = rng.rand(3, 17).astype(np.float32)
    intr = np.concatenate([rng.uniform(1, 2, (3, 2)), rng.randn(3, 2) * 0.1,
                           rng.randn(3, 5) * 0.05], 1).astype(np.float32)
    a[0, 3, 2] = 3e-5                     # the safe divide's branch
    if loss.startswith('project'):
        ni = int(loss[-1])
        pf = lambda x: plosses.project_joints(x, torch.from_numpy(
            intr[:, :ni])).sum()
        jf = lambda x: jreg.project_joints(x, intr[:, :ni]).sum()
        arrays = (a,)
    elif loss == 'semi':
        traj = rng.randn(3, 1, 3).astype(np.float32) + [0, 0, 5]
        t2d = rng.randn(3, 17, 2).astype(np.float32)

        def pf(x, y, t):
            d = plosses.semi_supervision_loss(
                y, x, t, torch.from_numpy(t2d), torch.from_numpy(intr),
                PARENTS, warmup=1.0)
            return d['proj_loss'] + 2 * d['bone_loss']

        def jf(x, y, t):
            d = jreg.semi_supervision_loss(y, x, t, t2d, intr, PARENTS,
                                           warmup=1.0)
            return d['proj_loss'] + 2 * d['bone_loss']
        arrays = (a, b, traj)
    else:
        fn = {'mpjpe': 'mpjpe_loss', 'mse': 'mse_loss',
              'mse_weighted': 'mse_loss', 'bone': 'bone_loss'}[loss]
        kw = dict(target_weight=w) if loss == 'mse_weighted' else {}
        extra = (PARENTS,) if loss == 'bone' else ()
        pf = lambda x, y: getattr(plosses, fn)(
            x, y, *extra, **{k: torch.from_numpy(v) for k, v in kw.items()})
        jf = lambda x, y: getattr(jreg, fn)(x, y, *extra, **kw)
        arrays = (a, b)
    got, gg = _grads(pf, *arrays)
    jargs = [jnp.asarray(x) for x in arrays]
    want, jg = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(len(arrays))))).lower(*jargs).compile(
            compiler_options={'xla_backend_optimization_level': 0})(*jargs)
    assert got == pytest.approx(float(want), rel=1e-6)
    for x, y in zip(gg, jg):
        np.testing.assert_allclose(x, np.asarray(y), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(y)).max())


def test_semi_loss_warmup_zero_skips_the_branch():
    """A trajectory at depth 0 with a zero pose makes the projection
    divide by the safe 1e-4 and the bone lengths 0 (a NaN gradient); at
    warm-up 0 both packages return zeros and no gradient reaches the
    inputs."""
    pose = torch.zeros(2, 17, 3, requires_grad=True)
    traj = torch.zeros(2, 1, 3, requires_grad=True)
    lab = torch.zeros(2, 17, 3)
    t2d, intr = torch.zeros(2, 17, 2), torch.ones(2, 4)
    d = plosses.semi_supervision_loss(lab, pose, traj, t2d, intr, PARENTS,
                                      warmup=0.0)
    jd = jreg.semi_supervision_loss(lab.numpy(), pose.detach().numpy(),
                                    traj.detach().numpy(), t2d.numpy(),
                                    intr.numpy(), PARENTS, warmup=0.0)
    for k in ('proj_loss', 'bone_loss'):
        assert float(d[k]) == float(jd[k]) == 0.0
    (d['proj_loss'] + d['bone_loss'] + (pose * 0).sum()).backward()
    assert torch.equal(pose.grad, torch.zeros_like(pose))


# --- datasets ---------------------------------------------------------------

@pytest.mark.parametrize('kw', [
    dict(seq_len=27), dict(seq_len=9, causal=True),
    dict(seq_len=5, seq_frame_interval=2, det=True), dict(seq_len=1)],
    ids=['centred', 'causal', 'interval_det', 'single'])
def test_body3d_windows_match_jax(sets, kw):
    kw = dict(kw)
    if kw.pop('det', False):
        kw['det_file'] = sets['train_det']
    args = (sets['train'],)
    ref = jbody3d.Body3DH36MDataset(*args, camera_param_file=sets['cameras'],
                                    **kw)
    port = pbody3d.Body3DH36MDataset(*args,
                                     camera_param_file=sets['cameras'], **kw)
    assert len(port) == len(ref) == sum(n for _, n in SEQS)
    assert port.sample_indices == ref.sample_indices
    for i in range(len(port)):
        assert_same_tree(port[i], ref[i])
        ti = port[i]['target_idx']
        assert np.array_equal(port.normalize_2d(port[i]['input_2d'], ti),
                              ref.normalize_2d(ref[i]['input_2d'], ti))
        assert np.array_equal(port.normalized_intrinsics(ti),
                              ref.normalized_intrinsics(ti))


def test_body3d_metrics_and_helpers_match_jax(sets):
    ref = jbody3d.Body3DH36MDataset(sets['val'], seq_len=1)
    port = pbody3d.Body3DH36MDataset(sets['val'], seq_len=1)
    rng = np.random.RandomState(4)
    results = [dict(preds=port.joints_3d[i:i + 5, :, :3]
                    + rng.randn(5, 17, 3) * 90, target_idxs=list(
                        range(i, i + 5))) for i in range(0, 20, 5)]
    metric = ['mpjpe', 'p-mpjpe', 'n-mpjpe']
    assert_same_tree(port.evaluate(results, metric), ref.evaluate(
        results, metric))
    hp_ref = j3dhp.MpiInf3dhpDataset(sets['val'], seq_len=1)
    hp = p3dhp.MpiInf3dhpDataset(sets['val'], seq_len=1)
    metric = ['mpjpe', 'p-mpjpe', '3dpck', '3dauc']
    got = hp.evaluate(results, metric)
    assert_same_tree(got, hp_ref.evaluate(results, metric))
    assert 0 < got['3DPCK'] < 100 and 0 < got['3DAUC'] < got['3DPCK']
    for entry in ({'stats_file': sets['stats2d']},
                  {'mean': [1.0, 2.0], 'std': [3.0, 4.0]}, None):
        assert_same_tree(pbody3d.load_joint_normalize(entry),
                         jbody3d.load_joint_normalize(entry))
    pose = rng.randn(2, 17, 3)
    pairs = [(1, 4), (2, 5), (3, 6)]
    assert np.array_equal(pbody3d.flip_relative_pose(pose, pairs, 0.3),
                          jbody3d.flip_relative_pose(pose, pairs, 0.3))
    semi = (pbody3d.Body3DSemiSupervisionDataset(port, hp, seed=2),
            jbody3d.Body3DSemiSupervisionDataset(ref, hp_ref, seed=2))
    for s in semi:
        s.set_epoch(3)
    for i in range(len(semi[0])):
        assert_same_tree(semi[0][i], semi[1][i])


# --- the training and evaluation CLIs ---------------------------------------

def _log(work):
    with open(os.path.join(work, 'train.log.json')) as f:
        return [json.loads(line) for line in f]


def _labeled_pair(sets, case):
    """(port, JAX) train datasets and the norm/remove_root options of a
    supervised recipe."""
    kw = dict(seq_len=27 if case == 'videopose3d' else 1,
              camera_param_file=sets['cameras'])
    ds = (pbody3d.Body3DH36MDataset(sets['train'], **kw),
          jbody3d.Body3DH36MDataset(sets['train'], **kw))
    if case == 'videopose3d':
        return ds, dict(norm2d=None, norm3d=None, remove_root=False)
    return ds, dict(norm2d=pbody3d.load_joint_normalize(
        {'stats_file': sets['stats2d']}), norm3d=pbody3d.load_joint_normalize(
            {'stats_file': sets['stats3d']}), remove_root=True)


def jax_lifter_steps(mdict, variables, x, y, lr, loss, n=2):
    """JAX's supervised lifter step as train_pose_lifter_model builds it
    (train-mode BN and dropout, Adam over the whole variables tree,
    batch_stats merged back), compiled at XLA level 0; [(loss, variables,
    Adam's first moment)] after each of `n` steps."""
    import optax
    jm = jax_lifter(mdict)
    tx = optax.adam(lr)
    crit = jreg.mse_loss if loss == 'mse' else jreg.mpjpe_loss

    def step(v, opt_state, x, y):
        def loss_fn(v):
            out, upd = jm.apply(v, x, train=True, mutable=['batch_stats'],
                                rngs={'dropout': jax.random.PRNGKey(0)})
            return crit(out, y), upd
        (value, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(v)
        updates, opt_state = tx.update(grads, opt_state, v)
        return {**optax.apply_updates(v, updates), **upd}, opt_state, value

    opt_state = tx.init(variables)
    args = (variables, opt_state, jnp.asarray(x), jnp.asarray(y))
    fn = jax.jit(step).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    out = []
    for _ in range(n):
        variables, opt_state, value = fn(variables, opt_state, *args[2:])
        out.append((float(value), jax.tree.map(np.asarray, variables),
                    first_moment(opt_state)))
    return out


def first_moment(opt_state):
    """Adam's first moment of an optax.adam state, as numpy."""
    mu = next(st.mu for st in jax.tree.leaves(
        opt_state, is_leaf=lambda st: hasattr(st, 'mu'))
        if hasattr(st, 'mu'))
    return jax.tree.map(np.asarray, mu)


def assert_lifter_close(model, optimizer, variables, mu, lr, steps):
    """After step `steps` of JAX's (`variables`, Adam's first moment
    `mu`): every parameter within the steps' lr of JAX's (Adam's first
    step turns f32 noise on near-zero gradients into +-lr), the BN
    statistics 1e-4 of each one's largest. After step 1 also the
    gradients, as Adam's first moment, 1e-5 of each tensor's largest, and
    every parameter within 1e-6 of JAX's but for at most 1e-3 of them (a
    step that moved nothing, or moved the wrong way, leaves all of them
    about lr apart)."""
    state = model.state_dict()
    ref = pose_lifter_state_dict_from_flax(variables)
    assert sorted(state) == sorted(ref)
    moved, total = 0, 0
    for name, t in state.items():
        if name.endswith('num_batches_tracked'):
            continue
        a, b = t.numpy(), ref[name].numpy()
        if 'running_' in name:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max(),
                                       err_msg=name)
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=2 * lr * steps,
                                   err_msg=name)
        moved += int((np.abs(a - b) > 1e-6).sum())
        total += a.size
    if steps == 1:
        assert moved <= 1e-3 * total, (moved, total)
        moments = pose_lifter_state_dict_from_flax(mu)
        for name, p in model.named_parameters():
            m = moments[name].numpy()
            np.testing.assert_allclose(
                optimizer.state[p]['exp_avg'].numpy(), m, rtol=0,
                atol=1e-5 * np.abs(m).max(), err_msg=name)


@pytest.mark.parametrize('case', ['videopose3d', 'simplebaseline'])
def test_supervised_steps_match_jax(sets, case):
    """Batches (JAX's _labeled_batch: camera or stats normalisation, flips
    drawn from the epoch's RandomState, remove_root) equal to JAX's, then
    two steps (MPJPE over 27 frames; SimpleBaseline3D's MSE on 16
    root-free joints) from the same weights: the loss 1e-4 relative, the
    weights, BN statistics and Adam's first moment as assert_lifter_close
    holds them."""
    from vitpose_tpu.train import lifter_loop as jloop
    from vitpose_tpu_torch.train import lifter_loop as ploop
    from vitpose_tpu_torch.train.family_loop import adam
    (port_ds, jax_ds), norm = _labeled_pair(sets, case)
    pairs = [(1, 4), (2, 5), (3, 6)]
    idxs = [3, 17, 8, 0]
    got = ploop.labeled_batch(port_ds, idxs, pairs,
                              np.random.RandomState(1), **norm)
    want = jloop._labeled_batch(jax_ds, idxs, pairs,
                                np.random.RandomState(1), **norm)
    assert_same_tree(got, want)
    mdict = dict(family='pose_lifter', stem_channels=WIDTH, dropout=0.0,
                 kernel_sizes=(3, 3, 3) if case == 'videopose3d'
                 else (1, 1, 1))
    if case == 'simplebaseline':
        mdict.update(num_joints=16, remove_root=True)
    loss = 'mse' if case == 'simplebaseline' else 'mpjpe'
    model = shaped_lifter(mdict, 10)
    lr = 1e-3
    ref = jax_lifter_steps(mdict, jax_variables(model, mdict), got[0],
                           got[1], lr, loss)
    optimizer, scheduler = adam(model.parameters(), lr, lambda c: lr)
    for i, (value, variables, mu) in enumerate(ref):
        metrics = ploop.lifter_step(
            model, optimizer, scheduler, torch.from_numpy(got[0]),
            torch.from_numpy(got[1]), torch.Generator(), loss)
        assert float(metrics['mpjpe_loss']) == pytest.approx(value,
                                                             rel=1e-4)
        assert_lifter_close(model, optimizer, variables, mu, lr, i + 1)


def jax_semi_steps(mdict, variables, batch, lr, scfg, warms):
    """JAX's semi-supervised lifter step as train_pose_lifter_model builds
    it (the labelled pass, the unlabelled one on the statistics it left,
    pose and trajectory MPJPE, the warm-up-gated projection and bone
    losses, Adam over the whole tree), compiled at XLA level 0; [(metrics,
    variables, Adam's first moment)] after each step, one per warm-up gate
    of `warms`."""
    import optax
    jm = jax_lifter(mdict)
    tx = optax.adam(lr)

    def apply(v, x):
        return jm.apply(v, x, train=True, mutable=['batch_stats'],
                        rngs={'dropout': jax.random.PRNGKey(0)})

    def step(v, opt_state, x, y_rel, root, xu, t2d, intr, warm):
        def loss_fn(v):
            (pose, traj), upd = apply(v, x)
            (upose, utraj), upd2 = apply({**v, **upd}, xu)
            l_pose = jreg.mpjpe_loss(pose, y_rel)
            l_traj = jreg.mpjpe_loss(traj, root)
            sl = jreg.semi_supervision_loss(
                pose, upose, utraj, t2d, intr, PARENTS,
                projection_loss_weight=scfg['projection_loss_weight'],
                bone_loss_weight=scfg['bone_loss_weight'], warmup=warm)
            total = l_pose + l_traj + sl['proj_loss'] + sl['bone_loss']
            return total, (upd2, dict(mpjpe_loss=l_pose, traj_loss=l_traj,
                                      **sl))
        (_, (upd, mets)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(v)
        updates, opt_state = tx.update(grads, opt_state, v)
        return {**optax.apply_updates(v, updates), **upd}, opt_state, mets

    opt_state = tx.init(variables)
    args = (variables, opt_state) + tuple(jnp.asarray(a) for a in batch)
    fn = jax.jit(step).lower(*args, 0.0).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    out = []
    for warm in warms:
        variables, opt_state, mets = fn(variables, opt_state, *args[2:],
                                        warm)
        out.append(({k: float(m) for k, m in mets.items()},
                    jax.tree.map(np.asarray, variables),
                    first_moment(opt_state)))
    return out


def test_semi_supervised_steps_match_jax(sets):
    """Unlabelled batches (detections at the target frame, normalised
    intrinsics, flips negating c_x) equal to JAX's _unlabeled_batch, then
    two semi-supervised steps from the same weights, the warm-up gate 0
    then 1: the four losses 1e-4 relative (the gated ones exactly 0 at step
    1), the weights as above."""
    from vitpose_tpu.train import lifter_loop as jloop
    from vitpose_tpu_torch.train import lifter_loop as ploop
    from vitpose_tpu_torch.train.family_loop import adam
    (port_ds, jax_ds), norm = _labeled_pair(sets, 'videopose3d')
    pairs = [(1, 4), (2, 5), (3, 6)]
    lab = ploop.labeled_batch(port_ds, [3, 17, 8, 0], pairs,
                              np.random.RandomState(2), **norm)
    unl = ploop.unlabeled_batch(port_ds, [5, 21, 1, 12], pairs,
                                np.random.RandomState(3))
    assert_same_tree(unl, jloop._unlabeled_batch(
        jax_ds, [5, 21, 1, 12], pairs, np.random.RandomState(3)))
    mdict = dict(family='pose_lifter', stem_channels=WIDTH, dropout=0.0,
                 kernel_sizes=(3, 3, 3), with_traj=True)
    model = shaped_lifter(mdict, 11)
    lr = 1e-3
    scfg = dict(projection_loss_weight=1.0, bone_loss_weight=1.0,
                joint_parents=PARENTS)
    batch = lab + unl
    ref = jax_semi_steps(mdict, jax_variables(model, mdict), batch, lr,
                         scfg, (0.0, 1.0))
    optimizer, scheduler = adam(model.parameters(), lr, lambda c: lr)
    for i, (mets, variables, mu) in enumerate(ref):
        got = ploop.lifter_semi_step(
            model, optimizer, scheduler,
            *[torch.from_numpy(a) for a in batch], float(i),
            torch.Generator(), scfg)
        assert list(got) == ['mpjpe_loss', 'traj_loss', 'proj_loss',
                             'bone_loss']
        for k, v in mets.items():
            assert float(got[k]) == pytest.approx(v, rel=1e-4), (i, k)
        assert (float(got['proj_loss']) > 0) == (i == 1)
        assert_lifter_close(model, optimizer, variables, mu, lr, i + 1)


def test_train_cli_runs_the_semi_recipe(sets, tmp_path):
    """The training CLI on the semi-supervised config: two steps crossing
    the warm-up, final.pth, then --resume from it."""
    path = small_config(str(tmp_path), sets,
                        'videopose3d_h36m_27frames_semi_supervised.py',
                        'semi', loss_semi=dict(warmup_iterations=1))
    work = str(tmp_path / 'work')
    args = [path, '--work-dir', work, '--device', 'cpu', '--max-steps', '2']
    model, metrics = train_cli.main(args)
    assert metrics['proj_loss'] > 0 and metrics['bone_loss'] > 0
    first = torch.load(os.path.join(work, 'final.pth'), weights_only=True)
    train_cli.main(args + ['--resume'])
    second = torch.load(os.path.join(work, 'final.pth'), weights_only=True)
    assert any(not torch.equal(first[k], second[k]) for k in first)
    assert [r['step'] for r in _log(work)] == [2, 2]


def test_train_cli_evaluates_and_keeps_the_best(sets, tmp_path):
    """SimpleBaseline3D for one epoch through the training CLI with
    evaluation.interval 1: a mode='val' line with the config's metrics and
    best.pth by MPJPE (less is better) beside final.pth; init_pose_model
    on the config gives the lifter, which loads best.pth."""
    from vitpose_tpu_torch.api import init_pose_model
    path = small_config(str(tmp_path), sets, 'simplebaseline3d_h36m.py',
                        'sb3d')
    work = str(tmp_path / 'work')
    train_cli.main([path, '--work-dir', work, '--device', 'cpu',
                    '--cfg-options', 'optimizer.total_epochs=1',
                    'evaluation.interval=1'])
    log = _log(work)
    assert [r.get('mode') for r in log] == ['val', None]
    assert set(log[0]) == {'MPJPE', 'P-MPJPE', 'N-MPJPE', 'mode', 'epoch'}
    assert log[1]['step'] == len(pbody3d.Body3DH36MDataset(
        sets['train'], seq_len=1)) // 4
    best = os.path.join(work, 'best.pth')
    lifter = init_pose_model(path, checkpoint=best, device='cpu')
    assert isinstance(lifter, PoseLifter) and not lifter.training
    for k, v in torch.load(best, weights_only=True).items():
        assert torch.equal(lifter.state_dict()[k], v), k


def load_params_npz(path):
    from vitpose_tpu_torch.utils.checkpoint import load_params_npz as load
    return load(path)


class _Apply:
    """JAX's lifter behind `apply`, compiled once per input shape."""

    def __init__(self, jm):
        self.jm, self.fns = jm, {}

    def apply(self, v, x, train=False):
        if x.shape not in self.fns:
            self.fns[x.shape] = jax.jit(
                lambda v, x: self.jm.apply(v, x, train=False))
        return self.fns[x.shape](v, x)


@pytest.mark.parametrize('case', ['h36m', 'hp_3dhp'])
def test_eval_cli_matches_jax(sets, tmp_path, case, monkeypatch):
    base = ('videopose3d_h36m_27frames.py' if case == 'h36m'
            else 'simplebaseline3d_3dhp.py')
    path = small_config(str(tmp_path), sets, base, case)
    cfg = jax_load_config(path)
    model = shaped_lifter(load_config(path)['model'], 5)
    v = jax_variables(model, cfg['model'])
    ckpt = str(tmp_path / 'w.pth')
    torch.save(model.state_dict(), ckpt)
    npz = str(tmp_path / 'w.npz')
    save_params_npz(npz, jax.tree.map(np.asarray, v))
    jm = _Apply(jax_lifter(load_config(path)['model']))
    if case == 'hp_3dhp':
        with pytest.raises(KeyError, match='3dpck'):
            jax_evaluate(cfg, jm, v)
        # JAX's own 3DHP evaluate on JAX's predictions
        monkeypatch.setattr(jbody3d, 'Body3DH36MDataset',
                            j3dhp.MpiInf3dhpDataset)
    want = jax_evaluate(cfg, jm, v)
    assert list(want) == ([m.upper() for m in cfg['evaluation']['metric']])
    for weights in (ckpt, npz):
        out = str(tmp_path / 'stats.json')
        test_cli.main([path, weights, '--device', 'cpu', '--out', out])
        with open(out) as f:
            got = json.load(f)
        assert list(got) == list(want)
        for k, value in want.items():
            assert got[k] == pytest.approx(value, rel=1e-5), k


# --- the API, the demos, the converters and the zoo -------------------------

def test_lifter_api_matches_jax():
    mdict = dict(family='pose_lifter', stem_channels=WIDTH, dropout=0.0,
                 kernel_sizes=(3, 3), with_traj=True)
    model = shaped_lifter(mdict, 6).eval()
    v = jax_variables(model, mdict)
    jm = jax_lifter(mdict)
    rng = np.random.RandomState(7)
    frames = []
    for f in range(12):
        people = []
        for tid in ((0, 1) if f % 4 else (1,)):
            kp = np.concatenate([rng.uniform(0, 640, (17, 2)),
                                 rng.rand(17, 1)], 1).astype(np.float32)
            x0, y0 = kp[:, :2].min(0)
            people.append(dict(keypoints=kp, track_id=tid,
                               bbox=[x0, y0, x0 + 90, y0 + 150]))
        frames.append(people)
    for causal in (False, True):
        for idx in (0, 5, 11):
            seq = extract_pose_sequence(frames, idx, causal=causal,
                                        seq_len=9, step=2)
            assert seq == jinf3d.extract_pose_sequence(
                frames, idx, causal=causal, seq_len=9, step=2)
            for norm in (False, True):
                got = inference_pose_lifter_model(
                    model, seq, image_size=(640, 480), norm_pose_2d=norm,
                    causal=causal)
                want = jinf3d.inference_pose_lifter_model(
                    jm, v, seq, image_size=(640, 480), norm_pose_2d=norm,
                    causal=causal)
                assert len(got) == len(want) > 0
                for a, b in zip(got, want):
                    for k in ('keypoints_3d', 'traj'):
                        np.testing.assert_allclose(
                            a[k], b[k], rtol=0,
                            atol=1e-5 * np.abs(b[k]).max())
                    assert a['track_id'] == b['track_id']


def test_body3d_demos_on_the_cpu(tmp_path):
    rng = np.random.RandomState(8)
    img = rng.randint(0, 60, (96, 128, 3), np.uint8)
    img[30:60, 50:80] = 255
    paths = {'img': str(tmp_path / 'p.jpg'), 'video': str(tmp_path / 'v.avi'),
             'json': str(tmp_path / 'kp.json')}
    cv2.imwrite(paths['img'], img)
    writer = cv2.VideoWriter(paths['video'], cv2.VideoWriter_fourcc(*'MJPG'),
                             10, (128, 96))
    for i in range(4):
        writer.write(np.roll(img, 3 * i, axis=1))
    writer.release()
    kps = [np.concatenate([rng.uniform(20, 100, (17, 2)), np.ones((17, 1))],
                          1).ravel().tolist() for _ in range(2)]
    with open(paths['json'], 'w') as f:
        json.dump({'annotations': [{'keypoints': k, 'bbox': [10, 10, 60, 80]}
                                   for k in kps]}, f)
    config = str(tmp_path / 'small_vit.py')
    with open(config, 'w') as f:
        f.write("model = dict(variant='s', img_size=(64, 48), "
                "out_channels=17, deconv_filters=(16, 16), "
                "backbone_overrides=dict(embed_dim=32, depth=2, "
                "num_heads=2))\n")
    out = str(tmp_path / 'vis')
    res, png = body3d_two_stage_img_demo.main(
        [paths['img'], '--json-file', paths['json'], '--out-img-root', out,
         '--device', 'cpu'])
    assert len(res) == 2 and os.path.getsize(png) > 0
    assert all(np.isfinite(r['keypoints_3d']).all() for r in res)
    res, png = body3d_two_stage_img_demo.main(
        [paths['img'], '--variant', config, '--out-img-root', out,
         '--device', 'cpu'])
    assert len(res) == 1 and res[0]['keypoints_3d'].shape == (17, 3)
    n, outs = body3d_video_demo.main(
        [paths['video'], '--variant', config, '--out-img-root', out,
         '--device', 'cpu'])
    assert n == 4 and len(outs) == 4
    assert all(os.path.getsize(p) > 0 for p in outs)


@pytest.mark.parametrize('traj', [False, True])
def test_converters_round_trip(traj):
    mdict = dict(family='pose_lifter', stem_channels=WIDTH,
                 kernel_sizes=(3, 3, 3), with_traj=traj)
    sd = shaped_lifter(mdict, 9).state_dict()
    back = pose_lifter_state_dict_from_flax(convert_pose_lifter_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, {'model': mdict}))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float() if v.is_floating_point()
                           else v), k


def test_the_zoo_runs_493_of_493():
    """Every config of the zoo passes the training runner's and the
    evaluation CLI's checks: all 493 run since ROADMAP item 12f; the 15
    configs of the video and 3D families
    (PoseWarper, the lifters, InterHand3D, the mesh, VoxelPose) build at
    full width on the meta device."""
    paths = sorted(glob.glob(os.path.join(ROOT, 'vitpose_tpu', 'configs',
                                          '*', '*.py')))
    paths = [p for p in paths if '/base/' not in p]
    families = {}
    args = test_cli.argparse.Namespace(int8=False, show_dir=None,
                                       batch_size=None, tmpdir=None)
    for p in paths:
        cfg = load_config(p)
        family = cfg.get('model', {}).get('family', 'topdown')
        _refuse_unported(cfg)
        test_cli._refuse_unported(cfg, args)
        families[family] = families.get(family, 0) + 1
        if family in ('posewarper', 'pose_lifter', 'interhand3d', 'mesh',
                      'voxelpose'):
            with torch.device('meta'):
                build_model_from_cfg(cfg['model'])
    assert len(paths) == 493
    assert families == {'topdown': 434, 'bottomup': 44, 'posewarper': 2,
                        'pose_lifter': 10, 'interhand3d': 1, 'mesh': 1,
                        'voxelpose': 1}

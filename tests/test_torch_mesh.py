"""HMR mesh recovery with its adversarial prior (ROADMAP item 12f) and the
multi-task model in the port against the JAX package on the CPU, at a
small size: a ResNet trunk of one block a stage (test_torch_interhand3d's
`resnet10`) on 64x64 crops, the zoo's rot6d head (1024
wide, 3 iterations) and seeded linear SMPL surrogate, a discriminator 64
wide, synthetic npz mesh and Mosh sets with JPEGs in `tmp_path`.

  * The generator in eval mode (JAX's variables by JAX's converter from the
    port's state dict, seeded BN statistics): pose, shape, camera,
    vertices and joints within 1e-5 of each one's largest; the converters
    both ways exact (the mean parameters are buffers, JAX's param).
  * The rotation helpers near their branch points (identity, 180-degree
    turns, ties of Shepperd's leading terms, small angles), the linear SMPL
    surrogate's RandomState draws, the discriminator, the GAN, joint and
    SMPL-parameter losses and their gradients (the axis-angle gradient at
    the exact identity is NaN in JAX, 0 in the port).
  * The data: the datasets, the mixture's sampling, the SMPL-consistent
    flips and rotations, the adversarial loader's batches and the
    joint_error evaluation against JAX's.
  * Two adversarial steps against JAX's (the trunk in float64, step 2 from
    JAX's state after step 1), the evaluation CLI against JAX's
    evaluate_mesh, the training CLI with --resume, the 3D API, the
    rendering and the demo on the CPU.
  * MultiTaskModel (the trunk with a heatmap and a regression head) in
    eval mode, `multitask_loss` and `multitask_gather_target` against
    JAX's.
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import mesh as jdata
from vitpose_tpu.models import losses_regression as jreg
from vitpose_tpu.models import mesh as jmesh
from vitpose_tpu.models.resnet import ResNet as JaxResNet
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.family_ckpt import convert_mesh_checkpoint

from test_torch_data import assert_same_tree
from test_torch_interhand3d import (DEPTH, adam_moments, close, compiled,
                                    resnet10)  # noqa: F401
from vitpose_tpu_torch.data import mesh as pdata
from vitpose_tpu_torch.models import losses as plosses
from vitpose_tpu_torch.models import mesh as pmesh
from vitpose_tpu_torch.tools import test as test_cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train import mesh_loop as ploop
from vitpose_tpu_torch.train.family_loop import adam
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils.convert import mesh_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'mesh',
                      'hmr_res50_mixed_224x224.py')
MDICT = dict(family='mesh', backbone_type='resnet',
             backbone_overrides=dict(depth=DEPTH), num_iters=3,
             pose_rep='rot6d', smpl='linear')
CFG = {'model': MDICT}


def shaped_mesh(seed, mdict=MDICT):
    """The port's ParametricMesh with seeded BN statistics and mean
    parameters."""
    model = build_model_from_cfg(mdict, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith('running_var'):
            sd[name] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)
                                        .astype(np.float32))
        elif name.endswith('running_mean') or name.startswith(
                'mesh_head.init_'):
            sd[name] = torch.from_numpy(0.1 * rng.standard_normal(t.shape)
                                        .astype(np.float32))
    model.load_state_dict(sd)
    return model


def jax_mesh(depth=DEPTH, dtype=jnp.float32):
    return jmesh.ParametricMesh(JaxResNet(depth=depth, dtype=dtype),
                                jmesh.linear_smpl_fn(), num_iters=3,
                                pose_rep='rot6d')


def jax_variables(model, dtype=np.float32):
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return jax.tree.map(lambda a: np.asarray(a, dtype),
                        convert_mesh_checkpoint(sd, CFG))


def disc_to_flax(disc):
    """The port's SMPLDiscriminator (JAX's layer names) -> flax params."""
    return {'params': {name: {'kernel': m.weight.detach().numpy().T.copy(),
                              'bias': m.bias.detach().numpy().copy()}
                       for name, m in disc.named_children()}}


class _JaxMesh:
    """JAX's ParametricMesh behind `apply`, compiled once per input
    shape (eval mode)."""

    def __init__(self, mesh):
        self.mesh, self.fns = mesh, {}

    def apply(self, v, x, train=False):
        x = jnp.asarray(x)
        if x.shape not in self.fns:
            self.fns[x.shape] = compiled(
                lambda v, x: self.mesh.apply(v, x, train=False), v, x)
        return self.fns[x.shape](v, x)


@pytest.fixture(scope='module')
def pair():
    model = shaped_mesh(0).eval()
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    return model, _JaxMesh(jax_mesh()), jax_variables(model), x


def test_mesh_matches_jax_and_converters_round_trip(pair):
    model, jm, v, x = pair
    got = model(torch.from_numpy(x))
    want = jm.apply(v, x)
    assert sorted(got) == sorted(want)      # jit returns a sorted dict
    for k in want:
        close(got[k].detach().numpy(), want[k], 1e-5, k)
    assert got['vertices'].shape == (2, 689, 3)
    sd = model.state_dict()
    back = mesh_state_dict_from_flax(
        {'gen': jax.tree.map(np.asarray, v), 'disc': {}}, 'resnet')
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t.float() if t.is_floating_point()
                           else t), k
    assert not any('init_' in n for n, _ in model.named_parameters())


def rotation_cases():
    """rot6d inputs [N, 144] whose matrices sit at the branch points:
    identity, 180-degree turns about x, y, z and a diagonal axis, a tie of
    Shepperd's leading terms, tiny angles, and random ones."""
    rng = np.random.RandomState(0)
    mats = [np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
            np.diag([-1.0, -1, 1])]
    axis = np.array([1.0, 1.0, 0.0]) / np.sqrt(2)
    mats.append(2 * np.outer(axis, axis) - np.eye(3))   # 180 deg, diagonal
    for angle in (1e-7, 1e-4, np.pi / 2, np.pi - 1e-6):
        a = rng.randn(3)
        a /= np.linalg.norm(a)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        mats.append(np.eye(3) + np.sin(angle) * k
                    + (1 - np.cos(angle)) * k @ k)
    while len(mats) < 48:
        q, _ = np.linalg.qr(rng.randn(3, 3))
        mats.append(q * np.sign(np.linalg.det(q)))
    six = np.stack([m[:, :2] for m in mats])              # [48, 3, 2]
    six = six * rng.uniform(0.5, 2.0, (48, 1, 2))         # unnormalised
    return six.reshape(2, 144).astype(np.float32)


def test_rotations_match_jax():
    x = rotation_cases()
    pairs = ((pmesh.rot6d_to_rotmat, jmesh.rot6d_to_rotmat),
             (lambda t: pmesh.rotmat_to_quat(pmesh.rot6d_to_rotmat(t)),
              lambda t: jmesh.rotmat_to_quat(jmesh.rot6d_to_rotmat(t))),
             (pmesh.rot6d_to_axis_angle, jmesh.rot6d_to_axis_angle))
    # JAX's three and the axis-angle's gradient in one compiled function
    *wants, jg = compiled(lambda a: [jf(a) for _, jf in pairs] + [jax.grad(
        lambda a: jnp.sum(jmesh.rot6d_to_axis_angle(a) ** 2))(a)], x)(x)
    for (pf, _), want in zip(pairs, wants):
        close(pf(torch.from_numpy(x)).numpy(), want, 1e-6)
    t = torch.tensor(x, requires_grad=True)
    pmesh.rot6d_to_axis_angle(t).pow(2).sum().backward()
    jg = np.asarray(jg)
    # the exact identity (the first rotation) has a zero quaternion vector:
    # JAX's norm gives it a NaN gradient, torch's norm a zero subgradient
    finite = np.isfinite(jg)
    assert not finite[0, :6].any() and finite[0, 6:].all() \
        and finite[1].all()
    got = t.grad.numpy()
    assert np.isfinite(got).all()
    close(got[finite], jg[finite], 1e-5)


def test_smpl_discriminator_and_losses_match_jax(tmp_path):
    """The linear and npz SMPL surrogates, the discriminator, the GAN,
    joint and SMPL-parameter losses and their gradients against JAX's, all
    of JAX's in one compiled function."""
    rng = np.random.RandomState(2)
    pose = rng.randn(3, 72).astype(np.float32) * 0.3
    shape = rng.randn(3, 10).astype(np.float32)
    npz = str(tmp_path / 'smpl.npz')
    np.savez(npz, J_w=rng.randn(82, 72), V_w=rng.randn(82, 30))
    disc = pmesh.SMPLDiscriminator(64, generator=torch.Generator()
                                   .manual_seed(3))
    dv = disc_to_flax(disc)
    a = rng.randn(3, 24, 3).astype(np.float32)
    b = rng.randn(3, 24, 3).astype(np.float32)
    vis = (rng.rand(3, 24) > 0.3).astype(np.float32)
    has = np.array([1.0, 0.0, 1.0], np.float32)
    # (loss, the names of its inputs)
    cases = [(lambda p, x, y, kind=kind: p.gan_loss(x, True, kind, 0.5),
              ('a',)) for kind in ('vanilla', 'lsgan', 'wgan')]
    cases += [(lambda p, x, y: p.gan_loss(x, False, 'vanilla'), ('a',)),
              (lambda p, x, y: p.mesh_joint_loss(x, y, vis), ('a', 'b')),
              (lambda p, x, y: p.mesh_joint_loss(x, y, vis, 2.0, (2, 3)),
               ('a', 'b')),
              (lambda p, x, y: p.smpl_param_loss(x, y, has), ('a0', 'b0'))]

    def inputs(a, b):
        return dict(a=a, b=b, a0=a[:, 0], b0=b[:, 0])
    linear, from_npz = jmesh.linear_smpl_fn(), jmesh.npz_smpl_fn(npz)

    def jax_side(pose, shape, dv, a, b):
        env = inputs(a, b)
        losses = [jax.value_and_grad(
            lambda *xs, fn=fn: fn(jreg, *(list(xs) + [None] * (2 - len(xs)))),
            argnums=tuple(range(len(names))))(*[env[n] for n in names])
            for fn, names in cases]
        return (linear(pose, shape), from_npz(pose, shape),
                jmesh.SMPLDiscriminator(64).apply(dv, pose, shape), losses)
    want_linear, want_npz, want_disc, want_losses = compiled(
        jax_side, pose, shape, dv, a, b)(pose, shape, dv, a, b)
    got = pmesh.linear_smpl()(torch.from_numpy(pose), torch.from_numpy(shape))
    for x, y in zip(got, want_linear):
        close(x.numpy(), y, 1e-6)
    for x, y in zip(pmesh.npz_smpl(npz)(torch.from_numpy(pose),
                                        torch.from_numpy(shape)), want_npz):
        close(x.numpy(), y, 1e-6)
    close(disc(torch.from_numpy(pose), torch.from_numpy(shape))
          .detach().numpy(), want_disc, 1e-5)
    env = inputs(a, b)
    for (fn, names), (want, grads) in zip(cases, want_losses):
        ts = [torch.tensor(env[n], requires_grad=True) for n in names]
        out = fn(_TorchLosses, *(ts + [None] * (2 - len(ts))))
        out.backward()
        assert float(out.detach()) == pytest.approx(float(want), rel=1e-6)
        for t, g in zip(ts, grads):
            close(t.grad.numpy(), g, 1e-6)


class _TorchLosses:
    """The port's losses with numpy constants turned into tensors."""

    @staticmethod
    def _t(x):
        return torch.from_numpy(x) if isinstance(x, np.ndarray) else x

    @classmethod
    def gan_loss(cls, *a):
        return plosses.gan_loss(*a)

    @classmethod
    def mesh_joint_loss(cls, x, y, vis, *a):
        return plosses.mesh_joint_loss(x, y, cls._t(vis), *a)

    @classmethod
    def smpl_param_loss(cls, x, y, has, *a):
        return plosses.smpl_param_loss(x, y, cls._t(has), *a)


# --- data -------------------------------------------------------------------

def write_mesh_set(root, name, seed, n=6, with_smpl=True):
    """An npz of the mesh layout (imgname, center, scale, part [n, 24, 3],
    S [n, 24, 4], pose, shape) and its JPEGs."""
    rng = np.random.RandomState(seed)
    names = [f'{name}_{i}.jpg' for i in range(n)]
    for fn in names:
        cv2.imwrite(os.path.join(root, fn),
                    rng.randint(0, 255, (96, 128, 3), np.uint8))
    part = np.concatenate([rng.uniform(20, 100, (n, 24, 2)),
                           (rng.rand(n, 24, 1) > 0.2)], -1)
    s3d = np.concatenate([rng.randn(n, 24, 3) * 0.3,
                          (rng.rand(n, 24, 1) > 0.2)], -1)
    data = dict(imgname=np.array(names), center=rng.uniform(
        50, 80, (n, 2)), scale=rng.uniform(0.3, 0.5, n), part=part, S=s3d)
    if with_smpl:
        data.update(pose=rng.randn(n, 72) * 0.2, shape=rng.randn(n, 10))
    path = os.path.join(root, f'{name}.npz')
    np.savez(path, **data)
    return path


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('mesh'))
    out = {'root': root,
           'h36m': write_mesh_set(root, 'h36m', 0),
           'coco': write_mesh_set(root, 'coco', 1, n=4, with_smpl=False),
           'val': write_mesh_set(root, 'val', 2, n=5)}
    rng = np.random.RandomState(3)
    out['mosh'] = os.path.join(root, 'mosh.npz')
    np.savez(out['mosh'], pose=rng.randn(7, 72) * 0.2,
             shape=rng.randn(7, 10))
    return out


def loaders(sets, batch_size=2, image_size=(64, 64), seed=4):
    out = []
    for mod in (pdata, jdata):
        parts = [mod.MeshDataset(sets[k], sets['root'],
                                 image_size=image_size)
                 for k in ('h36m', 'coco')]
        mix = mod.MeshMixDataset(parts, [0.6, 0.4])
        ld = mod.MeshAdvLoader(mix, mod.MoshDataset(sets['mosh']),
                               batch_size, image_size=image_size, seed=seed)
        ld.set_epoch(1)
        out.append(ld)
    return out


def test_mesh_data_matches_jax(sets):
    ours, ref = loaders(sets)
    assert_same_tree(ours.ds.datasets[0].db, ref.ds.datasets[0].db)
    for a, b in zip(ours, ref):
        assert list(a) == list(b)
        for k in b:
            # the crops: cv2 warps of affines an f32 ulp apart
            close(a[k], b[k], 1e-5, k, atol=2.0 / 255 if k == 'imgs'
                  else None)
    rng = np.random.RandomState(5)
    pose = rng.randn(72).astype(np.float32)
    j3d = rng.randn(24, 3).astype(np.float32)
    vis = (rng.rand(24, 1) > 0.3).astype(np.float32)
    assert_same_tree(pdata.flip_smpl_pose(pose), jdata.flip_smpl_pose(pose))
    for rot in (0.0, 30.0, -75.0):
        assert_same_tree(pdata.rotate_smpl_pose(pose, rot),
                         jdata.rotate_smpl_pose(pose, rot))
        assert_same_tree(pdata.rotate_joints_3d(j3d, rot),
                         jdata.rotate_joints_3d(j3d, rot))
    assert_same_tree(pdata.flip_joints_3d(j3d, vis),
                     jdata.flip_joints_3d(j3d, vis))
    val = (pdata.MeshDataset(sets['val'], sets['root']),
           jdata.MeshDataset(sets['val'], sets['root']))
    results = [dict(keypoints_3d=np.stack(
        [r['joints_3d'] for r in val[0].db[i:i + 3]])
        + rng.randn(len(val[0].db[i:i + 3]), 24, 3) * 0.05,
        image_path=[r['image_file'] for r in val[0].db[i:i + 3]])
        for i in (0, 3)]
    got = val[0].evaluate(results)
    assert_same_tree(got, val[1].evaluate(results))
    assert 0 < got['MPJPE-PA'] < got['MPJPE']


def test_two_adversarial_steps_match_jax(sets, monkeypatch):
    """Two adversarial steps on one loader batch, the trunk in float64 on
    both sides (the head, SMPL and the discriminator compute in f32 in
    both, as JAX's modules fix it; in f32 the training-mode BN over the
    trunk's small maps leaves JAX's gradients far from the port's, as
    test_torch_interhand3d shows): step 1 from the same weights, step 2
    from JAX's state after step 1 (generator and discriminator weights, BN
    statistics, both Adams' moments). Each step's five losses 1e-5
    relative; Adam's first moments within 1e-5 of each tensor's largest;
    every parameter within 2 lr of JAX's and all but 1e-3 of them within
    1e-8; the BN statistics 1e-6; the mean parameters never move."""
    import optax
    from vitpose_tpu_torch.utils import convert
    monkeypatch.setattr(convert, '_t', lambda x: torch.from_numpy(
        np.array(x, np.float64)))
    mdict = dict(MDICT, backbone_overrides=dict(depth=DEPTH, dtype='float64'))
    batch = ploop.mesh_batch_to_device(next(iter(loaders(
        sets, image_size=(32, 32))[0])), 'cpu')
    model = shaped_mesh(0, mdict)
    v = jax_variables(model, np.float64)
    model.double()
    disc = pmesh.SMPLDiscriminator(64, generator=torch.Generator()
                                   .manual_seed(3))
    dv = disc_to_flax(disc)
    lr = 1e-5
    with jax.enable_x64(True):
        gen_tx, disc_tx = optax.adam(lr), optax.adam(lr)
        step = jmesh.make_adversarial_train_step(
            jax_mesh(dtype=jnp.float64), jmesh.SMPLDiscriminator(64),
            gen_tx, disc_tx)
        # optax's inits under jit: one compile each, not one a leaf
        state = (v, dv, jax.jit(gen_tx.init)(v), jax.jit(disc_tx.init)(dv))
        jb = {k: np.asarray(t.numpy(), np.float64 if k == 'imgs'
                            else np.float32) for k, t in batch.items()}
        fn = compiled(step, *state, jb)
        ref = []
        for _ in range(2):
            *state, mets = fn(*state, jb)
            ref.append(jax.device_get((mets, state[0], state[1],
                                       adam_moments(state[2]),
                                       adam_moments(state[3]))))
    gen_opt, gen_sched = adam(model.parameters(), lr, lambda c: lr)
    disc_opt, disc_sched = adam(disc.parameters(), lr, lambda c: lr)
    pb = {k: t.double() if k == 'imgs' else t for k, t in batch.items()}
    mean = {k: t.clone() for k, t in model.state_dict().items()
            if 'init_' in k}

    def disc_sd(tree):
        return {f'{m}.{"weight" if leaf == "kernel" else "bias"}':
                torch.from_numpy(np.array(x, np.float32).T
                                 if leaf == 'kernel' else
                                 np.array(x, np.float32))
                for m, d in tree['params'].items() for leaf, x in d.items()}

    for i, (mets, gv, dvv, (gmu, gnu), (dmu, dnu)) in enumerate(ref):
        if i == 1:                    # from JAX's state after step 1
            _, gv1, dv1, (gmu1, gnu1), (dmu1, dnu1) = ref[0]
            model.load_state_dict(mesh_state_dict_from_flax(gv1, 'resnet'))
            disc.load_state_dict(disc_sd(dv1))
            for opt, net, mu1, nu1, to_sd in (
                    (gen_opt, model, gmu1, gnu1,
                     lambda t: mesh_state_dict_from_flax(t, 'resnet')),
                    (disc_opt, disc, dmu1, dnu1, disc_sd)):
                m1, n1 = to_sd(mu1), to_sd(nu1)
                for name, p in net.named_parameters():
                    opt.state[p]['exp_avg'].copy_(m1[name])
                    opt.state[p]['exp_avg_sq'].copy_(n1[name])
        got = pmesh.adversarial_step(model, disc, gen_opt, disc_opt, pb,
                                     gen_sched=gen_sched,
                                     disc_sched=disc_sched)
        assert list(got) == ['loss_2d', 'loss_3d', 'loss_adv', 'gen_loss',
                             'disc_loss']
        for k, value in mets.items():
            assert float(got[k]) == pytest.approx(float(value),
                                                  rel=1e-5), (i, k)
        for opt, net, mu, to_sd in (
                (gen_opt, model, gmu,
                 lambda t: mesh_state_dict_from_flax(t, 'resnet')),
                (disc_opt, disc, dmu, disc_sd)):
            moments = to_sd(mu)
            for name, p in net.named_parameters():
                close(opt.state[p]['exp_avg'].numpy(),
                      moments[name].numpy(), 1e-5, f'step {i} {name}')
        moved, total = 0, 0
        for net, want in ((model, mesh_state_dict_from_flax(gv, 'resnet')),
                          (disc, disc_sd(dvv))):
            for name, t in net.state_dict().items():
                if name.endswith('num_batches_tracked'):
                    continue
                a, b = t.numpy(), want[name].numpy()
                if 'running_' in name:
                    close(a, b, 1e-6, f'step {i} {name}')
                    continue
                close(a, b, what=f'step {i} {name}', atol=2 * lr)
                moved += int((np.abs(a - b) > 1e-8).sum())
                total += a.size
        assert moved <= 1e-3 * total, (i, moved, total)
    for k, t in mean.items():
        assert torch.equal(model.state_dict()[k], t), k


# --- the CLIs, the API, the rendering and the demo --------------------------

def small_config(root, sets, name='hmr', **extra):
    lines = [f"_base_ = ['{CONFIG}']",
             f"model = dict(backbone_overrides=dict(depth={DEPTH}), "
             "disc_hidden=64)",
             "data = dict(image_size=(64, 64), batch_size=3, "
             f"train=dict(configs=[dict(ann_file='{sets['h36m']}', "
             f"img_prefix='{sets['root']}'), dict(ann_file='{sets['coco']}',"
             f" img_prefix='{sets['root']}')], "
             f"adv_ann_file='{sets['mosh']}'), "
             f"val=dict(ann_file='{sets['val']}', "
             f"img_prefix='{sets['root']}'))"]
    lines += [f'{k} = {v!r}' for k, v in extra.items()]
    path = os.path.join(root, f'{name}.py')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def test_eval_cli_matches_jax(pair, sets, tmp_path):
    """JAX's evaluate_mesh on JAX's variables against the evaluation CLI on
    their .npz (batches of 3 and 2)."""
    from vitpose_tpu.eval.families import evaluate_mesh
    from vitpose_tpu.utils.config import load_config as jax_load_config
    _, jm, v, _ = pair
    path = small_config(str(tmp_path), sets)
    want = evaluate_mesh(jax_load_config(path), jm, v)
    npz = str(tmp_path / 'w.npz')
    save_params_npz(npz, jax.tree.map(np.asarray, v))
    got = test_cli.main([path, npz, '--device', 'cpu'])
    assert list(got) == list(want) == ['MPJPE', 'MPJPE-PA']
    for k, value in want.items():
        assert got[k] == pytest.approx(float(value), rel=1e-4), k


def test_train_cli_resumes_and_scores(sets, tmp_path):
    """One epoch (the mixture's 6 records: 2 steps of 3) through the
    training CLI with an evaluation, then --resume; final.pth holds the
    generator and the discriminator (`discriminator.`) and scores through
    the evaluation CLI."""
    path = small_config(str(tmp_path), sets,
                        evaluation=dict(interval=1, metric='joint_error'))
    work = str(tmp_path / 'work')
    args = [path, '--work-dir', work, '--device', 'cpu', '--cfg-options',
            'optimizer.total_epochs=1']
    _, metrics = train_cli.main(args)
    assert list(metrics) == ['loss_2d', 'loss_3d', 'loss_adv', 'gen_loss',
                             'disc_loss']
    assert all(np.isfinite(list(metrics.values())))
    final = os.path.join(work, 'final.pth')
    first = torch.load(final, weights_only=True)
    assert any(k.startswith('discriminator.') for k in first)
    train_cli.main(args + ['--resume'])
    second = torch.load(final, weights_only=True)
    assert any(not torch.equal(first[k], second[k]) for k in first)
    with open(os.path.join(work, 'train.log.json')) as f:
        assert [json.loads(line).get('mode') for line in f] == [
            'val', None, 'val', None]
    stats = test_cli.main([path, final, '--device', 'cpu'])
    assert np.isfinite(stats['MPJPE'])


def test_api_rendering_and_demo_on_the_cpu(pair, tmp_path):
    from vitpose_tpu.api import inference as jinf
    from vitpose_tpu.api import inference_3d as jinf3d
    from vitpose_tpu_torch.api.inference import imshow_mesh_3d
    from vitpose_tpu_torch.api.inference_3d import (inference_mesh_model,
                                                    vis_3d_mesh_result)
    from vitpose_tpu_torch.demo import mesh_img_demo
    model, jm, v, _ = pair
    rng = np.random.RandomState(6)
    img = rng.randint(0, 255, (100, 140, 3), np.uint8)
    dets = [{'bbox': [10, 20, 50, 60, 0.9]}, {'bbox': [60, 10, 70, 80, 0.8]},
            {'bbox': [5, 5, 30, 30, 0.1]}]
    faces = np.array([[0, 1, 2], [2, 3, 4]])
    got = inference_mesh_model(model, img, dets, bbox_thr=0.5,
                               image_size=(64, 64), faces=faces)
    want = jinf3d.inference_mesh_model((jm, v), img, dets, bbox_thr=0.5,
                                       image_size=(64, 64), faces=faces)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        for k in ('bbox', 'center', 'scale'):
            close(a[k], b[k], 1e-6, k)
        for k in ('keypoints_3d', 'camera', 'vertices'):
            close(a[k], b[k], 1e-4, k)
    # the rendering on both packages' inputs: the same numpy rasteriser
    verts = [np.asarray(got[0]['vertices'][:5]) * [1, 1, 0.1] + [0, 0, 3]]
    assert np.array_equal(
        imshow_mesh_3d(img, verts, [faces], (70, 50), (90, 90)),
        jinf.imshow_mesh_3d(img, verts, [faces], (70, 50), (90, 90)))
    assert np.array_equal(vis_3d_mesh_result(None, got, img=img),
                          jinf3d.vis_3d_mesh_result(None, got, img=img))
    img_path = str(tmp_path / 'person.jpg')
    cv2.imwrite(img_path, img)
    config = str(tmp_path / 'demo.py')
    with open(config, 'w') as f:
        f.write(f"_base_ = ['{CONFIG}']\n"
                f"model = dict(backbone_overrides=dict(depth={DEPTH}))\n")
    res, out = mesh_img_demo.main([img_path, '--config', config, '--bbox',
                                   '20,10,80,80', '--out-img-root',
                                   str(tmp_path / 'vis'), '--device', 'cpu'])
    assert res[0]['vertices'].shape == (192, 3)
    rendered = cv2.imread(out)
    assert rendered.shape == img.shape
    assert not np.array_equal(rendered, img[..., ::-1])


# --- the multi-task model ---------------------------------------------------

def test_multitask_model_matches_jax():
    """The trunk with a heatmap head and a regression head: eval
    outputs within 1e-5 of each one's largest (JAX's variables from the
    port's weights by JAX's converters), `multitask_loss` and its
    gradients, `multitask_gather_target`."""
    from vitpose_tpu.data.pipeline import multitask_gather_target as jgather
    from vitpose_tpu.models import multitask as jmt
    from vitpose_tpu.models.heads import HeatmapHead as JaxHeatmapHead
    from vitpose_tpu.models.heads_extra import RegressionHead as JaxReg
    from vitpose_tpu.utils.cnn_ckpt import convert_resnext
    from vitpose_tpu.utils.torch_ckpt import convert_head
    from vitpose_tpu_torch.data.pipeline import multitask_gather_target
    from vitpose_tpu_torch.models.heads import HeatmapHead
    from vitpose_tpu_torch.models.heads_extra import RegressionHead
    from vitpose_tpu_torch.models.multitask import (MultiTaskModel,
                                                    multitask_loss)
    from vitpose_tpu_torch.models.resnet import ResNet
    g = torch.Generator().manual_seed(4)
    model = MultiTaskModel(ResNet(DEPTH, generator=g), [
        HeatmapHead(512, 17, (8, 8), (4, 4), generator=g),
        RegressionHead(512, 17, generator=g)]).eval()
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    bp, bs = convert_resnext(sd, prefix='backbone.')
    hp, hs = convert_head(sd, prefix='heads.0.')
    params = {'backbone': bp, 'heads_0': hp, 'heads_1': {'fc': {
        'kernel': sd['heads.1.fc.weight'].T, 'bias': sd['heads.1.fc.bias']}}}
    v = {'params': params, 'batch_stats': {'backbone': bs, 'heads_0': hs}}
    jm = jmt.MultiTaskModel(JaxResNet(depth=DEPTH), [
        JaxHeatmapHead(17, (8, 8), (4, 4)), JaxReg(17)])
    x = np.random.RandomState(7).rand(2, 64, 64, 3).astype(np.float32)
    want = compiled(lambda v, x: jm.apply(v, x, train=False), v, x)(v, x)
    got = model(torch.from_numpy(x))
    assert got[0].shape == (2, 17, 8, 8) and got[1].shape == (2, 17, 2)
    # JAX's heatmap head gives NHWC maps, the port's NCHW
    close(got[0].detach().numpy(), np.transpose(want[0], (0, 3, 1, 2)), 1e-5)
    close(got[1].detach().numpy(), want[1], 1e-5)
    rng = np.random.RandomState(8)
    outs = [t.detach().numpy() for t in got]
    targets = [rng.rand(*o.shape).astype(np.float32) for o in outs]
    weights = [rng.rand(2, 17).astype(np.float32) for _ in outs]
    ts = [torch.tensor(o, requires_grad=True) for o in outs]
    total, losses = multitask_loss(
        ts, [torch.from_numpy(t) for t in targets],
        [torch.from_numpy(w) for w in weights],
        [plosses.joints_mse_loss, plosses.smooth_l1_loss], [1.0, 0.5])
    total.backward()
    from vitpose_tpu.models.losses import joints_mse_loss as jmse

    def jf(a, b):
        return jmt.multitask_loss([a, b], targets, weights,
                                  [jmse, jreg.smooth_l1_loss], [1.0, 0.5])
    (jt, jl), jg = compiled(jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True), *outs)(*outs)
    assert list(losses) == list(jl)
    for k in jl:
        assert float(losses[k]) == pytest.approx(float(jl[k]), rel=1e-6)
    for t, gr in zip(ts, jg):
        close(t.grad.numpy(), gr, 1e-6)
    fns = [lambda r: dict(target=r['x'] * 2, target_weight=1),
           lambda r: dict(target=r['x'] + 1)]
    rec = {'x': np.arange(3.0)}
    for idx in (None, [1, 0, 1]):
        assert_same_tree(multitask_gather_target(fns, rec, idx),
                         jgather(fns, rec, idx))

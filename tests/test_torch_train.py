"""The port's training slice against the JAX package on the CPU: targets,
point warps, PCK, the loss, host augmentation, device preprocessing, the
optimizer's schedule and groups, BatchNorm and DropPath in training mode, the
explicit train/eval mode, a 3-step train-step trajectory, freezing (the
trainable mask and a 2-step trajectory under it), and block remat (the
port's own: its gradients against those without remat).

The model is the small one of tests/test_torch_models.py (64x48 crops,
width 32, depth 2, 4 heads), with the same numpy variables on both sides.
JAX references compile at XLA CPU optimisation level 0.

Tolerances: elementwise f32 math (targets, point warps, crops) 1e-5; the
model's f32 outputs and BN statistics 1e-4 as in tests/test_torch_models.py.
The trajectory: loss, grad_norm and acc_pose 1e-4 relative; parameters
after each step 1e-5 absolute plus 1e-4 relative. An Adam step moves an
element by lr * m_hat / (sqrt(v_hat) + 1e-8), so a gradient difference at f32
rounding level moves it by a tiny fraction of lr (here <= 1e-3, so 1e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data.dataset_info import DatasetInfo as JaxDatasetInfo
from vitpose_tpu.data.pipeline import AugmentConfig as JaxAugmentConfig
from vitpose_tpu.data.pipeline import make_preprocess_fn as jax_preprocess_fn
from vitpose_tpu.data.pipeline import (
    sample_augmentations as jax_sample_augmentations)
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.models.heads import HeatmapHead as JaxHead
from vitpose_tpu.models.losses import joints_mse_loss as jax_mse
from vitpose_tpu.ops import geometry as jgeo
from vitpose_tpu.ops import target as jtarget
from vitpose_tpu.ops.decode import pose_pck_accuracy as jax_pck
from vitpose_tpu.train import optim as joptim
from vitpose_tpu.train.state import create_train_state as jax_create_state
from vitpose_tpu.train.step import make_train_step as jax_make_train_step

from test_torch_models import (SMALL, _compile_fast, _port_model,
                               _random_variables, _small)
from vitpose_tpu_torch.data.dataset_info import DatasetInfo
from vitpose_tpu_torch.data.pipeline import (AugmentConfig,
                                             make_preprocess_fn,
                                             sample_augmentations)
from vitpose_tpu_torch.models import forward, infer, make_config
from vitpose_tpu_torch.models.losses import (combined_target_mse_loss,
                                             joints_mse_loss)
from vitpose_tpu_torch.models.topdown import loss_fn
from vitpose_tpu_torch.models.vit import DropPath
from vitpose_tpu_torch.ops import geometry as tgeo
from vitpose_tpu_torch.ops import target as ttarget
from vitpose_tpu_torch.ops.decode import pose_pck_accuracy
from vitpose_tpu_torch.train import (OptimConfig, create_train_state,
                                     layer_decay_adamw, make_lr_schedule,
                                     make_train_step)
from vitpose_tpu_torch.train.optim import layer_id_for_path, make_freeze_mask
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
COCO = DatasetInfo.load('coco')


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _joints(seed, n=3, k=5, lo=-10.0, hi=60.0):
    """Joints of which some lie off the map and some are invisible."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(lo, hi, (n, k, 2)).astype(np.float32)
    vis = (rng.rand(n, k) > 0.25).astype(np.float32)
    return joints, vis


TARGET_KINDS = ('udp', 'msra', 'msra_unbiased')


def _target_joints():
    joints, vis = _joints(0)
    joints[0, 0] = [-60.0, 10.0]      # window misses the map: weight 0
    joints[0, 1] = [47.9, 63.2]       # window clipped at the corner
    return joints, vis


@pytest.fixture(scope='module')
def jax_targets():
    """{kind: (target, weight)} from one JAX program."""
    def fn(joints, vis):
        args = (joints, vis, (48, 64), (12, 16))
        return {'udp': jtarget.generate_udp_heatmaps(*args, sigma=2.0),
                'msra': jtarget.generate_msra_heatmaps(*args, sigma=2.0),
                'msra_unbiased': jtarget.generate_msra_heatmaps(
                    *args, sigma=2.0, unbiased=True)}

    return _compile_fast(fn, *map(jnp.asarray, _target_joints()))


@pytest.mark.parametrize('kind', TARGET_KINDS)
def test_heatmap_targets_match_jax(jax_targets, kind):
    joints, vis = map(_t, _target_joints())
    args = (joints, vis, (48, 64), (12, 16))
    if kind == 'udp':
        out = ttarget.generate_udp_heatmaps(*args, sigma=2.0)
    else:
        out = ttarget.generate_msra_heatmaps(
            *args, sigma=2.0, unbiased=kind == 'msra_unbiased')
    ref = jax_targets[kind]
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert out[1][0, 0] == 0 and (vis == 0).any()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), **TOL)


def _pck_inputs():
    rng = np.random.RandomState(1)
    out = rng.rand(3, 5, 16, 12).astype(np.float32)
    target = rng.rand(3, 5, 16, 12).astype(np.float32)
    target[:, :, 5, 4] += 2.0        # half the predictions hit
    out[:, :2, 5, 4] += 2.0
    weight = (rng.rand(3, 5) > 0.3).astype(np.float32)
    weight[:, 4] = 0.0               # a joint without valid samples
    rot = rng.uniform(-40, 40, 3).astype(np.float32)
    center = rng.uniform(100, 500, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (3, 2)).astype(np.float32)
    pts = rng.uniform(0, 640, (3, 17, 2)).astype(np.float32)
    return out, target, weight, rot, center, scale, pts


def test_point_warp_pck_and_loss_match_jax():
    args = _pck_inputs()

    def fn(out, target, weight, rot, center, scale, pts):
        mat = jgeo.udp_warp_matrix(rot, center, scale, (192, 256))
        return (mat, jgeo.apply_affine_to_points(pts, mat),
                jax_pck(out, target, weight > 0),
                jax_mse(out, target, weight))

    mat, ref_pts, (ref_acc, ref_cnt), ref_loss = _compile_fast(
        fn, *map(jnp.asarray, args))
    out, target, weight, _, _, _, pts = map(_t, args)
    np.testing.assert_allclose(
        tgeo.apply_affine_to_points(pts, _t(np.array(mat))).numpy(),
        np.asarray(ref_pts), **TOL)
    acc, cnt = pose_pck_accuracy(out, target, weight > 0)
    assert int(cnt) == int(ref_cnt) == 4
    np.testing.assert_allclose(float(acc), float(ref_acc), rtol=1e-6)
    loss = joints_mse_loss(out, target, weight)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    assert loss_fn(out, target, weight)['heatmap_loss'] == loss
    # the CombinedTarget loss over 3K channels (held to JAX's in
    # tests/test_torch_td_rest.py)
    out3, target3 = out.repeat(1, 3, 1, 1), target.repeat(1, 3, 1, 1)
    assert loss_fn(out3, target3, weight, 'CombinedTarget')[
        'heatmap_loss'] == combined_target_mse_loss(out3, target3, weight)


def test_dataset_info_body_halves_match_jax():
    ref = JaxDatasetInfo.load('coco')
    assert COCO.upper_body_ids == ref.upper_body_ids
    assert COCO.lower_body_ids == ref.lower_body_ids


def _records(seed, n, canvas_w=120, canvas_h=100):
    """Records of people on a canvas: joints, visibility, center, scale."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        joints = np.zeros((17, 3), np.float32)
        joints[:, 0] = rng.uniform(10, canvas_w - 10, 17)
        joints[:, 1] = rng.uniform(10, canvas_h - 10, 17)
        vis = np.repeat((rng.rand(17, 1) > 0.1).astype(np.float32), 3, 1)
        out.append({'joints_3d': joints, 'joints_3d_visible': vis,
                    'center': rng.uniform(40, 80, 2).astype(np.float32),
                    'scale': rng.uniform(0.3, 0.6, 2).astype(np.float32)})
    return out


def test_sample_augmentations_bit_identical_to_jax():
    """Every aug on (shift and translation too): the same RandomState gives
    the same draws and the same outputs, bit for bit."""
    kw = dict(flip_prob=0.5, half_body_prob=0.6, shift_prob=0.5,
              trans_prob=0.5)
    aug, jaug = AugmentConfig(**kw), JaxAugmentConfig(**kw)
    jinfo = JaxDatasetInfo.load('coco')
    rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    for rec in _records(2, 40):
        out = sample_augmentations(rng, rec, COCO, 120, aug, (48, 64))
        ref = jax_sample_augmentations(jrng, rec, jinfo, 120, jaug, (48, 64))
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    # the image-level augmentations are ported (item 7) but for the
    # albumentations transform
    assert AugmentConfig(photometric=True).has_image_augs()
    with pytest.raises(NotImplementedError, match='albumentations'):
        AugmentConfig(albumentations=[{'type': 'Blur'}])


@pytest.mark.parametrize('use_udp', [True, False])
def test_preprocess_matches_jax(use_udp):
    """Crops, targets and weights of a batch with flip on for some samples
    and off for others, and non-zero rotations."""
    rng = np.random.RandomState(4)
    n = 4
    imgs = rng.randint(0, 256, (n, 100, 120, 3)).astype(np.uint8)
    center = rng.uniform(40, 80, (n, 2)).astype(np.float32)
    scale = rng.uniform(0.3, 0.6, (n, 2)).astype(np.float32)
    rot = np.array([0.0, 25.0, -40.0, 10.0], np.float32)
    joints, vis = _joints(5, n=n, k=17, lo=0.0, hi=110.0)
    flip = np.array([False, True, True, False])
    args = (imgs, center, scale, rot, joints, vis, flip)
    ref = jax_preprocess_fn((48, 64), (12, 16), use_udp=use_udp)(*args)
    out = make_preprocess_fn((48, 64), (12, 16), use_udp=use_udp)(
        *map(_t, args))
    for key in ('imgs', 'target', 'target_weight'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-4)
    # the ViTPose+ padding takes heatmap targets only, as JAX's
    with pytest.raises(ValueError, match='Regression'):
        make_preprocess_fn(target_type='Regression', pad_num_joints=20)


SCHED = dict(base_lr=1e-3, warmup_iters=4, warmup_ratio=0.1,
             decay_epochs=(2, 3), total_epochs=5)


@pytest.mark.parametrize('policy', ['step', 'cosine'])
def test_lr_schedule_matches_optax_at_the_boundaries(policy):
    """Warmup end (4), decay boundaries (6, 9: count >= boundary decays),
    and the cosine's end (15), with 3 steps per epoch. optax computes in
    f32, the port in f64: atol is about base_lr * 2^-24."""
    sched = make_lr_schedule(OptimConfig(**SCHED), 3, policy)
    ref = joptim.make_lr_schedule(joptim.OptimConfig(**SCHED), 3, policy)
    for count in (0, 1, 3, 4, 5, 6, 8, 9, 10, 14, 15, 16):
        np.testing.assert_allclose(sched(count), float(ref(count)),
                                   rtol=1e-6, atol=1e-10)


def test_param_groups_match_jax_scale_and_decay_trees():
    v = _random_variables(seed=6)
    model = _port_model(_small(make_config), v)
    cfg = OptimConfig(num_layers=2)
    opt, _ = layer_decay_adamw(model, cfg, 10)

    def as_state_dict(tree):
        full = jax.tree.map(lambda x, p: np.full(p.shape, x, np.float32),
                            tree, v['params'])
        return state_dict_from_flax({'params': full,
                                     'batch_stats': v['batch_stats']})

    scales = as_state_dict(joptim._lr_scale_tree(v['params'], 2, 0.75))
    decays = as_state_dict(joptim._wd_mask_tree(v['params']))
    names = {id(p): n for n, p in model.named_parameters()}
    seen = set()
    for group in opt.param_groups:
        for name in (names[id(p)] for p in group['params']):
            seen.add(name)
            np.testing.assert_allclose(group['lr_scale'],
                                       scales[name].flatten()[0], rtol=1e-6)
            assert (group['weight_decay'] > 0) == bool(
                decays[name].flatten()[0])
    assert seen == {n for n, _ in model.named_parameters()}
    assert layer_id_for_path('backbone.blocks.1.attn.qkv.weight', 2) == 2
    assert layer_id_for_path('backbone.pos_embed', 2) == 0
    assert layer_id_for_path('keypoint_head.final_layer.bias', 2) == 3


@pytest.fixture(scope='module')
def head_train_ref():
    """(features, variables, flax head output and mutated batch_stats in
    training mode)."""
    feat = np.random.RandomState(7).randn(2, 4, 3, 32).astype(np.float32)
    v = _random_variables(seed=8)
    head = JaxHead(out_channels=5, deconv_filters=(16, 16))
    hv = {'params': v['params']['head'],
          'batch_stats': v['batch_stats']['head']}

    def fn(hv, feat):
        return head.apply(hv, feat, train=True, mutable=['batch_stats'])

    return feat, v, _compile_fast(fn, hv, jnp.asarray(feat))


def test_heatmap_head_training_bn_matches_flax(head_train_ref):
    """Batch statistics normalise, and the running ones move by
    0.9 * old + 0.1 * batch with the biased variance, as flax's."""
    feat, v, (ref, mutated) = head_train_ref
    model = _port_model(_small(make_config), v)
    head = model.keypoint_head.train()
    out = head(torch.from_numpy(feat))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               **MODEL_TOL)
    sd = state_dict_from_flax({'params': v['params'],
                               'batch_stats': {'head': mutated['batch_stats']}})
    # f32 statistics of the same values agree to about 1e-7 of the largest;
    # torch's unbiased running variance (n/(n-1) of the batch's) is 4e-4 and
    # 3e-5 of it away here (96 and 384 values per channel)
    for name, buf in head.named_buffers():
        if 'running' in name:
            np.testing.assert_allclose(buf.numpy(),
                                       sd[f'keypoint_head.{name}'].numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_droppath_draws_from_the_callers_generator():
    dp = DropPath(0.5).train()
    x = torch.ones(64, 3, 2)

    def draw(seed):
        return dp(x, torch.Generator().manual_seed(seed))

    torch.manual_seed(0)
    a = draw(1)
    torch.manual_seed(123)                        # the global seed is unused
    np.testing.assert_array_equal(draw(1).numpy(), a.numpy())
    assert not torch.equal(draw(2), a)
    kept = a[:, 0, 0]
    assert set(kept.tolist()) == {0.0, 2.0} and 10 < (kept > 0).sum() < 54
    with pytest.raises(ValueError, match='Generator'):
        dp(x)
    np.testing.assert_array_equal(dp.eval()(x).numpy(), x.numpy())


def test_infer_runs_in_eval_mode_whatever_mode_training_left():
    """A module left in training mode (BN batch statistics, DropPath)
    still infers with the running statistics, as JAX's train=False."""
    v = _random_variables(seed=9)
    cfg = _small(make_config)
    model = _port_model(cfg, v)
    x = torch.from_numpy(np.random.RandomState(10).randn(2, 64, 48, 3)
                         .astype(np.float32))
    with torch.no_grad():
        ref = infer(model, x, flip_index=np.arange(5))
        forward(model, x, train=True, generator=torch.Generator())
        assert model.training
        model.load_state_dict(state_dict_from_flax(v))   # undo BN update
        out = infer(model, x, flip_index=np.arange(5))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    assert not model.training


# the optimizer of the trajectory: lr 1e-4, 5.5e-4 and 1e-4 at steps 0-2
# (warmup, then a decay boundary at count 2), clipping at 0.05
TRAJ_OPTIM = dict(base_lr=1e-3, num_layers=2, warmup_iters=2,
                  warmup_ratio=0.1, decay_epochs=(2,), total_epochs=4,
                  grad_clip_norm=0.05)


@pytest.fixture(scope='module')
def jax_trajectory():
    """(batch, variables, [(metrics, variables) after each of 3 steps]) of
    the JAX step with drop_path 0."""
    jcfg = _small(jax_make_config, drop_path_rate=0.0)
    jm = JaxTopDown(jcfg)
    v = _random_variables(seed=11)
    rng = np.random.RandomState(12)
    imgs = rng.randn(2, 64, 48, 3).astype(np.float32)
    joints, vis = _joints(13, n=2, k=5, lo=0.0, hi=48.0)
    target, weight = ttarget.generate_udp_heatmaps(_t(joints), _t(vis),
                                                   (48, 64), (12, 16))
    batch = {'imgs': imgs, 'target': target.numpy(),
             'target_weight': weight.numpy()}
    tx = joptim.layer_decay_adamw(v['params'],
                                  joptim.OptimConfig(**TRAJ_OPTIM), 1)
    state = jax_create_state(jm, jax.random.PRNGKey(0), imgs, tx,
                             variables=v)
    step = jax.jit(jax_make_train_step(jm)).lower(
        state, batch, jax.random.PRNGKey(1)).compile(
            compiler_options={'xla_backend_optimization_level': 0})
    out = []
    for _ in range(3):
        state, metrics = step(state, batch, jax.random.PRNGKey(1))
        out.append((jax.tree.map(np.asarray, metrics),
                    {'params': jax.tree.map(np.asarray, state.params),
                     'batch_stats': jax.tree.map(np.asarray,
                                                 state.batch_stats)}))
    return batch, v, out


def test_train_step_trajectory_matches_jax(jax_trajectory):
    batch, v, ref = jax_trajectory
    model = _port_model(_small(make_config, drop_path_rate=0.0), v)
    cfg = OptimConfig(**TRAJ_OPTIM)
    state = create_train_state(model, layer_decay_adamw(model, cfg, 1),
                               cfg.grad_clip_norm)
    step = make_train_step(model)
    tbatch = {k: _t(x) for k, x in batch.items()}
    gen = torch.Generator()
    for i, (ref_metrics, ref_vars) in enumerate(ref):
        metrics = step(state, tbatch, gen)
        for key in ('heatmap_loss', 'grad_norm', 'acc_pose'):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(ref_metrics[key]), rtol=1e-4,
                                       err_msg=f'step {i} {key}')
        assert float(metrics['grad_norm']) > cfg.grad_clip_norm  # clipped
        expected = state_dict_from_flax(ref_vars)
        for name, value in model.state_dict().items():
            if 'num_batches' in name:
                continue
            np.testing.assert_allclose(value.numpy(),
                                       expected[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f'step {i} {name}')
    assert state.step == 3
    # the next update's lr: schedule(3) = 1e-4, times the head's scale 1
    assert state.optimizer.param_groups[-1]['lr'] == pytest.approx(1e-4)


# --- freezing -------------------------------------------------------------

FREEZE_CASES = [dict(frozen_stages=1), dict(frozen_stages=0),
                dict(freeze_attn=True), dict(freeze_ffn=True),
                dict(frozen_stages=1, freeze_attn=True)]


@pytest.mark.parametrize('kw', FREEZE_CASES, ids=lambda kw: '-'.join(kw))
def test_freeze_mask_matches_jax(kw):
    v = _random_variables(seed=14)
    model = _port_model(_small(make_config), v)
    ref = joptim.make_freeze_mask(v['params'], **kw)
    full = jax.tree.map(lambda t, p: np.full(p.shape, t, np.float32), ref,
                        v['params'])
    expected = state_dict_from_flax({'params': full,
                                     'batch_stats': v['batch_stats']})
    mask = make_freeze_mask(model, **kw)
    assert list(mask) == [n for n, _ in model.named_parameters()]
    assert mask == {n: bool(expected[n].flatten()[0]) for n in mask}
    assert not all(mask.values())


# frozen_stages=1 freezes the patch embedding and block 1 (not block 0)
FREEZE = dict(frozen_stages=1)


@pytest.fixture(scope='module')
def jax_frozen_trajectory():
    """(batch, variables, [(metrics, variables) after each of 2 steps]) of
    the JAX step under freeze_tx, drop_path 0."""
    jm = JaxTopDown(_small(jax_make_config, drop_path_rate=0.0))
    v = _random_variables(seed=15)
    rng = np.random.RandomState(16)
    imgs = rng.randn(2, 64, 48, 3).astype(np.float32)
    joints, vis = _joints(17, n=2, k=5, lo=0.0, hi=48.0)
    target, weight = ttarget.generate_udp_heatmaps(_t(joints), _t(vis),
                                                   (48, 64), (12, 16))
    batch = {'imgs': imgs, 'target': target.numpy(),
             'target_weight': weight.numpy()}
    tx = joptim.freeze_tx(
        joptim.layer_decay_adamw(v['params'],
                                 joptim.OptimConfig(**TRAJ_OPTIM), 1),
        joptim.make_freeze_mask(v['params'], **FREEZE))
    state = jax_create_state(jm, jax.random.PRNGKey(0), imgs, tx,
                             variables=v)
    step = jax.jit(jax_make_train_step(jm)).lower(
        state, batch, jax.random.PRNGKey(1)).compile(
            compiler_options={'xla_backend_optimization_level': 0})
    out = []
    for _ in range(2):
        state, metrics = step(state, batch, jax.random.PRNGKey(1))
        out.append((jax.tree.map(np.asarray, metrics),
                    {'params': jax.tree.map(np.asarray, state.params),
                     'batch_stats': jax.tree.map(np.asarray,
                                                 state.batch_stats)}))
    return batch, v, out


def test_frozen_train_step_matches_jax(jax_frozen_trajectory):
    """Frozen parameters keep their values (no update, no weight decay),
    the clip's norm covers the trainable gradients, and the logged
    grad_norm every gradient, frozen ones too, as JAX's freeze_tx and
    optax.global_norm(grads) give them; tolerances of the 3-step
    trajectory."""
    batch, v, ref = jax_frozen_trajectory
    model = _port_model(_small(make_config, drop_path_rate=0.0), v)
    cfg = OptimConfig(**TRAJ_OPTIM)
    mask = make_freeze_mask(model, **FREEZE)
    state = create_train_state(
        model, layer_decay_adamw(model, cfg, 1, trainable=mask),
        cfg.grad_clip_norm)
    step = make_train_step(model)
    tbatch = {k: _t(x) for k, x in batch.items()}
    init = state_dict_from_flax(v)
    for i, (ref_metrics, ref_vars) in enumerate(ref):
        metrics = step(state, tbatch, torch.Generator())
        for key in ('heatmap_loss', 'grad_norm', 'acc_pose'):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(ref_metrics[key]), rtol=1e-4,
                                       err_msg=f'step {i} {key}')
        expected = state_dict_from_flax(ref_vars)
        for name, value in model.named_parameters():
            if not mask[name]:
                assert torch.equal(value, init[name]), name
            np.testing.assert_allclose(value.detach().numpy(),
                                       expected[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f'step {i} {name}')


# --- remat ----------------------------------------------------------------

def _remat_grads(policy):
    """Gradients of one training-mode forward and backward of the small
    model (drop_path 0.3, the same seeded weights, crops and DropPath
    generator seed), with `policy` ('none' or a remat policy)."""
    kw = {} if policy == 'none' else dict(remat_blocks=True,
                                          remat_policy=policy)
    cfg = _small(make_config, drop_path_rate=0.3, fused_attention=True,
                 **kw)
    model = _port_model(cfg, _random_variables(seed=18))
    x = torch.from_numpy(np.random.RandomState(19).randn(4, 64, 48, 3)
                         .astype(np.float32))
    out = forward(model, x, train=True,
                  generator=torch.Generator().manual_seed(20))
    out.square().mean().backward()
    return [p.grad for p in model.parameters()]


@pytest.mark.parametrize('policy', ['full', 'attn', 'dots'])
def test_remat_gives_the_gradients_of_no_remat(policy, monkeypatch):
    """Every gradient equals the one without remat, exactly (a recompute on
    the CPU repeats the same ops): the DropPath masks are drawn before the
    checkpointed blocks, so the recompute uses the forward's. 'attn' keeps
    K3's output and runs the attention forward once per block, as no remat
    does; 'full' and 'dots' run it again in the backward pass."""
    import vitpose_tpu_torch.ops.attention as attn
    plain, calls = attn.reference_attention, []

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(attn, 'reference_attention', counted)
    ref = _remat_grads('none')
    assert len(calls) == SMALL['depth']
    calls.clear()
    grads = _remat_grads(policy)
    for g, r in zip(grads, ref):
        assert torch.equal(g, r)
    assert len(calls) == SMALL['depth'] * (1 if policy == 'attn' else 2)


def test_remat_refuses_unported_and_unknown_policies():
    """Every JAX policy is ported ('attn' on the plain einsum path too,
    held to no remat in tests/test_torch_custom_ops.py); an unknown one
    raises."""
    cfg = _small(make_config, remat_blocks=True, remat_policy='attn')
    _port_model(cfg, _random_variables(seed=18))
    cfg = _small(make_config, remat_blocks=True, remat_policy='most')
    with pytest.raises(ValueError, match='remat_policy'):
        _port_model(cfg, _random_variables(seed=18))

"""The rest of ROADMAP item 7 in the port against the JAX package on the CPU:
the image-level augmentations and their loader hook, CombinedTarget
(target, pipeline, loss, decode), the adaptive wing loss, DeepPose (the
regression head, its flip test, the three regression losses, the
pipeline's target, the step and the decode to image space), and the two
functions no config calls (`generate_megvii_heatmaps`, `weight_norm_clip`).

  * Augmentations: seeded uint8 images and RandomStates; the canvases must
    be equal to JAX's, byte for byte, over seeds on which every gate both
    fires and is skipped (counted by a RandomState that records its draws);
    the train loader with all three on over the COCO fixture of
    tests/test_torch_data.py gives JAX's batches exactly.
  * CombinedTarget: targets within 1e-5 (an ulp of the grid position over
    the radius),
    the loss and its gradient 1e-6 relative, the decode within 1e-4 px.
  * AdaptiveWing and the regression losses: value and gradient within 1e-6
    relative, targets with their weights.
  * DeepPose on ResNet-18 at 64x48 (JAX variables from a seeded numpy
    generator carried through the converters): the head's coordinates
    and the flip test within 1e-5 of the largest, one step of each loss
    from the same weights (metrics 1e-4 relative; Adam's first moment 1e-4
    relative plus 1e-4 of its largest; every parameter within twice the
    step's lr, as tests/test_torch_cnn.py holds steps), the decode within
    1e-3 px. JAX's programs run at XLA level 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import pipeline as jpipe
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.models import losses as jlosses
from vitpose_tpu.models import losses_regression as jreg
from vitpose_tpu.ops import decode as jdecode
from vitpose_tpu.ops import target as jtarget
from vitpose_tpu.train import optim as joptim
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.train.state import TrainState as JaxTrainState
from vitpose_tpu.train.step import make_train_step as jax_make_train_step

from test_torch_cnn import FLIP, TRAIN_OPTIM, _adam_mu
from test_torch_cnn_ms import (crops, jax_variables,  # noqa: F401
                               one_torch_thread, port_model)
from test_torch_data import assert_same_tree, dataset_pair, write_coco_fixture
from test_torch_models import _compile_fast
from vitpose_tpu_torch.data import pipeline as ppipe
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.models import losses as plosses
from vitpose_tpu_torch.models.heads_extra import RegressionHead
from vitpose_tpu_torch.models.topdown import forward, infer
from vitpose_tpu_torch.ops import decode as pdecode
from vitpose_tpu_torch.ops import target as ptarget
from vitpose_tpu_torch.train import (OptimConfig, create_train_state,
                                     layer_decay_adamw)
from vitpose_tpu_torch.train.optim import weight_norm_clip
from vitpose_tpu_torch.train.loop import build_model_from_cfg, topdown_config
from vitpose_tpu_torch.train.step import make_train_step
from vitpose_tpu_torch.utils.convert import cnn_state_dict_from_flax

SEEDS = range(40)


class Recorder(np.random.RandomState):
    """A RandomState that records the result of every randint(2) and of
    every rand() (the augmentations' gates)."""

    def __init__(self, seed):
        super().__init__(seed)
        self.gates = []

    def randint(self, *a, **k):
        out = super().randint(*a, **k)
        if a == (2,):
            self.gates.append(int(out))
        return out

    def rand(self, *a):
        out = super().rand(*a)
        if not a:
            self.gates.append(float(out))
        return out


def image(seed, hw=(40, 56)):
    return np.random.RandomState(seed).randint(0, 256, hw + (3,)) \
        .astype(np.uint8)


def photometric_gates(gates):
    """{gate: fired} of one photometric draw sequence: brightness, contrast
    before or after, saturation, hue, channel swap."""
    bright, last, *rest = gates
    out = {'brightness': bright, 'contrast_last': last}
    if not last:
        out['contrast'], rest = rest[0], rest[1:]
    out['saturation'], out['hue'] = rest[0], rest[1]
    if last:
        out['contrast'], rest = rest[2], rest[3:]
    else:
        rest = rest[2:]
    out['swap'] = rest[0]
    return out


def test_photometric_distortion_equals_jax():
    seen = {}
    for seed in SEEDS:
        img = image(seed)
        rec = Recorder(seed)
        got = ppipe.photometric_distortion(rec, img.copy())
        want = jpipe.photometric_distortion(np.random.RandomState(seed),
                                            img.copy())
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f'seed {seed}')
        for gate, fired in photometric_gates(rec.gates).items():
            seen.setdefault(gate, set()).add(bool(fired))
    assert len(seen) == 6 and all(v == {True, False} for v in seen.values())


@pytest.mark.parametrize('which, kw', [
    ('coarse_dropout', {}),
    ('coarse_dropout', dict(max_holes=3, max_height=8, max_width=12,
                            min_height=2, min_width=2, fill_value=128)),
    ('grid_dropout', {}),
    ('grid_dropout', dict(unit_size_min=4, unit_size_max=9, ratio=0.3,
                          random_offset=False, fill_value=7))])
def test_dropouts_equal_jax(which, kw):
    fired = set()
    for seed in SEEDS:
        img = image(seed)
        rec = Recorder(seed)
        got = getattr(ppipe, which)(rec, img, **kw)
        want = getattr(jpipe, which)(np.random.RandomState(seed), img, **kw)
        np.testing.assert_array_equal(got, want, err_msg=f'seed {seed}')
        fired.add(rec.gates[0] < 0.5)
        assert (got is img) == (rec.gates[0] >= 0.5)
    assert fired == {True, False}


def test_apply_image_augmentations_equals_jax():
    for seed in SEEDS:
        kw = dict(photometric=dict(hue_delta=30), coarse_dropout=dict(p=0.8),
                  grid_dropout=True)
        img = image(seed)
        got = ppipe.apply_image_augmentations(
            np.random.RandomState(seed), img, ppipe.AugmentConfig(**kw))
        want = jpipe.apply_image_augmentations(
            np.random.RandomState(seed), img, jpipe.AugmentConfig(**kw))
        np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError, match='albumentations'):
        ppipe.AugmentConfig(albumentations=[dict(type='Blur')])


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    return write_coco_fixture(str(tmp_path_factory.mktemp('td_rest')))


def test_train_loader_with_image_augmentations_matches_jax(coco):
    """The hook of JAX's loader: each record's canvas changed from its own
    RandomState before its geometry is drawn; canvases, draws and every
    other field equal JAX's."""
    aug = dict(photometric=True, coarse_dropout=dict(p=0.7),
               grid_dropout=dict(p=0.7))
    ref_ds, port_ds = dataset_pair(coco, use_gt_bbox=True)
    ref = JaxTopDownLoader(ref_ds, 4, is_train=True, seed=3, num_workers=2,
                           aug=jpipe.AugmentConfig(**aug))
    port = TopDownLoader(port_ds, 4, is_train=True, seed=3, num_workers=2,
                         aug=ppipe.AugmentConfig(**aug))
    plain = TopDownLoader(port_ds, 4, is_train=True, seed=3, num_workers=2)
    for loader in (ref, port, plain):
        loader.use_native = False
    a, b, c = list(ref), list(port), list(plain)
    assert len(a) == len(b) > 0
    assert_same_tree(b, a)
    assert any((x['imgs'] != y['imgs']).any() for x, y in zip(b, c))


# --- CombinedTarget ----------------------------------------------------------

def joints_case(seed, n=2, k=17, size=(48, 64)):
    """Joints in a 48x64 crop, some outside it, some invisible."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(-8, [size[0] + 8, size[1] + 8], (n, k, 2)) \
        .astype(np.float32)
    vis = (rng.rand(n, k) > 0.25).astype(np.float32)
    return joints, vis


def test_combined_target_equals_jax():
    joints, vis = joints_case(0)
    got, w = ptarget.generate_combined_target(
        torch.from_numpy(joints), torch.from_numpy(vis), (48, 64), (12, 16))
    want, jw = _compile_fast(lambda j, v: jtarget.generate_combined_target(
        j, v, (48, 64), (12, 16)), joints, vis)
    assert got.shape == (2, 17, 3, 16, 12)
    # an ulp of the joint's grid position (XLA divides by the stride as a
    # product with its reciprocal) over the radius: 1.1e-6 measured
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert got[:, :, 0].sum() > 10


@pytest.mark.parametrize('target_type', ['CombinedTarget', 'Regression'])
def test_preprocess_targets_equal_jax(target_type):
    """make_preprocess_fn's crops and targets of a flipped, rotated batch:
    CombinedTarget's 3K channels, DeepPose's normalised coordinates and
    their [N, K, 2] weight (0 outside the crop)."""
    rng = np.random.RandomState(4)
    imgs = rng.randint(0, 256, (2, 96, 96, 3)).astype(np.uint8)
    center = np.array([[48, 40], [50, 55]], np.float32)
    scale = np.array([[0.4, 0.5], [0.3, 0.4]], np.float32)
    rot = np.array([0.0, 20.0], np.float32)
    joints = rng.uniform(10, 86, (2, 17, 2)).astype(np.float32)
    vis = (rng.rand(2, 17) > 0.2).astype(np.float32)
    flip = np.array([True, False])
    args = dict(image_size=(48, 64), heatmap_size=(12, 16), use_udp=True,
                target_type=target_type)
    want = jpipe.make_preprocess_fn(**args)(imgs, center, scale, rot,
                                            joints, vis, flip)
    got = ppipe.make_preprocess_fn(**args)(
        *(torch.from_numpy(a) for a in (imgs, center, scale, rot, joints,
                                        vis, flip)))
    k = 3 * 17 if target_type == 'CombinedTarget' else 17
    shape = (2, k, 16, 12) if target_type == 'CombinedTarget' else (2, 17, 2)
    assert got['target'].shape == shape
    # crops 1e-4 (the bilinear warp, as tests/test_torch_data.py), targets
    # 1e-5 (the crop-space joints come from the affine in f32, whose
    # rounding differs by an ulp: 1.1e-6 measured on the offsets)
    for key, atol in (('imgs', 1e-4), ('target', 1e-5),
                      ('target_weight', 0)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, err_msg=key)
    if target_type == 'Regression':
        assert got['target_weight'].shape == (2, 17, 2)
        assert 0 < got['target_weight'].mean() < 1


def grad_pair(port_fn, jax_fn, pred, *rest):
    """(value, d value / d pred) of the port's and JAX's loss."""
    p = torch.from_numpy(pred).requires_grad_()
    value = port_fn(p, *(torch.from_numpy(np.array(r)) for r in rest))
    value.backward()
    value = value.detach()
    jv, jg = _compile_fast(jax.value_and_grad(lambda x: jax_fn(x, *rest)),
                           pred)
    return (float(value), p.grad.numpy()), (float(jv), np.asarray(jg))


def assert_close_pair(got, want):
    assert got[0] == pytest.approx(want[0], rel=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6,
                               atol=1e-6 * np.abs(want[1]).max())


def test_combined_target_loss_equals_jax():
    joints, vis = joints_case(1)
    t, w = jtarget.generate_combined_target(joints, vis, (48, 64), (12, 16))
    target = np.asarray(t).reshape(2, 51, 16, 12)
    pred = target + np.random.RandomState(2).normal(
        0, 0.3, target.shape).astype(np.float32)
    got, want = grad_pair(plosses.combined_target_mse_loss,
                          jlosses.combined_target_mse_loss, pred, target,
                          np.asarray(w))
    assert_close_pair(got, want)
    assert want[0] > 0


def test_combined_target_decode_equals_jax():
    """Maps of a target blurred into a smooth response plus noise: the UDP
    decode through keypoints_from_heatmaps (and its argmax, offsets and
    radius) within 1e-4 px of JAX's in image space."""
    joints, vis = joints_case(3, size=(192, 256))
    vis[:] = 1
    joints = np.clip(joints, 4, [188, 252]).astype(np.float32)
    t, _ = jtarget.generate_combined_target(joints, vis, (192, 256),
                                            (48, 64))
    maps = np.asarray(t).reshape(2, 51, 64, 48) + np.random.RandomState(
        5).normal(0, 0.05, (2, 51, 64, 48)).astype(np.float32)
    center = np.array([[100, 120], [80, 150]], np.float32)
    scale = np.array([[1.0, 1.3], [0.8, 1.1]], np.float32)
    got = pdecode.keypoints_from_heatmaps(
        torch.from_numpy(maps), torch.from_numpy(center),
        torch.from_numpy(scale), use_udp=True, target_type='CombinedTarget')
    want = _compile_fast(lambda m, c, s: jdecode.keypoints_from_heatmaps(
        m, c, s, use_udp=True, target_type='CombinedTarget'), maps, center,
        scale)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)


def test_combined_target_step_metrics():
    """The CombinedTarget step trains on the 3K-channel target and logs no
    PCK (JAX's step skips it there)."""
    model = build_model_from_cfg(dict(
        backbone_type='hrnet', backbone_overrides=dict(
            width=8, stage_modules=(1,), stage_blocks=1),
        img_size=(64, 48), out_channels=17, deconv_filters=(),
        target_type='CombinedTarget'))
    assert model.cfg.out_channels == 51      # 3 maps per joint
    cfg = OptimConfig(**TRAIN_OPTIM)
    state = create_train_state(model, layer_decay_adamw(model, cfg, 1),
                               cfg.grad_clip_norm)
    joints, vis = joints_case(6)
    t, w = ptarget.generate_combined_target(
        torch.from_numpy(joints), torch.from_numpy(vis), (48, 64), (12, 16))
    batch = {'imgs': torch.from_numpy(crops((64, 48), 1, n=2)),
             'target': t.reshape(2, 51, 16, 12), 'target_weight': w}
    m = make_train_step(model, target_type='CombinedTarget')(
        state, batch, torch.Generator())
    assert set(m) == {'heatmap_loss', 'grad_norm'}
    assert float(m['heatmap_loss']) > 0 and np.isfinite(float(m['grad_norm']))
    # a head whose channels are not 3 x the target's joints raises
    wrong = dict(batch, target_weight=torch.ones(2, 51))
    with pytest.raises(ValueError, match='3 maps per joint'):
        make_train_step(model, target_type='CombinedTarget')(
            state, wrong, torch.Generator())


@pytest.mark.parametrize('joints', [15, 17, 21])
def test_combined_target_out_channels_count_joints(joints):
    """Under CombinedTarget a config's out_channels counts joints, whether
    or not it is a multiple of 3 (Sub-JHMDB's 15, COCO's 17, a hand's 21):
    the head has 3 maps per joint."""
    cfg = topdown_config(dict(backbone_type='resnet', out_channels=joints,
                              target_type='CombinedTarget'))
    assert cfg.out_channels == 3 * joints
    plain = topdown_config(dict(backbone_type='resnet', out_channels=joints))
    assert plain.out_channels == joints


# --- AdaptiveWing and the regression losses ----------------------------------

def test_adaptive_wing_loss_equals_jax():
    rng = np.random.RandomState(7)
    target = rng.uniform(0, 1, (2, 5, 8, 6)).astype(np.float32)
    pred = target + rng.normal(0, 0.6, target.shape).astype(np.float32)
    weight = (rng.rand(2, 5) > 0.3).astype(np.float32)
    got, want = grad_pair(plosses.adaptive_wing_loss,
                          jlosses.adaptive_wing_loss, pred, target, weight)
    assert_close_pair(got, want)
    # both regimes: residuals below and above theta
    d = np.abs((target - pred) * weight[..., None, None])
    assert (d < 0.5).any() and (d > 0.5).any()


@pytest.mark.parametrize('name', ['smooth_l1', 'wing', 'soft_wing'])
@pytest.mark.parametrize('weight_rank', [2, 3])
def test_regression_losses_equal_jax(name, weight_rank):
    rng = np.random.RandomState(8)
    target = rng.uniform(0, 1, (3, 7, 2)).astype(np.float32)
    # residuals on both sides of each loss's knee (1, 10 and 2)
    pred = target + rng.normal(0, 4.0, target.shape).astype(np.float32)
    weight = (rng.rand(3, 7) > 0.3).astype(np.float32)
    if weight_rank == 3:
        weight = np.repeat(weight[..., None], 2, -1)
    jfn = {'smooth_l1': jreg.smooth_l1_loss, 'wing': jreg.wing_loss,
           'soft_wing': jreg.soft_wing_loss}[name]
    got, want = grad_pair(plosses.REGRESSION_LOSSES[name], jfn, pred, target,
                          weight)
    assert_close_pair(got, want)


# --- DeepPose ----------------------------------------------------------------

DEEPPOSE = dict(backbone_type='resnet', backbone_overrides=dict(depth=18),
                img_size=(64, 48), out_channels=17, head='regression',
                target_type='Regression', use_udp=False, flip_test=True)
OPTIM = dict(TRAIN_OPTIM, base_lr=1e-4)


def jax_regression_outputs(variables, x):
    """JAX DeepPose's coordinates of x and its mirror, and its infer's flip
    test of x, one program at XLA level 0."""
    from vitpose_tpu.models.topdown import infer as jax_infer
    jm = jax_build(DEEPPOSE)

    def fn(v, x):
        both = jm.apply(v, jnp.concatenate([x, x[:, :, ::-1]]))
        return both, jax_infer(jm, v, x, flip_index=FLIP)

    return _compile_fast(fn, variables, jnp.asarray(x))


@pytest.fixture(scope='module')
def deeppose():
    v = jax_variables(DEEPPOSE, seed=3)
    x = crops((64, 48), seed=13, n=2)
    both, flipped = jax_regression_outputs(v, x)
    return port_model(DEEPPOSE, v), v, x, np.asarray(both), \
        np.asarray(flipped)


def test_regression_head_and_flip_test_equal_jax(deeppose):
    model, _, x, both, flipped = deeppose
    assert isinstance(model.keypoint_head, RegressionHead)
    assert set(model.keypoint_head.state_dict()) == {'fc.weight', 'fc.bias'}
    with torch.no_grad():
        out = forward(model, torch.from_numpy(
            np.concatenate([x, x[:, :, ::-1]])))
    assert out.dtype == torch.float32 and out.shape == (4, 17, 2)
    top = np.abs(both).max()
    np.testing.assert_allclose(out.numpy(), both, atol=1e-5 * top)
    with torch.no_grad():
        hm = infer(model, torch.from_numpy(x),
                   flip_index=torch.from_numpy(FLIP))
    np.testing.assert_allclose(hm.numpy(), flipped, atol=1e-5 * top)
    # the mirror pass, permuted and mirrored about 0.5, enters the mean
    mirror = both[2:][:, FLIP]
    mirror[..., 0] = 1 - mirror[..., 0]
    np.testing.assert_allclose(flipped, (both[:2] + mirror) / 2,
                               atol=1e-5 * top)


def regression_batch(model, seed):
    """2 crops and targets of joints drawn inside and outside the crop,
    through the port's preprocess (its targets are held to JAX's in
    test_preprocess_targets_equal_jax)."""
    rng = np.random.RandomState(seed)
    pre = ppipe.make_preprocess_fn((48, 64), (12, 16), use_udp=False,
                                   target_type='Regression')
    out = pre(torch.from_numpy(rng.randint(0, 256, (2, 80, 80, 3))
                               .astype(np.uint8)),
              torch.tensor([[40.0, 40.0], [38.0, 42.0]]),
              torch.tensor([[0.3, 0.4], [0.25, 0.33]]), torch.zeros(2),
              torch.from_numpy(rng.uniform(0, 80, (2, 17, 2))
                               .astype(np.float32)),
              torch.from_numpy((rng.rand(2, 17) > 0.2).astype(np.float32)))
    return {k: v.numpy() for k, v in out.items()}


def jax_regression_step(v, batch, reg_loss):
    """JAX's state and metrics after one DeepPose step of `reg_loss` from
    `v`, all in float64 (64-bit JAX for this call, XLA level 1), returned
    as numpy f64."""
    mdict = dict(DEEPPOSE, reg_loss=reg_loss, dtype='float64',
                 backbone_overrides=dict(DEEPPOSE['backbone_overrides'],
                                         dtype='float64'))
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), v)
        batch = {k: jnp.asarray(a, jnp.float64) for k, a in batch.items()}
        jm = jax_build(mdict)
        tx = joptim.layer_decay_adamw(v['params'],
                                      joptim.OptimConfig(**OPTIM), 1)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                              params=v['params'],
                              batch_stats=v['batch_stats'],
                              opt_state=jax.jit(tx.init)(v['params']), tx=tx)
        step = jax.jit(jax_make_train_step(
            jm, target_type='Regression', reg_loss=reg_loss)).lower(
                state, batch, jax.random.PRNGKey(1)).compile(
                    compiler_options={'xla_backend_optimization_level': 1})
        state, metrics = step(state, batch, jax.random.PRNGKey(1))
        return (jax.tree.map(np.asarray, state.params),
                jax.tree.map(np.asarray, state.batch_stats),
                jax.tree.map(np.asarray, _adam_mu(state.opt_state)),
                {k: float(m) for k, m in metrics.items()})


@pytest.mark.parametrize('reg_loss', ['smooth_l1'])
def test_regression_step_matches_jax(deeppose, reg_loss):
    """One DeepPose step from the same weights, both packages in float64
    (ResNet-18's layer4 is 2x2 at these crops: BN over 8 values a channel,
    where f32 statistics lose digits, as PRs 11-12 found): the metrics
    (reg_loss and heatmap_loss the criterion, acc_pose PCK at 0.05,
    grad_norm), Adam's first moment, every parameter and BN statistic."""
    model, v, _, _, _ = deeppose
    batch = regression_batch(model, seed=40)
    params, stats, mu, jmetrics = jax_regression_step(v, batch, reg_loss)
    twin = build_model_from_cfg(dict(
        DEEPPOSE, dtype='float64', backbone_overrides=dict(
            DEEPPOSE['backbone_overrides'], dtype='float64'))).double()
    twin.load_state_dict(model.state_dict())
    cfg = OptimConfig(**OPTIM)
    pstate = create_train_state(twin, layer_decay_adamw(twin, cfg, 1),
                                cfg.grad_clip_norm)
    metrics = make_train_step(twin, target_type='Regression',
                              reg_loss=reg_loss)(
        pstate, {k: torch.from_numpy(a) for k, a in batch.items()},
        torch.Generator())
    assert list(metrics) == ['reg_loss', 'heatmap_loss', 'acc_pose',
                             'grad_norm']
    for key in metrics:
        assert float(metrics[key]) == pytest.approx(jmetrics[key],
                                                    rel=1e-6), key
    moments = cnn_state_dict_from_flax({'params': mu}, 'resnet')
    for name, p in twin.named_parameters():
        want = moments[name].numpy()
        np.testing.assert_allclose(
            pstate.optimizer.state[p]['exp_avg'].numpy(), want, rtol=1e-6,
            atol=1e-6 * np.abs(want).max(), err_msg=name)
    after = cnn_state_dict_from_flax({'params': params,
                                      'batch_stats': stats}, 'resnet')
    for name, t in twin.state_dict().items():
        np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize('reg_loss', ['wing', 'soft_wing'])
def test_regression_step_takes_the_configs_criterion(deeppose, reg_loss):
    """The face configs' criteria in the step (JAX holds the smooth L1
    step above; each criterion's value and gradient against JAX's in
    test_regression_losses_equal_jax): reg_loss is the criterion of the
    training-mode output, before the update."""
    model, _, _, _, _ = deeppose
    weights = {k: t.clone() for k, t in model.state_dict().items()}
    batch = {k: torch.from_numpy(a)
             for k, a in regression_batch(model, seed=41).items()}
    try:
        with torch.no_grad():
            out = forward(model, batch['imgs'], train=True)
        want = plosses.REGRESSION_LOSSES[reg_loss](out, batch['target'],
                                                   batch['target_weight'])
        model.load_state_dict(weights)
        cfg = OptimConfig(**OPTIM)
        state = create_train_state(model, layer_decay_adamw(model, cfg, 1),
                                   cfg.grad_clip_norm)
        m = make_train_step(model, target_type='Regression',
                            reg_loss=reg_loss)(state, batch,
                                               torch.Generator())
        assert float(m['reg_loss']) == float(m['heatmap_loss']) \
            == pytest.approx(float(want), rel=1e-6)
        assert float(m['reg_loss']) != pytest.approx(float(
            plosses.smooth_l1_loss(out, batch['target'],
                                   batch['target_weight'])), rel=1e-3)
    finally:
        model.load_state_dict(weights)
        model.eval()


def test_regression_decode_to_image_space(deeppose, coco):
    """keypoints_from_regression equals JAX's (transform_preds without UDP;
    with UDP as JAX's val step calls it); run_validation with the
    'Regression' target type decodes the flip-tested coordinates of each
    box with maxvals of one."""
    from vitpose_tpu.ops.geometry import transform_preds as jax_transform
    rng = np.random.RandomState(9)
    coords = rng.uniform(0, 1, (3, 17, 2)).astype(np.float32)
    center = rng.uniform(50, 100, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (3, 2)).astype(np.float32)
    got, ones = pdecode.keypoints_from_regression(
        torch.from_numpy(coords), torch.from_numpy(center),
        torch.from_numpy(scale), (48, 64))
    want, jones = jdecode.keypoints_from_regression(coords, center, scale,
                                                    (48, 64))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    np.testing.assert_array_equal(ones.numpy(), jones)
    got_udp, _ = pdecode.keypoints_from_regression(
        torch.from_numpy(coords), torch.from_numpy(center),
        torch.from_numpy(scale), (48, 64), use_udp=True)
    want_udp = jax_transform(coords * np.float32([48, 64]), center, scale,
                             (48, 64), use_udp=True)
    np.testing.assert_allclose(got_udp.numpy(), np.asarray(want_udp),
                               atol=1e-3)
    model = deeppose[0]
    _, port_ds = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                              bbox_file=coco['det'])
    loader = TopDownLoader(port_ds, 4, is_train=False, num_workers=2)
    results = run_validation(model, loader, use_udp=False,
                             target_type='Regression')
    batch = next(iter(loader))
    preds = results[0]['preds']
    assert preds.shape == (4, 17, 3) and (preds[..., 2] == 1).all()
    x = torch.from_numpy(batch['imgs']).float() / 255.0
    from vitpose_tpu_torch.ops.geometry import affine_matrix
    from vitpose_tpu_torch.ops.warp import warp_affine_batch
    c, s = (torch.from_numpy(batch[k]) for k in ('center', 'scale'))
    crops_ = warp_affine_batch(x, affine_matrix(c, s, torch.zeros(4),
                                                (48, 64)), (48, 64))
    crops_ = (crops_ - torch.from_numpy(ppipe.IMAGENET_MEAN)) \
        / torch.from_numpy(ppipe.IMAGENET_STD)
    with torch.no_grad():
        coords = infer(model, crops_, flip_index=torch.from_numpy(FLIP))
    want, _ = pdecode.keypoints_from_regression(
        coords, torch.from_numpy(batch['center_orig']),
        torch.from_numpy(batch['scale_orig']), (48, 64))
    np.testing.assert_allclose(preds[..., :2], want.numpy(), atol=1e-3)


# --- the two functions no config calls ---------------------------------------

def test_megvii_heatmaps_equal_jax():
    joints, vis = joints_case(11, size=(48, 64))
    vis[0, :3] = 2
    got, w = ptarget.generate_megvii_heatmaps(
        torch.from_numpy(joints), torch.from_numpy(vis), (48, 64), (12, 16),
        kernel=5)
    want, jw = _compile_fast(lambda j, v: jtarget.generate_megvii_heatmaps(
        j, v, (48, 64), (12, 16), kernel=5), joints, vis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert got.amax() > 200 and (w == 0).any() and (w > 0).any()


def test_weight_norm_clip_equals_jax(deeppose):
    """Every linear and conv weight whose norm exceeds max_norm scaled to
    it, as JAX's clip of the flax kernels; BN scales and biases kept."""
    model, v, _, _, _ = deeppose
    weights = {k: t.clone() for k, t in model.state_dict().items()}
    try:
        weight_norm_clip(model, max_norm=3.0)
        clipped = _compile_fast(lambda p: joptim.weight_norm_clip(p, 3.0),
                                v['params'])
        want = cnn_state_dict_from_flax(dict(v, params=jax.tree.map(
            np.asarray, clipped)), 'resnet')
        changed = 0
        for name, t in model.state_dict().items():
            # each norm sums up to 1.2 M f32 squares in another order
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=3e-5, atol=1e-7, err_msg=name)
            changed += not torch.equal(t, weights[name])
        assert changed > 5
        assert all(torch.equal(t, weights[n]) for n, t in
                   model.state_dict().items() if '.bn' in n)
    finally:
        model.load_state_dict(weights)

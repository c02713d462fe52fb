"""The port's multi-stage and lightweight CNNs of ROADMAP item 12b (MSPN and
RSN with the MSMU head, Lite-HRNet, stacked Hourglass with the multi-stage
head, CPM with the identity head, MobileNetV2 and ShuffleNetV2 with the
classic head) against the JAX package on the CPU: the backbone features,
the flip-tested heatmaps and their decode ('megvii' on MSPN), every (stage,
unit) output in training mode, bf16, the weight converters and the
weight-decay sets, and Lite-HRNet's fusion quirks.

Weights: JAX's variables of each case are drawn from a seeded numpy
generator (fan-in scaled kernels, BN scales near 1, non-trivial running
statistics) in the tree that JAX's converters read off a state dict of the
port model's shapes, and carried into the port through
`cnn_state_dict_from_flax` with strict=True. Sizes: 64x48 crops (Lite-HRNet
and Hourglass 64x64), one block per stage or unit, widths of 8 to 32 where
the JAX classes let them be set (CPM's stem, MSPN's bottleneck expansion
and the Hourglass stem are fixed), Hourglass at downsample_times 2 with two
stacks, MSPN with two stages (cross-stage skips and the cross conv), RSN
with three steps and two units. Each JAX reference is one program (the
crops and their mirror, in eval and in training mode) compiled at XLA CPU
optimisation level 0, once per module.

Tolerances as tests/test_torch_cnn_more.py: f32 features and heatmaps 1e-4
absolute plus 1e-4 relative, decoded keypoints 1e-3 px; bf16 against the
f32 answer of the same weights, the port's RMS error at most BF16_FACTOR
times flax's own and the two within 5% of the largest f32 value; the
converters exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.models import multistage_nets as jms
from vitpose_tpu.ops.decode import keypoints_from_heatmaps as jax_decode
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.utils.cnn_ckpt import (BACKBONE_CONVERTERS, HEAD_CONVERTERS,
                                        convert_msmu_head)
from vitpose_tpu.utils.torch_ckpt import convert_head

from test_torch_cnn import (BF16_FACTOR, FLIP, TOL, _Reads,
                            assert_decay_and_lr_scale_sets_match,
                            jax_flip_test)
from test_torch_models import _compile_fast
from test_torch_cnn_more import _equal_trees
from vitpose_tpu_torch.models import multistage_nets as pms
from vitpose_tpu_torch.models.resnet import conv2d, norm
from vitpose_tpu_torch.models.topdown import (GenericMultiStageTopDown,
                                              GenericTopDown, forward, infer)
from vitpose_tpu_torch.ops.decode import keypoints_from_heatmaps
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils.convert import cnn_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

HEAD = dict(deconv_filters=(16, 16), deconv_kernels=(4, 4))
LITE = dict(stem_channels=16, stem_out_channels=16, num_modules=(1, 1, 1),
            num_blocks=(1, 1, 1), stage_channels=((8, 16), (8, 16, 32),
                                                  (8, 16, 32, 64)))
# name -> (model dict, (h, w) of the crops)
CASES = {
    'mspn': (dict(backbone_type='mspn', backbone_overrides=dict(
        num_stages=2, num_units=4, num_blocks=(1, 1, 1, 1),
        unit_channels=16, res_top_channels=16), head='msmu', num_stages=2,
        num_units=4, post_process='megvii', modulate_kernel=5, use_udp=False),
        (64, 48)),
    'rsn': (dict(backbone_type='rsn', backbone_overrides=dict(
        num_stages=1, num_units=2, num_blocks=(1, 1), unit_channels=16,
        num_steps=3), head='msmu', num_stages=1, num_units=2), (64, 48)),
    'litehrnet': (dict(backbone_type='litehrnet', backbone_overrides=LITE,
                       deconv_filters=(), shift_heatmap=True), (64, 64)),
    'hourglass': (dict(backbone_type='hourglass', backbone_overrides=dict(
        downsample_times=2, num_stacks=2, stage_channels=(256, 16, 24),
        stage_blocks=(1, 1, 1), feat_channel=16), head='multistage',
        num_stages=2, deconv_filters=(), final_kernel=1), (64, 64)),
    'cpm': (dict(backbone_type='cpm', backbone_overrides=dict(
        out_channels=17, num_stages=3, feat_channels=16, middle_channels=8),
        head='identity', num_stages=3, shift_heatmap=True), (64, 48)),
    'mobilenet_v2': (dict(backbone_type='mobilenet_v2', backbone_overrides=
                          dict(widen_factor=0.25), **HEAD), (64, 48)),
    'shufflenet_v2': (dict(backbone_type='shufflenet_v2', backbone_overrides=
                           dict(widen_factor=0.5), **HEAD), (64, 48)),
}
MULTI_STAGE = ('mspn', 'rsn', 'hourglass', 'cpm')
# the training-mode maps held to JAX's f32 ones; MSPN's are not: at 64x48
# its lowest units are 2x2, each BN over 8 values a channel, where JAX's
# f32 statistics lose digits (its maps up to 5.2e-4 from an f64 run, the
# port's f32 1.7e-4); MSPN's training mode is held in
# tests/test_torch_cnn_ms_paths.py's train steps against JAX's f64
TRAIN_MODE = ('rsn', 'hourglass', 'cpm')
BF16_CASE = 'mspn'


def model_dict(name, dtype=None):
    mdict, hw = CASES[name]
    mdict = dict(mdict, img_size=hw, out_channels=17)
    if dtype:
        mdict['dtype'] = dtype
        mdict['backbone_overrides'] = dict(
            mdict.get('backbone_overrides', {}), dtype=dtype)
    return mdict


def converters(mdict, sd):
    """JAX's backbone and head converters of `mdict` on the state dict
    `sd`: ((params, stats) of the backbone, of the head)."""
    bt = mdict['backbone_type']
    bb = BACKBONE_CONVERTERS[bt](sd, prefix='backbone.')
    if mdict.get('head') == 'msmu':
        head = convert_msmu_head(sd, prefix='keypoint_head.',
                                 num_units=mdict['num_units'],
                                 use_prm=mdict.get('use_prm', False))
    else:
        head = HEAD_CONVERTERS.get(bt, convert_head)(sd,
                                                     prefix='keypoint_head.')
    return bb, head


def as_variables(bb, head):
    params, stats = {'backbone': bb[0]}, {'backbone': bb[1]}
    if head[0]:
        params['head'], stats['head'] = head
    return {'params': params, 'batch_stats': stats}


def jax_variables(mdict, seed):
    """JAX's variables of `mdict` in the tree its converters read off a
    state dict of the port model's shapes, filled from a seeded numpy
    generator, as numpy."""
    with torch.device('meta'):
        model = build_model_from_cfg(mdict)
    sd = {k: np.zeros(v.shape, np.float32)
          for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name == 'var':
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        a = rng.standard_normal(shape, np.float32)
        if name == 'scale':
            return 1.0 + 0.1 * a
        if name in ('mean', 'bias'):
            return 0.1 * a
        return a / np.float32(np.sqrt(np.prod(shape[:-1])))    # kernels

    return jax.tree_util.tree_map_with_path(
        fill, as_variables(*converters(mdict, sd)))


def port_model(mdict, variables):
    """The port's model of `mdict` with the JAX variables, loaded strictly
    into a model built on the meta device."""
    with torch.device('meta'):
        model = build_model_from_cfg(mdict)
    model.load_state_dict(cnn_state_dict_from_flax(
        variables, mdict['backbone_type']), strict=True, assign=True)
    return model.eval()


def flat(tree):
    """The arrays of a nested list, in order."""
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in flat(t)]
    return [tree]


def jax_forward(mdict, variables, x, train=True):
    """(backbone features NHWC, eval heatmaps, the training-mode list of
    maps, or None without `train`) of JAX's model on x and its mirror, one
    program."""
    jm = jax_build(mdict)

    def fn(v, x):
        x2 = jnp.concatenate([x, x[:, :, ::-1]])
        hm, state = jm.apply(v, x2, capture_intermediates=(
            lambda mdl, _: mdl.name == 'backbone'))
        (feat,) = state['intermediates']['backbone']['__call__']
        outs = (jm.apply(v, x2, train=True, mutable=['batch_stats'])[0]
                if train else None)
        return [f[:x.shape[0]] for f in flat(feat)], hm, outs

    return jm, _compile_fast(fn, variables, jnp.asarray(x))


def crops(hw, seed, n=1):
    return np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def forwards():
    """{case: (port model, crops, JAX variables, JAX features, JAX
    flip-tested heatmaps, JAX training-mode maps of a TRAIN_MODE case)},
    and the bf16 case's JAX heatmaps beside the port's bf16 twin."""
    out = {}
    for i, name in enumerate(CASES):
        mdict = model_dict(name)
        v = jax_variables(mdict, seed=i)
        x = crops(CASES[name][1], seed=10 + i)
        jm, (feat, hm, train) = jax_forward(mdict, v, x,
                                            train=name in TRAIN_MODE)
        out[name] = (port_model(mdict, v), x, v,
                     [np.asarray(f) for f in feat],
                     jax_flip_test(jm.cfg, hm, len(x)),
                     train and [np.asarray(t) for t in flat(train)])
    mdict = model_dict(BF16_CASE, 'bfloat16')
    v, x = out[BF16_CASE][2], out[BF16_CASE][1]
    jm, (_, hm, _) = jax_forward(mdict, v, x, train=False)
    out[BF16_CASE, 'bf16'] = (port_model(mdict, v), x, v, None,
                              jax_flip_test(jm.cfg, hm, len(x)), None)
    return out


@pytest.mark.parametrize('name', list(CASES))
def test_features_and_flip_test_match_jax(forwards, name):
    model, x, _, feat, ref, _ = forwards[name]
    assert isinstance(model, GenericMultiStageTopDown if name in MULTI_STAGE
                      else GenericTopDown)
    with torch.no_grad():
        got = flat(model.backbone(torch.from_numpy(x)))
    assert len(got) == len(feat)
    for g, f in zip(got, feat):
        assert g.dtype == torch.float32
        # JAX's CPM gives its per-stage maps in NCHW, the others NHWC
        g = g if name == 'cpm' else g.permute(0, 2, 3, 1)
        np.testing.assert_allclose(g.numpy(), f, **TOL)
    hm = infer(model, torch.from_numpy(x), flip_index=torch.from_numpy(FLIP))
    assert hm.dtype == torch.float32 and hm.shape == ref.shape
    np.testing.assert_allclose(hm.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize('name', TRAIN_MODE)
def test_every_stage_output_in_training_mode_matches_jax(forwards, name):
    """In training mode the model returns every (stage, unit) map in f32,
    BN on the batch's statistics (the crops and their mirror); in eval mode
    the last one alone."""
    model, x, _, _, _, ref = forwards[name]
    x2 = torch.from_numpy(np.concatenate([x, x[:, :, ::-1]]))
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    try:
        with torch.no_grad():
            outs = forward(model, x2, train=True)
        assert isinstance(outs, list) and len(outs) == len(ref) > 1
        for got, want in zip(outs, ref):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, **TOL)
        with torch.no_grad():
            last = forward(model, x2)
        assert isinstance(last, torch.Tensor) and last.shape == outs[-1].shape
    finally:
        model.load_state_dict(stats)
        model.eval()


def test_mspn_decodes_with_megvii_as_jax(forwards):
    """MSPN's 'megvii' decode (Gaussian modulation, kernel 5, the +0.5
    shift) on the flip-tested heatmaps, in image pixels."""
    model, x, _, _, ref, _ = forwards['mspn']
    with torch.no_grad():
        hm = infer(model, torch.from_numpy(x),
                   flip_index=torch.from_numpy(FLIP))
    rng = np.random.RandomState(5)
    center = rng.uniform(100, 300, (len(x), 2)).astype(np.float32)
    scale = rng.uniform(0.8, 1.6, (len(x), 2)).astype(np.float32)
    kw = dict(post_process='megvii', kernel=5, use_udp=False)
    preds, maxvals = keypoints_from_heatmaps(
        hm, torch.from_numpy(center), torch.from_numpy(scale), **kw)
    # compiled: the 'megvii' decode's blur takes 2 s op by op
    jp, jv = _compile_fast(functools.partial(jax_decode, **kw),
                           *map(jnp.asarray, (ref, center, scale)))
    np.testing.assert_allclose(preds.numpy(), np.asarray(jp), atol=1e-3)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize('name', ['cpm', 'litehrnet'])
def test_decoded_keypoints_match_jax(forwards, name):
    model, x, _, _, ref, _ = forwards[name]
    with torch.no_grad():
        hm = infer(model, torch.from_numpy(x),
                   flip_index=torch.from_numpy(FLIP))
    rng = np.random.RandomState(6)
    center = rng.uniform(100, 300, (len(x), 2)).astype(np.float32)
    scale = rng.uniform(0.8, 1.6, (len(x), 2)).astype(np.float32)
    kw = dict(post_process='default', use_udp=False)
    preds, _ = keypoints_from_heatmaps(
        hm, torch.from_numpy(center), torch.from_numpy(scale), **kw)
    jp, _ = jax_decode(jnp.asarray(ref), jnp.asarray(center),
                       jnp.asarray(scale), **kw)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jp), atol=1e-3)


def test_bf16_as_close_to_f32_as_flax(forwards):
    """The bf16 backbone and head, as the zoo's MSPN configs set them (the
    units' maps resized in f32): port and flax each against the f32
    answer."""
    exact = forwards[BF16_CASE][4]
    model, x, _, _, ref, _ = forwards[BF16_CASE, 'bf16']
    with torch.no_grad():
        got = infer(model, torch.from_numpy(x),
                    flip_index=torch.from_numpy(FLIP)).numpy()

    def rms(a):
        return float(np.sqrt(np.mean((a - exact) ** 2)))

    assert rms(ref) > 0 and rms(got) <= BF16_FACTOR * rms(ref), \
        (rms(got), rms(ref))
    assert np.abs(got - ref).max() <= 0.05 * np.abs(exact).max()


# --- the shared helpers and Lite-HRNet's fusion ------------------------------

def test_resize_and_pool_helpers_match_jax():
    """resize_bilinear_ac (f32, also from bf16, and from one row or
    column) as JAX's matmul form; adaptive_avg_pool as JAX's, refusing a
    ratio that is not an integer; the channel shuffle in NCHW as JAX's in
    NHWC."""
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    for src, hw in ((x, (9, 4)), (x[:, :1], (3, 6)), (x, (1, 1))):
        got = pms.resize_bilinear_ac(torch.from_numpy(src).permute(
            0, 3, 1, 2), hw)
        want = jms.resize_bilinear_ac(jnp.asarray(src), hw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6)
    bf = torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16()
    assert pms.resize_bilinear_ac(bf, (4, 4)).dtype == torch.float32
    y = np.random.RandomState(1).randn(2, 8, 12, 6).astype(np.float32)
    got = pms.adaptive_avg_pool(torch.from_numpy(y).permute(0, 3, 1, 2),
                                (2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(
        jms._adaptive_avg_pool(jnp.asarray(y), (2, 3))), rtol=1e-6,
        atol=1e-6)
    with pytest.raises(ValueError, match='integer ratio'):
        pms.adaptive_avg_pool(torch.zeros(1, 1, 8, 12), (3, 3))
    got = pms.channel_shuffle(torch.from_numpy(y).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jms._channel_shuffle(
                                      jnp.asarray(y), 2)))


def test_lite_fuse_keeps_the_reference_quirks(forwards):
    """Lite-HRNet's fusion counts branch 0 twice in every sum, and the
    later branches read branch 0's fused sum before its ReLU: the first
    module's outputs equal a fusion written out with both quirks, and
    differ from one without either."""
    model = forwards['litehrnet'][0]
    module = model.backbone.stage2[0]
    rng = np.random.RandomState(3)
    xs = [torch.from_numpy(rng.randn(1, c, s, s).astype(np.float32))
          for c, s in zip((8, 16, 32, 64), (16, 8, 4, 2))]
    with torch.no_grad():
        blocks = module.layers[0](xs)
        got = module(xs)

        def contribution(i, j, y):
            layer = module.fuse_layers[i][j]
            if j > i:
                y = norm(layer[1], conv2d(layer[0], y, torch.float32),
                         torch.float32)
                return pms.resize_nearest(y, blocks[i].shape[2:])
            if j < i:
                for seq in layer:
                    y = pms._run_dw_pw(seq, y, torch.float32)
            return y

        n = len(blocks)
        acc0 = 2 * blocks[0] + sum(contribution(0, j, blocks[j])
                                   for j in range(1, n))
        inputs = [acc0] + blocks[1:]
        want = [torch.relu(acc0)]
        plain = [torch.relu(acc0 - blocks[0])]
        for i in range(1, n):
            c = [contribution(i, j, inputs[j]) for j in range(n)]
            want.append(torch.relu(c[0] + sum(c)))
            p = [contribution(i, j, blocks[j]) for j in range(n)]
            plain.append(torch.relu(sum(p)))
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(g.numpy() - p.numpy()).max() > 1e-2


# --- the optimizer and the converters ----------------------------------------

@pytest.mark.parametrize('name', list(CASES))
def test_weight_decay_and_lr_scale_sets_match_jax(forwards, name):
    """The port's AdamW decays the leaves that JAX's mask decays: conv,
    deconv, Dense (PRM's middle path) and 1x1-conv (Lite-HRNet's spatial
    weighting) kernels, not BN scales nor biases."""
    decayed, names = assert_decay_and_lr_scale_sets_match(
        model_dict(name), forwards[name][2]['params'])
    assert all(names[n].ndim in (2, 4) for n in decayed)


@pytest.mark.parametrize('name', list(CASES))
def test_state_dict_round_trips_through_jax_converters(forwards, name):
    """JAX's BACKBONE_CONVERTERS and head converters read the port's state
    dict back into the flax variables it came from, exactly, and read
    every entry of it (BN's num_batches_tracked aside)."""
    model, _, v, _, _, _ = forwards[name]
    sd = _Reads({k: t.numpy() for k, t in model.state_dict().items()})
    _equal_trees(as_variables(*converters(model_dict(name), sd)), v)
    assert sd.read == {k for k in sd if not k.endswith('num_batches_tracked')}


def test_msmu_head_with_prm_matches_jax():
    """RSN's Pose Refine Machine (use_prm; no zoo config sets it): the
    units' maps through PRM's channel and spatial attention, in eval and
    in training mode (BN1d over the batch), as JAX's."""
    mdict = dict(model_dict('rsn'), use_prm=True)
    bb_over = dict(mdict['backbone_overrides'], num_units=1,
                   num_blocks=(1,))
    mdict.update(backbone_overrides=bb_over, num_units=1)
    with torch.device('meta'):
        shapes = build_model_from_cfg(mdict).state_dict()
    sd = {k: np.zeros(t.shape, np.float32) for k, t in shapes.items()}
    head = convert_msmu_head(sd, prefix='keypoint_head.', num_units=1,
                             use_prm=True)
    assert 'prm1_conv' in head[0]['s0_u0_prm']
    v = jax_variables(mdict, seed=30)
    model = port_model(mdict, v)
    x = crops((64, 48), seed=31)
    _, (_, hm, train) = jax_forward(mdict, v, x)
    x2 = torch.from_numpy(np.concatenate([x, x[:, :, ::-1]]))
    with torch.no_grad():
        np.testing.assert_allclose(model(x2).numpy(), np.asarray(hm), **TOL)
        (out,) = forward(model, x2, train=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(train[0]), **TOL)

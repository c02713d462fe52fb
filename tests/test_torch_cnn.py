"""The port's CNN top-down models (ResNet, ResNetV1d, HRNet, HRNetV2 through
GenericTopDown) against the JAX package on the CPU: the backbone features,
the flip-tested heatmaps and their decode, one bf16 case, one and two train
steps, the checkpoint converters, the weight-decay and lr-scale sets, and
every CNN top-down config of the zoo through the port's refusal checks.

Weights: each port model is built from a seeded generator, its BN affine
parameters and running statistics are redrawn from a seeded numpy generator
(so that BN is no identity), and its `state_dict()` goes as numpy through
JAX's own `convert_generic_topdown_checkpoint`, the path a released .pth
takes there. Inputs are seeded numpy. Sizes: 64x48 crops and one odd size,
65x49, where ResNetV1d's ceil-mode average pool has a ragged edge and
HRNet's nearest resizes have non-integer ratios (JAX samples at half-pixel
centres, torch's 'nearest-exact'). Each JAX reference is one program per
case, compiled at XLA CPU optimisation level 0, once per module.

Tolerances: f32 features and heatmaps 1e-4 absolute plus 1e-4 relative, as
tests/test_torch_models.py (measured: at most 5e-6 apart); the train steps
as tests/test_torch_train.py's trajectory (metrics 1e-4 relative; BN
running statistics 1e-4 relative plus 1e-5 absolute; Adam's first moment
after step 1, 0.1 times the clipped gradient, 1e-4 relative plus 1e-4 of the
tensor's largest value), the parameters as tests/test_torch_loop.py holds
the runner's (see PARAM_TOL). bf16: the port and flax round to
bf16 at different points, so each is held to the f32 answer, as the ViT's
bf16 test does: the port's RMS error may be at most BF16_FACTOR times
flax's own (measured 1.08 on the HRNet case below), and the two lie within
5% of the largest f32 value of each other (measured 1.4%).
"""
import functools
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.ops.decode import keypoints_from_heatmaps as jax_decode
from vitpose_tpu.ops.geometry import flip_back as jax_flip_back
from vitpose_tpu.train import optim as joptim
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.train.state import TrainState as JaxTrainState
from vitpose_tpu.train.step import make_train_step as jax_make_train_step
from vitpose_tpu.utils.cnn_ckpt import (BACKBONE_CONVERTERS, HEAD_CONVERTERS,
                                        convert_generic_topdown_checkpoint)
from vitpose_tpu.utils.torch_ckpt import convert_head

from test_torch_data import ROOT
from test_torch_models import _compile_fast
from vitpose_tpu_torch.data import DatasetInfo, topdown_dataset_cls
from vitpose_tpu_torch.data.pipeline import AugmentConfig, make_preprocess_fn
from vitpose_tpu_torch.models.topdown import (GenericMultiStageTopDown,
                                              GenericTopDown, infer)
from vitpose_tpu_torch.ops import target as ttarget
from vitpose_tpu_torch.ops.decode import keypoints_from_heatmaps
from vitpose_tpu_torch.train import (OptimConfig, create_train_state,
                                     layer_decay_adamw, make_train_step)
from vitpose_tpu_torch.train.loop import (MULTI_STAGE_HEADS, _model_parts,
                                          _refuse_unported, build_backbone,
                                          build_model_from_cfg)
from vitpose_tpu_torch.utils.config import load_config
from vitpose_tpu_torch.utils.convert import cnn_state_dict_from_flax

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_FACTOR = 1.5
FLIP = np.asarray(DatasetInfo.load('coco').flip_index)
HR_SMALL = dict(width=8, stage_modules=(1, 1, 1), stage_blocks=1)

# name -> (model dict, (h, w) of the crops)
CASES = {
    'resnet18': (dict(backbone_type='resnet', backbone_overrides=dict(
        depth=18), deconv_filters=(16, 16), deconv_kernels=(4, 4)), (64, 48)),
    'resnet50': (dict(backbone_type='resnet', backbone_overrides=dict(
        depth=50), deconv_filters=(16, 16, 16), deconv_kernels=(4, 4, 4),
        shift_heatmap=True), (64, 48)),
    'resnet_v1d50_odd': (dict(backbone_type='resnet_v1d', backbone_overrides=
                              dict(depth=50), deconv_filters=(16, 16),
                              deconv_kernels=(4, 4)), (65, 49)),
    'hrnet_odd': (dict(backbone_type='hrnet', backbone_overrides=HR_SMALL,
                       deconv_filters=(), shift_heatmap=True), (65, 49)),
    'hrnetv2_extra_conv': (dict(backbone_type='hrnetv2',
                                backbone_overrides=HR_SMALL,
                                deconv_filters=(), head_extra_convs=(1,)),
                           (64, 48)),
}


# the train steps' HRNetV2: two exchange stages, three branches. With four
# (the lowest at 2x2 for these crops: 8 values per BN channel in a batch of
# 2) JAX's f32 gradients lie up to 1.1e-2 of a tensor's largest value from
# the port's, while the port's lie within 5e-5 of an f64 run of the port and
# f64 runs of both packages agree within 2.1e-6: JAX's f32 rounding there,
# not a difference of the models. With three they agree within 2.8e-5.
TRAIN_HRNET = (dict(CASES['hrnetv2_extra_conv'][0], backbone_overrides=dict(
    HR_SMALL, stage_modules=(1, 1))), (64, 48))


def model_dict(name, **extra):
    mdict, hw = TRAIN_HRNET if name == 'hrnetv2_train' else CASES[name]
    return dict(mdict, img_size=hw, out_channels=17, **extra)


def randomize_bn(model, seed):
    """Every BN's scale, bias and running statistics redrawn from a seeded
    numpy generator."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(
                    1.0 + 0.1 * rng.randn(n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(
                    0.1 * rng.randn(n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(
                    0.1 * rng.randn(n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, n).astype(np.float32)))
    return model


def port_model(mdict, seed=0):
    model = build_model_from_cfg(mdict, torch.Generator().manual_seed(seed))
    return randomize_bn(model, seed + 100).eval()


def jax_variables(model, backbone_type):
    """The port model's weights as JAX's converter reads a .pth."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return jax.tree.map(jnp.asarray, convert_generic_topdown_checkpoint(
        sd, backbone_type))


def crops(hw, seed, n=2):
    return np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)


def jax_forward(mdict, variables, x):
    """(backbone features NHWC, heatmaps) of JAX's GenericTopDown on x and
    its mirror, one program."""
    jm = jax_build(mdict)

    def fn(v, x):
        x2 = jnp.concatenate([x, x[:, :, ::-1]])
        hm, state = jm.apply(v, x2, capture_intermediates=(
            lambda mdl, _: mdl.name == 'backbone'))
        (feat,) = state['intermediates']['backbone']['__call__']
        return feat[:x.shape[0]], hm

    return jm, _compile_fast(fn, variables, jnp.asarray(x))


def jax_flip_test(cfg, hm, n):
    """JAX `infer`'s average of the two passes (vitpose_tpu/models/
    topdown.py:245-273) from their heatmaps."""
    hm_f = jax_flip_back(hm[n:], jnp.asarray(FLIP),
                         target_type=cfg.target_type)
    if cfg.shift_heatmap:
        hm_f = hm_f.at[..., 1:].set(hm_f[..., :-1])
    return np.asarray((hm[:n] + hm_f) * 0.5)


@pytest.fixture(scope='module')
def forwards():
    """{case: (port model, crops, JAX features, JAX flip-tested heatmaps)}
    for every f32 case, and the bf16 HRNet beside its f32 twin."""
    out = {}
    for i, name in enumerate(CASES):
        mdict = model_dict(name)
        model = port_model(mdict, seed=i)
        x = crops(CASES[name][1], seed=10 + i)
        jm, (feat, hm) = jax_forward(
            mdict, jax_variables(model, mdict['backbone_type']), x)
        out[name] = (model, x, np.asarray(feat),
                     jax_flip_test(jm.cfg, hm, len(x)))
    bf16 = dict(HR_SMALL, dtype='bfloat16')
    mdict = model_dict('hrnet_odd', backbone_overrides=bf16,
                       dtype='bfloat16')
    model = port_model(mdict, seed=7)
    x = crops(CASES['hrnet_odd'][1], seed=17)
    jm, (_, hm) = jax_forward(mdict, jax_variables(model, 'hrnet'), x)
    out['hrnet_bf16'] = (model, x, None, jax_flip_test(jm.cfg, hm, len(x)))
    return out


@pytest.mark.parametrize('name', list(CASES))
def test_features_and_flip_test_match_jax(forwards, name):
    model, x, feat, ref = forwards[name]
    assert isinstance(model, GenericTopDown)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x))
    assert got.shape[1] == model.backbone.out_channels
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), feat, **TOL)
    hm = infer(model, torch.from_numpy(x), flip_index=torch.from_numpy(FLIP))
    assert hm.dtype == torch.float32 and hm.shape == ref.shape
    np.testing.assert_allclose(hm.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize('name', ['hrnet_odd', 'resnet50'])
def test_decoded_keypoints_match_jax(forwards, name):
    """The zoo's CNN decode ('default': argmax and the quarter-pixel shift,
    no UDP) on the flip-tested heatmaps, in image pixels."""
    model, x, _, ref = forwards[name]
    with torch.no_grad():
        hm = infer(model, torch.from_numpy(x),
                   flip_index=torch.from_numpy(FLIP))
    rng = np.random.RandomState(5)
    center = rng.uniform(100, 300, (len(x), 2)).astype(np.float32)
    scale = rng.uniform(0.8, 1.6, (len(x), 2)).astype(np.float32)
    kw = dict(post_process='default', use_udp=False)
    preds, maxvals = keypoints_from_heatmaps(
        hm, torch.from_numpy(center), torch.from_numpy(scale), **kw)
    jp, jv = jax_decode(jnp.asarray(ref), jnp.asarray(center),
                        jnp.asarray(scale), **kw)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jp), atol=1e-3)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(jv), **TOL)


def test_bf16_hrnet_as_close_to_f32_as_flax(forwards):
    """HRNet with bf16 backbone and head (as 79 of the zoo's 84 HRNet
    configs): port and flax each against the f32 answer of the same
    weights."""
    model, x, _, ref = forwards['hrnet_bf16']
    f32 = model_dict('hrnet_odd')
    twin = build_model_from_cfg(f32).eval()
    twin.load_state_dict(model.state_dict())
    xt, fi = torch.from_numpy(x), torch.from_numpy(FLIP)
    with torch.no_grad():
        exact = infer(twin, xt, flip_index=fi).numpy()
        got = infer(model, xt, flip_index=fi).numpy()

    def rms(a):
        return float(np.sqrt(np.mean((a - exact) ** 2)))

    assert rms(ref) > 0 and rms(got) <= BF16_FACTOR * rms(ref), \
        (rms(got), rms(ref))
    assert np.abs(got - ref).max() <= 0.05 * np.abs(exact).max()


# --- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize('name', list(CASES))
def test_state_dict_round_trips_through_jax_converter(forwards, name):
    """cnn_state_dict_from_flax inverts JAX's converter exactly, and its
    output loads with strict=True."""
    model = forwards[name][0]
    sd = model.state_dict()
    variables = convert_generic_topdown_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, CASES[name][0]['backbone_type'])
    back = cnn_state_dict_from_flax(variables,
                                    CASES[name][0]['backbone_type'])
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    model.load_state_dict(back, strict=True)


def test_resnet_v1d_shortcut_names():
    """A strided avg_down shortcut is [AvgPool, conv, bn]; layer1.0's stays
    [conv, bn] (JAX's converter tells them apart by ndim)."""
    with torch.device('meta'):
        model = build_model_from_cfg(model_dict('resnet_v1d50_odd'))
    keys = set(model.state_dict())
    assert 'backbone.layer1.0.downsample.0.weight' in keys
    assert 'backbone.layer1.0.downsample.1.running_var' in keys
    assert 'backbone.layer2.0.downsample.1.weight' in keys
    assert 'backbone.layer2.0.downsample.2.running_var' in keys
    assert 'backbone.stem.2.bn.weight' in keys
    assert not any(k.startswith('backbone.conv1') for k in keys)


# --- training ----------------------------------------------------------------

# parameters elementwise as tests/test_torch_loop.py holds the runner's,
# 1e-4 relative plus 5e-5 absolute, except that an element whose gradient
# is f32 noise (1e-10 against 5e-5 in its tensor) takes its Adam step,
# lr * m / (sqrt(v) + 1e-8), by that noise: up to FLIPPED_SHARE of the
# model's elements may lie outside (measured: 4 of 430,721 after the
# second step; none of a ResNet-18's after two), each within the steps' lr
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
FLIPPED_SHARE = 5e-5
TRAIN_OPTIM = dict(base_lr=1e-3, num_layers=12, warmup_iters=2,
                   warmup_ratio=0.1, decay_epochs=(2,), total_epochs=4,
                   grad_clip_norm=0.05)
TRAIN_CASES = ('hrnetv2_train',)


def train_batch(name, hm_hw, seed):
    h, w = model_dict(name)['img_size']
    rng = np.random.RandomState(seed)
    imgs = rng.randn(2, h, w, 3).astype(np.float32)
    joints = rng.uniform(0, w, (2, 17, 2)).astype(np.float32)
    vis = (rng.rand(2, 17) > 0.2).astype(np.float32)
    target, weight = ttarget.generate_msra_heatmaps(
        torch.from_numpy(joints), torch.from_numpy(vis), (w, h),
        hm_hw[::-1], sigma=2.0)
    return {'imgs': imgs, 'target': target.numpy(),
            'target_weight': weight.numpy()}


def _adam_mu(opt_state):
    """The first moment of optax's scale_by_adam in a chain's state."""
    return next(s.mu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: hasattr(s, 'mu')) if hasattr(s, 'mu'))


def jax_train_steps(mdict, variables, batch, optim=TRAIN_OPTIM, f64=False):
    """[(metrics, variables, Adam's first moment) after step 1 and 2] of
    JAX's train step on `batch` from `variables` with the `optim` options,
    compiled at XLA level 0; with `f64` the model, its variables and the
    batch in float64 (64-bit JAX for this call only) and compiled at XLA
    level 1 (level 0 runs f64 convs in XLA's slow loops; level 1 does not,
    and compiles faster than the default), returned as float32."""
    if not f64:
        return _jax_train_steps(mdict, variables, batch, optim, 0)
    mdict = dict(mdict, dtype='float64', backbone_overrides=dict(
        mdict.get('backbone_overrides', {}), dtype='float64'))
    with jax.enable_x64(True):
        steps = _jax_train_steps(
            mdict, jax.tree.map(lambda a: np.asarray(a, np.float64),
                                variables),
            {k: np.asarray(a, np.float64) for k, a in batch.items()}, optim,
            1)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), steps)


def _jax_train_steps(mdict, variables, batch, optim, opt_level):
    jm = jax_build(mdict)
    tx = joptim.layer_decay_adamw(variables['params'],
                                  joptim.OptimConfig(**optim), 1)
    # JAX's create_train_state with the optimizer's init compiled (it takes
    # 2 s op by op)
    state = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables['params'],
                          batch_stats=variables.get('batch_stats', {}),
                          opt_state=jax.jit(tx.init)(variables['params']),
                          tx=tx)
    step = jax.jit(jax_make_train_step(jm)).lower(
        state, batch, jax.random.PRNGKey(1)).compile(
            compiler_options={'xla_backend_optimization_level': opt_level})
    steps = []
    for _ in range(2):
        state, metrics = step(state, batch, jax.random.PRNGKey(1))
        steps.append((
            jax.tree.map(np.asarray, metrics),
            {'params': jax.tree.map(np.asarray, state.params),
             'batch_stats': jax.tree.map(np.asarray, state.batch_stats)},
            jax.tree.map(np.asarray, _adam_mu(state.opt_state))))
    return steps


@pytest.fixture(scope='module')
def jax_steps():
    """{case: (weights, batch, [(metrics, variables, mu) after step 1 and
    2])} of JAX's train step."""
    out = {}
    for i, name in enumerate(TRAIN_CASES):
        mdict = model_dict(name)
        model = port_model(mdict, seed=20 + i)
        v = jax_variables(model, mdict['backbone_type'])
        with torch.no_grad():
            hm_hw = model(torch.zeros(1, *mdict['img_size'], 3)).shape[2:]
        batch = train_batch(name, tuple(hm_hw), seed=30 + i)
        out[name] = (model.state_dict(), batch,
                     jax_train_steps(mdict, v, batch))
    return out


@pytest.mark.parametrize('name', TRAIN_CASES)
def test_train_steps_match_jax(jax_steps, name):
    """Two MSRA-target joints-MSE steps (BN in training mode with flax's
    statistics, the global-norm clip, AdamW): metrics, the gradients as
    Adam's first moment after step 1, and every parameter and BN statistic
    after each step."""
    weights, batch, ref = jax_steps[name]
    mdict = model_dict(name)
    model = build_model_from_cfg(mdict)
    model.load_state_dict(weights)
    # conv biases before a training-mode BN: gradient 0, so their values are
    # f32 noise on both sides (1e-8 against 0.29 in the model: hence the
    # gradient floor of 1e-6 of the model's largest value)
    noise_only = {f'keypoint_head.final_layer.{3 * j}.bias'
                  for j in range(len(mdict.get('head_extra_convs', ())))}
    assert_train_steps_match(model, batch, ref, mdict['backbone_type'],
                             noise_only)


def assert_train_steps_match(model, batch, ref, bt, noise_only=(),
                             optim=TRAIN_OPTIM):
    """The port's two steps of `model` on `batch` with the `optim` options
    against JAX's `ref` (jax_train_steps) of a `bt` backbone: metrics, the
    gradients as Adam's first moment after step 1, and every parameter and
    BN statistic after each step; the `noise_only` parameters within the
    steps' lr."""
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = OptimConfig(**optim)
    state = create_train_state(model, layer_decay_adamw(model, cfg, 1),
                               cfg.grad_clip_norm)
    step = make_train_step(model)
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    max_step = 0.0
    for i, (metrics_ref, vars_ref, mu) in enumerate(ref):
        max_step += state.optimizer.param_groups[0]['lr']
        metrics = step(state, tbatch, torch.Generator())
        for key in ('heatmap_loss', 'grad_norm', 'acc_pose'):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(metrics_ref[key]), rtol=1e-4,
                                       err_msg=f'step {i} {key}')
        assert float(metrics['grad_norm']) > cfg.grad_clip_norm  # clipped
        if i == 0:
            moments = cnn_state_dict_from_flax({'params': mu}, bt)
            top = max(np.abs(m.numpy()).max() for m in moments.values())
            for pname, p in model.named_parameters():
                got = state.optimizer.state[p]['exp_avg'].numpy()
                want = moments[pname].numpy()
                np.testing.assert_allclose(
                    got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max()
                    + 1e-6 * top,
                    err_msg=f'grad {pname}')
        expected = cnn_state_dict_from_flax(vars_ref, bt)
        params = dict(model.named_parameters())
        flipped = {}
        for pname, value in model.state_dict().items():
            if 'num_batches' in pname:
                continue
            got, want = value.numpy(), expected[pname].numpy()
            if pname not in params:                  # BN running statistics
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=f'step {i} {pname}')
                continue
            if pname in noise_only:
                assert np.abs(got - want).max() <= 2 * max_step, pname
                continue
            off = np.abs(got - want) > PARAM_TOL['atol'] \
                + PARAM_TOL['rtol'] * np.abs(want)
            flipped[pname] = int(off.sum())
            assert np.abs(got - want).max() <= 2 * max_step, pname
        size = sum(p.numel() for p in params.values())
        assert sum(flipped.values()) <= FLIPPED_SHARE * size, \
            (f'step {i}: of {size}',
             {k: v for k, v in flipped.items() if v})
    assert any('running_var' in k and not torch.equal(v, weights[k])
               for k, v in model.state_dict().items())


@pytest.mark.parametrize('name', ['hrnetv2_extra_conv', 'resnet_v1d50_odd'])
def test_weight_decay_and_lr_scale_sets_match_jax(name):
    """JAX decays every leaf with ndim > 1 but 'bias' (conv and deconv
    kernels; not BN scale or bias, nor conv biases) and scales every CNN
    lr by 1 (no 'blocks_'); the port's AdamW groups hold the same sets."""
    mdict = model_dict(name)
    with torch.device('meta'):
        model = build_model_from_cfg(mdict)
    zeros = {k: np.zeros(v.shape, np.float32)
             for k, v in model.state_dict().items()}
    params = convert_generic_topdown_checkpoint(
        zeros, mdict['backbone_type'])['params']
    decayed, names = assert_decay_and_lr_scale_sets_match(mdict, params)
    assert all(n.endswith('.weight') and names[n].ndim == 4
               for n in decayed)


def assert_decay_and_lr_scale_sets_match(mdict, params):
    """The port's AdamW groups of `mdict`'s model decay exactly the leaves
    that JAX's `_wd_mask_tree` of the flax `params` decays, and scale every
    lr by JAX's `_lr_scale_tree` (1 for a CNN); returns (the decayed names,
    {name: parameter})."""
    cfg = OptimConfig(layer_decay_rate=0.75)
    wd = joptim._wd_mask_tree(params)
    scale = joptim._lr_scale_tree(params, cfg.num_layers, 0.75)
    full = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), wd,
                        params)
    scales = jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32),
                          scale, params)
    want_wd = cnn_state_dict_from_flax({'params': full},
                                       mdict['backbone_type'])
    want_scale = cnn_state_dict_from_flax({'params': scales},
                                          mdict['backbone_type'])
    with torch.device('meta'):
        model = build_model_from_cfg(mdict)
    opt, _ = layer_decay_adamw(model, cfg, 1)
    group_of = {id(p): g for g in opt.param_groups for p in g['params']}
    names = dict(model.named_parameters())
    assert set(names) == set(want_wd)
    decayed = {n for n, p in names.items()
               if group_of[id(p)]['weight_decay'] > 0}
    assert decayed == {n for n, v in want_wd.items() if v.flatten()[0] == 1}
    assert decayed
    for n, p in names.items():
        assert group_of[id(p)]['lr_scale'] == pytest.approx(
            float(want_scale[n].flatten()[0])) == 1.0
    return decayed, names


# --- the zoo's CNN top-down configs --------------------------------------------

CNN_BACKBONES = ('resnet', 'resnet_v1d', 'hrnet', 'hrnetv2', 'resnext',
                 'seresnet', 'seresnext', 'scnet', 'resnest', 'vgg',
                 'alexnet', 'shufflenet_v1', 'vipnas_resnet', 'vipnas_mbv3',
                 'mobilenet_v2', 'shufflenet_v2', 'litehrnet', 'cpm',
                 'hourglass', 'mspn', 'rsn', 'hrformer')


def _zoo_cnn_configs():
    out = []
    for p in sorted(glob.glob(os.path.join(ROOT, 'vitpose_tpu', 'configs',
                                           '*', '*.py'))):
        model = load_config(p).get('model', {})
        if model.get('family', 'topdown') == 'topdown' \
                and model.get('backbone_type') in CNN_BACKBONES:
            out.append(os.path.relpath(p, ROOT))
    return out


CNN_CONFIGS = _zoo_cnn_configs()
# the configs that wait for later items, with the ROADMAP item each cites:
# none since items 7, 12c and 12d's datasets
REFUSED = {}
RUNNABLE = [p for p in CNN_CONFIGS if p not in REFUSED]
# the 30 configs that items 7, 12c and 12d's datasets made runnable
SLICE_13 = [
    *(f'vitpose_tpu/configs/coco/hrformer_{size}_coco_{hw}.py'
      for size in ('small', 'base') for hw in ('256x192', '384x288')),
    *(f'vitpose_tpu/configs/coco/hrnet_w32_coco_256x192_{aug}.py'
      for aug in ('coarsedropout', 'gridmask', 'photometric')),
    'vitpose_tpu/configs/coco/hrnet_w32_coco_256x192_udp_regress.py',
    'vitpose_tpu/configs/coco/res50_coco_256x192_awing.py',
    'vitpose_tpu/configs/face/hrnetv2_w18_wflw_256x256_awing.py',
    'vitpose_tpu/configs/coco/deeppose_res50_coco_256x192.py',
    'vitpose_tpu/configs/mpii/deeppose_res50_mpii_256x256.py',
    *(f'vitpose_tpu/configs/face/deeppose_res50_wflw_256x256{loss}.py'
      for loss in ('', '_softwingloss', '_wingloss')),
    *(f'vitpose_tpu/configs/jhmdb/res50{deconv}_jhmdb_sub{i}_256x256.py'
      for deconv in ('', '_2deconv') for i in (1, 2, 3)),
    *(f'vitpose_tpu/configs/jhmdb/cpm_jhmdb_sub{i}_368x368.py'
      for i in (1, 2, 3)),
    *(f'vitpose_tpu/configs/posetrack/{name}.py' for name in (
        'hrnet_w32_posetrack18_256x192', 'hrnet_w32_posetrack18_384x288',
        'hrnet_w48_posetrack18_256x192', 'hrnet_w48_posetrack18_384x288',
        'hrnet_w48_posetrack18_384x288_posewarper_stage1',
        'res50_posetrack18_256x192'))]


def refusal_checks(cfg):
    """What the runner and the evaluation CLI check before they read data:
    the family and runtime refusals, the model (built at full width on the
    meta device: shapes without values; backbones shared between configs
    of one architecture), each train set's metadata and class, the
    augmentation, the target type and the loss. Returns the model."""
    _refuse_unported(cfg)
    backbone_type, overrides, mcfg = _model_parts(cfg['model'])
    backbone = _meta_backbone(backbone_type,
                              tuple(sorted(overrides.items())))
    cls = (GenericMultiStageTopDown if mcfg.head_type in MULTI_STAGE_HEADS
           else GenericTopDown)
    with torch.device('meta'):
        model = cls(backbone, mcfg, backbone_type)
    dcfg = cfg['data']
    name = dcfg.get('dataset', 'coco')
    assert DatasetInfo.load(name).num_joints > 0
    topdown_dataset_cls(name)
    AugmentConfig(**dcfg.get('aug', {}))
    make_preprocess_fn(target_type=mcfg.target_type)
    make_train_step(model, target_type=mcfg.target_type,
                    reg_loss=mcfg.reg_loss, heatmap_loss=mcfg.heatmap_loss)
    return model


@functools.lru_cache(maxsize=None)
def _meta_backbone(backbone_type, overrides):
    with torch.device('meta'):
        return build_backbone(backbone_type, **dict(overrides))


class _Reads(dict):
    """A state dict that records the keys a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k in self:
            self.read.add(k)
        return super().get(k, default)


@functools.lru_cache(maxsize=None)
def _converter_reads(backbone_type, keys):
    """The keys JAX's converters read of a state dict with these keys
    (tiny arrays of each entry's rank stand in for the values)."""
    sd = _Reads({k: np.zeros((1,) * nd, np.float32) for k, nd in keys})
    # what convert_generic_topdown_checkpoint runs, on the recording dict
    # (it copies what it is given)
    BACKBONE_CONVERTERS[backbone_type](sd, prefix='backbone.')
    HEAD_CONVERTERS.get(backbone_type, convert_head)(
        sd, prefix='keypoint_head.')
    return frozenset(sd.read)


@pytest.mark.parametrize('path', RUNNABLE)
def test_cnn_config_passes_the_ports_refusals_and_builds(path):
    """Each runnable config passes the refusal checks and builds its
    GenericTopDown (or GenericMultiStageTopDown) at full width (on the
    meta device: shapes without values), whose state-dict keys are exactly those JAX's converters read
    where JAX has one for the backbone (BN's num_batches_tracked aside:
    mmpose .pth files carry it and JAX does not read it; the flax-named
    backbones are held leaf for leaf in tests/test_torch_cnn_more.py)."""
    model = refusal_checks(load_config(os.path.join(ROOT, path)))
    mcfg, backbone_type = model.cfg, model.backbone_type
    assert model.keypoint_head.dtype == {
        'float32': torch.float32, 'bfloat16': torch.bfloat16}[
            mcfg.backbone.dtype]
    sd = model.state_dict()
    keys = frozenset((k, v.ndim) for k, v in sd.items()
                     if not k.endswith('num_batches_tracked'))
    if backbone_type in BACKBONE_CONVERTERS:
        assert _converter_reads(backbone_type, keys) == {k for k, _ in keys}
    # DeepPose's fc gives (x, y) per joint
    per_joint = 2 if mcfg.head_type == 'regression' else 1
    assert prediction_weight(sd).shape[0] == per_joint * mcfg.out_channels


def prediction_weight(sd):
    """The weight of the conv that gives the (last) heatmaps: the classic
    head's final_layer (the last of its Sequential), the multi-stage head's
    last stage's, the MSMU head's last unit's 3x3, or CPM's last stage's
    prediction conv in the backbone (its identity head has none)."""
    def last(prefix, suffix):
        keys = [k for k in sd if k.startswith(prefix) and k.endswith(suffix)
                and k[len(prefix):-len(suffix)].isdigit()]
        return sd[max(keys, key=lambda k: int(k[len(prefix):-len(suffix)]))] \
            if keys else None

    for name in ('keypoint_head.final_layer.weight',
                 'keypoint_head.fc.weight'):
        if name in sd:
            return sd[name]
    for prefix, suffix in (('keypoint_head.final_layer.', '.weight'),
                           ('keypoint_head.multi_final_layers.', '.weight'),
                           ('keypoint_head.predict_layers.',
                            '.conv_layers.1.conv.weight'),
                           ('backbone.out_convs.', '.1.conv.weight')):
        w = last(prefix, suffix)
        if w is not None:
            return w
    raise KeyError('no prediction conv')


def test_the_zoo_has_250_runnable_and_23_refused_cnn_configs():
    """The counts since items 7, 12c and 12d's datasets: 315 CNN top-down
    configs (the four HRFormer ones among them), all runnable (the name
    keeps item 12a's counts). The 30 that this slice made runnable, which
    earlier raised here, each pass the refusal checks, and the head of each
    fits its target: a 3K-channel head for CombinedTarget (its config
    inherits 17 channels, the joints), the regression head for DeepPose."""
    assert len(CNN_CONFIGS) == 315 and len(RUNNABLE) == 315
    assert not REFUSED and len(SLICE_13) == len(set(SLICE_13)) == 30
    assert set(SLICE_13) <= set(RUNNABLE)
    for path in SLICE_13:
        model = refusal_checks(load_config(os.path.join(ROOT, path)))
        cfg = model.cfg
        if cfg.target_type.lower() == 'combinedtarget':
            assert cfg.out_channels == 51
        assert (cfg.head_type == 'regression') == ('deeppose' in path)

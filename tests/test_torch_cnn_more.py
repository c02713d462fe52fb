"""The port's single-stage CNN backbones of ROADMAP item 12a (ResNeXt,
SE-ResNet, SE-ResNeXt, SCNet, ResNeSt, VGG, AlexNet, ShuffleNetV1,
ViPNAS-ResNet and ViPNAS-MobileNetV3 with the ViPNAS head, RegNet and
MobileNetV3), each in a GenericTopDown, against the JAX package on the CPU:
features, the flip-tested heatmaps and their decode, bf16, and the weight
converters.

Weights: JAX's variables of each case are drawn from a seeded numpy
generator (as `test_torch_models._fill` draws them: fan-in scaled kernels,
BN scales near 1, non-trivial running statistics) and carried into the port
through `cnn_state_dict_from_flax`, loaded with strict=True. Their tree is
flax's init for the six that JAX has no converter for, and JAX's
converters' reading of the port's shapes for the other six. Sizes: the smallest
depths the JAX classes take (depth 18's stage counts for the ResNet
layouts, whose blocks stay bottlenecks there; VGG 11; RegNet one block per
stage; ViPNAS one block per stage), 64x48 crops but for AlexNet, whose
unpadded pools need 63 pixels a side (80x64: 1x1 features), and heads of
two deconvs 16 wide (ViPNAS: 4 groups). At 64x48 SCNet's self-calibrated
convs see 8x6 and 4x3 maps, whose sides are not multiples of the clamped
pool size. Each JAX reference is one program (the crops and their mirror)
compiled at XLA CPU optimisation level 0, once per module.

Tolerances as tests/test_torch_cnn.py: f32 features and heatmaps 1e-4
absolute plus 1e-4 relative, decoded keypoints 1e-3 px; bf16 against the
f32 answer of the same weights, the port's RMS error at most BF16_FACTOR
times flax's own and the two within 5% of the largest f32 value; the
converters exact.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vitpose_tpu.ops.decode import keypoints_from_heatmaps as jax_decode
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.utils.cnn_ckpt import BACKBONE_CONVERTERS, HEAD_CONVERTERS
from vitpose_tpu.utils.torch_ckpt import convert_head

from test_torch_cnn import (BF16_FACTOR, FLIP, TOL,
                            assert_decay_and_lr_scale_sets_match, crops,
                            jax_flip_test, jax_forward)
from vitpose_tpu_torch.models.more_cnns import SCConv
from vitpose_tpu_torch.models.topdown import GenericTopDown, infer
from vitpose_tpu_torch.ops.decode import keypoints_from_heatmaps
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils.convert import (FLAX_NAMED_BACKBONES,
                                             cnn_state_dict_from_flax)
from test_torch_threads import torch_test_threads  # noqa: F401

HEAD = dict(deconv_filters=(16, 16), deconv_kernels=(4, 4))
VIPNAS_HEAD = dict(head='vipnas', deconv_filters=(16, 16),
                   deconv_groups=(4, 4))
MBV3_DEP = (0, 1, 1, 1, 1, 1, 1)
# name -> (model dict, (h, w) of the crops)
CASES = {
    'resnext': (dict(backbone_type='resnext', backbone_overrides=dict(
        depth=18), **HEAD), (64, 48)),
    'seresnet': (dict(backbone_type='seresnet', backbone_overrides=dict(
        depth=18), **HEAD), (64, 48)),
    'seresnext': (dict(backbone_type='seresnext', backbone_overrides=dict(
        depth=18), shift_heatmap=True, **HEAD), (64, 48)),
    'scnet': (dict(backbone_type='scnet', backbone_overrides=dict(depth=18),
                   **HEAD), (64, 48)),
    'resnest': (dict(backbone_type='resnest', backbone_overrides=dict(
        depth=18), **HEAD), (64, 48)),
    'vgg': (dict(backbone_type='vgg', backbone_overrides=dict(
        depth=11, with_bn=True), **HEAD), (64, 48)),
    'alexnet': (dict(backbone_type='alexnet', **HEAD), (80, 64)),
    'shufflenet_v1': (dict(backbone_type='shufflenet_v1',
                           backbone_overrides=dict(groups=3), **HEAD),
                      (64, 48)),
    'regnet': (dict(backbone_type='regnet', backbone_overrides=dict(
        stage_depths=(1, 1, 1, 1)), **HEAD), (64, 48)),
    'mobilenet_v3': (dict(backbone_type='mobilenet_v3', **HEAD), (64, 48)),
    'vipnas_resnet': (dict(backbone_type='vipnas_resnet',
                           backbone_overrides=dict(dep=(0, 1, 1, 1, 1)),
                           **VIPNAS_HEAD), (64, 48)),
    'vipnas_mbv3': (dict(backbone_type='vipnas_mbv3', backbone_overrides=dict(
        dep=MBV3_DEP), shift_heatmap=True, **VIPNAS_HEAD), (64, 48)),
}
BF16_CASES = ('vipnas_mbv3', 'resnest')


def model_dict(name, dtype=None):
    mdict, hw = CASES[name]
    mdict = dict(mdict, img_size=hw, out_channels=17)
    if dtype:
        mdict['dtype'] = dtype
        mdict['backbone_overrides'] = dict(
            mdict.get('backbone_overrides', {}), dtype=dtype)
    return mdict


def variable_shapes(mdict, jm):
    """The tree of JAX's variables of `mdict`: for the six that JAX
    converts from mmpose's names, its converters' reading of a state dict of
    the port model's shapes (numpy, no trace), else flax's init traced."""
    bt = mdict['backbone_type']
    if bt in FLAX_NAMED_BACKBONES:
        return jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, *mdict['img_size'], 3)))
    with torch.device('meta'):
        model = build_model_from_cfg(mdict)
    sd = {k: np.zeros(v.shape, np.float32)
          for k, v in model.state_dict().items()}
    kw = ({'dep': mdict['backbone_overrides']['dep']}
          if bt == 'vipnas_mbv3' else {})
    bb = BACKBONE_CONVERTERS[bt](sd, prefix='backbone.', **kw)
    head = HEAD_CONVERTERS.get(bt, convert_head)(sd, prefix='keypoint_head.')
    return {'params': {'backbone': bb[0], 'head': head[0]},
            'batch_stats': {'backbone': bb[1], 'head': head[1]}}


def jax_variables(mdict, seed):
    """(JAX GenericTopDown, its variables filled from a seeded numpy
    generator as `test_torch_models._fill` fills them, as numpy)."""
    jm = jax_build(mdict)
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

    return jm, jax.tree_util.tree_map_with_path(
        fill, variable_shapes(mdict, jm))


def port_model(mdict, variables):
    """The port's model of `mdict` with the JAX variables, loaded strictly
    into a model built on the meta device (no random draws)."""
    with torch.device('meta'):
        model = build_model_from_cfg(mdict)
    model.load_state_dict(cnn_state_dict_from_flax(
        variables, mdict['backbone_type']), strict=True, assign=True)
    return model.eval()


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """The port's side on one thread: its tensors are tiny, and on the
    xdist workers that share the CPU more threads only wait on each
    other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def forwards():
    """{case: (port model, crops, JAX variables, JAX features, JAX
    flip-tested heatmaps)} for every f32 case, and the bf16 cases' JAX
    heatmaps beside the port's bf16 and f32 twins."""
    out = {}
    for i, name in enumerate(CASES):
        mdict = model_dict(name)
        jm, v = jax_variables(mdict, seed=i)
        x = crops(CASES[name][1], seed=10 + i, n=1)
        _, (feat, hm) = jax_forward(mdict, v, x)
        out[name] = (port_model(mdict, v), x, v, np.asarray(feat),
                     jax_flip_test(jm.cfg, hm, len(x)))
    for name in BF16_CASES:
        mdict = model_dict(name, 'bfloat16')
        _, _, v, _, _ = out[name]
        x = out[name][1]
        jm, (_, hm) = jax_forward(mdict, v, x)
        out[name, 'bf16'] = (port_model(mdict, v), x, v, None,
                             jax_flip_test(jm.cfg, hm, len(x)))
    return out


@pytest.mark.parametrize('name', list(CASES))
def test_features_and_flip_test_match_jax(forwards, name):
    model, x, _, feat, ref = forwards[name]
    assert isinstance(model, GenericTopDown)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x))
    assert got.shape[1] == model.backbone.out_channels
    assert model.backbone.dtype == got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), feat, **TOL)
    hm = infer(model, torch.from_numpy(x), flip_index=torch.from_numpy(FLIP))
    assert hm.dtype == torch.float32 and hm.shape == ref.shape
    np.testing.assert_allclose(hm.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize('name', ['vipnas_resnet', 'scnet'])
def test_float64_model_matches_jax(forwards, name):
    """dtype 'float64' (as JAX's modules take it): every conv, BN and
    LayerNorm statistic and softmax in f64, the heatmaps f64 and within the
    f32 tolerance of JAX's f32 answer."""
    model, x, _, feat, ref = forwards[name]
    twin = build_model_from_cfg(model_dict(name, 'float64')).double().eval()
    twin.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = twin.backbone(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), feat, **TOL)
    hm = infer(twin, torch.from_numpy(x), flip_index=torch.from_numpy(FLIP))
    assert hm.dtype == torch.float64
    np.testing.assert_allclose(hm.detach().numpy(), ref, **TOL)


@pytest.mark.parametrize('name', ['scnet', 'vipnas_mbv3'])
def test_decoded_keypoints_match_jax(forwards, name):
    """The zoo's CNN decode ('default': argmax and the quarter-pixel shift,
    no UDP) on the flip-tested heatmaps, in image pixels."""
    model, x, _, _, ref = forwards[name]
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


def test_scconv_sees_maps_that_its_pool_does_not_tile(forwards):
    """SCNet's calibration pool is clamped to the map, r = min(4, H, W), and
    floors: at 64x48 its convs see 8x6 (r = 4) and 4x3 (r = 3) maps, whose
    heatmaps test_features_and_flip_test_match_jax holds to JAX's."""
    model, x, _, _, _ = forwards['scnet']
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape[2:])))
        for m in model.modules() if isinstance(m, SCConv)]
    try:
        with torch.no_grad():
            model(torch.from_numpy(x))
    finally:
        for h in hooks:
            h.remove()
    untiled = [(h, w) for h, w in seen
               if h % min(4, h, w) or w % min(4, h, w)]
    assert (8, 6) in untiled and (4, 3) in untiled, seen


@pytest.mark.parametrize('name', BF16_CASES)
def test_bf16_as_close_to_f32_as_flax(forwards, name):
    """The bf16 backbone and head (as the zoo's ResNeSt-50 and ViPNAS
    wholebody configs set them): port and flax each against the f32
    answer of the same weights."""
    exact = forwards[name][4]
    model, x, _, _, ref = forwards[name, 'bf16']
    with torch.no_grad():
        got = infer(model, torch.from_numpy(x),
                    flip_index=torch.from_numpy(FLIP)).numpy()

    def rms(a):
        return float(np.sqrt(np.mean((a - exact) ** 2)))

    assert rms(ref) > 0 and rms(got) <= BF16_FACTOR * rms(ref), \
        (rms(got), rms(ref))
    assert np.abs(got - ref).max() <= 0.05 * np.abs(exact).max()


# --- the optimizer -----------------------------------------------------------

@pytest.mark.parametrize('name', list(CASES))
def test_weight_decay_and_lr_scale_sets_match_jax(forwards, name):
    """The port's AdamW decays the leaves that JAX's mask decays: conv,
    deconv and Dense kernels (the SE, split-attention and context-block
    ones too), not BN or LayerNorm scales (ViPNAS's context blocks keep
    mmpose's LayerNorm([planes, 1, 1]), a 3-D weight of a 1-D flax scale)
    nor biases."""
    decayed, names = assert_decay_and_lr_scale_sets_match(
        model_dict(name), forwards[name][2]['params'])
    assert all(names[n].ndim in (2, 4) for n in decayed)
    if name == 'vipnas_resnet':
        ln = [n for n in names if 'channel_add_conv.1.' in n]
        assert ln and not set(ln) & decayed and all(
            names[n].ndim == 3 for n in ln if n.endswith('weight'))


# --- the converters ----------------------------------------------------------

def _equal_trees(a, b, path=()):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k], path + (k,))
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=str(path + (k,)))


@pytest.mark.parametrize('name', [n for n in CASES
                                  if n not in FLAX_NAMED_BACKBONES])
def test_state_dict_round_trips_through_jax_converters(forwards, name):
    """For the six that JAX converts from mmpose's names: its
    BACKBONE_CONVERTERS and HEAD_CONVERTERS read the port's state dict back
    into the flax variables it came from, exactly."""
    model, _, v, _, _ = forwards[name]
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    kw = dict(dep=MBV3_DEP) if name == 'vipnas_mbv3' else {}
    bb = BACKBONE_CONVERTERS[name](sd, prefix='backbone.', **kw)
    head = HEAD_CONVERTERS.get(name, convert_head)(sd,
                                                   prefix='keypoint_head.')
    _equal_trees({'params': {'backbone': bb[0], 'head': head[0]},
                  'batch_stats': {'backbone': bb[1], 'head': head[1]}},
                 {k: v[k] for k in ('params', 'batch_stats')})


# some port entries of the six without a JAX converter, and their flax leaf
# (tree, module path, leaf)
FLAX_NAMED = {
    'resnest': {
        'layer1.0.splat.fc1.weight': ('params', 'layer1_0/splat/fc1',
                                      'kernel'),
        'layer2.0.downsample.0.weight': ('params', 'layer2_0/ds', 'kernel'),
        'layer2.0.downsample.1.running_var': ('batch_stats',
                                              'layer2_0/ds_bn', 'var')},
    'vgg': {'conv0_0.weight': ('params', 'conv0_0', 'kernel'),
            'bn4_1.running_mean': ('batch_stats', 'bn4_1', 'mean')},
    'alexnet': {'conv5.bias': ('params', 'conv5', 'bias')},
    'shufflenet_v1': {'s0b0_g1.weight': ('params', 's0b0_g1', 'kernel'),
                      's2b3_bn3.running_var': ('batch_stats', 's2b3_bn3',
                                               'var')},
    'regnet': {'s3b0_ds.weight': ('params', 's3b0_ds', 'kernel'),
               's0b0_dsbn.bias': ('params', 's0b0_dsbn', 'bias')},
    'mobilenet_v3': {'b0_se.fc2.weight': ('params', 'b0_se/fc2', 'kernel'),
                     'head_bn.weight': ('params', 'head_bn', 'scale')},
}


@pytest.mark.parametrize('name', FLAX_NAMED_BACKBONES)
def test_flax_named_backbones_map_leaf_for_leaf(forwards, name):
    """The six without a JAX converter: one port entry per flax leaf (BN's
    num_batches_tracked aside) holding the leaf's values (4-D kernels
    transposed, Dense kernels as nn.Linear's [out, in]), under the flax
    module path with `_CNN_MODULES`' renames."""
    model, _, v, _, _ = forwards[name]
    sd = {k[len('backbone.'):]: t for k, t in model.state_dict().items()
          if k.startswith('backbone.')
          and not k.endswith('num_batches_tracked')}
    leaves = [np.asarray(a) for a in jax.tree.leaves(
        {k: v[k].get('backbone', {}) for k in ('params', 'batch_stats')})]
    assert len(sd) == len(leaves)
    np.testing.assert_array_equal(
        np.sort(np.concatenate([a.ravel() for a in leaves])),
        np.sort(torch.cat([t.flatten() for t in sd.values()]).numpy()))
    for port_name, (tree, module, leaf) in FLAX_NAMED[name].items():
        a = v[tree]['backbone']
        for part in module.split('/'):
            a = a[part]
        a = np.asarray(a[leaf])
        a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1) \
            if a.ndim == 4 else a
        np.testing.assert_array_equal(sd[port_name].numpy(), a)

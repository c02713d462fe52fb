"""The port's ViT, head, top-down model, weight carry-over and inference API
against the JAX package, on the CPU at a small size (64x48 crops, width 32,
depth 2, 4 heads).

Both sides get the same weights: random numpy variables in the flax layout,
carried into the port with `state_dict_from_flax`. f32 tolerance is 1e-4 as
in tests/test_model_parity.py. The JAX references of a test group are one
program, compiled by XLA's CPU backend at optimisation level 0 (half the
compile time; it may differ from the default level in the last bits of a
transcendental, far inside every tolerance here).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.api.inference import (
    inference_top_down_pose_model as jax_inference,
    init_pose_model as jax_init_pose_model)
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.models import infer as jax_infer
from vitpose_tpu.models.heads import HeatmapHead as JaxHead
from vitpose_tpu.models.vit import ViT as JaxViT
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.torch_ckpt import convert_topdown_checkpoint

from vitpose_tpu_torch.api import (inference_top_down_pose_model,
                                   init_pose_model)
from vitpose_tpu_torch.models import TopDownModel, infer, make_config
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
# bf16 backbone against flax at dtype=bfloat16: the two round to bf16 at
# different points (see vitpose_tpu_torch/models/vit.py), a step or two of
# the output apart, so each is held to the f32 answer: the port's RMS error
# may be at most BF16_FACTOR times flax's own
BF16_FACTOR = 1.25
SMALL = dict(embed_dim=32, depth=2, num_heads=4)


def _small(make, out_channels=5, **backbone):
    cfg = make('b', img_size=(64, 48), out_channels=out_channels)
    bb = dataclasses.replace(cfg.backbone, **SMALL, **backbone)
    return dataclasses.replace(cfg, backbone=bb, deconv_filters=(16, 16))


def _compile_fast(fn, *args):
    """jax.jit(fn)(*args), compiled at XLA CPU optimisation level 0."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})(*args)


@functools.lru_cache(maxsize=None)
def _variable_shapes(out_channels):
    """Shapes of the small model's variables; the GELU, attention and dtype
    options do not change them."""
    module = JaxTopDown(_small(jax_make_config, out_channels=out_channels))
    return jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 64, 48, 3)))


def _random_variables(seed, out_channels=5):
    """flax variables of the small model filled from a seeded numpy
    generator, with non-trivial BN running statistics."""
    return _fill(_variable_shapes(out_channels), seed)


def _fill(shapes, seed):
    """Variables of the given shapes (a tree of ShapeDtypeStruct), filled
    as `_random_variables` describes."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == 'var':
            a = rng.uniform(0.5, 1.5, shape)
        elif name == 'scale':
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name in ('mean', 'bias'):
            a = 0.1 * rng.randn(*shape)
        elif name == 'pos_embed':
            a = 0.02 * rng.randn(*shape)
        else:                                        # kernels, fan-in scaled
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _peaked(v):
    """Turn random variables into ones whose heatmaps have one smooth peak,
    so that the UDP Newton step is well conditioned and the decoded
    keypoints can be held to 1e-3 px: token 7 of the 4x3 grid carries a
    spike in channel 0, the blocks and the patch embed are damped (not
    removed), and the head maps channel 0 through bump-shaped deconv
    kernels onto every joint."""
    bb, head = v['params']['backbone'], v['params']['head']
    bb['patch_embed']['kernel'] *= 0.2
    for i in range(SMALL['depth']):
        bb[f'blocks_{i}']['attn']['proj']['kernel'] *= 0.05
        bb[f'blocks_{i}']['mlp']['fc2']['kernel'] *= 0.05
    bb['pos_embed'][0, 1 + 7, 0] += 5.0
    bump = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32) / 8
    for i in range(2):
        head[f'deconv_{i}']['kernel'] *= 0.1
        head[f'deconv_{i}']['kernel'][:, :, 0, 0] = bump
    head['final']['kernel'] *= 0.1
    head['final']['kernel'][0, 0, 0, :] = 1.0
    return v


def _crops(seed, n=2):
    return np.random.RandomState(seed).randn(n, 64, 48, 3).astype(np.float32)


def _port_model(cfg, variables):
    model = TopDownModel(cfg).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope='module')
def small_pair():
    """(jax model, variables, port model), f32, classic head, 5 joints."""
    jm = JaxTopDown(_small(jax_make_config))
    v = _random_variables(seed=1)
    return jm, v, _port_model(_small(make_config), v)


BACKBONES = [dict(gelu_approx=g, fused_attention=f)
             for g in (False, True) for f in (False, True)]
BF16_BACKBONE = dict(fused_attention=True, dtype='bfloat16')   # serving


@pytest.fixture(scope='module')
def backbone_refs():
    """(crops, variables, flax outputs of BACKBONES + [BF16_BACKBONE])."""
    x = _crops(2)
    v = _random_variables(seed=3)

    def fn(params, x):
        return [JaxViT(_small(jax_make_config, **kw).backbone).apply(
            {'params': params}, x) for kw in BACKBONES + [BF16_BACKBONE]]

    return x, v, _compile_fast(fn, v['params']['backbone'], jnp.asarray(x))


@pytest.mark.parametrize('gelu_approx', [False, True])
@pytest.mark.parametrize('fused', [False, True])
def test_vit_backbone_matches_jax(backbone_refs, gelu_approx, fused):
    kw = dict(gelu_approx=gelu_approx, fused_attention=fused)
    x, v, refs = backbone_refs
    ref = refs[BACKBONES.index(kw)]
    port = _port_model(_small(make_config, **kw), v)
    with torch.no_grad():
        out = port.backbone(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 4, 3, 32)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_vit_backbone_bf16_matches_flax(backbone_refs):
    """The port's bf16 path (f32 parameters, bf16 compute, f32 LayerNorm) is
    as accurate as flax's dtype=bfloat16 path. The bf16 output rounding of
    the last LayerNorm dominates both errors, so a change of cast scheme
    inside the blocks smaller than one bf16 step of the output does not
    show here."""
    x, v, refs = backbone_refs
    assert refs[-1].dtype == jnp.bfloat16
    flax_bf16 = np.asarray(refs[-1].astype(jnp.float32))
    f32 = np.asarray(refs[BACKBONES.index(dict(gelu_approx=False,
                                               fused_attention=True))])
    port = _port_model(_small(make_config, **BF16_BACKBONE), v)
    with torch.no_grad():
        out = port.backbone(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    port_err = np.sqrt(np.mean((out.float().numpy() - f32) ** 2))
    flax_err = np.sqrt(np.mean((flax_bf16 - f32) ** 2))
    assert 0 < port_err <= BF16_FACTOR * flax_err, (port_err, flax_err)


FLIP_INDEX = np.array([0, 2, 1, 4, 3])
SHIFTS = (False, True)


@pytest.fixture(scope='module')
def small_refs(small_pair):
    """(head features, crops, {flax head output, infer output per shift})."""
    jm, v, _ = small_pair
    feat = np.random.RandomState(4).randn(2, 4, 3, 32).astype(np.float32)
    x = _crops(5)
    head = JaxHead(out_channels=5, deconv_filters=(16, 16))

    def fn(v, feat, x):
        out = {'head': head.apply({'params': v['params']['head'],
                                   'batch_stats': v['batch_stats']['head']},
                                  feat)}
        for shift in SHIFTS:
            model = JaxTopDown(dataclasses.replace(jm.cfg,
                                                   shift_heatmap=shift))
            out[f'infer{shift}'] = jax_infer(model, v, x,
                                             flip_index=FLIP_INDEX)
        return out

    return feat, x, _compile_fast(fn, v, jnp.asarray(feat), jnp.asarray(x))


def test_heatmap_head_matches_jax(small_pair, small_refs):
    _, _, port = small_pair
    feat, _, refs = small_refs
    with torch.no_grad():
        out = port.keypoint_head(torch.from_numpy(feat)).numpy()
    np.testing.assert_allclose(out, np.asarray(refs['head']).transpose(
        0, 3, 1, 2), **TOL)


@pytest.mark.parametrize('shift', SHIFTS)
def test_topdown_infer_flip_matches_jax(small_pair, small_refs, shift):
    _, v, _ = small_pair
    _, x, refs = small_refs
    port = _port_model(
        dataclasses.replace(_small(make_config), shift_heatmap=shift), v)
    with torch.no_grad():
        out = infer(port, torch.from_numpy(x), flip_index=FLIP_INDEX).numpy()
    assert out.shape == (2, 5, 16, 12) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(refs[f'infer{shift}']), **TOL)


HEADS = {'simple': dict(head_type='simple'),
         'identity': dict(final_kernel=0)}


@pytest.mark.parametrize('head', sorted(HEADS))
def test_simple_and_identity_heads_match_jax(head):
    """The simple decoder (ReLU, bilinear x4, 3x3 conv) and the classic
    head with an identity final layer (the deconv features are the output),
    through the weight carry-over."""
    jcfg = dataclasses.replace(_small(jax_make_config), **HEADS[head])
    jm = JaxTopDown(jcfg)
    v = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 48, 3))), seed=6)
    x = _crops(7)
    ref = _compile_fast(lambda v, x: jm.apply(v, x), v, jnp.asarray(x))
    port = _port_model(dataclasses.replace(_small(make_config),
                                           **HEADS[head]), v)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == ((2, 5, 16, 12) if head == 'simple'
                         else (2, 16, 16, 12))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_state_dict_round_trip(small_pair):
    """convert_topdown_checkpoint(state_dict_from_flax(v)) gives back v."""
    jm, v, _ = small_pair
    sd = {k: t.numpy() for k, t in state_dict_from_flax(v).items()}
    back = convert_topdown_checkpoint(sd, jm.cfg)
    flat_v = jax.tree_util.tree_leaves_with_path(v)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_v) == len(flat_b)
    for path, leaf in flat_v:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_inference_api_matches_jax_from_npz(tmp_path):
    """Both APIs load the .npz the JAX package saved and decode the same
    keypoints (UDP, flip test) on a seeded image with 3 boxes."""
    jcfg = _small(jax_make_config, out_channels=17)
    v = _peaked(_random_variables(seed=15, out_channels=17))
    path = str(tmp_path / 'small.npz')
    save_params_npz(path, v)
    img = np.random.RandomState(7).randint(0, 256, (90, 120, 3), np.uint8)
    boxes = [{'bbox': [10.0, 5.0, 40.0, 70.0, 0.9]},
             {'bbox': [60.0, 20.0, 50.0, 60.0, 0.8]},
             {'bbox': [-8.0, 40.0, 30.0, 45.0, 0.7]}]
    jmodel = jax_init_pose_model(jcfg, checkpoint=path)
    ref, ref_out = jax_inference(jmodel, img, boxes, return_heatmap=True)
    port = init_pose_model(_small(make_config, out_channels=17),
                           checkpoint=path, device='cpu')
    res, out = inference_top_down_pose_model(port, img, boxes,
                                             return_heatmap=True)
    hm = out[0]['heatmap']
    np.testing.assert_allclose(hm, ref_out[0]['heatmap'], **TOL)
    # the argmax is decisive: the best cell beats every other by far more
    # than the heatmap tolerance
    flat = np.sort(hm.reshape(3, 17, -1), axis=-1)
    assert (flat[..., -1] - flat[..., -2]).min() > 1e-3
    assert [r['bbox'] for r in res] == [b['bbox'] for b in boxes]
    for a, b in zip(res, ref):
        np.testing.assert_allclose(a['keypoints'][:, :2],
                                   b['keypoints'][:, :2], rtol=0, atol=1e-3)
        np.testing.assert_allclose(a['keypoints'][:, 2],
                                   b['keypoints'][:, 2], **TOL)


def test_init_pose_model_loads_a_pth_state_dict(small_pair, tmp_path):
    """A .pth state dict under the mmpose names loads as it is."""
    _, _, port = small_pair
    path = str(tmp_path / 'small.pth')
    torch.save({'state_dict': port.state_dict()}, path)
    loaded = init_pose_model(_small(make_config), checkpoint=path,
                             device='cpu')
    x = torch.from_numpy(_crops(8))
    with torch.no_grad():
        np.testing.assert_array_equal(loaded.model(x).numpy(),
                                      port(x).numpy())

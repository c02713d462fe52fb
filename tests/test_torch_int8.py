"""The port's int8 W8A8 serving path against the JAX package on the CPU:
`Int8Linear` against flax `Int8Dense`, calibration, `int8_serving_config`,
`first_last_skip`, whole-model heatmaps, and the evaluation CLI's `--int8
--int8-skip`.

Tolerances:
  * `Int8Linear`: the weight and activation codes equal JAX's (the test
    prints how many differ: none may), the int32 product is exact, and the
    f32 output agrees within 1e-6 relative (f32 rounding of the two scale
    products and the bias); in bf16 the outputs are equal.
  * Calibration scales (absmaxes of f32 LayerNorm, GELU and attention
    outputs): within 1e-5 relative.
  * Whole-model heatmaps at the same scales: within 1e-4, the f32 model
    tolerance of tests/test_torch_models.py. The int8 path itself moves
    the heatmaps by about 1e-2 here, and one activation code step of an
    input moves a product's output by s_x * s_w * |w_q|, up to s_x *
    max|W| (the test prints it): 1e-4 is well under one step.
  * The evaluation CLI's stats against JAX `calibrate_from_loader` +
    `int8_serving_config` + `run_validation`: within 1e-6, as in
    tests/test_torch_eval.py.

The small model is tests/test_torch_models.py's (64x48 crops, width 32,
depth 2); the CLI test uses depth 3, since the port refuses
`--int8-skip 1` at depth 2 (it would leave no block in int8).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.eval.loop import run_validation as jax_run_validation
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.models.vit import Int8Dense
from vitpose_tpu.ops import geometry as jgeometry
from vitpose_tpu.ops import warp as jwarp
from vitpose_tpu.utils import quantize as jq
from vitpose_tpu.utils.checkpoint import save_params_npz

from test_torch_data import dataset_pair, write_coco_fixture
from test_torch_eval import (AP_TOL, _small_config, _write_gt_from,
                             assert_stats_close)
from test_torch_models import (TOL, _compile_fast, _crops, _fill, _peaked,
                               _port_model, _random_variables, _small)
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.models import TopDownModel, make_config
from vitpose_tpu_torch.models.vit import Int8Linear, int8_matmul
from vitpose_tpu_torch.tools import test as cli
from vitpose_tpu_torch.utils import quantize as q
from test_torch_threads import torch_test_threads  # noqa: F401

OUT_RTOL = 1e-6
SCALE_RTOL = 1e-5


class CompiledApply:
    """A flax module whose `apply` runs as one program compiled at XLA CPU
    optimisation level 0 (once per capture filter and input shape), for
    the JAX calibration functions to call in place of the module: they
    then run their own code around a compiled forward instead of
    dispatching it op by op."""

    def __init__(self, module):
        self.module, self.cfg, self._fns = module, module.cfg, {}

    def apply(self, variables, x, **kw):
        capture = kw.get('capture_intermediates')
        key = (id(capture), x.shape)
        if key not in self._fns:
            # the entry holds the filter, so that its id is not reused
            self._fns[key] = capture, jax.jit(
                lambda v, x: self.module.apply(v, x, **kw)).lower(
                    variables, x).compile(compiler_options={
                        'xla_backend_optimization_level': 0})
        return self._fns[key][1](variables, x)

# --- Int8Linear against Int8Dense -------------------------------------------

# (input dtype, act_scale: None per token, 'amax' the input's absmax,
# 'clip' 0.6 of it, or a number)
LINEAR_CASES = {
    'static': ('float32', 'amax'),
    'static_clipped': ('float32', 'clip'),
    'dynamic': ('float32', None),
    'ties': ('float32', 127.0),
    'bf16_static': ('bfloat16', 'amax'),
    'bf16_dynamic': ('bfloat16', None),
}


def _jax_codes(kernel, x, act_scale):
    """Int8Dense's codes and scales (vitpose_tpu/models/vit.py:75-86), in
    the same jnp expressions, compiled with the layer in one program as
    every JAX entry point compiles the model (XLA then multiplies by the
    f32 reciprocal of 127 where the code divides by it)."""
    k = jnp.asarray(kernel, jnp.float32)
    s_w = jnp.max(jnp.abs(k), axis=0, keepdims=True) / 127.0
    w_q = jnp.round(k / jnp.maximum(s_w, 1e-12)).astype(jnp.int8)
    xf = jnp.asarray(x).astype(jnp.float32)
    if act_scale is not None:
        a = float(act_scale)
        x_q = jnp.round(jnp.clip(xf * (127.0 / a), -127.0, 127.0)
                        ).astype(jnp.int8)
        s_x = a / 127.0
    else:
        s_x = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0
        x_q = jnp.round(xf / jnp.maximum(s_x, 1e-12)).astype(jnp.int8)
    return w_q, s_w, x_q, jnp.asarray(s_x, jnp.float32)


@pytest.mark.parametrize('case', list(LINEAR_CASES))
def test_int8_linear_matches_int8dense(case):
    dtype, scale = LINEAR_CASES[case]
    rng = np.random.RandomState(list(LINEAR_CASES).index(case))
    kernel = (rng.randn(32, 24) / np.sqrt(32)).astype(np.float32)
    kernel[:, 3] = 0.0                       # an all-zero output channel
    bias = (0.1 * rng.randn(24)).astype(np.float32)
    x = rng.randn(2, 12, 32).astype(np.float32)
    if case == 'ties':                       # x * (127 / 127) lands on .5
        x[0, :, :8] = np.arange(-4, 4) + 0.5
    jx = jnp.asarray(x, dtype)
    act = {'amax': float(np.abs(np.asarray(jx, np.float32)).max()),
           'clip': 0.6 * float(np.abs(x).max())}.get(scale, scale)
    layer = Int8Dense(24, act_scale=act, dtype=jnp.dtype(dtype))

    def jax_ref(params, x):
        return (layer.apply({'params': params}, x).astype(jnp.float32),
                _jax_codes(params['kernel'], x, act))

    ref, (w_q, s_w, x_q, s_x) = jax.tree.map(np.asarray, _compile_fast(
        jax_ref, {'kernel': kernel, 'bias': bias}, jx))

    port = Int8Linear(32, 24, act_scale=act)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.T))
        port.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    pw_q, ps_w = port.quantized_weight()
    px_q, ps_x = port.quantize_input(xt)
    w_diff = int((pw_q.numpy().T != w_q).sum())
    x_diff = int((px_q.numpy() != x_q).sum())
    print(f'{case}: {w_diff} of {w_q.size} weight codes and {x_diff} of '
          f'{x_q.size} activation codes differ from JAX')
    assert w_diff == 0 and x_diff == 0
    np.testing.assert_array_equal(ps_w.numpy(), s_w[0])
    np.testing.assert_array_equal(np.asarray(ps_x, np.float32),
                                  np.asarray(s_x, np.float32))
    if case == 'ties':                       # half to even, as jnp.round
        assert x_q[0, 0, :8].tolist() == [-4, -2, -2, 0, 0, 2, 2, 4]
    if case == 'static_clipped':
        assert (np.abs(x_q) == 127).any()

    y = int8_matmul(px_q.reshape(-1, 32), pw_q)
    assert y.dtype == torch.int32
    exact = x_q.reshape(-1, 32).astype(np.int64) @ w_q.astype(np.int64)
    np.testing.assert_array_equal(y.numpy(), exact)

    with torch.no_grad():
        out = port(xt, getattr(torch, dtype)).float().numpy()
    if dtype == 'bfloat16':
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=OUT_RTOL,
                                   atol=OUT_RTOL * np.abs(ref).max())


def test_int8_linear_requantizes_loaded_weights():
    """The cached codes follow the weight: a load_state_dict gives the new
    weight's codes, and a float checkpoint loads into an int8 layer under
    nn.Linear's names."""
    a, b = torch.nn.Linear(16, 8), torch.nn.Linear(16, 8)
    layer = Int8Linear(16, 8, act_scale=2.0)
    layer.load_state_dict(a.state_dict())
    first = layer.quantized_weight()[0].clone()
    layer.load_state_dict(b.state_dict())
    second, s_w = layer.quantized_weight()
    w = b.weight.detach()
    np.testing.assert_array_equal(
        second.numpy(), torch.round(w / (w.abs().amax(1) * (1 / 127))[:, None])
        .to(torch.int8).numpy())
    assert not torch.equal(first, second)
    assert sorted(layer.state_dict()) == ['bias', 'weight']


# --- calibration and configs ---------------------------------------------

@pytest.fixture(scope='module')
def calib():
    """(variables, calibration batches, JAX scales for attn False / True)."""
    v = _random_variables(seed=21)
    batches = [_crops(22), _crops(23)]
    jm = CompiledApply(JaxTopDown(_small(jax_make_config)))
    scales = {attn: jq.calibrate_act_scales(jm, v, batches, attn=attn)
              for attn in (False, True)}
    return v, batches, scales


@pytest.mark.parametrize('attn', [False, True])
def test_calibrate_act_scales_matches_jax(calib, attn):
    v, batches, scales = calib
    port = _port_model(_small(make_config), v)
    got = q.calibrate_act_scales(port, batches, attn=attn)
    ref = np.asarray(scales[attn])
    assert np.asarray(got).shape == ref.shape == (2, 4 if attn else 2)
    np.testing.assert_allclose(got, ref, rtol=SCALE_RTOL)
    doubled = q.calibrate_act_scales(port, batches, attn=attn, margin=2.0)
    np.testing.assert_allclose(doubled, 2.0 * np.asarray(got), rtol=1e-7)


INT8_FIELDS = ('int8_mlp', 'int8_qkv', 'int8_act_scales',
               'int8_skip_blocks')


@pytest.mark.parametrize('qkv,skip', [(False, ()), (True, (0,)),
                                      (True, [1])])
def test_int8_serving_config_matches_jax(calib, qkv, skip):
    _, _, scales = calib
    s = scales[True]
    ref = jq.int8_serving_config(_small(jax_make_config), s, qkv=qkv,
                                 skip_blocks=skip)
    got = q.int8_serving_config(_small(make_config), s, qkv=qkv,
                                skip_blocks=skip)
    for f in INT8_FIELDS:
        assert getattr(got.backbone, f) == getattr(ref.backbone, f), f


def test_int8_serving_config_refusals(calib):
    _, _, scales = calib
    with pytest.raises(ValueError, match='attn=True'):
        q.int8_serving_config(_small(make_config), scales[False], qkv=True)
    moe = _small(make_config, num_experts=2, part_dim=8)
    for mod in (q, jq):
        with pytest.raises(NotImplementedError, match='MoE'):
            mod.int8_serving_config(moe, scales[True])
    bad = dataclasses.replace(moe, backbone=dataclasses.replace(
        moe.backbone, int8_mlp=True))
    with pytest.raises(NotImplementedError, match='MoE'):
        TopDownModel(bad)


@pytest.mark.parametrize('depth,k_first,k_last', [(12, 0, 0), (12, 1, 1),
                                                  (12, 2, 1), (3, 1, 1),
                                                  (24, 3, 0)])
def test_first_last_skip_matches_jax(depth, k_first, k_last):
    assert q.first_last_skip(depth, k_first, k_last) \
        == jq.first_last_skip(depth, k_first, k_last)


@pytest.mark.parametrize('depth,k', [(2, 1), (12, 6), (12, 7)])
def test_first_last_skip_refuses_all_blocks(depth, k):
    """JAX returns every block here; the port refuses (ROADMAP.md queue
    1 item 8)."""
    assert jq.first_last_skip(depth, k, k) == tuple(range(depth))
    with pytest.raises(ValueError, match='no block in int8'):
        q.first_last_skip(depth, k, k)


# --- whole model ------------------------------------------------------------

HEATMAP_CASES = [(False, ()), (True, ()), (True, (1,))]


@pytest.fixture(scope='module')
def int8_refs(calib):
    """(crops, the JAX int8 heatmaps per HEATMAP_CASES, f32 heatmaps), all
    at the JAX scales with attention."""
    v, _, scales = calib
    x = _crops(24)
    cfgs = [jq.int8_serving_config(_small(jax_make_config), scales[True],
                                   qkv=qkv, skip_blocks=skip)
            for qkv, skip in HEATMAP_CASES]

    def fn(v, x):
        return ([JaxTopDown(c).apply(v, x) for c in cfgs],
                JaxTopDown(_small(jax_make_config)).apply(v, x))

    return x, _compile_fast(fn, v, jnp.asarray(x))


@pytest.mark.parametrize('case', range(len(HEATMAP_CASES)))
def test_int8_heatmaps_match_jax(calib, int8_refs, case):
    v, _, scales = calib
    x, (refs, f32) = int8_refs
    qkv, skip = HEATMAP_CASES[case]
    cfg = q.int8_serving_config(_small(make_config), scales[True], qkv=qkv,
                                skip_blocks=skip)
    port = _port_model(cfg, v)
    kinds = {type(m).__name__ for i, blk in enumerate(port.backbone.blocks)
             for m in (blk.attn.qkv, blk.mlp.fc1) if i not in skip}
    assert kinds == ({'Int8Linear'} if qkv else {'Int8Linear', 'Linear'})
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    ref = np.asarray(refs[case])
    fc2 = port.backbone.blocks[0].mlp.fc2
    step = fc2.act_scale / 127.0 * fc2.weight.abs().max().item()
    print(f'int8 vs JAX {np.abs(out - ref).max():.3e}, int8 vs f32 '
          f'{np.abs(ref - np.asarray(f32)).max():.3e}, one fc2 input code '
          f'step up to {step:.3e}')
    np.testing.assert_allclose(out, ref, **TOL)
    assert np.abs(ref - np.asarray(f32)).max() > 10 * TOL['atol']


# --- the evaluation CLI -----------------------------------------------------

def _depth3(make):
    cfg = _small(make, out_channels=17)
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, depth=3))


@pytest.fixture(scope='module')
def cli_setup(tmp_path_factory):
    """A depth-3 small model's peaked variables saved as .npz, the COCO
    fixture with its GT rewritten from the JAX int8 predictions (so that AP
    lies strictly between 0 and 1), the JAX scales, and the JAX stats of
    the int8 path with --int8-skip 1."""
    root = tmp_path_factory.mktemp('int8_cli')
    coco = write_coco_fixture(str(root / 'coco'), seed=3)
    jcfg = _depth3(jax_make_config)
    jm = JaxTopDown(jcfg)
    v = _peaked(_fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                     jnp.zeros((1, 64, 48, 3))), seed=25))
    npz = str(root / 'depth3.npz')
    save_params_npz(npz, v)
    ds, _ = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                         bbox_file=coco['det'])
    loader = JaxTopDownLoader(ds, 4, is_train=False, num_workers=2)
    jv = jax.tree.map(jnp.asarray, v)
    # the crop warp compiled as the val step compiles it, not op by op
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jgeometry, 'udp_warp_matrix'),
                          (jwarp, 'warp_affine_batch')):
            mp.setattr(mod, name, jax.jit(getattr(mod, name),
                                          static_argnums=3 if name ==
                                          'udp_warp_matrix' else 2))
        scales = jq.calibrate_from_loader(CompiledApply(jm), jv, loader,
                                          attn=True)
    fcfg = jq.int8_serving_config(jcfg, scales, qkv=True,
                                  skip_blocks=jq.first_last_skip(3, 1, 1))
    fcfg = dataclasses.replace(fcfg, backbone=dataclasses.replace(
        fcfg.backbone, gelu_approx=True))
    results = jax_run_validation(JaxTopDown(fcfg), jv, loader)
    _write_gt_from(results, coco, seed=4)
    ds, _ = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                         bbox_file=coco['det'])
    return coco, npz, v, scales, ds.evaluate(results)


def test_cli_int8_matches_jax(cli_setup, tmp_path):
    coco, npz, v, scales, ref_stats = cli_setup
    out = str(tmp_path / 'stats.json')
    stats = cli.main([
        _small_config(tmp_path), npz, '--device', 'cpu', '--out', out,
        '--int8', '--int8-skip', '1', '--cfg-options',
        'model.backbone_overrides.depth=3',
        f"data.val.ann_file={coco['ann']}",
        f"data.val.img_prefix={coco['prefix']}",
        f"data.val.bbox_file={coco['det']}"])
    with open(out) as f:
        written = json.load(f)
    assert written == {k: float(v) for k, v in stats.items()}
    assert_stats_close(written, ref_stats, AP_TOL)
    assert 0 < written['AP'] < 1


def test_int8_model_calibrates_and_skips(cli_setup):
    """`tools.test.int8_model`: the loader's scales are JAX's, block 1 alone
    is int8 (skip 1 at depth 3), with attention and tanh GELU."""
    coco, _, v, scales, _ = cli_setup
    model = _port_model(_depth3(make_config), v)
    _, port_ds = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                              bbox_file=coco['det'])
    loader = TopDownLoader(port_ds, 4, is_train=False, num_workers=2)
    m8 = cli.int8_model(model, loader, 1)
    bb = m8.cfg.backbone
    assert (bb.int8_mlp, bb.int8_qkv, bb.gelu_approx) == (True, True, True)
    assert bb.int8_skip_blocks == (0, 2)
    np.testing.assert_allclose(bb.int8_act_scales, scales, rtol=SCALE_RTOL)
    assert [type(b.attn.qkv).__name__ for b in m8.backbone.blocks] \
        == ['Linear', 'Int8Linear', 'Linear']
    sd = m8.state_dict()
    assert all(torch.equal(sd[k], t) for k, t in model.state_dict().items())

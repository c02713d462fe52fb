"""The port's bench tools (vitpose_tpu_torch/tools/analysis/bench_*.py) on
the CPU at a small size, held to the JAX package's tools/analysis/bench_*.py:

  * bench_attn_pack: every arm of the chain (base, sdpa, fused, pack{2,4},
    pack{2,4}_full) against JAX's expressions of :38-81 (jnp.einsum,
    jax.nn.softmax; rebuilt here, since they are closures in JAX's main)
    and the port's plain attention, at (B, H, S, D) = (2, 4, 8, 8) f32; the
    chain of 3 against JAX's lax.scan;
  * bench_breakdown: the e2e arm (uint8 crops, normalisation, the small ViT,
    the UDP decode) against JAX's TopDownModel.apply + keypoints_from_heatmaps
    on the same weights and crops; decode_only against JAX's decode; one JSON
    line per experiment with JAX's keys;
  * bench_zoo: the ZOO table, the build_fast settings of its ten configs and
    which backbones take a dtype (JAX: which raise TypeError), and the FLOP
    count of the small ViT against the analytic products;
  * bench_io: make_jpegs byte for byte, the evaluation loader's batches on
    its files against JAX's TopDownLoader's;
  * bench_batch_sweep, bench_fused_attention: their printed lines.

Tolerances: f32 attention arms 1e-5 (summation order; the packed arms add
exact zeros); the chain 1e-5 relative; the small model's keypoints 1e-3 px
(shaped weights, tests/test_torch_models.py `_peaked`), the decode of
seeded peaked maps 1e-4 px, as tests/test_torch_ops.py holds the decode. The JAX
references run as one program compiled at XLA optimisation level 0.
"""
import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import DatasetInfo as JaxDatasetInfo
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.ops.decode import keypoints_from_heatmaps as jax_decode
from vitpose_tpu.train.loop import build_backbone as jax_build_backbone
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build_model
from vitpose_tpu.utils.config import load_config as jax_load_config

from test_torch_eval import _small_config
from test_torch_models import (SMALL, _compile_fast, _peaked, _port_model,
                               _random_variables, _small)
from test_torch_tools_analysis import analytic_flops
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.models import make_config
from vitpose_tpu_torch.ops.attention import reference_attention
from vitpose_tpu_torch.tools.analysis import (bench_attn_pack,
                                              bench_batch_sweep,
                                              bench_breakdown,
                                              bench_fused_attention,
                                              bench_io, bench_zoo)
from vitpose_tpu_torch.train.loop import (BACKBONES, _model_parts,
                                          backbone_takes)
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ['--device', 'cpu', '--img-size', '64', '48', '--backbone',
        *(f'{k}={v}' for k, v in SMALL.items())]
SHAPE = (2, 4, 8, 8)                  # (B, H, S, D)
CHAIN = 3
GROUPS = (2, 4)
CENTER = np.tile(np.float32([[320.0, 240.0]]), (2, 1))
SCALE = np.tile(np.float32([[1.2, 1.6]]), (2, 1))


def _jax_tool(name):
    """tools/analysis/<name>.py of the JAX package, loaded by file path."""
    path = os.path.join(ROOT, 'tools', 'analysis', f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'jax_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- JAX's cores of bench_attn_pack.py:38-95, which live inside its main ---

def _jax_base(q, k, v):
    scale = q.shape[-1] ** -0.5
    s = jnp.einsum('bhsd,bhtd->bhst', q, k,
                   preferred_element_type=jnp.float32) * scale
    p = jax.nn.softmax(s, axis=-1).astype(q.dtype)
    return jnp.einsum('bhst,bhtd->bhsd', p, v)


def _jax_pack(q, k, v, g, full):
    b, h, s, d = q.shape
    n = b * h // g
    scale = d ** -0.5
    qm, km = q.reshape(n, g * s, d), k.reshape(n, g * s, d)
    vp = v.reshape(n, g, s, d)
    full_s = jnp.einsum('pmd,pnd->pmn', qm, km,
                        preferred_element_type=jnp.float32) * scale
    blocks = full_s.reshape(n, g, s, g, s)
    diag = jnp.einsum('pgsht,gh->pgst', blocks,
                      jnp.eye(g, dtype=full_s.dtype))
    p = jax.nn.softmax(diag, axis=-1).astype(q.dtype)
    if full:
        pbd = (p[:, :, :, None, :]
               * jnp.eye(g, dtype=p.dtype)[None, :, None, :, None])
        pbd = pbd.reshape(n, g * s, g * s)
        return jnp.einsum('pmn,pnd->pmd', pbd,
                          vp.reshape(n, g * s, d)).reshape(b, h, s, d)
    return jnp.einsum('pgst,pgtd->pgsd', p, vp).reshape(b, h, s, d)


def _jax_chain(core, q, k, v):
    def body(carry, _):
        q, k, v = carry
        o = core(q, k, v)
        o = o / (jnp.max(jnp.abs(o)) + 1e-3)
        return (o, k + o * 1e-3, v + o * 1e-3), ()
    (o, _, _), _ = jax.lax.scan(body, (q, k, v), None, length=CHAIN)
    return jnp.sum(o.astype(jnp.float32))


def _qkv():
    rng = np.random.RandomState(0)
    return [rng.randn(*SHAPE).astype(np.float32) for _ in range(3)]


def _u8_crops():
    return np.random.RandomState(3).randint(0, 255, (2, 64, 48, 3)).astype(
        np.uint8)


def _random_maps():
    """One Gaussian peak (sigma 2 px) a joint at a seeded sub-pixel spot,
    plus 1% noise: random maps alone make the UDP Newton step ill
    conditioned (tests/test_torch_models.py `_peaked`)."""
    rng = np.random.RandomState(4)
    cy, cx = rng.uniform(3, 12, (2, 17, 1, 1)), rng.uniform(3, 8, (2, 17, 1, 1))
    y, x = np.mgrid[:16, :12]
    maps = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / 8.0)
    return (maps + 0.01 * rng.randn(*maps.shape)).astype(np.float32)


@pytest.fixture(scope='module')
def jax_refs():
    """JAX's attention arms and chain, the e2e arm's keypoints on shaped
    weights and the decode of random maps, as one program."""
    jm = JaxTopDown(_small(jax_make_config, out_channels=17))
    v = _peaked(_random_variables(seed=21, out_channels=17))
    mean, std = jnp.asarray(IMAGENET_MEAN), jnp.asarray(IMAGENET_STD)

    def fn(v, q, k, vv, u8, maps, c, s):
        out = {'base': _jax_base(q, k, vv),
               'chain': _jax_chain(_jax_base, q, k, vv)}
        for g in GROUPS:
            out[f'pack{g}'] = _jax_pack(q, k, vv, g, False)
            out[f'pack{g}_full'] = _jax_pack(q, k, vv, g, True)
        x = (u8.astype(jnp.float32) / 255.0 - mean) / std
        hm = jm.apply(v, x, train=False)
        out['e2e'] = jax_decode(hm, c, s, post_process='default',
                                use_udp=True)[0]
        out['decode'] = jax_decode(maps, c, s, post_process='default',
                                   use_udp=True)[0]
        return out

    out = _compile_fast(fn, v, *_qkv(), _u8_crops(), _random_maps(), CENTER,
                        SCALE)
    return v, jax.tree.map(np.asarray, out)


# --- bench_attn_pack ---------------------------------------------------------

ARMS = ['base', 'sdpa', 'fused'] + [f'pack{g}{f}' for g in GROUPS
                                   for f in ('', '_full')]


@pytest.mark.parametrize('arm', ARMS)
def test_attn_pack_arm_matches_jax_and_plain_attention(jax_refs, arm):
    """Each arm equals JAX's expression of it (the plain einsum attention
    for sdpa and fused, as JAX's xla_sdpa and pallas compute it) and the
    port's plain attention."""
    _, ref = jax_refs
    q, k, v = map(torch.from_numpy, _qkv())
    core = dict(bench_attn_pack.variants())[arm]
    out = core(q, k, v).numpy()
    np.testing.assert_allclose(out, ref.get(arm, ref['base']), rtol=1e-5,
                               atol=1e-6)
    plain = reference_attention(*(x.transpose(1, 2) for x in (q, k, v)))
    np.testing.assert_allclose(out, plain.transpose(1, 2).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_attn_pack_chain_matches_jax_scan(jax_refs):
    _, ref = jax_refs
    run = bench_attn_pack.chained(bench_attn_pack.base_core, CHAIN)
    got = float(run(*map(torch.from_numpy, _qkv())))
    np.testing.assert_allclose(got, ref['chain'], rtol=1e-5)


def test_attn_pack_main_prints_every_arm(capsys):
    """JAX's variant list as the first argument (its names xla_sdpa and
    pallas taken for sdpa and fused), one line per arm in JAX's format."""
    out = bench_attn_pack.main(['xla_sdpa,pallas,pack2_full', '--device',
                                'cpu', '--shape', *map(str, SHAPE),
                                '--chain', '2', '--iters', '2', '--dtype',
                                'float32'])
    assert list(out) == ['sdpa', 'fused', 'pack2_full']
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith('shape B2 H4 S8 D8, L=2 chained, float32; '
                               'useful ')
    for name, line in zip(out, lines[1:]):
        assert re.fullmatch(rf'{name} +[\d.]+ ms/dispatch +[\d.]+ '
                            r'useful-TFLOP/s on the CPU', line), line
    with pytest.raises(ValueError, match='unknown arms'):
        bench_attn_pack.main(['pack3', '--device', 'cpu'])


# --- bench_breakdown ---------------------------------------------------------

def test_breakdown_e2e_arm_matches_jax(jax_refs):
    """uint8 crops -> normalisation -> the small ViT -> the UDP decode, on
    the weights and crops of the JAX run."""
    v, ref = jax_refs
    model = _port_model(_small(make_config, out_channels=17), v)
    c, s = torch.from_numpy(CENTER), torch.from_numpy(SCALE)
    run = bench_breakdown.make_e2e(model, c, s)
    (preds,) = run(torch.from_numpy(_u8_crops())[None])
    np.testing.assert_allclose(preds.numpy(), ref['e2e'], atol=1e-3)
    corner = bench_breakdown.make_e2e(model, c, s, with_decode=False,
                                      backbone_only=True)
    assert corner(torch.from_numpy(_u8_crops())[None])[0].shape == (
        2, 4, 1, 1)


def test_breakdown_decode_only_matches_jax(jax_refs):
    _, ref = jax_refs
    run = bench_breakdown.decode_group(torch.from_numpy(CENTER),
                                       torch.from_numpy(SCALE))
    (preds,) = run(torch.from_numpy(_random_maps())[None])
    np.testing.assert_allclose(preds.numpy(), ref['decode'], rtol=1e-5,
                               atol=1e-4)


JAX_KEYS = ['exp', 'per_sec', 'ms_per_iter', 'unit']
EXPERIMENTS = {'matmul_ceiling': None, 'e2e_fused_decode': None,
               'e2e_fused_nodecode': None, 'backbone_fused': None,
               'backbone_plain_attn': 'backbone_xla_attn',
               'e2e_plain_decode': 'e2e_xla_decode',
               'e2e_fused_group1': None, 'decode_only': None}


def test_breakdown_prints_one_json_line_per_experiment(capsys):
    out = bench_breakdown.main(TINY + ['--batch', '2', '--group', '2',
                                       '--iters', '1'])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r['exp'] for r in lines] == list(EXPERIMENTS)
    for rec in lines:
        alias = EXPERIMENTS[rec['exp']]
        assert list(rec) == JAX_KEYS + (['alias'] if alias else []) + [
            'card'], rec
        assert rec.get('alias') == alias and rec['card'] == 'the CPU'
        assert rec['unit'] == ('TFLOP/s' if rec['exp'] == 'matmul_ceiling'
                               else 'imgs/sec')
        assert rec['ms_per_iter'] > 0
    assert out['launches']['e2e_fused_decode'] == {'k1': 0, 'k2': 0}


# --- bench_zoo ---------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_zoo():
    return _jax_tool('bench_zoo')


def test_zoo_table_is_jaxs(jax_zoo):
    assert bench_zoo.ZOO == jax_zoo.ZOO
    assert os.path.samefile(bench_zoo.CFG_DIR, jax_zoo.CFG_DIR)


def _jax_fast_settings(jax_zoo, path):
    """JAX build_fast's settings: its model's config for a ViT; for a CNN,
    whether the bf16 backbone override builds (else JAX falls back to
    f32, bench_zoo.py:63-67)."""
    model = jax_zoo.build_fast(path)
    bb = model.cfg.backbone
    mcfg = dict(jax_load_config(os.path.join(jax_zoo.CFG_DIR,
                                             path))['model'])
    if mcfg.get('backbone_type', 'vit') == 'vit':
        return {'dtype': bb.dtype, 'backbone_dtype': bb.dtype,
                'fused_attention': bb.fused_attention,
                'gelu_approx': bb.gelu_approx}
    mcfg['dtype'] = 'bfloat16'
    mcfg['backbone_overrides'] = {**mcfg.get('backbone_overrides', {}),
                                  'dtype': 'bfloat16'}
    try:
        jax_build_model(mcfg)
        backbone_dtype = 'bfloat16'
    except TypeError:
        backbone_dtype = dict(mcfg['backbone_overrides']).get(
            'dtype', 'float32')
    return {'dtype': bb.dtype, 'backbone_dtype': backbone_dtype,
            'fused_attention': False, 'gelu_approx': False}


def _fast_settings(path):
    """The same settings of the port's fast model dict, from its config
    alone (no weights drawn)."""
    backbone_type, over, cfg = _model_parts(bench_zoo.fast_model_dict(path))
    bb = cfg.backbone
    if backbone_type == 'vit':
        return {'dtype': bb.dtype, 'backbone_dtype': bb.dtype,
                'fused_attention': bb.fused_attention,
                'gelu_approx': bb.gelu_approx}
    return {'dtype': bb.dtype,
            'backbone_dtype': over.get('dtype', 'float32'),
            'fused_attention': False, 'gelu_approx': False}


@pytest.mark.parametrize('name', list(bench_zoo.ZOO))
def test_zoo_fast_settings_match_jax_build_fast(jax_zoo, name):
    path = bench_zoo.ZOO[name][0]
    assert _fast_settings(path) == _jax_fast_settings(jax_zoo, path)


@pytest.mark.parametrize('backbone_type', sorted(BACKBONES))
def test_backbone_takes_a_dtype_where_jax_builds_one(backbone_type):
    """backbone_takes reads what JAX learns from a TypeError: the port's
    answer for 'dtype' and for an option no backbone has."""
    for option in ('dtype', 'no_such_option'):
        try:
            jax_build_backbone(backbone_type, **{option: 'bfloat16'})
            jax_takes = True
        except TypeError:
            jax_takes = False
        assert backbone_takes(backbone_type, option) == jax_takes, option


def test_zoo_flops_are_the_analytic_products():
    """measure() counts FLOPs per image with FlopCounterMode over one batch:
    exactly the products of the small ViT, through K1's formula."""
    model = _port_model(_small(make_config, out_channels=17,
                               fused_attention=True),
                        _random_variables(seed=22, out_channels=17))
    imgs_s, flops = bench_zoo.measure(model, 2, 2, 1, torch.device('cpu'))
    assert flops == analytic_flops(SMALL['depth'], SMALL['embed_dim'],
                                   SMALL['num_heads'], (4, 3), (16, 16), 17)
    assert imgs_s > 0


def test_zoo_main_prints_json_lines_and_the_table(monkeypatch, tmp_path,
                                                  capsys):
    monkeypatch.setitem(bench_zoo.ZOO, 'small', (_small_config(tmp_path), 2,
                                                 2))
    out = bench_zoo.main(['--device', 'cpu', '--only', 'small', '--iters',
                          '1'])
    lines = capsys.readouterr().out.splitlines()
    rec = json.loads(lines[0])
    assert list(rec) == ['model', 'imgs_per_sec', 'batch', 'group',
                         'gflops_per_img', 'tflops_per_sec', 'card']
    assert rec['model'] == 'small' and rec['batch'] == rec['group'] == 2
    assert lines[2] == ('| model | batch | imgs/s/card | GFLOP/img '
                        '(FlopCounterMode) | TFLOP/s |')
    assert lines[4].startswith('| small | 2x2 | ')
    assert lines[5] == '(figures on the CPU)'
    assert out['launches']['small'] == {'k1': 0, 'k2': 0}


# --- bench_io ----------------------------------------------------------------

@pytest.fixture(scope='module')
def jpegs(tmp_path_factory):
    port = tmp_path_factory.mktemp('port_jpegs')
    ref = tmp_path_factory.mktemp('jax_jpegs')
    return (bench_io.make_jpegs(str(port), 3),
            _jax_tool('bench_io').make_jpegs(str(ref), 3))


def test_make_jpegs_writes_jaxs_files(jpegs):
    port, ref = jpegs
    assert [os.path.basename(p) for p in port] == [os.path.basename(p)
                                                   for p in ref]
    for a, b in zip(port, ref):
        with open(a, 'rb') as fa, open(b, 'rb') as fb:
            assert fa.read() == fb.read()


def test_eval_loader_batches_match_jax(jpegs):
    paths = jpegs[0]

    class JaxSet:
        db = bench_io.synthetic_records(paths)
        num_joints = 17
        image_size = (256, 192)
        heatmap_size = (64, 48)
        info = JaxDatasetInfo.load('coco')
        dataset_idx = 0
        name = 'synthetic'

    port = TopDownLoader(bench_io.SyntheticSet(paths, (256, 192), (64, 48)),
                         2, is_train=False, canvas_size=640, seed=0)
    ref = JaxTopDownLoader(JaxSet(), 2, is_train=False, canvas_size=640,
                           seed=0)
    pairs = list(zip(port, ref))
    assert len(pairs) == 2
    for got, want in pairs:
        for key in ('imgs', 'center', 'scale', 'rot', 'joints', 'vis',
                    'bbox_id', 'valid'):
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]),
                                          err_msg=key)


def test_io_main_prints_the_rates(capsys):
    out = bench_io.main(['--device', 'cpu', '--n', '4', '--batch', '2',
                         '--iters', '1'])
    text = capsys.readouterr().out
    assert re.search(r'^4 JPEGs, 640x480, avg \d+ KiB$', text, re.M)
    assert re.search(r'^cv2\.imread single-thread : +[\d.]+ imgs/s', text,
                     re.M)
    for mode in ('train', 'eval '):
        assert re.search(rf'^TopDownLoader {mode} batches : +[\d.]+ imgs/s',
                         text, re.M)
    if isinstance(out['native'], str):
        assert f'native loader not built ({out["native"]})' in text
    else:
        assert sorted(out['native']) == [1, 4, 8, 16]


# --- bench_batch_sweep, bench_fused_attention ---------------------------------

def test_batch_sweep_prints_jaxs_lines(capsys):
    out = bench_batch_sweep.main(TINY + ['--batches', '2', '4', '--iters',
                                         '2'])
    lines = capsys.readouterr().out.splitlines()
    assert [int(re.fullmatch(r'batch (\d+): [\d.]+ ms -> \d+ imgs/s on the '
                             r'CPU', x).group(1)) for x in lines] == [2, 4]
    assert list(out) == [2, 4]


def test_fused_attention_prints_jaxs_lines(capsys):
    out = bench_fused_attention.main(TINY + ['--batch', '2', '--iters',
                                             '2'])
    lines = capsys.readouterr().out.splitlines()
    for i, fused in enumerate((False, True)):
        assert re.fullmatch(rf'fused={fused}: first call \d+s on the CPU',
                            lines[2 * i])
        assert re.fullmatch(rf'fused={fused}: [\d.]+ ms/batch -> \d+ '
                            r'imgs/s \(fliptest\) on the CPU', lines[2 * i + 1])
    assert list(out) == ['plain', 'fused']

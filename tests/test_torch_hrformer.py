"""The port's HRFormer (ROADMAP item 12c) against the JAX package on the CPU:
the backbone features and flip-tested heatmaps in eval mode, the
training-mode heatmaps and BN statistics, the converter both ways, two
GenericTopDown train steps, and the two places where a port easily drifts
from JAX's window attention (the mirrored index and the centred pad).

Weights: JAX's variables drawn from a seeded numpy generator in the tree
that JAX's `convert_hrformer` reads off a state dict of the port model's
shapes (tests/test_torch_cnn_ms.py `jax_variables`), every relative-position
bias table from N(0, 0.5), so that a wrong index shows, carried into the
port through `cnn_state_dict_from_flax` with strict=True.

Sizes: 64x48 crops, whose four branches are 16x12, 8x6, 4x3 and 2x2: with
the window of 7, 16 pads 2 rows before and 3 after, 12 pads 1 and 1, 6 pads
0 and 1, 4 pads 1 and 2, 3 pads 2 and 2. Width 16 (heads 1, 2, 4, 8: head
dim 16), one module per stage, one block per branch. The JAX reference of
the forwards is one program compiled at XLA level 0. The train steps run
one stage (branches 16x12 and 8x6) in f32 on both sides, JAX at level 0:
with at least 96 values per BN channel in a batch of 2, f32 statistics keep
their digits here (PRs 11-12 ran their steps in float64 for BN over 2x2
maps; this step passes in f64 too, at twice JAX's compile time).

Tolerances: heatmaps and features within 1e-4 of JAX's largest output (the
issue's bound; measured 6e-7 of it); BN statistics 1e-4 relative plus 1e-5
absolute; the converters exact; the train steps as
tests/test_torch_cnn.py's `assert_train_steps_match`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.models import hrformer as jhrformer
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.utils.cnn_ckpt import convert_hrformer

from test_torch_cnn import (FLIP, TRAIN_OPTIM, assert_train_steps_match,
                            jax_flip_test, jax_train_steps)
from test_torch_cnn_more_paths import train_batch
from test_torch_cnn_ms import (crops, jax_variables,  # noqa: F401
                               one_torch_thread, port_model)
from test_torch_models import _compile_fast
from vitpose_tpu_torch.models import hrformer
from vitpose_tpu_torch.models.topdown import GenericTopDown, forward, infer
from vitpose_tpu_torch.utils.convert import cnn_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

HW = (64, 48)
SMALL = dict(width=16, stage_modules=(1, 1, 1), num_heads=(1, 2, 4, 8),
             blocks_per_module=1)
MDICT = dict(backbone_type='hrformer', backbone_overrides=SMALL,
             img_size=HW, out_channels=17, deconv_filters=(),
             shift_heatmap=True, use_udp=False)
# the train steps' model: one stage of two branches, 16x12 and 8x6 (JAX's
# step of two stages takes 10 s to trace and compile in f32, 16 s in f64;
# the forward tests hold the downsampling links and transitions in both
# modes)
TRAIN_MDICT = dict(MDICT, backbone_overrides=dict(SMALL,
                                                  stage_modules=(1,)))
OPTIM = dict(TRAIN_OPTIM, base_lr=1e-5)


def rel(got, want):
    """max |got - want| over JAX's largest |output|."""
    return np.abs(np.asarray(got) - np.asarray(want)).max() \
        / np.abs(np.asarray(want)).max()


def hrformer_variables(mdict, seed):
    """jax_variables with every bias table drawn from N(0, 0.5)."""
    v = jax_variables(mdict, seed)
    rng = np.random.default_rng(100 + seed)

    def fill(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                fill(leaf)
            elif key == 'rel_pos_bias_table':
                tree[key] = rng.normal(0.0, 0.5, leaf.shape).astype(
                    np.float32)

    fill(v['params'])
    return v


def jax_program(mdict, variables, x):
    """JAX's (backbone features NHWC, heatmaps of x and its mirror in eval
    mode, the same in training mode, the mutated batch_stats), one
    program at XLA level 0."""
    jm = jax_build(mdict)

    def fn(v, x):
        x2 = jnp.concatenate([x, x[:, :, ::-1]])
        hm, state = jm.apply(v, x2, capture_intermediates=(
            lambda mdl, _: mdl.name == 'backbone'))
        (feat,) = state['intermediates']['backbone']['__call__']
        train_hm, mutated = jm.apply(v, x2, train=True,
                                     mutable=['batch_stats'])
        return feat[:x.shape[0]], hm, train_hm, mutated

    return jm, _compile_fast(fn, variables, jnp.asarray(x))


@pytest.fixture(scope='module')
def case():
    """(port model, crops, JAX variables, JAX backbone features, JAX
    flip-tested heatmaps, JAX training-mode heatmaps, JAX batch_stats after
    the training-mode pass)."""
    v = hrformer_variables(MDICT, seed=0)
    x = crops(HW, seed=10)
    jm, (feat, hm, train_hm, mutated) = jax_program(MDICT, v, x)
    return (port_model(MDICT, v), x, v, np.asarray(feat),
            jax_flip_test(jm.cfg, hm, len(x)), np.asarray(train_hm),
            jax.tree.map(np.asarray, mutated))


def test_eval_forward_matches_jax(case):
    model, x, _, feat, ref, _, _ = case
    assert isinstance(model, GenericTopDown)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(x))
    assert got.shape == (1, 16, 16, 12) and got.dtype == torch.float32
    assert rel(got.permute(0, 2, 3, 1).numpy(), feat) <= 1e-4
    hm = infer(model, torch.from_numpy(x), flip_index=torch.from_numpy(FLIP))
    assert hm.shape == ref.shape == (1, 17, 16, 12)
    assert rel(hm.detach().numpy(), ref) <= 1e-4


def test_training_forward_and_bn_statistics_match_jax(case):
    """The crops and their mirror in training mode: heatmaps on the batch's
    statistics, and every BN's running statistics after the pass."""
    model, x, v, _, _, ref, mutated = case
    x2 = torch.from_numpy(np.concatenate([x, x[:, :, ::-1]]))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    try:
        with torch.no_grad():
            hm = forward(model, x2, train=True)
        assert rel(hm.numpy(), ref) <= 1e-4
        want = cnn_state_dict_from_flax(
            {'params': v['params'], **mutated}, 'hrformer')
        moved = 0
        for name, t in model.state_dict().items():
            if 'running' in name:
                np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=name)
                moved += not torch.equal(t, before[name])
        assert moved > 50
    finally:
        model.load_state_dict(before)
        model.eval()


def test_converter_is_exact_both_ways(case):
    """JAX's convert_hrformer of the port's state dict gives the variables
    back, and the port's converter of them the state dict, every entry
    equal; a stored mmpose `relative_position_index` is dropped on load."""
    model, _, v, _, _, _, _ = case
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    bb = {k[len('backbone.'):]: a for k, a in sd.items()
          if k.startswith('backbone.')}
    params, stats = convert_hrformer(bb)
    flat_p = dict(_leaves(params))
    assert flat_p.keys() == dict(_leaves(v['params']['backbone'])).keys()
    for path, a in _leaves(v['params']['backbone']):
        np.testing.assert_array_equal(flat_p[path], a, err_msg=path)
    for path, a in _leaves(v['batch_stats']['backbone']):
        np.testing.assert_array_equal(dict(_leaves(stats))[path], a)
    back = cnn_state_dict_from_flax(v, 'hrformer')
    assert back.keys() == sd.keys()
    for k, t in back.items():
        np.testing.assert_array_equal(t.numpy(), sd[k], err_msg=k)
    name = 'backbone.stage2.0.branches.0.0.attn.attn.relative_position_index'
    extra = dict(model.state_dict(), **{name: torch.zeros(49, 49)})
    model.load_state_dict(extra, strict=True)


def _leaves(tree, prefix=''):
    for k, a in tree.items():
        if isinstance(a, dict):
            yield from _leaves(a, f'{prefix}{k}/')
        else:
            yield prefix + k, np.asarray(a)


def test_window_index_and_pads_follow_jax(case, monkeypatch):
    """The lookup index is JAX's, columns mirrored, and the pads are
    centred. A port with Swin's usual index (no mirror) or with its pad
    all after the map lies far outside the eval test's bound."""
    np.testing.assert_array_equal(hrformer.rel_position_index(7, 7),
                                  jhrformer._rel_position_index(7, 7))
    x = torch.arange(1, 16 * 12 + 1, dtype=torch.float32).reshape(
        1, 16, 12, 1)
    win, padded, pads = hrformer.window_partition(x, 7)
    assert padded == (21, 14) and pads == (5, 2)
    # 2 rows before and 3 after, 1 column before and 1 after
    first = win[0, :, 0].reshape(7, 7)
    assert (first[:2] == 0).all() and (first[:, 0] == 0).all()
    assert first[2, 1] == 1.0 and first[3, 1] == 13.0
    np.testing.assert_array_equal(
        hrformer.window_merge(win, 7, padded, (16, 12), pads, 1).numpy(),
        x.numpy())
    model, x, _, _, ref, _, _ = case

    def flip_test():
        for m in model.modules():
            if isinstance(m, hrformer.WindowMSA):
                m._index.clear()
        with torch.no_grad():
            return infer(model, torch.from_numpy(x),
                         flip_index=torch.from_numpy(FLIP)).numpy()

    swin = hrformer.rel_position_index(7, 7)[:, ::-1].copy()
    monkeypatch.setattr(hrformer, 'rel_position_index', lambda h, w: swin)
    assert rel(flip_test(), ref) > 1e-2
    monkeypatch.undo()
    partition = hrformer.window_partition

    def pad_after(x, ws):
        n, h, w, c = x.shape
        ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
        win, padded, _ = partition(
            torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph)), ws)
        return win, padded, (0, 0)

    monkeypatch.setattr(hrformer, 'window_partition', pad_after)
    assert rel(flip_test(), ref) > 1e-2
    monkeypatch.undo()
    assert rel(flip_test(), ref) <= 1e-4


def test_train_steps_match_jax():
    """Two MSRA-target joints-MSE steps of GenericTopDown over the one-stage
    HRFormer (BN in training mode, the global-norm clip, AdamW)."""
    v = hrformer_variables(TRAIN_MDICT, seed=1)
    model = port_model(TRAIN_MDICT, v)
    batch = train_batch(model, HW, seed=31)
    ref = jax_train_steps(TRAIN_MDICT, v, batch, OPTIM)
    assert_train_steps_match(model, batch, ref, 'hrformer', optim=OPTIM)

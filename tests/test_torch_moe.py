"""The port's ViTPose+ model, train step and checkpoints against the JAX
package on the CPU: `MoEMlp`, the MoE `ViT`, `TopDownModel` with associate
heads (mixed experts in one batch, `head_idx`, `all_heads`, the flip test),
two steps of `make_moe_train_step`, the expert split of a dense
`pretrained` backbone, `split_moe_experts`, `merge_moe_expert`,
`model_split` and a ViTPose+ `best.pth` read by the JAX package.

The model is the small one of tests/test_torch_models.py (64x48 crops,
width 32, depth 2, 4 heads) with 3 experts of part_dim 8 and two associate
heads (5 joints in the main head, then 3 and 6), in f32, with the same
numpy variables on both sides. JAX references compile at XLA CPU
optimisation level 0.

Tolerances: model outputs 1e-5 absolute plus 1e-5 relative; the two steps:
every loss_d, heatmap_loss and grad_norm 1e-5 relative, and every parameter
and BN statistic after each step 1e-5 absolute plus 1e-4 relative, as
tests/test_torch_train.py's trajectory (an Adam step moves an element by
lr * m_hat / (sqrt(v_hat) + 1e-8): a gradient at f32 rounding level moves it
by a tiny fraction of lr, here <= 1e-3).
"""
import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import infer as jax_infer
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.models.vit import MoEMlp as JaxMoEMlp
from vitpose_tpu.models.vit import ViT as JaxViT
from vitpose_tpu.train import optim as joptim
from vitpose_tpu.train.state import create_train_state as jax_create_state
from vitpose_tpu.train.step import make_moe_train_step as jax_moe_step
from vitpose_tpu.utils import torch_ckpt as jckpt

from test_torch_ckpt import _mae_state_dict
from test_torch_data import ROOT
from test_torch_models import SMALL, _compile_fast, _crops, _fill, _small
from test_torch_train import TRAJ_OPTIM, _joints, _t
from vitpose_tpu_torch.models import TopDownModel, forward, infer, make_config
from vitpose_tpu_torch.models.vit import MoEMlp, ViT, expert_routing
from vitpose_tpu_torch.ops import target as ttarget
from vitpose_tpu_torch.tools import model_split
from vitpose_tpu_torch.train import (OptimConfig, create_train_state,
                                     layer_decay_adamw, make_moe_train_step)
from vitpose_tpu_torch.train import loop
from vitpose_tpu_torch.utils import torch_ckpt
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
EXPERTS, PART = 3, 8
HEADS = (5, 3, 6)                     # main, then the associate heads
MIXED = np.array([2, 0, 1, 2])        # one batch of four, three experts


def _moe(make, heads=HEADS, **backbone):
    cfg = _small(make, out_channels=heads[0], num_experts=EXPERTS,
                 part_dim=PART, **backbone)
    return dataclasses.replace(cfg, num_extra_heads=len(heads) - 1,
                               extra_head_channels=heads[1:])


def _moe_variables(seed, heads=HEADS, **backbone):
    module = JaxTopDown(_moe(jax_make_config, heads, **backbone))
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 48, 3)),
                            expert_idx=jnp.zeros(1, jnp.int32),
                            all_heads=True))
    return _fill(shapes, seed)


def _port(variables, **backbone):
    model = TopDownModel(_moe(make_config, **backbone)).eval()
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


@pytest.fixture(scope='module')
def moe_refs():
    """(crops, variables, the JAX outputs of one program)."""
    x = _crops(21, n=4)
    v = _moe_variables(22)
    jm = JaxTopDown(_moe(jax_make_config))
    bb = v['params']['backbone']
    mlp = JaxMoEMlp(4 * SMALL['embed_dim'], SMALL['embed_dim'], EXPERTS,
                    PART)
    tokens = np.random.RandomState(23).randn(4, 12, 32).astype(np.float32)

    def fn(v, x, tokens, idx):
        out = {'mlp': mlp.apply({'params': bb['blocks_0']['mlp']}, tokens,
                                idx),
               'mlp_one': mlp.apply({'params': bb['blocks_0']['mlp']},
                                    tokens, jnp.full(4, 1)),
               'vit': JaxViT(jm.cfg.backbone).apply(
                   {'params': v['params']['backbone']}, x, expert_idx=idx),
               'all': jm.apply(v, x, expert_idx=idx, all_heads=True)}
        for h in range(len(HEADS)):
            out[f'head{h}'] = jm.apply(v, x, expert_idx=idx, head_idx=h)
        out['infer'] = jax_infer(jm, v, x, flip_index=np.array([0, 2, 1]),
                                 expert_idx=idx, head_idx=1)
        return out

    return x, tokens, v, _compile_fast(fn, v, jnp.asarray(x),
                                       jnp.asarray(tokens),
                                       jnp.asarray(MIXED))


def test_moe_mlp_matches_jax(moe_refs):
    _, tokens, v, refs = moe_refs
    model = _port(v)
    mlp = model.backbone.blocks[0].mlp
    assert isinstance(mlp, MoEMlp)
    x = torch.from_numpy(tokens)
    with torch.no_grad():
        mixed = mlp(x, torch.float32, expert_routing(MIXED, 4, EXPERTS, 'cpu'))
        one = mlp(x, torch.float32, expert_routing(1, 4, EXPERTS, 'cpu'))
    np.testing.assert_allclose(mixed.numpy(), np.asarray(refs['mlp']), **TOL)
    np.testing.assert_allclose(one.numpy(), np.asarray(refs['mlp_one']),
                               **TOL)


def test_moe_vit_and_heads_match_jax(moe_refs):
    x, _, v, refs = moe_refs
    model = _port(v)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        feat = model.backbone(xt, expert_idx=MIXED)
        outs = forward(model, xt, expert_idx=list(MIXED), all_heads=True)
        heads = [model(xt, expert_idx=MIXED, head_idx=h)
                 for h in range(len(HEADS))]
        flipped = infer(model, xt, flip_index=np.array([0, 2, 1]),
                        expert_idx=MIXED, head_idx=1)
    np.testing.assert_allclose(feat.numpy(), np.asarray(refs['vit']), **TOL)
    assert [o.shape[1] for o in outs] == list(HEADS)
    for h in range(len(HEADS)):
        np.testing.assert_allclose(outs[h].numpy(),
                                   np.asarray(refs['all'][h]), **TOL)
        np.testing.assert_allclose(heads[h].numpy(),
                                   np.asarray(refs[f'head{h}']), **TOL)
    np.testing.assert_allclose(flipped.numpy(), np.asarray(refs['infer']),
                               **TOL)


def test_experts_change_the_output(moe_refs):
    x, _, v, _ = moe_refs
    model = _port(v)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        outs = [model.backbone(xt, expert_idx=e) for e in range(EXPERTS)]
        mixed = model.backbone(xt, expert_idx=MIXED)
    for a in range(EXPERTS):
        for b in range(a + 1, EXPERTS):
            assert (outs[a] - outs[b]).abs().max() > 1e-3
    for i, e in enumerate(MIXED):
        np.testing.assert_allclose(mixed[i].numpy(), outs[e][i].numpy(),
                                   **TOL)
    for bad in (None, 3, [0, 1], np.array([0, 1, 2, -1])):
        with pytest.raises(ValueError, match='expert_idx'):
            model.backbone(xt, expert_idx=bad)
    # indices on a device would be read back from it: the caller passes
    # them on the host
    with pytest.raises(TypeError, match='expert_idx'):
        model.backbone(xt, expert_idx=torch.from_numpy(MIXED))


def test_state_dict_carries_the_mmpose_names(moe_refs):
    """Stacked parameters in the module, per-expert mmpose entries in its
    state dicts, both ways; a state dict with an expert missing fails a
    strict load."""
    _, _, v, _ = moe_refs
    model = _port(v)
    names = {n for n, _ in model.named_parameters()}
    assert 'backbone.blocks.1.mlp.expert_weight' in names
    assert not any('.experts.' in n for n in names)
    sd = model.state_dict()
    assert not any('expert_weight' in k or 'expert_bias' in k for k in sd)
    kernel = v['params']['backbone']['blocks_1']['mlp']['expert_kernel']
    for e in range(EXPERTS):
        w = sd[f'backbone.blocks.1.mlp.experts.{e}.weight']
        assert w.shape == (PART, 4 * SMALL['embed_dim'])
        np.testing.assert_array_equal(w.numpy(), kernel[e].T)
    assert sd['associate_keypoint_heads.1.final_layer.weight'].shape[0] == 6
    del sd['backbone.blocks.0.mlp.experts.2.bias']
    with pytest.raises(RuntimeError, match='experts.2.bias|expert_bias'):
        _port(v).load_state_dict(sd)


# --- the MoE step ------------------------------------------------------------

# step 1 selects experts 0 and 1 (expert 2 moves by decay alone), step 2
# experts 0 and 2 (expert 1 by its Adam state and decay); dataset 1 is
# absent from step 2, so loss_1 is exactly 0 there
STEP_IDX = (np.array([0, 1, 1, 0]), np.array([2, 0, 2, 0]))
MOE_OPTIM = dict(TRAJ_OPTIM, weight_decay=0.5)


def _step_batches():
    rng = np.random.RandomState(31)
    out = []
    for idx in STEP_IDX:
        imgs = rng.randn(4, 64, 48, 3).astype(np.float32)
        joints, vis = _joints(int(rng.randint(100)), n=4, k=max(HEADS),
                              lo=0.0, hi=48.0)
        target, weight = ttarget.generate_udp_heatmaps(
            _t(joints), _t(vis), (48, 64), (12, 16))
        out.append({'imgs': imgs, 'target': target.numpy(),
                    'target_weight': weight.numpy(), 'dataset_idx': idx})
    return out


@pytest.fixture(scope='module')
def jax_moe_steps():
    """(batches, variables, [(metrics, variables) after each step])."""
    jm = JaxTopDown(_moe(jax_make_config, drop_path_rate=0.0))
    v = _moe_variables(32, drop_path_rate=0.0)
    batches = _step_batches()
    tx = joptim.layer_decay_adamw(v['params'],
                                  joptim.OptimConfig(**MOE_OPTIM), 1)
    state = jax_create_state(jm, jax.random.PRNGKey(0), batches[0]['imgs'],
                             tx, variables=v)
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    step = jax.jit(jax_moe_step(jm, len(HEADS))).lower(
        state, jb[0], jax.random.PRNGKey(1)).compile(
            compiler_options={'xla_backend_optimization_level': 0})
    out = []
    for b in jb:
        state, metrics = step(state, b, jax.random.PRNGKey(1))
        out.append((jax.tree.map(np.asarray, metrics),
                    {'params': jax.tree.map(np.asarray, state.params),
                     'batch_stats': jax.tree.map(np.asarray,
                                                 state.batch_stats)}))
    return batches, v, out


def test_moe_train_step_matches_jax(jax_moe_steps):
    batches, v, ref = jax_moe_steps
    model = _port(v, drop_path_rate=0.0)
    cfg = OptimConfig(**MOE_OPTIM)
    state = create_train_state(model, layer_decay_adamw(model, cfg, 1),
                               cfg.grad_clip_norm)
    decays = {p: g['weight_decay'] > 0
              for g in state.optimizer.param_groups for p in g['params']}
    mlp = model.backbone.blocks[0].mlp
    assert decays[mlp.expert_bias] and decays[mlp.expert_weight]
    assert not decays[mlp.fc2.bias]
    step = make_moe_train_step(model, len(HEADS))
    gen = torch.Generator()
    before = mlp.expert_weight.detach().clone()
    for i, (batch, (ref_metrics, ref_vars)) in enumerate(zip(batches, ref)):
        tb = {k: (_t(x) if k != 'dataset_idx' else x)
              for k, x in batch.items()}
        metrics = step(state, tb, gen)
        assert set(metrics) == set(ref_metrics) == {
            'loss_0', 'loss_1', 'loss_2', 'heatmap_loss', 'grad_norm'}
        for key, value in ref_metrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(value),
                                       rtol=1e-5, err_msg=f'step {i} {key}')
        expected = state_dict_from_flax(ref_vars)
        for name, value in model.state_dict().items():
            if 'num_batches' in name:
                continue
            np.testing.assert_allclose(value.numpy(),
                                       expected[name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f'step {i} {name}')
        # every expert moves on every step: the unselected ones by decay
        # (and, after step 1, their Adam state)
        after = mlp.expert_weight.detach().clone()
        assert all((after[e] != before[e]).any() for e in range(EXPERTS))
        before = after
    assert float(metrics['loss_1']) == 0.0
    head = model.associate_keypoint_heads[0]
    assert all(p.grad is not None and not p.grad.any()
               for p in head.parameters())
    with pytest.raises(ValueError, match='num_datasets'):
        make_moe_train_step(model, 2)(state, tb, gen)


# --- checkpoints --------------------------------------------------------------

def _dense_backbone(tmp_path):
    """A dense backbone .pth of the small model's width and depth at its
    own geometry (patch 16, 4x3 grid)."""
    path = str(tmp_path / 'dense.pth')
    mae = _mae_state_dict(41, grid=4, patch=16)
    mae['pos_embed'] = mae['pos_embed'][:, :13]
    torch.save({'model': mae}, path)
    return path, mae


def test_pretrained_split_matches_jax_and_keeps_the_dense_features(tmp_path):
    """Each expert starts as the last part_dim rows of the dense fc2, so
    every expert's backbone features equal the dense backbone's."""
    path, mae = _dense_backbone(tmp_path)
    jcfg = _moe(jax_make_config)
    ref = jckpt.convert_backbone_checkpoint(path, jcfg, num_experts=EXPERTS,
                                            part_dim=PART)
    sd = torch_ckpt.convert_backbone_checkpoint(path, _moe(make_config)
                                                .backbone)
    carried = jckpt.convert_backbone({k: t.numpy() for k, t in sd.items()})
    flat = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(jax.tree_util.tree_leaves(carried))
    got = dict(jax.tree_util.tree_leaves_with_path(carried))
    for key, leaf in flat:
        np.testing.assert_array_equal(got[key], np.asarray(leaf), str(key))
    moe = TopDownModel(_moe(make_config)).eval()
    loop.load_pretrained(moe, path)
    dense = ViT(dataclasses.replace(_moe(make_config).backbone,
                                    num_experts=0, part_dim=0)).eval()
    dense.load_state_dict(torch_ckpt.convert_backbone_checkpoint(
        path, dense.cfg), strict=False)
    x = torch.from_numpy(_crops(42))
    with torch.no_grad():
        want = dense(x)
        for e in range(EXPERTS):
            np.testing.assert_allclose(moe.backbone(x, expert_idx=e).numpy(),
                                       want.numpy(), **TOL)
    np.testing.assert_array_equal(
        moe.state_dict()['backbone.blocks.1.mlp.experts.2.weight'].numpy(),
        mae['blocks.1.mlp.fc2.weight'][-PART:].numpy())


def _jax_model_split():
    spec = importlib.util.spec_from_file_location(
        'jax_model_split', os.path.join(ROOT, 'tools', 'model_split.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_split_merge_and_model_split_match_jax(moe_refs):
    _, _, v, _ = moe_refs
    sd = _port(v).state_dict()
    npsd = {k: t.numpy() for k, t in sd.items()}
    backbone = {k[len('backbone.'):]: t for k, t in sd.items()
                if k.startswith('backbone.') and '.experts.' not in k}
    dense = {k: t for k, t in backbone.items()}
    for i in range(SMALL['depth']):
        for p in ('weight', 'bias'):
            dense[f'blocks.{i}.mlp.fc2.{p}'] = torch.cat(
                [backbone[f'blocks.{i}.mlp.fc2.{p}'],
                 sd[f'backbone.blocks.{i}.mlp.experts.1.{p}']])
    split = torch_ckpt.split_moe_experts(dense, EXPERTS, PART, 2)
    ref = jckpt.split_moe_experts({k: t.numpy() for k, t in dense.items()},
                                  EXPERTS, PART, 2)
    assert set(split) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(split[k].numpy(), ref[k], k)
    for e in range(EXPERTS):
        merged = torch_ckpt.merge_moe_expert(sd, e, 2)
        want = jckpt.merge_moe_expert(npsd, e, 2)
        assert set(merged) == set(want)
        for k in want:
            np.testing.assert_array_equal(merged[k].numpy(), want[k], k)
    jax_split = _jax_model_split()
    for i, k in enumerate((17, 3, 6)):
        out = model_split.split_one(sd, i, k, 2)
        want = jax_split.split_one(npsd, i, k, 2)
        assert set(out) == set(want)
        for name in want:
            np.testing.assert_array_equal(out[name].numpy(), want[name],
                                          name)


def test_moe_best_pth_reads_in_jax(moe_refs, tmp_path):
    """The port's ViTPose+ state dict saved as a .pth: the JAX package's
    convert_topdown_checkpoint gives its heatmaps."""
    x, _, v, _ = moe_refs
    path = str(tmp_path / 'best.pth')
    torch.save(_port(v).state_dict(), path)
    jm = JaxTopDown(_moe(jax_make_config))
    jv = jckpt.convert_topdown_checkpoint(path, jm.cfg)
    out = _compile_fast(
        lambda jv, x, idx: jm.apply(jv, x, expert_idx=idx, all_heads=True),
        jv, jnp.asarray(x), jnp.asarray(MIXED))
    with torch.no_grad():
        port = forward(_port(v), torch.from_numpy(x), expert_idx=MIXED,
                       all_heads=True)
    for h in range(len(HEADS)):
        np.testing.assert_allclose(np.asarray(out[h]), port[h].numpy(), **TOL)

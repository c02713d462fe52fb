"""The port's training checkpoints and its loading of weights into a model
about to train, on the CPU.

  * `CheckpointManager` (its own, as the JAX one is orbax's): the newest
    `max_to_keep` epochs, best-metric tracking in both directions, a work
    dir whose tracked metric changed, restore of the whole train state bit
    for bit, and `best.pth`, which torch.load(weights_only=True), the port's
    `init_pose_model` and the JAX package's `load_checkpoint_variables`
    read.
  * `pretrained` (a backbone-only MAE checkpoint at another grid and patch
    size) and `load_from` (a whole model with another number of joints, as
    the JAX package's .npz and as a .pth) against the JAX package's
    conversions and merges: the same entries skipped, and the same outputs
    within 1e-4, the f32 model tolerance of tests/test_torch_models.py.

The model is the small one of tests/test_torch_models.py.
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.api.inference import load_checkpoint_variables
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.models.vit import ViT as JaxViT
from vitpose_tpu.train.loop import _merge_trees, _merge_trees_checked
from vitpose_tpu.utils import torch_ckpt as jckpt
from vitpose_tpu.utils.checkpoint import save_params_npz

from test_torch_models import (SMALL, TOL, _compile_fast, _crops,
                               _port_model, _random_variables, _small)
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.models import make_config
from vitpose_tpu_torch.train import (OptimConfig, create_train_state,
                                     layer_decay_adamw, make_train_step)
from vitpose_tpu_torch.train import loop
from vitpose_tpu_torch.utils.checkpoint import CheckpointManager
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401


def _train_state(seed=0):
    model = _port_model(_small(make_config), _random_variables(seed))
    cfg = OptimConfig(num_layers=SMALL['depth'], warmup_iters=2)
    return create_train_state(model, layer_decay_adamw(model, cfg, 2),
                              cfg.grad_clip_norm)


def _step(state, seed):
    """One training step on a seeded random batch."""
    rng = np.random.RandomState(seed)
    batch = {'imgs': torch.from_numpy(_crops(seed)),
             'target': torch.from_numpy(rng.rand(2, 5, 16, 12)
                                        .astype(np.float32)),
             'target_weight': torch.ones(2, 5)}
    make_train_step(state.model)(state, batch, torch.Generator())


def _clone(sd):
    return {k: v.clone() for k, v in sd.items()}


def assert_same_tensors(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


CASES = {'AP': ([0.2, 0.5, 0.4, 0.1, 0.45], 1, 'max'),
         'NME': ([0.3, 0.1, 0.2, 0.4, 0.15], 1, 'min')}


@pytest.mark.parametrize('metric', sorted(CASES))
def test_keeps_the_newest_and_the_best(tmp_path, metric):
    values, best, mode = CASES[metric]
    state = _train_state()
    mgr = CheckpointManager(str(tmp_path), save_best_metric=metric)
    assert mgr.mode == mode and mgr.latest_epoch() is None
    weights = []
    for epoch, v in enumerate(values):
        _step(state, epoch)
        weights.append(_clone(state.model.state_dict()))
        mgr.save(epoch, state, metrics={metric: v, 'other': 1.0})
    assert mgr.epochs() == [2, 3, 4] and mgr.latest_epoch() == 4
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith('info')) \
        == [f'info_{e}.json' for e in range(5)]
    assert mgr.load_info(3) == {'epoch': 3, 'meta': {},
                                'metrics': {metric: values[3],
                                            'other': 1.0}}
    assert mgr.load_info(7) is None
    with open(tmp_path / 'meta.json') as f:
        meta = json.load(f)
    assert meta['best_value'] == values[best] and meta['best_epoch'] == best
    assert meta['metric'] == metric and meta['mode'] == mode
    assert_same_tensors(mgr.restore_best(), weights[best])


def test_a_stored_best_is_adopted_only_for_the_same_metric(tmp_path):
    state = _train_state()
    CheckpointManager(str(tmp_path)).save(0, state, metrics={'AP': 0.5})
    assert CheckpointManager(str(tmp_path)).best_value == 0.5
    nme = CheckpointManager(str(tmp_path), save_best_metric='NME')
    assert nme.best_value == np.inf
    best = _clone(nme.restore_best())
    _step(state, 1)
    CheckpointManager(str(tmp_path)).save(1, state, metrics={'AP': 0.4})
    assert_same_tensors(CheckpointManager(str(tmp_path)).restore_best(),
                        best)                          # 0.4 < 0.5: kept
    nme.save(2, state, metrics={'NME': 0.9})
    with open(tmp_path / 'meta.json') as f:
        assert json.load(f)['metric'] == 'NME'


def test_restore_brings_back_the_whole_state(tmp_path):
    """Parameters, BN statistics, AdamW's moments and step counts, the
    schedule's position (so the next step's lr) and the step, bit for
    bit, into a fresh state; a preemption save's meta."""
    state = _train_state()
    for i in range(3):
        _step(state, i)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, meta={'completed': False})
    model = _clone(state.model.state_dict())
    opt = state.optimizer.state_dict()
    moments = {k: {n: t.clone() for n, t in v.items()}
               for k, v in opt['state'].items()}
    lrs = [g['lr'] for g in state.optimizer.param_groups]

    fresh = _train_state(seed=5)
    fresh, epoch = mgr.restore(fresh)
    assert epoch == 0 and fresh.step == state.step == 3
    assert mgr.load_info(0)['meta'] == {'completed': False}
    assert_same_tensors(fresh.model.state_dict(), model)
    got = fresh.optimizer.state_dict()['state']
    assert list(got) == list(moments)
    for k in moments:
        assert_same_tensors(got[k], moments[k])
    assert [g['lr'] for g in fresh.optimizer.param_groups] == lrs
    assert fresh.scheduler.state_dict() == state.scheduler.state_dict()
    _step(state, 9)
    _step(fresh, 9)
    assert_same_tensors(fresh.model.state_dict(), state.model.state_dict())
    assert CheckpointManager(str(tmp_path / 'none')).restore(fresh) \
        == (fresh, None)


def test_best_pth_loads_in_both_packages(tmp_path):
    state = _train_state()
    _step(state, 0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state, metrics={'AP': 0.3})
    path = str(tmp_path / 'best.pth')
    sd = torch.load(path, map_location='cpu', weights_only=True)
    assert_same_tensors(sd, state.model.state_dict())
    pm = init_pose_model(_small(make_config), checkpoint=path, device='cpu')
    assert_same_tensors(pm.model.state_dict(), sd)
    jv = load_checkpoint_variables(path, topdown_cfg=_small(jax_make_config))
    carried = state_dict_from_flax(jax.tree.map(np.asarray, jv))
    for k, v in carried.items():
        if 'num_batches' not in k:
            assert torch.equal(v, sd[k]), k


# --- pretrained and load_from ----------------------------------------------

def _mae_state_dict(seed, grid=5, patch=14):
    """A backbone-only MAE-style checkpoint of the small width and depth at
    a `grid` x `grid` token grid with `patch` x `patch` patches, with the
    entries the fine-tuning model has not (cls_token, the final `norm`, a
    decoder) and none of its last_norm."""
    rng = np.random.RandomState(seed)
    d, h = SMALL['embed_dim'], 4 * SMALL['embed_dim']
    shapes = {'cls_token': (1, 1, d), 'pos_embed': (1, grid * grid + 1, d),
              'patch_embed.proj.weight': (d, 3, patch, patch),
              'patch_embed.proj.bias': (d,), 'norm.weight': (d,),
              'norm.bias': (d,), 'decoder_embed.weight': (16, d)}
    for i in range(SMALL['depth']):
        for name, shape in (('norm1', (d,)), ('norm2', (d,)),
                            ('attn.qkv', (3 * d, d)), ('attn.proj', (d, d)),
                            ('mlp.fc1', (h, d)), ('mlp.fc2', (d, h))):
            shapes[f'blocks.{i}.{name}.weight'] = shape
            shapes[f'blocks.{i}.{name}.bias'] = shape[:1]
    return {k: torch.from_numpy(0.1 * rng.randn(*s).astype(np.float32))
            for k, s in shapes.items()}


def test_pretrained_matches_jax(tmp_path):
    """The MAE kernel padded 14 -> 16 and the 5x5 pos embed regridded to
    the model's 4x3: the same backbone output as the JAX package's
    convert_backbone_checkpoint merged into its init. The same weights as
    a MoBY file ('encoder.' prefix) load the same; a file without backbone
    entries raises."""
    path = str(tmp_path / 'mae.pth')
    mae = _mae_state_dict(0)
    torch.save({'model': mae}, path)
    moby = str(tmp_path / 'moby.pth')
    torch.save({'state_dict': {f'encoder.{k}': v for k, v in mae.items()}},
               moby)
    empty = str(tmp_path / 'empty.pth')
    torch.save({'model': {'head.weight': torch.zeros(2)}}, empty)
    v = _random_variables(3)
    bb = jckpt.convert_backbone_checkpoint(path, _small(jax_make_config))
    params = _merge_trees(v['params']['backbone'], bb)
    x = _crops(4)
    jvit = JaxViT(_small(jax_make_config).backbone)
    ref = _compile_fast(lambda p, x: jvit.apply({'params': p}, x), params,
                        jnp.asarray(x))

    model = _port_model(_small(make_config), v)
    init = _clone(model.state_dict())
    loop.load_pretrained(model, path)
    with torch.no_grad():
        out = model.backbone(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    sd = model.state_dict()
    assert torch.equal(sd['backbone.blocks.1.mlp.fc2.weight'],
                       mae['blocks.1.mlp.fc2.weight'])
    assert torch.equal(sd['backbone.last_norm.weight'],
                       init['backbone.last_norm.weight'])
    assert not torch.equal(sd['backbone.pos_embed'],
                           init['backbone.pos_embed'])
    assert sd['backbone.patch_embed.proj.weight'].shape[-1] == 16
    other = _port_model(_small(make_config), v)
    loop.load_pretrained(other, moby)
    for k, t in other.state_dict().items():
        assert torch.equal(t, sd[k]), k
    with pytest.raises(ValueError, match='no ViT backbone entries'):
        loop.load_pretrained(other, empty)


def _flax_names(variables):
    """{port name: the JAX merge's path ('/head/final/kernel')} of every
    carried entry, found by carrying leaves that hold their own index."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(variables)
    # the merge runs per collection: its paths leave 'params' out
    paths = ['/' + '/'.join(p.key for p in path[1:]) for path, _ in flat]
    leaves = [x for _, x in flat]
    out = {}
    marked = jax.tree.unflatten(treedef, [np.full(x.shape, i, np.float32)
                                          for i, x in enumerate(leaves)])
    for name, t in state_dict_from_flax(marked).items():
        if 'num_batches' not in name:
            out[name] = paths[int(t.flatten()[0])]
    return out


def _skipped(text):
    return sorted(re.findall(r'load_from: skipping (\S+)', text))


@pytest.mark.parametrize('fmt', ['npz', 'pth'])
def test_load_from_matches_jax(tmp_path, capsys, fmt):
    """A 14-joint donor into a 17-joint model: the head's final conv stays
    at its init on both sides and everything else comes from the donor;
    the same entries are reported skipped and the heatmaps agree."""
    donor = _random_variables(7, out_channels=14)
    path = str(tmp_path / f'donor.{fmt}')
    if fmt == 'npz':
        save_params_npz(path, donor)
    else:
        torch.save(state_dict_from_flax(donor), path)
    v = _random_variables(8, out_channels=17)
    jcfg = _small(jax_make_config, out_channels=17)
    lv = jax.tree.map(np.asarray, load_checkpoint_variables(
        path, topdown_cfg=jcfg))
    capsys.readouterr()
    merged = {'params': _merge_trees_checked(v['params'], lv['params']),
              'batch_stats': _merge_trees_checked(v['batch_stats'],
                                                  lv['batch_stats'])}
    jax_skipped = _skipped(capsys.readouterr().out)
    x = _crops(9)
    ref = _compile_fast(lambda v, x: JaxTopDown(jcfg).apply(v, x), merged,
                        jnp.asarray(x))

    model = _port_model(_small(make_config, out_channels=17), v)
    loop.load_from(model, path)
    skipped = _skipped(capsys.readouterr().out)
    assert skipped == ['keypoint_head.final_layer.bias',
                       'keypoint_head.final_layer.weight']
    names = _flax_names(v)
    assert sorted(names[k] for k in skipped) == jax_skipped
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)

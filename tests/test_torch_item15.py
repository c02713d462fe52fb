"""The public JAX functions that no config reaches, in the port, against the
JAX package on the CPU at a small size (ROADMAP item 15): the OHKM and RLE
losses, the geometry flips and `bbox_cs2xyxy`, the 3D keypoint decode and
the multi-label accuracy, `HybridEmbed` with its weight carry-over,
`make_eval_step`, the flat .npz interchange, `collect_env` and
`get_root_logger`, the IUV helpers, the record utilities and the crop wire
format.

Inputs come from seeded numpy generators and go through both packages.
f32 tolerances are stated per check: elementwise code is held to 1e-6
relative, code with reductions or products to 1e-5 to 1e-4 (summation
order); integer and copy results are held exactly. The JAX references are
jitted at XLA optimisation level 0 where they are whole models.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import mesh as jmesh
from vitpose_tpu.data import pipeline as jpipe
from vitpose_tpu.models import losses as jlosses
from vitpose_tpu.models import losses_regression as jlreg
from vitpose_tpu.models.resnet import ResNet as JaxResNet
from vitpose_tpu.models.vit import Block as JaxBlock
from vitpose_tpu.models.vit import HybridEmbed as JaxHybridEmbed
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.ops import decode as jdecode
from vitpose_tpu.ops import geometry as jgeo
from vitpose_tpu.train.step import make_eval_step as jax_make_eval_step
from vitpose_tpu.utils import checkpoint as jckpt

from test_torch_models import (_compile_fast, _crops, _fill, _port_model,
                               _random_variables, _small)
from vitpose_tpu_torch.data import mesh, pipeline
from vitpose_tpu_torch.models import losses, make_config
from vitpose_tpu_torch.models.resnet import ResNet
from vitpose_tpu_torch.models.vit import Block, HybridEmbed
from vitpose_tpu_torch.ops import decode, geometry
from vitpose_tpu_torch.train.step import make_eval_step
from vitpose_tpu_torch.utils import checkpoint, env
from vitpose_tpu_torch.utils.convert import hybrid_embed_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

COCO_FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=rtol, atol=atol)


# --- item 15.1: losses ------------------------------------------------------

@pytest.mark.parametrize('topk', [1, 4, 17])
def test_joints_ohkm_mse_loss_matches_jax(topk):
    """Top-k per-sample joint selection (torch.topk against lax.top_k):
    the same joints, the loss within f32 summation order (rtol 1e-5)."""
    rng = np.random.RandomState(topk)
    pred, target = (rng.rand(3, 17, 8, 6).astype(np.float32)
                    for _ in range(2))
    weight = rng.randint(0, 2, (3, 17)).astype(np.float32)
    ref = jlosses.joints_ohkm_mse_loss(pred, target, weight, topk=topk,
                                       loss_weight=0.7)
    got = losses.joints_ohkm_mse_loss(_t(pred), _t(target), _t(weight),
                                      topk=topk, loss_weight=0.7)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize('q', ['laplace', 'gaussian'])
@pytest.mark.parametrize('weight_rank', [None, 2, 3])
def test_rle_loss_matches_jax(q, weight_rank):
    """Elementwise log-likelihood and its mean (rtol 1e-5), a weight
    [N, K] broadcast over D or [N, K, D]; sigmas below the 1e-9 floor
    included."""
    rng = np.random.RandomState(0)
    pred, target = (rng.randn(4, 17, 2).astype(np.float32)
                    for _ in range(2))
    sigma = rng.uniform(0.05, 1.0, (4, 17, 2)).astype(np.float32)
    sigma[0, 0] = 0.0
    pred[0, 0] = target[0, 0]                # error 0 / floor, not 0 / 0
    weight = (None if weight_rank is None else
              rng.rand(*(4, 17, 2)[:weight_rank]).astype(np.float32))
    ref = jlreg.rle_loss(pred, sigma, target, weight, q_distribution=q,
                         loss_weight=0.5)
    got = losses.rle_loss(_t(pred), _t(sigma), _t(target),
                          None if weight is None else _t(weight),
                          q_distribution=q, loss_weight=0.5)
    _close(got, ref, 1e-5)


# --- item 15.2: geometry ----------------------------------------------------

def test_bbox_cs2xyxy_matches_jax():
    """Elementwise f32: rtol 1e-6."""
    rng = np.random.RandomState(1)
    center = rng.uniform(0, 500, (5, 2)).astype(np.float32)
    scale = rng.uniform(0.1, 3, (5, 2)).astype(np.float32)
    _close(geometry.bbox_cs2xyxy(center, scale),
           jgeo.bbox_cs2xyxy(center, scale), 1e-6)


def test_fliplr_joints_matches_jax():
    """Permutation, mirror and mask: exact."""
    rng = np.random.RandomState(2)
    joints = rng.uniform(0, 200, (2, 17, 3)).astype(np.float32)
    vis = rng.randint(0, 2, (2, 17, 1)).astype(np.float32)
    flip_index = geometry.flip_index_from_pairs(COCO_FLIP_PAIRS, 17)
    got = geometry.fliplr_joints(joints, vis, 192, flip_index)
    ref = jgeo.fliplr_joints(joints, vis, 192, flip_index)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('mode', ['static', 'root'])
def test_fliplr_regression_matches_jax(mode):
    """Pairs swapped and x mirrored: exact, also through the permutation
    given as a tensor (`flip_index`)."""
    rng = np.random.RandomState(3)
    reg = rng.rand(3, 17, 2).astype(np.float32)
    ref = np.asarray(jgeo.fliplr_regression(reg, COCO_FLIP_PAIRS, mode,
                                            center_x=0.4, center_index=5))
    got = geometry.fliplr_regression(_t(reg), COCO_FLIP_PAIRS, mode,
                                     center_x=0.4, center_index=5)
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = torch.as_tensor(geometry.flip_index_from_pairs(COCO_FLIP_PAIRS, 17))
    got = geometry.fliplr_regression(_t(reg), None, mode, center_x=0.4,
                                     center_index=5, flip_index=idx)
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        geometry.fliplr_regression(_t(reg), COCO_FLIP_PAIRS, 'mean')


# --- item 15.3: decode ------------------------------------------------------

def test_keypoints_from_heatmaps3d_matches_jax():
    """Argmax exact, the un-crop rtol 1e-6; a volume with no positive
    value gives -1 coordinates on both sides."""
    rng = np.random.RandomState(4)
    hm = rng.rand(2, 5, 4, 8, 6).astype(np.float32)
    hm[1, 2] = -1.0
    center = rng.uniform(50, 150, (2, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 2, (2, 2)).astype(np.float32)
    preds, maxvals = decode.keypoints_from_heatmaps3d(_t(hm), center, scale)
    rp, rm = jdecode.keypoints_from_heatmaps3d(hm, center, scale)
    _close(preds, rp, 1e-6)
    np.testing.assert_array_equal(maxvals.numpy(), np.asarray(rm))


@pytest.mark.parametrize('mask_rank', [1, 2])
def test_multilabel_classification_accuracy_matches_jax(mask_rank):
    """Host numpy on both sides: equal."""
    rng = np.random.RandomState(5)
    pred, gt = rng.rand(20, 2), (rng.rand(20, 2) > 0.5).astype(np.float64)
    mask = rng.randint(0, 2, (20, 2) if mask_rank == 2 else (20,))
    assert decode.multilabel_classification_accuracy(pred, gt, mask) == \
        jdecode.multilabel_classification_accuracy(pred, gt, mask)
    none = np.zeros_like(mask)
    assert decode.multilabel_classification_accuracy(pred, gt, none) == 0.0


# --- item 15.4: HybridEmbed -------------------------------------------------

def _block_state_dict(p):
    sd = {}
    for norm in ('norm1', 'norm2'):
        sd[f'{norm}.weight'] = _t(p[norm]['scale'])
        sd[f'{norm}.bias'] = _t(p[norm]['bias'])
    for group, name in (('attn', 'qkv'), ('attn', 'proj'), ('mlp', 'fc1'),
                        ('mlp', 'fc2')):
        sd[f'{group}.{name}.weight'] = _t(p[group][name]['kernel'].T.copy())
        sd[f'{group}.{name}.bias'] = _t(p[group][name]['bias'])
    return sd


@pytest.fixture(scope='module')
def hybrid_ref():
    """JAX's HybridEmbed over a ResNet-18 trunk (its own variables, the
    trunk under 'backbone' as a top-level HybridEmbed names it) followed by
    two Blocks, as one program."""
    x = _crops(6)
    embed = JaxHybridEmbed(backbone=JaxResNet(depth=18), embed_dim=32)
    blk = JaxBlock(4)
    v_embed = _fill(jax.eval_shape(embed.init, jax.random.PRNGKey(0),
                                   jnp.zeros_like(x)), 7)
    v_blocks = [_fill(jax.eval_shape(blk.init, jax.random.PRNGKey(0),
                                     jnp.zeros((2, 4, 32))), 8 + i)
                for i in range(2)]

    def run(v_embed, v_blocks, x):
        t = embed.apply(v_embed, x)
        for v in v_blocks:
            t = blk.apply(v, t)
        return t

    tokens = _compile_fast(run, v_embed, v_blocks, x)
    return x, jax.tree.map(np.asarray, (v_embed, v_blocks)), \
        np.asarray(tokens)


def test_hybrid_embed_then_blocks_match_jax(hybrid_ref):
    """ResNet-18 trunk -> 4 tokens of width 32 -> two ViT blocks: f32,
    atol 1e-4 (the products of the trunk and the blocks, summation
    order), with the weights carried over by
    hybrid_embed_state_dict_from_flax and a block converter."""
    x, (v_embed, v_blocks), ref = hybrid_ref
    assert sorted(v_embed['params']) == ['backbone', 'proj']
    embed = HybridEmbed(ResNet(depth=18), 32)
    embed.load_state_dict(
        hybrid_embed_state_dict_from_flax(v_embed, 'resnet'), strict=True)
    blocks = [Block(32, 4) for _ in range(2)]
    for blk, v in zip(blocks, v_blocks):
        blk.load_state_dict(_block_state_dict(v['params']), strict=True)
    embed.eval()
    with torch.no_grad():
        t = embed(_t(x))
        assert t.shape == (2, 4, 32)
        for blk in blocks:
            t = blk(t, torch.float32)
    _close(t, ref, 0, atol=1e-4)


# --- item 15.5: make_eval_step ----------------------------------------------

def test_make_eval_step_matches_jax():
    """The flip-tested forward of the small ViT (width 32, depth 2): f32,
    rtol and atol 1e-4 as tests/test_torch_models.py holds infer; without
    a flip index, the single forward."""
    v = _random_variables(seed=11)
    jm = JaxTopDown(_small(jax_make_config))
    model = _port_model(_small(make_config), v)
    x = _crops(12)
    flip_index = np.array([0, 2, 1, 4, 3])
    ref = _compile_fast(lambda v, x: jax_make_eval_step(jm, flip_index)(v, x),
                        jax.tree.map(jnp.asarray, v), x)
    got = make_eval_step(model, torch.as_tensor(flip_index))(_t(x))
    assert not got.requires_grad
    _close(got, ref, 1e-4, atol=1e-4)
    plain = make_eval_step(model)(_t(x))
    assert not torch.allclose(plain, got)


# --- item 15.6: checkpoint and env ------------------------------------------

def test_params_npz_round_trips_with_jax(tmp_path):
    """The port's .npz reads back in JAX and JAX's in the port, leaf for
    leaf (exact); a torch state dict (flat dotted keys, tensors) keeps its
    keys."""
    rng = np.random.RandomState(6)
    tree = {'params': {'a': {'kernel': rng.rand(3, 2).astype(np.float32)},
                       'b': rng.rand(4).astype(np.float32)},
            'batch_stats': {'bn': {'mean': rng.rand(2)}}}
    checkpoint.save_params_npz(str(tmp_path / 'port.npz'), tree)
    jckpt.save_params_npz(str(tmp_path / 'jax.npz'), tree)
    for got in (jckpt.load_params_npz(str(tmp_path / 'port.npz')),
                checkpoint.load_params_npz(str(tmp_path / 'jax.npz')),
                checkpoint.load_params_npz(str(tmp_path / 'port.npz'))):
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    sd = {'backbone.w': torch.arange(3.0), 'head.b': torch.ones(2)}
    checkpoint.save_params_npz(str(tmp_path / 'sd.npz'), sd)
    back = checkpoint.load_params_npz(str(tmp_path / 'sd.npz'))
    assert sorted(back) == sorted(sd)
    np.testing.assert_array_equal(back['backbone.w'], sd['backbone.w'])


def test_collect_env_and_logger(tmp_path):
    info = env.collect_env()
    for key in ('python', 'torch', 'torch_cuda', 'cudnn', 'nvcc',
                'cuda_available', 'numpy', 'cv2', 'vitpose_tpu_torch'):
        assert key in info, key
    assert info['torch'] == torch.__version__
    assert 'jax' not in info
    log = tmp_path / 'run.log'
    name = f'vitpose_tpu_torch.test_{tmp_path.name}'
    logger = env.get_root_logger(str(log), logging.INFO, name=name)
    assert env.get_root_logger(name=name) is logger
    assert len(logger.handlers) == 2 and not logger.propagate
    logger.info('hello %d', 3)
    for h in logger.handlers:
        h.flush()
    assert 'INFO - hello 3' in log.read_text()
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)


# --- item 15.7: host data ---------------------------------------------------

def test_iuv_helpers_match_jax(tmp_path):
    """Read, flip and split an IUV png: exact against JAX's."""
    import cv2
    rng = np.random.RandomState(8)
    img = rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
    path = tmp_path / 'iuv.png'
    cv2.imwrite(str(path), img)
    got, ref = mesh.load_iuv(path), jmesh.load_iuv(path)
    assert got[1] == ref[1] == 1
    np.testing.assert_array_equal(got[0], ref[0])
    assert mesh.load_iuv(path, use_iuv=False) == (None, 0)
    with pytest.raises(ValueError, match='Fail to read'):
        mesh.load_iuv(tmp_path / 'missing.png')
    np.testing.assert_array_equal(mesh.flip_iuv(got[0]),
                                  jmesh.flip_iuv(ref[0]))
    with pytest.raises(NotImplementedError):
        mesh.flip_iuv(got[0], uv_type='SMPL')
    for iuv in (got[0], None):
        for g, r in zip(mesh.iuv_to_arrays(iuv, (6, 4)),
                        jmesh.iuv_to_arrays(iuv, (6, 4))):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def test_record_utilities_match_jax():
    items = {'a': {'x': 1, 'y': [2]}, 'b': {'x': 3, 'y': [4]}}

    def fn(r):
        return {'x2': r['x'] * 2, 'y': r['y']}

    got = pipeline.multi_item_process(fn, items)
    assert got == jpipe.multi_item_process(fn, items)
    assert pipeline.discard_duplicated_items(got, ['y', 'z']) == \
        jpipe.discard_duplicated_items(got, ['y', 'z'])
    renamed = pipeline.rename_keys(got, [('x2', 'double')])
    assert renamed == jpipe.rename_keys(got, [('x2', 'double')])
    assert 'x2' in got and 'x2' not in renamed


@pytest.fixture(scope='module')
def crop_wire():
    """JAX's host crop and device finish on seeded canvases, the inputs of
    tests/test_host_crop_wire.py at 64x48."""
    rng = np.random.RandomState(0)
    n, k = 3, 17
    inputs = dict(
        imgs=rng.randint(0, 256, (n, 96, 96, 3)).astype(np.uint8),
        center=np.asarray([[48, 48], [45, 51], [51, 45]], np.float32),
        scale=np.full((n, 2), 0.45, np.float32),
        rot=np.asarray([0.0, 15.0, -30.0], np.float32),
        joints=rng.uniform(24, 72, (n, k, 2)).astype(np.float32),
        flip=np.asarray([False, True, False]))
    vis = np.ones((n, k), np.float32)
    crops, joints_c = jpipe.make_host_crop_fn(image_size=(48, 64))(
        jnp.asarray(inputs['imgs']), inputs['center'], inputs['scale'],
        inputs['rot'], inputs['joints'], inputs['flip'])
    out = jpipe.make_device_finish_fn(image_size=(48, 64),
                                      heatmap_size=(12, 16))(
        crops, joints_c, vis)
    return inputs, vis, (np.asarray(crops), np.asarray(joints_c)), \
        jax.tree.map(np.asarray, out)


def test_host_crop_and_finish_match_jax(crop_wire):
    """uint8 crops within one level of JAX's (the bilinear sums round in
    another order; rounding to uint8 may land a half-way value on either
    side), crop-space joints rtol 1e-6, targets atol 1e-5 from the same
    joints; and the pair agrees with the port's fused preprocess up to the
    uint8 quantisation, as tests/test_host_crop_wire.py holds JAX's."""
    inputs, vis, (ref_crops, ref_joints), ref_out = crop_wire
    crops, joints_c = pipeline.make_host_crop_fn(image_size=(48, 64))(
        **inputs)
    assert crops.dtype == torch.uint8 and crops.shape == (3, 64, 48, 3)
    diff = np.abs(crops.numpy().astype(int) - ref_crops.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    _close(joints_c, ref_joints, 1e-6)
    out = pipeline.make_device_finish_fn(image_size=(48, 64),
                                         heatmap_size=(12, 16))(
        _t(ref_crops), _t(ref_joints), _t(vis))
    _close(out['imgs'], ref_out['imgs'], 1e-6, atol=1e-6)
    _close(out['target'], ref_out['target'], 0, atol=1e-5)
    np.testing.assert_array_equal(out['target_weight'].numpy(),
                                  ref_out['target_weight'])
    fused = pipeline.make_preprocess_fn(image_size=(48, 64),
                                        heatmap_size=(12, 16))(
        _t(inputs['imgs']), _t(inputs['center']), _t(inputs['scale']),
        _t(inputs['rot']), _t(inputs['joints']), _t(vis),
        _t(inputs['flip']))
    mine = pipeline.make_device_finish_fn(image_size=(48, 64),
                                          heatmap_size=(12, 16))(
        crops, joints_c, _t(vis))
    _close(mine['imgs'], fused['imgs'], 0, atol=2.5 / 255 / 0.2)
    _close(mine['target'], fused['target'], 0, atol=1e-5)
    with pytest.raises(ValueError, match='on the host'):
        pipeline.make_host_crop_fn()(torch.zeros(1, 8, 8, 3, device='meta'),
                                     *[inputs[k][:1] for k in
                                       ('center', 'scale', 'rot', 'joints')])

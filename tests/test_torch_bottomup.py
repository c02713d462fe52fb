"""The port's bottom-up modules against the JAX package on the CPU: the
segmentation masks, every target painter, the training affine and flip, the
test-time multi-scale sizing, the grouping parser (with the tie order of a
plateau), both AE heads and both AE losses, the estimator's flip inference,
the multi-scale and single-canvas APIs, two training steps, the
ViT-backbone estimator and the weight converters in both directions.

Models: HigherHRNet (HRNet of width 8, one module per stage, one block per
branch; the flagship head's geometry with deconvs of 8), the AE simple head
on the same HRNet, and ResNet-18 with three deconvs of 16 and the AE simple
head, at 64x64 inputs: output sizes (16, 32), 17 joints. Port weights come
from a seeded generator, BN redrawn from a seeded numpy generator, and go to
JAX through its own `convert_bottomup_checkpoint`, the path a released .pth
takes there; the other direction (JAX's init through the port's
`bottomup_state_dict_from_flax`) is held too. Inputs are seeded numpy. Each
JAX forward is one program compiled at XLA CPU optimisation level 0, once
per module. Random weights give many candidates per joint: the heatmap
channels' biases are shifted (`sparse_heatmaps`) so that a few local maxima
per joint pass the parser's 0.1 detection threshold, as trained weights do.

Tolerances: masks, targets and the test-time sizing exact (the same numpy
and cv2 code; unrotated affine matrices equal to the bit); the training
affine and flip take the same draws and agree but where a rotation's f32
cos or sin rounds differently in XLA and torch (one ulp, about 7% of
angles): then warped pixels within one grey level and mask pixels at most
at MOVED_SHARE of them, joints within 1e-4 px (see `near`); parser poses
and scores exact on the plateau maps; head outputs, flip-tested maps and
the multi-scale maps 1e-4 absolute plus 1e-4 relative (the flip-tested
maps measured at most 8.6e-6 apart, of values up to 7.6); the losses 1e-6
relative plus 1e-7 absolute; grouped poses of the API 1e-3 px and their
scores (means of heatmap values) 1e-4 relative plus 1e-6 absolute; the
train steps as tests/test_torch_cnn.py's (metrics 1e-4 relative, the first
step's clipped gradients as Adam's first moment 1e-4 relative plus 1e-4 of
the tensor's largest value, BN statistics 1e-4 relative plus 1e-5
absolute, parameters 1e-4 relative plus 5e-5 absolute but for at most
FLIPPED_SHARE of the elements, each within four times lr: Adam's first
step moves an element by about lr whatever the size of its gradient, so
near-zero gradients flip with f32 noise; lr is small, see LR).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitpose_tpu.api.inference import (
    inference_bottom_up_multi_scale as jax_multi_scale)
from vitpose_tpu.data import bottomup as jdata
from vitpose_tpu.data import mask as jmask
from vitpose_tpu.models import bottomup as jbu
from vitpose_tpu.models.losses_regression import (ae_heatmap_loss as
                                                  jax_heatmap_loss)
from vitpose_tpu.models.losses_regression import ae_tag_loss as jax_tag_loss
from vitpose_tpu.models.vit import ViTConfig as JaxViTConfig
from vitpose_tpu.ops import group as jgroup
from vitpose_tpu.train import bottomup_loop as jloop
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.utils.family_ckpt import convert_bottomup_checkpoint

from test_torch_cnn import randomize_bn
from test_torch_models import _compile_fast, _fill
from vitpose_tpu_torch.data import DatasetInfo
from vitpose_tpu_torch.data import bottomup as pdata
from vitpose_tpu_torch.data import mask as pmask
from vitpose_tpu_torch.models import bottomup as pbu
from vitpose_tpu_torch.models.heads_extra import AEHigherResolutionHead
from vitpose_tpu_torch.models.losses import ae_heatmap_loss, ae_tag_loss
from vitpose_tpu_torch.models.vit import ViTConfig
from vitpose_tpu_torch.ops import group as pgroup
from vitpose_tpu_torch.train import bottomup_loop as ploop
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils.convert import bottomup_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-6, atol=1e-7)
POSE_TOL_PX = 1e-3
METRIC_RTOL = 1e-4
BN_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=5e-5)
FLIPPED_SHARE = 1e-3
MOVED_SHARE = 1e-3
# small, so that the near-zero gradients whose Adam step f32 noise turns
# move the second step's losses by less than METRIC_RTOL
LR = 1e-5
FLIP = np.asarray(DatasetInfo.load('coco').flip_index)
HR_SMALL = dict(width=8, stage_modules=(1, 1, 1), stage_blocks=1)
MODELS = {
    'higher': dict(backbone_type='hrnet', backbone_overrides=HR_SMALL,
                   head='ae_higher', head_overrides=dict(
                       tag_per_joint=True, num_deconv_layers=1,
                       deconv_filters=(8,), deconv_kernels=(4,),
                       num_basic_blocks=2, cat_output=(True,),
                       with_ae_loss=(True, False), final_kernel=1)),
    'ae_hrnet': dict(backbone_type='hrnet', backbone_overrides=HR_SMALL,
                     head='ae', head_overrides=dict(
                         tag_per_joint=True, deconv_filters=(),
                         deconv_kernels=(), final_kernel=1)),
    'ae_res18': dict(backbone_type='resnet',
                     backbone_overrides=dict(depth=18), head='ae',
                     head_overrides=dict(tag_per_joint=True,
                                         deconv_filters=(16, 16, 16),
                                         deconv_kernels=(4, 4, 4),
                                         final_kernel=1)),
}


def mdict(name):
    return dict(MODELS[name], family='bottomup', num_joints=17,
                dataset_info='coco')


def images(seed, n=2, hw=(64, 64)):
    return np.random.RandomState(seed).randn(n, *hw, 3).astype(np.float32)


def final_convs(model):
    head = model.keypoint_head
    if isinstance(head, AEHigherResolutionHead):
        return list(head.final_layers)
    return [head.final_layer]


def sparse_heatmaps(model, x, keep=3):
    """Shift every heatmap channel's bias so that about `keep` local maxima
    per joint of the flip-tested maps of `x` exceed 0.1."""
    hm, _ = model.infer(torch.from_numpy(x), FLIP)
    return shift_heatmap_bias(model, hm, keep)


def port_model(name, seed=0, x=None):
    model = build_model_from_cfg(mdict(name),
                                 torch.Generator().manual_seed(seed))
    model = randomize_bn(model, seed + 100).eval()
    return sparse_heatmaps(model, x) if x is not None else model


def jax_variables(model, name):
    """The port model's weights as JAX's converter reads a .pth."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return jax.tree.map(jnp.asarray, convert_bottomup_checkpoint(
        sd, {'model': mdict(name)}))


def jax_infer_fn(est):
    """JAX's `BottomUpEstimator.infer` body, compiled at level 0."""
    def apply_reduced(v, x):
        out = est.apply(v, x)
        if isinstance(out, (list, tuple)):
            out = jbu.reduce_multires_output(
                out, est.num_joints, getattr(est.head, 'with_ae_loss', None))
        return out

    def fn(v, x):
        return jbu.ae_forward_with_flip(apply_reduced, v, x, est.num_joints,
                                        FLIP)
    return fn


# infer_refs' compiled JAX programs (flip inference and raw outputs of a
# batch of 2 at 64x64), by model
_INFER = {}


@pytest.fixture(scope='module')
def infer_refs():
    """{model: (port model, JAX estimator, JAX variables, images, JAX
    (heatmaps, tags), JAX raw outputs)}."""
    out = {}
    for i, name in enumerate(MODELS):
        x = images(20 + i)
        model = port_model(name, seed=i, x=x)
        est = jax_build(mdict(name))
        v = jax_variables(model, name)
        fn = jax_infer_fn(est)

        def both(v, x, fn=fn, est=est):
            return fn(v, x), est.apply(v, x)

        xj = jnp.asarray(x)
        _INFER[name] = jax.jit(both).lower(v, xj).compile(
            compiler_options={'xla_backend_optimization_level': 0})
        (hm, tags), raw = _INFER[name](v, xj)
        raw = raw if isinstance(raw, (list, tuple)) else [raw]
        out[name] = (model, est, v, x, (np.asarray(hm), np.asarray(tags)),
                     [np.asarray(r).transpose(0, 3, 1, 2) for r in raw])
    return out


# --- masks, targets, augmentation ---------------------------------------------

def _segmentations(h=23, w=31):
    m = np.zeros((h, w), np.uint8)
    m[3:15, 4:20] = 1
    m[18:, 25:] = 1
    rle = pmask.mask_to_rle(m)
    return {'polygon': [[2.2, 3.0, 20.7, 4.1, 15.0, 19.6, 3.1, 12.0],
                        [22.0, 15.0, 30.0, 15.0, 30.0, 22.0]],
            'rle': rle,
            'compressed_rle': dict(
                counts=pmask.encode_compressed_rle(rle['counts']),
                size=[h, w])}


@pytest.mark.parametrize('kind', ['polygon', 'rle', 'compressed_rle'])
def test_segmentation_masks_match_jax(kind):
    segm = _segmentations()[kind]
    got = pmask.segmentation_to_mask(segm, 23, 31)
    want = jmask.segmentation_to_mask(segm, 23, 31)
    assert got.sum() > 0
    np.testing.assert_array_equal(got, want)


def _people(seed, p=4, k=17, size=32):
    rng = np.random.RandomState(seed)
    j = np.zeros((p + 2, k, 3), np.float32)        # two padded people
    j[:p, :, :2] = rng.uniform(-3, size + 3, (p, k, 2))
    j[:p, :, 2] = rng.rand(p, k) > 0.2
    return j


@pytest.mark.parametrize('use_udp', [False, True])
def test_target_painters_match_jax(use_udp):
    j = _people(1)
    for size, sigma in ((32, 2.0), ((24, 16), -1.0)):
        np.testing.assert_array_equal(
            pdata.generate_heatmap_targets(j, size, sigma, use_udp),
            jdata.generate_heatmap_targets(j, size, sigma, use_udp))
    pair = [_people(2), _people(3)]
    for got, want in zip(
            pdata.generate_heatmap_targets_multiscale(pair, (16, 32), 2.0,
                                                      use_udp),
            jdata.generate_heatmap_targets_multiscale(pair, (16, 32), 2.0,
                                                      use_udp)):
        np.testing.assert_array_equal(got, want)
    mask = np.ones((64, 64), np.float32)
    mask[5:30, 10:40] = 0
    got = pdata.generate_ae_targets(_people(4, size=64), mask, 64, 32,
                                    use_udp=use_udp)
    want = jdata.generate_ae_targets(_people(4, size=64), mask, 64, 32,
                                     use_udp=use_udp)
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))


def test_paf_targets_match_jax():
    skeleton = DatasetInfo.load('coco').skeleton_links
    j = _people(5)
    j[0, 3, :2] = j[0, 1, :2]                      # a zero-length limb
    for size in (32, (24, 16)):
        np.testing.assert_array_equal(
            pdata.generate_paf_targets(j, size, 1.0, skeleton),
            jdata.generate_paf_targets(j, size, 1.0, skeleton))
    got = pdata.generate_paf_targets_multiscale([j, j / 2], (32, 16), 1.0,
                                                skeleton)
    want = jdata.generate_paf_targets_multiscale([j, j / 2], (32, 16), 1.0,
                                                 skeleton)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('use_udp', [False, True])
def test_random_affine_and_flip_match_jax(use_udp):
    rng_img = np.random.RandomState(6)
    img = rng_img.randint(0, 256, (70, 90, 3)).astype(np.uint8)
    mask = (rng_img.rand(70, 90) > 0.3).astype(np.float32)
    joints = _people(7, size=80)
    outs = []
    for mod in (pdata, jdata):
        rng = np.random.RandomState(8)
        res = []
        for _ in range(3):
            a = mod.bottomup_random_affine(
                img, [mask, mask], [joints, joints], 64, (16, 32), rng,
                use_udp=use_udp)
            f = mod.bottomup_random_flip(a[0], a[1], a[2], FLIP, (16, 32),
                                         rng, flip_prob=0.5)
            res.append((a, f))
        outs.append(res)
    flips = 0
    for (a, f), (ja, jf) in zip(*outs):
        assert a[3] == ja[3] and f[3] == jf[3]        # the same draws
        flips += f[3]
        for got, want in ((a[0], ja[0]), (f[0], jf[0])):
            near(got, want, 1)
        for s in range(2):
            for got, want in ((a[1][s], ja[1][s]), (f[1][s], jf[1][s])):
                near(got, want, 0)
            for got, want in ((a[2][s], ja[2][s]), (f[2][s], jf[2][s])):
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert 0 < flips < 3


def near(got, want, levels):
    """Warped images and masks: the affine matrices of the two packages
    differ by one f32 ulp where the rotation's cos or sin rounds
    differently (XLA's and torch's; about 7% of angles), which moves a
    bilinear sample across a rounding or the masks' 0.5 cut at a few
    pixels: at most MOVED_SHARE of them, each by at most one grey level
    (`levels` 1) or mask value."""
    diff = np.abs(got.astype(np.float64) - want)
    assert diff.max() <= max(levels, 1)
    assert (diff > 0).mean() <= MOVED_SHARE


@pytest.mark.parametrize('use_udp', [False, True])
def test_multi_scale_sizing_matches_jax(use_udp):
    for hw in ((70, 90), (120, 50)):
        img = np.random.RandomState(9).randint(0, 256, hw + (3,)).astype(
            np.uint8)
        for scale in (0.5, 1.0, 2.0):
            got = pdata.get_multi_scale_size(img, (64, 64), scale, 0.5,
                                             use_udp)
            want = jdata.get_multi_scale_size(img, (64, 64), scale, 0.5,
                                              use_udp)
            assert got[0] == want[0]
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2], want[2])
            got = pdata.resize_align_multi_scale(img, (64, 64), scale, 0.5,
                                                 use_udp)
            want = jdata.resize_align_multi_scale(img, (64, 64), scale, 0.5,
                                                  use_udp)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


# --- the parser ------------------------------------------------------------

def plateau_maps(k=17, h=16, w=16):
    """Heatmaps whose candidates tie: for every joint, four people at one
    peak value 0.9 each, isolated, plus a 2x2 flat maximum of 0.5 that NMS
    keeps whole, and tags that tell the four people apart. With
    max_num_people 3 the tie order decides which three candidates a joint
    keeps and in which order the people come out."""
    hm = np.zeros((1, k, h, w), np.float32)
    tags = np.zeros((1, k, h, w, 1), np.float32)
    rng = np.random.RandomState(10)
    for j in range(k):
        cells = [(2, 3), (2, 12), (9, 6), (13, 12)]
        for p, (y, x) in enumerate(cells):
            dy, dx = rng.randint(-1, 2, 2)
            hm[0, j, y + dy, x + dx] = 0.9
            tags[0, j, y + dy, x + dx, 0] = 3.0 * p + 0.1 * rng.randn()
        hm[0, j, 6:8, 13:15] = 0.5
        tags[0, j, 6:8, 13:15, 0] = 20.0
    return hm, tags


@pytest.mark.parametrize('use_udp', [False, True])
def test_parser_on_plateaus_matches_jax_tie_order(use_udp):
    hm, tags = plateau_maps()
    kw = dict(max_num_people=3, use_udp=use_udp)
    got, got_s = pgroup.HeatmapParser(**kw).parse(torch.from_numpy(hm),
                                                  torch.from_numpy(tags))
    want, want_s = jgroup.HeatmapParser(**kw).parse(hm, tags)
    assert got[0].shape == want[0].shape and len(got[0]) >= 3
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(np.asarray(got_s), np.asarray(want_s))


def test_topk_candidates_keep_jax_order_of_ties():
    hm, tags = plateau_maps()
    got = pgroup.topk_candidates(torch.from_numpy(hm),
                                 torch.from_numpy(tags), 6)
    want = jgroup.topk_candidates(hm, tags, 6)
    for key in got:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


# --- heads, losses, the estimator ---------------------------------------------

@pytest.mark.parametrize('name', list(MODELS))
def test_heads_and_flip_inference_match_jax(infer_refs, name):
    model, _, _, x, (hm_ref, tags_ref), raw_ref = infer_refs[name]
    with torch.no_grad():
        raw = model(torch.from_numpy(x))
    assert [r.shape for r in raw] == [r.shape for r in raw_ref]
    for got, want in zip(raw, raw_ref):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    hm, tags = model.infer(torch.from_numpy(x), FLIP)
    assert hm.shape == hm_ref.shape and tags.shape == tags_ref.shape \
        and tags.shape[-1] == 2
    np.testing.assert_allclose(hm.numpy(), hm_ref, **TOL)
    np.testing.assert_allclose(tags.numpy(), tags_ref, **TOL)


@pytest.mark.parametrize('name', list(MODELS))
def test_flax_tree_round_trips_through_both_converters(name):
    """JAX's variables (the shapes of its init, seeded values) ->
    bottomup_state_dict_from_flax -> the port with strict=True -> JAX's
    convert_bottomup_checkpoint gives back every leaf bit for bit: the names
    and layouts agree both ways (the forward of converted weights is held in
    test_heads_and_flip_inference_match_jax)."""
    est = jax_build(mdict(name))
    shapes = jax.eval_shape(est.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    v = _fill(shapes, 3)
    model = build_model_from_cfg(mdict(name))
    model.load_state_dict(bottomup_state_dict_from_flax(
        v, MODELS[name]['backbone_type']), strict=True)
    back = convert_bottomup_checkpoint(
        {k: t.numpy() for k, t in model.state_dict().items()},
        {'model': mdict(name)})
    want = dict(jax.tree_util.tree_leaves_with_path(v))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=str(path))


def _tag_case(seed, n=3, m=4, k=5, hw=36):
    """[N, KHW, 1] tags and [N, M, K, 2] joints: sample 0 has nobody, sample
    1 one person, sample 2 M people, some joints invisible."""
    rng = np.random.RandomState(seed)
    tags = rng.randn(n, k * hw, 1).astype(np.float32)
    joints = np.zeros((n, m, k, 2), np.int32)
    joints[..., 0] = rng.randint(0, k * hw, (n, m, k))
    joints[1, 0, :, 1] = 1
    joints[2, :, :, 1] = rng.rand(m, k) > 0.3
    joints[2, 1, :, 1] = 0
    joints[2, 1, 2, 1] = 1
    return tags, joints


@pytest.mark.parametrize('loss_type', ['exp', 'max'])
def test_ae_losses_match_jax(loss_type):
    tags, joints = _tag_case(11)
    push, pull = ae_tag_loss(torch.from_numpy(tags),
                             torch.from_numpy(joints), loss_type)
    jpush, jpull = jax_tag_loss(jnp.asarray(tags), jnp.asarray(joints),
                                loss_type)
    np.testing.assert_allclose(push.numpy(), np.asarray(jpush), **LOSS_TOL)
    np.testing.assert_allclose(pull.numpy(), np.asarray(jpull), **LOSS_TOL)
    assert push[0] == pull[0] == push[1] == 0 and pull[1] > 0 \
        and push[2] > 0
    rng = np.random.RandomState(12)
    pred, gt = rng.rand(2, 3, 5, 8, 6).astype(np.float32)
    gt[1, 2] = 0
    mask = (rng.rand(3, 8, 6) > 0.2).astype(np.float32)
    for supervise_empty in (True, False):
        got = ae_heatmap_loss(torch.from_numpy(pred), torch.from_numpy(gt),
                              torch.from_numpy(mask), supervise_empty, 2.0)
        want = jax_heatmap_loss(jnp.asarray(pred), jnp.asarray(gt),
                                jnp.asarray(mask), supervise_empty, 2.0)
        np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)


def test_vit_estimator_matches_jax():
    """The ViT-backbone estimator as JAX's
    tests/test_heads_extra_bottomup.py builds it (64x48, embed 32, depth 2,
    4 heads, the default AE head): JAX's init through the converter, the
    flip-tested maps and the parse."""
    kw = dict(img_size=(64, 48), embed_dim=32, depth=2, num_heads=4)
    est = jbu.BottomUpEstimator(JaxViTConfig(**kw), num_joints=17)
    x = images(31, n=1, hw=(64, 48))
    v = _fill(jax.eval_shape(est.init, jax.random.PRNGKey(0),
                             jnp.asarray(x)), 4)
    model = pbu.BottomUpEstimator(ViTConfig(**kw), num_joints=17)
    assert model.backbone_type == 'vit'
    model.load_state_dict(bottomup_state_dict_from_flax(v, 'vit'),
                          strict=True)
    hm_ref, tags_ref = _compile_fast(jax_infer_fn(est), v, jnp.asarray(x))
    hm, tags = model.infer(torch.from_numpy(x), FLIP)
    np.testing.assert_allclose(hm.numpy(), np.asarray(hm_ref), **TOL)
    np.testing.assert_allclose(tags.numpy(), np.asarray(tags_ref), **TOL)
    center, scale = np.array([32.0, 24.0]), np.array([0.3, 0.4])
    preds, scores = model.parse(hm, tags, center, scale)
    jpreds, jscores = est.parse(np.asarray(hm_ref, np.float32),
                                np.asarray(tags_ref, np.float32), center,
                                scale)
    assert len(preds) == len(jpreds)


# --- the multi-scale API -------------------------------------------------------

@pytest.mark.parametrize('align_corners', [False, True])
def test_multi_scale_api_matches_jax(align_corners):
    """Scales (0.5, 1, 2) with the flip: the scale-2 maps shrink back to the
    base size (antialiased, as jax.image.resize) or through the
    align-corners resize; aggregated maps, grouped poses and scores as
    JAX's."""
    from vitpose_tpu_torch.api.inference import (
        inference_bottom_up_multi_scale, multi_scale_maps)
    img = np.random.RandomState(13).randint(0, 256, (50, 70, 3)).astype(
        np.uint8)
    kw = dict(test_scale_factor=(0.5, 1.0, 2.0), base_size=64,
              use_udp=align_corners, align_corners=align_corners)
    model = port_model('higher', seed=5)
    hm, _, _, _ = multi_scale_maps(model, img, **kw)
    shift_heatmap_bias(model, hm)
    est = jax_build(mdict('higher'))
    est.apply = _compiled_apply(est)
    v = jax_variables(model, 'higher')
    got, maps = recording_parse(
        model.parser, lambda: inference_bottom_up_multi_scale(
            model, img, pose_nms_thr=None, **kw)[0])
    want, jmaps = recording_parse(
        est.parser, lambda: jax_multi_scale(est, v, img, pose_nms_thr=None,
                                            **kw)[0])
    for a, b in zip(maps, jmaps):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a['keypoints'], np.asarray(
            b['keypoints']), atol=POSE_TOL_PX, rtol=0)
        np.testing.assert_allclose(a['score'], b['score'], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize('name', list(MODELS))
def test_single_canvas_api_matches_jax(infer_refs, name):
    """inference_bottom_up_pose_model (bottom_up_maps on the square base
    canvas, then grouping and OKS NMS) on a square image against JAX's
    (vitpose_tpu/api/inference.py:416): the parser's maps, the grouped
    poses and their scores. JAX's flip inference is infer_refs' program,
    given the canvas twice."""
    from vitpose_tpu.api.inference import (
        inference_bottom_up_pose_model as jax_single_canvas)
    from vitpose_tpu_torch.api.inference import (
        bottom_up_maps, inference_bottom_up_pose_model)
    img = np.random.RandomState(40 + list(MODELS).index(name)).randint(
        0, 256, (48, 48, 3)).astype(np.uint8)
    model = copy.deepcopy(infer_refs[name][0])
    hm, _, _, _ = bottom_up_maps(model, img, base_size=64)
    shift_heatmap_bias(model, hm)
    est, v = infer_refs[name][1], jax_variables(model, name)
    got, maps = recording_parse(
        model.parser, lambda: inference_bottom_up_pose_model(
            model, img, base_size=64)[0])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(est, 'infer', lambda v, x, flip_index: [
            m[:1] for m in _INFER[name](v, jnp.concatenate([x, x]))[0]])
        want, jmaps = recording_parse(
            est.parser, lambda: jax_single_canvas(est, v, img,
                                                  base_size=64)[0])
    for a, b in zip(maps, jmaps):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a['keypoints'], np.asarray(
            b['keypoints']), atol=POSE_TOL_PX, rtol=0)
        np.testing.assert_allclose(a['score'], b['score'], rtol=1e-4,
                                   atol=1e-6)


_APPLY = {}


def _compiled_apply(est):
    """est.apply (eval mode) as one program per model and input shape,
    compiled at level 0 and shared by the test's cases (JAX's API runs it op
    by op). The key holds the model (its backbone, which a copy of the
    estimator shares): two models fed one image size in one process must not
    share a program."""
    def apply(v, x):
        key = (id(est.backbone), x.shape)
        if key not in _APPLY:
            _APPLY[key] = jax.jit(type(est).apply, static_argnums=0).lower(
                est, v, x).compile(
                    compiler_options={'xla_backend_optimization_level': 0})
        return _APPLY[key](v, x)
    return apply


def shift_heatmap_bias(model, hm, keep=3):
    """`sparse_heatmaps` from given flip-tested maps."""
    flat = pgroup.heatmap_nms(hm).flatten(2).sort(-1, descending=True)[0]
    shift = 0.1 - flat[..., keep - 1:keep + 1].mean(-1).amax(0)
    with torch.no_grad():
        for conv in final_convs(model):
            conv.bias[:17] += shift
    return model


def recording_parse(parser, run):
    """run()'s result and the (heatmaps, tags) its parser was given, as
    numpy."""
    seen = []
    parse = parser.parse

    def record(heatmaps, tags, *a, **k):
        seen.append(tuple(m.numpy() if isinstance(m, torch.Tensor)
                          else np.asarray(m) for m in (heatmaps, tags)))
        return parse(heatmaps, tags, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(parser, 'parse', record)
        out = run()
    (maps,) = seen
    return out, maps


# --- training --------------------------------------------------------------

def train_batch(seed, n=2):
    """A loader-shaped batch at 64 -> (16, 32) from painted targets."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n, 64, 64, 3)).astype(np.uint8)
    hms, masks, aes = [[], []], [[], []], []
    for i in range(n):
        joints = _people(seed + i, p=3, size=64)
        mask = np.ones((64, 64), np.float32)
        mask[rng.randint(0, 40):, :rng.randint(5, 30)] = 0
        for s, o in enumerate((16, 32)):
            t = pdata.generate_ae_targets(joints, mask, 64, o,
                                          max_people=5)
            hms[s].append(t['heatmaps'])
            masks[s].append(t['mask'])
            if s == 0:
                aes.append(t['ae_joints'])
    return dict(imgs=imgs, heatmaps=np.stack(hms[0]),
                masks=np.stack(masks[0]),
                multi_heatmaps=tuple(np.stack(h) for h in hms),
                multi_masks=tuple(np.stack(m) for m in masks),
                ae_joints=np.stack(aes))


def _adam_mu(opt_state):
    return next(s.mu for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


@pytest.fixture(scope='module')
def train_runs():
    """Two steps of the port and of JAX from the same weights and batch
    (HigherHRNet: two outputs, the tags on the first): (port metrics, port final state dict, JAX
    metrics, JAX final variables as a port state dict, initial state
    dict)."""
    out = {}
    batch = train_batch(40)
    for name in ('higher',):
        model = port_model(name, seed=60)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        v = jax_variables(model, name)
        est = jax_build(mdict(name))
        _, step = jloop.make_bottomup_train_step(est)
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
        params, stats = jloop.split_bottomup_variables(v)
        opt = tx.init(params)
        jbatch = jax.tree.map(jnp.asarray, batch)
        run = functools.partial(step, tx=tx)
        fast = jax.jit(run).lower(params, stats, opt, jbatch).compile(
            compiler_options={'xla_backend_optimization_level': 0})
        jm = []
        for i in range(2):
            params, stats, opt, m = fast(params, stats, opt, jbatch)
            jm.append({k: float(x) for k, x in m.items()})
            if i == 0:
                mu = bottomup_state_dict_from_flax(
                    {part: {'params': jax.tree.map(np.asarray, tree)}
                     for part, tree in _adam_mu(opt).items()},
                    MODELS[name]['backbone_type'])
        jvars = jax.tree.map(np.asarray,
                             jloop.join_bottomup_variables(params, stats))
        state = ploop.bottomup_train_state(model, LR, [])
        pstep = ploop.make_bottomup_train_step(model)
        pm = []
        for i in range(2):
            pm.append({k: float(x) for k, x in pstep(
                state, ploop.batch_to_device(batch, 'cpu')).items()})
            if i == 0:
                pmu = {n: state.optimizer.state[p]['exp_avg'].clone()
                       for n, p in model.named_parameters()}
        out[name] = (pm, state.model.state_dict(), jm,
                     bottomup_state_dict_from_flax(
                         jvars, MODELS[name]['backbone_type']), init,
                     pmu, mu)
    return out


@pytest.mark.parametrize('name', ['higher'])
def test_two_train_steps_match_jax(train_runs, name):
    pm, sd, jm, jsd, init, pmu, mu = train_runs[name]
    for step, (a, b) in enumerate(zip(pm, jm)):
        for key in ('heatmap_loss', 'push_loss', 'pull_loss', 'total_loss'):
            np.testing.assert_allclose(a[key], b[key], rtol=METRIC_RTOL,
                                       err_msg=f'step {step} {key}')
    assert pm[0]['push_loss'] > 0 and pm[0]['pull_loss'] > 0
    assert pm[0]['grad_norm'] > 1.0                   # clipped
    # the clipped gradients of step 1, as Adam's first moment (0.1 g)
    top = max(np.abs(m.numpy()).max() for m in mu.values())
    for key, got in pmu.items():
        want = mu[key].numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max()
                                   + 1e-6 * top, err_msg=f'grad {key}')
    flipped = total = 0
    for key, value in sd.items():
        if 'num_batches' in key:
            continue
        got, want = value.numpy(), jsd[key].numpy()
        if 'running' in key:
            np.testing.assert_allclose(got, want, **BN_TOL, err_msg=key)
            assert not np.array_equal(got, init[key].numpy()), key
            continue
        bad = np.abs(got - want) > PARAM_TOL['atol'] \
            + PARAM_TOL['rtol'] * np.abs(want)
        flipped += int(bad.sum())
        total += got.size
        assert np.abs(got - want).max() <= 4 * LR, key
    assert flipped <= FLIPPED_SHARE * total

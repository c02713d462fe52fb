"""The port's crop geometry, batched warp and heatmap decoding against the
JAX package, on the CPU, with the same numpy inputs on both sides.

Tolerances: geometry and warp are f32 elementwise math, held to 1e-5
relative; decoded image coordinates to 1e-4 px plus 1e-5 relative (the two
blur implementations sum in different orders).
"""
import jax
import numpy as np
import pytest
import torch

from vitpose_tpu.ops import decode as jdec
from vitpose_tpu.ops import geometry as jgeo
from vitpose_tpu.ops.warp import warp_affine_batch as jax_warp

from vitpose_tpu_torch.ops import decode as tdec
from vitpose_tpu_torch.ops import geometry as tgeo
from vitpose_tpu_torch.ops.warp import warp_affine_batch
from test_torch_threads import torch_test_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _boxes(seed, n=4):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-20, 200, (n, 2))
    wh = rng.uniform(5, 150, (n, 2))
    return np.concatenate([xy, wh], 1).astype(np.float32)


def _cs(seed, n=4):
    return jgeo.bbox_xywh2cs(_boxes(seed, n), 0.75)


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


@pytest.mark.parametrize('aspect', [0.75, 1.5])
def test_bbox_xywh2cs(aspect):
    b = _boxes(0, 8)
    c, s = tgeo.bbox_xywh2cs(b, aspect, padding=1.25)
    rc, rs = jgeo.bbox_xywh2cs(b, aspect, padding=1.25)
    _close(c, rc)
    _close(s, rs)


# numpy inputs shared by the port and the JAX side
B1 = np.concatenate([_boxes(1), np.full((4, 1), 0.5, np.float32)], 1)
CS2, CS4, CS5 = _cs(2), _cs(4), _cs(5)
ROT4 = np.array([0.0, 30.0, -45.0, 90.0], np.float32)
ROT_UDP = np.array([0.0, 15.0, -30.0, 180.0], np.float32)
MAT = np.random.RandomState(3).randn(5, 2, 3).astype(np.float32)
COORDS = np.random.RandomState(6).uniform(-2, 50, (4, 17, 2)).astype(
    np.float32)
FLIP = np.array([0, 2, 1, 4, 3])
HM_G = np.random.RandomState(7).randn(2, 5, 8, 6).astype(np.float32)
HM_C = np.random.RandomState(7).randn(2, 15, 8, 6).astype(np.float32)
IMG = np.random.RandomState(8).rand(1, 20, 24, 3).astype(np.float32)
WARP_C = np.array([[12.0, 10.0], [2.0, 3.0], [20.0, 18.0]], np.float32)
WARP_S = np.array([[0.08, 0.1], [0.1, 0.13], [0.05, 0.07]], np.float32)
WARP_ROT = np.array([0.0, 25.0, -60.0], np.float32)


@pytest.fixture(scope='module')
def jref():
    """Every JAX geometry and warp reference, from one JAX program."""
    def refs():
        warp_mat = jgeo.udp_warp_matrix(WARP_ROT, WARP_C, WARP_S, (12, 16))
        return {
            'xyxy2xywh': jgeo.bbox_xyxy2xywh(B1),
            **{f'affine{inv}': jgeo.affine_matrix(
                *CS2, ROT4, (48, 64), shift=(0.1, -0.2), inv=inv)
               for inv in (False, True)},
            'invert': jgeo.invert_affine(MAT),
            'udp': jgeo.udp_warp_matrix(ROT_UDP, *CS4, (192, 256)),
            **{f'preds{udp}': jgeo.transform_preds(
                COORDS, *CS5, (48, 64), use_udp=udp)
               for udp in (False, True)},
            'flipGaussianHeatmap': jgeo.flip_back(HM_G, FLIP),
            'flipCombinedTarget': jgeo.flip_back(HM_C, FLIP,
                                                 'CombinedTarget'),
            'warp_mat': warp_mat,
            'warp': jax_warp(np.repeat(IMG, 3, 0), warp_mat, (12, 16)),
        }
    return jax.jit(refs)()


def test_bbox_xyxy2xywh(jref):
    _close(tgeo.bbox_xyxy2xywh(B1), jref['xyxy2xywh'])


@pytest.mark.parametrize('inv', [False, True])
def test_affine_matrix(jref, inv):
    out = tgeo.affine_matrix(*CS2, ROT4, (48, 64), shift=(0.1, -0.2),
                             inv=inv)
    _close(out, jref[f'affine{inv}'], rtol=1e-5, atol=1e-4)


def test_invert_affine(jref):
    _close(tgeo.invert_affine(torch.from_numpy(MAT)), jref['invert'],
           rtol=1e-5, atol=1e-4)


def test_udp_warp_matrix(jref):
    _close(tgeo.udp_warp_matrix(ROT_UDP, *CS4, (192, 256)), jref['udp'],
           rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('use_udp', [False, True])
def test_transform_preds(jref, use_udp):
    _close(tgeo.transform_preds(COORDS, *CS5, (48, 64), use_udp=use_udp),
           jref[f'preds{use_udp}'], rtol=1e-5, atol=1e-4)


def test_flip_index_from_pairs():
    pairs = [[1, 2], [3, 4], [5, 6]]
    np.testing.assert_array_equal(tgeo.flip_index_from_pairs(pairs, 7),
                                  jgeo.flip_index_from_pairs(pairs, 7))


@pytest.mark.parametrize('target_type', ['GaussianHeatmap', 'CombinedTarget'])
def test_flip_back(jref, target_type):
    hm = HM_C if target_type == 'CombinedTarget' else HM_G
    _close(tgeo.flip_back(torch.from_numpy(hm), FLIP, target_type),
           jref[f'flip{target_type}'], rtol=0, atol=0)


def test_warp_affine_batch_from_one_expanded_image(jref):
    """cv2 semantics with the zero border, on an expanded (stride 0) batch
    of one image, as the inference API feeds it."""
    images = torch.from_numpy(IMG).expand(3, -1, -1, -1)
    out = warp_affine_batch(images, torch.from_numpy(np.array(
        jref['warp_mat'])), (12, 16))
    assert out.shape == (3, 16, 12, 3)
    assert (np.asarray(jref['warp']) == 0).any()        # the border is hit
    _close(out, jref['warp'])


def _engineered_heatmaps():
    """[2, 6, 16, 12] maps: interior, border and corner peaks, a tie between
    two equal peaks (first in row-major order wins), a map <= 0 everywhere,
    and a flat map."""
    h, w = 16, 12
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def g(x, y, sigma=2.0, amp=1.0):
        return amp * np.exp(-((xx - x) ** 2 + (yy - y) ** 2)
                            / (2 * sigma ** 2))

    maps = [
        [g(5.3, 7.6), g(0, 8), g(11, 15, amp=0.7), g(3, 4) + g(6, 10),
         -0.1 - g(6.3, 6.7), np.full((h, w), 0.5)],
        [g(7.8, 2.2, 1.5), g(4, 0, amp=2.0), g(0, 0), g(9, 3) + g(2, 13),
         g(6.5, 11.5, 3.0, 0.3), g(5, 5) * 0.01],
    ]
    return np.asarray(maps, np.float32)


MODES = {'udp': dict(use_udp=True), 'default': dict(post_process='default'),
         'unbiased': dict(post_process='unbiased'),
         'megvii': dict(post_process='megvii')}


@pytest.fixture(scope='module')
def jax_decoded():
    """JAX decode of the engineered maps in every mode, in one program."""
    hm = _engineered_heatmaps()
    c, s = _cs(9, n=2)
    def fn(h, c, s):
        return {'argmax': jdec.heatmaps_to_coords(h),
                **{mode: jdec.keypoints_from_heatmaps(h, c, s, kernel=11, **kw)
                   for mode, kw in MODES.items()}}

    # XLA's CPU backend at optimisation level 0 compiles this in half the
    # time; it moves the decoded coordinates by up to ~1e-4 px against the
    # default level (last bits of the transcendentals), inside the tolerance
    compiled = jax.jit(fn).lower(hm, c, s).compile(
        compiler_options={'xla_backend_optimization_level': 0})
    return hm, c, s, compiled(hm, c, s)


@pytest.mark.parametrize('mode', list(MODES))
def test_keypoints_from_heatmaps(jax_decoded, mode):
    hm, c, s, ref = jax_decoded
    preds, maxvals = tdec.keypoints_from_heatmaps(
        torch.from_numpy(hm), torch.from_numpy(np.asarray(c)),
        torch.from_numpy(np.asarray(s)), kernel=11, **MODES[mode])
    np.testing.assert_allclose(preds.numpy(), np.asarray(ref[mode][0]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(ref[mode][1]),
                               **TOL)


def test_argmax_ties_go_to_the_first_max(jax_decoded):
    hm, _, _, ref = jax_decoded
    coords, maxvals = tdec.heatmaps_to_coords(torch.from_numpy(hm))
    assert coords[0, 3].tolist() == [3.0, 4.0]
    assert coords[0, 4].tolist() == [-1.0, -1.0]         # max <= 0
    assert coords[0, 5].tolist() == [0.0, 0.0]           # flat map
    _close(coords, ref['argmax'][0], rtol=0, atol=0)
    _close(maxvals, ref['argmax'][1], rtol=0, atol=0)


def test_combined_target_decode_is_not_ported_yet():
    """Since item 7 the UDP CombinedTarget decode runs (held to JAX's in
    tests/test_torch_td_rest.py); another target type under UDP raises
    JAX's ValueError."""
    hm = torch.zeros(1, 3, 8, 6)
    hm[0, 0, 5, 2] = 1.0
    preds, maxvals = tdec.keypoints_from_heatmaps(
        hm, torch.zeros(1, 2), torch.ones(1, 2), use_udp=True,
        target_type='CombinedTarget')
    assert preds.shape == (1, 1, 2) and maxvals.shape == (1, 1, 1)
    assert float(maxvals) > 0
    with pytest.raises(ValueError, match='bad target_type'):
        tdec.keypoints_from_heatmaps(hm, torch.zeros(1, 2), torch.ones(1, 2),
                                     use_udp=True, target_type='Other')

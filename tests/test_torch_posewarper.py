"""PoseWarper in the port (ROADMAP item 12d) against the JAX package on the
CPU, at a small size: HRNet width 8 with one stage-2 module of one block,
64x48 crops, a 2-block neck 16 wide at dilations (1, 3), 3-frame windows,
17 deformable groups (one per joint, as the config).

The zoo's neck starts as an exact identity warp (zero offset convs,
identity deformable kernels), which samples nothing between pixels. Every
model here draws its offset convs so that the offsets are several pixels,
fractional and partly past the border, and its deformable kernels and BN
statistics at random (`shaped_model`), and checks that they are.

  * `deform_conv2d` against JAX's on seeded inputs: 1 and 17 groups, the v2
    mask, dilation 1 and 3, stride 2, offsets past the border; within 1e-5
    of the largest output.
  * The model (JAX's variables by JAX's converter from the port's state
    dict) in eval and training mode: heatmaps within 1e-4 of the largest,
    the BN statistics after a training-mode pass within 1e-5.
  * Two Adam steps from the same weights and batch (JAX's step as its loop
    compiles it, at XLA level 0): the loss 1e-4 relative, every parameter
    within the steps' lr of JAX's (Adam's first step turns f32 noise on
    near-zero gradients into +-lr), the BN statistics 1e-4; trans_layer
    bit for bit unchanged on both sides.
  * PoseTrackVideoDataset's records in test and train mode equal to JAX's;
    `load_window` byte for byte with and without the augmentation, given
    the same crop affine (XLA's own is within an ulp).
  * `evaluate_posewarper` through the evaluation CLI: the mAP table equal
    to JAX's within 1e-9; the CLI's loader reads JAX's .npz into the same
    weights.
  * The training CLI: two steps, then `--resume` (final.pth).
  * The converters both ways, exactly, and JAX's refusal of a checkpoint
    whose head tensors the config does not build.
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitpose_tpu.data.posetrack import PoseTrackVideoDataset as JaxVideoSet
from vitpose_tpu.eval.families import evaluate_posewarper as jax_evaluate
from vitpose_tpu.models.losses import joints_mse_loss as jax_mse
from vitpose_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build
from vitpose_tpu.train.posewarper_loop import load_window as jax_load_window
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.config import load_config as jax_load_config
from vitpose_tpu.utils.family_ckpt import convert_posewarper_checkpoint

from test_torch_data import assert_same_tree
from vitpose_tpu_torch.api.inference import init_pose_model, load_checkpoint
from vitpose_tpu_torch.data import PoseTrackVideoDataset
from vitpose_tpu_torch.models.posewarper import PoseWarper
from vitpose_tpu_torch.ops.deform_conv import deform_conv2d
from vitpose_tpu_torch.ops.target import generate_msra_heatmaps
from vitpose_tpu_torch.tools import test as test_cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train.bottomup_loop import piecewise_constant_lr
from vitpose_tpu_torch.train.family_loop import adam
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.train.posewarper_loop import (load_window,
                                                     posewarper_step,
                                                     trainable_parameters)
from vitpose_tpu_torch.utils.convert import posewarper_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'posetrack',
                      'posewarper_hrnet_w48_posetrack18.py')
SMALL_BACKBONE = dict(width=8, stage_modules=(1,), stage_blocks=1)
SMALL_NECK = dict(out_channels=17, inner_channels=16, num_blocks=2,
                  trans_conv_kernel=1, dilations=(1, 3))
MDICT = dict(family='posewarper', backbone_type='hrnet',
             backbone_overrides=SMALL_BACKBONE, neck=SMALL_NECK,
             out_channels=17)
IMAGE_HW = (64, 48)
FRAME_WEIGHT = np.array([0.5, 0.2, 0.3], np.float32)
LR = 1e-3
# (h, w) of the fixture's frames; its videos: (frames, labelled frames)
FRAME_HW = (96, 80)
VIDEOS = {'000001': (6, (0, 1, 2, 4)), '000002': (5, (1, 3))}


def shaped_model(seed, mdict=MDICT):
    """The port's model of `mdict` with every weight drawn from a seeded
    numpy generator: random BN statistics and affine, offset convs that
    give offsets of several pixels, random deformable kernels."""
    model = build_model_from_cfg(mdict, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for name, t in sd.items():
        shape = tuple(t.shape)
        if name.endswith('num_batches_tracked'):
            continue
        if name.endswith('running_var'):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith('running_mean') or name.endswith('bias'):
            a = 0.1 * rng.standard_normal(shape)
        elif 'offset_layers' in name:
            a = 3.0 * rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif t.ndim == 1:                       # BN scale
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        sd[name] = torch.from_numpy(a.astype(np.float32))
    model.load_state_dict(sd)
    return model


def jax_variables(model, mdict=MDICT):
    """JAX's variables of the port model, by JAX's converter (copies: a
    CPU jax array may alias a numpy array's memory)."""
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return jax.tree.map(jnp.asarray, convert_posewarper_checkpoint(
        sd, {'model': mdict}))


def compiled(fn, *args, level=0):
    """jax.jit(fn) lowered for `args`, compiled at XLA level `level`."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': level})


@pytest.fixture(scope='module')
def pair():
    """(port model, JAX model, JAX variables, frames [2, 3, 64, 48, 3])."""
    model = shaped_model(1)
    frames = np.random.RandomState(2).randn(2, 3, *IMAGE_HW, 3).astype(
        np.float32)
    return model, jax_build(MDICT), jax_variables(model), frames


@pytest.mark.parametrize('case', ['g1', 'g17_mask_dil3', 'g2_stride2_mask'])
def test_deform_conv2d_matches_jax(case):
    g, cin, cout, dil, stride, mask = {
        'g1': (1, 4, 5, 1, 1, False),
        'g17_mask_dil3': (17, 17, 17, 3, 1, True),
        'g2_stride2_mask': (2, 6, 3, 1, 2, True)}[case]
    rng = np.random.RandomState(len(case))
    n, h, w, k = 2, 9, 7, 3
    ho = (h + 2 * dil - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * dil - dil * (k - 1) - 1) // stride + 1
    x = rng.randn(n, h, w, cin).astype(np.float32)
    # a few pixels, fractional, many samples past the border
    off = (rng.randn(n, ho, wo, 2 * k * k * g) * 4).astype(np.float32)
    wt = rng.randn(k, k, cin, cout).astype(np.float32)
    m = rng.rand(n, ho, wo, k * k).astype(np.float32) if mask else None
    args = [jnp.asarray(a) for a in (x, off, wt) + (() if m is None
                                                     else (m,))]

    def run(x, off, wt, m=None):
        return jax_deform_conv2d(x, off, wt, m, stride=stride, padding=dil,
                                 dilation=dil, deform_groups=g)

    want = np.asarray(compiled(run, *args)(*args))
    got = deform_conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(off).permute(0, 3, 1, 2),
        torch.from_numpy(wt).permute(3, 2, 0, 1),
        None if m is None else torch.from_numpy(m).permute(0, 3, 1, 2),
        stride=stride, padding=dil, dilation=dil, deform_groups=g)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5 * np.abs(want).max(), rtol=0)
    assert np.abs(off).max() > max(h, w)


def _offsets(model, frames):
    """The offsets each dilation's conv gives on `frames` in eval mode, key
    frame 0 (the neck's own steps, run as modules)."""
    neck = model.neck
    with torch.no_grad():
        model.eval()
        n, t = frames.shape[:2]
        feats = model.backbone(frames.reshape(n * t, *frames.shape[2:]))
        sup = neck.trans_layer(feats)
        key = sup.reshape(n, t, *sup.shape[1:])[:, 0]
        diff = neck.offset_feats(key.repeat_interleave(t, 0) - sup)
        return [layer(diff) for layer in neck.offset_layers]


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_posewarper_matches_jax(pair, train):
    """Heatmaps of the whole model (backbone over every frame, the neck's
    warps at both dilations, frame weights, key frame 0) and, in training
    mode, every BN statistic after the pass."""
    model, jm, v, frames = pair
    model = shaped_model(1) if train else model
    for d, off in zip(SMALL_NECK['dilations'],
                      _offsets(model, torch.from_numpy(frames))):
        mag = off.abs()
        frac = mag - mag.floor()
        assert mag.max() > 4 and (mag > 1).float().mean() > 0.3
        assert ((frac > 0.05) & (frac < 0.95)).float().mean() > 0.5
        # the share of bilinear samples past the border
        n, _, h, w = off.shape
        xy = off.reshape(n, 17, 3, 3, 2, h, w)
        taps = (torch.arange(3) - 1) * d
        y = torch.arange(h)[:, None] + taps[:, None, None, None] + xy[..., 0,
                                                                   :, :]
        x = torch.arange(w) + taps[None, :, None, None] + xy[..., 1, :, :]
        out = (y < 0) | (y > h - 1) | (x < 0) | (x > w - 1)
        assert 0.05 < out.float().mean() < 0.6
    model.train(train)
    got = model(torch.from_numpy(frames), frame_weight=torch.from_numpy(
        FRAME_WEIGHT), key_index=0).detach().numpy()

    def run(v, x):
        return jm.apply(v, x, train=train, frame_weight=FRAME_WEIGHT,
                        key_index=0, mutable=['batch_stats'] if train
                        else False)

    out = compiled(run, v, jnp.asarray(frames))(v, jnp.asarray(frames))
    want = np.asarray(out[0] if train else out)
    assert got.shape == want.shape == (2, 17, 16, 12)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    if train:
        after = posewarper_state_dict_from_flax(
            {'params': jax.tree.map(np.asarray, v['params']),
             'batch_stats': jax.tree.map(np.asarray,
                                         out[1]['batch_stats'])})
        for name, t in model.state_dict().items():
            if 'running_' in name:
                np.testing.assert_allclose(t.numpy(), after[name].numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=name)


F64 = dict(MDICT, backbone_overrides=dict(SMALL_BACKBONE, dtype='float64'),
           neck=dict(SMALL_NECK, dtype='float64'))


def jax_posewarper_steps(variables, frames, target, weight, n=2):
    """JAX's PoseWarper step as train_posewarper_model builds it (Adam,
    the trans_layer update masked to zero, key frame 0, the train frame
    weights) in float64 (64-bit JAX for this call; XLA level 1, which
    compiles f64 convs faster than level 0); [(loss, params, batch_stats,
    Adam's first moment)] after each of `n` steps, as numpy f64."""
    with jax.enable_x64(True):
        jm = jax_build(F64)
        tx = optax.chain(optax.adam(LR), optax.masked(
            optax.set_to_zero(),
            lambda params: jax.tree_util.tree_map_with_path(
                lambda path, _: any(getattr(k, 'key', None) == 'trans_layer'
                                    for k in path), params)))
        variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                 variables)
        params = variables['params']
        stats = {'batch_stats': variables['batch_stats']}
        fw = jnp.asarray(FRAME_WEIGHT, jnp.float64)

        def step(params, stats, opt_state, frames, target, weight):
            def loss_fn(p):
                out, new_vars = jm.apply({'params': p, **stats}, frames,
                                         train=True, frame_weight=fw,
                                         key_index=0,
                                         mutable=['batch_stats'])
                return jax_mse(out, target, weight), new_vars
            (loss, new_vars), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_vars, \
                opt_state, loss

        opt_state = tx.init(params)
        args = (params, stats, opt_state) + tuple(
            jnp.asarray(a, jnp.float64) for a in (frames, target, weight))
        fn = compiled(step, *args, level=1)
        out = []
        for _ in range(n):
            params, stats, opt_state, loss = fn(params, stats, opt_state,
                                                *args[3:])
            mu = next(st.mu for st in jax.tree.leaves(
                opt_state, is_leaf=lambda st: hasattr(st, 'mu'))
                if hasattr(st, 'mu'))
            out.append((float(loss), jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, stats['batch_stats']),
                        jax.tree.map(np.asarray, mu)))
        return out


def test_two_train_steps_match_jax(pair):
    """Two steps from the same weights and batch with trans_layer frozen,
    both packages in float64: in f32, flax's BN statistics over these
    16x12 and 8x6 maps lose digits and JAX's first gradients leave an f64
    run by up to 2% of a tensor's largest (the port's stay within 1e-6),
    as PRs 11-12 found for small maps. Step 1: the loss 1e-6 relative, the
    gradients (Adam's first moment) 1e-5 of each tensor's largest, every
    parameter 1e-6 but for at most 1e-4 of them, which Adam's first step
    moves by +-lr on noise-sized gradients (JAX's deformable contraction
    accumulates in f32), the BN statistics 1e-6. Step 2: the loss 1e-6,
    the parameters within the two steps' lr (a parameter 1e-5 apart moves
    a bilinear sample across a pixel edge, where its gradient jumps), the
    BN statistics 1e-4 of each one's largest."""
    _, _, v, frames = pair
    model = build_model_from_cfg(F64).double()
    model.load_state_dict(shaped_model(1).state_dict())
    frames = frames.astype(np.float64)
    rng = np.random.RandomState(3)
    joints = rng.uniform(0, 48, (2, 17, 2)).astype(np.float32)
    vis = (rng.rand(2, 17) > 0.2).astype(np.float32)
    target, weight = generate_msra_heatmaps(
        torch.from_numpy(joints), torch.from_numpy(vis), (48, 64), (12, 16),
        sigma=2.0)
    target, weight = target.double(), weight.double()
    ref = jax_posewarper_steps(v, frames, target.numpy(), weight.numpy())
    frozen = {k: t.clone() for k, t in model.state_dict().items()
              if k.startswith('neck.trans_layer.')}
    optimizer, scheduler = adam(trainable_parameters(model, {'model': F64}),
                                LR, piecewise_constant_lr(LR, ()))
    for i, (loss, params, stats, mu) in enumerate(ref):
        got = posewarper_step(model, optimizer, scheduler,
                              torch.from_numpy(frames), target, weight,
                              torch.from_numpy(FRAME_WEIGHT).double())
        assert float(got['heatmap_loss']) == pytest.approx(
            loss, rel=1e-6 if i == 0 else 1e-5)
        want = posewarper_state_dict_from_flax(
            {'params': params, 'batch_stats': stats})
        if i == 0:
            moments = posewarper_state_dict_from_flax({'params': mu})
            for name, p in model.named_parameters():
                if name in moments and not name.startswith(
                        'neck.trans_layer.'):
                    m = moments[name].numpy()
                    np.testing.assert_allclose(
                        optimizer.state[p]['exp_avg'].numpy(), m, rtol=0,
                        atol=1e-5 * np.abs(m).max(), err_msg=name)
        moved, total = 0, 0
        for name, t in model.state_dict().items():
            if name.endswith('num_batches_tracked'):
                continue
            a, b = t.numpy(), want[name].numpy()
            if 'running_' in name:
                np.testing.assert_allclose(a, b, rtol=0, atol=(
                    1e-6 if i == 0 else 1e-4) * np.abs(b).max(),
                    err_msg=f'step {i} {name}')
                continue
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2 * LR * (i + 1),
                                       err_msg=f'step {i} {name}')
            moved += int((np.abs(a - b) > 1e-6).sum())
            total += a.size
        if i == 0:
            assert moved <= 1e-4 * total, (moved, total)
    for name, t in frozen.items():
        assert torch.equal(model.state_dict()[name], t), name
        assert np.array_equal(want[name].numpy(), t.numpy()), name


# --- data -------------------------------------------------------------------

def write_video_fixture(root, seed):
    """Two PoseTrack18-style videos, each in its own folder of consecutive
    %06d.jpg frames with `nframes`, people on the labelled frames (boxes,
    17 joints, head boxes, track ids); the second video's last frame file
    is missing (its supports fall back to the key frame). Returns the
    annotation file and the image prefix."""
    rng = np.random.RandomState(seed)
    h, w = FRAME_HW
    images, anns = [], []
    for vid, (nframes, labelled) in VIDEOS.items():
        folder = os.path.join(root, 'images', 'val', vid)
        os.makedirs(folder, exist_ok=True)
        for f in range(nframes):
            name = f'images/val/{vid}/{f:06d}.jpg'
            img_id = int(vid) * 100 + f
            if not (vid == '000002' and f == nframes - 1):
                cv2.imwrite(os.path.join(root, name),
                            rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
            images.append(dict(id=img_id, file_name=name, width=w, height=h,
                               vid_id=vid, frame_id=img_id, nframes=nframes,
                               is_labeled=f in labelled))
            if f not in labelled:
                continue
            for p in range(2):
                bw, bh = rng.uniform(20, 36), rng.uniform(40, 70)
                x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                kp = np.concatenate([
                    rng.uniform((x, y), (x + bw, y + bh), (17, 2)),
                    (rng.rand(17, 1) > 0.15) * 2], 1)
                anns.append(dict(
                    id=len(anns) + 1, image_id=img_id, category_id=1,
                    bbox=[x, y, bw, bh], area=bw * bh, iscrowd=0,
                    keypoints=kp.ravel().tolist(),
                    num_keypoints=int((kp[:, 2] > 0).sum()),
                    bbox_head=[x, y, 10.0, 10.0], track_id=p))
    ann = os.path.join(root, 'ann.json')
    with open(ann, 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    return ann, root + '/'


@pytest.fixture(scope='module')
def video_set(tmp_path_factory):
    return write_video_fixture(str(tmp_path_factory.mktemp('posetrack')), 5)


def _sets(video_set, test_mode):
    ann, prefix = video_set
    kw = dict(image_size=(48, 64), heatmap_size=(12, 16),
              test_mode=test_mode, use_gt_bbox=True, seed=4)
    if test_mode:
        kw['frame_indices_test'] = (-2, -1, 0, 1, 2)
    else:
        kw['num_adj_frames'] = 2
    return (JaxVideoSet(ann, prefix, **kw),
            PoseTrackVideoDataset(ann, prefix, **kw))


@pytest.mark.parametrize('test_mode', [True, False], ids=['test', 'train'])
def test_video_records_match_jax(video_set, test_mode):
    ref, port = _sets(video_set, test_mode)
    assert_same_tree(port.db, ref.db)
    assert port.num_frames == ref.num_frames == (5 if test_mode else 3)
    files = [f for r in port.db for f in r['image_files']]
    assert all(os.path.exists(f) for f in files)
    if test_mode:
        # frame order [key, -2, -1, 1, 2] with JAX's test weights; a missing
        # support (the last frame of video 2) falls back to the key frame
        assert np.allclose(port.db[0]['frame_weight'],
                           (0.3, 0.1, 0.25, 0.25, 0.1))
        late = [r for r in port.db if '000002/000003' in r['image_file']]
        assert late and all(r['image_files'][3:] == [r['image_file']] * 2
                            for r in late)


@pytest.mark.parametrize('mode', ['test', 'train', 'train_rot'])
def test_load_window_matches_jax(video_set, mode, monkeypatch):
    """Windows byte for byte, augmentation drawn in JAX's order, given the
    same crop affine: XLA's f32 arithmetic rounds JAX's own affine up to
    an ulp from the port's (4e-6 in a translation), so JAX's load_window
    takes the port's matrix here, and the two matrices are held within
    1e-6 relative."""
    from vitpose_tpu.ops import geometry as jgeometry
    from vitpose_tpu_torch.ops.geometry import affine_matrix
    jax_affine = jgeometry.affine_matrix
    gaps = []

    def port_affine(*args):
        want = np.asarray(jax_affine(*args))
        got = affine_matrix(*args).numpy()
        gaps.append(np.abs(got - want).max() / np.abs(want).max())
        return got

    monkeypatch.setattr(jgeometry, 'affine_matrix', port_affine)
    ref, port = _sets(video_set, mode == 'test')
    kw = {} if mode == 'test' else dict(
        flip_pairs=port.info.flip_pairs, info=port.info, half_body_prob=0.5,
        rot_prob=0.0 if mode == 'train' else 1.0)
    rngs = ((None, None) if mode == 'test' else
            (np.random.RandomState(6), np.random.RandomState(6)))
    for rec_ref, rec in zip(ref.db, port.db):
        want = jax_load_window(rec_ref, (48, 64), rng=rngs[0], **kw)
        got = load_window(rec, (48, 64), rng=rngs[1], **kw)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.array_equal(a, b)
    assert len(gaps) == len(port.db) and max(gaps) < 1e-6


# --- the CLIs and the converters -------------------------------------------

def small_config(root, ann, prefix):
    path = os.path.join(root, 'posewarper_small.py')
    with open(path, 'w') as f:
        f.write(
            f"_base_ = ['{CONFIG}']\n"
            f"model = dict(backbone_overrides={SMALL_BACKBONE!r},\n"
            f"             neck=dict(inner_channels=16, num_blocks=2,\n"
            f"                       dilations=(1, 3)))\n"
            f"data = dict(image_size=(48, 64), heatmap_size=(12, 16),\n"
            f"            frame_indices=(-1, 0, 1), batch_size=4,\n"
            f"            train=dict(ann_file='{ann}', img_prefix='{prefix}'),\n"
            f"            val=dict(_delete_=True, ann_file='{ann}',\n"
            f"                     img_prefix='{prefix}'))\n"
            f"optimizer = dict(base_lr={LR}, decay_epochs=(1,),\n"
            f"                 total_epochs=2)\n")
    return path


class _Compiled:
    """JAX's model behind `apply`, one XLA level-0 program per shape."""

    def __init__(self, jm):
        self.jm, self.fns = jm, {}

    def apply(self, v, x, train=False, frame_weight=None, key_index=None):
        key = (x.shape, tuple(np.asarray(frame_weight)))
        if key not in self.fns:
            fw = np.asarray(frame_weight)
            self.fns[key] = compiled(lambda v, x: self.jm.apply(
                v, x, train=False, frame_weight=fw, key_index=key_index),
                v, x)
        return self.fns[key](v, x)


def test_eval_cli_matches_jax(video_set, tmp_path):
    """The evaluation CLI (flip test, 1-pixel shift) on the port's .pth and
    on JAX's .npz gives JAX's evaluate_posewarper table."""
    ann, prefix = video_set
    path = small_config(str(tmp_path), ann, prefix)
    cfg = jax_load_config(path)
    model = shaped_model(7, cfg['model'])
    ckpt = str(tmp_path / 'w.pth')
    torch.save(model.state_dict(), ckpt)
    v = jax_variables(model, cfg['model'])
    npz = str(tmp_path / 'w.npz')
    save_params_npz(npz, jax.tree.map(np.asarray, v))
    want = jax_evaluate(cfg, _Compiled(jax_build(cfg['model'])), v)
    out = str(tmp_path / 'stats.json')
    test_cli.main([path, ckpt, '--device', 'cpu', '--out', out])
    with open(out) as f:
        got = json.load(f)
    assert list(got) == list(want) and 'Total AP' in got
    for k, value in want.items():
        assert abs(got[k] - value) <= 1e-9 or (
            np.isnan(got[k]) and np.isnan(value)), (k, got[k], value)
    # the CLI's checkpoint loader reads JAX's .npz into the same weights;
    # init_pose_model on the config gives the PoseWarper itself
    twin = init_pose_model(path, checkpoint=npz, device='cpu')
    assert isinstance(twin, PoseWarper) and not twin.training
    for k, t in model.state_dict().items():
        assert torch.equal(twin.state_dict()[k], t), k


def test_train_cli_freezes_trans_layer_and_resumes(video_set, tmp_path):
    ann, prefix = video_set
    path = small_config(str(tmp_path), ann, prefix)
    work = str(tmp_path / 'work')
    args = [path, '--work-dir', work, '--device', 'cpu', '--max-steps', '2',
            '--cfg-options', 'data.batch_size=2']
    model, metrics = train_cli.main(args)
    assert np.isfinite(metrics['heatmap_loss'])
    first = torch.load(os.path.join(work, 'final.pth'), weights_only=True)
    init = build_model_from_cfg(jax_load_config(path)['model'],
                                torch.Generator().manual_seed(0))
    for name, t in init.state_dict().items():
        if name.startswith('neck.trans_layer.'):
            assert torch.equal(first[name], t), name
    assert any(not torch.equal(first[n], t)
               for n, t in init.state_dict().items())
    model, _ = train_cli.main(args + ['--resume'])
    second = torch.load(os.path.join(work, 'final.pth'), weights_only=True)
    assert any(not torch.equal(second[n], t) for n, t in first.items()
               if 'offset_feats' in n)
    with open(os.path.join(work, 'train.log.json')) as f:
        log = [json.loads(line) for line in f]
    assert [r['step'] for r in log] == [2, 2]


def test_converters_round_trip_and_refuse_head(tmp_path):
    """state dict -> JAX's convert_posewarper_checkpoint -> the port's
    inverse gives the state dict back exactly, with the identity head and
    with a deconv head; a checkpoint with head tensors for the identity
    head is refused by both packages."""
    with_head = dict(MDICT, head_overrides=dict(
        deconv_filters=(8,), deconv_kernels=(4,), final_kernel=1))
    for mdict in (MDICT, with_head):
        sd = shaped_model(3, mdict).state_dict()
        flax = convert_posewarper_checkpoint(
            {k: v.numpy() for k, v in sd.items()}, {'model': mdict})
        back = posewarper_state_dict_from_flax(flax)
        assert sorted(back) == sorted(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v.float()), k
    sd = {k: v.numpy() for k, v in shaped_model(3, with_head)
          .state_dict().items()}
    with pytest.raises(ValueError, match='keypoint_head tensors'):
        convert_posewarper_checkpoint(sd, {'model': MDICT})
    ckpt = str(tmp_path / 'head.pth')
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    with pytest.raises(ValueError, match='keypoint_head tensors'):
        load_checkpoint(build_model_from_cfg(MDICT), ckpt)

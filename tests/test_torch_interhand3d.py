"""InterHand3D (InterNet, ROADMAP item 12f) in the port against the JAX
package on the CPU, at a small size: a ResNet trunk of one block a stage
(`resnet10`) on 64x64 crops, two
8-wide deconvs to 8x8 maps, 8 depth bins, 42 joints, synthetic
InterHand2.6M annotation, camera and joint files in `tmp_path`.

  * The estimator in eval and training mode (mmpose's split right/left
    heads; JAX's variables by JAX's converter from the port's state dict,
    seeded BN statistics): the volumes, root and hand-type logits within
    1e-5 of each one's largest, the BN statistics after a training pass
    1e-5; JAX's fused head from JAX's init through the port's converter;
    the converters' round trip exact.
  * The decode (argmax, soft-argmax root depth, sigmoid) on the same
    outputs, back-projection, the three losses and their gradients, the
    2.5D targets: equal or within 1e-6 relative.
  * The dataset's records, the loader's batches (flip, translation,
    scale, rotation drawn from the same RandomState) and `evaluate`
    (MPJPE, MRRPE, Handedness_acc, AUC) against JAX's.
  * Two training steps against JAX's step (the trunk in float64, XLA
    level 0), the
    evaluation CLI (JAX's .npz) against JAX's
    evaluate_interhand3d, the training CLI with --resume, the 3D API and
    the demo on the CPU.
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import interhand as jih
from vitpose_tpu.models import interhand3d as jmodel
from vitpose_tpu.models.resnet import ResNet as JaxResNet
from vitpose_tpu.ops import target as jtarget
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.family_ckpt import convert_interhand3d_checkpoint

from test_torch_data import assert_same_tree
from vitpose_tpu_torch.data import interhand as pih
from vitpose_tpu_torch.models import interhand3d as pmodel
from vitpose_tpu_torch.ops import target as ptarget
from vitpose_tpu_torch.tools import test as test_cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train import interhand_loop as ploop
from vitpose_tpu_torch.train.family_loop import adam
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils.convert import interhand3d_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

# the trunk of every test here and in test_torch_mesh: one basic block a
# stage, as depth 10 in both packages' RESNET_SPECS while the module runs
# (ResNet-18's stages and widths at half its blocks, half JAX's traces)
DEPTH = 10


@pytest.fixture(scope='module', autouse=True)
def resnet10():
    from vitpose_tpu.models import resnet as jresnet
    from vitpose_tpu_torch.models import resnet as presnet
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jresnet, presnet):
            mp.setitem(mod.RESNET_SPECS, DEPTH, ('basic', (1, 1, 1, 1)))
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'hand',
                      'res50_interhand3d_all_256x256.py')
MDICT = dict(family='interhand3d', backbone_type='resnet',
             backbone_overrides=dict(depth=DEPTH), num_joints=42, depth_size=8,
             heatmap_size=(8, 8), split_hands=True, deconv_filters=(8, 8))
CFG = {'model': MDICT}


def shaped_model(seed, mdict=MDICT):
    """The port's estimator with seeded BN statistics and biases."""
    model = build_model_from_cfg(mdict, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith('running_var'):
            sd[name] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)
                                        .astype(np.float32))
        elif name.endswith('running_mean') or (
                name.endswith('bias') and 'bn' in name):
            sd[name] = torch.from_numpy(0.1 * rng.standard_normal(t.shape)
                                        .astype(np.float32))
    model.load_state_dict(sd)
    return model


def jax_estimator(mdict=MDICT):
    kw = {k: v for k, v in mdict.items()
          if k not in ('family', 'backbone_type', 'backbone_overrides')}
    return jmodel.Interhand3DEstimator(
        backbone=JaxResNet(**mdict['backbone_overrides']),
        backbone_mode_kwarg='train', **kw)


def jax_variables(model):
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return jax.tree.map(jnp.asarray, convert_interhand3d_checkpoint(sd, CFG))


def compiled(fn, *args, level=0):
    """jit(fn) lowered for `args` and compiled at XLA optimisation
    `level`."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': level})


def close(a, b, tol=1e-5, what='', atol=None):
    """|a - b| within `tol` of b's largest magnitude (or within `atol`)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    bound = atol if atol is not None else tol * max(np.abs(b).max(), 1e-30)
    worst = np.abs(a - b).max() if a.size else 0.0
    assert worst <= bound, f'{what}: {worst} > {bound}'


class _JaxInfer:
    """JAX's estimator behind `infer` and `decode`, apply compiled once per
    input shape."""

    def __init__(self, est):
        self.est, self.fns = est, {}

    def infer(self, v, x):
        x = jnp.asarray(x)
        if x.shape not in self.fns:
            self.fns[x.shape] = compiled(
                lambda v, x: self.est.apply(v, x), v, x)
        return self.fns[x.shape](v, x)

    def decode(self, *args):
        return self.est.decode(*args)


@pytest.fixture(scope='module')
def pair():
    """(port model, JAX estimator behind _JaxInfer, JAX variables, 64x64
    crops)."""
    model = shaped_model(0)
    x = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    return model, _JaxInfer(jax_estimator()), jax_variables(model), x


def test_estimator_matches_jax(pair):
    """Eval mode: the volumes, root and hand-type logits within 1e-5 of
    each one's largest (training mode: test_two_train_steps_match_jax)."""
    model, jest, v, x = pair
    got = model.eval()(torch.from_numpy(x))
    assert got[0].shape == (2, 42, 8, 8, 8)
    for a, b, name in zip(got, jest.infer(v, x), ('hm3d', 'root', 'type')):
        close(a.detach().numpy(), b, 1e-5, name)


def test_fused_head_from_jax_and_round_trip():
    """JAX's fused head (split_hands False: `deconv_i`, `bn_i`, `hm3d`):
    seeded variables in the tree JAX's init gives (its shapes, traced
    without running) load through the port's converter and give JAX's
    head outputs on the same features within 1e-5; the split layout goes
    port -> JAX -> port exactly."""
    from vitpose_tpu.models.heads_extra import Interhand3DHead as JaxHead
    from vitpose_tpu_torch.models.heads_extra import Interhand3DHead
    head = JaxHead(num_joints=42, depth_size=8, deconv_filters=(8, 8))
    feat = np.random.RandomState(2).randn(2, 2, 2, 512).astype(np.float32)
    shapes = jax.eval_shape(head.init, jax.random.PRNGKey(0),
                            jnp.asarray(feat))
    rng = np.random.RandomState(8)
    v = jax.tree.map(lambda s: np.asarray(
        rng.uniform(0.5, 1.5, s.shape) if len(s.shape) == 1
        else rng.randn(*s.shape) * np.prod(s.shape[:-1]) ** -0.5,
        np.float32), shapes)
    port = Interhand3DHead(512, 42, 8, deconv_filters=(8, 8)).eval()
    sd = interhand3d_state_dict_from_flax(
        {'backbone': {}, 'head': v}, 'resnet')
    port.load_state_dict({k[len('keypoint_head.'):]: t
                          for k, t in sd.items()})
    want = compiled(lambda v, x: head.apply(v, x), v, feat)(v, feat)
    got = port(torch.from_numpy(feat).permute(0, 3, 1, 2))
    for a, b in zip(got, want):
        close(a.detach().numpy(), b, 1e-5)
    sd = shaped_model(3).state_dict()
    back = interhand3d_state_dict_from_flax(convert_interhand3d_checkpoint(
        {k: t.numpy() for k, t in sd.items()}, CFG), 'resnet')
    assert sorted(back) == sorted(sd)
    for k, t in sd.items():
        assert torch.equal(back[k], t.float() if t.is_floating_point()
                           else t), k


def test_decode_backproject_and_losses_match_jax(pair):
    model, jest, _, _ = pair
    est = jest.est
    rng = np.random.RandomState(4)
    hm = rng.rand(3, 42, 8, 8, 8).astype(np.float32) - 0.2
    hm[2, 5] = -1.0                       # maxval <= 0: coords -1
    root = rng.randn(3, 64).astype(np.float32)
    typ = rng.randn(3, 2).astype(np.float32)
    center = rng.uniform(50, 150, (3, 2)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (3, 2)).astype(np.float32)
    got = model.decode(torch.from_numpy(hm), torch.from_numpy(root),
                       torch.from_numpy(typ), center, scale)
    want = est.decode(hm, root, typ, center, scale)
    assert list(got) == list(want)
    for k in want:
        close(got[k], want[k], 1e-6, k)
    focal = rng.uniform(800, 1200, (3, 2))
    princpt = rng.uniform(100, 200, (3, 2))
    depth = rng.uniform(500, 900, (3, 2))
    assert np.array_equal(
        pmodel.backproject_to_camera(want['keypoints_3d'], focal, princpt,
                                     depth),
        jmodel.backproject_to_camera(want['keypoints_3d'], focal, princpt,
                                     depth))
    target = rng.rand(3, 42, 8, 8, 8).astype(np.float32)
    args = (rng.rand(3, 42).astype(np.float32),
            np.array([-150.0, 30.0, 260.0], np.float32),   # one out of range
            np.array([1.0, 1.0, 0.0], np.float32),
            (rng.rand(3, 2) > 0.5).astype(np.float32),
            np.array([1.0, 0.0, 1.0], np.float32))
    ts = [torch.tensor(a, requires_grad=True) for a in (hm, root, typ)]
    out = pmodel.interhand3d_losses(ts, torch.from_numpy(target),
                                    *map(torch.from_numpy, args))
    total = sum(out.values())
    total.backward()

    def jf(hm, root, typ):
        d = jmodel.interhand3d_losses((hm, root, typ), target, *args)
        return sum(d.values()), d
    jargs = [jnp.asarray(a) for a in (hm, root, typ)]
    (jt, jd), jg = compiled(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True), *jargs)(*jargs)
    for k in jd:
        assert float(out[k].detach()) == pytest.approx(float(jd[k]),
                                                       rel=1e-6), k
    for t, g in zip(ts, jg):
        close(t.grad.numpy(), g, 1e-5)


def test_3d_heatmaps_match_jax():
    rng = np.random.RandomState(5)
    joints = np.concatenate([rng.uniform(-10, 74, (42, 2)),
                             rng.uniform(-260, 260, (42, 1))], 1)
    vis = (rng.rand(42, 3) > 0.2).astype(np.float32)
    args = (joints, vis, (64, 64), (8, 8, 8), 400.0)
    for kw in (dict(sigma=2.5), dict(sigma=1.0, joint_indices=[0, 3, 41],
                                     joint_weights=np.arange(42.0))):
        assert_same_tree(ptarget.generate_3d_heatmaps(*args, **kw),
                         jtarget.generate_3d_heatmaps(*args, **kw))


# --- data -------------------------------------------------------------------

def write_interhand_set(root, name, seed, n=6):
    """InterHand2.6M-layout annotation, camera and joint jsons for `n`
    images of two captures (the last without annotations), and a JPEG per
    image."""
    rng = np.random.RandomState(seed)
    images, anns, joints, cams = [], [], {}, {}
    for cap in ('0', '1'):
        cams[cap] = {k: {} for k in ('campos', 'camrot', 'focal',
                                     'princpt')}
        for cam in ('400262', '400263'):
            th = rng.uniform(-0.3, 0.3)
            cams[cap]['campos'][cam] = rng.uniform(-50, 50, 3).tolist()
            cams[cap]['camrot'][cam] = [[np.cos(th), 0, np.sin(th)],
                                        [0, 1, 0],
                                        [-np.sin(th), 0, np.cos(th)]]
            cams[cap]['focal'][cam] = rng.uniform(900, 1100, 2).tolist()
            cams[cap]['princpt'][cam] = rng.uniform(140, 180, 2).tolist()
        joints[cap] = {}
    types = ['right', 'left', 'interacting']
    os.makedirs(os.path.join(root, 'images'), exist_ok=True)
    for i in range(n):
        cap, cam, frame = str(i % 2), ('400262', '400263')[i % 3 % 2], str(i)
        wrist = np.array([rng.uniform(-30, 30), rng.uniform(-30, 30),
                          rng.uniform(700, 900)])
        world = wrist + rng.randn(42, 3) * [25, 25, 40]
        joints[cap][frame] = {'world_coord': world.tolist()}
        file_name = f'images/{name}_{i}.jpg'
        cv2.imwrite(os.path.join(root, file_name),
                    rng.randint(0, 255, (320, 320, 3), np.uint8))
        images.append(dict(id=i, file_name=file_name, capture=int(cap),
                           camera=cam, frame_idx=int(frame), width=320,
                           height=320))
        if i == n - 1:
            continue
        valid = (rng.rand(42) > 0.1).astype(int)
        valid[[20, 41]] = 1 if i % 4 else [1, 0]
        anns.append(dict(id=100 + i, image_id=i, bbox=rng.uniform(
            [60, 60, 90, 90], [120, 120, 160, 160]).tolist(),
            joint_valid=valid.tolist(), hand_type=types[i % 3],
            hand_type_valid=int(i % 5 != 0)))
    paths = {}
    for key, data in (('ann', dict(images=images, annotations=anns,
                                   categories=[dict(id=1, name='hand')])),
                      ('camera', cams), ('joint', joints)):
        paths[key] = os.path.join(root, f'{name}_{key}.json')
        with open(paths[key], 'w') as f:
            json.dump(data, f)
    return paths


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('interhand'))
    return root, {name: write_interhand_set(root, name, i)
                  for i, name in enumerate(('train', 'val'))}


def datasets(sets, name):
    root, paths = sets
    p = paths[name]
    args = (p['ann'], p['camera'], p['joint'])
    return (pih.InterHandDataset(*args, img_prefix=root),
            jih.InterHandDataset(*args, img_prefix=root))


def test_dataset_loader_and_metrics_match_jax(sets):
    from vitpose_tpu.train.interhand_loop import InterHandLoader
    port, ref = datasets(sets, 'train')
    assert len(port) == len(ref) == 5
    assert_same_tree(port.db, ref.db)
    kw = dict(image_size=(64, 64), heatmap_size=(8, 8, 8), seed=3)
    for is_train in (True, False):
        loaders = (ploop.InterHandLoader(port, 2, is_train=is_train, **kw),
                   InterHandLoader(ref, 2, is_train=is_train, **kw))
        for ld in loaders:
            ld.set_epoch(1)
        for a, b in zip(*loaders):
            assert list(a) == list(b)
            for k in b:
                # the crops: cv2 warps of affines an f32 ulp apart
                tol = 2 / 255 if k == 'imgs' else 1e-6
                close(a[k], b[k], tol, k)
    rng = np.random.RandomState(6)
    results = []
    for start in (0, 3):
        recs = port.db[start:start + 3]
        px = np.stack([r['joints_3d'] for r in recs]) + rng.randn(
            len(recs), 42, 3) * 4
        results.append(dict(
            preds=pmodel.backproject_to_camera(
                px, np.stack([r['focal'] for r in recs]),
                np.stack([r['princpt'] for r in recs]),
                np.stack([r['abs_depth'] for r in recs])),
            hand_type=rng.rand(len(recs), 2), keypoints_px=px,
            rel_root_depth=rng.randn(len(recs)) * 20,
            bbox_ids=[r['bbox_id'] for r in recs]))
    metric = ['MPJPE', 'MRRPE', 'Handedness_acc', 'AUC']
    got = port.evaluate(results, metric)
    assert_same_tree(got, ref.evaluate(results, metric))
    assert got['MRRPE'] > 0 and 0 <= got['Handedness_acc'] <= 1
    rec = port.db[1]
    assert_same_tree(pih.training_targets(rec, (64, 64), (8, 8, 8)),
                     jih.training_targets(rec, (64, 64), (8, 8, 8)))


def adam_moments(opt_state):
    """(mu, nu) of an optax adam(w) state."""
    st = next(st for st in jax.tree.leaves(
        opt_state, is_leaf=lambda st: hasattr(st, 'mu')) if hasattr(st, 'mu'))
    return st.mu, st.nu


def test_two_train_steps_match_jax(sets, monkeypatch):
    """Two steps (AdamW at weight decay 1e-2, lr 1e-5) on one loader batch
    of 32x32 crops, the trunk in float64 on both sides
    (64-bit JAX for this test; the head computes in f32 in both, as JAX's
    head module fixes it):
    in f32 the training-mode BN over the trunk's 1x1 to 4x4 maps leaves
    JAX's first gradients up to 40% of a tensor's largest from the port's
    (the deep-random-net chaos of ROADMAP §3). Step 1 from the same
    weights, step 2 from JAX's state after step 1 (weights, BN statistics,
    Adam's moments), so that Adam's turning of noise on near-zero
    gradients into +-lr at step 1 does not carry over: each step's losses
    1e-5 relative (the f32 head), Adam's first moment within 1e-5 of each tensor's
    largest, every parameter within 2 lr of JAX's and all but 1e-3 of them
    within 1e-8, the BN statistics 1e-6."""
    import optax
    from vitpose_tpu.train.interhand_loop import make_interhand_train_step
    from vitpose_tpu_torch.utils import convert
    # the port's reading of JAX's trees, kept in float64
    monkeypatch.setattr(convert, '_t', lambda x: torch.from_numpy(
        np.array(x, np.float64)))
    mdict = dict(MDICT, backbone_overrides=dict(depth=DEPTH, dtype='float64'),
                 heatmap_size=(4, 4))
    port_ds, _ = datasets(sets, 'train')
    batch = next(iter(ploop.InterHandLoader(
        port_ds, 2, image_size=(32, 32), heatmap_size=(4, 4, 8))))
    model = shaped_model(0, mdict)
    sd = {k: t.numpy() for k, t in model.state_dict().items()}
    model.double()
    lr = 1e-5
    with jax.enable_x64(True):
        est = jmodel.Interhand3DEstimator(
            backbone=JaxResNet(depth=DEPTH, dtype=jnp.float64),
            backbone_mode_kwarg='train', num_joints=42, depth_size=8,
            heatmap_size=(4, 4), split_hands=True, deconv_filters=(8, 8))
        v = jax.tree.map(lambda a: np.asarray(a, np.float64),
                         convert_interhand3d_checkpoint(sd, CFG))
        tx = optax.adamw(lr, weight_decay=1e-2)
        step = make_interhand_train_step(est, tx)
        params = {k: v[k]['params'] for k in v}
        stats = {k: {c: x for c, x in v[k].items() if c != 'params'}
                 for k in v}
        opt_state = jax.jit(tx.init)(params)   # one compile, not one a leaf
        jb = {k: np.asarray(x, np.float64) for k, x in batch.items()}
        fn = compiled(step, params, stats, opt_state, jb)
        ref = []
        for _ in range(2):
            params, stats, opt_state, mets = fn(params, stats, opt_state,
                                                jb)
            ref.append(jax.device_get((mets, params, stats,
                                       adam_moments(opt_state))))
    optimizer, scheduler = adam(model.parameters(), lr, lambda c: lr,
                                weight_decay=1e-2)
    pb = {k: t.double() for k, t in ploop.batch_to_device(batch, 'cpu')
          .items()}

    def tree_sd(params, stats):
        return interhand3d_state_dict_from_flax(
            {k: {**stats[k], 'params': params[k]} for k in params},
            'resnet')

    def moments_sd(tree):
        return interhand3d_state_dict_from_flax(
            {k: {'params': tree[k]} for k in tree}, 'resnet')

    for i, (mets, params, stats, (mu, _)) in enumerate(ref):
        if i == 1:                    # from JAX's state after step 1
            _, p1, s1, (mu1, nu1) = ref[0]
            model.load_state_dict(tree_sd(p1, s1))
            m1, n1 = moments_sd(mu1), moments_sd(nu1)
            for name, p in model.named_parameters():
                st = optimizer.state[p]
                st['exp_avg'].copy_(m1[name])
                st['exp_avg_sq'].copy_(n1[name])
        got = ploop.interhand_step(model, optimizer, scheduler, pb)
        assert list(got) == ['hand_loss', 'rel_root_loss',
                             'hand_type_loss', 'total_loss']
        for k, value in mets.items():
            assert float(got[k]) == pytest.approx(float(value),
                                                  rel=1e-5), (i, k)
        moments = moments_sd(mu)
        for name, p in model.named_parameters():
            close(optimizer.state[p]['exp_avg'].numpy(),
                  moments[name].numpy(), 1e-5, f'step {i} {name}')
        want = tree_sd(params, stats)
        moved, total = 0, 0
        for name, t in model.state_dict().items():
            if name.endswith('num_batches_tracked'):
                continue
            a, b = t.numpy(), want[name].numpy()
            if 'running_' in name:
                close(a, b, 1e-6, f'step {i} {name}')
                continue
            close(a, b, what=f'step {i} {name}', atol=2 * lr)
            moved += int((np.abs(a - b) > 1e-8).sum())
            total += a.size
        assert moved <= 1e-3 * total, (i, moved, total)


# --- the CLIs, the API and the demo -----------------------------------------

def small_config(root, sets, name='ih', batch_size=2, **extra):
    """The zoo config at the small size on the synthetic sets."""
    _, paths = sets
    entry = lambda s: (f"dict(ann_file='{paths[s]['ann']}', "
                       f"camera_file='{paths[s]['camera']}', "
                       f"joint_file='{paths[s]['joint']}', "
                       f"img_prefix='{sets[0]}')")
    lines = [f"_base_ = ['{CONFIG}']",
             f"model = dict(backbone_overrides=dict(depth={DEPTH}), "
             "depth_size=8, "
             "heatmap_size=(8, 8), deconv_filters=(8, 8))",
             f"data = dict(image_size=(64, 64), heatmap_size=(8, 8), "
             f"batch_size={batch_size}, train={entry('train')}, "
             f"val={entry('val')})"]
    lines += [f'{k} = {v!r}' for k, v in extra.items()]
    path = os.path.join(root, f'{name}.py')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def test_eval_cli_matches_jax(pair, sets, tmp_path):
    from vitpose_tpu.eval.families import evaluate_interhand3d
    from vitpose_tpu.utils.config import load_config as jax_load_config
    model, jest, v, _ = pair
    # batches of 3 and 2: shapes JAX compiled for the API test and the
    # forward
    path = small_config(str(tmp_path), sets, batch_size=3)
    cfg = jax_load_config(path)
    want = evaluate_interhand3d(cfg, jest, v)
    assert list(want) == ['MPJPE', 'Handedness_acc', 'MRRPE']
    npz = str(tmp_path / 'w.npz')
    save_params_npz(npz, jax.tree.map(np.asarray, v))
    out = str(tmp_path / 'stats.json')
    test_cli.main([path, npz, '--device', 'cpu', '--out', out])
    with open(out) as f:
        got = json.load(f)
    assert list(got) == list(want)
    for k, value in want.items():
        assert got[k] == pytest.approx(float(value), rel=1e-4), k


def test_train_cli_resumes_and_keeps_the_best(sets, tmp_path):
    """One epoch through the training CLI with an evaluation (a val line
    and best.pth by MPJPE; the zoo config's runtime names 'AP', as JAX's
    base runtime does, so the test names MPJPE there), then --resume;
    best.pth through the evaluation CLI."""
    path = small_config(str(tmp_path), sets,
                        evaluation=dict(interval=1, metric=['MPJPE']),
                        runtime=dict(save_best='MPJPE'))
    work = str(tmp_path / 'work')
    args = [path, '--work-dir', work, '--device', 'cpu', '--cfg-options',
            'optimizer.total_epochs=1']
    model, metrics = train_cli.main(args)
    assert set(metrics) == {'hand_loss', 'rel_root_loss', 'hand_type_loss',
                            'total_loss'}
    assert all(np.isfinite(list(metrics.values())))
    first = torch.load(os.path.join(work, 'final.pth'), weights_only=True)
    assert os.path.exists(os.path.join(work, 'best.pth'))
    train_cli.main(args + ['--resume'])
    second = torch.load(os.path.join(work, 'final.pth'), weights_only=True)
    assert any(not torch.equal(first[k], second[k]) for k in first)
    with open(os.path.join(work, 'train.log.json')) as f:
        log = [json.loads(line) for line in f]
    assert [r.get('mode') for r in log] == ['val', None, 'val', None]
    stats = test_cli.main([path, os.path.join(work, 'best.pth'), '--device',
                           'cpu'])
    assert list(stats) == ['MPJPE'] and np.isfinite(stats['MPJPE'])


def test_api_and_demo_on_the_cpu(pair, tmp_path):
    """inference_interhand_3d_model against JAX's on the same boxes (JAX's
    reads its crop size from a ViT config: a stand-in gives it 64x64), then
    the demo end to end."""
    from vitpose_tpu.api import inference_3d as jinf3d
    from vitpose_tpu_torch.api.inference_3d import \
        inference_interhand_3d_model
    from vitpose_tpu_torch.demo import interhand3d_img_demo
    model, jest, v, _ = pair
    model = model.eval()
    model.image_size = (64, 64)
    rng = np.random.RandomState(7)
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    dets = [{'bbox': [10, 20, 60, 50, 0.9]}, {'bbox': [70, 30, 50, 70, 0.2]},
            {'bbox': [5, 5, 40, 40, 0.7]}]

    class Stand:
        backbone = type('B', (), {'cfg': type('C', (), {
            'img_size': (64, 64)})})
        infer = jest.infer
        decode = jest.decode
    # the threshold keeps 3 of 4 boxes: the shapes JAX compiled for 3
    for thr, boxes in ((None, dets), (0.5, dets + [
            {'bbox': [90, 60, 45, 45, 0.8]}])):
        got = inference_interhand_3d_model(model, img, boxes, bbox_thr=thr)
        want = jinf3d.inference_interhand_3d_model((Stand, v), img, boxes,
                                                   bbox_thr=thr)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert np.array_equal(a['bbox'], b['bbox'])
            close(a['keypoints_3d'], b['keypoints_3d'], 1e-4)
            assert a['rel_root_depth'] == pytest.approx(b['rel_root_depth'],
                                                        rel=1e-4, abs=1e-3)
    img_path = str(tmp_path / 'hand.jpg')
    cv2.imwrite(img_path, img)
    config = small_config(str(tmp_path), (str(tmp_path), {
        s: {'ann': 'a', 'camera': 'c', 'joint': 'j'}
        for s in ('train', 'val')}), 'demo_cfg')
    res, out = interhand3d_img_demo.main(
        [img_path, '--config', config, '--hand-box', '10,20,60,50',
         '--focal', '1000,1000', '--princpt', '80,60', '--out-img-root',
         str(tmp_path / 'vis'), '--device', 'cpu'])
    assert res[0]['keypoints_3d'].shape == (42, 4)
    assert np.isfinite(res[0]['keypoints_cam']).all()
    assert os.path.getsize(out) > 0

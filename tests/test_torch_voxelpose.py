"""VoxelPose multiview 3D pose (ROADMAP item 12f) in the port against the
JAX package on the CPU, at a small size: V2VNets of mid_channels 4, a space
grid of 16x16x8 voxels and cubes of 16^3, 15 joints, 3 views of 16x24
heatmaps, a synthetic CMU-Panoptic sequence (calibration and coco19 body
files, cameras with distortion around two people) in `tmp_path`.

  * The voxel grid, the cameras' arrays, the pixel projection with
    distortion and the multiview sampling (points in and out of the maps)
    against JAX's camera-list and array versions, within 1e-5 of the
    largest value (the port samples with F.grid_sample).
  * The centre and pose nets (JAX's variables by JAX's converter from the
    port's state dict, seeded BN statistics) in eval and training mode,
    the BN statistics after it; the converters both ways exact.
  * The whole forward on GT-projected heatmaps: the host proposals equal
    JAX's on the same centre volume, the people's joints within 1e-4.
  * The dataset's frames and cameras, the heatmap cameras and painted
    heatmaps, the voxel targets, the loop's frame arrays and `evaluate`
    (recall and MPJPE at 500 mm, AP/AR) against JAX's with each body cut to
    the 15 joints the model predicts, as mmpose reads coco19 (JAX keeps 19
    and its evaluation raises on 15-joint predictions: ROADMAP §3).
  * One batched training step against JAX's (the single-scene losses
    against the batched ones), the evaluation CLI against JAX's evaluate_voxelpose and the
    training CLI with --resume.
"""
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import panoptic_mview as jdata
from vitpose_tpu.models import voxelpose as jvp
from vitpose_tpu.ops import target as jtarget
from vitpose_tpu.train import voxelpose_loop as jloop
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.family_ckpt import convert_voxelpose_checkpoint

from test_torch_data import assert_same_tree
from test_torch_interhand3d import adam_moments, close, compiled
from vitpose_tpu_torch.data import panoptic_mview as pdata
from vitpose_tpu_torch.models import voxelpose as pvp
from vitpose_tpu_torch.ops import target as ptarget
from vitpose_tpu_torch.tools import test as test_cli
from vitpose_tpu_torch.tools import train as train_cli
from vitpose_tpu_torch.train import voxelpose_loop as ploop
from vitpose_tpu_torch.train.family_loop import adam
from vitpose_tpu_torch.train.loop import build_model_from_cfg
from vitpose_tpu_torch.utils.convert import voxelpose_state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'body3d',
                      'voxelpose_prn64x64x64_cpn80x80x20_panoptic_cam5.py')
GEOM = dict(num_joints=15, space_size=(8000, 8000, 2000),
            space_center=(0, -500, 800), space_resolution=(16, 16, 8),
            cube_size=(2000, 2000, 2000), cube_resolution=(16, 16, 16),
            mid_channels=4, beta=100.0, max_people=3, center_threshold=0.0)
MDICT = dict(family='voxelpose', **GEOM)
HM = (16, 24)                                   # heatmaps (h, w)
CAMS = ('00_03', '00_06', '00_12')


def shaped_model(seed):
    """The port's DetectAndRegress with seeded BN statistics and biases."""
    model = build_model_from_cfg(MDICT, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    for name, t in sd.items():
        if name.endswith('running_var'):
            sd[name] = torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)
                                        .astype(np.float32))
        elif name.endswith('running_mean') or name.endswith('bias'):
            sd[name] = torch.from_numpy(0.1 * rng.standard_normal(t.shape)
                                        .astype(np.float32))
    model.load_state_dict(sd)
    return model


def jax_variables(model):
    sd = {k: t.numpy().copy() for k, t in model.state_dict().items()}
    return jax.tree.map(np.asarray, convert_voxelpose_checkpoint(sd, None))


# --- a synthetic Panoptic sequence ------------------------------------------

def look_at(pos):
    """Panoptic extrinsics (X_cam = R X_world + t, cm, y down) of a camera
    at `pos` looking at the origin's mid-height."""
    z = np.array([0.0, -90.0, 0.0]) - pos
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    r = np.stack([x, np.cross(z, x), z])
    return r, -r @ pos


def write_sequence(root, name, seed, frames=2):
    rng = np.random.RandomState(seed)
    seq = os.path.join(root, name)
    os.makedirs(os.path.join(seq, 'hdPose3d_stage1_coco19'))
    cams = []
    for i, cam in enumerate(CAMS + ('00_99',)):
        ang = 2 * np.pi * i / 4 + 0.3
        r, t = look_at(np.array([700 * np.cos(ang), -150.0,
                                 700 * np.sin(ang)]))
        cams.append(dict(name=cam, K=[[1400.0, 0, 960], [0, 1400.0, 540],
                                      [0, 0, 1]], R=r.tolist(),
                         t=t.reshape(3, 1).tolist(), resolution=[1920, 1080],
                         distCoef=(rng.randn(5) * [0.05, 0.01, 1e-3, 1e-3,
                                                   1e-3]).tolist()))
    with open(os.path.join(seq, f'calibration_{name}.json'), 'w') as f:
        json.dump({'cameras': cams}, f)
    for fi in range(frames):
        bodies = []
        for pid in range(2):
            base = np.array([rng.uniform(-60, 60), 0.0, rng.uniform(-60, 60)])
            j = base + np.stack([rng.uniform(-25, 25, 19),
                                 -rng.uniform(0, 170, 19),
                                 rng.uniform(-25, 25, 19)], 1)
            j[2] = base + [0, -95, 0]          # the body centre (root_id 2)
            conf = rng.uniform(0.2, 1.0, (19, 1))
            conf[rng.rand(19) < 0.1] = 0.0
            bodies.append(dict(id=pid, joints19=np.concatenate(
                [j, conf], 1).ravel().tolist()))
        with open(os.path.join(seq, 'hdPose3d_stage1_coco19',
                               f'body3DScene_{fi:08d}.json'), 'w') as f:
            json.dump({'bodies': bodies}, f)
    return seq


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('panoptic'))
    return {name: write_sequence(root, name, i)
            for i, name in enumerate(('train_seq', 'val_seq'))}


class TrimmedPanoptic(jdata.PanopticMviewDataset):
    """JAX's dataset with each body cut to its first num_joints, as mmpose
    (and the port) read coco19: JAX's own keeps all 19 joints, which its
    15-joint VoxelPose cannot take (ROADMAP §3)."""

    def __getitem__(self, idx):
        out = super().__getitem__(idx)
        for p in out['people']:
            p['joints_3d'] = p['joints_3d'][:self.num_joints]
            p['joints_vis'] = p['joints_vis'][:self.num_joints]
        return out


def datasets(seq, cls=TrimmedPanoptic):
    return (pdata.PanopticMviewDataset([seq], cam_names=CAMS,
                                       num_joints=15),
            cls([seq], cam_names=CAMS, num_joints=15))


@pytest.fixture(scope='module')
def scene(sets):
    """(port frame, JAX frame, heatmap-frame cameras of each, the painted
    heatmaps)."""
    port, ref = datasets(sets['train_seq'])
    pf, jf = port[0], ref[0]
    pc = ploop.heatmap_frame_cameras(pf['cameras'], HM)
    jc = jloop.heatmap_frame_cameras(jf['cameras'], HM)
    return pf, jf, pc, jc, ploop.gt_projected_heatmaps(pf, pc, 15, HM)


def test_grid_projection_and_sampling_match_jax(scene):
    pf, jf, pc, jc, heatmaps = scene
    grid = pvp.make_voxel_grid(GEOM['space_center'], GEOM['space_size'],
                               GEOM['space_resolution'])
    jgrid = jvp.make_voxel_grid(GEOM['space_center'], GEOM['space_size'],
                                GEOM['space_resolution'])
    close(grid.numpy(), jgrid, 1e-6)
    assert_same_tree(dict(sorted(pvp.stack_camera_params(pc).items())),
                     jax.tree.map(np.asarray, jvp.stack_camera_params(jc)))
    cp = pvp.camera_tensors(pc, 'cpu')
    pix = pvp.project_points_pix(grid.reshape(-1, 3), cp).numpy()
    # a cube grid around a person and the space grid, through both JAX
    # versions (the camera list and the arrays), and the pixels, in one
    # compiled function
    grids = [g.numpy() for g in (grid, pvp.make_voxel_grid(
        pf['people'][0]['joints_3d'][2], GEOM['cube_size'],
        GEOM['cube_resolution']))]

    def jax_side(h, jgrid, grids):
        return jvp.project_points_pix(
            jgrid.reshape(-1, 3), jvp.stack_camera_params(jc)), [
            (jvp.project_heatmaps_to_voxels(h, jc, g),
             jvp.project_heatmaps_to_voxels_arr(
                 h, jvp.stack_camera_params(jc), g)) for g in grids]
    jpix, jvols = compiled(jax_side, heatmaps, jgrid, grids)(
        heatmaps, jgrid, grids)
    close(pix, jpix, 1e-6)
    inside = ((pix >= 0) & (pix < [HM[1] - 1, HM[0] - 1])).all(-1)
    assert 0.05 < inside.mean() < 0.95          # in and out of the maps
    for g, want in zip(grids, jvols):
        got = pvp.project_heatmaps_to_voxels(torch.from_numpy(heatmaps),
                                             pc, torch.from_numpy(g)).numpy()
        for w in want:
            close(got, w, 1e-5)
        assert np.abs(got).max() > 0.1


@pytest.fixture(scope='module')
def pair():
    model = shaped_model(0)
    jm = jvp.DetectAndRegress(**GEOM)
    return model, jm, jax_variables(model)


@pytest.fixture(scope='module')
def jax_forward(pair):
    """One _JaxForward for the module: the forward and the evaluation
    CLI's reference share its compiled steps."""
    return _JaxForward(pair[1])


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_heads_match_jax(pair, train):
    """The centre net on a space volume and the pose net on two cubes:
    eval mode within 1e-5 of the largest output; training mode (BN over
    the nets' 4x4x2 to 16^3 volumes) within 1e-4, the BN statistics after
    it 1e-4."""
    _, jm, v = pair
    model = shaped_model(0).train(train)
    rng = np.random.RandomState(1)
    space = rng.rand(1, 16, 16, 8, 15).astype(np.float32)
    cubes = rng.rand(2, 16, 16, 16, 15).astype(np.float32)
    grids = np.stack([np.asarray(jvp.make_voxel_grid(c, GEOM['cube_size'],
                                                     (16, 16, 16)))
                      for c in ((0, 0, 800), (500, -300, 900))])
    mut = ['batch_stats'] if train else False

    def jf(v, space, cubes, grids):
        c = jm.center_head.apply(v['center'], space, train=train,
                                 mutable=mut)
        p = jm.pose_head.apply(v['pose'], cubes, grids, train=train,
                               mutable=mut)
        return c, p
    jc, jp = compiled(jf, v, space, cubes, grids)(v, space, cubes, grids)
    if train:
        (jc, cupd), (jp, pupd) = (jc, jp)
    got_c = model.center(torch.from_numpy(space).permute(0, 4, 1, 2, 3))
    got_p = model.pose(torch.from_numpy(cubes).permute(0, 4, 1, 2, 3),
                       torch.from_numpy(grids))
    tol = 1e-4 if train else 1e-5
    close(got_c.detach().numpy(), jc, tol, 'center')
    close(got_p.detach().numpy(), jp, tol, 'joints')
    if train:
        after = voxelpose_state_dict_from_flax(jax.device_get({
            'center': {'params': v['center']['params'], **cupd},
            'pose': {'params': v['pose']['params'], **pupd}}))
        for name, t in model.state_dict().items():
            if 'running_' in name:
                close(t.numpy(), after[name].numpy(), 1e-4, name)
    else:
        sd = model.state_dict()
        back = voxelpose_state_dict_from_flax(v)
        assert sorted(back) == sorted(sd)
        for k, t in sd.items():
            assert torch.equal(back[k], t.float() if t.is_floating_point()
                               else t), k


class _JaxForward:
    """JAX's DetectAndRegress with the projections (the array version,
    held to the camera-list one above) and the centre and pose nets
    compiled once per input shape (its forward runs them eagerly)."""

    def __init__(self, jm):
        self.jm, self.num_joints, self.fns = jm, jm.num_joints, {}

    def _head(self, name, *args):
        key = (name,) + tuple(np.shape(a) for a in args[1:])
        if key not in self.fns:
            head = getattr(self.jm, name)
            self.fns[key] = compiled(
                lambda v, *xs: head.apply(v, *xs, train=False), *args)
        return self.fns[key](*args)

    def _project(self, heatmaps, cameras, grid):
        """JAX's project_heatmaps_to_voxels_arr, compiled per grid shape."""
        cp = jvp.stack_camera_params(cameras)
        key = ('project', np.shape(heatmaps), np.shape(grid))
        if key not in self.fns:
            self.fns[key] = compiled(jvp.project_heatmaps_to_voxels_arr,
                                     heatmaps, cp, grid)
        return self.fns[key](heatmaps, cp, grid)

    def forward(self, v, heatmaps, cameras):
        """JAX's DetectAndRegress.forward, its steps compiled."""
        jm = self.jm
        space = self._project(heatmaps, cameras, jm.space_grid)
        center = self._head('center_head', v['center'], space[None])
        self.center = np.asarray(center)[0]
        people = []
        for xyz, score in jvp.CuboidCenterHead.get_proposals(
                self.center, jm.space_grid, max_people=jm.max_people,
                threshold=jm.center_threshold):
            grid = jvp.make_voxel_grid(xyz, jm.cube_size, jm.cube_resolution)
            cube = self._project(heatmaps, cameras, grid)
            joints = self._head('pose_head', v['pose'], cube[None], grid)
            people.append((np.asarray(joints)[0], score))
        return people


def test_forward_matches_jax(pair, scene, jax_forward):
    """The whole eval forward on the frame's GT-projected heatmaps: the
    centre volume within 1e-5 of its largest, the proposals JAX's host
    argsort gives on JAX's volume equal to the port's on the same volume,
    and the people (in that order) within 1e-4 mm-relative."""
    model, jm, v = pair
    _, _, pc, jc, heatmaps = scene
    jf = jax_forward
    want = jf.forward(v, jnp.asarray(heatmaps), jc)
    center = model.eval().center_volume(torch.from_numpy(heatmaps), pc)
    close(center.detach().numpy(), jf.center, 1e-5)
    grid = np.asarray(jm.space_grid)
    assert_same_tree(pvp.CuboidCenterHead.get_proposals(jf.center, grid, 3,
                                                        0.0),
                     jvp.CuboidCenterHead.get_proposals(jf.center, grid, 3,
                                                        0.0))
    got = model(torch.from_numpy(heatmaps), pc)
    assert len(got) == len(want) == 3
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == pytest.approx(sb, rel=1e-5)
        close(a, b, 1e-4)


def test_data_targets_and_metrics_match_jax(sets, scene):
    port, ref = datasets(sets['train_seq'])
    assert len(port) == len(ref) == 2
    for i in range(2):
        a, b = port[i], ref[i]
        assert_same_tree(a['people'], b['people'])
        assert len(a['cameras']) == len(b['cameras']) == 3
        for ca, cb in zip(a['cameras'], b['cameras']):
            for k in ('R_w2c', 'T_w2c', 'K', 'k', 'p'):
                close(getattr(ca, k), np.asarray(getattr(cb, k)), 1e-6, k)
    pf, jf, pc, jc, heatmaps = scene
    close(heatmaps, jloop.gt_projected_heatmaps(jf, jc, 15, HM), 1e-5)
    joints = np.random.RandomState(2).uniform(-3000, 3000, (3, 15, 3))
    for kw in (dict(sigma=400.0), dict(sigma=600.0, joint_indices=[2])):
        args = (joints, np.ones((3, 15)), GEOM['space_size'],
                GEOM['space_center'], GEOM['space_resolution'])
        assert_same_tree(ptarget.generate_voxel_3d_targets(*args, **kw),
                         jtarget.generate_voxel_3d_targets(*args, **kw))
    rng = np.random.RandomState(3)
    results = [[(p['joints_3d'][:15] + rng.randn(15, 3) * s, sc)
                for p, s, sc in zip(port[i]['people'], (20, 400), (0.9, 0.4))]
               + [(rng.randn(15, 3) * 1000, 0.5)] for i in range(2)]
    metric = ['mpjpe', 'mAP']
    got = port.evaluate(results, metric)
    assert_same_tree(got, ref.evaluate(results, metric))
    assert 0 < got['RECALL 500mm'] <= 1 and got['mAP'] > 0
    # JAX's own dataset keeps the 19 coco19 joints: 15-joint predictions
    # do not broadcast against them
    untrimmed = jdata.PanopticMviewDataset([sets['train_seq']],
                                           cam_names=CAMS, num_joints=15)
    assert untrimmed[0]['people'][0]['joints_3d'].shape == (19, 3)
    with pytest.raises(ValueError, match='broadcast'):
        untrimmed.evaluate(results, metric)


def step_batch(model, sets):
    """The loop's frame arrays of the first training frame (people padded
    to 3), as numpy."""
    port, _ = datasets(sets['train_seq'])
    return ploop.frame_arrays(model, port[0], HM, 3, 2, 400.0)


def test_train_step_matches_jax(pair, sets):
    """One batched step (G = 1 frame, 3 candidate slots, one padded) from
    the same weights against JAX's loop step (training_losses_batched, Adam
    over the parameters). JAX's V2VNet computes in f32 whatever its
    parameters' type, and training-mode BN over these small volumes
    magnifies f32 rounding (and the pose head's softmax of 100 x the volume
    magnifies it again; the port's own f32 gradients sit up to 1e-2 of a
    tensor's largest from its float64 run), so the port's float64 step is
    the arbiter of the losses: both within 2e-4 relative of JAX's and no
    farther from the f64 run's than JAX's are. The gradients (Adam's first
    moment) within 2e-2 of each tensor's largest of JAX's (or 1e-3 of the
    largest of all: the convs' biases before a BN have a zero gradient,
    rounding noise in both); every parameter within 2 lr of JAX's (Adam's
    first step turns noise on near-zero gradients into +-lr) and all but 1%
    of them within 1e-6, the BN statistics 1e-4; the single-scene
    `training_losses` (a batch of one per candidate) 1e-5."""
    import optax
    _, jm, v = pair
    model = shaped_model(0)
    fa = step_batch(model, sets)
    assert fa['cand_mask'].tolist() == [1.0, 1.0, 0.0]
    lr = 1e-3
    tx = optax.adam(lr)
    trainable = {k: v[k]['params'] for k in v}
    stats = {k: {c: x for c, x in v[k].items() if c != 'params'} for k in v}
    jb = jax.tree.map(lambda a: np.asarray(a)[None], fa)

    def step(trainable, stats, opt_state, batch):
        def loss_fn(t):
            losses, new_vars = jm.training_losses_batched(
                {k: {**stats[k], 'params': t[k]} for k in t},
                batch['heatmaps'], batch['cam'], batch['candidates'],
                batch['cand_mask'], batch['gt_joints'], batch['gt_vis'],
                batch['targets_3d'], train=True)
            return losses['loss_center'] + losses['loss_pose'], (losses,
                                                                 new_vars)
        (_, (losses, new_vars)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(trainable)
        updates, opt_state = tx.update(grads, opt_state, trainable)
        new_stats = {k: {c: x for c, x in new_vars[k].items()
                         if c != 'params'} for k in new_vars}
        return (optax.apply_updates(trainable, updates), new_stats,
                opt_state, losses)
    opt_state = jax.jit(tx.init)(trainable)   # one compile, not one a leaf
    trainable, stats, opt_state, losses = jax.device_get(compiled(
        step, trainable, stats, opt_state, jb)(trainable, stats, opt_state,
                                               jb))
    batch = ploop.stack_frames([fa], 'cpu')
    runs = {}
    for name, m in (('f32', model), ('f64', shaped_model(0).double())):
        optimizer, scheduler = adam(m.parameters(), lr, lambda c: lr)
        got = ploop.voxelpose_step(m, optimizer, scheduler, batch)
        runs[name] = got, {n: optimizer.state[p]['exp_avg'].double().numpy()
                           for n, p in m.named_parameters()}
    got, ref64 = runs['f32'][0], runs['f64'][0]
    assert list(got) == ['loss_center', 'loss_pose', 'total_loss']
    for k in losses:
        ours, theirs, truth = (float(got[k]), float(losses[k]),
                               float(ref64[k]))
        assert ours == pytest.approx(theirs, rel=2e-4), k
        assert abs(ours - truth) <= max(abs(theirs - truth),
                                        1e-6 * abs(truth)), (k, ours,
                                                             theirs, truth)
    mu = voxelpose_state_dict_from_flax(jax.device_get(
        {k: {'params': m} for k, m in adam_moments(opt_state)[0].items()}))
    floor = 1e-3 * max(np.abs(m.numpy()).max() for m in mu.values())
    for name, m in mu.items():
        if name in runs['f32'][1]:
            m = m.numpy()
            close(runs['f32'][1][name], m, what=name,
                  atol=max(2e-2 * np.abs(m).max(), floor))
    want = voxelpose_state_dict_from_flax(
        {k: {'params': trainable[k], **stats[k]} for k in trainable})
    moved, total = 0, 0
    for name, t in model.state_dict().items():
        if name.endswith('num_batches_tracked'):
            continue
        a, b = t.numpy(), want[name].numpy()
        if 'running_' in name:
            close(a, b, 1e-4, name)
            continue
        close(a, b, what=name, atol=2 * lr)
        moved += int((np.abs(a - b) > 1e-6).sum())
        total += a.size
    assert moved <= 1e-2 * total, (moved, total)
    # the single-scene losses (a batch of one per candidate) equal the
    # batched ones in eval mode, where BN normalises each sample alone
    model = shaped_model(0).eval()
    port_ds, _ = datasets(sets['train_seq'])
    cams = ploop.heatmap_frame_cameras(port_ds[0]['cameras'], HM)
    single = model.training_losses(
        torch.from_numpy(fa['heatmaps']), cams,
        *[torch.from_numpy(fa[k]) for k in ('candidates', 'cand_mask',
                                            'gt_joints', 'gt_vis',
                                            'targets_3d')])
    batched = model.training_losses_batched(
        batch['heatmaps'], batch['cam'], batch['candidates'],
        batch['cand_mask'], batch['gt_joints'], batch['gt_vis'],
        batch['targets_3d'])
    for k in single:
        assert float(single[k]) == pytest.approx(float(batched[k]),
                                                 rel=1e-5), k


def small_config(root, sets, name='vp', **extra):
    entry = lambda s: (f"dict(seq_dirs=('{sets[s]}',), "
                       f"cam_names={CAMS!r})")
    lines = [f"_base_ = ['{CONFIG}']",
             'model = dict(space_resolution=(16, 16, 8), '
             'cube_resolution=(16, 16, 16), mid_channels=4, max_people=3, '
             'center_threshold=0.0, max_people_train=3)',
             f"data = dict(heatmap_size=(24, 16), train={entry('train_seq')},"
             f" val={entry('val_seq')})",
             'target = dict(sigma=400.0)']
    lines += [f'{k} = {v!r}' for k, v in extra.items()]
    path = os.path.join(root, f'{name}.py')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def test_eval_cli_matches_jax(pair, sets, tmp_path, monkeypatch,
                              jax_forward):
    """The evaluation CLI on JAX's variables' .npz against JAX's
    evaluate_voxelpose on its dataset with the bodies cut to 15 joints
    (TrimmedPanoptic), every Panoptic metric 1e-4 relative."""
    from vitpose_tpu.eval.families import evaluate_voxelpose
    from vitpose_tpu.utils.config import load_config as jax_load_config
    monkeypatch.setattr(jdata, 'PanopticMviewDataset', TrimmedPanoptic)
    _, _, v = pair
    path = small_config(str(tmp_path), sets)
    want = evaluate_voxelpose(jax_load_config(path), jax_forward, v)
    npz = str(tmp_path / 'w.npz')
    save_params_npz(npz, v)
    got = test_cli.main([path, npz, '--device', 'cpu'])
    assert list(got) == list(want)
    assert len(want) == 2 + 14
    for k, value in want.items():
        assert got[k] == pytest.approx(float(value), rel=1e-4, abs=1e-6), k


def test_train_cli_resumes_and_scores(sets, tmp_path):
    path = small_config(str(tmp_path), sets,
                        evaluation=dict(interval=1, metric=['mpjpe']),
                        runtime=dict(save_best='MPJPE 500mm'))
    work = str(tmp_path / 'work')
    args = [path, '--work-dir', work, '--device', 'cpu', '--cfg-options',
            'optimizer.total_epochs=1']
    _, metrics = train_cli.main(args)
    assert list(metrics) == ['loss_center', 'loss_pose', 'total_loss']
    assert all(np.isfinite(list(metrics.values())))
    final = os.path.join(work, 'final.pth')
    first = torch.load(final, weights_only=True)
    train_cli.main(args + ['--resume'])
    second = torch.load(final, weights_only=True)
    assert any(not torch.equal(first[k], second[k]) for k in first)
    with open(os.path.join(work, 'train.log.json')) as f:
        log = [json.loads(line) for line in f]
    assert [r.get('mode') for r in log] == ['val', None, 'val', None]
    assert log[1]['step'] == 2
    assert sorted(glob.glob(os.path.join(work, '*.pth'))) == [
        os.path.join(work, 'best.pth'), final]
    stats = test_cli.main([path, os.path.join(work, 'best.pth'),
                           '--device', 'cpu'])
    assert set(stats) >= {'RECALL 500mm', 'MPJPE 500mm'}

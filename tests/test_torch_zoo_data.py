"""The port's datasets of the rest of the ViTPose zoo against the JAX package
on the CPU: every metadata file, `from_mmpose_dict`, MPII and MPII-TRB,
COCO-WholeBody, PoseTrack18 and Sub-JHMDB, the COCO-format AIC, CrowdPose,
AP-10K and InterHand2D through `TopDownDataset`, the dataset dispatch, the ViTPose+ mixture
loader with the target padding, and every ViTPose config of the zoo
through the port's refusal checks.

The dataset fixtures are synthetic and written into a temporary directory:
seeded noise JPEGs (120x160) with cv2, and annotations in each dataset's
own format. MPII's is the list json with center, scale, joints and
joints_vis (matlab's 1-based coordinates) beside a `mpii_gt_val.mat`
written with scipy.io.savemat; MPII-TRB's a COCO-format json with center,
scale and headbox; COCO-WholeBody's a COCO-format json with the foot, face
and hand fields. tests/test_torch_moe_loop.py trains on them too.

Everything compared here is host numpy copied from the JAX package, so
records, batches and evaluation stats are held to be equal exactly.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from vitpose_tpu.data import topdown_dataset_cls as jax_dataset_cls
from vitpose_tpu.data.dataset_info import DatasetInfo as JaxDatasetInfo
from vitpose_tpu.data.dataset_info import (
    available_datasets as jax_available_datasets)
from vitpose_tpu.data.loader import ConcatPoseDataset as JaxConcat
from vitpose_tpu.data.loader import MultiDatasetLoader as JaxMixture
from vitpose_tpu.data.loader import RepeatDataset as JaxRepeat
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.data.pipeline import make_preprocess_fn as jax_preprocess_fn

from test_torch_data import ROOT, assert_same_tree
from vitpose_tpu_torch.data import (DatasetInfo, MpiiDataset, WholeBodyDataset,
                                    available_datasets, topdown_dataset_cls)
from vitpose_tpu_torch.data.dataset_info import _META_DIR
from vitpose_tpu_torch.data.loader import (ConcatPoseDataset,
                                           MultiDatasetLoader, RepeatDataset,
                                           TopDownLoader)
from vitpose_tpu_torch.data.pipeline import AugmentConfig, make_preprocess_fn
from vitpose_tpu_torch.train.loop import _refuse_unported, topdown_config
from vitpose_tpu_torch.utils.config import load_config

JAX_META = os.path.join(ROOT, 'vitpose_tpu', 'data', 'metadata')
SIZE = (120, 160)                     # (h, w) of every fixture image
MPII_NAMES = ['rank', 'rkne', 'rhip', 'lhip', 'lkne', 'lank', 'pelv', 'thrx',
              'neck', 'head', 'rwri', 'relb', 'rsho', 'lsho', 'lelb', 'lwri']
WHOLEBODY_PARTS = (('foot_kpts', 6), ('face_kpts', 68),
                   ('lefthand_kpts', 21), ('righthand_kpts', 21))


def _write_images(root, rng, n):
    import cv2
    os.makedirs(root, exist_ok=True)
    names = []
    for i in range(n):
        name = f'{i + 1:06d}.jpg'
        cv2.imwrite(os.path.join(root, name),
                    rng.randint(0, 256, SIZE + (3,)).astype(np.uint8))
        names.append(name)
    return names


def _person(rng, k):
    """(bbox xywh, keypoints [k, 3] with v in {0, 1, 2}) inside an image."""
    h, w = SIZE
    bw, bh = rng.uniform(0.3, 0.6) * w, rng.uniform(0.4, 0.7) * h
    x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    kp = np.stack([rng.uniform(x, x + bw, k), rng.uniform(y, y + bh, k),
                   rng.choice([0, 1, 2], k, p=[0.2, 0.3, 0.5])], 1)
    return [x, y, bw, bh], kp


def write_kpt_fixture(root, seed, k, n_images=4, per_image=2,
                      wholebody=False, crowd_index=False, video=False):
    """A COCO-format keypoint set of `k` joints. With `wholebody`, `k` is
    the body's count and each person also carries the foot, face and hand
    fields (with their validity flags and boxes). With `video` (PoseTrack18
    style), images belong to two videos (`vid_id`, `frame_id`; the third
    unlabelled) and people carry a `bbox_head` and a `track_id`. Returns
    {'ann', 'prefix'}."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, name in enumerate(_write_images(root, rng, n_images)):
        im = dict(id=i + 1, file_name=name, width=SIZE[1], height=SIZE[0])
        if crowd_index:
            im['crowdIndex'] = float(rng.uniform(0, 1))
        if video:
            im.update(vid_id=f'{10001 + i % 2:06d}', frame_id=i + 1,
                      is_labeled=i != 2)
        images.append(im)
        for p in range(per_image):
            bbox, kp = _person(rng, k)
            ann = dict(id=len(anns) + 1, image_id=i + 1, category_id=1,
                       bbox=bbox, area=bbox[2] * bbox[3] * 0.7, iscrowd=0,
                       keypoints=kp.ravel().tolist(),
                       num_keypoints=int((kp[:, 2] > 0).sum()))
            if video:
                ann.update(bbox_head=[bbox[0], bbox[1],
                                      float(rng.uniform(8, 20)),
                                      float(rng.uniform(8, 20))],
                           track_id=p)
            if wholebody:
                for field, n in WHOLEBODY_PARTS:
                    part = _person(rng, n)[1]
                    ann[field] = part.ravel().tolist()
                    ann[field.replace('kpts', 'valid')] = True
                    ann[field.replace('kpts', 'box')] = bbox
            anns.append(ann)
    out = dict(ann=os.path.join(root, 'ann.json'), prefix=root + '/')
    with open(out['ann'], 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    return out


def write_mpii_fixture(root, seed, n_images=4, per_image=2):
    """MPII's list json (1-based center, scale, joints, joints_vis; one
    record without a center, -1) and `mpii_gt_val.mat` of the same
    people. Returns {'ann', 'prefix'}."""
    from scipy.io import savemat
    rng = np.random.RandomState(seed)
    recs = []
    for name in _write_images(root, rng, n_images):
        for _ in range(per_image):
            bbox, kp = _person(rng, 16)
            recs.append(dict(
                image=name, joints=(kp[:, :2] + 1).tolist(),
                joints_vis=(kp[:, 2] > 0).astype(int).tolist(),
                center=[bbox[0] + bbox[2] / 2 + 1, bbox[1] + bbox[3] / 2 + 1],
                scale=bbox[3] / 200.0))
    recs[-1]['center'] = [-1, -1]
    out = dict(ann=os.path.join(root, 'mpii_val.json'), prefix=root + '/')
    with open(out['ann'], 'w') as f:
        json.dump(recs, f)
    joints = np.array([r['joints'] for r in recs])           # [N, 16, 2]
    vis = np.array([r['joints_vis'] for r in recs])
    heads = joints[:, 9]
    headboxes = np.stack([heads - 10, heads + 10], 0)         # [2, N, 2]
    names = np.empty((1, 16), object)
    for i, n in enumerate(MPII_NAMES):
        names[0, i] = np.array([n])
    savemat(os.path.join(root, 'mpii_gt_val.mat'), dict(
        dataset_joints=names, jnt_missing=(1 - vis).T.astype(np.float64),
        pos_gt_src=joints.transpose(1, 2, 0),
        headboxes_src=headboxes.transpose(0, 2, 1)))
    return out


def write_trb_fixture(root, seed, n_images=3, per_image=2):
    """MPII-TRB's COCO-format json: 40 keypoints, center, scale (as
    image size over 200 px), headbox; one annotation without a labelled
    joint. Returns {'ann', 'prefix'}."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, name in enumerate(_write_images(root, rng, n_images)):
        images.append(dict(id=i + 1, file_name=name, width=SIZE[1],
                           height=SIZE[0]))
        for _ in range(per_image):
            bbox, kp = _person(rng, 40)
            anns.append(dict(
                id=int(rng.randint(1000)) * 10 + len(anns), image_id=i + 1,
                category_id=1, keypoints=kp.ravel().tolist(),
                center=[bbox[0] + bbox[2] / 2, bbox[1] + bbox[3] / 2],
                scale=float(256 / bbox[3]),
                headbox=[bbox[0], bbox[1], bbox[0] + 20, bbox[1] + 20]))
    anns[0]['keypoints'] = [0] * 120
    out = dict(ann=os.path.join(root, 'trb.json'), prefix=root + '/')
    with open(out['ann'], 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    return out


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp('zoo')
    return dict(
        mpii=write_mpii_fixture(str(root / 'mpii'), 1),
        mpii_trb=write_trb_fixture(str(root / 'trb'), 2),
        coco_wholebody=write_kpt_fixture(str(root / 'wb'), 3, 17,
                                         wholebody=True),
        aic=write_kpt_fixture(str(root / 'aic'), 4, 14),
        crowdpose=write_kpt_fixture(str(root / 'crowdpose'), 5, 14,
                                    crowd_index=True),
        ap10k=write_kpt_fixture(str(root / 'ap10k'), 6, 17),
        interhand2d=write_kpt_fixture(str(root / 'interhand'), 7, 21),
        posetrack18=write_kpt_fixture(str(root / 'posetrack'), 8, 17,
                                      video=True),
        jhmdb=write_kpt_fixture(str(root / 'jhmdb'), 9, 15))


# --- metadata ---------------------------------------------------------------

INFO_FIELDS = ('dataset_name', 'keypoint_names', 'keypoint_swap',
               'keypoint_type', 'sigmas', 'joint_weights', 'skeleton',
               'keypoint_colors', 'skeleton_colors', 'flip_pairs',
               'flip_index', 'upper_body_ids', 'lower_body_ids',
               'skeleton_links')


def _fields(info):
    return {f: getattr(info, f) for f in INFO_FIELDS}


@pytest.mark.parametrize('name', sorted(
    f[:-5] for f in os.listdir(JAX_META) if f.endswith('.json')))
def test_metadata_matches_jax(name):
    with open(os.path.join(JAX_META, f'{name}.json'), 'rb') as f:
        ref_bytes = f.read()
    with open(os.path.join(_META_DIR, f'{name}.json'), 'rb') as f:
        assert f.read() == ref_bytes
    assert_same_tree(_fields(DatasetInfo.load(name)),
                     _fields(JaxDatasetInfo.load(name)))


def test_available_datasets_and_mmpose_dict_match_jax():
    assert available_datasets() == jax_available_datasets()
    assert len(available_datasets()) == 37
    info = DatasetInfo.load('coco_wholebody')
    d = dict(dataset_name='wb', sigmas=info.sigmas.tolist(),
             keypoint_info={i: dict(name=n, swap=s, type=t) for i, (n, s, t)
                            in enumerate(zip(info.keypoint_names,
                                             info.keypoint_swap,
                                             info.keypoint_type))},
             skeleton_info={i: dict(link=link)
                            for i, link in enumerate(info.skeleton)})
    port = DatasetInfo.from_mmpose_dict(d)
    assert_same_tree(_fields(port), _fields(JaxDatasetInfo.from_mmpose_dict(d)))
    assert port.flip_index.tolist() == info.flip_index.tolist()


def test_topdown_dataset_cls_dispatch_matches_jax():
    for name in ('coco', 'aic', 'crowdpose', 'ap10k', 'interhand2d', 'mpii',
                 'mpii_trb', 'coco_wholebody', 'posetrack18', 'jhmdb'):
        assert topdown_dataset_cls(name).__name__ == \
            jax_dataset_cls(name).__name__


# --- datasets ---------------------------------------------------------------

def _pair(name, fixture, test_mode=False, **kw):
    args = dict(dataset_info=name, image_size=(48, 64),
                heatmap_size=(12, 16), test_mode=test_mode, **kw)
    return (jax_dataset_cls(name)(fixture['ann'], fixture['prefix'], **args),
            topdown_dataset_cls(name)(fixture['ann'], fixture['prefix'],
                                      **args))


def _predictions(ds, seed, noise=1.0):
    """Results entries (two batches) of every record: its GT joints plus
    seeded noise, as the val loop returns them."""
    rng = np.random.RandomState(seed)
    preds, boxes = [], []
    for rec in ds.db:
        kp = rec['joints_3d'][:, :2] + rng.normal(0, noise,
                                                  (ds.num_joints, 2))
        preds.append(np.concatenate(
            [kp, rng.uniform(0.3, 1, (ds.num_joints, 1))], 1))
        c = rec.get('center', np.array(rec['bbox'][:2]) + 10)
        s = rec.get('scale', np.ones(2, np.float32))
        boxes.append([c[0], c[1], s[0], s[1], 1e4, 1.0])
    half = len(preds) // 2
    return [dict(preds=np.array(preds[a:b], np.float32),
                 boxes=np.array(boxes[a:b], np.float32),
                 image_paths=[r['image_file'] for r in ds.db[a:b]],
                 bbox_ids=[r['bbox_id'] for r in ds.db[a:b]])
            for a, b in ((0, half), (half, len(preds)))]


DATASETS = {'mpii': ('PCKh',), 'mpii_trb': ('PCKh',),
            'coco_wholebody': ('mAP',), 'aic': ('mAP',),
            'crowdpose': ('mAP',), 'ap10k': ('mAP',),
            'interhand2d': ('PCK', 'AUC', 'EPE'),
            'posetrack18': ('mAP',), 'jhmdb': ('PCK', 'tPCK')}
# the stat each protocol leads with
HEADLINE = {'posetrack18': 'Total AP', 'jhmdb': 'Mean PCK'}


@pytest.mark.parametrize('name', sorted(DATASETS))
def test_dataset_records_and_evaluate_match_jax(sets, name):
    ref, port = _pair(name, sets[name])
    assert type(port).__name__ == type(ref).__name__
    assert len(port) == len(ref) > 0
    assert_same_tree(port.db, ref.db)
    if name != 'mpii_trb':
        ref_t, port_t = _pair(name, sets[name], test_mode=True)
        assert_same_tree(port_t.db, ref_t.db)
    results = _predictions(port, seed=len(name))
    metric = list(DATASETS[name])
    stats = port.evaluate(results, metric=metric[0] if len(metric) == 1
                          else metric)
    ref_stats = ref.evaluate(results, metric=metric[0] if len(metric) == 1
                             else metric)
    assert list(stats) == list(ref_stats) and len(stats) > 0
    for key, value in ref_stats.items():
        assert stats[key] == value or (np.isnan(stats[key])
                                       and np.isnan(value)), key
    headline = HEADLINE.get(name, {'PCKh': 'PCKh', 'mAP': 'AP',
                                   'PCK': 'PCK'}[metric[0]])
    assert 0 < stats[headline] <= 100


def test_mpii_records_follow_the_matlab_convention(sets):
    ds = MpiiDataset(sets['mpii']['ann'], sets['mpii']['prefix'])
    with open(sets['mpii']['ann']) as f:
        first = json.load(f)[0]
    rec = ds.db[0]
    np.testing.assert_allclose(
        rec['center'], np.array(first['center'], np.float32)
        + [-1, 15 * first['scale'] - 1], rtol=1e-6)
    np.testing.assert_allclose(rec['scale'], [first['scale'] * 1.25] * 2,
                               rtol=1e-6)
    np.testing.assert_allclose(rec['joints_3d'][:, :2],
                               np.array(first['joints']) - 1, rtol=1e-6)
    assert ds.canvas_size == 1280 and ds.sigmas is None


def test_wholebody_evaluates_six_parts(sets):
    ds = WholeBodyDataset(sets['coco_wholebody']['ann'],
                          sets['coco_wholebody']['prefix'])
    assert ds.num_joints == 133 and ds.db[0]['joints_3d'].shape == (133, 3)
    stats = ds.evaluate(_predictions(ds, seed=1))
    for part in ('body', 'foot', 'face', 'lefthand', 'righthand'):
        assert f'{part}/AP' in stats
    assert 'AP' in stats


# --- the mixture and the target padding ----------------------------------------

def _mixture(cls, loader_cls, sets, datasets):
    loaders = [loader_cls(datasets[name], 2, is_train=True, seed=3 + i,
                          num_workers=1, canvas_size=640)
               for i, name in enumerate(('mpii', 'coco_wholebody', 'aic'))]
    return cls(loaders), loaders


@pytest.mark.parametrize('epoch', [0, 1])
def test_mixture_batches_match_jax(sets, epoch):
    """Whole single-dataset batches in the seeded order of the epoch; the
    port's set_epoch also sets its children's."""
    datasets = {}
    for i, name in enumerate(('mpii', 'coco_wholebody', 'aic')):
        datasets[name] = _pair(name, sets[name], dataset_idx=i,
                               max_num_joints=133)
    ref, ref_children = _mixture(JaxMixture, JaxTopDownLoader, sets,
                                 {k: v[0] for k, v in datasets.items()})
    port, _ = _mixture(MultiDatasetLoader, TopDownLoader, sets,
                       {k: v[1] for k, v in datasets.items()})
    for loader in ref_children:
        loader.set_epoch(epoch)
    ref.set_epoch(epoch)
    port.set_epoch(epoch)
    a, b = list(ref), list(port)
    assert len(b) == len(port) == len(ref) == len(a) == 12
    assert_same_tree(b, a)
    order = [int(x['dataset_idx'][0]) for x in b]
    assert all((x['dataset_idx'] == x['dataset_idx'][0]).all() for x in b)
    assert sorted(order) == [0] * 4 + [1] * 4 + [2] * 4
    assert order != sorted(order)


def test_repeat_and_concat_datasets_match_jax(sets):
    ref, port = _pair('aic', sets['aic'])
    assert_same_tree(RepeatDataset(port, 3).db, JaxRepeat(ref, 3).db)
    assert len(RepeatDataset(port, 3)) == 3 * len(port)
    assert RepeatDataset(port, 2).num_joints == 14
    both = ConcatPoseDataset([port, port])
    assert_same_tree(both.db, JaxConcat([ref, ref]).db)
    assert both.info is port.info
    with pytest.raises(ValueError):
        ConcatPoseDataset([])


def test_target_padding_matches_jax():
    rng = np.random.RandomState(0)
    n, k = 3, 5
    args = (rng.randint(0, 256, (n, 80, 90, 3)).astype(np.uint8),
            rng.uniform(30, 50, (n, 2)).astype(np.float32),
            rng.uniform(0.2, 0.4, (n, 2)).astype(np.float32),
            np.array([0.0, 20.0, -30.0], np.float32),
            rng.uniform(0, 80, (n, k, 2)).astype(np.float32),
            (rng.rand(n, k) > 0.3).astype(np.float32),
            np.array([False, True, False]))
    ref = jax_preprocess_fn((48, 64), (12, 16), pad_num_joints=9)(*args)
    out = make_preprocess_fn((48, 64), (12, 16), pad_num_joints=9)(
        *(torch.from_numpy(a) for a in args))
    assert out['target'].shape == (n, 9, 16, 12)
    assert out['target_weight'].shape == (n, 9)
    assert not out['target'][:, k:].any() and not out['target_weight'][:, k:].any()
    for key in ('imgs', 'target', 'target_weight'):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-4)


# --- the zoo's ViTPose configs through the port's refusal checks ------------

VITPOSE_CONFIGS = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, 'vitpose_tpu', 'configs', '*', '*.py'))
    if os.path.basename(p).lower().startswith('vitpose'))


@pytest.mark.parametrize('path', VITPOSE_CONFIGS)
def test_vitpose_config_passes_the_ports_refusals(path):
    """What the runner checks before it reads data: the family and runtime
    refusals, the model config, each train set's metadata and class, the
    augmentation and the target type."""
    cfg = load_config(os.path.join(ROOT, path))
    _refuse_unported(cfg)
    mcfg = topdown_config(cfg['model'])
    dcfg = cfg['data']
    trains = (dcfg['train'] if isinstance(dcfg['train'], list)
              else [dict(dcfg['train'], dataset=dcfg.get('dataset', 'coco'))])
    for entry in trains:
        name = entry.get('dataset', 'coco')
        assert DatasetInfo.load(name).num_joints > 0
        topdown_dataset_cls(name)
    AugmentConfig(**dcfg.get('aug', {}))
    make_preprocess_fn(target_type=mcfg.target_type)
    if len(trains) > 1:
        assert mcfg.num_extra_heads == len(trains) - 1
        assert mcfg.backbone.num_experts == len(trains)


def test_the_zoo_has_119_vitpose_configs():
    assert len(VITPOSE_CONFIGS) == 119

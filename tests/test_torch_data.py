"""The port's host data path against the JAX package on the CPU: config
files, the COCO index, OKS NMS, the top-down dataset's record dbs, and the
loader's batches in eval and train mode, with the cv2 and the native
decoders.

Everything here is host numpy or pure Python copied from the JAX package, so
every comparison is exact: equal dicts, equal keep lists, equal records and
byte-identical batches.

The COCO fixture (`write_coco_fixture`) is written into a temporary
directory: seeded noise JPEGs written with cv2, most of them 120x160 and one
720x960, larger than the 640-pixel canvas, so that the loader's downscale
and its two coordinate frames are exercised; a COCO keypoint json and a
detection json. tests/test_torch_eval.py uses it too.
"""
import json
import os

import numpy as np
import pytest

from vitpose_tpu.data import TopDownDataset as JaxTopDownDataset
from vitpose_tpu.data.coco_index import CocoIndex as JaxCocoIndex
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.data.native import (
    decode_batch_native as jax_decode_batch_native,
    native_available as jax_native_available)
from vitpose_tpu.ops import nms as jnms
from vitpose_tpu.utils import config as jconfig

from vitpose_tpu_torch.data import (CocoIndex, TopDownDataset,
                                    topdown_dataset_cls)
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.data.native import (decode_batch_native,
                                           native_available)
from vitpose_tpu_torch.ops import nms
from vitpose_tpu_torch.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCO_B = os.path.join(ROOT, 'vitpose_tpu', 'configs', 'coco',
                      'vitpose_b_coco_256x192.py')
IMAGE_SIZE = (48, 64)                 # (w, h) of the tests' small model
BIG = (720, 960)                      # (h, w), larger than the canvas


def _image_ids(n_small):
    return list(range(1, n_small + 2))


def write_coco_fixture(root, seed=0, n_small=4, boxes_per_image=2):
    """JPEGs (n_small of 120x160 and one BIG), a COCO keypoint json with
    GT persons (some crowd, one with no visible joint, one degenerate box)
    and a detection json. Returns {'ann', 'det', 'prefix'}."""
    import cv2
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    sizes = [(120, 160)] * n_small + [BIG]
    images, anns, dets = [], [], []
    for img_id, (h, w) in zip(_image_ids(n_small), sizes):
        name = f'{img_id:06d}.jpg'
        cv2.imwrite(os.path.join(root, name),
                    rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append(dict(id=img_id, file_name=name, width=w, height=h))
        for j in range(boxes_per_image):
            bw, bh = rng.uniform(0.2, 0.5) * w, rng.uniform(0.3, 0.6) * h
            x, y = rng.uniform(-5, w - bw), rng.uniform(-5, h - bh)
            kp = np.stack([rng.uniform(x, x + bw, 17),
                           rng.uniform(y, y + bh, 17),
                           rng.randint(0, 3, 17)], 1)
            if img_id == 1 and j == 0:
                kp[:, 2] = 0                  # no labelled joint: dropped
            anns.append(dict(
                id=len(anns) + 1, image_id=img_id, category_id=1,
                bbox=[x, y, bw, bh], area=bw * bh * 0.8,
                iscrowd=int(img_id == 2 and j == 1),
                keypoints=kp.ravel().tolist(),
                num_keypoints=int((kp[:, 2] > 0).sum())))
            dets.append(dict(image_id=img_id, category_id=1,
                             bbox=[x + rng.uniform(-3, 3),
                                   y + rng.uniform(-3, 3), bw, bh],
                             score=float(rng.uniform(0.05, 1.0))))
    anns.append(dict(id=len(anns) + 1, image_id=1, category_id=1,
                     bbox=[10.0, 10.0, 0.0, 30.0], area=0.0, iscrowd=0,
                     keypoints=[20.0, 20.0, 2.0] * 17, num_keypoints=17))
    dets.append(dict(image_id=1, category_id=2, bbox=[0, 0, 30, 30],
                     score=0.9))                  # not a person: skipped
    out = dict(ann=os.path.join(root, 'ann.json'),
               det=os.path.join(root, 'det.json'), prefix=root + '/')
    with open(out['ann'], 'w') as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name='person')]), f)
    with open(out['det'], 'w') as f:
        json.dump(dets, f)
    return out


@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    return write_coco_fixture(str(tmp_path_factory.mktemp('coco')))


def dataset_pair(coco, **kw):
    """(JAX dataset, port dataset) over the fixture with the same
    arguments."""
    args = dict(dataset_info='coco', image_size=IMAGE_SIZE,
                heatmap_size=(12, 16), **kw)
    return (JaxTopDownDataset(coco['ann'], coco['prefix'], **args),
            TopDownDataset(coco['ann'], coco['prefix'], **args))


def assert_same_tree(a, b, path='root'):
    """Equal nested dicts/lists with numpy leaves of equal dtype and value,
    and equal Python leaves of equal type."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same_tree(a[k], b[k], f'{path}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_tree(x, y, f'{path}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


# --- config -----------------------------------------------------------------

def _base_and_delete_config(tmp_path):
    (tmp_path / 'base.py').write_text(
        "model = dict(variant='b', backbone_overrides=dict(depth=2),\n"
        "             head=dict(kind='a', width=3))\n"
        "data = dict(batch_size=8, val=dict(ann_file='x.json'))\n")
    (tmp_path / 'child.py').write_text(
        "_base_ = ['base.py']\n"
        "model = dict(variant='s', head=dict(_delete_=True, kind='b'))\n"
        "data = dict(val=dict(use_gt_bbox=False), extra=dict(_delete_=True,"
        " a=1))\n"
        "import os\nlr = 1e-3\n")
    return str(tmp_path / 'child.py')


OPTIONS = ['data.val.ann_file=/tmp/a.json', 'model.dtype=float32',
           'data.batch_size=4', 'new.key.path=(1, 2)', 'data.name=coco']


@pytest.mark.parametrize('which', ['coco_b', 'base_and_delete'])
def test_config_matches_jax(tmp_path, which):
    path = COCO_B if which == 'coco_b' else _base_and_delete_config(tmp_path)
    cfg = config.load_config(path)
    assert cfg == jconfig.load_config(path)
    assert config.apply_options(cfg, OPTIONS) == \
        jconfig.apply_options(cfg, OPTIONS)
    if which == 'base_and_delete':
        assert cfg['model']['head'] == {'kind': 'b'}
        assert cfg['model']['backbone_overrides'] == {'depth': 2}
        assert cfg['data']['extra'] == {'a': 1}


# --- CocoIndex and NMS ----------------------------------------------------------

def test_coco_index_matches_jax(coco):
    port, ref = CocoIndex(coco['ann']), JaxCocoIndex(coco['ann'])
    assert port.getImgIds() == ref.getImgIds()
    assert port.getCatIds() == ref.getCatIds() == [1]
    assert port.getCatIds(catNms=['person']) == [1]
    for kw in (dict(), dict(imgIds=2), dict(imgIds=[1, 3], iscrowd=False),
               dict(catIds=1, iscrowd=True), dict(catIds=[7])):
        assert port.getAnnIds(**kw) == ref.getAnnIds(**kw)
    ids = port.getAnnIds(imgIds=[1, 2])
    assert port.loadAnns(ids) == ref.loadAnns(ids)
    assert port.loadImgs([1, 2]) == ref.loadImgs([1, 2])
    rng = np.random.RandomState(0)
    res = [dict(image_id=int(i), category_id=1, score=float(rng.rand()),
                keypoints=rng.uniform(0, 100, 51).tolist())
           for i in rng.randint(1, 5, 6)]
    res[0]['area'] = 77.0
    a, b = port.loadRes(res), ref.loadRes(res)
    assert a.dataset == b.dataset and a.anns == b.anns


def _nms_candidates(seed, n=24, per_joint=False):
    rng = np.random.RandomState(seed)
    centres = rng.uniform(0, 200, (4, 2))
    out = []
    for i in range(n):
        kp = np.concatenate([centres[i % 4] + rng.normal(0, 6, (17, 2)),
                             rng.uniform(0, 1, (17, 1))], 1)
        out.append(dict(keypoints=kp.astype(np.float32),
                        score=(rng.uniform(0, 1, 17) if per_joint
                               else float(rng.uniform(0, 1))),
                        area=float(rng.uniform(500, 5000))))
    return out


@pytest.mark.parametrize('soft', [False, True])
@pytest.mark.parametrize('variant', ['default', 'vis_thr', 'per_joint'])
def test_oks_nms_matches_jax(soft, variant):
    kpts = _nms_candidates(3, per_joint=variant == 'per_joint')
    kw = dict(vis_thr=0.3) if variant == 'vis_thr' else \
        dict(score_per_joint=True) if variant == 'per_joint' else {}
    port = (nms.soft_oks_nms if soft else nms.oks_nms)(kpts, 0.5, **kw)
    ref = (jnms.soft_oks_nms if soft else jnms.oks_nms)(kpts, 0.5, **kw)
    assert [int(i) for i in port] == [int(i) for i in ref]
    assert 0 < len(port) < len(kpts)
    assert np.array_equal(nms.COCO_SIGMAS, jnms.COCO_SIGMAS)


# --- dataset records --------------------------------------------------------

@pytest.mark.parametrize('mode', ['gt', 'det', 'det_thr'])
def test_dataset_records_match_jax(coco, mode):
    kw = dict(test_mode=mode != 'gt', use_gt_bbox=mode == 'gt',
              bbox_file=coco['det'],
              det_bbox_thr=0.5 if mode == 'det_thr' else 0.0)
    ref, port = dataset_pair(coco, **kw)
    assert len(port) == len(ref) > 0
    assert_same_tree(port.db, ref.db)
    if mode == 'det_thr':
        with open(coco['det']) as f:
            people = [d for d in json.load(f) if d['category_id'] == 1]
        assert 0 < len(port) < len(people)
    if mode == 'gt':
        # the no-joint person and the zero-width box are dropped
        with open(coco['ann']) as f:
            n_ann = len(json.load(f)['annotations'])
        assert len(port) < n_ann


def test_topdown_dataset_cls():
    """COCO-format datasets use TopDownDataset (MPII, MPII-TRB,
    COCO-WholeBody, PoseTrack18 and Sub-JHMDB their own classes,
    tests/test_torch_zoo_data.py and tests/test_torch_video_sets.py)."""
    assert topdown_dataset_cls('coco') is TopDownDataset
    assert topdown_dataset_cls('crowdpose') is TopDownDataset
    for name, cls in (('posetrack18', 'PoseTrackDataset'),
                      ('jhmdb', 'JhmdbDataset')):
        assert topdown_dataset_cls(name).__name__ == cls
        assert issubclass(topdown_dataset_cls(name), TopDownDataset)


# --- loader -----------------------------------------------------------------

def _batches(loader, use_native, epoch=0):
    loader.use_native = use_native
    loader.set_epoch(epoch)
    return list(loader)


def _loader_pair(coco, decoder, **kw):
    ref_ds, port_ds = dataset_pair(
        coco, test_mode=not kw.get('is_train', False),
        use_gt_bbox=kw.get('is_train', False), bbox_file=coco['det'])
    if decoder == 'native' and not native_available():
        pytest.skip('no native loader here: jpeglib.h or a C++ compiler is '
                    'missing')
    ref = JaxTopDownLoader(ref_ds, 4, num_workers=2, **kw)
    port = TopDownLoader(port_ds, 4, num_workers=2, **kw)
    return ref, port


@pytest.mark.parametrize('decoder', ['cv2', 'native'])
def test_loader_eval_batches_match_jax(coco, decoder):
    """Ragged last batch, one source larger than the canvas: byte-identical
    canvases and exactly equal geometry, ids and paths."""
    ref, port = _loader_pair(coco, decoder, is_train=False)
    native = decoder == 'native'
    if native:
        assert jax_native_available()
    a, b = _batches(ref, native), _batches(port, native)
    assert len(a) == len(b) == len(port) == 3
    assert_same_tree(b, a)
    last = b[-1]
    assert 0 < last['valid'].sum() < len(last['valid'])
    big = [i for i, p in enumerate(last['image_paths'] + b[0]['image_paths'])
           if p.endswith('000005.jpg')]
    assert big
    sf = np.concatenate([x['scale_factor'] for x in b])
    assert sf.min() < 1.0 and np.allclose(sf[sf < 1], 640 / BIG[1])
    shrunk = np.concatenate([x['scale_factor'] < 1 for x in b])
    c = np.concatenate([x['center'] for x in b])[shrunk]
    co = np.concatenate([x['center_orig'] for x in b])[shrunk]
    assert np.allclose(co * 640 / BIG[1], c)


@pytest.mark.parametrize('epoch', [0, 3])
def test_loader_train_draws_match_jax(coco, epoch):
    """Train mode: the same shuffle and the same augmentation draws for the
    same seed and epoch."""
    ref, port = _loader_pair(coco, 'cv2', is_train=True, seed=5)
    a, b = _batches(ref, False, epoch), _batches(port, False, epoch)
    assert len(b) == len(port) == len(a) > 0
    assert_same_tree(b, a)
    assert any(x['flip'].any() for x in b)
    assert any((x['rot'] != 0).any() for x in b)


@pytest.mark.parametrize('count', [2, 3, 20])
def test_loader_shards_match_jax(coco, count):
    ref, port = _loader_pair(coco, 'cv2', is_train=False)
    for index in range(count):
        for loader in (ref, port):
            loader.process_index, loader.process_count = index, count
        assert len(port) == len(ref)
        assert np.array_equal(port._indices(), ref._indices())


def test_native_decode_matches_jax_native(coco):
    if not native_available():
        pytest.skip('no native loader here: jpeglib.h or a C++ compiler is '
                    'missing')
    paths = [os.path.join(coco['prefix'], f'{i:06d}.jpg')
             for i in (5, 1, 2)]
    port = decode_batch_native(paths, 640, 2)
    ref = jax_decode_batch_native(paths, 640, 2)
    assert_same_tree(list(port), list(ref))
    assert port[1][0] == np.float32(640 / BIG[1])
    with pytest.raises(IOError, match='missing.jpg'):
        decode_batch_native([paths[0], coco['prefix'] + 'missing.jpg'], 640)

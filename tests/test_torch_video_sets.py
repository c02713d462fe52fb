"""The port's PoseTrack18 and Sub-JHMDB datasets (ROADMAP item 12d) against
the JAX package on the CPU, on synthetic annotation files written into a
temporary directory (tests/test_torch_zoo_data.py `write_kpt_fixture`:
seeded noise JPEGs, people with boxes, 17 or 15 joints; PoseTrack's images
in two videos, one unlabelled, people with head boxes).

  * PoseTrack18: records, the per-video prediction jsons (read back, equal
    to JAX's), and the poseval AP table for perfect predictions (100), noisy
    ones (below 100) and none at all (0), equal to JAX's within 1e-9;
    `evaluate_posetrack_ap` and `_voc_ap` on hand-made cases (greedy
    matching, unpredicted joints, no ground truth); the 1920-pixel canvas
    the loader takes.
  * Sub-JHMDB: the PCK and tPCK tables for perfect and noisy predictions,
    one person with no labelled joint and one with a degenerate torso (the
    threshold then falls back to the prediction's), equal to JAX's within
    1e-9.
"""
import json
import os

import numpy as np
import pytest

from vitpose_tpu.data import JhmdbDataset as JaxJhmdb
from vitpose_tpu.data import PoseTrackDataset as JaxPoseTrack
from vitpose_tpu.data import posetrack as jposetrack
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader

from test_torch_data import assert_same_tree
from test_torch_zoo_data import write_kpt_fixture
from vitpose_tpu_torch.data import (JhmdbDataset, PoseTrackDataset,
                                    TopDownLoader, topdown_dataset_cls)
from vitpose_tpu_torch.data import posetrack as pposetrack
from test_torch_threads import torch_test_threads  # noqa: F401

TOL = 1e-9


@pytest.fixture(scope='module')
def sets(tmp_path_factory):
    root = tmp_path_factory.mktemp('video_sets')
    return dict(
        posetrack=write_kpt_fixture(str(root / 'posetrack'), 21, 17,
                                    n_images=6, per_image=3, video=True),
        jhmdb=write_kpt_fixture(str(root / 'jhmdb'), 22, 15, n_images=5,
                                per_image=2))


def pair(cls_ref, cls_port, fixture, **kw):
    args = dict(image_size=(48, 64), heatmap_size=(12, 16), test_mode=True,
                use_gt_bbox=True, **kw)
    return (cls_ref(fixture['ann'], fixture['prefix'], **args),
            cls_port(fixture['ann'], fixture['prefix'], **args))


def results_of(ds, noise=0.0, seed=0, keep=None):
    """Results entries (one per record, as the val loop gives them) of the
    GT joints plus seeded noise, per-joint scores 0.9 on labelled joints;
    `keep` selects the records that get one."""
    rng = np.random.RandomState(seed)
    out = []
    for i, rec in enumerate(ds.db):
        if keep is not None and not keep(i):
            continue
        kp = rec['joints_3d'].copy()
        kp[:, :2] += rng.randn(ds.num_joints, 2) * noise
        kp[:, 2] = np.where(rec['joints_3d_visible'][:, 0] > 0, 0.9, 0.0)
        x, y, w, h = rec['bbox']
        out.append(dict(preds=kp[None].astype(np.float32),
                        boxes=np.array([[x + w / 2, y + h / 2, w / 200,
                                         h / 200, float(w * h), 1.0]]),
                        image_paths=[rec['image_file']],
                        bbox_ids=[rec['bbox_id']]))
    return out


def assert_stats_equal(got, want):
    assert list(got) == list(want) and len(got) > 0
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL or (np.isnan(got[k]) and np.isnan(v)), \
            (k, got[k], v)


@pytest.mark.parametrize('case', ['perfect', 'noisy', 'empty'])
def test_posetrack_table_and_video_jsons_match_jax(sets, case, tmp_path):
    ref, port = pair(JaxPoseTrack, PoseTrackDataset, sets['posetrack'])
    assert type(port) is topdown_dataset_cls('posetrack18')
    assert_same_tree(port.db, ref.db)
    results = {'perfect': lambda: results_of(port),
               'noisy': lambda: results_of(port, noise=6.0, seed=3),
               'empty': lambda: results_of(port, keep=lambda i: False)}[
                   case]()
    folders = {k: str(tmp_path / k) for k in ('ref', 'port')}
    want = ref.evaluate(results, res_folder=folders['ref'])
    got = port.evaluate(results, res_folder=folders['port'])
    assert_stats_equal(got, want)
    total = got['Total AP']
    assert {'perfect': total == pytest.approx(100.0),
            'noisy': 0 < total < 100, 'empty': total == 0.0}[case], got
    names = sorted(os.listdir(folders['ref']))
    assert names == sorted(os.listdir(folders['port'])) \
        == ['010001.json', '010002.json']
    for name in names:
        with open(os.path.join(folders['ref'], name)) as f:
            a = json.load(f)
        with open(os.path.join(folders['port'], name)) as f:
            b = json.load(f)
        assert a == b and len(a['images']) == 3
        assert len(a['annotations']) == (0 if case == 'empty' else 9)


def test_posetrack_ap_protocol_matches_jax():
    """Greedy PCKh matching (the far, higher-scored pose is a false
    positive), a joint not predicted (score 0), a frame without ground
    truth, a pose whose joints are all unlabelled."""
    gt = [[dict(joints=np.array([[10, 10, 1]] * 17, np.float32),
                head_size=10.0),
           dict(joints=np.array([[60, 60, 0]] * 17, np.float32),
                head_size=10.0)],
          []]
    good = np.array([[11, 11, 0.9]] * 17, np.float32)
    good[3, 2] = 0
    bad = np.array([[100, 100, 0.95]] * 17, np.float32)
    preds = [[dict(joints=bad), dict(joints=good)], [dict(joints=good)]]
    got = pposetrack.evaluate_posetrack_ap(gt, preds)
    assert_stats_equal(got, jposetrack.evaluate_posetrack_ap(gt, preds))
    assert 0 < got['Total AP'] < 100
    for scores, tp, n in (([], [], 0), ([], [], 3), ([0.5, 0.7, 0.7],
                                                     [1, 0, 1], 4)):
        a, b = pposetrack._voc_ap(scores, tp, n), \
            jposetrack._voc_ap(scores, tp, n)
        assert a == b or (np.isnan(a) and np.isnan(b))
    assert pposetrack._head_size([1, 2, 3, 4]) == \
        jposetrack._head_size([1, 2, 3, 4])


def test_posetrack_loader_takes_the_1920_canvas(sets):
    ref, port = pair(JaxPoseTrack, PoseTrackDataset, sets['posetrack'])
    assert port.canvas_size == ref.canvas_size == 1920
    a = next(iter(JaxTopDownLoader(ref, 2, is_train=False, num_workers=1)))
    b = next(iter(TopDownLoader(port, 2, is_train=False, num_workers=1)))
    assert b['imgs'].shape == (2, 1920, 1920, 3)
    assert_same_tree(b, a)


@pytest.mark.parametrize('case', ['perfect', 'noisy'])
def test_jhmdb_tables_match_jax(sets, case):
    ref, port = pair(JaxJhmdb, JhmdbDataset, sets['jhmdb'])
    assert type(port) is topdown_dataset_cls('jhmdb')
    assert_same_tree(port.db, ref.db)
    # one person with no labelled joint, one whose torso (joints 4 and 5)
    # is a point: its tPCK threshold is the prediction's torso
    for ds in (ref, port):
        ds.db[0]['joints_3d_visible'][:] = 0
        ds.db[1]['joints_3d'][5] = ds.db[1]['joints_3d'][4]
    results = results_of(port, noise=0.0 if case == 'perfect' else 8.0,
                         seed=5)
    want = ref.evaluate(results, metric=['PCK', 'tPCK'])
    got = port.evaluate(results, metric=['PCK', 'tPCK'])
    assert_stats_equal(got, want)
    assert len(got) == 16
    if case == 'perfect':
        assert got['Mean PCK'] == got['Mean tPCK'] == 1.0
    else:
        assert got['Mean tPCK'] < 1.0 and 0 < got['Mean PCK'] < 1.0
    with pytest.raises(KeyError, match='not supported'):
        port.evaluate(results, metric='mAP')

"""The port's evaluation path against the JAX package on the CPU: COCO
keypoint AP, the host keypoint metrics, `TopDownDataset.evaluate`, the val
loop (`run_validation`), checkpoint regridding, config-file models and the
evaluation CLI.

Tolerances:
  * COCO AP, CrowdPose AP and the PCK/AUC/EPE/NME metrics are host numpy
    copied from the JAX package: 1e-12 (the same arithmetic, so in practice
    equal).
  * `run_validation` on the small model of tests/test_torch_models.py (64x48
    crops, width 32, depth 2, peaked weights; f32): keypoints within 1e-3 px
    and maxvals within 1e-4, as the port's serving tests hold them; the AP
    and AR of the two result lists within 1e-6. The GT is made from the JAX
    predictions plus seeded jitter of a few pixels, so that AP lies strictly
    between 0 and 1.
  * The pos-embed regrid and patch-kernel pad: 1e-6; heatmaps of a model
    loaded from a regridded .pth: 1e-4, the f32 model tolerance of
    tests/test_torch_models.py.
"""
import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitpose_tpu.data import TopDownDataset as JaxTopDownDataset
from vitpose_tpu.data.coco_index import CocoIndex as JaxCocoIndex
from vitpose_tpu.data.loader import TopDownLoader as JaxTopDownLoader
from vitpose_tpu.eval import cocoeval as jcocoeval
from vitpose_tpu.eval.loop import run_validation as jax_run_validation
from vitpose_tpu.models import TopDownModel as JaxTopDown
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.ops import decode as jdecode
from vitpose_tpu.train.loop import build_model_from_cfg as jax_build_model
from vitpose_tpu.utils import torch_ckpt as jckpt
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.utils.config import load_config as jax_load_config

from test_torch_data import (COCO_B, IMAGE_SIZE, dataset_pair,
                             write_coco_fixture)
from test_torch_models import (SMALL, _compile_fast, _crops, _peaked,
                               _port_model, _random_variables, _small)
from vitpose_tpu_torch.api import init_pose_model
from vitpose_tpu_torch.data import CocoIndex, TopDownDataset
from vitpose_tpu_torch.data.loader import TopDownLoader
from vitpose_tpu_torch.eval import cocoeval
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.models import make_config
from vitpose_tpu_torch.ops import decode
from vitpose_tpu_torch.tools import test as cli
from vitpose_tpu_torch.train.loop import build_model_from_cfg, topdown_config
from vitpose_tpu_torch.utils import torch_ckpt
from vitpose_tpu_torch.utils.convert import state_dict_from_flax
from test_torch_threads import torch_test_threads  # noqa: F401

EXACT = dict(rtol=0, atol=1e-12)
AP_TOL = 1e-6
KP_TOL_PX = 1e-3
MAXVAL_TOL = 1e-4
HM_TOL = dict(rtol=1e-4, atol=1e-4)


def assert_stats_close(port, ref, atol):
    assert list(port) == list(ref)
    for k in ref:
        assert abs(port[k] - ref[k]) <= atol, (k, port[k], ref[k])


# --- COCO keypoint AP ---------------------------------------------------------

def _random_coco(seed, n_img=6):
    """GT with crowd persons, persons without a visible joint and images
    without GT; detections near the GT, false positives and one with zero
    confidence. Returns (gt dict, detection list)."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for img_id in range(1, n_img + 1):
        images.append(dict(id=img_id, file_name=f'{img_id}.jpg', width=640,
                           height=480, crowdIndex=float(rng.rand())))
        for _ in range(rng.randint(0 if img_id == n_img else 1, 4)):
            w, h = rng.uniform(20, 200), rng.uniform(40, 300)
            x, y = rng.uniform(0, 400), rng.uniform(0, 150)
            kp = np.stack([rng.uniform(x, x + w, 17), rng.uniform(y, y + h, 17),
                           rng.choice([0, 1, 2], 17, p=[.2, .3, .5])], 1)
            if rng.rand() < 0.15:
                kp[:, 2] = 0
            anns.append(dict(id=len(anns) + 1, image_id=img_id, category_id=1,
                             bbox=[x, y, w, h], area=w * h * 0.7,
                             iscrowd=int(rng.rand() < 0.15),
                             num_keypoints=int((kp[:, 2] == 2).sum()),
                             keypoints=kp.ravel().tolist()))
            for _ in range(rng.randint(0, 3)):
                d = kp.copy()
                d[:, :2] += rng.normal(0, rng.uniform(1, 15), (17, 2))
                d[:, 2] = rng.uniform(0, 1, 17)
                dets.append(dict(image_id=img_id, category_id=1,
                                 score=float(rng.rand()),
                                 keypoints=d.ravel().tolist()))
        for _ in range(rng.randint(0, 2)):           # false positives
            d = np.stack([rng.uniform(0, 640, 17), rng.uniform(0, 480, 17),
                          rng.uniform(0, 1, 17)], 1)
            dets.append(dict(image_id=img_id, category_id=1,
                             score=float(rng.rand()),
                             keypoints=d.ravel().tolist()))
    dets[0]['keypoints'][2::3] = [0.0] * 17          # dropped by the eval
    gt = dict(images=images, annotations=anns,
              categories=[dict(id=1, name='person')])
    return gt, dets


COCO_EVAL_CASES = ['default', 'no_area', 'num_keypoints_ignore',
                   'max_dets_2', 'crowdpose']


@pytest.mark.parametrize('case', COCO_EVAL_CASES)
@pytest.mark.parametrize('seed', [0, 1])
def test_coco_eval_matches_jax(case, seed):
    gt, dets = _random_coco(seed)
    port_gt, ref_gt = CocoIndex(dataset=copy.deepcopy(gt)), \
        JaxCocoIndex(dataset=copy.deepcopy(gt))
    port_dt, ref_dt = port_gt.loadRes(dets), ref_gt.loadRes(dets)
    sigmas = np.full(17, 0.07) if case == 'crowdpose' else None
    if case == 'crowdpose':
        port = cocoeval.evaluate_crowdpose(port_gt, port_dt, sigmas)
        ref = jcocoeval.evaluate_crowdpose(ref_gt, ref_dt, sigmas)
    else:
        kw = {'default': {}, 'no_area': dict(use_area=False),
              'num_keypoints_ignore': dict(gt_ignore_from_num_keypoints=True),
              'max_dets_2': dict(max_dets=2)}[case]
        port = cocoeval.CocoKeypointEval(port_gt, **kw).evaluate(port_dt)
        ref = jcocoeval.CocoKeypointEval(ref_gt, **kw).evaluate(ref_dt)
        assert sorted(port) == sorted(cocoeval.COCO_KPT_STAT_NAMES)
    assert_stats_close(port, ref, EXACT['atol'])
    assert 0 < port['AP'] < 1


def test_oks_matrix_matches_jax():
    gt, dets = _random_coco(2)
    gts = [a for a in gt['annotations'] if a['image_id'] == 1]
    dts = [d for d in dets if d['image_id'] == 1]
    sig = np.asarray(cocoeval._DEFAULT_SIGMAS)
    np.testing.assert_allclose(cocoeval.compute_oks_matrix(gts, dts, sig),
                               jcocoeval.compute_oks_matrix(gts, dts, sig),
                               **EXACT)


# --- host keypoint metrics ----------------------------------------------------

@pytest.mark.parametrize('metric', ['pck', 'auc', 'nme', 'epe'])
def test_keypoint_metrics_match_jax(metric):
    rng = np.random.RandomState(7)
    gt = rng.uniform(0, 100, (9, 17, 2)).astype(np.float32)
    pred = gt + rng.normal(0, 4, gt.shape).astype(np.float32)
    mask = rng.rand(9, 17) > 0.2
    mask[:, 3] = False                              # a joint never labelled
    norm = rng.uniform(20, 60, (9, 2)).astype(np.float32)
    norm[2] = 0.0                                   # a row without a scale
    args = {'pck': (pred, gt, mask, 0.1, norm), 'auc': (pred, gt, mask, 30),
            'nme': (pred, gt, mask, norm), 'epe': (pred, gt, mask)}[metric]
    fn = {'pck': 'keypoint_pck_accuracy', 'auc': 'keypoint_auc',
          'nme': 'keypoint_nme', 'epe': 'keypoint_epe'}[metric]
    port, ref = getattr(decode, fn)(*args), getattr(jdecode, fn)(*args)
    if metric == 'pck':
        np.testing.assert_array_equal(port[0], ref[0])
        assert port[1:] == ref[1:]
    else:
        assert port == ref


# --- TopDownDataset.evaluate ------------------------------------------------

@pytest.fixture(scope='module')
def coco(tmp_path_factory):
    return write_coco_fixture(str(tmp_path_factory.mktemp('coco')))


def _results_for(db, seed, batch=3):
    """A results list covering every record of `db`: joints plus noise,
    seeded confidences, boxes from the records' bboxes."""
    rng = np.random.RandomState(seed)
    results = []
    for s in range(0, len(db), batch):
        recs = db[s:s + batch]
        preds = np.stack([np.concatenate(
            [r['joints_3d'][:, :2] + rng.normal(0, 3, (17, 2)),
             rng.uniform(0, 1, (17, 1))], 1) for r in recs]).astype(
                 np.float32)
        c = np.stack([r['bbox'][:2] + r['bbox'][2:] / 2 for r in recs])
        s_ = np.stack([r['bbox'][2:] / 200 * 1.25 for r in recs])
        boxes = np.concatenate([c, s_, np.prod(s_ * 200, 1, keepdims=True),
                                rng.uniform(0.3, 1, (len(recs), 1))], 1)
        results.append(dict(preds=preds, boxes=boxes.astype(np.float32),
                            image_paths=[r['image_file'] for r in recs],
                            bbox_ids=[r['bbox_id'] for r in recs]))
    return results


EVAL_CASES = {
    'mAP': (dict(), dict(metric='mAP')),
    'mAP_rle_score': (dict(), dict(metric='mAP', rle_score=True)),
    'mAP_soft_nms': (dict(soft_nms=True, oks_thr=0.5), dict(metric='mAP')),
    'mAP_no_nms': (dict(use_nms=False), dict(metric='mAP')),
    'PCK_AUC_EPE': (dict(), dict(metric=['PCK', 'AUC', 'EPE'])),
}


@pytest.mark.parametrize('case', list(EVAL_CASES))
def test_dataset_evaluate_matches_jax(coco, tmp_path, case):
    ds_kw, ev_kw = EVAL_CASES[case]
    ref, port = dataset_pair(coco, test_mode=True, use_gt_bbox=True, **ds_kw)
    results = _results_for(port.db, seed=1)
    out_p, out_r = str(tmp_path / 'port'), str(tmp_path / 'ref')
    port_stats = port.evaluate(copy.deepcopy(results), res_folder=out_p,
                               **ev_kw)
    ref_stats = ref.evaluate(copy.deepcopy(results), res_folder=out_r,
                             **ev_kw)
    assert_stats_close(port_stats, ref_stats, EXACT['atol'])
    if ev_kw['metric'] != 'mAP':
        return
    assert 0 < port_stats['AP'] < 1
    with open(os.path.join(out_p, 'result_keypoints.json')) as f:
        port_json = json.load(f)
    with open(os.path.join(out_r, 'result_keypoints.json')) as f:
        assert port_json == json.load(f)


def test_evaluate_per_kpts_matches_jax(coco):
    ref, port = dataset_pair(coco, test_mode=True, use_gt_bbox=True)
    results = _results_for(port.db, seed=2)
    p, r = port.evaluate_per_kpts(results), ref.evaluate_per_kpts(results)
    assert len(p) == len(r) == 17
    for a, b in zip(p, r):
        assert_stats_close(a, b, EXACT['atol'])


# --- run_validation -----------------------------------------------------------

def _port_loader(coco, batch=4):
    ds = TopDownDataset(coco['ann'], coco['prefix'], image_size=IMAGE_SIZE,
                        heatmap_size=(12, 16), test_mode=True,
                        use_gt_bbox=False, bbox_file=coco['det'])
    return TopDownLoader(ds, batch, is_train=False, num_workers=2)


def _jax_loader(coco, batch=4):
    ds = JaxTopDownDataset(coco['ann'], coco['prefix'], image_size=IMAGE_SIZE,
                           heatmap_size=(12, 16), test_mode=True,
                           use_gt_bbox=False, bbox_file=coco['det'])
    return JaxTopDownLoader(ds, batch, is_train=False, num_workers=2)


def _write_gt_from(results, coco, seed):
    """Rewrite the fixture's annotations: one GT person per detection (every
    fourth left out, a false positive), its joints the JAX predictions plus
    a few pixels of seeded jitter, some unlabelled."""
    rng = np.random.RandomState(seed)
    with open(coco['ann']) as f:
        data = json.load(f)
    with open(coco['det']) as f:
        people = [d for d in json.load(f) if d['category_id'] == 1]
    name2id = {im['file_name']: im['id'] for im in data['images']}
    anns = []
    for r in results:
        for kp, path, bid in zip(r['preds'], r['image_paths'], r['bbox_ids']):
            if bid % 4 == 3:
                continue
            x, y, w, h = people[bid]['bbox']
            xy = kp[:, :2] + rng.normal(0, 2.0, (17, 2))
            v = np.where(rng.rand(17) < 0.85, 2, 0)
            anns.append(dict(
                id=len(anns) + 1, image_id=name2id[os.path.basename(path)],
                category_id=1, bbox=[x, y, w, h], area=w * h, iscrowd=0,
                num_keypoints=int((v > 0).sum()),
                keypoints=np.concatenate([xy, v[:, None]], 1).ravel()
                .tolist()))
    data['annotations'] = anns
    with open(coco['ann'], 'w') as f:
        json.dump(data, f)


@pytest.fixture(scope='module')
def val_setup(tmp_path_factory):
    """The fixture (10 detections, batches of 4: the last one ragged; one
    source larger than the canvas), peaked small-model variables, the JAX
    model and its run_validation results with the UDP decode and with
    post_process='unbiased', and the GT rewritten from the UDP results."""
    coco = write_coco_fixture(str(tmp_path_factory.mktemp('val')), seed=1)
    variables = _peaked(_random_variables(1, out_channels=17))
    jm = JaxTopDown(_small(jax_make_config, out_channels=17))
    jv = jax.tree.map(jnp.asarray, variables)
    loader = _jax_loader(coco)
    ref = {'udp': jax_run_validation(jm, jv, loader),
           'unbiased': jax_run_validation(jm, jv, loader, use_udp=False,
                                          post_process='unbiased')}
    _write_gt_from(ref['udp'], coco, seed=2)
    return coco, variables, ref


def _assert_results_close(port, ref):
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert p['image_paths'] == r['image_paths']
        assert p['bbox_ids'] == r['bbox_ids']
        assert p['preds'].shape == r['preds'].shape
        assert p['preds'].dtype == r['preds'].dtype == np.float32
        assert np.abs(p['preds'][..., :2] - r['preds'][..., :2]).max() \
            <= KP_TOL_PX
        assert np.abs(p['preds'][..., 2] - r['preds'][..., 2]).max() \
            <= MAXVAL_TOL
        np.testing.assert_array_equal(p['boxes'], r['boxes'])
    assert sum(len(p['bbox_ids']) for p in port) == 10


@pytest.mark.parametrize('decode_mode', ['udp', 'unbiased'])
def test_run_validation_matches_jax(val_setup, decode_mode):
    coco, variables, ref = val_setup
    model = _port_model(_small(make_config, out_channels=17), variables)
    kw = {} if decode_mode == 'udp' else dict(use_udp=False,
                                               post_process='unbiased')
    port = run_validation(model, _port_loader(coco), **kw)
    _assert_results_close(port, ref[decode_mode])
    gt_ref, gt_port = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                                   bbox_file=coco['det'])
    stats = gt_port.evaluate(port)
    assert_stats_close(stats, gt_ref.evaluate(ref[decode_mode]), AP_TOL)
    assert 0 < stats['AP'] < 1


def test_run_validation_refuses_unported(val_setup):
    """Nothing of run_validation is refused since item 7: target_type
    'Regression' takes the DeepPose decode (a DeepPose model's
    coordinates, maxvals of one; held to JAX's in
    tests/test_torch_td_rest.py). (ViTPose+ expert and head selection:
    tests/test_torch_moe*.py.)"""
    coco, _, _ = val_setup
    model = build_model_from_cfg(dict(
        backbone_type='resnet', backbone_overrides=dict(depth=18),
        img_size=(64, 48), out_channels=17, head='regression',
        target_type='Regression', use_udp=False))
    results = run_validation(model, _port_loader(coco), use_udp=False,
                             target_type='Regression')
    preds = np.concatenate([r['preds'] for r in results])
    assert preds.shape == (10, 17, 3) and np.isfinite(preds).all()
    assert (preds[..., 2] == 1).all()


# --- the CLI ---------------------------------------------------------------

def _small_config(tmp_path):
    path = tmp_path / 'small.py'
    path.write_text(
        "_base_ = ['" + os.path.dirname(COCO_B) + "/../base/coco_data.py']\n"
        "model = dict(variant='b', img_size=(64, 48), out_channels=17,\n"
        "             deconv_filters=(16, 16), flip_test=True, use_udp=True,\n"
        "             post_process='default',\n"
        f"             backbone_overrides=dict({', '.join(f'{k}={v}' for k, v in SMALL.items())}))\n"
        "data = dict(image_size=(48, 64), heatmap_size=(12, 16),\n"
        "            batch_size=4, num_workers=2)\n")
    return str(path)


def test_cli_matches_jax(val_setup, tmp_path):
    """main() on a small config and an .npz saved from the JAX model writes
    the stats of the JAX package's run_validation + evaluate."""
    coco, variables, ref = val_setup
    npz = str(tmp_path / 'small.npz')
    save_params_npz(npz, variables)
    out = str(tmp_path / 'stats.json')
    stats = cli.main([
        _small_config(tmp_path), npz, '--device', 'cpu', '--out', out,
        '--cfg-options', f"data.val.ann_file={coco['ann']}",
        f"data.val.img_prefix={coco['prefix']}",
        f"data.val.bbox_file={coco['det']}"])
    ref_ds, _ = dataset_pair(coco, test_mode=True, use_gt_bbox=False,
                             bbox_file=coco['det'])
    ref_stats = ref_ds.evaluate(ref['udp'])
    with open(out) as f:
        written = json.load(f)
    assert_stats_close(written, ref_stats, AP_TOL)
    assert written == {k: float(v) for k, v in stats.items()}
    assert sorted(written) == sorted(cocoeval.COCO_KPT_STAT_NAMES)
    assert 0 < written['AP'] < 1


@pytest.mark.parametrize('flag', ['--int8', '--tmpdir', 'family', 'cuda'])
def test_cli_refuses_unported(tmp_path, monkeypatch, flag):
    """--int8 is refused only for a ViTPose+ (MoE) model, whose MLP has no
    int8 path, as in JAX; every family of the zoo is evaluated since item
    12f, and a family the zoo does not have is refused; --tmpdir is taken
    since item 11."""
    args = [_small_config(tmp_path), 'none.npz', '--device', 'cpu']
    if flag == 'family':
        args += ['--cfg-options', 'model.family=nerf']
    elif flag == 'cuda':
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
        args = args[:2] + ['--device', 'cuda']
    elif flag == '--int8':
        args += [flag, '--cfg-options', 'model.num_experts=2',
                 'model.part_dim=8']
    else:
        # --tmpdir is taken since item 11 (the folder of a multi-process
        # gather; one process gathers nothing): the run gets past the
        # refusals to the data, which this config does not have
        with pytest.raises(FileNotFoundError, match='No such file'):
            cli.main(args + [flag, str(tmp_path)])
        return
    with pytest.raises((NotImplementedError, RuntimeError, KeyError),
                       match='ROADMAP|CUDA is not available|MoE|'
                             'unknown model family'):
        cli.main(args)


# --- config-file models -------------------------------------------------------

def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k != 'backbone'}


def test_config_file_model_matches_jax():
    """The COCO-B config's model dict gives the JAX package's TopDownConfig
    (the fields both packages have)."""
    mcfg = jax_load_config(COCO_B)['model']
    port, ref = topdown_config(mcfg), jax_build_model(mcfg).cfg
    assert _fields(port) == {k: v for k, v in _fields(ref).items()
                             if k in _fields(port)}
    bb_port, bb_ref = dataclasses.asdict(port.backbone), \
        dataclasses.asdict(ref.backbone)
    assert bb_port == {k: bb_ref[k] for k in bb_port}
    assert port.backbone.dtype == 'bfloat16' and port.backbone.fused_attention
    # a CNN backbone builds its GenericTopDown (ROADMAP item 12's CNN
    # top-down; HRFormer since item 12c); every family of the zoo builds
    # since item 12f, and a family the zoo does not have raises
    cnn = build_model_from_cfg(dict(
        mcfg, backbone_type='hrnet',
        backbone_overrides=dict(width=8, stage_modules=(1, 1),
                                stage_blocks=1)))
    assert type(cnn).__name__ == 'GenericTopDown'
    assert cnn.backbone_type == 'hrnet' and cnn.cfg.backbone.depth == 12
    mesh = build_model_from_cfg(dict(
        family='mesh', backbone_type='resnet',
        backbone_overrides=dict(depth=18)))
    assert type(mesh).__name__ == 'ParametricMesh'
    with pytest.raises(KeyError, match='unknown model family'):
        build_model_from_cfg(dict(mcfg, family='nerf'))
    former = build_model_from_cfg(dict(
        mcfg, backbone_type='hrformer', backbone_overrides=dict(
            width=8, stage_modules=(1,), num_heads=(1, 2),
            blocks_per_module=1)))
    assert type(former.backbone).__name__ == 'HRFormer'
    assert former.backbone_type == 'hrformer'



@pytest.mark.parametrize('source', ['file', 'model_dict'])
def test_init_pose_model_from_config_file(val_setup, tmp_path, source):
    """A config FILE path as `config`, or its model dict with a
    'backbone_type': `img_size` is (h, w) there; the file names the
    dataset; an .npz loads into the same model as state_dict_from_flax
    gives."""
    _, variables, _ = val_setup
    npz = str(tmp_path / 'small.npz')
    save_params_npz(npz, variables)
    config = _small_config(tmp_path)
    if source == 'model_dict':
        config = dict(jax_load_config(config)['model'], backbone_type='vit')
    pm = init_pose_model(config, npz, device='cpu')
    assert pm.image_size == (48, 64) and pm.heatmap_size == (12, 16)
    assert pm.dataset_info.dataset_name == 'coco'
    ref = _port_model(_small(make_config, out_channels=17), variables)
    x = torch.from_numpy(_crops(6))
    with torch.no_grad():
        assert torch.equal(pm.model(x), ref(x))


# --- checkpoint regrid -------------------------------------------------------

@pytest.mark.parametrize('source', ['cls_5x5', 'no_cls_6x6', 'distilled_4x4',
                                    'cls_matching', 'no_cls_matching'])
def test_interpolate_pos_embed_matches_jax(source):
    grid = (4, 3)
    length = {'cls_5x5': 26, 'no_cls_6x6': 36, 'distilled_4x4': 18,
              'cls_matching': 13, 'no_cls_matching': 12}[source]
    pos = np.random.RandomState(length).randn(1, length, 8).astype(
        np.float32)
    port = torch_ckpt._interpolate_pos_embed(pos, 12, grid)
    ref = jckpt._interpolate_pos_embed(pos, 12, grid)
    assert port.shape == ref.shape == (1, 13, 8)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize('mode,k', [('pad', 14), ('pad', 13), ('pad', 16),
                                    ('bicubic', 14), ('pad', 18),
                                    ('bilinear', 12)])
def test_adapt_patch_embed_matches_jax(mode, k):
    kernel = np.random.RandomState(k).randn(6, 3, k, k).astype(np.float32)
    port = torch_ckpt._adapt_patch_embed(kernel, 16, mode)
    ref = jckpt._adapt_patch_embed(kernel, 16, mode)
    assert port.shape == ref.shape == (6, 3, 16, 16)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def test_regridded_pth_matches_jax_conversion(tmp_path):
    """An mmpose .pth (torch.save) whose pos embed has a 5x5 grid and whose
    patch kernel is 14x14 loads through init_pose_model and gives the
    heatmaps of the JAX package's convert_topdown_checkpoint model."""
    variables = _random_variables(4, out_channels=17)
    sd = state_dict_from_flax(variables)
    rng = np.random.RandomState(5)
    sd['backbone.pos_embed'] = torch.from_numpy(
        0.02 * rng.randn(1, 26, 32).astype(np.float32))
    sd['backbone.patch_embed.proj.weight'] = torch.from_numpy(
        rng.randn(32, 3, 14, 14).astype(np.float32) / 24)
    pth = str(tmp_path / 'regrid.pth')
    torch.save({'state_dict': {f'module.{k}': v for k, v in sd.items()}},
               pth)
    cfg = _small(make_config, out_channels=17)
    pm = init_pose_model(cfg, pth, device='cpu')
    x = _crops(7)
    with torch.no_grad():
        port = pm.model(torch.from_numpy(x)).numpy()
    jcfg = _small(jax_make_config, out_channels=17)
    jv = jckpt.convert_topdown_checkpoint(pth, jcfg)
    jm = JaxTopDown(jcfg)
    ref = _compile_fast(lambda v, x: jm.apply(v, x, train=False),
                        jax.tree.map(jnp.asarray, jv), jnp.asarray(x))
    np.testing.assert_allclose(port, np.asarray(ref), **HM_TOL)

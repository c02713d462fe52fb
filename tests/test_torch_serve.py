"""The port's deployment surface against the JAX package on the CPU: the
HTTP pose server (`vitpose_tpu_torch.tools.serve` against
tools/deployment/serve.py), drawing (`vis_pose_result`, `imshow_bboxes`,
the evaluation CLI's `--show-dir`, `vis_pose_tracking_result`), detector
boxes, the `outputs=` capture and the `dataset=` selector, tracking and
One-Euro smoothing.

Tolerances:
  * /predict equals a direct `inference_top_down_pose_model` call on the
    server's model exactly, and JAX's server on the same weights (the
    small peaked f32 model of tests/test_torch_models.py) within 1e-3 px
    and 1e-4 in score, as tests/test_torch_models.py holds the API.
  * int8 calibration inputs equal JAX's exactly; the scales within 1e-5
    relative, as tests/test_torch_int8.py holds them.
  * Drawings are pixel-equal; `outputs=` arrays within 1e-4 (f32); track
    ids equal; One-Euro output within 1e-6.
The servers bind 127.0.0.1 on port 0, serve from a daemon thread and shut
down in a `finally`; every request has a timeout.
"""
import base64
import contextlib
import copy
import http.client
import importlib.util
import json
import os
import threading
import warnings
from http.server import HTTPServer

import cv2
import numpy as np
import pytest

from vitpose_tpu.api import inference as japi
from vitpose_tpu.api import tracking as jtracking
from vitpose_tpu.data import DatasetInfo as JaxDatasetInfo
from vitpose_tpu.ops.smoothing import OneEuroFilter as JaxOneEuroFilter
from vitpose_tpu.utils import quantize as jq
from vitpose_tpu.utils.checkpoint import save_params_npz

from test_torch_data import write_coco_fixture
from test_torch_eval import _small_config
from test_torch_int8 import CompiledApply
from test_torch_models import TOL, _peaked, _random_variables, _small
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu_torch import api
from vitpose_tpu_torch.api import inference as papi
from vitpose_tpu_torch.api import tracking
from vitpose_tpu_torch.data import DatasetInfo
from vitpose_tpu_torch.eval.loop import run_validation
from vitpose_tpu_torch.ops.smoothing import OneEuroFilter
from vitpose_tpu_torch.tools import serve
from vitpose_tpu_torch.tools import test as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KP_TOL_PX = 1e-3
SCORE_TOL = 1e-4
SCALE_RTOL = 1e-5
TIMEOUT_S = 60


def _jax_serve_module():
    spec = importlib.util.spec_from_file_location(
        'jax_deployment_serve',
        os.path.join(ROOT, 'tools', 'deployment', 'serve.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jserve = _jax_serve_module()


@contextlib.contextmanager
def serving(server: HTTPServer):
    """Serve from a daemon thread; yields the bound port."""
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(TIMEOUT_S)
        assert not thread.is_alive()


def request(port, method, path, body=None):
    """(status, parsed json) of one request."""
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=TIMEOUT_S)
    try:
        data = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


IMG = np.random.RandomState(7).randint(0, 256, (90, 120, 3), np.uint8)
BOXES = [[10.0, 5.0, 40.0, 70.0, 0.9], [60.0, 20.0, 50.0, 60.0, 0.8]]


def _png(img_rgb):
    ok, buf = cv2.imencode('.png', img_rgb[..., ::-1])
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _direct(model, boxes):
    """What /predict should answer: the direct API call's results in the
    server's JSON form."""
    persons = [{'bbox': np.asarray(b, np.float32)} for b in boxes] or None
    results, _ = papi.inference_top_down_pose_model(model, IMG, persons)
    return [{'bbox': np.asarray(r['bbox']).tolist(),
             'keypoints': np.asarray(r['keypoints']).tolist()}
            for r in results]


@pytest.fixture(scope='module')
def weights(tmp_path_factory):
    """(small config file, .npz of peaked 17-joint variables)."""
    root = tmp_path_factory.mktemp('serve')
    v = _peaked(_random_variables(seed=31, out_channels=17))
    npz = str(root / 'small.npz')
    save_params_npz(npz, v)
    return _small_config(root), npz


@pytest.fixture(scope='module')
def jmodel(weights):
    """The JAX PoseModel of the same weights, as JAX's server builds it."""
    _, npz = weights
    model = japi.init_pose_model(_small(jax_make_config, out_channels=17),
                                 checkpoint=npz)
    model.dataset_info = JaxDatasetInfo.load('coco')
    return model


@pytest.fixture(scope='module')
def default_server(weights, jmodel):
    """The port's server in its default mode (f32) on the small config,
    and JAX's answers to /health and /predict on the same weights."""
    config, npz = weights
    jserver = HTTPServer(('127.0.0.1', 0), jserve.make_handler(jmodel))
    with serving(jserver) as port:
        ref = {'health': request(port, 'GET', '/health'),
               'predict': request(port, 'POST', '/predict',
                                  {'image': _png(IMG), 'bboxes': BOXES})}
    server = serve.build_server(['--config', config, '--checkpoint', npz,
                                 '--device', 'cpu', '--port', '0'])
    with serving(server) as port:
        yield server.pose_model, port, ref


def test_server_health_matches_jax(default_server):
    _, port, ref = default_server
    status, health = request(port, 'GET', '/health')
    assert status == ref['health'][0] == 200
    assert sorted(health) == sorted(ref['health'][1])
    assert health['model'] == 'vitpose_tpu_torch'
    assert {k: v for k, v in health.items() if k != 'model'} \
        == {k: v for k, v in ref['health'][1].items() if k != 'model'}
    assert health['input_size'] == [64, 48] and health['num_joints'] == 17


@pytest.mark.parametrize('boxes', [BOXES, []], ids=['2_boxes', 'no_boxes'])
def test_server_predict_equals_direct_call(default_server, boxes):
    model, port, _ = default_server
    status, out = request(port, 'POST', '/predict',
                          {'image': _png(IMG), 'bboxes': boxes})
    assert status == 200
    assert out['pose_results'] == _direct(model, boxes)
    assert len(out['pose_results']) == max(len(boxes), 1)


def test_server_predict_matches_jax(default_server):
    _, port, ref = default_server
    status, out = request(port, 'POST', '/predict',
                          {'image': _png(IMG), 'bboxes': BOXES})
    assert status == ref['predict'][0] == 200
    got, want = out['pose_results'], ref['predict'][1]['pose_results']
    assert [r['bbox'] for r in got] == [r['bbox'] for r in want]
    kp, kp_ref = (np.array([r['keypoints'] for r in res])
                  for res in (got, want))
    assert kp.shape == (2, 17, 3)
    assert np.abs(kp[..., :2] - kp_ref[..., :2]).max() <= KP_TOL_PX
    assert np.abs(kp[..., 2] - kp_ref[..., 2]).max() <= SCORE_TOL


BAD_REQUESTS = {
    'not_json': ('POST', '/predict', b'{not json', 400),
    'no_image': ('POST', '/predict', {'bboxes': BOXES}, 400),
    'not_an_image': ('POST', '/predict',
                     {'image': base64.b64encode(b'xyz').decode()}, 400),
    'get_unknown': ('GET', '/nope', None, 404),
    'post_unknown': ('POST', '/nope', {'image': ''}, 404),
}


@pytest.mark.parametrize('case', list(BAD_REQUESTS))
def test_server_rejects_bad_requests(default_server, case):
    _, port, _ = default_server
    method, path, body, code = BAD_REQUESTS[case]
    status, out = request(port, method, path, body)
    assert status == code and 'error' in out


@pytest.fixture(scope='module')
def jax_scales(jmodel):
    """JAX's scales from its own `_calibration_batches` on the small f32
    model, with attention: (fc1, fc2, qkv, proj) per block. Without
    attention JAX gives the first two of each (tests/test_torch_int8.py
    holds both forms)."""
    cal = jserve._calibration_batches(None, 64, 48)
    return jq.calibrate_act_scales(CompiledApply(jmodel.model),
                                   jmodel.variables, cal, attn=True)


@pytest.mark.parametrize('flags', [['--fast'], ['--int8'], ['--int8-qkv']],
                         ids=lambda f: f[0])
def test_server_modes(weights, jax_scales, flags):
    """--fast serves bf16 with K1 attention (its plain version here) and
    tanh GELU; --int8 quantises the MLP, --int8-qkv attention too, at the
    scales JAX's server calibrates on the same inputs."""
    config, npz = weights
    server = serve.build_server(['--config', config, '--checkpoint', npz,
                                 '--device', 'cpu', '--port', '0', *flags])
    model = server.pose_model
    bb = model.model.backbone.cfg
    if flags == ['--fast']:
        assert (bb.dtype, bb.fused_attention, bb.gelu_approx) \
            == ('bfloat16', True, True)
        assert not bb.int8_mlp
    else:
        qkv = flags == ['--int8-qkv']
        assert (bb.int8_mlp, bb.int8_qkv, bb.dtype) == (True, qkv, 'float32')
        np.testing.assert_allclose(
            bb.int8_act_scales, np.asarray(jax_scales)[:, :4 if qkv else 2],
            rtol=SCALE_RTOL)
        kinds = {type(b.attn.qkv).__name__
                 for b in model.model.backbone.blocks}
        assert kinds == {'Int8Linear' if qkv else 'Linear'}
    with serving(server) as port:
        status, out = request(port, 'POST', '/predict',
                              {'image': _png(IMG), 'bboxes': BOXES})
    assert status == 200
    assert out['pose_results'] == _direct(model, BOXES)
    assert np.isfinite(np.array([r['keypoints']
                                 for r in out['pose_results']])).all()


@pytest.mark.parametrize('source', ['synthetic', 'dir', 'empty_dir'])
def test_calibration_batches_match_jax(tmp_path, source):
    calib_dir = None
    if source != 'synthetic':
        calib_dir = str(tmp_path)
    if source == 'dir':
        rng = np.random.RandomState(3)
        for i, ext in enumerate(('jpg', 'png', 'jpeg')):
            cv2.imwrite(str(tmp_path / f'{i}.{ext}'),
                        rng.randint(0, 256, (50 + 10 * i, 40, 3), np.uint8))
    got = serve._calibration_batches(calib_dir, 64, 48)
    ref = jserve._calibration_batches(calib_dir, 64, 48)
    assert len(got) == len(ref) == (1 if source == 'dir' else 2)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_server_refuses_cnn_configs(tmp_path):
    path = tmp_path / 'res50.py'
    path.write_text("model = dict(backbone_type='resnet', depth=50)\n"
                    "data = dict(dataset='coco')\n")
    with pytest.raises(NotImplementedError, match='item 12'):
        serve.build_server(['--config', str(path), '--device', 'cpu'])


# --- drawing -----------------------------------------------------------------

def _poses(seed, n=3, k=17):
    rng = np.random.RandomState(seed)
    return [{'keypoints': np.concatenate(
        [rng.uniform(0, 110, (k, 1)), rng.uniform(0, 85, (k, 1)),
         rng.uniform(0, 1, (k, 1))], 1).astype(np.float32),
        'bbox': np.array([5, 5, 60, 80], np.float32) + 10 * i,
        'track_id': 3 * i} for i in range(n)]


@pytest.mark.parametrize('dataset', ['coco', 'mpii', 'horse10'])
def test_vis_pose_result_pixel_equal(tmp_path, dataset):
    poses = _poses(1, k=DatasetInfo.load(dataset).num_joints)
    path = str(tmp_path / 'img.png')
    cv2.imwrite(path, IMG[..., ::-1])
    for img in (IMG, path):
        for kw in (dict(), dict(kpt_score_thr=0.5, radius=2, thickness=3)):
            got = papi.vis_pose_result(
                None, img, poses, dataset_info=DatasetInfo.load(dataset),
                out_file=str(tmp_path / 'port.png'), **kw)
            ref = japi.vis_pose_result(
                None, img, poses, dataset_info=JaxDatasetInfo.load(dataset),
                out_file=str(tmp_path / 'jax.png'), **kw)
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(
                cv2.imread(str(tmp_path / 'port.png')),
                cv2.imread(str(tmp_path / 'jax.png')))
    assert (got != IMG[..., ::-1]).any()


def test_imshow_bboxes_and_tracking_drawing_pixel_equal():
    boxes = np.array([[5, 5, 60, 80], [30, 20, 100, 70]], np.float32)
    for kw in (dict(), dict(labels=['a', 'b'], colors=[(255, 0, 0),
                                                       (0, 0, 255)],
                            thickness=2)):
        np.testing.assert_array_equal(
            papi.imshow_bboxes(IMG, boxes, **kw),
            japi.imshow_bboxes(IMG, boxes, **kw))
    poses = _poses(2)
    np.testing.assert_array_equal(
        tracking.vis_pose_tracking_result(
            None, IMG, poses, dataset_info=DatasetInfo.load('coco')),
        jtracking.vis_pose_tracking_result(
            None, IMG, poses, dataset_info=JaxDatasetInfo.load('coco')))


def test_show_dir_matches_jax_drawing(weights, tmp_path):
    """`--show-dir` writes one image per val image, named as the JAX CLI
    names it, each file byte for byte JAX's `vis_pose_result` of the same
    predictions (JPEG, as the val images are)."""
    config, npz = weights
    coco = write_coco_fixture(str(tmp_path / 'coco'), seed=5)
    show = str(tmp_path / 'show')
    cli.main([config, npz, '--device', 'cpu', '--show-dir', show,
              '--cfg-options', f"data.val.ann_file={coco['ann']}",
              f"data.val.img_prefix={coco['prefix']}",
              f"data.val.bbox_file={coco['det']}"])
    model, ds, loader = cli.build_eval_objects(cli.apply_options(
        cli.load_config(config), [
            f"data.val.ann_file={coco['ann']}",
            f"data.val.img_prefix={coco['prefix']}",
            f"data.val.bbox_file={coco['det']}"]))
    cli.load_checkpoint(model, npz)
    results = run_validation(model.eval(), loader)
    by_img = {}
    for r in results:
        for kp, path in zip(r['preds'], r['image_paths']):
            by_img.setdefault(path, []).append(dict(keypoints=kp))
    assert sorted(os.listdir(show)) == sorted(
        os.path.basename(p) for p in by_img)
    assert len(by_img) == len({d['image_id'] for d in json.load(
        open(coco['det'])) if d['category_id'] == 1})
    for path, poses in by_img.items():
        name = os.path.basename(path)
        japi.vis_pose_result(None, path, poses,
                             dataset_info=JaxDatasetInfo.load('coco'),
                             out_file=str(tmp_path / name))
        with open(os.path.join(show, name), 'rb') as a, \
                open(tmp_path / name, 'rb') as b:
            assert a.read() == b.read(), name


# --- detector boxes, outputs= and dataset= ---------------------------------

def test_process_mmdet_results_matches_jax():
    rng = np.random.RandomState(4)
    per_class = [rng.rand(n, 5).astype(np.float32) for n in (3, 0, 2)]
    for det in (per_class, (per_class, [[None] * 3, [], [None] * 2])):
        for cat_id in (1, 2, 3):
            got = api.process_mmdet_results(det, cat_id)
            ref = japi.process_mmdet_results(det, cat_id)
            assert len(got) == len(ref)
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a['bbox'], b['bbox'])


OUTPUT_NAMES = ['backbone', 'head', 'blocks_1', 'last_norm', 'norm1', 'attn',
                'qkv', 'proj', 'norm2', 'mlp', 'fc1', 'fc2']


@pytest.fixture(scope='module')
def outputs_refs(weights, jmodel):
    _, npz = weights
    with pytest.warns(DeprecationWarning, match='dataset is deprecated'):
        ref = japi.inference_top_down_pose_model(
            jmodel, IMG, [{'bbox': b} for b in BOXES],
            dataset='TopDownOCHumanDataset', outputs=OUTPUT_NAMES)
    return npz, ref


def test_outputs_and_dataset_match_jax(outputs_refs):
    """`outputs=` captures the modules JAX names, under JAX's keys and
    layouts; the deprecated `dataset=` warns and picks the same metadata
    (OCHuman's flip pairs)."""
    npz, (ref_res, ref_out) = outputs_refs
    model = papi.init_pose_model(_small(papi.make_config, out_channels=17),
                                 checkpoint=npz, device='cpu')
    with pytest.warns(DeprecationWarning, match='dataset is deprecated'):
        res, out = papi.inference_top_down_pose_model(
            model, IMG, [{'bbox': b} for b in BOXES],
            dataset='TopDownOCHumanDataset', outputs=OUTPUT_NAMES)
    assert len(out) == len(ref_out) == 1
    assert sorted(out[0]) == sorted(ref_out[0])
    # backbone, head, blocks_1, last_norm; 8 in each block
    assert len(out[0]) == 4 + 8 * 2
    for k, ref in ref_out[0].items():
        assert out[0][k].shape == np.asarray(ref).shape, k
        np.testing.assert_allclose(out[0][k], np.asarray(ref), **TOL,
                                   err_msg=k)
    for a, b in zip(res, ref_res):
        np.testing.assert_allclose(a['keypoints'][:, :2],
                                   b['keypoints'][:, :2], rtol=0,
                                   atol=KP_TOL_PX)
    assert papi._DATASET_CLASS_TO_NAME == japi._DATASET_CLASS_TO_NAME
    with pytest.raises(ValueError, match='patch_embed'):
        papi.inference_top_down_pose_model(model, IMG, outputs=['final'])
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        papi.inference_top_down_pose_model(
            model, IMG, dataset='TopDownCocoDataset',
            dataset_info=DatasetInfo.load('coco'))


# --- tracking and smoothing -------------------------------------------------

def _frames(seed, n_frames=5):
    """Per frame, pose results of people who drift: one leaves after frame
    2, another enters at frame 3, and in frame 1 a newcomer far from the
    others has too few labelled keypoints to start a track."""
    rng = np.random.RandomState(seed)
    starts = np.concatenate([rng.uniform(20, 300, (4, 2)), [[600, 450]]])
    frames = []
    for f in range(n_frames):
        people = []
        for p in range(5):
            if (p == 2 and f > 2) or (p == 3 and f < 3) or (p == 4
                                                            and f != 1):
                continue
            c = starts[p] + f * rng.uniform(-6, 6, 2)
            kp = np.concatenate([c + rng.normal(0, 15, (17, 2)),
                                 rng.uniform(0.2, 1, (17, 1))], 1)
            if p == 4:
                kp[3:, 1] = 0.0
            box = np.concatenate([kp[:, :2].min(0), kp[:, :2].max(0)])
            people.append({'bbox': box.astype(np.float32),
                           'keypoints': kp.astype(np.float32)})
        frames.append(people)
    return frames


def _track(get_track_id, frames, **kw):
    frames = copy.deepcopy(frames)
    last, next_id, out = [], 0, []
    for people in frames:
        people, next_id = get_track_id(people, last, next_id, **kw)
        out.append(people)
        last = [{k: v for k, v in p.items()} for p in people]
    return out, next_id


TRACK_CASES = {'iou': dict(), 'oks': dict(use_oks=True),
               'oks_one_euro': dict(use_oks=True, use_one_euro=True,
                                    fps=30),
               'iou_xywh': dict(bbox_format='xywh', tracking_thr=0.5)}


@pytest.mark.parametrize('case', list(TRACK_CASES))
def test_get_track_id_matches_jax(case):
    frames = _frames(6)
    if case == 'iou_xywh':
        for people in frames:
            for p in people:
                p['bbox'][2:] -= p['bbox'][:2]
    got, got_next = _track(api.get_track_id, frames, **TRACK_CASES[case])
    ref, ref_next = _track(jtracking.get_track_id, frames,
                           **TRACK_CASES[case])
    assert got_next == ref_next
    ids = [[p['track_id'] for p in people] for people in got]
    assert ids == [[p['track_id'] for p in people] for people in ref]
    assert -1 in ids[1] and len(set(sum(ids, [])) - {-1}) >= 4
    for gp, rp in zip(got, ref):
        for a, b in zip(gp, rp):
            np.testing.assert_allclose(a['keypoints'], b['keypoints'],
                                       rtol=0, atol=1e-6)
            np.testing.assert_array_equal(a['bbox'], b['bbox'])
            assert a['area'] == b['area']


def test_one_euro_filter_matches_jax():
    rng = np.random.RandomState(8)
    x0 = rng.uniform(1, 100, (17, 2)).astype(np.float32)
    port, ref = OneEuroFilter(x0, fps=25), JaxOneEuroFilter(x0, fps=25)
    for t in range(6):
        x = x0 + rng.normal(0, 3, x0.shape).astype(np.float32) * (t + 1)
        x[t, 0] = -1.0                          # a missing keypoint
        a, b = port(x), ref(x)
        assert a.shape == (17, 2)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert a[t, 0] == -10.0


def test_api_exports_the_top_down_surface():
    assert set(api.__all__) == {
        'init_pose_model', 'inference_top_down_pose_model',
        'vis_pose_result', 'process_mmdet_results', 'get_track_id',
        'vis_pose_tracking_result', 'run_validation', 'train_model',
        'init_random_seed'}
    assert all(callable(getattr(api, n)) for n in api.__all__)

"""The port's webcam framework (`vitpose_tpu_torch.webcam`, the node graph
of vitpose_tpu/webcam/), its single-chain runners
(`vitpose_tpu_torch.api.webcam`) and `tools/run_webcam.py` on the CPU: the
counterparts of every test in tests/test_webcam_framework.py and
tests/test_webcam_runner.py, and the checks across packages.

Tolerances: effect nodes fed the same frame and pose results draw frames
byte-equal to JAX's; `TopDownPoseEstimatorNode` on the same weights (the
small peaked f32 model of tests/test_torch_models.py) gives JAX's keypoints
within 1e-3 px and 1e-4 in score, as tests/test_torch_serve.py holds the
API. Every config under tools/webcam/configs/ builds against the port's
registry. The runs are headless (show=False) and bounded (max_frames).
"""
import glob
import inspect
import os
import tempfile
import threading
import time
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

import vitpose_tpu.webcam as jwebcam
from vitpose_tpu.data.dataset_info import DatasetInfo as JaxDatasetInfo
from vitpose_tpu.models import make_config as jax_make_config
from vitpose_tpu.utils.checkpoint import save_params_npz
from vitpose_tpu.webcam import model_nodes as jmodel_nodes

from test_torch_models import _peaked, _random_variables, _small
from test_webcam_framework import _person_kpts, _write_frames
from vitpose_tpu_torch.api import webcam as api_webcam
from vitpose_tpu_torch.data.dataset_info import DatasetInfo
from vitpose_tpu_torch.models import make_config
from vitpose_tpu_torch.tools import run_webcam
from vitpose_tpu_torch.utils.config import load_config
from vitpose_tpu_torch.webcam import (NODES, Buffer, BufferManager,
                                      EventManager, FrameMessage,
                                      WebcamRunner)
from vitpose_tpu_torch.webcam.model_nodes import (DetectorNode,
                                                  TopDownPoseEstimatorNode)
from vitpose_tpu_torch.webcam.node import Node
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APP_CONFIGS = sorted(glob.glob(os.path.join(ROOT, 'tools', 'webcam',
                                            'configs', '*', '*.py')))
KP_TOL_PX = 1e-3
SCORE_TOL = 1e-4

PORT = types.SimpleNamespace(NODES=NODES, FrameMessage=FrameMessage,
                             info=lambda: DatasetInfo.load('coco'))
JAX = types.SimpleNamespace(NODES=jwebcam.NODES,
                            FrameMessage=jwebcam.FrameMessage,
                            info=lambda: JaxDatasetInfo.load('coco'))


# --- primitives -----------------------------------------------------------

def test_buffer_put_force_drops_oldest():
    buf = Buffer(maxsize=2)
    for i in range(4):
        buf.put_force(i)
    assert buf.get() == 2 and buf.get() == 3


def test_buffer_manager_sub_manager_is_a_view():
    mgr = BufferManager()
    mgr.register_buffer('a', 1)
    mgr.register_buffer('b', 1)
    sub = mgr.get_sub_manager(['a'])
    sub.put('a', 'x')
    assert mgr.get('a') == 'x'
    with pytest.raises(ValueError):
        sub.put('b', 'y')
    with pytest.raises(ValueError):
        mgr.register_buffer('a', 1)


def test_event_manager_keyboard_namespace():
    ev = EventManager()
    ev.register_event('s', is_keyboard=True)
    ev.set('s', is_keyboard=True)
    assert not ev.is_set('s')
    assert ev.is_set('s', is_keyboard=True)
    assert ev.is_set(ord('s'), is_keyboard=True)
    with ev.wait_and_handle('s', is_keyboard=True, timeout=0.1) as fired:
        assert fired
    assert not ev.is_set('s', is_keyboard=True)


def test_frame_message_tagged_results_and_route_merge():
    msg = FrameMessage(np.zeros((4, 4, 3), np.uint8))
    msg.add_pose_result({'preds': [1]}, tag='human')
    msg.add_pose_result({'preds': [2]}, tag='animal')
    assert len(msg.get_pose_results()) == 2
    assert msg.get_pose_results(tag='animal') == [{'preds': [2]}]
    assert msg.get_detection_results() is None
    msg.update_route_info(node_name='a', node_type='A',
                          info={'timestamp': 2.0})
    other = FrameMessage(np.zeros((4, 4, 3), np.uint8))
    other.update_route_info(node_name='b', node_type='B',
                            info={'timestamp': 1.0})
    msg.merge_route_info(other.get_route_info())
    assert [e['node'] for e in msg.get_route_info()] == ['a', 'b']
    msg2 = FrameMessage(np.zeros((4, 4, 3), np.uint8))
    msg2.set_full_results(msg.get_full_results())
    assert len(msg2.get_pose_results()) == 2


def test_node_registry_build_and_unknown():
    node = NODES.build(dict(type='NoticeBoardNode', name='n',
                            frame_buffer='f', output_buffer='o',
                            content_lines=['hi']))
    assert node.name == 'n'
    with pytest.raises(KeyError):
        NODES.build(dict(type='NoSuchNode'))


def test_enable_key_requires_bypass():
    class NoBypass(Node):
        def process(self, input_msgs):
            return None

    with pytest.raises(NotImplementedError):
        NoBypass(name='x', enable_key='z')


# --- effect nodes -----------------------------------------------------------

def _pose_frame_msg(pkg, n_persons=1, h=128, w=96):
    """tests/test_webcam_framework.py `_pose_frame_msg` in package `pkg`."""
    gx = np.linspace(40, 200, w, dtype=np.uint8)
    gy = np.linspace(40, 200, h, dtype=np.uint8)
    img = np.stack([np.tile(gx, (h, 1)), np.tile(gy[:, None], (1, w)),
                    np.full((h, w), 120, np.uint8)], axis=-1)
    msg = pkg.FrameMessage(img)
    box = np.array([5, 5, w - 5, h - 5, 0.9], np.float32)
    preds = [{'keypoints': _person_kpts(cx=(i + 1) * w // (n_persons + 1)),
              'bbox': box.copy(), 'track_id': i, 'label': 'person'}
             for i in range(n_persons)]
    msg.add_pose_result({'preds': preds, 'dataset_info': pkg.info()},
                        tag='pose')
    msg.add_detection_result({'preds': [{'cls_id': 0, 'label': 'person',
                                         'mask': None, 'bbox': box.copy()}]},
                             tag='det')
    return msg


def _cfg(kind, **kw):
    return dict(type=kind, name=kind.lower(), frame_buffer='f',
                output_buffer='o', **kw)


DRAWING_NODES = ['PoseVisualizerNode', 'SunglassesNode', 'BugEyeNode',
                 'MoustacheNode', 'HatNode', 'FirecrackerNode',
                 'NoticeBoardNode', 'SaiyanNode', 'BackgroundNode',
                 'SpriteNode']


@pytest.mark.parametrize('kind', DRAWING_NODES)
def test_effect_nodes_draw(kind):
    node = NODES.build(_cfg(kind))
    msg = _pose_frame_msg(PORT)
    before = msg.get_image().copy()
    out = node.draw(msg)
    assert out.shape == before.shape and out.dtype == np.uint8
    assert np.any(out != before), f'{kind} drew nothing'


# (node config, persons, frames drawn): every node of effect_nodes.py
SAME_AS_JAX = {kind: (_cfg(kind), 1, 1) for kind in DRAWING_NODES}
SAME_AS_JAX.update({
    'FaceSwapNode': (_cfg('FaceSwapNode', mode_key='x'), 2, 1),
    'ValentineMagicNode': (_cfg('ValentineMagicNode'), 1, 3),
    'XDwenDwenNode': (_cfg('XDwenDwenNode', mode_key='x',
                           out_shape=(120, 120)), 1, 1),
})


@pytest.mark.parametrize('kind', sorted(SAME_AS_JAX))
def test_effect_node_draws_what_jax_draws(kind):
    """The same frame and pose results through the port's node and JAX's
    give byte-equal frames (the valentine heart over 3 frames, with both
    wrists raised above the nose)."""
    cfg, persons, frames = SAME_AS_JAX[kind]
    outs = []
    for pkg in (PORT, JAX):
        node = pkg.NODES.build(dict(cfg))
        msg = _pose_frame_msg(pkg, n_persons=persons, h=160, w=192)
        kpts = msg.get_pose_results()[0]['preds'][0]['keypoints']
        kpts[9], kpts[10] = [96, 20, 1.0], [98, 20, 1.0]
        for _ in range(frames):
            out = node.draw(msg)
        outs.append(out)
    assert outs[0].dtype == outs[1].dtype == np.uint8
    np.testing.assert_array_equal(outs[0], outs[1])


def test_effect_nodes_no_pose_is_noop():
    node = NODES.build(_cfg('SunglassesNode'))
    img = np.full((64, 48, 3), 50, np.uint8)
    np.testing.assert_array_equal(node.draw(FrameMessage(img.copy())), img)


def test_faceswap_swaps_between_two_people():
    from vitpose_tpu_torch.webcam.effect_nodes import FaceSwapMode
    node = NODES.build(_cfg('FaceSwapNode', mode_key='x'))
    msg = _pose_frame_msg(PORT, n_persons=2, h=160, w=192)
    img = msg.get_image()
    img[20:60, 40:90] = (0, 0, 200)
    img[20:60, 100:150] = (0, 200, 0)
    out = node.draw(msg)
    assert out.shape == img.shape and np.any(out != img)
    node.switch_mode()
    node.switch_mode()
    assert node.mode == FaceSwapMode.NONE
    np.testing.assert_array_equal(node.draw(msg), msg.get_image())


def test_valentine_heart_on_wrist_gesture():
    node = NODES.build(_cfg('ValentineMagicNode'))
    msg = _pose_frame_msg(PORT)
    kpts = msg.get_pose_results()[0]['preds'][0]['keypoints']
    kpts[9], kpts[10] = [48, 20, 1.0], [50, 20, 1.0]
    before = msg.get_image().copy()
    for _ in range(3):
        out = node.draw(msg)
    assert np.any(out != before)


def test_xdwendwen_outputs_template_canvas():
    node = NODES.build(_cfg('XDwenDwenNode', mode_key='x',
                            out_shape=(120, 120)))
    assert node.draw(_pose_frame_msg(PORT)).shape == (120, 120, 3)
    node.switch_mode()
    assert node.mode_index == 0


def test_monitor_node_overlays_route_info():
    node = NODES.build(_cfg('MonitorNode', enable=True))
    msg = _pose_frame_msg(PORT)
    msg.update_route_info(node_name='up', node_type='Up',
                          info={'fps': 12.5})
    before = msg.get_image().copy()
    assert np.any(node.process({'frame': msg}).get_image() != before)


class _FakeRunner:
    def __init__(self, synchronous):
        self.synchronous = synchronous
        self.buffer_manager = BufferManager()
        for b in ('r', 'f', 'o'):
            self.buffer_manager.register_buffer(b, 1)
        self.event_manager = EventManager()


@pytest.mark.parametrize('synchronous', [False, True],
                         ids=['async', 'sync'])
def test_model_result_binding_async_and_sync(synchronous):
    """Async: every frame goes out with the latest result; sync: the
    result's own frame goes out."""
    from vitpose_tpu_torch.webcam.helper_nodes import ModelResultBindingNode
    node = ModelResultBindingNode('bind', frame_buffer='f',
                                  result_buffer='r', output_buffer='o')
    node.set_runner(_FakeRunner(synchronous))
    result_msg = _pose_frame_msg(PORT)
    if synchronous:
        assert [b.essential for b in node._input_buffers] == [True, False]
        assert node.process({'result': result_msg, 'frame': None}) \
            is result_msg
        return
    assert [b.essential for b in node._input_buffers] == [False, True]
    frame_msg = FrameMessage(np.zeros((8, 8, 3), np.uint8))
    out = node.process({'result': result_msg, 'frame': frame_msg})
    assert out is frame_msg and len(out.get_pose_results()) == 1
    frame2 = FrameMessage(np.zeros((8, 8, 3), np.uint8))
    out2 = node.process({'result': None, 'frame': frame2})
    assert len(out2.get_pose_results()) == 1


# --- the config-driven runner, headless ----------------------------------

class _StubPoseNode(Node):
    """Stands in for TopDownPoseEstimatorNode: tags a fixed pose result."""

    def __init__(self, name, input_buffer, output_buffer):
        super().__init__(name=name, enable=True)
        self.register_input_buffer(input_buffer, 'input', essential=True)
        self.register_output_buffer(output_buffer)

    def process(self, input_msgs):
        msg = input_msgs['input']
        h, w = msg.get_image().shape[:2]
        msg.add_pose_result(
            {'preds': [{'keypoints': _person_kpts(cx=w // 2, cy=h // 3),
                        'bbox': np.array([2, 2, w - 2, h - 2, 0.9],
                                         np.float32)}],
             'dataset_info': DatasetInfo.load('coco')}, tag=self.name)
        return msg


def test_runner_headless_graph(tmp_path):
    src = _write_frames(tmp_path / 'imgs', n=30)
    out_video = str(tmp_path / 'rec.avi')
    displayed = []
    runner = WebcamRunner(
        name='test app', camera_id=src, camera_fps=120, show=False,
        max_frames=6,
        on_display=lambda img, msg: displayed.append(img.shape),
        nodes=[
            _StubPoseNode('pose', input_buffer='_input_',
                          output_buffer='pose'),
            dict(type='ModelResultBindingNode', name='binder',
                 frame_buffer='_frame_', result_buffer='pose',
                 output_buffer='frame'),
            dict(type='PoseVisualizerNode', name='vis', enable_key='v',
                 frame_buffer='frame', output_buffer='vis'),
            dict(type='SunglassesNode', name='sunglasses', enable_key='s',
                 enable=False, frame_buffer='vis', output_buffer='vis2'),
            dict(type='MonitorNode', name='monitor', enable_key='m',
                 enable=True, frame_buffer='vis2', output_buffer='disp'),
            dict(type='RecorderNode', name='recorder',
                 out_video_file=out_video, out_video_codec='MJPG',
                 frame_buffer='disp', output_buffer='_display_'),
        ])
    assert runner.run() == 6 and len(displayed) == 6
    assert displayed[0] == (64, 48, 3)
    assert os.path.getsize(out_video) > 0
    for b in ('pose', 'frame', 'vis', 'vis2', 'disp'):
        assert b in runner.buffer_manager


def test_runner_video_ending_terminates():
    with tempfile.TemporaryDirectory() as d:
        _write_frames(d, n=3)
        runner = WebcamRunner(
            camera_id=d, camera_fps=200, show=False,
            nodes=[dict(type='MonitorNode', name='mon', enable=True,
                        frame_buffer='_frame_', output_buffer='_display_')])
        t0 = time.time()
        assert runner.run() <= 3
        assert time.time() - t0 < 30
        assert runner.event_manager.is_set('_exit_')


def test_runner_hotkey_toggles_node(tmp_path):
    """A key injected while the app runs (30 frames at the node's 30 fps,
    about a second) toggles the node."""
    _write_frames(tmp_path, n=60, h=32, w=32)
    notice = NODES.build(dict(type='NoticeBoardNode', name='notice',
                              enable_key='h', enable=False,
                              frame_buffer='_frame_',
                              output_buffer='_display_'))
    runner = WebcamRunner(camera_id=str(tmp_path), camera_fps=500,
                          show=False, max_frames=30, nodes=[notice])

    def poke():
        time.sleep(0.3)
        runner.inject_key('h')

    th = threading.Thread(target=poke)
    th.start()
    runner.run()
    th.join(10)
    assert not th.is_alive()
    assert notice._enabled, 'hot-key did not toggle the node'


def test_runner_synchronous_mode(tmp_path):
    img_file = str(tmp_path / 'cam.jpg')
    cv2.imwrite(img_file, np.full((48, 64, 3), 90, np.uint8))
    runner = WebcamRunner(
        camera_id=img_file, synchronous=True, show=False, max_frames=4,
        nodes=[
            _StubPoseNode('pose', input_buffer='_input_',
                          output_buffer='pose'),
            dict(type='ModelResultBindingNode', name='binder',
                 frame_buffer='_frame_', result_buffer='pose',
                 output_buffer='frame'),
            dict(type='PoseVisualizerNode', name='vis',
                 frame_buffer='frame', output_buffer='_display_'),
        ])
    assert runner.run() == 4


def test_detector_node_whole_frame_fallback():
    node = DetectorNode('det', input_buffer='_input_', output_buffer='o',
                        detector=None)
    out = node.process({'input': FrameMessage(np.zeros((40, 30, 3),
                                                       np.uint8))})
    preds = out.get_detection_results(tag='det')[0]['preds']
    assert preds[0]['label'] == 'person'
    np.testing.assert_allclose(preds[0]['bbox'][:4], [0, 0, 30, 40])


@pytest.fixture(scope='module')
def pose_weights(tmp_path_factory):
    """.npz of the small peaked 17-joint variables."""
    npz = str(tmp_path_factory.mktemp('webcam') / 'small.npz')
    save_params_npz(npz, _peaked(_random_variables(seed=41,
                                                   out_channels=17)))
    return npz


def _pose_nodes(npz, device='cpu'):
    det = DetectorNode('det', input_buffer='_input_', output_buffer='det',
                       detector=None)
    pose = TopDownPoseEstimatorNode(
        'pose', model_config=_small(make_config, out_channels=17),
        model_checkpoint=npz, cls_names=['person'], input_buffer='det',
        output_buffer='pose', device=device)
    return det, pose


def test_pose_estimator_node_end_to_end(pose_weights, tmp_path):
    """The real node (small ViT, on the CPU) inside a headless synchronous
    runner: detector -> pose -> binder -> visualizer."""
    det_node, pose_node = _pose_nodes(pose_weights)
    # one frame on this thread first, so that a fault raises here rather
    # than ending the node's thread
    warm = FrameMessage(np.zeros((64, 48, 3), np.uint8))
    pose_node.process({'input': det_node.process({'input': warm})})
    img_file = str(tmp_path / 'cam.jpg')
    cv2.imwrite(img_file, np.full((64, 48, 3), 90, np.uint8))
    shown = []
    runner = WebcamRunner(
        camera_id=img_file, synchronous=True, show=False, max_frames=3,
        on_display=lambda img, msg: shown.append(msg),
        nodes=[
            det_node, pose_node,
            dict(type='ModelResultBindingNode', name='binder',
                 frame_buffer='_frame_', result_buffer='pose',
                 output_buffer='frame'),
            dict(type='PoseVisualizerNode', name='vis',
                 frame_buffer='frame', output_buffer='_display_'),
        ])
    assert runner.run() == 3
    poses = [m.get_pose_results() for m in shown if m.get_pose_results()]
    assert poses, 'no pose results reached the display chain'
    preds = poses[-1][0]['preds']
    assert preds and preds[0]['keypoints'].shape == (17, 3)
    assert 'track_id' in preds[0]


def _jax_infer_at_level_0(pm, nb, img_shape):
    """Put JAX's infer function for `nb` boxes, compiled at XLA CPU
    optimisation level 0, in the PoseModel's cache, where
    inference_top_down_pose_model looks it up."""
    fi = tuple(int(i) for i in pm.dataset_info.flip_index)
    fn = pm.infer_fn(nb, flip_index=fi)
    args = (pm.variables, jnp.zeros((nb,) + img_shape, jnp.uint8),
            jnp.zeros((nb, 2), jnp.float32), jnp.zeros((nb, 2), jnp.float32))
    pm._jitted[(nb, False, fi)] = fn.lower(*args).compile(
        compiler_options={'xla_backend_optimization_level': 0})


def test_pose_estimator_node_matches_jax(pose_weights):
    """The port's node and JAX's on the same weights, frame and two
    detector boxes: the same boxes, track ids and keypoints."""
    h, w = 90, 120
    img = np.random.RandomState(42).randint(0, 256, (h, w, 3), np.uint8)
    boxes = [np.array([10, 5, 50, 75, 0.9], np.float32),
             np.array([60, 20, 110, 80, 0.8], np.float32)]
    _, pose = _pose_nodes(pose_weights)
    jpose = jmodel_nodes.TopDownPoseEstimatorNode(
        'pose', model_config=_small(jax_make_config, out_channels=17),
        model_checkpoint=pose_weights, cls_names=['person'],
        input_buffer='det', output_buffer='pose', device='cpu')
    _jax_infer_at_level_0(jpose.model, 2, (h, w, 3))
    outs = []
    for pkg, node in ((PORT, pose), (JAX, jpose)):
        msg = pkg.FrameMessage(img.copy())
        msg.add_detection_result({'preds': [
            {'cls_id': 0, 'label': 'person', 'bbox': b.copy(), 'mask': None}
            for b in boxes]}, tag='det')
        outs.append(node.process({'input': msg})
                    .get_pose_results(tag='pose')[0]['preds'])
    got, want = outs
    assert [p['track_id'] for p in got] == [p['track_id'] for p in want]
    for g, r in zip(got, want):
        np.testing.assert_array_equal(g['bbox'], r['bbox'])
        assert np.abs(g['keypoints'][:, :2]
                      - r['keypoints'][:, :2]).max() <= KP_TOL_PX
        assert np.abs(g['keypoints'][:, 2]
                      - r['keypoints'][:, 2]).max() <= SCORE_TOL


@pytest.mark.parametrize('path', APP_CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_webcam_app_config_loads_and_names_known_nodes(path):
    """Every shipped app config loads through the port's config loader and
    names only nodes of the port's registry, with arguments they take."""
    cfg = load_config(path)['runner']
    assert cfg['nodes'], path
    for node_cfg in cfg['nodes']:
        sig = inspect.signature(NODES.get(node_cfg['type']).__init__)
        for k in node_cfg:
            assert k == 'type' or k in sig.parameters, \
                f'{node_cfg["type"]} has no arg {k!r}'


def test_port_registry_holds_every_jax_node():
    assert sorted(NODES._modules) == sorted(jwebcam.NODES._modules)
    assert len(APP_CONFIGS) >= 8


def test_run_webcam_cli_runs_the_example_app(tmp_path, monkeypatch):
    """tools/run_webcam.py on the shipped example (ViT-S pose node, f32 on
    the CPU), camera, display and frame count set by --cfg-options."""
    src = _write_frames(tmp_path / 'imgs', n=20, h=96, w=72)
    monkeypatch.chdir(tmp_path)          # the recorder's record.mp4
    runner = run_webcam.main([
        '--cfg-options', f'runner.camera_id={src}', 'runner.show=False',
        'runner.max_frames=3', '--device', 'cpu'])
    assert runner.frame_count == 3
    pose = [n for n in runner.node_list
            if isinstance(n, TopDownPoseEstimatorNode)]
    assert pose and pose[0].model.device.type == 'cpu'


def test_run_webcam_device_defaults_to_cuda():
    args = run_webcam.parse_args([])
    assert args.device == 'cuda'
    assert args.config.endswith(os.path.join('examples',
                                             'pose_estimation.py'))
    nodes = run_webcam.runner_config(args)['nodes']
    assert [n['device'] for n in nodes
            if n['type'] == 'TopDownPoseEstimatorNode'] == ['cuda']


# --- the single-chain runners (api/webcam.py) -------------------------------

class _CountNode:
    def __init__(self, delay=0.0, key='n'):
        self.delay = delay
        self.key = key
        self.name = f'count_{key}'
        self.count = 0

    def process(self, msg):
        if self.delay:
            time.sleep(self.delay)
        self.count += 1
        msg[self.key] = self.count
        return msg


def _frames(n, h=32, w=32):
    return [np.full((h, w, 3), i, np.uint8) for i in range(n)]


def test_sync_runner_processes_every_frame():
    node = _CountNode()
    assert api_webcam.WebcamRunner(iter(_frames(5)), [node]).run() == 5
    assert node.count == 5


def test_latest_buffer_overwrites():
    b = api_webcam.LatestBuffer()
    b.put(1)
    b.put(2)
    assert b.get(timeout=0.1) == 2
    assert b.get(timeout=0.05) is None


def test_async_runner_display_keeps_source_rate():
    slow = _CountNode(delay=0.08, key='inferred')
    disp = _CountNode(key='shown')

    def source():
        for f in _frames(12):
            time.sleep(0.01)
            yield f

    r = api_webcam.AsyncWebcamRunner(source(), [slow], [disp])
    assert r.run() == 12 and disp.count == 12
    assert 1 <= r.inference_count < 12


def test_async_runner_propagates_results_to_display():
    class Tagger(_CountNode):
        def process(self, msg):
            msg = super().process(msg)
            msg['pose_results'] = [{'id': msg['frame_id']}]
            return msg

    seen = []

    class Capture:
        name = 'capture'

        def process(self, msg):
            seen.append(msg.get('pose_results'))
            return msg

    def source():
        for f in _frames(10):
            time.sleep(0.02)
            yield f

    api_webcam.AsyncWebcamRunner(source(), [Tagger()], [Capture()]).run()
    assert any(seen)
    assert all(seen[-3:]), 'latest results should reach the display loop'

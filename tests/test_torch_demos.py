"""The port's top-down demos (`vitpose_tpu_torch.demo`, the counterparts of
the root demo/ scripts) on the CPU: each `main` runs once on a synthetic
2-person image or a 6-frame video and writes its output.

The six demos that take a config file through `--variant` get the small
model of tests/test_torch_models.py as a config file (f32, K1 on: the op
runs its plain kernel on the CPU); the face demos wrap the variant in a
dict, so they run their default ViT-S, in f32, as in JAX.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from test_torch_models import SMALL
from vitpose_tpu_torch.demo import (face_img_demo, face_video_demo,
                                    top_down_img_demo,
                                    top_down_img_demo_with_det,
                                    top_down_pose_tracking_demo,
                                    top_down_video_demo,
                                    top_down_video_demo_with_det,
                                    webcam_demo)
from test_torch_threads import torch_test_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOXES = [[10, 20, 60, 110], [90, 15, 55, 120]]      # xywh, two people
FRAMES = 6


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """The demos' models on one intra-op thread: the face demos run the
    full ViT-S, which on a CPU shared with other test workers loses more
    to thread contention than it gains from threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
    """A 2-person image with its COCO json and detection jsons, a 6-frame
    MJPG video with per-frame boxes, and the small model's config file."""
    root = tmp_path_factory.mktemp('demos')
    rng = np.random.RandomState(0)
    img = rng.randint(0, 60, (144, 160, 3), np.uint8)
    for x, y, w, h in BOXES:
        img[y + h // 3:y + h // 3 + 12, x + w // 2 - 6:x + w // 2 + 6] = 255
    paths = {'img': str(root / 'people.jpg'), 'video': str(root / 'v.avi')}
    cv2.imwrite(paths['img'], img)
    writer = cv2.VideoWriter(paths['video'], cv2.VideoWriter_fourcc(*'MJPG'),
                             10, (160, 144))
    assert writer.isOpened()
    for i in range(FRAMES):
        writer.write(np.roll(img, 2 * i, axis=1))
    writer.release()
    docs = {
        'ann': {'images': [{'id': 1, 'file_name': 'people.jpg'}],
                'annotations': [{'image_id': 1, 'bbox': b} for b in BOXES]},
        'det': [{'image_id': 1, 'category_id': 1, 'bbox': b, 'score': 0.9}
                for b in BOXES],
        'frames': {str(i): [b + [0.9] for b in BOXES]
                   for i in range(FRAMES)}}
    for name, doc in docs.items():
        paths[name] = str(root / f'{name}.json')
        with open(paths[name], 'w') as f:
            json.dump(doc, f)
    paths['config'] = str(root / 'small.py')
    with open(paths['config'], 'w') as f:
        f.write(
            "_base_ = ['" + ROOT + "/vitpose_tpu/configs/base/coco_data.py']\n"
            "model = dict(variant='b', img_size=(64, 48), out_channels=17,\n"
            "             deconv_filters=(16, 16),\n"
            "             backbone_overrides=dict(fused_attention=True, "
            + ', '.join(f'{k}={v}' for k, v in SMALL.items()) + '))\n')
    return paths


def _frames(path):
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


IMAGE_DEMOS = {
    'top_down_img_demo': (top_down_img_demo, ['--json-file', 'ann'],
                          'vis_people.jpg'),
    'top_down_img_demo_with_det': (top_down_img_demo_with_det,
                                   ['--det-json', 'det', '--image-id', '1'],
                                   'vis_det_people.jpg'),
}


@pytest.mark.parametrize('name', sorted(IMAGE_DEMOS))
def test_image_demo_writes_its_drawing(name, inputs, tmp_path):
    module, extra, out_name = IMAGE_DEMOS[name]
    args = [inputs['img'], '--variant', inputs['config'], '--out-img-root',
            str(tmp_path), '--device', 'cpu']
    args += [inputs.get(a, a) for a in extra]
    results, out = module.main(args)
    assert out == str(tmp_path / out_name)
    assert len(results) == 2
    assert all(r['keypoints'].shape == (17, 3)
               and np.isfinite(r['keypoints']).all() for r in results)
    assert cv2.imread(out).shape == (144, 160, 3)


VIDEO_DEMOS = {
    'top_down_video_demo': (top_down_video_demo, [], 'vis_v.avi'),
    'top_down_video_demo_with_det': (top_down_video_demo_with_det,
                                     ['--det-json', 'frames'],
                                     'vis_det_v.avi'),
    'top_down_pose_tracking_demo': (top_down_pose_tracking_demo,
                                    ['--det-json', 'frames'],
                                    'track_v.avi'),
}


@pytest.mark.parametrize('name', sorted(VIDEO_DEMOS))
def test_video_demo_writes_every_frame(name, inputs, tmp_path):
    module, extra, out_name = VIDEO_DEMOS[name]
    args = [inputs['video'], '--variant', inputs['config'],
            '--out-video-root', str(tmp_path), '--device', 'cpu']
    args += [inputs.get(a, a) for a in extra]
    n, out = module.main(args)
    assert n == FRAMES and out == str(tmp_path / out_name)
    assert _frames(out) == FRAMES


def test_face_img_demo(inputs, tmp_path):
    results, out = face_img_demo.main([
        inputs['img'], '--face-box', '40,30,80,90', '--out-img-root',
        str(tmp_path), '--device', 'cpu'])
    assert out == str(tmp_path / 'vis_face_people.jpg')
    assert len(results) == 1 and results[0]['keypoints'].shape == (68, 3)
    assert os.path.isfile(out)


def test_face_video_demo(inputs, tmp_path):
    n, out = face_video_demo.main([
        inputs['video'], '--out-video-root', str(tmp_path), '--device',
        'cpu'])
    assert n == FRAMES and out == str(tmp_path / 'face_v.avi')
    assert _frames(out) == FRAMES


@pytest.mark.parametrize('mode', ['--sync', '--async'])
def test_webcam_demo_writes_the_video(mode, inputs, tmp_path):
    out = str(tmp_path / 'webcam.avi')
    n, sink = webcam_demo.main([
        '--input', inputs['video'], '--variant', inputs['config'], '--out',
        out, '--device', 'cpu', mode])
    assert n == FRAMES and sink.frames_written == FRAMES
    assert _frames(out) == FRAMES


def test_demos_default_to_cuda(inputs, monkeypatch):
    """Without CUDA, the default device raises, as in the other CLIs."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        top_down_img_demo.main([inputs['img']])

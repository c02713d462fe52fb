"""Realtime pose pipeline: a small node-graph runner.

Counterpart of vitpose_tpu/api/webcam.py (the reference webcam app,
tools/webcam/webcam_apis/webcam_runner.py + nodes): frames flow through a
chain of nodes (source -> person detection -> top-down pose -> visualizer ->
sink). Headless-friendly: sources can be a camera index, a video file, or a
directory of images; sinks can be a display window or an output video.

The pose node runs `inference_top_down_pose_model` on the model's device
(CUDA unless the model was built with device='cpu'): person boxes padded to
a bucket size, one batched warp, the model with K1 where the config turns
fused attention on, and the decode, with the host decoding the frame.
`VideoSink` writes through `utils.video.video_writer` (MJPG for .avi, mp4v
otherwise, as JAX does for every file), which raises where cv2 cannot open
the file.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np

from .inference import inference_top_down_pose_model, vis_pose_result
from .tracking import get_track_id
from ..utils.timer import StopWatch
from ..utils.video import video_writer


class Node:
    name = 'node'

    def process(self, msg: dict) -> dict:
        raise NotImplementedError


class FrameSource:
    """Camera index / video path / image directory -> frame iterator."""

    def __init__(self, src):
        self.src = src

    def __iter__(self):
        import cv2
        if isinstance(self.src, str) and os.path.isdir(self.src):
            for name in sorted(os.listdir(self.src)):
                if name.lower().endswith(('.jpg', '.jpeg', '.png')):
                    img = cv2.imread(os.path.join(self.src, name))
                    if img is not None:
                        yield cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            return
        cap = cv2.VideoCapture(self.src)
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        finally:
            cap.release()


class DetectorNode(Node):
    """Person detection. Default: whole-frame box (the reference uses an
    mmdet model here); plug in any callable frame -> list of xywh boxes."""
    name = 'detector'

    def __init__(self, detect_fn: Optional[Callable] = None):
        self.detect_fn = detect_fn

    def process(self, msg):
        frame = msg['frame']
        if self.detect_fn is None:
            h, w = frame.shape[:2]
            msg['person_results'] = [
                {'bbox': np.array([0, 0, w, h, 1.0], np.float32)}]
        else:
            msg['person_results'] = [
                {'bbox': np.asarray(b, np.float32)}
                for b in self.detect_fn(frame)]
        return msg


class PoseNode(Node):
    name = 'pose'

    def __init__(self, pose_model, track: bool = True):
        self.model = pose_model
        self.track = track
        self._last = []
        self._next_id = 0

    def process(self, msg):
        results, _ = inference_top_down_pose_model(
            self.model, msg['frame'], msg['person_results'])
        if self.track:
            # DetectorNode boxes are xywh (inference_top_down default)
            results, self._next_id = get_track_id(
                results, self._last, self._next_id, bbox_format='xywh')
            self._last = [dict(r) for r in results]
        msg['pose_results'] = results
        return msg


class VisualizerNode(Node):
    name = 'visualizer'

    def __init__(self, pose_model, kpt_thr=0.3):
        self.model = pose_model
        self.kpt_thr = kpt_thr

    def process(self, msg):
        msg['vis_frame'] = vis_pose_result(
            self.model, msg['frame'], msg.get('pose_results', []),
            kpt_score_thr=self.kpt_thr)
        return msg


class VideoSink(Node):
    name = 'sink'

    def __init__(self, out_path=None, fps=30):
        self.out_path = out_path
        self.fps = fps
        self._writer = None
        self.frames_written = 0

    def process(self, msg):
        if self.out_path is None:
            return msg
        import cv2
        frame = msg.get('vis_frame')
        if frame is None:
            # headless chains without a visualizer still record: the raw
            # source frame is RGB -> convert for the BGR video writer
            frame = cv2.cvtColor(msg['frame'], cv2.COLOR_RGB2BGR)
        if self._writer is None:
            self._size = (frame.shape[1], frame.shape[0])
            self._writer = video_writer(self.out_path, self.fps, self._size)
        if (frame.shape[1], frame.shape[0]) != self._size:
            frame = cv2.resize(frame, self._size)
        self._writer.write(frame)
        self.frames_written += 1
        return msg

    def close(self):
        if self._writer is not None:
            self._writer.release()


class WebcamRunner:
    """Drive frames through the node chain, collecting per-node timings."""

    def __init__(self, source, nodes: List[Node], max_frames=None):
        self.source = FrameSource(source) if not hasattr(source, '__iter__') \
            or isinstance(source, str) else source
        self.nodes = nodes
        self.max_frames = max_frames
        self.stopwatch = StopWatch(window=30)

    def run(self):
        n = 0
        for frame in self.source:
            msg = {'frame': frame, 'frame_id': n, 'timestamp': time.time()}
            with self.stopwatch.timeit('_FPS_'):
                for node in self.nodes:
                    with self.stopwatch.timeit(node.name):
                        msg = node.process(msg)
            n += 1
            if self.max_frames and n >= self.max_frames:
                break
        for node in self.nodes:
            if hasattr(node, 'close'):
                node.close()
        return n


class EffectNode(Node):
    """Fun frame effects driven by keypoints (counterpart of the reference
    webcam effect nodes, tools/webcam/webcam_apis/nodes/): 'sunglasses'
    draws shades over the eyes, 'bugeye' magnifies the eye regions."""
    name = 'effect'

    def __init__(self, pose_model, kind='sunglasses', kpt_thr=0.3):
        self.info = pose_model.dataset_info
        self.kind = kind
        self.kpt_thr = kpt_thr
        names = self.info.keypoint_names
        self.eye_ids = [names.index(n) for n in ('left_eye', 'right_eye')
                        if n in names]

    def process(self, msg):
        import cv2
        frame = msg.get('vis_frame')
        if frame is None:
            # no visualizer upstream: source frames are RGB but vis_frame
            # is BGR by contract (VideoSink writes it via cv2) — convert
            frame = cv2.cvtColor(msg['frame'], cv2.COLOR_RGB2BGR)
        else:
            frame = frame.copy()
        for res in msg.get('pose_results', []):
            kp = np.asarray(res['keypoints'])
            if len(self.eye_ids) != 2:
                continue
            le, re = kp[self.eye_ids[0]], kp[self.eye_ids[1]]
            if le[2] < self.kpt_thr or re[2] < self.kpt_thr:
                continue
            center = ((le[:2] + re[:2]) / 2).astype(int)
            half = max(int(np.linalg.norm(le[:2] - re[:2])), 8)
            if self.kind == 'sunglasses':
                for eye in (le, re):
                    cv2.circle(frame, tuple(eye[:2].astype(int)),
                               half // 2, (20, 20, 20), -1)
                cv2.line(frame, tuple(le[:2].astype(int)),
                         tuple(re[:2].astype(int)), (20, 20, 20), 2)
            elif self.kind == 'bugeye':
                for eye in (le, re):
                    ex, ey = eye[:2].astype(int)
                    r = half // 2
                    x0, y0 = max(ex - r, 0), max(ey - r, 0)
                    x1 = min(ex + r, frame.shape[1])
                    y1 = min(ey + r, frame.shape[0])
                    if x1 - x0 > 2 and y1 - y0 > 2:
                        patch = frame[y0:y1, x0:x1]
                        big = cv2.resize(patch, None, fx=1.5, fy=1.5)
                        bh, bw = big.shape[:2]
                        cx0 = max((bh - (y1 - y0)) // 2, 0)
                        cx1 = cx0 + (y1 - y0)
                        cy0 = max((bw - (x1 - x0)) // 2, 0)
                        cy1 = cy0 + (x1 - x0)
                        frame[y0:y1, x0:x1] = big[cx0:cx1, cy0:cy1]
        msg['vis_frame'] = frame
        return msg


class LatestBuffer:
    """Size-1 overwrite buffer (counterpart of the reference
    webcam_apis/utils/buffer.py Buffer registered with maxsize=1: when the
    consumer is slower than the producer, old frames are DROPPED and the
    consumer always sees the freshest one)."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._item = None

    def put(self, item):
        with self._lock:
            self._item = item
            self._event.set()

    def get(self, timeout=None):
        """Block until an item is available; returns None on timeout."""
        if not self._event.wait(timeout):
            return None
        with self._lock:
            item, self._item = self._item, None
            self._event.clear()
        return item


class AsyncWebcamRunner:
    """Decoupled capture/inference/display loop (counterpart of the
    reference webcam_runner.py threaded node graph).

    ``model_nodes`` (detector -> pose) run in a worker thread on the
    LATEST frame only; ``display_nodes`` (visualizer/effects -> sink) run
    for EVERY source frame using the most recent completed pose results.
    Display therefore keeps the camera's frame rate even when inference
    is slower, exactly like the reference's buffer-managed graph.
    """

    def __init__(self, source, model_nodes: List[Node],
                 display_nodes: List[Node], max_frames=None):
        self.source = FrameSource(source) if not hasattr(source, '__iter__') \
            or isinstance(source, str) else source
        self.model_nodes = model_nodes
        self.display_nodes = display_nodes
        self.max_frames = max_frames
        self.stopwatch = StopWatch(window=30)
        self.inference_count = 0
        self.worker_error = None

    def _worker(self, buffer, state, stop):
        try:
            while not stop.is_set():
                msg = buffer.get(timeout=0.1)
                if msg is None:
                    continue
                for node in self.model_nodes:
                    with self.stopwatch.timeit(node.name):
                        msg = node.process(msg)
                state.update({k: v for k, v in msg.items()
                              if k not in ('frame', 'frame_id',
                                           'timestamp')})
                self.inference_count += 1
        except BaseException as e:   # surfaced in run(), not swallowed
            self.worker_error = e
            stop.set()

    def run(self):
        import threading
        buffer = LatestBuffer()
        state = {}          # latest inference outputs (pose_results, ...)
        stop = threading.Event()
        worker = threading.Thread(target=self._worker,
                                  args=(buffer, state, stop), daemon=True)
        worker.start()
        n = 0
        try:
            for frame in self.source:
                if stop.is_set():        # worker died — stop streaming
                    break
                msg = {'frame': frame, 'frame_id': n,
                       'timestamp': time.time()}
                buffer.put(dict(msg))
                msg.update(state)        # freshest completed results
                with self.stopwatch.timeit('_FPS_'):
                    for node in self.display_nodes:
                        with self.stopwatch.timeit(node.name):
                            msg = node.process(msg)
                n += 1
                if self.max_frames and n >= self.max_frames:
                    break
        finally:
            stop.set()
            worker.join(timeout=5)
            for node in self.model_nodes + self.display_nodes:
                if hasattr(node, 'close'):
                    node.close()
        if self.worker_error is not None:
            raise RuntimeError(
                'webcam model worker failed') from self.worker_error
        return n

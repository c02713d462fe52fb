"""Config-driven webcam application runner.

Counterpart of the reference tools/webcam/webcam_apis/webcam_runner.py: it
owns the buffer and event managers, builds the node graph from config,
reads camera/video frames into the reserved `_frame_` / `_input_` buffers,
and displays (or headlessly drains) the `_display_` buffer.

Reserved buffers (reference webcam_runner.py:17-20,79-92):
  _frame_    raw frames for the display-side chain        (default size 1)
  _input_    frame copies for the model-side chain        (default size 1)
  _display_  final frames the display loop consumes       (default size 0)

Headless extensions for tunnel/CI deployments (no reference analogue):
`show=False` drains `_display_` without a GUI window, `on_display` receives
every output frame, `max_frames` bounds the run, and `inject_key()` feeds
the keyboard event namespace programmatically.
"""
from __future__ import annotations

import logging
import time
import warnings
from contextlib import nullcontext
from threading import Thread
from typing import Callable, Dict, List, Optional, Tuple, Union

from .buffer import BufferManager
from .event import EventManager
from .message import FrameMessage, VideoEndingMessage
from .misc import DirectoryCapture, ImageCapture, is_image_file, \
    limit_max_fps
from .node import NODES

DEFAULT_FRAME_BUFFER_SIZE = 1
DEFAULT_INPUT_BUFFER_SIZE = 1
DEFAULT_DISPLAY_BUFFER_SIZE = 0
DEFAULT_USER_BUFFER_SIZE = 1


class WebcamRunner:

    def __init__(self,
                 name: str = 'vitpose_tpu_torch webcam runner',
                 camera_id: Union[int, str] = 0,
                 camera_fps: int = 30,
                 camera_frame_shape: Optional[Tuple[int, int]] = None,
                 synchronous: bool = False,
                 buffer_sizes: Optional[Dict[str, int]] = None,
                 nodes: Optional[List[Dict]] = None,
                 show: bool = True,
                 max_frames: Optional[int] = None,
                 on_display: Optional[Callable] = None):
        self.name = name
        self.camera_id = camera_id
        self.camera_fps = camera_fps
        self.camera_frame_shape = camera_frame_shape
        self.synchronous = synchronous
        self.show = show
        self.max_frames = max_frames
        self.on_display = on_display
        self.frame_count = 0

        self.buffer_manager = BufferManager()
        self.event_manager = EventManager()
        self.node_list = []
        self.vcap = None

        self.event_manager.register_event('_exit_')
        if self.synchronous:
            self.event_manager.register_event('_idle_')

        if not nodes:
            raise ValueError('no nodes are registered to the runner')

        buffer_sizes = dict(buffer_sizes or {})
        self.buffer_manager.register_buffer(
            '_frame_', buffer_sizes.get('_frame_',
                                        DEFAULT_FRAME_BUFFER_SIZE))
        self.buffer_manager.register_buffer(
            '_input_', buffer_sizes.get('_input_',
                                        DEFAULT_INPUT_BUFFER_SIZE))
        self.buffer_manager.register_buffer(
            '_display_', buffer_sizes.get('_display_',
                                          DEFAULT_DISPLAY_BUFFER_SIZE))

        for node_cfg in nodes:
            node = node_cfg if not isinstance(node_cfg, dict) \
                else NODES.build(node_cfg)
            self.node_list.append(node)
            for info in node.registered_buffers:
                if info.buffer_name in self.buffer_manager:
                    continue
                self.buffer_manager.register_buffer(
                    info.buffer_name,
                    buffer_sizes.get(info.buffer_name,
                                     DEFAULT_USER_BUFFER_SIZE))
            for event_info in node.registered_events:
                self.event_manager.register_event(
                    event_info.event_name, event_info.is_keyboard)

        for node in self.node_list:
            node.set_runner(self)

    # -- capture ------------------------------------------------------------

    def _open_capture(self):
        import cv2
        import os
        cam = self.camera_id
        if is_image_file(cam):
            return ImageCapture(cam)
        if isinstance(cam, str) and os.path.isdir(cam):
            return DirectoryCapture(cam)
        vcap = cv2.VideoCapture(cam)
        if self.camera_frame_shape is not None:
            w, h = self.camera_frame_shape
            vcap.set(cv2.CAP_PROP_FRAME_WIDTH, w)
            vcap.set(cv2.CAP_PROP_FRAME_HEIGHT, h)
        return vcap

    def _read_camera(self):
        """Producer loop: frames into `_frame_` (blocking put — display
        pacing) and `_input_` (put_force — models always see the freshest
        frame). Reference webcam_runner.py:124."""
        self.vcap = self._open_capture()
        if not self.vcap.isOpened():
            warnings.warn(f'cannot open camera (ID={self.camera_id})')
            self.event_manager.set('_exit_')
            return

        first = True
        while not self.event_manager.is_set('_exit_'):
            if self.synchronous and not first:
                # Wait until the display loop marks the last frame done,
                # polling so _exit_ still terminates the producer.
                cm = self.event_manager.wait_and_handle('_idle_',
                                                        timeout=0.1)
            elif self.synchronous:
                cm = nullcontext(True)
            else:
                cm = limit_max_fps(self.camera_fps)
            first = False

            with cm as fired:
                if self.synchronous and not fired:
                    continue
                ok, frame = self.vcap.read()
                if not ok:
                    self._put_frame(VideoEndingMessage())
                    break
                if not self._put_frame(FrameMessage(frame)):
                    break
                input_msg = FrameMessage(frame.copy())
                input_msg.update_route_info(node_name='Camera Info',
                                            node_type='dummy',
                                            info=self._get_camera_info())
                self.buffer_manager.put_force('_input_', input_msg)

        self.vcap.release()

    def _put_frame(self, msg) -> bool:
        """Blocking put into `_frame_` that still honors `_exit_` (a plain
        blocking put could deadlock the producer once the display loop
        stops consuming, e.g. at max_frames)."""
        from queue import Full
        while not self.event_manager.is_set('_exit_'):
            try:
                self.buffer_manager.put('_frame_', msg, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def _get_camera_info(self) -> Dict:
        import cv2
        return {
            'Camera ID': self.camera_id,
            'Source resolution':
                f'{self.vcap.get(cv2.CAP_PROP_FRAME_WIDTH)}x'
                f'{self.vcap.get(cv2.CAP_PROP_FRAME_HEIGHT)}',
            'Source FPS': self.vcap.get(cv2.CAP_PROP_FPS),
        }

    # -- display ------------------------------------------------------------

    def inject_key(self, key: Union[str, int]):
        """Feed a key press without a GUI (headless counterpart of the
        reference's cv2.waitKey handling, webcam_runner.py:213)."""
        self._on_keyboard_input(ord(key) if isinstance(key, str) else key)

    def _on_keyboard_input(self, key: int):
        if key in (27, ord('q'), ord('Q')):
            self.event_manager.set('_exit_')
        else:
            self.event_manager.set(key, is_keyboard=True)

    def _display(self):
        """Consumer loop over `_display_` (reference webcam_runner.py:181):
        GUI window + keyboard when showing, plain drain when headless."""
        import cv2
        while not self.event_manager.is_set('_exit_'):
            try:
                output_msg = self.buffer_manager.get('_display_',
                                                     timeout=0.02)
            except Exception:
                continue

            if self.synchronous:
                self.event_manager.set('_idle_')

            if isinstance(output_msg, VideoEndingMessage):
                self.event_manager.set('_exit_')
                break

            img = output_msg.get_image()
            self.frame_count += 1
            if self.on_display is not None:
                self.on_display(img, output_msg)
            if self.show:
                cv2.imshow(self.name, img)
                key = cv2.waitKey(1)
                if key != -1:
                    self._on_keyboard_input(key)
            if self.max_frames and self.frame_count >= self.max_frames:
                self.event_manager.set('_exit_')
                break
        if self.show:
            cv2.destroyAllWindows()

    def run(self):
        """Start node threads + the camera reader, and consume the display
        stream in the calling thread (reference webcam_runner.py:238)."""
        try:
            non_daemon = [n for n in self.node_list if not n.daemon]
            for node in self.node_list:
                node.start()
            t_read = Thread(target=self._read_camera, args=())
            t_read.start()

            self._display()
            logging.info('display shut down')

            t_read.join()
            for node in non_daemon:
                node.join()
            # Daemon nodes exit via _exit_; give their on_exit a moment
            # (recorder flush etc.) before returning.
            deadline = time.time() + 5.0
            for node in self.node_list:
                node.join(timeout=max(0.0, deadline - time.time()))
        except KeyboardInterrupt:
            self.event_manager.set('_exit_')
        return self.frame_count

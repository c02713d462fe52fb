"""Helper nodes: result binding, runtime monitor, video recorder.

Counterparts of the reference tools/webcam/webcam_apis/nodes/helper_node.py.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from queue import Full, Queue
from threading import Thread
from typing import List, Optional, Union

import numpy as np

from .misc import color_val
from .node import NODES, Node


class RunningAverage:
    """Windowed mean (reference mmpose/utils/timer.py RunningAverage)."""

    def __init__(self, window: int = 10):
        self._vals = deque(maxlen=window)

    def update(self, value: float):
        self._vals.append(value)

    def average(self) -> float:
        return float(np.mean(self._vals)) if self._vals else 0.0


@NODES.register_module()
class ModelResultBindingNode(Node):
    """Pair display frames with the freshest model result (reference
    helper_node.py:24). In asynchronous mode every raw frame goes out
    carrying the latest completed results; in synchronous mode the frame
    the result was computed on goes out."""

    def __init__(self, name: str, frame_buffer: str, result_buffer: str,
                 output_buffer: Union[str, List[str]]):
        super().__init__(name=name, enable=True)
        self.synchronous = None
        self.last_result_msg = None
        self.last_output_msg = None
        self.frame_fps = RunningAverage(window=10)
        self.frame_lag = RunningAverage(window=10)
        self.result_fps = RunningAverage(window=10)
        self.result_lag = RunningAverage(window=10)
        # Which input is essential depends on runner.synchronous and is
        # resolved in set_runner (reference helper_node.py:48).
        self.register_input_buffer(result_buffer, 'result', essential=False)
        self.register_input_buffer(frame_buffer, 'frame', essential=False)
        self.register_output_buffer(output_buffer)

    def set_runner(self, runner):
        super().set_runner(runner)
        self.synchronous = runner.synchronous
        essential = 'result' if runner.synchronous else 'frame'
        for info in self._input_buffers:
            if info.input_name == essential:
                info.essential = True

    def process(self, input_msgs):
        result_msg = input_msgs['result']
        if result_msg is not None:
            if self.last_result_msg is not None:
                dt = result_msg.timestamp - self.last_result_msg.timestamp
                if dt > 0:
                    self.result_fps.update(1.0 / dt)
            self.result_lag.update(time.time() - result_msg.timestamp)
            self.last_result_msg = result_msg

        if not self.synchronous:
            frame_msg = input_msgs['frame']
            self.frame_lag.update(time.time() - frame_msg.timestamp)
            if self.last_result_msg is not None:
                frame_msg.set_full_results(
                    self.last_result_msg.get_full_results())
                frame_msg.merge_route_info(
                    self.last_result_msg.get_route_info())
            output_msg = frame_msg
        else:
            self.frame_lag.update(time.time() - result_msg.timestamp)
            output_msg = result_msg

        if self.last_output_msg is not None:
            dt = output_msg.timestamp - self.last_output_msg.timestamp
            if dt > 0:
                self.frame_fps.update(1.0 / dt)
        self.last_output_msg = output_msg
        return output_msg

    def _get_node_info(self):
        info = super()._get_node_info()
        info['result_fps'] = self.result_fps.average()
        info['result_lag (ms)'] = self.result_lag.average() * 1000
        info['frame_fps'] = self.frame_fps.average()
        info['frame_lag (ms)'] = self.frame_lag.average() * 1000
        return info


@NODES.register_module()
class MonitorNode(Node):
    """Overlay the message's route info (per-node fps/lag) on the frame
    (reference helper_node.py:119). Toggled with enable_key; disabled by
    default like the reference."""

    _default_ignore_items = ['timestamp']

    def __init__(self, name: str, frame_buffer: str,
                 output_buffer: Union[str, List[str]],
                 enable_key: Optional[Union[str, int]] = None,
                 enable: bool = False,
                 x_offset: int = 20, y_offset: int = 20, y_delta: int = 15,
                 text_color='black', background_color=(255, 183, 0),
                 text_scale: float = 0.4,
                 ignore_items: Optional[List[str]] = None):
        super().__init__(name=name, enable_key=enable_key, enable=enable)
        self.x_offset = x_offset
        self.y_offset = y_offset
        self.y_delta = y_delta
        self.text_color = color_val(text_color)
        self.background_color = color_val(background_color)
        self.text_scale = text_scale
        self.ignore_items = (self._default_ignore_items
                             if ignore_items is None else ignore_items)
        self.register_input_buffer(frame_buffer, 'frame', essential=True)
        self.register_output_buffer(output_buffer)

    def process(self, input_msgs):
        frame_msg = input_msgs['frame']
        frame_msg.update_route_info(node_name='System Info',
                                    node_type='dummy',
                                    info=self._get_system_info())
        img = self._show_route_info(frame_msg.get_image(),
                                    frame_msg.get_route_info())
        frame_msg.set_image(img)
        return frame_msg

    @staticmethod
    def _get_system_info():
        try:
            import psutil
            proc = psutil.Process()
            return {'CPU(%)': proc.cpu_percent(),
                    'Memory(%)': proc.memory_percent()}
        except (ImportError, ModuleNotFoundError):
            return {}

    def _show_route_info(self, img, route_info):
        import cv2
        canvas = np.full(img.shape, self.background_color, dtype=img.dtype)
        x, y = self.x_offset, self.y_offset
        max_len = 0

        def put_line(line=''):
            nonlocal y, max_len
            cv2.putText(canvas, line, (x, y), cv2.FONT_HERSHEY_DUPLEX,
                        self.text_scale, self.text_color, 1)
            y += self.y_delta
            max_len = max(max_len, len(line))

        for entry in route_info:
            put_line(f'{entry["node"]}({entry["node_type"]})')
            for k, v in (entry['info'] or {}).items():
                if k in self.ignore_items:
                    continue
                if isinstance(v, float):
                    v = f'{v:.1f}'
                put_line(f'    {k}: {v}')

        x1, y1 = max(0, self.x_offset), max(0, self.y_offset - self.y_delta)
        x2 = min(img.shape[1], int(x + max_len * self.text_scale * 20))
        y2 = min(img.shape[0], y)
        img[y1:y2, x1:x2] = cv2.addWeighted(canvas[y1:y2, x1:x2], 0.5,
                                            img[y1:y2, x1:x2], 0.5, 0)
        return img

    def bypass(self, input_msgs):
        return input_msgs['frame']


@NODES.register_module()
class RecorderNode(Node):
    """Write frames to a video file from a dedicated writer thread
    (reference helper_node.py:215), so slow disk IO never stalls the
    display chain beyond the bounded queue."""

    def __init__(self, name: str, frame_buffer: str,
                 output_buffer: Union[str, List[str]],
                 out_video_file: str,
                 out_video_fps: int = 30,
                 out_video_codec: str = 'mp4v',
                 buffer_size: int = 30):
        super().__init__(name=name, enable=True)
        self.queue = Queue(maxsize=buffer_size)
        self.out_video_file = out_video_file
        self.out_video_fps = out_video_fps
        self.out_video_codec = out_video_codec
        self.vwriter = None
        self.register_input_buffer(frame_buffer, 'frame', essential=True)
        self.register_output_buffer(output_buffer)
        self.t_record = Thread(target=self._record, daemon=True)
        self.t_record.start()

    def process(self, input_msgs):
        frame_msg = input_msgs['frame']
        img = frame_msg.get_image() if frame_msg is not None else None
        while True:
            try:
                self.queue.put(img, timeout=1)
                break
            except Full:
                logging.info('%s: recorder jammed', self.name)
        return frame_msg

    def _record(self):
        import cv2
        while True:
            img = self.queue.get()
            if img is None:
                break
            if self.vwriter is None:
                self.vwriter = cv2.VideoWriter(
                    self.out_video_file,
                    cv2.VideoWriter_fourcc(*self.out_video_codec),
                    self.out_video_fps, (img.shape[1], img.shape[0]))
                if not self.vwriter.isOpened():
                    raise RuntimeError(
                        f'cv2 cannot write {self.out_video_file!r} with '
                        f'codec {self.out_video_codec}')
            self.vwriter.write(img)
        if self.vwriter is not None:
            self.vwriter.release()

    def on_exit(self):
        try:
            self.queue.put(None, timeout=1)
            self.t_record.join(timeout=5)
        except Full:
            pass
        if self.t_record.is_alive() and self.vwriter is not None:
            logging.info('video recorder forced release')
            self.vwriter.release()

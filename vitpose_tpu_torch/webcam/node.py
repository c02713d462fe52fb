"""Threaded node base classes and the node registry.

Counterpart of the reference tools/webcam/webcam_apis/nodes/node.py and
nodes/builder.py: a Node is a thread that pulls Messages from registered
input buffers, runs `process` (or `bypass` when hot-key-disabled), and
pushes the output to registered output buffers. VideoEndingMessages are
forwarded untouched and shut the node down.
"""
from __future__ import annotations

import logging
import time
from abc import ABCMeta, abstractmethod
from dataclasses import dataclass, field
from queue import Empty
from threading import Thread
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..utils.timer import StopWatch
from .message import FrameMessage, Message, VideoEndingMessage
from .misc import limit_max_fps


class Registry:
    """Minimal name -> class registry with config-driven build
    (counterpart of the reference's mmcv Registry used in builder.py)."""

    def __init__(self, name: str):
        self.name = name
        self._modules: Dict[str, type] = {}

    def register_module(self, cls=None, name: Optional[str] = None):
        def _register(c):
            self._modules[name or c.__name__] = c
            return c
        return _register(cls) if cls is not None else _register

    def get(self, name: str) -> type:
        if name not in self._modules:
            raise KeyError(
                f'{name!r} is not registered in {self.name}; known: '
                f'{sorted(self._modules)}')
        return self._modules[name]

    def build(self, cfg: dict):
        cfg = dict(cfg)
        cls = self.get(cfg.pop('type'))
        return cls(**cfg)

    def __contains__(self, name):
        return name in self._modules


NODES = Registry('webcam nodes')


@dataclass
class BufferInfo:
    """One registered buffer (reference node.py:17)."""
    buffer_name: str
    input_name: Optional[str] = None
    essential: bool = False


@dataclass
class EventInfo:
    """One registered event handler (reference node.py:25)."""
    event_name: Union[str, int]
    is_keyboard: bool = False
    handler_func: Optional[Callable] = field(default=None)


class Node(Thread, metaclass=ABCMeta):
    """Base node: a thread wired to named buffers and the event bus.

    Mirrors the reference Node contract (node.py:32): subclasses register
    input/output buffers and events in __init__, then implement `process`
    (and `bypass` if they support an enable hot-key).
    """

    def __init__(self, name: Optional[str] = None,
                 enable_key: Optional[Union[str, int]] = None,
                 max_fps: int = 30,
                 input_check_interval: float = 0.01,
                 enable: bool = True,
                 daemon: bool = True):
        super().__init__(name=name, daemon=daemon)
        self._enabled = enable
        self.enable_key = enable_key
        self.max_fps = max_fps
        self.input_check_interval = input_check_interval

        self._buffer_manager = None     # set by set_runner
        self._event_manager = None
        self._input_buffers: List[BufferInfo] = []
        self._output_buffers: List[BufferInfo] = []
        self._registered_events: List[EventInfo] = []
        self._listener_threads: List[Thread] = []
        self._timer = StopWatch(window=10)

        if self.enable_key is not None:
            # Toggling requires a bypass behavior (reference node.py:95).
            if type(self).bypass is Node.bypass:
                raise NotImplementedError(
                    f'{type(self).__name__} sets enable_key but does not '
                    'override bypass()')
            self.register_event(self.enable_key, is_keyboard=True,
                                handler_func=self._toggle_enable)

    # -- registration -----------------------------------------------------

    @property
    def registered_buffers(self) -> List[BufferInfo]:
        return self._input_buffers + self._output_buffers

    @property
    def registered_events(self) -> List[EventInfo]:
        return self._registered_events.copy()

    def _toggle_enable(self):
        self._enabled = not self._enabled

    def register_input_buffer(self, buffer_name: str, input_name: str,
                              essential: bool = False):
        self._input_buffers.append(
            BufferInfo(buffer_name, input_name, essential))

    def register_output_buffer(self, buffer_name: Union[str, List[str]]):
        names = buffer_name if isinstance(buffer_name, list) \
            else [buffer_name]
        for name in names:
            self._output_buffers.append(BufferInfo(name))

    def register_event(self, event_name, is_keyboard: bool = False,
                       handler_func: Optional[Callable] = None):
        self._registered_events.append(
            EventInfo(event_name, is_keyboard, handler_func))

    def set_runner(self, runner):
        self._buffer_manager = runner.buffer_manager.get_sub_manager(
            [b.buffer_name for b in self.registered_buffers])
        self._event_manager = runner.event_manager

    # -- I/O ---------------------------------------------------------------

    def _get_input_from_buffer(self) -> Tuple[bool, Optional[Dict]]:
        """Non-blocking fetch of all registered inputs; fails (False, None)
        if any essential buffer is empty (reference node.py:194)."""
        mgr = self._buffer_manager
        if mgr is None:
            raise ValueError(f'{self.name}: runner not set')
        for info in self._input_buffers:
            if info.essential and mgr.is_empty(info.buffer_name):
                return False, None
        result = {info.input_name: None for info in self._input_buffers}
        for info in self._input_buffers:
            try:
                result[info.input_name] = mgr.get(info.buffer_name,
                                                  block=False)
            except Empty:
                if info.essential:
                    return False, None
        return True, result

    def _send_output_to_buffers(self, output_msg: Message):
        for info in self._output_buffers:
            self._buffer_manager.put_force(info.buffer_name, output_msg)

    # -- behavior ----------------------------------------------------------

    @abstractmethod
    def process(self, input_msgs: Dict[str, Message]) \
            -> Union[Message, None]:
        """Produce the output message from ready inputs."""

    def bypass(self, input_msgs: Dict[str, Message]) -> Union[Message, None]:
        """Behavior when hot-key-disabled; override alongside enable_key."""
        raise NotImplementedError

    def _get_node_info(self) -> Dict:
        ms = self._timer.report().get('_FPS_', 0.0)
        return {'fps': 1000.0 / ms if ms else 0.0,
                'timestamp': time.time()}

    def on_exit(self):
        """Invoked once when the node shuts down."""

    def run(self):
        """Node main loop (reference node.py:296). Not overridden by
        subclasses."""
        for event_info in self._registered_events:
            if event_info.handler_func is None:
                continue

            def listen(info=event_info):
                while not self._event_manager.is_set('_exit_'):
                    with self._event_manager.wait_and_handle(
                            info.event_name, info.is_keyboard,
                            timeout=0.1) as fired:
                        if fired:
                            info.handler_func()

            t = Thread(target=listen, daemon=True)
            t.start()
            self._listener_threads.append(t)

        while True:
            if self._event_manager.is_set('_exit_'):
                self.on_exit()
                break

            ok, input_msgs = self._get_input_from_buffer()
            if not ok:
                time.sleep(self.input_check_interval)
                continue

            # Forward stream-end without processing (reference node.py:330)
            ending = next((m for m in input_msgs.values()
                           if isinstance(m, VideoEndingMessage)), None)
            if ending is not None:
                self._send_output_to_buffers(ending)
                self.on_exit()
                break

            if not self._enabled:
                output_msg = self.bypass(input_msgs)
            else:
                with self._timer.timeit('_FPS_'):
                    with limit_max_fps(self.max_fps):
                        output_msg = self.process(input_msgs)
                if output_msg:
                    output_msg.update_route_info(
                        node=self, info=self._get_node_info())

            if output_msg is not None:
                self._send_output_to_buffers(output_msg)

        logging.info('%s: process ending', self.name)


class FrameDrawingNode(Node):
    """Base for nodes that draw on the frame image (reference
    frame_drawing_node.py:11): single essential frame input, `draw` hook,
    and pass-through bypass."""

    def __init__(self, name: str, frame_buffer: str,
                 output_buffer: Union[str, List[str]],
                 enable_key: Optional[Union[str, int]] = None,
                 enable: bool = True):
        super().__init__(name=name, enable_key=enable_key)
        self.register_input_buffer(frame_buffer, 'frame', essential=True)
        self.register_output_buffer(output_buffer)
        self._enabled = enable

    def process(self, input_msgs):
        frame_msg = input_msgs['frame']
        frame_msg.set_image(self.draw(frame_msg))
        return frame_msg

    def bypass(self, input_msgs):
        return input_msgs['frame']

    @abstractmethod
    def draw(self, frame_msg: FrameMessage):
        """Return the drawn image."""

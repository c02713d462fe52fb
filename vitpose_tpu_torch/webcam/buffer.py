"""Named buffers connecting webcam nodes.

Counterpart of the reference tools/webcam/webcam_apis/utils/buffer.py:
a Buffer is a Queue with `put_force` (drop-oldest when full, so realtime
producers never block on slow consumers), and BufferManager is a registry
of named buffers that nodes address by name.
"""
from __future__ import annotations

from queue import Queue
from typing import Dict, List, Optional


class Buffer(Queue):
    """Queue with drop-oldest force-put (reference buffer.py:35)."""

    def put_force(self, item):
        with self.mutex:
            if self.maxsize > 0:
                while self._qsize() >= self.maxsize:
                    self._get()
                    self.unfinished_tasks -= 1
            self._put(item)
            self.unfinished_tasks += 1
            self.not_empty.notify()


class BufferManager:
    """Registry of named Buffers (reference buffer.py:54)."""

    def __init__(self, buffer_type: type = Buffer,
                 buffers: Optional[Dict[str, Buffer]] = None):
        self.buffer_type = buffer_type
        self._buffers: Dict[str, Buffer] = dict(buffers) if buffers else {}

    def __contains__(self, name) -> bool:
        return name in self._buffers

    def _require(self, name: str) -> Buffer:
        if name not in self._buffers:
            raise ValueError(f'buffer "{name}" is not registered')
        return self._buffers[name]

    def register_buffer(self, name: str, maxsize: int = 0):
        if name in self._buffers:
            raise ValueError(f'buffer "{name}" is already registered')
        self._buffers[name] = self.buffer_type(maxsize)

    def put(self, name: str, item, block: bool = True, timeout=None):
        self._require(name).put(item, block, timeout)

    def put_force(self, name: str, item):
        self._require(name).put_force(item)

    def get(self, name: str, block: bool = True, timeout=None):
        return self._require(name).get(block, timeout)

    def is_empty(self, name: str) -> bool:
        return self._require(name).empty()

    def is_full(self, name: str) -> bool:
        return self._require(name).full()

    def get_sub_manager(self, buffer_names: List[str]) -> 'BufferManager':
        """A view restricted to `buffer_names` — nodes get one of these so
        they can only touch their registered buffers (reference
        buffer.py:101)."""
        return BufferManager(
            self.buffer_type,
            {name: self._require(name) for name in buffer_names})

    def get_info(self) -> Dict[str, Dict]:
        return {name: {'size': buf.qsize(), 'maxsize': buf.maxsize}
                for name, buf in self._buffers.items()}

"""Event bus for the webcam node graph.

Counterpart of the reference tools/webcam/webcam_apis/utils/event.py:
named events plus a reserved keyboard namespace, and a wait-and-handle
context manager that clears the event after the handler runs.
"""
from __future__ import annotations

from collections import defaultdict
from contextlib import contextmanager
from threading import Event
from typing import Optional, Union


class EventManager:

    def __init__(self):
        self._events = defaultdict(Event)

    @staticmethod
    def _key(event_name: Union[str, int], is_keyboard: bool) -> str:
        if is_keyboard:
            ch = chr(event_name) if isinstance(event_name, int) \
                else event_name
            return f'_keyboard_{ch}'
        return event_name

    def register_event(self, event_name, is_keyboard: bool = False):
        self._events[self._key(event_name, is_keyboard)] = Event()

    def set(self, event_name, is_keyboard: bool = False):
        return self._events[self._key(event_name, is_keyboard)].set()

    def wait(self, event_name, is_keyboard: bool = False,
             timeout: Optional[float] = None):
        return self._events[self._key(event_name, is_keyboard)].wait(timeout)

    def is_set(self, event_name, is_keyboard: bool = False) -> bool:
        return self._events[self._key(event_name, is_keyboard)].is_set()

    def clear(self, event_name, is_keyboard: bool = False):
        return self._events[self._key(event_name, is_keyboard)].clear()

    @contextmanager
    def wait_and_handle(self, event_name, is_keyboard: bool = False,
                        timeout: Optional[float] = None):
        """Wait for the event, yield whether it fired, then clear it
        (reference event.py:50). The timeout lets listener threads poll
        so they can also observe shutdown flags."""
        fired = self.wait(event_name, is_keyboard, timeout)
        try:
            yield fired
        finally:
            if fired:
                self.clear(event_name, is_keyboard)

"""Graceful preemption and the training seed, for one process.

Counterpart of vitpose_tpu/parallel/distributed.py:52-91 (`PreemptionGuard`,
`init_random_seed`). `init_distributed` and everything else across processes
is not ported yet (ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import signal
from typing import Callable, Optional

import numpy as np


class PreemptionGuard:
    """A SIGTERM handler that asks the training loop for a final checkpoint.

    The loop checks `should_stop` after each step; on preemption it saves
    and returns instead of dying mid-step. `install` must run in the main
    thread (Python's rule for signal handlers); `uninstall` puts the
    previous handler back.
    """

    def __init__(self, on_preempt: Optional[Callable] = None):
        self.should_stop = False
        self._on_preempt = on_preempt
        self._prev = None

    def install(self):
        def handler(signum, frame):
            self.should_stop = True
            if self._on_preempt is not None:
                self._on_preempt()
            if callable(self._prev):
                self._prev(signum, frame)
        self._prev = signal.signal(signal.SIGTERM, handler)
        return self

    def uninstall(self):
        signal.signal(signal.SIGTERM,
                      signal.SIG_DFL if self._prev is None else self._prev)


def init_random_seed(seed: Optional[int] = None) -> int:
    """The training seed: `seed` where given, else a random one (reference
    apis/train.py:27 `init_random_seed`; one process, so nothing is
    broadcast)."""
    if seed is not None:
        return int(seed)
    return int(np.random.randint(2 ** 31))

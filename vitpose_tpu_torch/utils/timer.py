"""Timing utilities: `StopWatch`, running per-tag statistics for realtime
apps (the port's copy of vitpose_tpu/utils/timer.py, the reference
mmpose/utils/timer.py). Host wall-clock times, not device times."""
from __future__ import annotations

import time
from collections import defaultdict, deque


class StopWatch:
    """Accumulate timings per named tag with a sliding window.

    with sw.timeit('forward'):
        ...
    print(sw.report_strings())
    """

    def __init__(self, window=10):
        self.window = window
        self._records = defaultdict(lambda: deque(maxlen=window))

    def timeit(self, name='_FPS_'):
        sw = self

        class _Ctx:
            # start time lives on the context object, so concurrent
            # same-name sections from different threads (async webcam
            # runner) don't clobber each other
            def __enter__(self):
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *a):
                sw._records[name].append(time.perf_counter() - self._t0)
        return _Ctx()

    def report(self):
        return {k: sum(v) / max(len(v), 1) * 1000.0
                for k, v in self._records.items()}

    def report_strings(self):
        out = []
        for k, ms in self.report().items():
            if k == '_FPS_':
                out.append(f'FPS: {1000.0 / ms:.1f}' if ms else 'FPS: --')
            else:
                out.append(f'{k}: {ms:.1f} ms')
        return out

    def reset(self):
        self._records.clear()

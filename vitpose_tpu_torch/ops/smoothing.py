"""Temporal keypoint smoothing: the One-Euro filter, in numpy on the host.

The port's own copy of vitpose_tpu/ops/smoothing.py (`OneEuroFilter`):
per-keypoint adaptive exponential smoothing with a derivative-dependent
cutoff; missing keypoints (x <= 0) are set to -10. It runs on the host
because it keeps state per track and is tiny.
"""
from __future__ import annotations

from time import time

import numpy as np


def _smoothing_factor(t_e, cutoff):
    r = 2.0 * np.pi * cutoff * t_e
    return r / (r + 1.0)


def _exp_smooth(a, x, x_prev):
    return a * x + (1.0 - a) * x_prev


class OneEuroFilter:
    def __init__(self, x0, dx0=0.0, min_cutoff=1.7, beta=0.3,
                 d_cutoff=30.0, fps=None):
        x0 = np.asarray(x0, np.float32)
        self.data_shape = x0.shape
        self.min_cutoff = float(min_cutoff)
        self.beta = float(beta)
        self.x_prev = x0.copy()
        self.dx_prev = np.full(x0.shape, dx0, np.float32)
        self.realtime = fps is None
        if self.realtime:
            self.skip_frame_factor = float(d_cutoff)
            self.d_cutoff = float(d_cutoff)
        else:
            self.d_cutoff = float(fps)
        self.t_prev = time()

    def __call__(self, x, t_e=1.0):
        x = np.asarray(x, np.float32)
        assert x.shape == self.data_shape
        t = 0.0
        if self.realtime:
            t = time()
            t_e = (t - self.t_prev) * self.skip_frame_factor
        missing = x <= 0

        a_d = _smoothing_factor(t_e, self.d_cutoff)
        dx = (x - self.x_prev) / t_e
        dx_hat = _exp_smooth(a_d, dx, self.dx_prev)

        cutoff = self.min_cutoff + self.beta * np.abs(dx_hat)
        a = _smoothing_factor(t_e, cutoff)
        x_hat = _exp_smooth(a, x, self.x_prev)
        x_hat = np.where(missing, -10.0, x_hat)

        self.x_prev = x_hat
        self.dx_prev = dx_hat
        self.t_prev = t
        return x_hat

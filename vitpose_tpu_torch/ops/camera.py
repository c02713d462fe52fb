"""Pinhole camera with distortion, in numpy.

The port's own copy of vitpose_tpu/ops/camera.py:19-97 (`SimpleCamera`,
reference mmpose/core/camera/single_camera.py:8), in numpy where the JAX
file uses jax.numpy, with its conventions: `R` [3, 3] is the
camera-to-world rotation and `T` [3, 1] the camera's position in world
coordinates; world -> camera is X @ R + (-T^T @ R), camera -> world X @ R^T
+ T^T; camera -> pixel divides by depth, applies the radial (3 or 6
coefficients) and tangential distortion, then the [3, 2] intrinsics. f32
arithmetic, as the JAX copy's.
"""
from __future__ import annotations

import copy

import numpy as np


class SimpleCamera:
    def __init__(self, param: dict):
        r = np.asarray(param['R'], np.float32)
        t = np.asarray(param['T'], np.float32).reshape(1, 3)
        self.R_c2w = r.T
        self.T_c2w = t
        self.R_w2c = r
        self.T_w2c = -t @ r
        if 'K' in param:
            k_mat = np.asarray(param['K'], np.float32)           # [2, 3]
            self.K = k_mat.T                                     # [3, 2]
            f = np.array([k_mat[0, 0], k_mat[1, 1]], np.float32)
            c = np.array([k_mat[0, 2], k_mat[1, 2]], np.float32)
        else:
            f = np.asarray(param['f'], np.float32).reshape(2)
            c = np.asarray(param['c'], np.float32).reshape(2)
            self.K = _intrinsics(f, c)
        self.f = f
        self.c = c
        self.has_dist = 'k' in param and 'p' in param
        if self.has_dist:
            self.k = np.asarray(param['k'], np.float32).flatten()
            self.p = np.asarray(param['p'], np.float32).flatten()

    def world_to_camera(self, x):
        return np.asarray(x, np.float32) @ self.R_w2c + self.T_w2c

    def camera_to_world(self, x):
        return np.asarray(x, np.float32) @ self.R_c2w + self.T_c2w

    def camera_to_pixel(self, x):
        x = np.asarray(x, np.float32)
        v = x / x[..., 2:]
        if self.has_dist:
            k, p = self.k, self.p
            v2 = v[..., :2]
            r2 = np.sum(v2 ** 2, axis=-1)
            radial = 1.0 + sum(ki * r2 ** (i + 1)
                               for i, ki in enumerate(k[:3]))
            if k.shape[0] == 6:
                radial = radial / (1.0 + sum(
                    ki * r2 ** (i + 1) for i, ki in enumerate(k[3:])))
            tangential = 2.0 * (p[1] * v[..., 0] + p[0] * v[..., 1])
            v2 = v2 * (radial + tangential)[..., None] \
                + r2[..., None] * p[::-1]
            v = np.concatenate([v2, v[..., 2:]], axis=-1)
        return v @ self.K

    def pixel_to_camera(self, x):
        x = np.asarray(x, np.float32)
        z = x[..., 2:]
        uv = (x[..., :2] - self.c) / self.f * z
        return np.concatenate([uv, z], axis=-1)

    def scaled(self, sx, sy):
        """A copy whose pixel frame is rescaled by (sx, sy): only f and c
        change (the distortion acts in normalised coordinates)."""
        out = copy.copy(self)
        s = np.asarray([sx, sy], np.float32)
        out.f = self.f * s
        out.c = self.c * s
        out.K = _intrinsics(out.f, out.c)
        return out


def _intrinsics(f, c):
    """[3, 2] projection of focal lengths f and principal point c."""
    return np.concatenate([np.diagflat(f), c[:, None]], axis=-1).T.astype(
        np.float32)

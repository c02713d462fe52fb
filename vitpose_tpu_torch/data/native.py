"""ctypes binding of the port's native data-loader core (csrc/loader.cpp).

Counterpart of vitpose_tpu/data/native.py. The library is the port's own:
`kernels._build.build_host` compiles ``vitpose_tpu_torch/csrc/loader.cpp``
with the host C++ compiler and ``-ljpeg`` at first use, into the git-ignored
``kernels/build/``. Where the compiler or ``jpeglib.h`` is missing there is
no native library, and the loader decodes with cv2 instead, which is the JAX
package's rule (vitpose_tpu/data/loader.py:124-128).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List

import numpy as np

from ..kernels import _build


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded native library, built first if needed; None without a C++
    compiler or the libjpeg headers. A failed build of present sources
    raises."""
    if not _build.has_header('jpeglib.h'):
        return None
    lib = ctypes.CDLL(str(_build.build_host('loader')))
    lib.vtp_decode_batch.restype = ctypes.c_int
    lib.vtp_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    return lib


def native_available() -> bool:
    return _library() is not None


def decode_batch_native(paths: List[str], canvas_size: int,
                        n_threads: int = 8):
    """Decode JPEGs onto zero-filled canvases with the C++ thread pool.

    Returns (canvases [N, S, S, 3] uint8, scales [N] float32). Raises on
    decode failure of any file.
    """
    lib = _library()
    if lib is None:
        raise RuntimeError('the native loader is not available: it needs a '
                           'C++ compiler and the libjpeg headers (jpeglib.h)')
    n = len(paths)
    canvases = np.empty((n, canvas_size, canvas_size, 3), np.uint8)
    scales = np.empty(n, np.float32)
    widths = np.empty(n, np.int32)
    heights = np.empty(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.vtp_decode_batch(
        c_paths, n,
        canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        canvas_size,
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    if rc != 0:
        raise IOError(f'native decode failed for {paths[rc - 1]}')
    return canvases, scales

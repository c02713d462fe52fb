"""Threading limits for the training process.

Counterpart of vitpose_tpu/utils/env.py:57 `setup_multi_processes`
(reference mmpose/utils/setup_env.py:10, without the torch.multiprocessing
start method: the loader decodes on threads or the native pool, not in
forked workers).
"""
from __future__ import annotations

import os


def setup_multi_processes(cfg=None):
    """Clamp cv2's threads to `cfg['opencv_num_threads']` (default 0: cv2
    runs single-threaded inside each loader thread) and, when the loader
    has more than one worker, OpenMP and MKL to one thread each where the
    environment does not set them, so the loader's threads do not
    oversubscribe the host."""
    cfg = cfg if isinstance(cfg, dict) else {}
    num_workers = cfg.get('data', {}).get('num_workers', 1)
    try:
        import cv2
        cv2.setNumThreads(int(cfg.get('opencv_num_threads', 0)))
    except ImportError:
        pass
    if num_workers > 1:
        for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
            if var not in os.environ:
                os.environ[var] = '1'

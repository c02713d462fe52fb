"""Environment fingerprint, the package logger and threading limits.

Counterpart of vitpose_tpu/utils/env.py: `collect_env` (:9; torch, CUDA,
cuDNN, nvcc and the cards take the place of JAX's backend and devices),
`get_root_logger` (:36) and `setup_multi_processes` (:57; reference
mmpose/utils/setup_env.py:10, without the torch.multiprocessing start
method: the loader decodes on threads or the native pool, not in forked
workers); and `card_line`, the card's name and power limit that every
timing the tools print stands beside.
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys


def _nvcc_version():
    """The last line of `nvcc --version` (PATH, else CUDA_HOME or
    /usr/local/cuda), or 'not found'."""
    nvcc = shutil.which('nvcc') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'nvcc')
    if not os.path.isfile(nvcc):
        return 'not found'
    out = subprocess.run([nvcc, '--version'], capture_output=True, text=True,
                         check=False).stdout.strip().splitlines()
    return out[-1] if out else 'unknown'


def collect_env():
    """Environment info dict for reproducibility logging: Python, torch and
    its CUDA and cuDNN builds, nvcc, the cards, numpy, cv2 and the port."""
    import torch
    info = {'python': sys.version.replace('\n', ' '),
            'torch': torch.__version__,
            'torch_cuda': torch.version.cuda or 'none (CPU build)',
            'cudnn': (str(torch.backends.cudnn.version())
                      if torch.backends.cudnn.is_available() else 'none'),
            'nvcc': _nvcc_version(),
            'cuda_available': torch.cuda.is_available()}
    if torch.cuda.is_available():
        info['devices'] = ', '.join(
            torch.cuda.get_device_name(i)
            for i in range(torch.cuda.device_count()))
    for mod in ('numpy', 'cv2'):
        try:
            info[mod] = getattr(__import__(mod), '__version__', 'unknown')
        except ImportError:
            info[mod] = 'not installed'
    from .. import __version__
    info['vitpose_tpu_torch'] = __version__
    return info


def card_line(device):
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of
    a CUDA `device`'s card (torch's name for it where nvidia-smi cannot be
    run); 'the CPU' for a CPU device."""
    import torch
    dev = torch.device(device)
    if dev.type != 'cuda':
        return 'the CPU'
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ['nvidia-smi', '-i', str(idx), '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out = ''
    return out or (f'{torch.cuda.get_device_name(idx)}, power limit not '
                   'read (no nvidia-smi)')


_logger_initialized = set()


def get_root_logger(log_file=None, log_level=logging.INFO,
                    name='vitpose_tpu_torch'):
    """The package logger, created on first use with a stream handler and,
    with `log_file`, a file handler beside it; later calls return it as it
    is."""
    logger = logging.getLogger(name)
    if name in _logger_initialized:
        return logger
    fmt = logging.Formatter(
        '%(asctime)s - %(name)s - %(levelname)s - %(message)s')
    handlers = [logging.StreamHandler()]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    logger.setLevel(log_level)
    logger.propagate = False
    _logger_initialized.add(name)
    return logger


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

"""Build the port's CUDA sources into plain-C shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``kernels/build/lib<name>_<hash>.so`` (the directory is git-ignored) and
loaded with ``ctypes``. The hash covers the source and the flags, so an edited
source builds anew and a stale library is never loaded. Building goes
through a temporary file and an atomic rename, so processes that build at the
same time do not see half-written libraries.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: dict = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and os.access(os.path.join(home, 'bin', 'nvcc'), os.X_OK):
            return os.path.join(home, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                           'are built from vitpose_tpu_torch/csrc at first '
                           'use')
    return found


def sources() -> list:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob('*.cu'))


def library_path(name: str) -> Path:
    src = (CSRC / f'{name}.cu').read_bytes()
    digest = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}_{digest[:16]}.so'


def build(name: str) -> tuple:
    """Compile csrc/<name>.cu unless its library exists.

    Returns (library path, compiler log); the log holds ptxas's register,
    shared-memory and spill counts, and is empty when nothing was built.
    """
    out = library_path(name)
    if out.exists():
        return out, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed on {name}.cu:\n{res.stdout}'
                           f'{res.stderr}')
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


def build_all() -> dict:
    """Build every source at once, one nvcc process each: {name: log}."""
    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        results = list(pool.map(build, names))
    return {n: log for n, (_, log) in zip(names, results)}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build(name)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib

"""Build the port's native sources into plain-C shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``kernels/build/lib<name>_<hash>.so`` (the directory is git-ignored) and
loaded with ``ctypes``. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source builds anew and a stale
library is never loaded. The host-side data loader, ``csrc/loader.cpp``, is
built the same way by the C++ compiler with ``-ljpeg`` (`build_host`).
Building goes through a temporary file and an atomic rename, so processes
that build at the same time do not see half-written libraries.

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
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-pthread', '-shared')
CXX_LIBS = ('-ljpeg', '-pthread')

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


def _hashed_path(name: str, files, flags) -> Path:
    src = b''.join(p.read_bytes() for p in files)
    digest = hashlib.sha256(src + ' '.join(flags).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}_{digest[:16]}.so'


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of that source, the
    headers it may include (csrc/*.cuh) and the flags."""
    return _hashed_path(name, [CSRC / f'{name}.cu',
                               *sorted(CSRC.glob('*.cuh'))], NVCC_FLAGS)


def _compile(out: Path, cmd_to) -> str:
    """Run the compiler command `cmd_to(tmp)` and rename its output to `out`
    unless `out` exists; returns the compiler log ('' when nothing was
    built)."""
    if out.exists():
        return ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    res = subprocess.run(cmd_to(tmp), capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'building {out.name} failed:\n{res.stdout}'
                           f'{res.stderr}')
    os.replace(tmp, out)
    return res.stdout + res.stderr


def build(name: str) -> tuple:
    """Compile csrc/<name>.cu unless its library exists.

    Returns (library path, compiler log); the log holds ptxas's register,
    shared-memory and spill counts, and is empty when nothing was built.
    """
    out = library_path(name)
    log = _compile(out, lambda tmp: [nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                                     str(CSRC / f'{name}.cu')])
    return out, log


def cxx():
    """Path of the host C++ compiler ($CXX, else g++ on PATH), or None."""
    return os.environ.get('CXX') or shutil.which('g++')


def has_header(header: str) -> bool:
    """Whether the host C++ compiler finds `header` (e.g. 'jpeglib.h')."""
    compiler = cxx()
    if compiler is None:
        return False
    res = subprocess.run([compiler, '-E', '-x', 'c++', '-'],
                         input=f'#include <{header}>\n', capture_output=True,
                         text=True)
    return res.returncode == 0


def build_host(name: str) -> Path:
    """Compile the host source csrc/<name>.cpp with the C++ compiler and
    CXX_LIBS unless its library exists; returns the library path."""
    compiler = cxx()
    if compiler is None:
        raise RuntimeError('no C++ compiler found (set CXX)')
    src = CSRC / f'{name}.cpp'
    out = _hashed_path(name, [src], (compiler, *CXX_FLAGS, *CXX_LIBS))
    _compile(out, lambda tmp: [compiler, *CXX_FLAGS, str(src), '-o',
                               str(tmp), *CXX_LIBS])
    return out


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

"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ctypes. Builds run at
first use, all sources in parallel, into ``_build/`` beside the
package (listed in .gitignore); a library's file name carries a hash
of the sources and flags, so an edited source is rebuilt.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into an FMA:
the kernels repeat the plain versions' rounding step by step, and one
ulp in a projected coordinate flips a corner or a rounded offset.

Each library has one C entry point. Every wrapper calls ``launch``,
which adds one to the library's count in ``LAUNCHES`` and raises when
the entry point returns a CUDA error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
KERNELS = ('splat', 'coverage', 'discfill', 'bokeh', 'insmedian', 'median5',
           'laplacian', 'nms', 'maskhead', 'epilogue', 'colorize', 'compact',
           'samattn', 'discfill_exact', 'roialign', 'nms_large', 'kmeans',
           'crf', 'swinattn')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC']

# launches per kernel library since the last reset_launches()
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels need the '
                           'CUDA toolkit (set CUDA_HOME)')
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:12]}.so'


def build(names: Sequence[str] = KERNELS, verbose: bool = False
          ) -> Dict[str, float]:
    """Compile the libraries not built yet, one nvcc per source, all
    started together. Returns the wall seconds of the build (0 for a
    library already on disk). With ``verbose`` nvcc prints each
    kernel's registers and spills (-Xptxas -v)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _lib_path(n).exists()]
    t0 = time.perf_counter()
    procs: List = []
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f'.{os.getpid()}.tmp')
        cmd = [_nvcc(), *NVCC_FLAGS, *(['-Xptxas', '-v'] if verbose else []),
               '-o', str(tmp), str(CSRC / f'{n}.cu')]
        procs.append((n, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'nvcc {n}.cu failed ({proc.returncode}):\n{log}')
            continue
        if verbose and log:
            print(f'[nvcc {n}.cu]\n{log}', flush=True)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError('\n'.join(errors))
    dt = time.perf_counter() - t0
    return {n: (dt if n in todo else 0.0) for n in names}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    if name not in _libs:
        build([name])
        so = ctypes.CDLL(str(_lib_path(name)))
        so.kb_error_string.restype = ctypes.c_char_p
        so.kb_error_string.argtypes = [I]
        _libs[name] = so
    return _libs[name]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, fn: str, argtypes, *args) -> None:
    """Call entry point ``fn`` of kernel ``name``; count the launch and
    raise on a CUDA error (a refused launch never runs, so this is the
    only place it shows)."""
    so = lib(name)
    f = getattr(so, fn)
    f.restype = I
    f.argtypes = argtypes
    rc = f(*args)
    LAUNCHES[name] += 1
    if rc != 0:
        msg = so.kb_error_string(rc).decode()
        raise RuntimeError(f'CUDA kernel {name} ({fn}) failed: {rc} {msg}')


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions on ``device``."""
    if t.device != device:
        raise ValueError(f'{name} is on {t.device}, expected {device}')
    if t.dtype != dtype:
        raise TypeError(f'{name} has dtype {t.dtype}, expected {dtype}')
    if t.ndim != ndim:
        raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                         f'{ndim} dimensions')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')

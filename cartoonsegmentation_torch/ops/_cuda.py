"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ctypes. Builds run at
first use, all sources in parallel, into ``_build/`` beside the
package (listed in .gitignore); a library's file name carries a hash
of the sources and flags, so an edited source is rebuilt.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into an FMA:
the kernels repeat the plain versions' rounding step by step, and one
ulp in a projected coordinate flips a corner or a rounded offset.

Each library has one C entry point, listed with its parameter types
in ``SIGNATURES`` and bound once when the library loads. Every wrapper
calls ``launch``, which adds one to the library's count in
``LAUNCHES`` and raises when the entry point returns a CUDA error.

The launch path is kept short because a small kernel's call is mostly
host time (chip_smoke.py's [host] phase takes it apart): the entry
points are typed once, not on every call; ``stream_ptr`` reads the raw
stream handle instead of building a ``torch.cuda.Stream``; the
libraries load as ``ctypes.PyDLL``, which keeps the GIL through the
call as PyTorch's own launches do (the entry points only enqueue
work). Each library links nvcc's static CUDA runtime: ``-cudart
shared`` measured no faster.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
KERNELS = ('splat', 'coverage', 'discfill', 'bokeh', 'insmedian', 'median5',
           'laplacian', 'nms', 'maskhead', 'epilogue', 'colorize', 'compact',
           'samattn', 'discfill_exact', 'roialign', 'nms_large', 'kmeans',
           'crf', 'swinattn', 'pushpull', 'jitter', 'median3', 'dynhead_fwd',
           'dynhead_bwd')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-shared', '-Xcompiler', '-fPIC']

# the one C entry point of each library and its parameters, in order:
# p a pointer (c_void_p, the stream too: a Python int passed as c_int
# would lose its upper 32 bits), i int, q long long, f float
SIGNATURES = {
    'splat': ('kb_splat', 'ppiiiiffippppp'),
    'coverage': ('kb_coverage', 'pipiiifiipp'),
    'discfill': ('kb_discfill', 'ppiiipp'),
    'bokeh': ('kb_bokeh', 'ppiiippiffpppp'),
    'insmedian': ('kb_masked_median', 'pppiippp'),
    'median5': ('kb_median5', 'piiiipp'),
    'laplacian': ('kb_laplacian', 'piiiipp'),
    'nms': ('kb_nms', 'ppifippp'),
    'maskhead': ('kb_mask_heads', 'pppppiiiiifppp'),
    'epilogue': ('kb_frame_epilogue', 'piiqiiiiiiiiippp'),
    'colorize': ('kb_colorize', 'pqiipp'),
    'compact': ('kb_append_masked', 'pppppiiippppippp'),
    'samattn': ('kb_sam_attention', 'pppiiiiiifpp'),
    'discfill_exact': ('kb_discfill_exact', 'pppiiiipp'),
    'roialign': ('kb_roi_align', 'pppiiiiiiiiiiiipp'),
    'nms_large': ('kb_nms_large', 'ppifipppp'),
    'kmeans': ('kb_kmeans', 'piiiiippp'),
    'crf': ('kb_crf', 'pppppiiiiiiipffiiipppp'),
    'swinattn': ('kb_swin_attention', 'ppppiiiiipp'),
    'pushpull': ('kb_pushpull', 'ppiiippp'),
    'jitter': ('kb_jitter', 'pppiiippp'),
    'median3': ('kb_median3', 'piiiipp'),
    'dynhead_fwd': ('kb_dynhead_fwd', 'ppppiiiiipp'),
    'dynhead_bwd': ('kb_dynhead_bwd', 'pppppiiiiipppp'),
}
CTYPES = {'p': ctypes.c_void_p, 'i': ctypes.c_int, 'q': ctypes.c_longlong,
          'f': ctypes.c_float}

# shared memory one block may take on the H100 (227 KB), which the
# tiled kernels (splat, bokeh, coverage) size their blocks against
SMEM_BYTES = 232448

# constants of csrc/coverage.cu and csrc/colorize.cu that their launch
# plans (ops/pointcloud.py:coverage_plan, pipeline/depth.py:
# colorize_plan) size against; the sources point here
# coverage.cu: threads a block, points a thread a tile, candidates a
# block at most; its fixed shared memory: two mbarriers' 16 bytes and
# two tiles of (x, y, z) (dynamic), the group's shifts and per-warp
# counts (static)
COVER_THREADS = 1024
COVER_PER_THREAD = 4
COVER_MAX_GROUP = 8
COVER_TILES_BYTES = 16 + 2 * 12 * COVER_THREADS * COVER_PER_THREAD
COVER_STATIC_BYTES = 4 * 3 * COVER_MAX_GROUP + 4 * 32 * COVER_MAX_GROUP
# colorize.cu: threads a block; blocks an SM the plan asks for (the
# kernel takes fewer if the card holds fewer at once)
COLORIZE_THREADS = 512
COLORIZE_BLOCKS_PER_SM = 2

# launches per kernel library since the last reset_launches()
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}

_libs: Dict[str, ctypes.PyDLL] = {}
# each library's entry point, bound (argtypes, restype) when it loads
_entries: Dict[str, Callable] = {}


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


def lib(name: str) -> ctypes.PyDLL:
    """The loaded library of kernel ``name``, built on first use; its
    entry point is bound then."""
    if name not in _libs:
        build([name])
        so = ctypes.PyDLL(str(_lib_path(name)))
        so.kb_error_string.restype = ctypes.c_char_p
        so.kb_error_string.argtypes = [ctypes.c_int]
        fn, params = SIGNATURES[name]
        f = getattr(so, fn)
        f.restype = ctypes.c_int
        f.argtypes = [CTYPES[c] for c in params]
        _libs[name], _entries[name] = so, f
    return _libs[name]


def stream_ptr(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


_sm_counts: Dict[int, int] = {}


def sm_count(t: torch.Tensor) -> int:
    """The streaming multiprocessors of ``t``'s card (read once a card)."""
    i = t.get_device()
    n = _sm_counts.get(i)
    if n is None:
        n = _sm_counts[i] = torch.cuda.get_device_properties(
            i).multi_processor_count
    return n


def launch(name: str, *args) -> None:
    """Call the entry point of kernel ``name`` with ``args`` (typed by
    ``SIGNATURES``); count the launch and raise on a CUDA error (a
    refused launch never runs, so this is the only place it shows)."""
    f = _entries.get(name)
    if f is None:
        lib(name)
        f = _entries[name]
    rc = f(*args)
    LAUNCHES[name] += 1
    if rc != 0:
        msg = _libs[name].kb_error_string(rc).decode()
        raise RuntimeError(f'CUDA kernel {name} ({SIGNATURES[name][0]}) '
                           f'failed: {rc} {msg}')


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

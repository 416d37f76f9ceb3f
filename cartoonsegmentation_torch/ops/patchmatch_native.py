"""ctypes binding of the repository's host C++ PatchMatch inpainting
(port of ``cartoonsegmentation_tpu/ops/patchmatch_native.py``).

``csrc/patchmatch.cpp`` (at the repository's root) is compiled at first
use with g++ into ``_build/`` beside the package, with the JAX
package's flags, so both packages run the same machine code on one
host. The library's file name carries a hash of the source and the
flags: an edited source is rebuilt. A failed build raises with g++'s
error output. This is host code: ``inpaint`` takes and returns numpy
arrays, and the Ken Burns pipeline's ``inpaint_type: patchmatch`` moves
its image to the host and back around it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.logger import LOGGER

SRC = Path(__file__).resolve().parent.parent.parent / 'csrc' / 'patchmatch.cpp'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
GXX_FLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-std=c++17']

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + ' '.join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'libpatchmatch_inpaint_{digest[:12]}.so'


def build_library(force: bool = False) -> Path:
    """Compile csrc/patchmatch.cpp unless its library is built; the
    library's path. Raises RuntimeError with g++'s output on failure."""
    lib = library_path()
    if lib.exists() and not force:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, renamed into place: concurrent builds never load a
    # half-written file
    tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', *GXX_FLAGS, str(SRC), '-o', str(tmp)]
    LOGGER.info('building patchmatch: %s', ' '.join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'cannot run g++ to build {SRC}: {e}') from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed to build {SRC} (exit '
                           f'{proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.pm_inpaint.argtypes = [
                _U8P, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_uint64, _U8P]
            lib.pm_inpaint.restype = None
            lib.pm_inpaint_regularity.argtypes = [
                _U8P, _U8P, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_uint64,
                _U8P]
            lib.pm_inpaint_regularity.restype = None
            _lib = lib
    return _lib


def _prepare(image: np.ndarray, mask: np.ndarray):
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    mask = np.ascontiguousarray((np.asarray(mask) > 0).astype(np.uint8))
    return image, mask, np.empty_like(image)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def inpaint(image: np.ndarray, mask: np.ndarray, patch_size: int = 3,
            iterations: int = 4, seed: int = 1234) -> np.ndarray:
    """uint8 image (H, W, C) or (H, W) and mask (H, W) (> 0 = hole) →
    the inpainted uint8 image of the same shape."""
    lib = _load()
    image, mask, out = _prepare(image, mask)
    h, w, c = image.shape
    lib.pm_inpaint(_u8(image), _u8(mask), h, w, c, patch_size, iterations,
                   seed, _u8(out))
    return out if c > 1 else out[..., 0]


def inpaint_regularity(image: np.ndarray, mask: np.ndarray,
                       ijmap: np.ndarray, patch_size: int = 15,
                       guide_weight: float = 0.25, iterations: int = 4,
                       seed: int = 1234) -> np.ndarray:
    """The guided variant: a float32 (H, W, G) guide map joins the patch
    distance with weight ``guide_weight``."""
    lib = _load()
    if ijmap.ndim != 3 or ijmap.dtype != np.float32:
        raise ValueError('ijmap must be float32 (H, W, G)')
    ijmap = np.ascontiguousarray(ijmap)
    image, mask, out = _prepare(image, mask)
    h, w, c = image.shape
    lib.pm_inpaint_regularity(
        _u8(image), _u8(mask), ijmap.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)),
        h, w, c, ijmap.shape[2], patch_size, iterations, guide_weight, seed,
        _u8(out))
    return out if c > 1 else out[..., 0]

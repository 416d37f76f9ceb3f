"""Depth-of-field bokeh (K4): port of
``cartoonsegmentation_tpu/ops/bokeh.py`` (``bokeh_weight_field``,
``bokeh_blur`` through ``_bokeh_core``).

Three chained 32-sample directional passes (vertical, −30°, −150°) on
pow(img, lightness), the mean of the last two, then the inverse pow.
Sample s of a pass lands at offset cround(w·coef_s), w the blur weight
at the pixel, and is weighted by the weight at the sample.

- ``bokeh_core_plain``: the (S, H, W) gather form of the JAX package's
  ``_bokeh_pass_gather`` spec.
- ``csrc/bokeh.cu``: a block per 32x16 output tile per pass, its
  samples read from the tile and the pass's halo (``_halo``) in shared
  memory; the global path where they do not fit (``_tiled``). The
  wrapper ``bokeh_core`` picks by device.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda

_SCALE = 0.0005  # reference effects.py:163
# pass directions (dx, dy): vertical, -30 deg, -150 deg
_DIRS = ((0.0, 1.0),
         (math.cos(-math.pi / 6), math.sin(-math.pi / 6)),
         (math.cos(-math.pi * 5 / 6), math.sin(-math.pi * 5 / 6)))


def _dir_coefs(dx: float, dy: float, H: int, W: int,
               num_samples: int) -> np.ndarray:
    """(2, S) f32 per-sample offset coefficients of a pass in direction
    (dx, dy): f32(double(d)·m·min(H, W)) for m = s − S//2, as the JAX
    package's _pass_table builds them (negative m is the exact
    negation)."""
    im_size = min(H, W)
    offset = num_samples // 2
    out = np.zeros((2, num_samples), np.float32)
    for s in range(num_samples):
        m = s - offset
        for a, d in enumerate((dx, dy)):
            out[a, s] = np.sign(m) * np.float32(np.float64(d)
                                                * (abs(m) * im_size))
    return out


@functools.lru_cache(maxsize=16)
def _coefs(H: int, W: int, num_samples: int) -> np.ndarray:
    """(3, 2, S) f32 coefficients of the three passes (``_dir_coefs``)."""
    return np.stack([_dir_coefs(dx, dy, H, W, num_samples)
                     for dx, dy in _DIRS])


_TILE_W, _TILE_H = 32, 16  # the kernel's tile (csrc/bokeh.cu)


@functools.lru_cache(maxsize=16)
def _halo(H: int, W: int, num_samples: int) -> np.ndarray:
    """(3, 2) int32: the largest |offset| in x and in y that each pass
    can take, cround(f32(5e-4)·|coef|) over its samples, in the
    kernel's f32 arithmetic (the clipped weight is at most 5e-4 and the
    rounding is monotone in it)."""
    x = np.abs(_coefs(H, W, num_samples)) * np.float32(_SCALE)
    return np.floor(x + np.float32(0.5)).max(-1).astype(np.int32)


@functools.lru_cache(maxsize=16)
def _tile_bytes(H: int, W: int, num_samples: int) -> int:
    """Shared memory of the largest pass's tile with its halo, 16 bytes
    a pixel."""
    h = _halo(H, W, num_samples).astype(np.int64)
    return int((16 * (_TILE_W + 2 * h[:, 0]) * (_TILE_H + 2 * h[:, 1])).max())


def _tiled(H: int, W: int, num_samples: int) -> bool:
    """True when every pass's tile with its halo fits one block's shared
    memory; else the kernel takes its global path."""
    return _tile_bytes(H, W, num_samples) <= _cuda.SMEM_BYTES


def _cround(v: torch.Tensor) -> torch.Tensor:
    """C round() (half away from zero) to int64."""
    return (torch.sign(v) * torch.floor(v.abs() + 0.5)).long()


def _pass_gather(src: torch.Tensor, weight: torch.Tensor, cx: torch.Tensor,
                 cy: torch.Tensor) -> torch.Tensor:
    """One directional pass, (S, H, W) gather form. src (H, W, 3),
    weight (H, W), cx/cy (S,) f32 coefficients."""
    H, W = weight.shape
    dev = weight.device
    py = torch.arange(H, device=dev)[None, :, None]
    px = torch.arange(W, device=dev)[None, None, :]
    qx = px + _cround(weight[None] * cx[:, None, None])
    qy = py + _cround(weight[None] * cy[:, None, None])
    inb = (qx >= 0) & (qx < W) & (qy >= 0) & (qy < H)
    q = qy.clamp(0, H - 1) * W + qx.clamp(0, W - 1)
    w = torch.where(inb, weight.reshape(-1)[q], 0.0)           # (S,H,W)
    wsum = w.sum(0)
    color = (w[..., None] * src.reshape(-1, src.shape[-1])[q]).sum(0)
    out = color / wsum.clamp(min=1e-30)[..., None]
    return torch.where((wsum != 0.0)[..., None], out, src)


def bokeh_pass(img: torch.Tensor, depth: torch.Tensor, dx: float, dy: float,
               num_samples: int = 32, max_weight: float = _SCALE
               ) -> torch.Tensor:
    """One directional pass of the JAX package's ``bokeh_pass``: img
    (H, W, C), depth (H, W) the blur weight, clipped to [0,
    max_weight]. K4 runs the three passes of ``bokeh_core`` in one
    launch and takes no lone pass, so this is plain PyTorch on the CPU,
    and a CUDA tensor raises."""
    if img.device.type != 'cpu':
        raise NotImplementedError(
            'bokeh_pass has no CUDA kernel of its own: bokeh_core (K4) '
            'runs the three passes of the bokeh in one launch')
    H, W = depth.shape
    co = torch.from_numpy(_dir_coefs(float(dx), float(dy), H, W,
                                     num_samples))
    return _pass_gather(img, depth.clamp(0.0, max_weight), co[0], co[1])


def bokeh_core_plain(img01: torch.Tensor, weight: torch.Tensor,
                     lightness_factor: float, num_samples: int
                     ) -> torch.Tensor:
    """Plain version of K4 (JAX _bokeh_core): img01 (H, W, 3), weight
    (H, W) → (H, W, 3) before the final clip."""
    H, W = weight.shape
    co = torch.from_numpy(_coefs(H, W, num_samples)).to(weight.device)
    lf = float(lightness_factor)
    hi = torch.pow(img01.clamp(min=0.0), lf)
    weight = weight.clamp(0.0, _SCALE)
    vert = _pass_gather(hi, weight, co[0, 0], co[0, 1])
    diag = _pass_gather(vert, weight, co[1, 0], co[1, 1])
    rhom = _pass_gather(diag, weight, co[2, 0], co[2, 1])
    return torch.pow((diag + rhom) / 2.0, 1.0 / lf)


def bokeh_core(img01: torch.Tensor, weight: torch.Tensor,
               lightness_factor: float, num_samples: int) -> torch.Tensor:
    """K4 wrapper: the plain version on the CPU, csrc/bokeh.cu on CUDA.
    img01 (H, W, 3) f32, weight (H, W) f32 → (H, W, 3)."""
    if img01.device.type == 'cpu':
        return bokeh_core_plain(img01, weight, lightness_factor,
                                num_samples)
    dev = img01.device
    img01 = img01.contiguous()
    weight = weight.contiguous()
    _cuda.check(img01, 'img01', torch.float32, 3, dev)
    _cuda.check(weight, 'weight', torch.float32, 2, dev)
    H, W, C = img01.shape
    if C != 3 or weight.shape != (H, W):
        raise ValueError(f'bokeh needs img (H, W, 3) and weight (H, W), '
                         f'got {tuple(img01.shape)}, {tuple(weight.shape)}')
    if not 1 <= num_samples <= 64:
        raise ValueError(f'bokeh takes 1 to 64 samples, got {num_samples}')
    co = np.ascontiguousarray(_coefs(H, W, num_samples))
    halo = np.ascontiguousarray(_halo(H, W, num_samples))
    vert = torch.empty_like(img01)
    diag = torch.empty_like(img01)
    out = torch.empty_like(img01)
    lf = float(lightness_factor)
    _cuda.launch('bokeh',
                 img01.data_ptr(), weight.data_ptr(), H, W, num_samples,
                 co.ctypes.data, halo.ctypes.data,
                 int(_tiled(H, W, num_samples)), lf, 1.0 / lf,
                 vert.data_ptr(), diag.data_ptr(), out.data_ptr(),
                 _cuda.stream_ptr(img01))
    return out


def bokeh_weight_field(depth: torch.Tensor, depth_factor: float = 2.0,
                       focal_plane=None) -> torch.Tensor:
    """Depth → per-pixel blur weight in [0, 5e-4]: remap around the
    focal plane, power curve, normalise, invert, scale
    (parity: effects.py:147-164)."""
    d = depth.float()
    if focal_plane is not None:
        d = d.max() - (d - focal_plane).abs()
    if depth_factor != 1:
        d = torch.pow(d.clamp(min=0.0), depth_factor)
    d = d - d.min()
    d = d / d.max().clamp(min=1e-12)
    return (1.0 - d) * _SCALE


def bokeh_blur(img: torch.Tensor, depth: torch.Tensor, num_samples: int = 32,
               lightness_factor: float = 10.0, depth_factor: float = 2.0,
               focal_plane=None) -> torch.Tensor:
    """Full hexagonal bokeh: img (H, W, 3) f32 in [0, 1], depth (H, W)
    → (H, W, 3) in [0, 1]. Parity: effects.py:143-181."""
    weight = bokeh_weight_field(depth, depth_factor, focal_plane)
    return bokeh_core(img, weight, float(lightness_factor),
                      num_samples).clamp(0.0, 1.0)

"""Spatial filters (port of ``cartoonsegmentation_tpu/ops/filters.py``):
the asymmetric laplacian validity filter and the 5x5 and 3x3 medians
(K7), and ``spatial_filter``, the reference's string dispatch.

Layout (..., H, W, C), channel-last as in the JAX package.

- ``laplacian_filter_plain`` / ``median_filter_plain``: the JAX
  versions' formulation in plain PyTorch (shifted copies; a sort over
  the 25 or 9 taps, NaN last as in JAX's order).
- ``csrc/laplacian.cu``: a shared-memory tile with its halo and one
  thread a pixel. ``csrc/median5.cu``: the tile as order keys (NaN
  above +inf), a thread 8 outputs down a column, each window row
  sorted once and shared rows merged once for two outputs.
  ``csrc/median3.cu``: a thread an output, its 9 taps as the same order
  keys through a median-of-9 network. The
  wrappers ``laplacian_filter`` and ``median_filter`` pick by device;
  the results are exact against the plain versions (the medians'
  NaNs where the plain version's are; the sign of a zero output may
  differ).
"""
from __future__ import annotations

import math

import torch

from . import _cuda


def _index(n: int, d: int, mode: str, device) -> torch.Tensor:
    i = torch.arange(n, device=device) + d
    if mode == 'edge':
        return i.clamp(0, n - 1)
    i = torch.where(i < 0, -i, i)                   # reflect
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _shift2d(x: torch.Tensor, dy: int, dx: int, mode: str) -> torch.Tensor:
    """out[y, x] = in[y+dy, x+dx] with 'edge' (replicate) or 'reflect'
    boundary handling. x: (..., H, W, C)."""
    H, W = x.shape[-3], x.shape[-2]
    x = x.index_select(-3, _index(H, dy, mode, x.device))
    return x.index_select(-2, _index(W, dx, mode, x.device))


def laplacian_filter_plain(x: torch.Tensor) -> torch.Tensor:
    """out = 4·in[y,x] − in[y−1,x] − in[y−1,x+1] − in[y,x−1]
    − in[y+1,x−1], replicate padding (reference models/utils.py:13-24).
    """
    return (4.0 * x
            - _shift2d(x, -1, 0, 'edge')
            - _shift2d(x, -1, 1, 'edge')
            - _shift2d(x, 0, -1, 'edge')
            - _shift2d(x, 1, -1, 'edge'))


def median_filter_plain(x: torch.Tensor, size: int) -> torch.Tensor:
    """size x size median with reflect padding (size odd)."""
    if size % 2 != 1:
        raise ValueError(f'median size must be odd, got {size}')
    r = size // 2
    taps = torch.stack([_shift2d(x, dy, dx, 'reflect')
                        for dy in range(-r, r + 1)
                        for dx in range(-r, r + 1)], -1)
    return taps.sort(-1).values[..., (size * size) // 2]


def _launch_stencil(name: str, x: torch.Tensor) -> torch.Tensor:
    """Run the stencil of csrc/{name}.cu on (..., H, W, C) f32: the
    leading dimensions are one batch of a contiguous buffer, so no
    reshape is made (each costs the host ~2 µs a call)."""
    if x.ndim < 3:
        raise ValueError(f'expected (..., H, W, C), got {tuple(x.shape)}')
    H, W, C = x.shape[-3:]
    if H < 3 or W < 3:
        raise ValueError(f'the CUDA stencils need H, W >= 3, got {H}x{W}')
    x = x.contiguous()
    _cuda.check(x, 'x', torch.float32, x.ndim, x.device)
    out = torch.empty_like(x)
    _cuda.launch(name, x.data_ptr(), math.prod(x.shape[:-3]), H, W, C,
                 out.data_ptr(), _cuda.stream_ptr(x))
    return out


def laplacian_filter(x: torch.Tensor) -> torch.Tensor:
    """K7 wrapper: the plain version on the CPU, csrc/laplacian.cu on
    CUDA. x (..., H, W, C) f32."""
    if x.device.type == 'cpu':
        return laplacian_filter_plain(x)
    return _launch_stencil('laplacian', x)


def median_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """K7 wrapper: the plain version on the CPU; on CUDA csrc/median5.cu
    at size 5 (the Inpaint net's) and csrc/median3.cu at size 3, the
    sizes the reference's ``spatial_filter`` takes. x (..., H, W, C)
    f32."""
    if x.device.type == 'cpu':
        return median_filter_plain(x, size)
    if size not in (3, 5):
        raise ValueError(f'the CUDA median takes size 3 or 5, got {size}')
    return _launch_stencil(f'median{size}', x)


def spatial_filter(x: torch.Tensor, kind: str) -> torch.Tensor:
    """'laplacian', 'median-3' or 'median-5' on (..., H, W, C) (the
    reference's string API)."""
    if kind == 'laplacian':
        return laplacian_filter(x)
    if kind in ('median-3', 'median-5'):
        return median_filter(x, int(kind[-1]))
    raise ValueError(f'unknown spatial filter: {kind}')


def valid_depth_mask(disparity: torch.Tensor,
                     thr: float = 0.03) -> torch.Tensor:
    """|laplacian(disparity / max)| < thr, as the input's dtype."""
    norm = disparity / (disparity.max() + 1e-12)
    return (laplacian_filter(norm).abs() < thr).to(disparity.dtype)

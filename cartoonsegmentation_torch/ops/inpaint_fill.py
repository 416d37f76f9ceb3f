"""Hole filling of the style flow's background (port of
``cartoonsegmentation_tpu/ops/inpaint_fill.py``, K13).

1. **push–pull** (K13a): validity-weighted 2x2 sums down to one pixel,
   then back up, each level blending its own normalised colour with
   the bilinear upsample of the coarser one; hole pixels take the
   result.
2. **jitter refine** (K13b): each hole pixel tries a source pixel at
   a random offset of each radius 4, 8, 16 and 32, and keeps the one
   whose 8-neighbour ring best matches its own (SSD); two iterations.

Layout (H, W, C) f32 with an (H, W) bool hole, as in the JAX package.

- ``push_pull_fill_plain`` / ``jitter_refine_plain``: the JAX
  versions' formulation in plain PyTorch, with the sums in a fixed
  order (the 2x2 sum as (0,0) + (0,1) + (1,0) + (1,1); the ring SSD
  tap by tap, channel by channel) that the kernels repeat. The
  upsample is ``jax.image.resize`` 'linear' for a size step up:
  half-pixel centres with clamped edges.
- ``csrc/pushpull.cu``, ``csrc/jitter.cu``: one entry point each;
  ``push_pull_fill`` and ``jitter_refine`` pick by device.

The random offsets: the JAX refine draws them inside with
``jax.random`` (threefry), which the port cannot reproduce without
JAX. Here ``jitter_offsets`` draws them on the given device from a
counter-based integer hash of (seed, iteration, radius, plane, pixel),
in torch integer ops that give the same bits on the CPU and on CUDA,
and ``jitter_refine`` takes them as an argument; the port's fill
differs from JAX's by the draws alone, and the tests hold it to JAX by
feeding it JAX's draws.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import _cuda

RADII = (4, 8, 16, 32)                     # each twice the one before
_TINY = 1e-8


def fill_levels(h: int, w: int, levels: int = 0) -> List[Tuple[int, int]]:
    """Sizes of the pyramid's levels 0..levels (each the ceil half of
    the one before); levels <= 0 means ⌈log2 max(h, w)⌉."""
    if levels <= 0:
        levels = int(math.ceil(math.log2(max(h, w)))) if max(h, w) > 1 else 0
    sizes = [(h, w)]
    for _ in range(levels):
        ph, pw = sizes[-1]
        sizes.append(((ph + 1) // 2, (pw + 1) // 2))
    return sizes


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 sums of (h, w, C) with zero padding to even sizes."""
    h, w = x.shape[:2]
    x = torch.nn.functional.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    return (x[0::2, 0::2] + x[0::2, 1::2]) + x[1::2, 0::2] + x[1::2, 1::2]


def _taps(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, ...]:
    """Half-pixel linear taps of a size step n_in → n_out: index pair
    and their weights, in f32 as the kernel computes them."""
    scale = torch.tensor(n_in / n_out, dtype=torch.float32)
    d = torch.arange(n_out, dtype=torch.float32)
    src = ((d + 0.5) * scale - 0.5).clamp(min=0.0)
    i0 = src.floor().to(torch.int64).clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    l1 = src - i0.to(torch.float32)
    l0 = 1.0 - l1
    return tuple(t.to(device) for t in (i0, i1, l0, l1))


def _upsample_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear (h', w', C) → (h, w, C) with h >= h', w >= w':
    ly0·(lx0·a00 + lx1·a01) + ly1·(lx0·a10 + lx1·a11)."""
    y0, y1, ly0, ly1 = _taps(x.shape[0], h, x.device)
    x0, x1, lx0, lx1 = _taps(x.shape[1], w, x.device)
    r0, r1 = x[y0], x[y1]
    lx0, lx1 = lx0[None, :, None], lx1[None, :, None]
    top = lx0 * r0[:, x0] + lx1 * r0[:, x1]
    bot = lx0 * r1[:, x0] + lx1 * r1[:, x1]
    return ly0[:, None, None] * top + ly1[:, None, None] * bot


def push_pull_fill_plain(image: torch.Tensor, hole: torch.Tensor,
                         levels: int = 0) -> torch.Tensor:
    """K13a's plain version; image (H, W, C) f32, hole (H, W) bool."""
    H, W, C = image.shape
    sizes = fill_levels(H, W, levels)
    w0 = (~hole).to(image.dtype)[..., None]
    pyr = [torch.cat([image * w0, w0], -1)]
    for _ in range(len(sizes) - 1):
        pyr.append(_downsample2(pyr[-1]))
    top = pyr[-1]
    filled = top[..., :C] / top[..., C:].clamp(min=_TINY)
    for lv in range(len(pyr) - 2, -1, -1):
        cur = pyr[lv]
        up = _upsample_to(filled, cur.shape[0], cur.shape[1])
        wgt = cur[..., C:].clamp(0.0, 1.0)
        col = cur[..., :C] / cur[..., C:].clamp(min=_TINY)
        filled = col * wgt + up * (1.0 - wgt)
    return torch.where(hole[..., None], filled, image)


def _check_fill_args(image: torch.Tensor, hole: torch.Tensor) -> None:
    if image.ndim != 3 or tuple(hole.shape) != tuple(image.shape[:2]):
        raise ValueError(f'expected image (H, W, C) and hole (H, W), got '
                         f'{tuple(image.shape)} and {tuple(hole.shape)}')


def push_pull_fill(image: torch.Tensor, hole: torch.Tensor,
                   levels: int = 0) -> torch.Tensor:
    """K13a wrapper: the plain version on the CPU, csrc/pushpull.cu on
    CUDA (C = 3; one call runs every level). image (H, W, C) f32, hole
    (H, W) bool."""
    _check_fill_args(image, hole)
    if image.device.type == 'cpu':
        return push_pull_fill_plain(image, hole, levels)
    H, W, C = image.shape
    if C != 3:
        raise ValueError(f'the CUDA push-pull takes C = 3, got {C}')
    dev = image.device
    image = image.contiguous()
    hole = hole.contiguous()
    _cuda.check(image, 'image', torch.float32, 3, dev)
    _cuda.check(hole, 'hole', torch.bool, 2, dev)
    sizes = fill_levels(H, W, levels)
    # levels 1..L, 4 floats a pixel, one after the other
    scratch = torch.empty(4 * sum(h * w for h, w in sizes[1:]),
                          dtype=torch.float32, device=dev)
    out = torch.empty_like(image)
    _cuda.launch('pushpull',
                 image.data_ptr(), hole.data_ptr(), H, W, len(sizes) - 1,
                 scratch.data_ptr(), out.data_ptr(), _cuda.stream_ptr(image))
    return out


_MASK32 = 0xffffffff


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) (an int or an int64 tensor)
    and a 32-bit constant c, in two 16-bit halves of c so that no
    product leaves int64 (each is below 2^48)."""
    return (x * (c & 0xffff) + (((x * (c >> 16)) & 0xffff) << 16)) & _MASK32


def _mix32(x):
    """A 32-bit integer hash (the lowbias32 finaliser): x in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    return x ^ (x >> 16)


def jitter_offsets(h: int, w: int, seed: int = 0, iters: int = 2,
                   device=None) -> torch.Tensor:
    """(iters, 4, 2, h, w) int32 offsets in [-r, r] for the radii 4, 8,
    16, 32, drawn on ``device`` (the CPU unless given). Plane s =
    (iteration * 4 + radius) * 2 + (0 for dy, 1 for dx) takes the key
    k_s = mix(mix(seed) ^ mix(s + 1)); pixel p draws v = mix(p ^ k_s),
    a 32-bit value mapped to (v * (2r + 1)) >> 32, less r. Integer ops
    only, every product below 2^48, so the CPU and CUDA give the same
    bits."""
    dev = torch.device('cpu') if device is None else torch.device(device)
    n = len(RADII)
    # the planes' keys and radii made on the device: no host copy
    s = torch.arange(iters * n * 2, dtype=torch.int64, device=dev)[:, None]
    k = _mix32(_mix32(s + 1) ^ _mix32((seed ^ (seed >> 32)) & _MASK32))
    r = RADII[0] << ((s // 2) % n)
    p = torch.arange(h * w, dtype=torch.int64, device=dev)[None, :]
    off = ((_mix32(p ^ k) * (2 * r + 1)) >> 32) - r
    return off.to(torch.int32).reshape(iters, n, 2, h, w)


def _ring(img: torch.Tensor) -> torch.Tensor:
    """(8, H, W, C): the 8 neighbours of each pixel, edges replicated,
    in the order dy, dx = -1..1 without the centre."""
    H, W = img.shape[:2]
    pad = torch.nn.functional.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1),
                                  mode='replicate')[0].permute(1, 2, 0)
    return torch.stack([pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dy or dx], 0)


def jitter_refine_plain(image: torch.Tensor, hole: torch.Tensor,
                        offsets: torch.Tensor,
                        iters: int = 2) -> torch.Tensor:
    """K13b's plain version; offsets (iters, 4, 2, H, W) int32."""
    H, W, C = image.shape
    dev = image.device
    py = torch.arange(H, device=dev)[:, None]
    px = torch.arange(W, device=dev)[None, :]
    offsets = offsets.to(dev, torch.int64)
    out = image
    for it in range(iters):
        cur_ring = _ring(out)
        best_cost = torch.full((H, W), math.inf, device=dev)
        best = out
        for ri in range(len(RADII)):
            off = offsets[it, ri]
            qy = (py + off[0]).clamp(0, H - 1)
            qx = (px + off[1]).clamp(0, W - 1)
            ok = ~hole[qy, qx]
            cand = out[qy, qx]
            d = cur_ring[:, qy, qx] - cur_ring
            d = d * d
            cost = d[0, ..., 0]
            for t in range(8):
                for c in range(C):
                    if t or c:
                        cost = cost + d[t, ..., c]
            cost = torch.where(ok, cost, math.inf)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best = torch.where(better[..., None], cand, best)
        out = torch.where((hole & torch.isfinite(best_cost))[..., None],
                          best, out)
    return out


def jitter_refine(image: torch.Tensor, hole: torch.Tensor,
                  offsets: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """K13b wrapper: the plain version on the CPU, csrc/jitter.cu on
    CUDA (C = 3; one launch an iteration). offsets (iters, 4, 2, H, W)
    int32 from ``jitter_offsets``, on the image's device."""
    _check_fill_args(image, hole)
    H, W, C = image.shape
    if tuple(offsets.shape) != (iters, len(RADII), 2, H, W):
        raise ValueError(f'offsets are {tuple(offsets.shape)}, expected '
                         f'{(iters, len(RADII), 2, H, W)}')
    if image.device.type == 'cpu':
        return jitter_refine_plain(image, hole, offsets, iters)
    if C != 3:
        raise ValueError(f'the CUDA jitter refine takes C = 3, got {C}')
    dev = image.device
    image = image.contiguous()
    hole = hole.contiguous()
    offsets = offsets.contiguous()
    _cuda.check(image, 'image', torch.float32, 3, dev)
    _cuda.check(hole, 'hole', torch.bool, 2, dev)
    _cuda.check(offsets, 'offsets', torch.int32, 5, dev)
    out = torch.empty_like(image)
    scratch = torch.empty_like(image) if iters > 1 else out
    _cuda.launch('jitter',
                 image.data_ptr(), hole.data_ptr(), offsets.data_ptr(), H, W,
                 iters, scratch.data_ptr(), out.data_ptr(),
                 _cuda.stream_ptr(image))
    return out


def inpaint(image: np.ndarray, mask: np.ndarray, patch_size: int = 3,
            refine: bool = True,
            device: Optional[torch.device] = None) -> np.ndarray:
    """uint8 BGR image + uint8/bool mask (> 0 = hole) → uint8 BGR, on
    ``device`` (CUDA unless given), the jitter offsets drawn there too.
    ``patch_size`` is the reference PatchMatch's argument, kept for its
    callers; the ring is 3x3."""
    dev = resolve_device(device)
    img = torch.from_numpy(image.astype(np.float32) / 255.0).to(dev)
    hole = torch.from_numpy(np.asarray(mask) > 0).to(dev)
    out = push_pull_fill(img, hole)
    if refine:
        h, w = hole.shape
        out = jitter_refine(out, hole, jitter_offsets(h, w, device=dev))
    return (out.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()

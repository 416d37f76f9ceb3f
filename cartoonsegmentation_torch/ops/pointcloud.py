"""Point-cloud forward splat (K1) and autozoom coverage counts (K2).

Port of ``cartoonsegmentation_tpu/ops/pointcloud.py``. Each kernel has
two versions behind one wrapper:

- a plain PyTorch version (``*_plain``), which the wrapper runs for a
  tensor on the CPU, and which the tests hold against the JAX package;
- a hand-written CUDA kernel (``csrc/splat.cu``: per-tile sums in
  shared memory, channel chunks from ``splat_plan``;
  ``csrc/coverage.cu``: per-block bitmaps in shared memory, groups and
  bands from ``coverage_plan``),
  which the wrapper launches for a CUDA tensor. There is no fallback:
  on a CUDA tensor the kernel runs or the wrapper raises.

Layout as in the JAX package: points (P, 3) camera-space xyz (invalid
slots have z < 0.001), payload (P, C) channel-last, outputs (H, W, C).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _cuda

BIG = 1000000.0  # z-buffer init (reference models/utils.py:59)


def true_div(num, den) -> torch.Tensor:
    """``num / den`` rounded once, as JAX divides, where one side may
    be a Python float (taken as f32 of the tensor's dtype). Torch
    rounds twice in ``float / tensor`` (``reciprocal() * float``) and,
    on CUDA, in ``tensor / float`` (``tensor * (1 / float)``)."""
    like = den if torch.is_tensor(den) else num
    if not torch.is_tensor(num):
        num = like.new_full((), num)
    if not torch.is_tensor(den):
        den = like.new_full((), den)
    return torch.div(num, den)


def depth_to_points(depth: torch.Tensor, focal: float) -> torch.Tensor:
    """Unproject (H, W) or (H, W, 1) depth to (H, W, 3) xyz on a grid
    centred at u ∈ [-W/2+0.5, W/2-0.5]."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    H, W = depth.shape
    xs = true_div(torch.arange(W, dtype=depth.dtype, device=depth.device)
                  - 0.5 * W + 0.5, focal)
    ys = true_div(torch.arange(H, dtype=depth.dtype, device=depth.device)
                  - 0.5 * H + 0.5, focal)
    return torch.stack([depth * xs[None, :], depth * ys[:, None], depth],
                       -1)


def _project(points: torch.Tensor, H: int, W: int, focal, baseline):
    """(u, v, key, valid): pinhole projection and z-buffer key
    1e6 − f·b/(z + 1e-7), in the JAX package's operation order with
    f32 camera scalars (f·b is an f32 product there too)."""
    focal, baseline = np.float32(focal), np.float32(baseline)
    fb = float(focal * baseline)
    focal = float(focal)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    valid = z >= 0.001
    zs = torch.where(valid, z, torch.ones_like(z))
    u = x * focal / zs + 0.5 * W - 0.5
    v = y * focal / zs + 0.5 * H - 0.5
    key = BIG - true_div(fb, z + 1e-7)
    return u, v, key, valid


def _corners(u: torch.Tensor, v: torch.Tensor, H: int, W: int):
    """Pixel index (4, P) (H·W where out of frame), in-frame mask and
    bilinear weight of the corners NW, NE, SW, SE. The bounds test runs
    on the floats, before any int conversion."""
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = u - x0, v - y0
    cx = torch.stack([x0, x0 + 1, x0, x0 + 1])
    cy = torch.stack([y0, y0, y0 + 1, y0 + 1])
    w = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                     (1 - fx) * fy, fx * fy])
    inb = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    idx = torch.where(inb, cy * W + cx, torch.full_like(cx, H * W))
    return idx.long(), inb, w


def _nearest(u: torch.Tensor, v: torch.Tensor, H: int, W: int):
    """Flat index of the largest-weight corner (ties at 0.5 to the
    lower index) and its in-frame mask."""
    x0, y0 = torch.floor(u), torch.floor(v)
    bx = x0 + (u - x0 > 0.5).to(u.dtype)
    by = y0 + (v - y0 > 0.5).to(v.dtype)
    inb = (bx >= 0) & (bx < W) & (by >= 0) & (by < H)
    idx = torch.where(inb, by * W + bx, torch.full_like(bx, H * W))
    return idx.long(), inb


def degrid(zee: torch.Tensor) -> torch.Tensor:
    """Opposing-neighbour z-buffer smoothing, out of place
    (reference models/utils.py:152-212). zee: (H, W)."""
    H, W = zee.shape
    pad = torch.nn.functional.pad(zee, (1, 1, 1, 1), value=float('inf'))

    def shifted(dy, dx):
        return pad[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    total = torch.zeros_like(zee)
    count = torch.zeros_like(zee)
    for dy, dx in ((0, 1), (1, 0), (1, 1), (-1, 1)):
        one, two = shifted(dy, dx), shifted(-dy, -dx)
        cond = (zee >= one + 1.0) & (zee >= two + 1.0)
        total = total + torch.where(cond, one + two, 0.0)
        count = count + torch.where(cond, 2.0, 0.0)
    avg = total / count.clamp(min=1.0)
    return torch.where(count > 0, torch.minimum(zee, avg), zee)


def splat_plain(points: torch.Tensor, data: torch.Tensor, H: int, W: int,
                focal: float, baseline: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1: scatter-min z-buffer on the nearest corner,
    degrid, then a bilinear scatter-add of [data, 1]·w gated by
    key <= zref + 1. Returns (render (H,W,C), weight (H,W,1),
    zee (H,W))."""
    C = data.shape[1]
    u, v, key, valid = _project(points, H, W, focal, baseline)
    zidx, zin = _nearest(u, v, H, W)
    zidx = torch.where(zin & valid, zidx, H * W)
    zee = torch.full((H * W + 1,), BIG, dtype=points.dtype,
                     device=points.device)
    zee.scatter_reduce_(0, zidx, key, 'amin')
    zee = degrid(zee[:H * W].reshape(H, W)).reshape(-1)

    idx, inb, w = _corners(u, v, H, W)
    data1 = torch.cat([data, data.new_ones((data.shape[0], 1))], 1)
    acc = torch.zeros((H * W + 1, C + 1), dtype=data.dtype,
                      device=data.device)
    zref = torch.cat([zee, zee.new_full((1,), BIG)])
    for c in range(4):
        ok = inb[c] & valid & (key <= zref[idx[c]] + 1.0)
        acc.index_add_(0, torch.where(ok, idx[c], H * W),
                       data1 * torch.where(ok, w[c], 0.0)[:, None])
    acc = acc[:H * W].reshape(H, W, C + 1)
    weight = acc[..., C:]
    return acc[..., :C] / (weight + 1e-7), weight, zee.reshape(H, W)


TILE = 16  # csrc/splat.cu sums 16x16 output tiles


def splat_plan(H: int, W: int, C: int) -> Tuple[int, int, int]:
    """(chunk, n_tiles, smem bytes) of csrc/splat.cu for an H x W view
    of a C-channel payload: a block sums ``chunk`` channels, their
    weight and the z-buffer of one 16x16 tile in shared memory,
    256·(chunk + 2) floats; payloads wider than 225 channels are split
    into chunks of 225 (a block each), so every C fits."""
    chunk = min(C, _cuda.SMEM_BYTES // (4 * TILE * TILE) - 2)
    n_tiles = -(-H // TILE) * -(-W // TILE)
    return chunk, n_tiles, 4 * TILE * TILE * (chunk + 2)


def splat(points: torch.Tensor, data: torch.Tensor, H: int, W: int,
          focal: float, baseline: float
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 wrapper: the plain version on the CPU, csrc/splat.cu on CUDA.
    Returns (render (H,W,C), weight (H,W,1), zee (H,W))."""
    if points.device.type == 'cpu':
        return splat_plain(points, data, H, W, focal, baseline)
    dev = points.device
    _cuda.check(points, 'points', torch.float32, 2, dev)
    _cuda.check(data, 'data', torch.float32, 2, dev)
    P, C = data.shape
    if points.shape != (P, 3):
        raise ValueError(f'points {tuple(points.shape)} do not match '
                         f'data {tuple(data.shape)}')
    chunk, n_tiles, _ = splat_plan(H, W, C)
    # z-keys, tile counts, tile offsets, the tiles' point lists
    scratch = torch.empty((H * W + 2 * n_tiles + 4 * P,), dtype=torch.int32,
                          device=dev)
    zee = torch.empty((H, W), dtype=torch.float32, device=dev)
    render = torch.empty((H, W, C), dtype=torch.float32, device=dev)
    weight = torch.empty((H, W, 1), dtype=torch.float32, device=dev)
    _cuda.launch('splat',
                 points.data_ptr(), data.data_ptr(), P, C, H, W,
                 float(focal), float(baseline), chunk,
                 scratch.data_ptr(), zee.data_ptr(), render.data_ptr(),
                 weight.data_ptr(), _cuda.stream_ptr(points))
    return render, weight, zee


def render_pointcloud(points: torch.Tensor, data: torch.Tensor, H: int,
                      W: int, focal, baseline
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-splat ``data`` (P, C) carried by ``points`` (P, 3) into
    an (H, W) view: (render (H,W,C) = sum/(w + 1e-7), weight (H,W,1)).
    Accumulates in f32. Parity: reference models/utils.py:315."""
    render, weight, _ = splat(points.float().contiguous(),
                              data.float().contiguous(), H, W, float(focal),
                              float(baseline))
    return render, weight


def render_coverage(points: torch.Tensor, H: int, W: int, focal,
                    baseline) -> torch.Tensor:
    """The number of pixels a full render of ``points`` covers (weight >
    0): K1 with an empty payload (C = 0), which splats the z-buffer and
    the weight alone, so the count equals the full render's exactly.
    Parity: the JAX package's ``render_coverage``."""
    pts = points.float().contiguous()
    _, weight, _ = splat(pts, pts.new_zeros((pts.shape[0], 0)), H, W,
                         float(focal), float(baseline))
    return (weight > 0.0).sum()


def shift_points(points: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Apply a camera shift (3,) to (P, 3) points; x, y are first
    multiplied by z/(z + 1e-7) as the reference does
    (common.py:76-81)."""
    z = points[:, 2:3]
    xy = points[:, :2] * (z / (z + 1e-7))
    return torch.cat([xy, z], 1) + shift[None, :]


def coverage_plain(points: torch.Tensor, shifts: torch.Tensor, H: int,
                   W: int, focal: float, baseline: float) -> torch.Tensor:
    """Plain version of K2: for each shift (K, 3), the number of pixels
    with a positive bilinear weight sum from the shifted cloud (no
    z-test). Returns (K,) int32."""
    counts = []
    for k in range(shifts.shape[0]):
        pts = shift_points(points, shifts[k])
        u, v, _, valid = _project(pts, H, W, focal, baseline)
        idx, inb, w = _corners(u, v, H, W)
        cov = torch.zeros((H * W + 1,), dtype=points.dtype,
                          device=points.device)
        for c in range(4):
            ok = inb[c] & valid
            cov.index_add_(0, torch.where(ok, idx[c], H * W),
                           torch.where(ok, w[c], 0.0))
        counts.append((cov[:H * W] > 0).sum())
    return torch.stack(counts).to(torch.int32)


def coverage_plan(K: int, H: int, W: int, sms: int
                  ) -> Tuple[int, int, int]:
    """(G, band_rows, smem bytes) of csrc/coverage.cu for K candidates
    on an H x W raster, on a card of ``sms`` streaming multiprocessors
    (``_cuda.sm_count``). A block keeps one bitmap (a bit a pixel) of
    each of its G candidates in shared memory; G is about K / sms, so
    that ~sms blocks fill the card while each point is read once for G
    candidates, as far as G bitmaps fit beside the tiles (the kernel's
    sizes: ``_cuda.COVER_*``). A raster whose one bitmap does not fit is
    cut into bands of ``band_rows`` rows (a block a band of one
    candidate); else ``band_rows`` is H. smem is the dynamic shared
    memory of a block, as the kernel computes it."""
    tiles = _cuda.COVER_TILES_BYTES
    budget = _cuda.SMEM_BYTES - tiles - _cuda.COVER_STATIC_BYTES
    bitmap = 4 * -(-(H * W) // 32)
    if bitmap <= budget:
        G = max(1, min(_cuda.COVER_MAX_GROUP, budget // bitmap,
                       int(K / sms + 0.5)))
        band_rows = H
    else:
        G, band_rows = 1, budget // 4 * 32 // W
        if band_rows < 1:
            raise ValueError(f'coverage: a raster row of {W} pixels does '
                             f'not fit a block')
    words = -(-(band_rows * W) // 32)
    return G, band_rows, tiles + 4 * G * words


def coverage(points: torch.Tensor, shifts: torch.Tensor, H: int, W: int,
             focal: float, baseline: float) -> torch.Tensor:
    """K2 wrapper: the plain version on the CPU, csrc/coverage.cu on
    CUDA (one launch, ``coverage_plan``'s groups and bands). points
    (N, 3), shifts (K, 3) → counts (K,) int32."""
    if points.device.type == 'cpu':
        return coverage_plain(points, shifts, H, W, focal, baseline)
    dev = points.device
    _cuda.check(points, 'points', torch.float32, 2, dev)
    _cuda.check(shifts, 'shifts', torch.float32, 2, dev)
    if points.shape[1] != 3 or shifts.shape[1] != 3:
        raise ValueError('points and shifts must be (N, 3) and (K, 3)')
    N, K = points.shape[0], shifts.shape[0]
    counts = torch.empty((K,), dtype=torch.int32, device=dev)
    if K == 0 or H * W == 0:
        return counts.zero_()
    if points.data_ptr() % 16:
        points = points.clone()   # the bulk copies read 16-byte units
    G, band_rows, _ = coverage_plan(K, H, W, _cuda.sm_count(points))
    _cuda.launch('coverage',
                 points.data_ptr(), N, shifts.data_ptr(), K, H, W,
                 float(focal), G, band_rows, counts.data_ptr(),
                 _cuda.stream_ptr(points))
    return counts


# the JAX package's name of the coverage search's objective (K2; the
# port's takes the K shifts and counts each)
render_coverage_fast = coverage

__all__ = ['BIG', 'coverage', 'coverage_plain', 'coverage_plan', 'degrid',
           'depth_to_points', 'render_coverage', 'render_coverage_fast',
           'render_pointcloud', 'shift_points', 'splat', 'splat_plain',
           'splat_plan', 'true_div']

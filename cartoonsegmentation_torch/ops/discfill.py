"""Exact disocclusion fill (K11): port of
``cartoonsegmentation_tpu/ops/discfill.py:fill_disocclusion``
(``discfill_mode: exact``).

For every hole pixel (depth <= 0), rays are marched in 16 directions
both ways, at most ``max_steps`` steps each, to the first valid pixel;
leaving the frame fails the way. Where both ways of a direction find a
pixel, the direction with the shortest gap between the two wins (strict
>, the first direction keeps a tie) and the hole copies the endpoint
that is farther in depth. The step s of direction d̂ from pixel p
visits p ± round(s·d̂) with C rounding (``offset_table``, computed on
the host in float64 as the JAX package does).

- ``fill_disocclusion_plain``: the march step by step in torch over the
  hole pixels, all 16 directions at once.
- ``csrc/discfill_exact.cu``: a warp a hole pixel, its 32 lanes
  walking the 16 directions' 32 half-lines at once from a table in
  shared memory (``kernel_table``), each stopped as soon as its
  direction cannot win; the non-hole pixels a coalesced copy. The
  wrapper ``fill_disocclusion`` picks by device; both give the same
  bits.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from . import _cuda

# direction table, reference common.py:171-172 (discfill.py:_DIR_X/_DIR_Y)
_DIR_X = np.array([-1, 0, 1, 1, -1, 1, 2, 2, -2, -1, 1, 2, 3, 3, 3, 3],
                  np.float64)
_DIR_Y = np.array([1, 1, 1, 0, 2, 2, 1, -1, 3, 3, 3, 3, 2, 1, -1, -2],
                  np.float64)

_CHUNK = 16
BIG = 1000000.0
# csrc/discfill_exact.cu: the most steps it takes (its table's packed
# offsets fit 16 bits, and the table 17 KB of shared memory), and the
# words a step in its table (16 directions and a pad)
MAX_KERNEL_STEPS = 256
TABLE_ROW = 17


def _c_round(v: np.ndarray) -> np.ndarray:
    """C round(): half away from zero (np.round is half-to-even)."""
    return np.sign(v) * np.floor(np.abs(v) + 0.5)


def round_steps(max_steps: int) -> int:
    """The step count the march runs: a multiple of 16, at least 16
    (the JAX version's chunking)."""
    return max(_CHUNK, (max_steps // _CHUNK) * _CHUNK)


@functools.lru_cache(maxsize=8)
def offset_table(max_steps: int) -> np.ndarray:
    """(16, K, 2) int32 (dy, dx) offsets of the '+dir' way; the '-dir'
    way negates them. Step s visits p + round(s·d̂), d̂ the unit
    direction, in float64 (C round is odd-symmetric, so the backward
    walk is the exact negation)."""
    norm = np.sqrt(_DIR_X ** 2 + _DIR_Y ** 2)
    dx, dy = _DIR_X / norm, _DIR_Y / norm
    s = np.arange(1, max_steps + 1, dtype=np.float64)
    offx = _c_round(s[None, :] * dx[:, None]).astype(np.int32)
    offy = _c_round(s[None, :] * dy[:, None]).astype(np.int32)
    return np.stack([offy, offx], axis=-1)


@functools.lru_cache(maxsize=8)
def kernel_table(K: int) -> np.ndarray:
    """csrc/discfill_exact.cu's step table: (K, TABLE_ROW) int32, row s
    the 16 directions' offsets of step s + 1 of the '+dir' way
    (``offset_table``), each packed as dy·65536 + dx, the last word of
    a row 0 (a pad: the 32 steps of a long walk then fall in 32
    banks)."""
    offs = offset_table(K).astype(np.int64)
    tab = np.zeros((K, TABLE_ROW), np.int64)
    tab[:, :16] = (offs[..., 0] * 65536 + offs[..., 1]).T
    return tab.astype(np.int32)


def _first_hit(depth: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
               offs: torch.Tensor):
    """First event of one way for every (direction, pixel): offs (16,
    K, 2); py, px (n,). Returns (found, ey, ex, ed), each (16, n)."""
    H, W = depth.shape
    n = py.shape[0]
    active = torch.ones((16, n), dtype=torch.bool, device=depth.device)
    found = torch.zeros_like(active)
    ey = py[None].expand(16, n).clone()
    ex = px[None].expand(16, n).clone()
    ed = torch.zeros((16, n), dtype=depth.dtype, device=depth.device)
    for s in range(offs.shape[1]):
        qy = py[None] + offs[:, s, 0:1]
        qx = px[None] + offs[:, s, 1:2]
        inb = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
        d = depth[qy.clamp(0, H - 1), qx.clamp(0, W - 1)]
        hit = inb & (d > 0.0)
        upd = active & hit
        found |= upd
        ey = torch.where(upd, qy, ey)
        ex = torch.where(upd, qx, ex)
        ed = torch.where(upd, d, ed)
        active &= ~(hit | ~inb)
    return found, ey, ex, ed


def fill_disocclusion_plain(img: torch.Tensor, depth: torch.Tensor,
                            max_steps: int = 128) -> torch.Tensor:
    """Plain version of K11. img (H, W, C), depth (H, W)."""
    H, W = depth.shape
    dev = depth.device
    K = round_steps(max_steps)
    offs = torch.from_numpy(offset_table(K)).long().to(dev)
    hole = (depth <= 0.0).reshape(-1).nonzero()[:, 0]
    py, px = hole // W, hole % W
    f_from, fy, fx, fd = _first_hit(depth, py, px, -offs)
    f_to, ty, tx, td = _first_hit(depth, py, px, offs)
    ok = f_from & f_to
    dist = torch.sqrt((tx - fx).float() ** 2 + (ty - fy).float() ** 2)
    use_to = fd < td
    ny = torch.where(use_to, ty, fy)
    nx = torch.where(use_to, tx, fx)
    best_d = torch.full(py.shape, BIG, dtype=torch.float32, device=dev)
    by, bx = py, px
    for d in range(16):                      # strict: the first wins
        better = ok[d] & (best_d > dist[d])
        best_d = torch.where(better, dist[d], best_d)
        by = torch.where(better, ny[d], by)
        bx = torch.where(better, nx[d], bx)
    out = img.clone()
    out[py, px] = img[by, bx]
    return out


_tables: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def fill_disocclusion(img: torch.Tensor, depth: torch.Tensor,
                      max_steps: int = 128) -> torch.Tensor:
    """K11 wrapper: the plain version on the CPU,
    csrc/discfill_exact.cu on CUDA. img (H, W, C) f32, depth (H, W) f32
    → (H, W, C). ``max_steps`` is rounded as ``round_steps`` does."""
    if img.device.type == 'cpu':
        return fill_disocclusion_plain(img, depth, max_steps)
    dev = img.device
    img = img.contiguous()
    depth = depth.contiguous()
    _cuda.check(img, 'img', torch.float32, 3, dev)
    _cuda.check(depth, 'depth', torch.float32, 2, dev)
    H, W, C = img.shape
    if depth.shape != (H, W):
        raise ValueError(f'depth {tuple(depth.shape)} does not match img '
                         f'{tuple(img.shape)}')
    K = round_steps(max_steps)
    if K > MAX_KERNEL_STEPS:
        raise ValueError(f'max_steps {max_steps} rounds to {K}: the kernel '
                         f'takes at most {MAX_KERNEL_STEPS} steps')
    if H * W >= 2 ** 31:
        raise ValueError(f'the CUDA fill takes fewer than 2^31 pixels, got '
                         f'{H}x{W}')
    key = (K, dev)
    if key not in _tables:
        _tables[key] = torch.from_numpy(kernel_table(K)).to(dev)
    out = torch.empty_like(img)
    _cuda.launch('discfill_exact',
                 img.data_ptr(), depth.data_ptr(), _tables[key].data_ptr(), K,
                 H, W, C, out.data_ptr(), _cuda.stream_ptr(img))
    return out


def _shear_tables(H: int, W: int, dx: float, dy: float):
    """A direction with |dy| >= |dx| as a shear: off[y] = round(y·dx/dy),
    pixel (y, x) at sheared column x - off[y] + base."""
    off = _c_round(np.arange(H, dtype=np.float64) * (dx / dy)).astype(
        np.int64)
    base = int(off.max())
    return off, base, W + base - int(off.min())


def _fill_one_direction(depth: torch.Tensor, dx: float, dy: float):
    """(found, dist, fy, fx) of one direction by a shear and column
    scans, in image space (the JAX package's ``_fill_one_direction``:
    the Bresenham line x(y) = round(y·dx/dy), one cell a row)."""
    H, W = depth.shape
    dev = depth.device
    off_np, base, Wp = _shear_tables(H, W, dx, dy)
    off = torch.from_numpy(off_np).to(dev)
    xps = torch.arange(Wp, device=dev)[None, :]
    xs = xps - base + off[:, None]
    inframe = (xs >= 0) & (xs < W)
    d_s = torch.where(inframe, depth[torch.arange(H, device=dev)[:, None],
                                     xs.clamp(0, W - 1)], 0.0)
    valid = inframe & (d_s > 0.0)
    yrow = torch.arange(H, device=dev)[:, None].expand(H, Wp)
    neg = torch.full((1, Wp), -1, dtype=torch.long, device=dev)
    pos = torch.full((1, Wp), H, dtype=torch.long, device=dev)

    def last_before(m):       # the nearest event strictly above a row
        c = torch.where(m, yrow, -1).cummax(0).values
        return torch.cat([neg, c[:-1]], 0)

    def first_after(m):       # ... strictly below
        c = torch.where(m, yrow, H).flip(0).cummin(0).values.flip(0)
        return torch.cat([c[1:], pos], 0)

    lv, lo = last_before(valid), last_before(~inframe)
    fv, fo = first_after(valid), first_after(~inframe)
    up = (lv > lo, lv.clamp(0, H - 1))
    down = (fv < fo, fv.clamp(0, H - 1))
    (f_from, r_from), (f_to, r_to) = (up, down) if dy > 0 else (down, up)

    def endpoint(rows):
        return off[rows] + (xps - base), rows, d_s.gather(0, rows)

    ex_f, ey_f, ed_f = endpoint(r_from)
    ex_t, ey_t, ed_t = endpoint(r_to)
    found = f_from & f_to
    dist = torch.sqrt((ex_t - ex_f).to(depth.dtype) ** 2
                      + (ey_t - ey_f).to(depth.dtype) ** 2)
    use_to = ed_f < ed_t
    fy = torch.where(use_to, ey_t, ey_f)
    fx = torch.where(use_to, ex_t, ex_f)
    col = (torch.arange(W, device=dev)[None, :] - off[:, None] + base)
    return tuple(a.gather(1, col) for a in (found, dist, fy, fx))


def fill_disocclusion_fast(img: torch.Tensor, depth: torch.Tensor
                           ) -> torch.Tensor:
    """The JAX package's shear-scan fill: K11's policy (the shortest
    valid-to-valid gap over the 16 directions, the farther endpoint
    wins) over the whole frame, each direction's line in Bresenham form.
    No path of either package runs it; here it is plain PyTorch on the
    CPU, and a CUDA tensor raises (the paths fill with K3 or K11).
    img (H, W, C), depth (H, W)."""
    if img.device.type != 'cpu':
        raise NotImplementedError(
            'fill_disocclusion_fast has no CUDA kernel; the render paths '
            'fill with discfill3.fill_disocclusion (K3) or '
            'discfill.fill_disocclusion (K11)')
    H, W = depth.shape
    best_d = torch.full((H, W), BIG, dtype=depth.dtype)
    py, px = torch.meshgrid(torch.arange(H), torch.arange(W), indexing='ij')
    by, bx = py, px
    bfound = torch.zeros((H, W), dtype=torch.bool)
    for dx, dy in zip(_DIR_X, _DIR_Y):
        if abs(dy) >= abs(dx):
            found, dist, fy, fx = _fill_one_direction(depth, float(dx),
                                                      float(dy))
        else:     # transposed, so the line's parameter is the row
            found, dist, fx, fy = (a.T for a in _fill_one_direction(
                depth.T.contiguous(), float(dy), float(dx)))
        better = found & (best_d > dist)
        best_d = torch.where(better, dist, best_d)
        by = torch.where(better, fy, by)
        bx = torch.where(better, fx, bx)
        bfound = bfound | better
    take = (depth <= 0.0) & bfound
    return img[torch.where(take, by, py), torch.where(take, bx, px)]

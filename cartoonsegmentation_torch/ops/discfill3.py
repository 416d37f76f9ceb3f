"""Disocclusion fill (K3): port of
``cartoonsegmentation_tpu/ops/discfill3.py:fill_disocclusion_fast3``.

For every hole pixel (depth <= 0), walk 16 digital lines both ways to
the first valid pixel; the direction with the smallest squared gap
wins (strict <, first wins) and the hole copies the endpoint with the
larger depth. The digital line of direction (dx, dy) with |dy| >= |dx|
is x = x0 + off(y) − off(y0), off(y) = round(y·dx/dy) (C rounding);
the other directions walk columns with the roles swapped.

- ``fill_disocclusion_plain``: the JAX version's formulation in plain
  PyTorch — shear each direction's validity field so its lines become
  columns, find the nearest event above and below each row with two
  int ``cummax`` scans over packed (row, valid) keys, unshear.
- ``csrc/discfill.cu``: a warp a hole pixel, its 32 lanes walking the
  16 lines' 32 halves at once and stopping each as soon as its
  direction cannot win; the non-hole pixels a coalesced copy. The
  wrapper ``fill_disocclusion`` picks by device; both give the same
  bits.
"""
from __future__ import annotations

import torch

from . import _cuda

BIG = 1000000.0

# direction table, reference common.py:171-172 (discfill.py:_DIR_X/_DIR_Y)
DIR_X = (-1, 0, 1, 1, -1, 1, 2, 2, -2, -1, 1, 2, 3, 3, 3, 3)
DIR_Y = (1, 1, 1, 0, 2, 2, 1, -1, 3, 3, 3, 3, 2, 1, -1, -2)


def _off_arith(t: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """round(t·p/q) with C half-away-from-zero rounding, t >= 0."""
    if p >= 0:
        return (2 * p * t + q) // (2 * q)
    return -((2 * (-p) * t + q) // (2 * q))


def _row_shift(a: torch.Tensor, off: torch.Tensor, const: int, w_out: int,
               fill) -> torch.Tensor:
    """B[y, j] = a[y, j + const + off[y]]; out-of-range sources → fill."""
    w_in = a.shape[1]
    src = (torch.arange(w_out, device=a.device)[None, :] + const
           + off[:, None])
    ok = (src >= 0) & (src < w_in)
    b = a.gather(1, src.clamp(0, w_in - 1))
    return torch.where(ok, b, torch.full_like(b, fill))


def _direction_pass(valid_f: torch.Tensor, p: int, q: int):
    """valid_f: (H, W) {1 valid, 0 hole}, walking rows along slope p/q.
    Returns per pixel (found, dist2, y_f, x_f, y_t, x_t); 'from' is the
    walk towards decreasing rows."""
    H, W = valid_f.shape
    dev = valid_f.device
    rows = torch.arange(H, device=dev)
    off = _off_arith(rows, p, q)
    omin, omax = int(off.min()), int(off.max())
    base = omax
    wp = W + base - omin

    v_s = _row_shift(valid_f, off, -base, wp, -1.0)
    valid = v_s > 0.5
    event = valid | (v_s < 0.0)
    yrow = rows[:, None].expand(H, wp)
    vbit = valid.long()
    key_up = torch.where(event, ((yrow + 1) << 1) | vbit, 0)
    key_dn = torch.where(event, ((H - yrow) << 1) | vbit, 0)
    zero = torch.zeros((1, wp), dtype=torch.long, device=dev)
    up = torch.cat([zero, key_up.cummax(0).values[:-1]], 0)
    dn = key_dn.flip(0).cummax(0).values.flip(0)
    dn = torch.cat([dn[1:], zero], 0)

    found = (up > 0) & ((up & 1) == 1) & (dn > 0) & ((dn & 1) == 1)
    y_f = ((up >> 1) - 1).clamp(0, H - 1)
    y_t = (H - (dn >> 1)).clamp(0, H - 1)
    xp = torch.arange(wp, device=dev)[None, :]
    x_f = xp - base + _off_arith(y_f, p, q)
    x_t = xp - base + _off_arith(y_t, p, q)
    dist2 = ((x_t - x_f) ** 2 + (y_t - y_f) ** 2).float()

    def un(arr, fill):
        return _row_shift(arr, -off, base, W, fill)

    return (un(found, False), un(dist2, BIG), un(y_f, 0), un(x_f, 0),
            un(y_t, 0), un(x_t, 0))


def fill_winners_plain(depth: torch.Tensor):
    """Each pixel's winning direction, as the plain version picks it:
    its squared gap (BIG where no direction found two valid endpoints)
    and its endpoints ((y_f, x_f), (y_t, x_t)). depth (H, W)."""
    H, W = depth.shape
    valid_f = (depth > 0.0).float()
    best_d = torch.full((H, W), BIG, device=depth.device)
    zeros = torch.zeros((H, W), dtype=torch.long, device=depth.device)
    by_f = bx_f = by_t = bx_t = zeros
    for dx, dy in zip(DIR_X, DIR_Y):
        if abs(dy) >= abs(dx):
            found, d2, yf, xf, yt, xt = _direction_pass(valid_f, dx, dy)
        else:
            found, d2, xf, yf, xt, yt = _direction_pass(valid_f.T
                                                        .contiguous(),
                                                        dy, dx)
            found, d2 = found.T, d2.T
            yf, xf, yt, xt = yf.T, xf.T, yt.T, xt.T
        better = found & (best_d > d2)
        best_d = torch.where(better, d2, best_d)
        by_f = torch.where(better, yf, by_f)
        bx_f = torch.where(better, xf, bx_f)
        by_t = torch.where(better, yt, by_t)
        bx_t = torch.where(better, xt, bx_t)
    return best_d, (by_f, bx_f), (by_t, bx_t)


def fill_disocclusion_plain(img: torch.Tensor, depth: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version of K3. img (H, W, C), depth (H, W)."""
    best_d, (by_f, bx_f), (by_t, bx_t) = fill_winners_plain(depth)
    d_f = depth[by_f, bx_f]
    d_t = depth[by_t, bx_t]
    use_to = d_f < d_t
    src = torch.where(use_to[..., None], img[by_t, bx_t], img[by_f, bx_f])
    take = (depth <= 0.0) & (best_d < BIG)
    return torch.where(take[..., None], src, img)


def fill_disocclusion(img: torch.Tensor, depth: torch.Tensor
                      ) -> torch.Tensor:
    """K3 wrapper: the plain version on the CPU, csrc/discfill.cu on
    CUDA. img (H, W, C) f32, depth (H, W) f32 → (H, W, C); on CUDA
    H, W < 32768 (the kernel's squared gaps are int)."""
    if img.device.type == 'cpu':
        return fill_disocclusion_plain(img, depth)
    dev = img.device
    img = img.contiguous()
    depth = depth.contiguous()
    _cuda.check(img, 'img', torch.float32, 3, dev)
    _cuda.check(depth, 'depth', torch.float32, 2, dev)
    H, W, C = img.shape
    if depth.shape != (H, W):
        raise ValueError(f'depth {tuple(depth.shape)} does not match img '
                         f'{tuple(img.shape)}')
    if H >= 32768 or W >= 32768:
        raise ValueError(f'the CUDA fill takes H, W < 32768, got {H}x{W}')
    out = torch.empty_like(img)
    _cuda.launch('discfill', img.data_ptr(), depth.data_ptr(), H, W, C,
                 out.data_ptr(), _cuda.stream_ptr(img))
    return out

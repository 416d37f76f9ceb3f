"""K13a, the push-pull fill, and the jitter offsets' hash, on the CPU.

- ``csrc/pushpull.cu``'s plan emulated in numpy f32: the tiles of
  32x32 level-0 pixels, each summing its pyramid down to level T =
  min(L, 5) alone (the scratch's levels 1..T, checked against the
  plain version's pyramid); after the barrier the coarse levels T+1..L
  from level T; then, for each tile with a hole pixel, the window of
  each level that the finer level's taps read (each within the plan's
  cap, every tap inside its window, every sum read one that the pull
  wrote) filled from level T down to 1, and its hole pixels. The
  result equals ``push_pull_fill_plain`` bit for bit and JAX's
  ``push_pull_fill`` within 1e-6 (the tolerance of
  tests/test_torch_inpaint_fill.py), at 1x1, 1xW, Hx1 and odd sizes.
- ``jitter_offsets``: the hash's draws in range for each radius,
  repeatable, different for another seed, each value of [-4, 4] within
  5% of its uniform share, and the documented formula.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.ops import inpaint_fill as jfill
from cartoonsegmentation_torch.ops import inpaint_fill as tfill
from torch_cpu import torch_threads  # noqa: F401  (autouse)

SRC = (Path(tfill.__file__).resolve().parent.parent / 'csrc' /
       'pushpull.cu').read_text()


def _const(name):
    expr = re.search(rf'constexpr int {name} = ([\d *<]+);', SRC).group(1)
    return int(eval(expr))


TILE_LOG = _const('kTileLog')
TILE = 1 << TILE_LOG
WIN_BYTES, COARSE_BYTES = _const('kWinBytes'), _const('kCoarseBytes')
F = np.float32
TINY = F(1e-8)


def plan(h, w, levels=0):
    """The host plan of kb_pushpull: level sizes, T, the f32 step scales
    (level k+1 -> k), the window caps and where the coarse levels go."""
    sizes = tfill.fill_levels(h, w, levels)
    L = len(sizes) - 1
    T = min(L, TILE_LOG)
    hs, ws = [a for a, _ in sizes], [b for _, b in sizes]
    sy = [F(hs[k + 1] / hs[k]) for k in range(L)]
    sx = [F(ws[k + 1] / ws[k]) for k in range(L)]
    caps, nh, nw = [(min(h, TILE), min(w, TILE))], min(h, TILE), min(w, TILE)
    for k in range(1, T + 1):
        nh = min(math.ceil((nh - 1) * (hs[k] / hs[k - 1])) + 3, hs[k])
        nw = min(math.ceil((nw - 1) * (ws[k] / ws[k - 1])) + 3, ws[k])
        caps.append((nh, nw))
    assert 16 * sum(a * b for a, b in caps[1:]) <= WIN_BYTES
    coarse = sum(hs[k] * ws[k] for k in range(T, L + 1))
    return dict(L=L, T=T, h=hs, w=ws, sy=sy, sx=sx, caps=caps,
                coarse_in_smem=16 * coarse <= COARSE_BYTES)


def tap(d, n_in, scale):
    src = np.maximum((np.asarray(d).astype(F) + F(0.5)) * scale - F(0.5),
                     F(0))
    i0 = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    i1 = np.minimum(i0 + 1, n_in - 1)
    l1 = src - i0.astype(F)
    return i0, i1, F(1) - l1, l1


def blend(c, w, up):
    """The kernel's blend: c * 0 + up where c = w = 0, else the plain
    version's col * wgt + up * (1 - wgt)."""
    wgt = np.minimum(np.maximum(w, F(0)), F(1))
    full = (c / np.maximum(w, TINY)) * wgt + up * (F(1) - wgt)
    return np.where((w == 0) & (c == 0), c * F(0) + up, full)


def top(c, w):
    return np.where((w == 0) & (c == 0), c, c / np.maximum(w, TINY))


def upsample(src, y0, x0, ys, xs, n_h, n_w, sy, sx):
    """Bilinear taps of rows ys, columns xs into ``src``, a window of a
    level of n_h x n_w whose corner is (y0, x0): every tap inside it."""
    ty, tx = tap(ys, n_h, sy), tap(xs, n_w, sx)
    for i in (ty[0], ty[1]):
        assert (i - y0 >= 0).all() and (i - y0 < src.shape[0]).all()
    for i in (tx[0], tx[1]):
        assert (i - x0 >= 0).all() and (i - x0 < src.shape[1]).all()

    def at(a, b):
        return src[(a - y0)[:, None], (b - x0)[None, :], :3]
    ly0, ly1 = ty[2][:, None, None], ty[3][:, None, None]
    lx0, lx1 = tx[2][None, :, None], tx[3][None, :, None]
    t = lx0 * at(ty[0], tx[0]) + lx1 * at(ty[0], tx[1])
    b = lx0 * at(ty[1], tx[0]) + lx1 * at(ty[1], tx[1])
    return ly0 * t + ly1 * b


def sum2x2(x, h, w):
    """Level k from level k-1's (h', w', 4): (0,0) + (0,1) + (1,0) +
    (1,1), zero padding to (2h, 2w)."""
    p = np.zeros((2 * h, 2 * w, 4), F)
    p[:x.shape[0], :x.shape[1]] = x
    return ((p[0::2, 0::2] + p[0::2, 1::2]) + p[1::2, 0::2]) + p[1::2, 1::2]


def emulate(img, hole, levels=0):
    H, W, _ = img.shape
    p = plan(H, W, levels)
    L, T, hs, ws = p['L'], p['T'], p['h'], p['w']
    out = np.full(img.shape, np.nan, F)
    scratch = {k: np.full((hs[k], ws[k], 4), np.nan, F)
               for k in range(1, L + 1)}
    w0 = (~hole).astype(F)[..., None]
    prem = np.concatenate([img * w0, w0], -1)
    tiles_y, tiles_x = -(-H // TILE), -(-W // TILE)
    holes = {}
    # 1. pull: each tile alone, down to level T
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            ys, xs = slice(ty * TILE, ty * TILE + TILE), \
                slice(tx * TILE, tx * TILE + TILE)
            keep = ~hole[ys, xs]
            out[ys, xs][keep] = img[ys, xs][keep]
            holes[ty, tx] = bool(hole[ys, xs].any())
            lv = prem[ys, xs]
            for k in range(1, T + 1):
                n = TILE >> k
                lv = sum2x2(lv, n, n)
                y, x = ty * n, tx * n
                hh, ww = min(n, hs[k] - y), min(n, ws[k] - x)
                scratch[k][y:y + hh, x:x + ww] = lv[:hh, :ww]
    # the tiles' sums are the whole pyramid's
    pyr = prem
    for k in range(1, T + 1):
        pyr = sum2x2(pyr, hs[k], ws[k])
        np.testing.assert_array_equal(scratch[k], pyr)
    # 2. after the barrier: the coarse levels from level T, their fill
    # pushed down to level T + 1
    fill = {}
    if L > T:
        sums = {T: scratch[T]}
        for k in range(T + 1, L + 1):
            sums[k] = sum2x2(sums[k - 1], hs[k], ws[k])
        f = sums[L].copy()
        f[..., :3] = top(f[..., :3], f[..., 3:])
        fill[L] = f
        for k in range(L - 1, T, -1):
            up = upsample(fill[k + 1], 0, 0, np.arange(hs[k]),
                          np.arange(ws[k]), hs[k + 1], ws[k + 1], p['sy'][k],
                          p['sx'][k])
            f = sums[k].copy()
            f[..., :3] = blend(f[..., :3], f[..., 3:], up)
            fill[k] = f
    # 3. push: each tile with a hole pixel, its windows from T down
    for (ty, tx), any_hole in holes.items():
        if not any_hole:
            continue
        y0, x0 = ty * TILE, tx * TILE
        win = [(y0, min(y0 + TILE, H), x0, min(x0 + TILE, W))]
        for k in range(1, T + 1):
            ylo, yhi, xlo, xhi = win[-1]
            sy, sx = p['sy'][k - 1], p['sx'][k - 1]
            win.append((int(tap(ylo, hs[k], sy)[0]),
                        int(tap(yhi - 1, hs[k], sy)[1]) + 1,
                        int(tap(xlo, ws[k], sx)[0]),
                        int(tap(xhi - 1, ws[k], sx)[1]) + 1))
            assert win[k][1] - win[k][0] <= p['caps'][k][0]
            assert win[k][3] - win[k][2] <= p['caps'][k][1]
        fine = None
        for k in range(T, 0, -1):
            ylo, yhi, xlo, xhi = win[k]
            f = scratch[k][ylo:yhi, xlo:xhi].copy()
            assert not np.isnan(f).any()      # sums the pull wrote
            if k == L:
                f[..., :3] = top(f[..., :3], f[..., 3:])
            else:
                src, sy0, sx0 = (fill[k + 1], 0, 0) if k == T else fine
                up = upsample(src, sy0, sx0, np.arange(ylo, yhi),
                              np.arange(xlo, xhi), hs[k + 1], ws[k + 1],
                              p['sy'][k], p['sx'][k])
                f[..., :3] = blend(f[..., :3], f[..., 3:], up)
            fine = (f, ylo, xlo)
        ylo, yhi, xlo, xhi = win[0]
        c = img[ylo:yhi, xlo:xhi] * F(0)
        if L == 0:
            res = c / TINY
        else:
            res = c + upsample(*fine, np.arange(ylo, yhi),
                               np.arange(xlo, xhi), hs[1], ws[1],
                               p['sy'][0], p['sx'][0])
        sel = hole[ylo:yhi, xlo:xhi]
        out[ylo:yhi, xlo:xhi][sel] = res[sel]
    assert not np.isnan(out).any()
    return out


def _case(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(F)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 7), 0.5 + 0.4 * np.cos(yy / 5),
                    rng.rand(h, w)], -1).astype(F)
    hole = rng.rand(h, w) < 0.15
    for cy, cx, r in ((h * 0.3, w * 0.6, max(h, w) / 6), (h / 2, 0, h / 4)):
        hole |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
    return img, hole


@pytest.mark.parametrize('h,w,levels', [(1, 1, 0), (1, 77, 0), (77, 1, 0),
                                        (37, 53, 0), (70, 101, 0),
                                        (70, 101, 3)])
def test_emulated_plan_matches_plain_and_jax(h, w, levels):
    img, hole = _case(h, w)
    got = emulate(img, hole, levels)
    want = tfill.push_pull_fill_plain(torch.from_numpy(img),
                                      torch.from_numpy(hole), levels).numpy()
    np.testing.assert_array_equal(got, want)
    jax_out = np.asarray(jfill.push_pull_fill(jnp.asarray(img),
                                              jnp.asarray(hole), levels))
    assert np.abs(got - jax_out).max() <= 1e-6


def test_emulated_plan_all_hole_and_no_hole():
    img, _ = _case(37, 53, 1)
    full = np.ones((37, 53), bool)
    np.testing.assert_array_equal(emulate(img, full), np.zeros_like(img))
    np.testing.assert_array_equal(emulate(img, ~full), img)


def test_plan_at_the_style_sizes():
    """448x768: 10 levels, a tile sums 5 alone, its coarse levels in a
    block's shared memory; 1600x1200 (level 5 of 50x38 pixels) puts
    them in the scratch."""
    p = plan(448, 768)
    assert (p['L'], p['T'], p['coarse_in_smem']) == (10, 5, True)
    assert p['caps'][1:] == [(19, 19), (12, 12), (9, 9), (7, 7), (6, 6)]
    assert plan(768, 768)['coarse_in_smem']
    assert not plan(1600, 1200)['coarse_in_smem']


# -- the jitter offsets' hash ------------------------------------------
def _mix(x):
    x ^= x >> 16
    x = (x * 0x7feb352d) & 0xffffffff
    x ^= x >> 15
    x = (x * 0x846ca68b) & 0xffffffff
    return x ^ (x >> 16)


def test_jitter_offsets_follow_the_documented_hash():
    seed, h, w = 7, 5, 9
    off = tfill.jitter_offsets(h, w, seed).numpy()
    for s in range(16):
        k = _mix(_mix(s + 1) ^ _mix(seed))
        r = tfill.RADII[(s // 2) % 4]
        for pix in (0, 17, h * w - 1):
            v = _mix(pix ^ k)
            assert off.reshape(16, -1)[s, pix] == ((v * (2 * r + 1)) >> 32) - r
    # the halves keep every product inside int64
    big = torch.tensor([0xffffffff], dtype=torch.int64)
    for c in (0x7feb352d, 0x846ca68b):
        assert int(tfill._mul32(big, c)) == (0xffffffff * c) & 0xffffffff


def test_jitter_offsets_range_repeat_and_share():
    a = tfill.jitter_offsets(128, 128, seed=1)
    assert a.dtype == torch.int32 and a.device.type == 'cpu'
    assert torch.equal(a, tfill.jitter_offsets(128, 128, seed=1))
    assert (a != tfill.jitter_offsets(128, 128, seed=2)).float().mean() > 0.9
    for ri, r in enumerate(tfill.RADII):
        assert int(a[:, ri].min()) == -r and int(a[:, ri].max()) == r
    counts = np.bincount(a[:, 0].numpy().ravel() + 4, minlength=9)
    share = counts / counts.mean()
    assert counts.shape == (9,) and np.abs(share - 1).max() < 0.05, share

"""K2's launch schedule (csrc/coverage.cu) and K5b's grid plan
(csrc/colorize.cu) on the CPU.

``emulate_coverage`` runs K2's schedule in numpy: the candidate groups
and row bands of ``pointcloud.coverage_plan``, the tiles of 1024 points
with the lanes' skewed order, the kernel's f32 arithmetic one rounding
at a time, one bitmap a (candidate, band) and the bands' counts summed.
Its counts must equal the port's plain version and the JAX package's
``render_coverage_fast``, also where the plan bands the raster and a
corner lies on a band's edge. The kernels themselves are held against
their plain versions on the card (tests/test_torch_kernels.py, marked
``gpu``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartoonsegmentation_tpu.ops import camera as jcamera
from cartoonsegmentation_tpu.ops import pointcloud as jpc
from cartoonsegmentation_torch.ops import _cuda
from cartoonsegmentation_torch.ops import camera as tcamera
from cartoonsegmentation_torch.ops import pointcloud as tpc
from cartoonsegmentation_torch.pipeline import depth as tdepth
from test_torch_kernels import _edge_cloud
from torch_cpu import torch_threads  # noqa: F401  (autouse)

f32 = np.float32
# the streaming multiprocessors of the H100 SXM, which the plans are
# held at here (on the card the wrappers read them from the device)
SMS = 132


def tile_order() -> np.ndarray:
    """The tile's points of each thread, (COVER_PER_THREAD, threads): in
    each run of 1024 points, lane l of warp w takes point
    32 l + (w + l) mod 32."""
    tid = np.arange(_cuda.COVER_THREADS)
    lane, warp = tid & 31, tid >> 5
    p0 = 32 * lane + ((warp + lane) & 31)
    return np.stack([p0 + j * _cuda.COVER_THREADS
                     for j in range(_cuda.COVER_PER_THREAD)])


def emulate_coverage(points: np.ndarray, shifts: np.ndarray, H: int, W: int,
                     focal: float, sms: int = SMS) -> np.ndarray:
    """csrc/coverage.cu's counts, block by block as coverage_plan
    schedules them."""
    N, K = len(points), len(shifts)
    G, band_rows, _ = tpc.coverage_plan(K, H, W, sms)
    T = _cuda.COVER_THREADS * _cuda.COVER_PER_THREAD
    order = tile_order().ravel()
    # every point once, tile by tile, in the threads' order
    seen = np.concatenate([t * T + order[t * T + order < N]
                           for t in range(-(-N // T))] or [np.zeros(0, int)])
    assert np.array_equal(np.sort(seen), np.arange(N))
    x, y, z = (points[seen, i] for i in range(3))
    focal = f32(focal)
    cu, cv = f32(0.5) * f32(W), f32(0.5) * f32(H)
    words = -(-(band_rows * W) // 32)
    counts = np.zeros(K, np.int64)
    with np.errstate(all='ignore'):
        ratio = z / (z + f32(1e-7))
        xr, yr = x * ratio, y * ratio
        for k0 in range(0, K, G):
            for r0 in range(0, H, band_rows):
                r1 = min(H, r0 + band_rows)
                for k in range(k0, min(K, k0 + G)):
                    xs, ys = xr + shifts[k, 0], yr + shifts[k, 1]
                    zs = z + shifts[k, 2]
                    valid = zs >= f32(0.001)
                    u = xs * focal / zs + cu - f32(0.5)
                    v = ys * focal / zs + cv - f32(0.5)
                    x0, y0 = np.floor(u), np.floor(v)
                    fx, fy = u - x0, v - y0
                    bits = np.zeros(words, np.uint32)
                    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)),
                                      (1, 0, fx * (1 - fy)),
                                      (0, 1, (1 - fx) * fy),
                                      (1, 1, fx * fy)):
                        cx, cy = x0 + f32(dx), y0 + f32(dy)
                        hit = (valid & (cx >= 0) & (cx < f32(W)) &
                               (cy >= f32(r0)) & (cy < f32(r1)) & (w > 0))
                        b = ((cy[hit].astype(np.int64) - r0) * W
                             + cx[hit].astype(np.int64))
                        np.bitwise_or.at(bits, b >> 5,
                                         (np.uint32(1) << (b & 31))
                                         .astype(np.uint32))
                    counts[k] += int(np.unpackbits(bits.view(np.uint8))
                                     .sum())
    return counts


def jax_coverage(points, shifts, H, W, focal, baseline):
    fn = jax.jit(jax.vmap(lambda s: jpc.render_coverage_fast(
        jcamera.shift_points(jnp.asarray(points), s), H, W,
        jnp.float32(focal), jnp.float32(baseline))))
    return np.asarray(fn(jnp.asarray(shifts)))


def _random_cloud(rng, P):
    pts = np.stack([rng.uniform(-30, 30, P), rng.uniform(-20, 20, P),
                    rng.uniform(0.5, 80, P)], 1).astype(f32)
    pts[:40, 2] = 0.0                      # invalid slots
    return pts


def _grid_cloud(rng, H=48, W=64, focal=32.0):
    """The autozoom's input: a grid-ordered cloud of a depth map and its
    256 candidate shifts, at stride 2 (a raster of H/2 x W/2)."""
    depth = rng.rand(H, W).astype(f32) * 200 + 300
    depth[10:30, 20:40] = 120.0
    pts = tpc.depth_to_points(torch.from_numpy(depth), focal)
    mini = pts[::2, ::2].reshape(-1, 3).contiguous()
    dr = tcamera.depth_range(torch.from_numpy(depth))
    lin = torch.from_numpy(tcamera._linspace_f32(-10.0, 10.0, 16))
    shifts = tcamera.compute_shift(dr, lin.repeat(16),
                                   lin.repeat_interleave(16), dr.min_val,
                                   dr.min_val * 0.8, W, H, focal)
    return mini.numpy(), shifts.numpy(), H // 2, W // 2, focal / 2


def _check(points, shifts, H, W, focal, baseline=40.0, jax_too=True,
           sms=SMS):
    got = emulate_coverage(points, shifts, H, W, focal, sms)
    plain = tpc.coverage_plain(torch.from_numpy(points),
                               torch.from_numpy(shifts), H, W, focal,
                               baseline).numpy()
    np.testing.assert_array_equal(got, plain)
    if jax_too:
        np.testing.assert_array_equal(
            got, jax_coverage(points, shifts, H, W, focal, baseline))
    return got


def test_coverage_schedule_random_cloud(rng):
    """A ragged last tile (2,500 points), one band, G = 1."""
    shifts = rng.uniform(-3, 3, (8, 3)).astype(f32)
    assert tpc.coverage_plan(8, 40, 56, SMS)[:2] == (1, 40)
    assert _check(_random_cloud(rng, 2500), shifts, 40, 56, 48.0).min() > 0


def test_coverage_schedule_edges(rng):
    """Pixel centres, frame edges, z at 0.001, NaN and inf, against
    shifts that keep them on centres (integer) and move them off."""
    H, W = 21, 30
    shifts = np.concatenate([
        np.zeros((1, 3)), [[1, 0, 0], [0, -1, 0], [0.5, 0.5, 0]],
        rng.uniform(-2, 2, (4, 3))]).astype(f32)
    pts = _edge_cloud(H, W)
    _check(pts[:-8], shifts, H, W, 2.0)
    # JAX converts a NaN corner to pixel 0 (XLA's float to int) and its
    # NaN weight empties the pixels it lands on; the port tests the
    # bounds on the floats, so a NaN point covers nothing
    _check(pts, shifts, H, W, 2.0, jax_too=False)


def test_coverage_schedule_groups_with_a_partial_last(rng):
    """G = 2 (as at the main path's 256 candidates on 132 SMs; here 9
    candidates on 4 SMs): the last group holds one."""
    assert tpc.coverage_plan(9, 40, 56, 4)[0] == 2
    _check(_random_cloud(rng, 1500), rng.uniform(-3, 3, (9, 3)).astype(f32),
           40, 56, 48.0, sms=4)


def test_coverage_schedule_bands(rng, monkeypatch):
    """A raster whose bitmap does not fit a block's shared memory takes
    bands of rows (here bands of 8 rows of 56 pixels: 5 over 37 rows,
    the last of 5); points straddle the bands' edges."""
    H, W = 37, 56
    monkeypatch.setattr(_cuda, 'SMEM_BYTES', _cuda.COVER_TILES_BYTES
                        + _cuda.COVER_STATIC_BYTES + 4 * 14)
    G, band_rows, smem = tpc.coverage_plan(6, H, W, SMS)
    assert (G, band_rows) == (1, 8) and -(-H // band_rows) == 5
    assert smem + _cuda.COVER_STATIC_BYTES <= _cuda.SMEM_BYTES
    pts = _random_cloud(rng, 3000)
    # v at 7.5, 15.5 and 31.5: corners on both sides of a band edge
    edge = np.array([[u - (W / 2 - 0.5), v - (H / 2 - 0.5), 2.0]
                     for u in (3.5, 10.0, 54.5) for v in (7.5, 8.0, 15.5,
                                                          31.5, 32.0)], f32)
    pts = np.concatenate([pts, edge]).astype(f32)
    shifts = np.concatenate([np.zeros((1, 3)),
                             rng.uniform(-3, 3, (5, 3))]).astype(f32)
    _check(pts, shifts, H, W, 2.0)


def test_coverage_schedule_grid_cloud(rng):
    """The autozoom's own input: a grid-ordered stride-2 miniature and
    the 16 x 16 candidate grid."""
    _check(*_grid_cloud(rng))


def test_coverage_schedule_empty(rng):
    """N = 0: every count 0."""
    got = _check(np.zeros((0, 3), f32),
                 rng.uniform(-1, 1, (3, 3)).astype(f32), 20, 30, 16.0)
    assert not got.any()


@pytest.mark.parametrize('K,H,W,G,bands', [
    (256, 288, 512, 2, 1),      # the main path: 576x1024 at stride 2
    (256, 341, 512, 2, 1),      # the 683x1024 clip
    (256, 512, 512, 2, 1),      # max_size 1024, square
    (256, 576, 1024, 1, 1),     # autozoom_stride 1: one 72 KB bitmap
    (32, 288, 512, 1, 1),
    (1, 288, 512, 1, 1),
    (2000, 288, 512, 7, 1),     # as many 18 KB bitmaps as fit
    (256, 1024, 2048, 1, 2),    # a bitmap of 256 KB takes bands
    (256, 4096, 4096, 1, 16)])
def test_coverage_plan_fits_shared_memory(K, H, W, G, bands):
    """G bitmaps, the tiles and the kernel's static arrays fit 227 KB;
    one band where a bitmap fits beside the tiles; the bands cover H."""
    g, band_rows, smem = tpc.coverage_plan(K, H, W, SMS)
    assert (g, -(-H // band_rows)) == (G, bands)
    words = -(-(band_rows * W) // 32)
    assert smem == _cuda.COVER_TILES_BYTES + 4 * g * words
    assert smem + _cuda.COVER_STATIC_BYTES <= _cuda.SMEM_BYTES
    assert band_rows == H if bands == 1 else band_rows < H
    # the kernel forms a bit's index in f32 and converts it with a
    # magic add, exact below 2^22
    assert band_rows * W < 1 << 22


def test_coverage_plan_main_path_grid():
    """At the main path's 256 candidates: 128 blocks of two candidates,
    two bitmaps of 18 KB."""
    G, band_rows, smem = tpc.coverage_plan(256, 288, 512, SMS)
    assert -(-256 // G) == 128
    assert smem == _cuda.COVER_TILES_BYTES + 2 * 18432


def test_tile_order_is_a_bank_free_permutation():
    """The threads' tile order takes every point of a tile once; the 32
    lanes of a warp read words 3p of 32 different banks and take points
    at least 31 apart, but for one pair where the skew wraps."""
    order = tile_order()
    assert np.array_equal(np.sort(order.ravel()), np.arange(order.size))
    for w in range(_cuda.COVER_THREADS // 32):
        for p in order[:, 32 * w:32 * (w + 1)]:
            assert len(set((3 * p) % 32)) == 32
            assert (np.diff(np.sort(p)) < 31).sum() <= 1


@pytest.mark.parametrize('n,blocks', [(1, 1), (511, 1), (513, 2),
                                      (64 * 1024, 128), (576 * 1024, 264),
                                      (683 * 1024, 264),
                                      (4096 * 4096, 264)])
def test_colorize_plan(n, blocks):
    """At most two blocks an SM (264), fewer for a small map; 2 floats
    of scratch a block after the map."""
    assert tdepth.colorize_plan(n, SMS) == (blocks, 2 * blocks)


def test_colorize_wrapper_returns_the_plain_version_on_cpu(rng):
    """On a CPU tensor the wrapper is the plain version, bit for bit,
    also on an odd-sized channel view."""
    buf = torch.from_numpy(rng.rand(13, 17, 4).astype(f32) * 50)
    x = buf[..., 2]
    assert torch.equal(tdepth.colorize_gray_r(x),
                       tdepth.colorize_gray_r_plain(x))

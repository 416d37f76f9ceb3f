"""Port ops (cartoonsegmentation_torch.ops / utils / pipeline.state and
depth) against the JAX package and the numpy oracles.

The same inputs, made by numpy from a seed, go through the JAX
function and the port's plain PyTorch version (the path every kernel
wrapper takes for a CPU tensor). Selections and integer results must
match exactly: z-buffer keys, the w > 0 mask, coverage counts, the
autozoom choice, fill sources, I420 bytes, medians, compaction.
Float sums get the tolerance stated beside each check.

The CUDA kernels are held against their plain versions in
tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartoonsegmentation_tpu.ops import bokeh as jbokeh
from cartoonsegmentation_tpu.ops import camera as jcamera
from cartoonsegmentation_tpu.ops import discfill as jdiscfill
from cartoonsegmentation_tpu.ops import discfill3 as jdiscfill3
from cartoonsegmentation_tpu.ops import filters as jfilters
from cartoonsegmentation_tpu.ops import pointcloud as jpc
from cartoonsegmentation_tpu.pipeline import depth as jdepth
from cartoonsegmentation_tpu.pipeline.state import PointCloud as JCloud
from cartoonsegmentation_tpu.utils import image as jimage
from cartoonsegmentation_torch.ops import bokeh as tbokeh
from cartoonsegmentation_torch.ops import camera as tcamera
from cartoonsegmentation_torch.ops import discfill as tdiscfill
from cartoonsegmentation_torch.ops import discfill3 as tdiscfill3
from cartoonsegmentation_torch.ops import filters as tfilters
from cartoonsegmentation_torch.ops import pointcloud as tpc
from cartoonsegmentation_torch.pipeline import depth as tdepth
from cartoonsegmentation_torch.pipeline.state import PointCloud as TCloud
from cartoonsegmentation_torch.utils import image as timage
from test_torch_kernels import _instance_masks
from oracles import (oracle_bokeh_pass, oracle_fill_disocclusion,
                     oracle_render_pointcloud)
from torch_cpu import torch_threads  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jax.device_get(a))


def _cloud(rng, P=3000, H=40, W=56):
    """Random cloud around the camera, with tiny-z points in frame whose
    key 1e6 − f·b/z goes negative (f·b = 1920 in these tests) and a few
    invalid (z = 0) slots."""
    pts = np.stack([rng.uniform(-30, 30, P), rng.uniform(-20, 20, P),
                    rng.uniform(0.5, 80, P)], 1).astype(np.float32)
    z = rng.uniform(0.001, 0.0019, 60).astype(np.float32)
    pts[:60, :2] *= z[:, None] / 40.0
    pts[:60, 2] = z
    pts[60:120, 2] = 0.0
    return pts


# ---------------------------------------------------------------------------
# K1 splat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('C', [4, 68])
def test_splat_plain_vs_jax(rng, C):
    H, W, focal, baseline = 40, 56, 48.0, 40.0
    pts = _cloud(rng)
    data = rng.rand(pts.shape[0], C).astype(np.float32)
    rj, wj, zj = jpc._render_impl(jnp.asarray(pts), jnp.asarray(data), H,
                                  W, jnp.float32(focal),
                                  jnp.float32(baseline), payload_dtype=None)
    rt, wt, zt = tpc.splat_plain(_t(pts), _t(data), H, W, focal, baseline)
    assert (_np(zj) < 0).any()       # the sign-ordered key case is hit
    np.testing.assert_array_equal(zt.numpy(), _np(zj))
    np.testing.assert_array_equal(wt.numpy() > 0, _np(wj) > 0)
    # scatter-add order differs (XLA vs index_add_): f32 sums of a few
    # terms agree to a few ulp
    np.testing.assert_allclose(wt.numpy(), _np(wj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rt.numpy(), _np(rj), rtol=1e-5, atol=1e-5)


def test_splat_plain_vs_oracle(rng):
    H = W = 24
    focal, baseline = 16.0, 40.0
    depth = rng.rand(H, W).astype(np.float32) * 20 + 10
    depth[8:16, 8:16] = 5.0
    pts = tpc.depth_to_points(_t(depth), focal).reshape(-1, 3).numpy()
    pts = pts + np.float32([0.7, -0.3, 0.5])
    pts[rng.rand(pts.shape[0]) < 0.1, 2] = 0.0
    data = rng.rand(pts.shape[0], 4).astype(np.float32)
    render, weight = tpc.render_pointcloud(_t(pts), _t(data), H, W, focal,
                                           baseline)
    o_render, o_weight = oracle_render_pointcloud(
        pts.astype(np.float64), data.astype(np.float64), H, W, focal,
        baseline)
    np.testing.assert_array_equal(weight.numpy()[..., 0] > 0, o_weight > 0)
    # the oracle accumulates in f64
    np.testing.assert_allclose(weight.numpy()[..., 0], o_weight, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(render.numpy(), o_render, rtol=1e-5,
                               atol=1e-5)


def test_depth_to_points_and_shift_vs_jax(rng):
    depth = rng.rand(12, 20).astype(np.float32) * 50 + 1
    np.testing.assert_array_equal(
        tpc.depth_to_points(_t(depth), 17.0).numpy(),
        _np(jpc.depth_to_points(jnp.asarray(depth), 17.0)))
    pts = _cloud(rng, 200)
    shift = np.float32([0.3, -1.2, 2.5])
    np.testing.assert_array_equal(
        tpc.shift_points(_t(pts), _t(shift)).numpy(),
        _np(jcamera.shift_points(jnp.asarray(pts), jnp.asarray(shift))))


# ---------------------------------------------------------------------------
# K2 coverage and the autozoom search
# ---------------------------------------------------------------------------

def test_coverage_plain_vs_jax(rng):
    H, W = 40, 56
    pts = _cloud(rng)
    shifts = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
    got = tpc.coverage_plain(_t(pts), _t(shifts), H, W, 48.0, 40.0)
    want = [int(jpc.render_coverage_fast(
        jcamera.shift_points(jnp.asarray(pts), jnp.asarray(s)), H, W,
        jnp.float32(48.0), jnp.float32(40.0))) for s in shifts]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('stride', [1, 2])
def test_autozoom_vs_jax(rng, stride):
    H, W = 48, 64
    depth = rng.rand(H, W).astype(np.float32) * 200 + 300
    depth[10:30, 20:40] = 120.0
    focal, baseline = 32.0, 40.0
    pts = _np(jpc.depth_to_points(jnp.asarray(depth), focal)).reshape(-1, 3)
    drj = jcamera.depth_range(jnp.asarray(depth))
    drt = tcamera.depth_range(_t(depth))
    assert float(drt.min_val) == float(drj.min_val)
    assert (float(drt.min_u), float(drt.min_v)) == \
        (float(drj.min_u), float(drj.min_v))
    got = tcamera.autozoom(_t(pts), drt, W, H, focal, baseline,
                           flt_shift=10.0, stride=stride)
    want = jcamera.autozoom(jnp.asarray(pts), drj, W, H, focal, baseline,
                            flt_shift=10.0, stride=stride)
    want = (float(want[0]), float(want[1])) + tuple(want[2:])
    # the chosen candidate cell and the crop sizes are exact. XLA's CPU
    # code for jnp.linspace reassociates and contracts its multiply-
    # adds, so a grid value may sit an ulp of the shift range from the
    # port's per-op f32 rounding of the same formula
    lin = tcamera._linspace_f32(-10.0, 10.0, 16)

    def cell(u, v):
        return int(np.abs(lin - u).argmin()), int(np.abs(lin - v).argmin())
    assert cell(*got[:2]) == cell(*want[:2])
    np.testing.assert_allclose(got[:2], want[:2], rtol=0,
                               atol=np.spacing(np.float32(10.0)))
    assert got[2:] == want[2:]


def test_compute_shift_vs_jax(rng):
    depth = rng.rand(30, 40).astype(np.float32) * 100 + 10
    drj = jcamera.depth_range(jnp.asarray(depth), margin=4)
    drt = tcamera.depth_range(_t(depth), margin=4)
    su = rng.uniform(-50, 50, 16).astype(np.float32)
    sv = rng.uniform(-50, 50, 16).astype(np.float32)
    got = tcamera.compute_shift(drt, _t(su), _t(sv), drt.min_val,
                                drt.min_val * 0.8, 40, 30, 512.0)
    want = jax.vmap(lambda u, v: jcamera.compute_shift(
        drj, u, v, drj.min_val, drj.min_val * jnp.float32(0.8), 40, 30,
        jnp.float32(512.0)))(jnp.asarray(su), jnp.asarray(sv))
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---------------------------------------------------------------------------
# K3 fill
# ---------------------------------------------------------------------------

def _holes(rng, H, W, C=4):
    img = rng.rand(H, W, C).astype(np.float32)
    depth = rng.rand(H, W).astype(np.float32) + 0.5
    depth[8:19, 10:26] = 0.0
    depth[:, :2] = 0.0
    depth[rng.rand(H, W) < 0.1] = 0.0
    img[depth == 0] = 0.0
    return img, depth


def _walk_oracle(img, depth):
    """Per-pixel brute-force walk along each direction's digital line
    x(y) = x0 + off[y] − off[y0] (transcribed from
    tests/test_discfill_fast.py::test_fast_fills_match_bruteforce_walk_
    oracle)."""
    def c_round(v):
        return np.sign(v) * np.floor(np.abs(v) + 0.5)

    H, W = depth.shape
    out = img.copy()
    valid = depth > 0
    for y0 in range(H):
        for x0 in range(W):
            if valid[y0, x0]:
                continue
            best = (np.inf, None)
            for dx, dy in zip(tdiscfill3.DIR_X, tdiscfill3.DIR_Y):
                if abs(dy) >= abs(dx):
                    off = c_round(np.arange(H) * dx / dy).astype(int)

                    def walk(step):
                        y = y0
                        while True:
                            y += step
                            if y < 0 or y >= H:
                                return None
                            x = x0 + off[y] - off[y0]
                            if x < 0 or x >= W:
                                return None
                            if valid[y, x]:
                                return (y, x)
                    s = 1 if dy > 0 else -1
                else:
                    off = c_round(np.arange(W) * dy / dx).astype(int)

                    def walk(step):
                        x = x0
                        while True:
                            x += step
                            if x < 0 or x >= W:
                                return None
                            y = y0 + off[x] - off[x0]
                            if y < 0 or y >= H:
                                return None
                            if valid[y, x]:
                                return (y, x)
                    s = 1 if dx > 0 else -1
                f, t = walk(-s), walk(s)
                if f is None or t is None:
                    continue
                d2 = (f[0] - t[0]) ** 2 + (f[1] - t[1]) ** 2
                if d2 < best[0]:
                    best = (d2, t if depth[f] < depth[t] else f)
            if best[1] is not None:
                out[y0, x0] = img[best[1]]
    return out


def test_fill_plain_vs_jax_and_walk_oracle(rng):
    H, W = 26, 34
    img, depth = _holes(rng, H, W)
    got = tdiscfill3.fill_disocclusion_plain(_t(img), _t(depth)).numpy()
    np.testing.assert_array_equal(
        got, _np(jdiscfill3.fill_disocclusion_fast3(jnp.asarray(img),
                                                     jnp.asarray(depth))))
    np.testing.assert_array_equal(got, _walk_oracle(img, depth))


def test_fill_plain_vs_raymarch_oracle_axis_aligned(rng):
    """On a vertical stripe the digital lines and the reference's
    accumulate-and-round ray march pick the same sources."""
    H, W = 40, 48
    img = rng.rand(H, W, 4).astype(np.float32)
    depth = rng.rand(H, W).astype(np.float32) + 0.5
    depth[:, 20:26] = 0.0
    img[depth == 0] = 0.0
    got = tdiscfill3.fill_disocclusion(_t(img), _t(depth)).numpy()
    np.testing.assert_array_equal(got, oracle_fill_disocclusion(img, depth))


@pytest.mark.parametrize('max_steps', [16, 40, 128])
def test_exact_fill_plain_vs_jax(rng, max_steps):
    """K11's plain version against the JAX fill_disocclusion, exactly:
    holes along every frame edge, a block wider than 16 steps and
    scattered pixels; 40 steps rounds down to 32, as the JAX version's
    chunking does."""
    H, W = 40, 56
    img, depth = _holes(rng, H, W)
    depth[:3] = 0.0
    depth[:, -4:] = 0.0
    depth[-2:, :20] = 0.0
    depth[12:30, 8:44] = 0.0
    img[depth == 0] = 0.0
    want = _np(jdiscfill.fill_disocclusion(jnp.asarray(img),
                                           jnp.asarray(depth),
                                           max_steps=max_steps))
    got = tdiscfill.fill_disocclusion(_t(img), _t(depth), max_steps).numpy()
    np.testing.assert_array_equal(got, want)
    assert tdiscfill.round_steps(max_steps) == max(16, max_steps // 16 * 16)
    np.testing.assert_array_equal(tdiscfill.offset_table(32),
                                  jdiscfill._offset_table(32))


# ---------------------------------------------------------------------------
# K4 bokeh
# ---------------------------------------------------------------------------

def assert_bokeh_close(got, want):
    """Same samples; the JAX version sums per offset cell, the port per
    sample, so the sums differ by f32 rounding, which the inverse pow
    1/13 maps to < 1e-5. Below 4e-3 (one LSB of the uint8 frame) the
    pow(x, 13) highlight lies in f32's subnormal range, which XLA's CPU
    code flushes to zero and torch keeps; there the bound is that LSB."""
    low = np.maximum(got, want) < 4e-3
    np.testing.assert_allclose(got[~low], want[~low], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[low], want[low], rtol=0, atol=4e-3)


def test_bokeh_core_plain_vs_jax(rng):
    H, W = 40, 56
    img = rng.rand(H, W, 3).astype(np.float32)
    weight = rng.rand(H, W).astype(np.float32) * 5e-4
    got = tbokeh.bokeh_core_plain(_t(img), _t(weight), 13.0, 32).numpy()
    want = _np(jbokeh._bokeh_core(jnp.asarray(img), jnp.asarray(weight),
                                  13.0, 32))
    assert_bokeh_close(got, want)


def test_bokeh_blur_vs_jax(rng):
    H, W = 36, 48
    img = rng.rand(H, W, 3).astype(np.float32)
    depth = rng.rand(H, W).astype(np.float32) * 255
    got = tbokeh.bokeh_blur(_t(img), _t(depth), 32, 13, 1,
                            focal_plane=torch.tensor(90.0)).numpy()
    want = _np(jbokeh.bokeh_blur(jnp.asarray(img), jnp.asarray(depth), 32,
                                 13, 1, focal_plane=90.0))
    assert_bokeh_close(got, want)
    np.testing.assert_allclose(
        tbokeh.bokeh_weight_field(_t(depth), 2.0, 40.0).numpy(),
        _np(jbokeh.bokeh_weight_field(jnp.asarray(depth), 2.0, 40.0)),
        rtol=1e-6, atol=1e-12)


def test_bokeh_pass_vs_oracle(rng):
    H, W = 20, 24
    img = rng.rand(H, W, 3).astype(np.float32)
    weight = rng.rand(H, W).astype(np.float32) * 5e-4
    co = torch.from_numpy(tbokeh._coefs(H, W, 8))
    for p, (dx, dy) in enumerate(tbokeh._DIRS[:2]):
        got = tbokeh._pass_gather(_t(img), _t(weight), co[p, 0],
                                  co[p, 1]).numpy()
        want = oracle_bokeh_pass(img.astype(np.float64), weight, dx, dy,
                                 num_samples=8)
        # the oracle accumulates in f64
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K5 frame epilogue, resizes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('crop', [(30, 50), (31, 49), (29, 50)])
def test_crop_center_resize_vs_jax(rng, crop):
    frame = rng.rand(36, 60, 3).astype(np.float32)
    got = timage.crop_center_resize(_t(frame), crop[0], crop[1], 36,
                                    60).numpy()
    want = _np(jimage.crop_center_resize(jnp.asarray(frame), crop[0],
                                         crop[1], 36, 60))
    # weights computed per implementation: a few f32 ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_bgr_to_i420_bytes_vs_jax_and_cv2(rng):
    frames = rng.randint(0, 256, (3, 16, 24, 3)).astype(np.uint8)
    got = timage.bgr_to_i420(_t(frames)).numpy()
    np.testing.assert_array_equal(got, _np(jimage.bgr_to_i420(
        jnp.asarray(frames))))
    cv2 = pytest.importorskip('cv2')
    # as tests/test_pipeline.py holds the JAX version: OpenCV's SIMD
    # path rounds ~0.5% of bytes one LSB the other way
    d = np.abs(got.astype(int) - np.stack([
        cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420) for f in frames]))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


@pytest.mark.parametrize('crop,out', [((30, 50), (36, 60)),
                                      ((31, 49), (36, 60)),
                                      ((29, 50), (36, 60)),
                                      ((31, 50), (32, 58)),
                                      ((32, 50), (32, 50)),
                                      ((31, 49), (31, 49))])
def test_frame_epilogue_vs_jax(rng, crop, out):
    """K5a's plain version against the JAX frame loop's tail (clip →
    crop_center_resize → clip → ×255 + 0.5 → uint8) on a view of a
    filled (H, W, 4) buffer with values outside [0, 1]: resized crops
    at integral, half-pixel and mixed corners, and crops kept at their
    size (the resize skipped); the I420 bytes are the JAX packer's of
    those BGR bytes."""
    buf = (rng.rand(36, 60, 4) * 1.2 - 0.1).astype(np.float32)
    frame = jnp.clip(jnp.asarray(buf[..., :3]), 0.0, 1.0)
    want = np.asarray((jnp.clip(jimage.crop_center_resize(
        frame, *crop, *out), 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8))
    i420 = torch.empty((out[0] * 3 // 2, out[1]), dtype=torch.uint8) \
        if out[0] % 4 == 0 else None
    got = timage.frame_epilogue(_t(buf)[..., :3], *crop, *out, i420=i420)
    np.testing.assert_array_equal(got.numpy(), want)
    if i420 is not None:
        np.testing.assert_array_equal(
            i420.numpy(), _np(jimage.bgr_to_i420(jnp.asarray(want[None]))[0]))


def test_colorize_of_a_channel_view_vs_jax(rng):
    """K5b on the filled frame's depth channel, a strided view, as the
    frame loop calls it."""
    buf = rng.rand(24, 30, 4).astype(np.float32) * 300
    np.testing.assert_array_equal(
        tdepth.colorize_gray_r(_t(buf)[..., 3]).numpy(),
        _np(jdepth.colorize_gray_r(jnp.asarray(buf[..., 3]))))


def test_i420_to_bgr_numpy_twin_matches_cv2(rng, monkeypatch):
    cv2 = pytest.importorskip('cv2')
    yuv = rng.randint(0, 256, (2, 24, 32)).astype(np.uint8)
    want = np.stack([cv2.cvtColor(f, cv2.COLOR_YUV2BGR_I420) for f in yuv])
    monkeypatch.setattr(timage, '_cv2', lambda: None)
    np.testing.assert_array_equal(timage.i420_to_bgr_host(yuv), want)


def test_resize_bilinear_vs_jax(rng):
    x = rng.rand(20, 30, 3).astype(np.float32)
    for h, w in ((40, 60), (13, 17)):
        np.testing.assert_allclose(
            timage.resize_bilinear(_t(x), h, w).numpy(),
            _np(jimage.resize_bilinear(jnp.asarray(x), h, w)),
            rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        timage.resize_bilinear_ac(_t(x), 39, 59).numpy(),
        _np(jimage.resize_bilinear_ac(jnp.asarray(x), 39, 59)),
        rtol=0, atol=2e-6)


def test_resize_antialias_vs_jax_default(rng):
    """jax.image.resize's default antialias against torch's antialias
    bilinear on the LeReS stage's two resizes: the input minification
    (576x1024 → 384x640, here scaled down) and the disparity's way back
    up. Both place a triangle of width max(1, in/out) per axis at the
    same centres and normalise its weights. Measured at the full
    shapes: 1.8e-7 down on [0, 1] data, 1.9e-3 up on [0, 255] data
    (7e-6 of the range), i.e. f32 rounding."""
    x = rng.rand(72, 128, 3).astype(np.float32)
    got = timage.resize_bilinear_aa(_t(x), 48, 80).numpy()
    want = _np(jax.image.resize(jnp.asarray(x), (48, 80, 3), 'linear'))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    d = rng.rand(48, 80, 1).astype(np.float32) * 255
    got = timage.resize_bilinear_aa(_t(d), 72, 128).numpy()
    want = _np(jax.image.resize(jnp.asarray(d), (72, 128, 1), 'linear'))
    np.testing.assert_allclose(got, want, rtol=0, atol=255 * 1e-5)


# ---------------------------------------------------------------------------
# K6 median, K7 filters, K10 compaction, colorize
# ---------------------------------------------------------------------------

def test_masked_median_u8_vs_jax(rng):
    H, W, N = 24, 30, 5
    vals = rng.rand(H, W).astype(np.float32) * 255
    masks = rng.rand(N, H, W) < 0.3
    masks[3] = False
    valid = np.array([True, True, False, True, True])
    got = tdepth.masked_median_u8(_t(vals), _t(masks), _t(valid)).numpy()
    want = _np(jdepth.masked_median_u8(jnp.asarray(vals),
                                       jnp.asarray(masks),
                                       jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('use_median', [False, True])
def test_adjust_disparity_vs_jax(rng, use_median):
    from cartoonsegmentation_tpu.instances import Instances as JIns
    from cartoonsegmentation_torch.instances import Instances as TIns
    H, W = 32, 40
    disp = rng.rand(H, W).astype(np.float32) * 200
    masks = np.zeros((2, H, W), bool)
    masks[0, 5:20, 6:18] = True
    masks[1, 12:30, 15:35] = True
    boxes = np.zeros((2, 4), np.float32)
    got = tdepth.adjust_disparity_by_instances(
        _t(disp), TIns.from_numpy(masks, boxes, capacity=3), use_median)
    want = jdepth.adjust_disparity_by_instances(
        jnp.asarray(disp), JIns.from_numpy(masks, boxes, capacity=3),
        use_median)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_filters_vs_jax(rng):
    x = rng.rand(1, 20, 24, 1).astype(np.float32)
    np.testing.assert_array_equal(
        tfilters.median_filter(_t(x), 5).numpy(),
        _np(jfilters.median_filter(jnp.asarray(x), 5)))
    np.testing.assert_allclose(
        tfilters.laplacian_filter(_t(x)).numpy(),
        _np(jfilters.laplacian_filter(jnp.asarray(x))), rtol=0, atol=1e-6)
    disp = rng.rand(20, 24, 1).astype(np.float32) * 40
    disp[5:9] = 2.0
    np.testing.assert_array_equal(
        tfilters.valid_depth_mask(_t(disp)).numpy(),
        _np(jfilters.valid_depth_mask(jnp.asarray(disp))))
    np.testing.assert_array_equal(
        tdepth.colorize_gray_r(_t(disp[..., 0])).numpy(),
        _np(jdepth.colorize_gray_r(jnp.asarray(disp[..., 0]))))


def test_append_masked_vs_jax(rng):
    M, P = 50, 70
    pts = rng.rand(M, 3).astype(np.float32)
    col = rng.rand(M, 3).astype(np.float32)
    d1 = rng.rand(M).astype(np.float32)
    d2 = rng.rand(M).astype(np.float32)
    m1, m2 = rng.rand(M) < 0.6, rng.rand(M) < 0.8    # second overflows
    jc = JCloud.with_capacity(P)
    tc = TCloud.with_capacity(P)
    for m in (m1, m2):
        jc = jc.append_masked(jnp.asarray(pts), jnp.asarray(col),
                              jnp.asarray(d1), jnp.asarray(d2),
                              jnp.asarray(m))
        tc = tc.append_masked(_t(pts), _t(col), _t(d1), _t(d2), _t(m))
    for k in ('points', 'colors', 'disparity', 'depth', 'count'):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      _np(getattr(jc, k)))
    np.testing.assert_array_equal(tc.shrink_to(64).points.numpy(),
                                  _np(jc.shrink_to(64).points))


def test_append_masked_overflow_in_one_call_vs_jax(rng):
    """K10's plain version: an append that crosses the capacity inside
    one call keeps the first entries in index order and clamps the
    count; the cloud appended to is left as it was."""
    M, P = 400, 150
    args = [rng.rand(M, 3), rng.rand(M, 3), rng.rand(M), rng.rand(M)]
    args = [a.astype(np.float32) for a in args]
    m0, m1 = rng.rand(M) < 0.1, rng.rand(M) < 0.5
    jc = JCloud.with_capacity(P)
    tc = TCloud.with_capacity(P)
    for m in (m0, m1):
        jc = jc.append_masked(*map(jnp.asarray, args), jnp.asarray(m))
        before = tc.clone()
        out = tc.append_masked(*map(_t, args), _t(m))
        for k in ('points', 'colors', 'disparity', 'depth', 'count'):
            assert torch.equal(getattr(tc, k), getattr(before, k)), k
        tc = out
    assert int(tc.count) == P
    for k in ('points', 'colors', 'disparity', 'depth', 'count'):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      _np(getattr(jc, k)))


# ---------------------------------------------------------------------------
# detector slice: K6 and K7 at more shapes, the uint8 resize, Instances
# ---------------------------------------------------------------------------

def test_masked_median_u8_real_masks_vs_jax(rng):
    """K6's plain version on the focal plane's input: a colorized depth
    with whole-number and half-way values (round half to even), disc
    masks, an empty valid mask and invalid slots; exact."""
    H, W, N = 57, 83, 9
    vals = np.round(rng.rand(H, W) * 510).astype(np.float32) / 2
    masks, valid = _instance_masks(rng, N, H, W)
    got = tdepth.masked_median_u8(_t(vals), _t(masks), _t(valid)).numpy()
    want = _np(jdepth.masked_median_u8(jnp.asarray(vals), jnp.asarray(masks),
                                       jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert np.isinf(got[2]) and np.isinf(got[-1]) and np.isfinite(got[0])


@pytest.mark.parametrize('shape', [(1, 7, 5, 1), (33, 21, 2), (2, 13, 9, 3)])
def test_filters_odd_sizes_vs_jax(rng, shape):
    """K7's plain versions at odd sizes, small enough that the reflect
    and replicate halos meet; the median exact, the laplacian exact
    (the same subtractions in the same order)."""
    x = rng.rand(*shape).astype(np.float32)
    x[..., :2, :, :] = np.round(x[..., :2, :, :])
    np.testing.assert_array_equal(
        tfilters.median_filter(_t(x), 5).numpy(),
        _np(jfilters.median_filter(jnp.asarray(x), 5)))
    np.testing.assert_array_equal(
        tfilters.laplacian_filter(_t(x)).numpy(),
        _np(jfilters.laplacian_filter(jnp.asarray(x))))


@pytest.mark.parametrize('src,dst', [((1440, 2560), (576, 1024)),
                                     ((400, 300), (640, 480)),
                                     ((37, 53), (80, 120)),
                                     ((1280, 720), (640, 360)),
                                     ((90, 60), (90, 41))])
def test_resize_linear_u8_matches_cv2(rng, src, dst):
    """cv2.INTER_LINEAR on uint8 byte for byte: down, up, the exact 2x
    area case and one axis only."""
    cv2 = pytest.importorskip('cv2')
    img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(timage.resize_linear_u8(img, *dst), want)
    np.testing.assert_array_equal(
        timage.resize_linear_u8(torch.from_numpy(img[..., 0]), *dst).numpy(),
        want[..., 0])


def test_scaledown_maxsize_without_cv2_matches_cv2(rng, monkeypatch):
    """A 1440x2560 frame down to max_size 1024 where cv2 is missing (the
    card's machine): the JAX package's cv2.resize bytes."""
    cv2 = pytest.importorskip('cv2')
    img = rng.randint(0, 256, (1440, 2560, 3)).astype(np.uint8)
    want = jimage.scaledown_maxsize(img, 1024)
    assert want.shape == (576, 1024, 3)
    monkeypatch.setattr(timage, '_cv2', lambda: None)
    np.testing.assert_array_equal(timage.scaledown_maxsize(img, 1024), want)
    np.testing.assert_array_equal(
        want, cv2.resize(img, (1024, 576), interpolation=cv2.INTER_LINEAR))


def _instance_pair(rng, N, H, W, n_valid):
    from cartoonsegmentation_tpu.instances import Instances as JIns
    from cartoonsegmentation_torch.instances import Instances as TIns
    masks, _ = _instance_masks(rng, n_valid, H, W)
    masks[1] = masks[0]                   # a duplicate of the first
    boxes = np.abs(rng.randn(n_valid, 4) * 20).astype(np.float32)
    scores = rng.rand(n_valid).astype(np.float32)
    return (TIns.from_numpy(masks, boxes, scores, capacity=N),
            JIns.from_numpy(masks, boxes, scores, capacity=N))


@pytest.mark.parametrize('hw', [(96, 150), (21, 37), (40, 150)])
def test_instances_resize_vs_jax(rng, hw):
    """Up (nearest, exact), down (antialiased linear: >= 99.5% of mask
    pixels, the rest at the 0.3 threshold) and mixed; boxes exactly."""
    ti, ji = _instance_pair(rng, 6, 48, 75, 4)
    got, want = ti.resize(*hw), jax.device_get(ji.resize(*hw))
    np.testing.assert_array_equal(got.bboxes.numpy(), want.bboxes)
    same = float((got.masks.numpy() == want.masks).mean())
    if hw[0] >= 48 and hw[1] >= 75:
        assert same == 1.0
    assert same >= 0.995, same
    assert ti.resize(48, 75) is ti


def test_remove_duplicated_vs_jax(rng):
    ti, ji = _instance_pair(rng, 7, 40, 60, 5)
    got, want = ti.remove_duplicated(), jax.device_get(ji.remove_duplicated())
    for k in ('masks', 'bboxes', 'scores', 'valid'):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(want, k))
    assert int(got.count()) < int(ti.count())

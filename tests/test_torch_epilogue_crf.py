"""The host side of K5a (the frame epilogue) and K12b (the dense-CRF
step) on the CPU.

K5a: ``utils/image.py:epilogue_plan``'s tiles, emulated in numpy as
csrc/epilogue.cu forms them (every output pixel's four taps inside its
tile's crop span in shared memory, the bytes from those taps against
the plain version), and ``EpiloguePlan``'s checks and packed launch on
``meta`` tensors (shapes without memory), the launch recorded in place
of the card. K12b: the device table buffer against ``_crf_tables``, the
pool's register sums (a thread a column, each q added to its own
label's sum and 0.0 to the others') emulated against the plain
``_pool_sum`` bit for bit, and the one-call ``densecrf_binary``'s buffer
layout. This file imports neither JAX nor the JAX package.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.ops import _cuda
from cartoonsegmentation_torch.ops import crf as tcrf
from cartoonsegmentation_torch.utils import image as timage
from torch_cpu import torch_threads  # noqa: F401  (autouse)

f32 = np.float32


def _taps(n_crop, n_out):
    """Each output row's first tap, its step to the second and the
    second's weight, as the kernel computes them (f32, one rounding an
    operation)."""
    scale = f32(n_crop) / f32(n_out)
    s = scale * (np.arange(n_out, dtype=f32) + f32(0.5)) - f32(0.5)
    s = np.maximum(s, f32(0.0))
    i = s.astype(np.int64)
    return i, (i < n_crop - 1).astype(np.int64), s - i.astype(f32)


def _emulate(frame, crop_h, crop_w, out_h, out_w, tile_h, tile_w, span_h,
             span_w):
    """csrc/epilogue.cu's bytes in numpy: each tile's crop span, every
    tap read relative to it (an index outside it fails), the
    crop pixels' clipped half-pixel means and the bilinear sum in the
    kernel's order."""
    H, W = frame.shape[:2]
    iy, ix = (H - crop_h + 1) // 2, (W - crop_w + 1) // 2
    fy, fx = (H - crop_h + 1) % 2, (W - crop_w + 1) % 2
    src = np.clip(frame, f32(0), f32(1))
    a = src[iy:iy + crop_h, ix:ix + crop_w]
    if fy:
        a = f32(0.5) * a + f32(0.5) * src[iy + 1:iy + 1 + crop_h,
                                          ix:ix + crop_w]
    if fx:
        b = src[iy:iy + crop_h, ix + 1:ix + 1 + crop_w]
        if fy:
            b = f32(0.5) * b + f32(0.5) * src[iy + 1:iy + 1 + crop_h,
                                              ix + 1:ix + 1 + crop_w]
        a = f32(0.5) * a + f32(0.5) * b
    same = (crop_h, crop_w) == (out_h, out_w)
    out = np.zeros((out_h, out_w, 3), f32)
    for oy0 in range(0, out_h, tile_h):
        for ox0 in range(0, out_w, tile_w):
            th, tw = min(tile_h, out_h - oy0), min(tile_w, out_w - ox0)
            if same:
                staged = a[oy0:oy0 + th, ox0:ox0 + tw]
                assert staged.shape[:2] == (th, tw)
                assert th <= span_h and tw <= span_w
                out[oy0:oy0 + th, ox0:ox0 + tw] = staged
                continue
            ri, rp, rl = (t[oy0:oy0 + th] for t in _taps(crop_h, out_h))
            ci, cp, cl = (t[ox0:ox0 + tw] for t in _taps(crop_w, out_w))
            r0, c0 = ri[0], ci[0]
            r1 = min(ri[-1] + 1, crop_h - 1)
            c1 = min(ci[-1] + 1, crop_w - 1)
            assert r1 - r0 + 1 <= span_h and c1 - c0 + 1 <= span_w
            staged = a[r0:r1 + 1, c0:c1 + 1]
            for t in (ri - r0, ri + rp - r0):
                assert t.min() >= 0 and t.max() < staged.shape[0]
            for t in (ci - c0, ci + cp - c0):
                assert t.min() >= 0 and t.max() < staged.shape[1]
            A = staged[(ri - r0)[:, None], (ci - c0)[None, :]]
            B = staged[(ri - r0)[:, None], (ci + cp - c0)[None, :]]
            D = staged[(ri + rp - r0)[:, None], (ci - c0)[None, :]]
            E = staged[(ri + rp - r0)[:, None], (ci + cp - c0)[None, :]]
            h1, w1 = rl[:, None, None], cl[None, :, None]
            h0, w0 = f32(1) - h1, f32(1) - w1
            out[oy0:oy0 + th, ox0:ox0 + tw] = \
                h0 * (w0 * A + w1 * B) + h1 * (w0 * D + w1 * E)
    return (np.clip(out, f32(0), f32(1)) * f32(255) + f32(0.5)).astype(
        np.uint8)


# (frame H, W; crop; out): the shipped default's crop, a crop kept at
# its size, the 683x1024 clip, odd sizes, a downscale, and one whose
# 8 x 128 tile does not fit shared memory
CASES = [((576, 1024), (558, 993), (576, 1024)),
         ((576, 1024), (556, 992), (556, 992)),
         ((683, 1024), (662, 993), (683, 1024)),
         ((64, 128), (59, 99), (61, 127)),
         ((64, 128), (58, 101), (13, 21)),
         ((600, 600), (599, 599), (20, 20))]


@pytest.mark.parametrize('hw,crop,out', CASES)
def test_epilogue_plan_tiles(hw, crop, out):
    """Every tile's taps lie in its staged span, its shared memory
    fits the card, and the tiles' bytes are the plain version's within
    one LSB on >= 99.99% of values (the tolerance of the gpu test)."""
    tile_h, tile_w, span_h, span_w = timage.epilogue_plan(
        *crop, *out, _cuda.SMEM_BYTES)
    assert tile_h % 2 == 0 and tile_w % 2 == 0
    assert timage.epilogue_smem(tile_h, tile_w, span_h,
                                span_w) <= _cuda.SMEM_BYTES
    if out != (20, 20):
        assert (tile_h, tile_w) == timage.EPILOGUE_TILE
    rng = np.random.RandomState(sum(hw))
    frame = (rng.rand(*hw, 3) * 1.2 - 0.1).astype(f32)
    got = _emulate(frame, *crop, *out, tile_h, tile_w, span_h, span_w)
    want = timage.frame_epilogue_plain(torch.from_numpy(frame), *crop,
                                       *out).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.9999


def test_epilogue_plan_halves_the_tile_to_fit():
    """A crop 30x its output reaches ~30x the tile's rows and columns:
    the tile halves until its shared memory fits, and a smaller limit
    halves it further."""
    big = timage.epilogue_plan(599, 599, 20, 20, _cuda.SMEM_BYTES)
    small = timage.epilogue_plan(599, 599, 20, 20, 30000)
    assert big[0] * big[1] < timage.EPILOGUE_TILE[0] * \
        timage.EPILOGUE_TILE[1]
    assert small[0] * small[1] < big[0] * big[1]
    for plan, limit in ((big, _cuda.SMEM_BYTES), (small, 30000)):
        assert timage.epilogue_smem(*plan) <= limit
    with pytest.raises(ValueError, match='shared memory'):
        timage.epilogue_plan(599, 599, 20, 20, 1000)


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device='meta')


@pytest.fixture
def recorded(monkeypatch):
    """The launches of the kernel wrappers, recorded instead of run."""
    calls = []
    monkeypatch.setattr(_cuda, 'launch',
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(_cuda, 'stream_ptr', lambda t: 7)
    return calls


def test_epilogue_plan_packs_the_launch_once(recorded, monkeypatch):
    """The plan's launches carry frame_epilogue's arguments, the slot's
    address t whole frames past the buffer's; the frame is checked (and
    the tile plan looked up) on the first frame and when its layout
    changes, not on every frame."""
    H, W, T = 576, 1024, 3
    bgr = _meta((T, H, W, 3), torch.uint8)
    i420 = _meta((T, H * 3 // 2, W), torch.uint8)
    plan = timage.EpiloguePlan(558, 993, H, W)
    plan.outputs(bgr, i420)
    filled = _meta((H, W, 4))[..., :3]
    checks = []
    real = timage._check_frame
    monkeypatch.setattr(timage, '_check_frame',
                        lambda *a: checks.append(1) or real(*a))
    for t in range(T):
        plan(filled, t)
    assert len(checks) == 1
    blurred = _meta((H, W, 3))
    plan(blurred, 0)
    assert len(checks) == 2
    timage.frame_epilogue(filled, 558, 993, H, W, bgr[1], i420[1])
    names = {c[0] for c in recorded}
    assert names == {'epilogue'} and len(recorded) == T + 2
    args = [c[1] for c in recorded]
    # frame, H, W, strides, crop, out, tiles: the same for every frame
    assert args[1][:13] == args[0][:13] == args[-1][:13]
    assert args[0][3:5] == (4 * W, 4) and args[T][3:5] == (3 * W, 3)
    assert args[0][9:13] == timage.epilogue_plan(558, 993, H, W,
                                                 _cuda.SMEM_BYTES)
    base_b, base_i = bgr.data_ptr(), i420.data_ptr()
    for t in range(T):
        assert args[t][13] == base_b + t * H * W * 3
        assert args[t][14] == base_i + t * H * W * 3 // 2
    assert args[-1][13:] == (bgr[1].data_ptr(), i420[1].data_ptr(), 7)
    # BGR only: no I420 address
    plan.outputs(bgr)
    plan(filled, 2)
    assert recorded[-1][1][14] == 0


@pytest.mark.parametrize('bad,error', [
    (lambda b, i: (b.float(), i), TypeError),
    (lambda b, i: (b[:, :-1], i), ValueError),
    (lambda b, i: (b.transpose(1, 2).contiguous().transpose(1, 2), i),
     ValueError),
    (lambda b, i: (b[:3], i[:2]), ValueError),
    (lambda b, i: (b, torch.empty(i.shape, dtype=i.dtype)), ValueError),
    (lambda b, i: (b[0], i[0]), ValueError)])
def test_epilogue_plan_refuses_wrong_buffers(bad, error):
    """The buffers' dtype, shape, layout and device are checked once a
    run of frames, and a wrong one raises as frame_epilogue's checks
    do."""
    H, W, T = 64, 96, 4
    bgr = _meta((T, H, W, 3), torch.uint8)
    i420 = _meta((T, H * 3 // 2, W), torch.uint8)
    plan = timage.EpiloguePlan(60, 90, H, W)
    plan.outputs(bgr, i420)
    with pytest.raises(error):
        plan.outputs(*bad(bgr, i420))


def test_epilogue_plan_refuses_wrong_frames_and_slots(recorded):
    H, W = 64, 96
    plan = timage.EpiloguePlan(60, 90, H, W)
    plan.outputs(_meta((2, H, W, 3), torch.uint8))
    with pytest.raises(IndexError):
        plan(_meta((H, W, 3)), 2)
    with pytest.raises(ValueError, match='float32'):
        plan(_meta((H, W, 3), torch.float64), 0)
    with pytest.raises(ValueError, match='does not fit'):
        plan(_meta((50, W, 3)), 0)
    with pytest.raises(ValueError, match='I420'):
        timage.EpiloguePlan(60, 90, 62, W).outputs(
            _meta((2, 62, W, 3), torch.uint8),
            _meta((2, 93, W), torch.uint8))
    assert recorded == []


@pytest.mark.parametrize('dtype', [torch.float64, torch.float16])
def test_epilogue_plan_checks_a_frame_of_another_dtype(recorded, dtype):
    """A frame whose shape and element strides match the bound one but
    whose dtype differs is checked anew, and refused."""
    H, W = 64, 96
    plan = timage.EpiloguePlan(60, 90, H, W)
    plan.outputs(_meta((2, H, W, 3), torch.uint8))
    plan(_meta((H, W, 3)), 0)
    with pytest.raises(ValueError, match='float32'):
        plan(_meta((H, W, 3), dtype), 1)
    assert len(recorded) == 1


def test_epilogue_launch_args_are_packed_in_one_place(recorded):
    """frame_epilogue and the plan launch with the same arguments,
    packed by ``_epilogue_args``."""
    H, W = 64, 96
    frame = _meta((H, W, 4))[..., :3]
    bgr = _meta((1, H, W, 3), torch.uint8)
    timage.frame_epilogue(frame, 60, 90, H, W, bgr[0])
    plan = timage.EpiloguePlan(60, 90, H, W)
    plan.outputs(bgr)
    plan(frame, 0)
    (_, one), (_, planned) = recorded
    assert one == planned
    assert one[1:13] == timage._epilogue_args(frame, 60, 90, H, W)


def test_epilogue_plan_on_the_cpu_is_the_plain_version():
    """On CPU tensors the plan writes frame_epilogue's bytes (the plain
    version) into the slots."""
    rng = np.random.RandomState(3)
    frames = [torch.from_numpy(rng.rand(40, 56, 4).astype(f32))[..., :3]
              for _ in range(2)]
    bgr = torch.zeros((2, 40, 56, 3), dtype=torch.uint8)
    i420 = torch.zeros((2, 60, 56), dtype=torch.uint8)
    plan = timage.EpiloguePlan(37, 51, 40, 56)
    plan.outputs(bgr, i420)
    for t, f in enumerate(frames):
        plan(f, t)
        want = timage.frame_epilogue_plain(f, 37, 51, 40, 56)
        assert torch.equal(bgr[t], want)
        assert torch.equal(i420[t], timage.bgr_to_i420(want[None])[0])


@pytest.mark.parametrize('H,W', [(37, 53), (1, 1), (576, 1024)])
def test_crf_table_buffer_is_the_tables(H, W):
    """One buffer of 4-byte words a (H, W, sxy), cached: the six tables
    of ``_crf_tables`` in csrc/crf.cu's order."""
    dev = torch.device('cpu')
    buf = tcrf._crf_table_buffer(H, W, 1.0, 46.0, dev)
    assert buf is tcrf._crf_table_buffer(H, W, 1.0, 46.0, dev)
    assert buf.dtype == torch.int32 and buf.is_contiguous()
    tables = tcrf._crf_tables(H, W, 1.0, 46.0)
    _, _, _, R = tcrf.lattice(H, W, 46.0)
    sizes = [5, 2 * R + 1, H, 2 * H, W, 2 * W]
    assert buf.numel() == sum(sizes)
    for t, part in zip(tables, torch.split(buf, sizes)):
        assert torch.equal(part.view(t.dtype).reshape(t.shape), t)


def test_crf_check_refuses_unaligned_pairs():
    """csrc/crf.cu reads a pixel's pair as one float2: an (H, W, 2)
    tensor off its 8-byte boundary is refused; the labels, read a value
    at a time, are not held to it."""
    H, W = 5, 7
    buf = torch.zeros(2 * H * W + 1)
    labels = torch.zeros(H * W + 1, dtype=torch.int32)[1:].view(H, W)
    tcrf._crf_check(labels, 10, 46.0, q=buf[:-1].view(H, W, 2))
    with pytest.raises(ValueError, match='q must be 8-byte aligned'):
        tcrf._crf_check(labels, 10, 46.0, q=buf[1:].view(H, W, 2))


def _pool_emulated(q, labels, K, s):
    """csrc/crf.cu's pool in numpy: a thread a pixel column walks the
    band down, adding each q to its own label's register sum and 0.0 to
    the others' (f32, from 0); then a cell's columns in order."""
    H, W, C = q.shape
    gh, gw = -(-H // s), -(-W // s)
    cols = np.zeros((gh, K, C, gw * s), f32)
    for gy in range(gh):
        sums = np.zeros((K, C, W), f32)
        for y in range(gy * s, min(gy * s + s, H)):
            for k in range(K):
                hit = (labels[y] == k)[None]
                sums[k] = sums[k] + np.where(hit, q[y].T, f32(0))
        cols[gy, :, :, :W] = sums
    cells = cols.reshape(gh, K, C, gw, s)
    out = cells[..., 0]
    for dx in range(1, s):
        out = out + cells[..., dx]
    return out.transpose(1, 0, 2, 3)      # (K, gh, C, gw)


@pytest.mark.parametrize('H,W,K,s', [(37, 53, 10, 23), (50, 9, 16, 4),
                                     (5, 7, 1, 23)])
def test_crf_pool_register_sums_are_the_plain_pool(H, W, K, s):
    """The pool's one pass over the pixels, each q added to its own
    label's sum (0.0 to the others'), equals the plain version's
    per-cluster _pool_sum of q * 1[label = c] bit for bit."""
    rng = np.random.RandomState(H + W)
    q = rng.rand(H, W, 2).astype(f32)
    q[rng.rand(H, W) < 0.2] = 0.0
    labels = rng.randint(0, K, (H, W))
    got = _pool_emulated(q, labels, K, s)
    gh, gw = -(-H // s), -(-W // s)
    for c in range(K):
        x = torch.from_numpy(q) * torch.from_numpy(
            (labels == c).astype(f32))[..., None]
        xp = torch.nn.functional.pad(x, (0, 0, 0, gw * s - W, 0, gh * s - H))
        want = tcrf._pool_sum(xp, s).numpy()          # (gh, gw, C)
        assert np.array_equal(got[c].transpose(0, 2, 1), want)


def test_crf_work_and_one_call_layout(recorded):
    """densecrf_binary on the card is one launch (after the k-means):
    the norm pass and every step, its norms, q, lattice scratch and
    flag at disjoint addresses of one buffer; crf_norms and crf_step
    run the same entry point one pass at a time."""
    H, W, K = 50, 70, 10
    unary_fg = _meta((H, W))
    rgb = _meta((H, W, 3), torch.uint8)
    tcrf.densecrf_binary(unary_fg, rgb, iterations=5)
    assert [c[0] for c in recorded] == ['kmeans', 'crf']
    a = recorded[1][1]
    norms, dead, steps, work, q_out = a[3], a[4], a[16], a[18], a[19]
    assert a[15:18] == (1, 5, 1)                     # norm pass, steps, flag
    n = 4 * 2 * H * W
    w = 4 * tcrf.crf_work(H, W, K, 46.0, 5)
    assert tcrf.crf_work(H, W, K, 46.0, 5) == \
        4 * K * 3 * 4 + 2 * H * W                    # a 3x4 lattice
    assert sorted([(norms, n), (q_out, n), (work, w), (dead, 4)]) == [
        (norms, n), (norms + n, n), (norms + 2 * n, w),
        (norms + 2 * n + w, 4)]
    recorded.clear()
    tcrf.densecrf_binary(unary_fg, rgb, iterations=1)
    assert recorded[1][1][15:18] == (1, 1, 0)        # no flag after 1 step
    recorded.clear()
    labels = _meta((H, W), torch.int32)
    tcrf.crf_norms(labels)
    q = _meta((H, W, 2))
    tcrf.crf_step(q, labels, q, q, _meta((1,), torch.int32))
    (_, norm_args), (_, step_args) = recorded
    assert norm_args[15:18] == (1, 0, 0) and step_args[15:18] == (0, 1, 1)
    with pytest.raises(ValueError, match='clusters'):
        tcrf.crf_norms(labels, num_clusters=17)

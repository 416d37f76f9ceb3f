"""K9's launch plan (cartoonsegmentation_torch/csrc/maskhead.cu)
emulated in torch on the CPU, against the plain version.

The kernel runs only on a card; here its plan runs as it runs it:
- the bands of 128 output rows, each reading the
  source rows [s_lo, s_hi] of ``maskhead_bands`` and owning the
  rows [o_lo, o_hi) whose probabilities it writes: the owned rows
  partition the source rows, every tap a band's rows read lies in its
  staged rows, and the last band may hold fewer rows;
- the heads of a band's rows two pixels a thread, pixels i and i + half
  of the band's n (the second only where it exists): each pixel once;
- a thread's 8 consecutive columns (the last group of a row short
  where the width is not a multiple of 8, and then every group written
  byte by byte) and its slice of the band's rows, walked in order with
  the two resampled source rows kept while they stay the same (the
  second taken as the first when the rows advance by one);
- a mask byte as ly0 * h0 + ly1 * h1 > thr, h the horizontally
  resampled row lx0 * a + lx1 * b, taken as the sign bit of thr - v
  (the same bit), and zero for an invalid instance.
The emulated masks equal, bit for bit, the same formula evaluated
directly at every output pixel from the whole probability map, and
agree with the plain version (torch's bilinear resize, which may
contract the products into FMAs) on >= 99.99% of the pixels, the
tolerance of the card's test.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import rtmdet as trtmdet
from torch_cpu import torch_threads  # noqa: F401  (autouse)

F32 = torch.float32
THREADS = 256   # csrc/maskhead.cu:kMaxThreads
COLS = 8        # csrc/maskhead.cu:kCols
ROWS = 128      # csrc/maskhead.cu:kRows


def maskhead_bands(h: int, H: int, R: int):
    """csrc/maskhead.cu:band_rows of each band of R output rows, in its
    f32 arithmetic: (s_lo, s_hi, o_lo, o_hi), the source rows the band
    reads, [s_lo, s_hi], and those it owns, [o_lo, o_hi), whose
    probabilities it writes."""
    f32 = np.float32
    scale = f32(h) / f32(H)

    def src(dst):
        s = scale * (f32(dst) + f32(0.5)) - f32(0.5)
        return int(max(s, f32(0.0)))
    nb = -(-H // R)
    bands = []
    for b in range(nb):
        Y0, Y1 = b * R, min(H, b * R + R) - 1
        first, last = src(Y0), src(Y1)
        o_lo = 0 if b == 0 else first
        o_hi = h if b == nb - 1 else src(Y1 + 1)
        bands.append((min(first, o_lo), max(last + (last < h - 1), o_hi - 1),
                      o_lo, o_hi))
    return bands


def source_index(scale: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """csrc/maskhead.cu:source_index in f32, one rounding a step."""
    s = scale * (dst.to(F32) + 0.5) - 0.5
    return torch.clamp(s, min=0.0)


def taps(n_src: int, n_dst: int, dst: torch.Tensor):
    """(i1, i2, l0, l1) of the destination indices: the first and second
    source index and their weights."""
    scale = torch.tensor(n_src, dtype=F32) / torch.tensor(n_dst, dtype=F32)
    s = source_index(scale, dst)
    i1 = s.to(torch.int64)
    l1 = s - i1.to(F32)
    return i1, i1 + (i1 < n_src - 1).long(), 1.0 - l1, l1


def hrow(row: torch.Tensor, x1, x2, lx0, lx1) -> torch.Tensor:
    """A source row (N, w) resampled to the columns' taps."""
    return lx0 * row[:, x1] + lx1 * row[:, x2]


def heads_pixels(n: int, T: int) -> list:
    """heads_range's pixels of a band's n, two a thread: i and i + half
    for i = t, t + T, ... (the second only where it exists)."""
    half = (n + 1) // 2
    return [p for t in range(T) for i in range(t, half, T)
            for p in ((i, i + half) if i + half < n else (i,))]


def emulate(probs: torch.Tensor, valid: torch.Tensor, H: int, W: int,
            thr: float):
    """The kernel's plan on the plain probabilities probs (N, h, w):
    (masks (N, H, W) bool, the probabilities the bands write (N, h, w))."""
    N, h, w = probs.shape
    R, V = ROWS, COLS
    bands = maskhead_bands(h, H, R)
    assert len(bands) == -(-H // R)
    written = torch.zeros((N, H, W), dtype=torch.int32)
    masks = torch.zeros((N, H, W), dtype=torch.bool)
    out_probs = torch.full((N, h, w), float('nan'))
    owned = torch.zeros(h, dtype=torch.int32)
    # the column groups: V consecutive columns a thread, the last short
    G = -(-W // V)
    X = torch.arange(G * V)
    live = X < W
    x1, x2, lx0, lx1 = taps(w, W, X.clamp(max=W - 1))
    assert (x2 < w).all() and (x1 >= 0).all()
    vec = W % V == 0
    assert vec or not live.all()
    S = max(1, THREADS // G)
    T = min(THREADS, S * G)
    for b, (s_lo, s_hi, o_lo, o_hi) in enumerate(bands):
        Y0 = b * R
        rows = min(R, H - Y0)
        assert rows == R or b == len(bands) - 1
        assert s_lo <= o_lo <= o_hi <= s_hi + 1
        owned[o_lo:o_hi] += 1
        # the staged rows' heads, each pixel once
        n_px = (s_hi - s_lo + 1) * w
        assert sorted(heads_pixels(n_px, T)) == list(range(n_px))
        out_probs[:, o_lo:o_hi] = probs[:, o_lo:o_hi]
        staged = probs[:, s_lo:s_hi + 1]
        y1, y2, _, ly1s = taps(h, H, torch.arange(Y0, Y0 + rows))
        # every tap of the band's rows lies in its staged rows
        assert (y1 >= s_lo).all() and (y2 <= s_hi).all()
        ry, ryp = (y1 - s_lo).tolist(), (y2 - y1).tolist()
        for sl in range(S):
            i0, i1 = sl * rows // S, (sl + 1) * rows // S
            ya = yb = -1
            h0 = h1 = None
            for i in range(i0, i1):
                na, nb = ry[i], ry[i] + ryp[i]
                if na != ya or nb != yb:
                    h0 = h1 if na == yb else hrow(staged[:, na], x1, x2,
                                                  lx0, lx1)
                    h1 = hrow(staged[:, nb], x1, x2, lx0, lx1)
                    ya, yb = na, nb
                ly1 = ly1s[i]
                vf = (1.0 - ly1) * h0 + ly1 * h1
                v = vf > thr
                assert torch.equal(torch.signbit(thr - vf), v)
                Y = Y0 + i
                masks[:, Y] = v[:, live] & valid[:, None]
                written[:, Y] += 1
    assert (owned == 1).all()                # a partition of the rows
    assert (written == 1).all()              # each byte once
    return masks, out_probs


def direct(probs: torch.Tensor, valid: torch.Tensor, H: int, W: int,
           thr: float) -> torch.Tensor:
    """The mask formula at every output pixel from the whole map:
    ly0 * (lx0 * a + lx1 * b) + ly1 * (lx0 * c + lx1 * d) > thr."""
    N, h, w = probs.shape
    y1, y2, ly0, ly1 = taps(h, H, torch.arange(H))
    x1, x2, lx0, lx1 = taps(w, W, torch.arange(W))
    r1, r2 = probs[:, y1], probs[:, y2]
    top = lx0 * r1[:, :, x1] + lx1 * r1[:, :, x2]
    bot = lx0 * r2[:, :, x1] + lx1 * r2[:, :, x2]
    v = ly0[:, None] * top + ly1[:, None] * bot
    return (v > thr) & valid[:, None, None]


@pytest.mark.parametrize('N,h,w,H,W', [
    (4, 80, 80, 640, 640), (6, 20, 24, 160, 192), (5, 13, 21, 104, 167),
    (4, 9, 12, 71, 90), (3, 16, 16, 40, 50), (3, 1, 1, 8, 8)],
    ids=['main-path', 'x8', 'w-odd', 'h-odd', 'down', 'one-pixel'])
def test_band_plan_vs_plain(rng, N, h, w, H, W):
    """The main path's 80x80 → 640x640 (5 bands of 128 rows, 80 groups
    of 8 columns), x8 sizes whose last band is short, widths that are
    not a multiple of 8 (a short last group, byte stores), a
    downsampling resize (owned rows that no band reads) and a 1x1
    source, with invalid instances among them."""
    feat = torch.from_numpy(rng.randn(h, w, 8).astype(np.float32))
    kern = torch.from_numpy(rng.randn(N, 169).astype(np.float32))
    priors = torch.from_numpy(rng.randint(0, w, (N, 2)).astype(np.float32)
                              * 8)
    strides = torch.from_numpy(rng.choice([8.0, 16.0, 32.0], N)
                               .astype(np.float32))
    valid = torch.from_numpy(np.arange(N) % 3 != 1)
    want_m, want_p = trtmdet.dynamic_masks_plain(feat, kern, priors, strides,
                                                 valid, H, W, 0.3)
    probs = want_p.reshape(N, h, w)
    masks, got_p = emulate(probs, valid, H, W, 0.3)
    assert torch.equal(got_p, probs)
    assert torch.equal(masks, direct(probs, valid, H, W, 0.3))
    assert float((masks == want_m).float().mean()) >= 0.9999
    assert not masks[~valid].any()
    assert masks[valid].any() or H * W < 100

"""K7's median-5 and K6's per-instance median on NaN, ±inf and ±0,
against the JAX package; csrc/median5.cu's networks emulated on the
CPU.

- The median-5's plain version against JAX's ``median_filter`` on planes
  whose windows hold 0, 1, 12, 13 and 25 NaN taps (NaNs of both signs),
  ±inf, ±0 and ties: equal with ``equal_nan``, NaN exactly where 13 or
  more taps are NaN.
- csrc/median5.cu's networks, read from its source (the ``KB_SORT5``,
  ``KB_MERGE_5_5`` and ``KB_MERGE_10_10`` comparator lists and ``RUN``):
  every output of a thread's run proved exact over all 2^25 inputs of
  0s and 1s to its window (a comparator network that selects the 13th
  of every 0-1 input selects the 13th of every input), the integer min/max that feed
  a run's outputs counted (the operations the compiler keeps, as the
  source states them), and the kernel's schedule (order keys, a run of
  8 outputs down a column in pairs, each window row sorted once, the
  staged rows and columns reflected as the kernel stages them)
  emulated in torch against JAX.
- K6's plain version against JAX's ``masked_median_u8`` with NaN and
  ±inf values, empty and invalid slots (NaN counts in bin 0).
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartoonsegmentation_tpu.ops import filters as jfilters
from cartoonsegmentation_tpu.pipeline import depth as jdepth
from cartoonsegmentation_torch.ops import _cuda
from cartoonsegmentation_torch.ops import filters as tfilters
from cartoonsegmentation_torch.pipeline import depth as tdepth
from torch_cpu import torch_threads  # noqa: F401  (autouse)

SOURCE = (_cuda.CSRC / 'median5.cu').read_text()
NEG_NAN = np.array([0xffc00001], np.uint32).view(np.float32)[0]


def _macro_pairs(name: str):
    """The comparator list X(i, j) ... of ``#define name(X)`` in
    csrc/median5.cu."""
    text = SOURCE.replace('\\\n', ' ')
    m = re.search(rf'#define {name}\(X\)(.*)', text)
    assert m, f'{name} not in median5.cu'
    return [(int(i), int(j))
            for i, j in re.findall(r'X\((\d+), (\d+)\)', m.group(1))]


def _constant(name: str) -> int:
    m = re.search(rf'constexpr int {name} = (\d+);', SOURCE)
    assert m, f'{name} not in median5.cu'
    return int(m.group(1))


SORT5 = _macro_pairs('KB_SORT5')
MERGE_5_5 = _macro_pairs('KB_MERGE_5_5')
MERGE_10_10 = _macro_pairs('KB_MERGE_10_10')
RUN = _constant('RUN')


def _network(v: list, pairs, lo, hi) -> list:
    """KB_CE over the wires v: min (``lo``) to the first, max (``hi``)
    to the second."""
    v = list(v)
    for i, j in pairs:
        v[i], v[j] = lo(v[i], v[j]), hi(v[i], v[j])
    return v


def run_outputs(rows: list, lo, hi) -> list:
    """csrc/median5.cu:median5_kernel's computation of one thread: its
    RUN + 4 window rows (5 taps each) to its RUN outputs, in the
    kernel's order (rows sorted once, pair p from lo = S(2p), mid =
    S(2p+2), s3 = S(2p+3), m0 = M(p))."""
    def sorted_row(i):
        return _network(rows[i], SORT5, lo, hi)

    def median_of(a, b):
        m = a[12]
        for i in range(5):
            m = lo(m, hi(a[11 - i], b[i]))
        return m
    out = []
    low, s1, mid = sorted_row(0), sorted_row(1), sorted_row(2)
    m0 = _network(s1 + mid, MERGE_5_5, lo, hi)
    s3 = sorted_row(3)
    for p in range(RUN // 2):
        s4, s5 = sorted_row(2 * p + 4), sorted_row(2 * p + 5)
        m1 = _network(s3 + s4, MERGE_5_5, lo, hi)
        a = _network(m0 + m1, MERGE_10_10, lo, hi)
        out += [median_of(a, low), median_of(a, s5)]
        low, mid, s3, m0 = mid, s4, s5, m1
    return out


def order_keys(x: np.ndarray) -> np.ndarray:
    """csrc/median5.cu:order_key: int32 keys, every NaN as +NaN."""
    b = np.ascontiguousarray(x, np.float32).view(np.int32).copy()
    b[np.isnan(x)] = 0x7fc00000
    return b ^ ((b >> 31) & 0x7fffffff)


def key_values(k: np.ndarray) -> np.ndarray:
    return (k ^ ((k >> 31) & 0x7fffffff)).astype(np.int32).view(np.float32)


def _reflect(i: int, n: int) -> int:
    i = -i if i < 0 else i
    return 2 * (n - 1) - i if i >= n else i


def median5_emulated(x: np.ndarray) -> np.ndarray:
    """The kernel on (..., H, W, C) f32, emulated a (b, c) plane at a
    time, every thread's run at once: its window rows reflect(min(y,
    H + 1)) for y from the run's first row - 2, its columns
    reflect(min(x, W + 1)), as the kernel stages them."""
    H, W, C = x.shape[-3:]
    planes = x.reshape(-1, H, W, C)
    n_run = -(-H // RUN)
    ys = np.array([[_reflect(min(r * RUN - 2 + i, H + 1), H)
                    for i in range(RUN + 4)] for r in range(n_run)])
    xs = np.array([[_reflect(min(c - 2 + d, W + 1), W) for d in range(5)]
                   for c in range(W)])
    out = np.empty_like(planes)
    for b in range(planes.shape[0]):
        for c in range(C):
            keys = torch.from_numpy(order_keys(planes[b, :, :, c]))
            taps = keys[ys][:, :, xs]              # (n_run, RUN + 4, W, 5)
            rows = [[taps[:, i, :, d] for d in range(5)]
                    for i in range(RUN + 4)]
            got = torch.stack(run_outputs(rows, torch.minimum,
                                          torch.maximum), 1)
            out[b, :, :, c] = key_values(
                got.reshape(n_run * RUN, W)[:H].numpy())
    return out.reshape(x.shape)


def nan_counts(x: np.ndarray) -> np.ndarray:
    """The NaN taps of each pixel's reflected 5x5 window."""
    nan = torch.from_numpy(np.isnan(x).astype(np.float32))
    return sum(tfilters._shift2d(nan, dy, dx, 'reflect')
               for dy in range(-2, 3) for dx in range(-2, 3)).numpy()


@pytest.fixture(scope='module')
def nan_planes():
    """(3, 19, 23, 2) planes: values on a few levels (ties) with ±0 and
    ±inf among them; NaNs of both signs at two densities near half (12
    and 13 NaN windows), a 7x7 block of NaN (25) and lone NaNs (1).
    Returns (x, JAX's median_filter(x, 5))."""
    rng = np.random.RandomState(7)
    x = rng.choice(np.array([-2.5, -1.0, -0.0, 0.0, 0.5, 3.0, np.inf,
                             -np.inf], np.float32), (3, 19, 23, 2))
    x[1] += rng.rand(19, 23, 2).astype(np.float32)
    for b, share in ((0, 0.49), (2, 0.52)):
        nan = rng.rand(19, 23, 2) < share
        x[b][nan] = np.where(rng.rand(int(nan.sum())) < 0.5, np.nan,
                             NEG_NAN)
    x[1, 4:11, 6:13] = np.nan
    x[1, 15, 2] = x[1, 2, 19, 1] = NEG_NAN
    want = np.array(jax.device_get(jax.jit(
        jfilters.median_filter, static_argnums=1)(jnp.asarray(x), 5)))
    return x, want


def test_nan_planes_cover_the_counts(nan_planes):
    counts = set(np.unique(nan_counts(nan_planes[0])).astype(int))
    assert {0, 1, 12, 13, 25} <= counts, sorted(counts)


def test_median5_plain_vs_jax_nan_order(nan_planes):
    """JAX's order: -inf < finite < +inf < NaN, -0 equal to +0."""
    x, want = nan_planes
    got = tfilters.median_filter(torch.from_numpy(x), 5)
    torch.testing.assert_close(got, torch.from_numpy(want), rtol=0, atol=0,
                               equal_nan=True)
    np.testing.assert_array_equal(np.isnan(want), nan_counts(x) >= 13)


def test_median5_kernel_emulated_vs_jax(nan_planes):
    x, want = nan_planes
    got = median5_emulated(x)
    torch.testing.assert_close(torch.from_numpy(got), torch.from_numpy(want),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize('shape', [(1, 3, 3, 1), (2, 9, 35, 3),
                                   (1, 20, 37, 1)])
def test_median5_kernel_emulated_ragged_vs_plain(shape):
    """Planes of fewer rows than a run, and rows not a multiple of it,
    of ties and signed zeros."""
    rng = np.random.RandomState(sum(shape))
    x = rng.choice(np.array([-0.0, 0.0, 1.0, 0.25], np.float32), shape)
    want = tfilters.median_filter_plain(torch.from_numpy(x), 5)
    torch.testing.assert_close(torch.from_numpy(median5_emulated(x)), want,
                               rtol=0, atol=0)


def _zero_one_rows(chunk: int, base: int):
    """A run's RUN + 4 window rows as bit-packed 0-1 inputs: assignment
    a = word * 64 + lane sets tap d of row r to bit 5 * (r % 5) + d of
    a, so that the 5 rows of any output's window carry the 25 bits once
    each; words base .. base + chunk - 1 of the 2^19."""
    words = torch.arange(base, base + chunk, dtype=torch.int64)
    bits = []
    for t in range(25):
        if t < 6:       # the lanes whose bit t is set, in every word
            w = sum(1 << lane for lane in range(64) if (lane >> t) & 1)
            w = w - (1 << 64) if w >= 1 << 63 else w
            bits.append(torch.full((chunk,), w, dtype=torch.int64))
        else:           # all ones or all zeros by the word's bit t - 6
            bits.append(-((words >> (t - 6)) & 1))
    return [bits[5 * (r % 5):5 * (r % 5) + 5] for r in range(RUN + 4)]


def _majority(chunk: int, base: int) -> torch.Tensor:
    """The expected bit-packed median of the 25 bits: 1 where 13 or more
    of the assignment's bits are set."""
    pc = [bin(i).count('1') for i in range(64)]
    masks = []
    for k in range(-19, 27):   # lanes with popcount(lane) >= k
        w = sum(1 << i for i in range(64) if pc[i] >= k)
        masks.append(w - (1 << 64) if w >= 1 << 63 else w)
    masks = torch.tensor(masks, dtype=torch.int64)
    words = torch.arange(base, base + chunk, dtype=torch.int64)
    hi = sum((words >> i) & 1 for i in range(19))
    return masks[13 - hi + 19]


@pytest.mark.parametrize('quarter', range(4))
def test_median5_network_exact_on_all_zero_one_inputs(quarter):
    """Every output of a run, for every assignment of 0s and 1s to the 25
    taps of its window (a quarter of the 2^25 a case), is their median:
    by the 0-1 principle the networks then select the 13th tap of any
    input. Output o reads the window rows o .. o + 4 only."""
    assert RUN == 8
    chunk = 1 << 17
    base = quarter * chunk
    got = run_outputs(_zero_one_rows(chunk, base), torch.bitwise_and,
                      torch.bitwise_or)
    want = _majority(chunk, base)
    for out, g in enumerate(got):
        assert torch.equal(g, want), out


def test_median5_network_operations():
    """The integer min/max that feed a run's outputs (what the compiler
    keeps of the unrolled networks), as the source states them: under
    the 99 compare-exchanges (198 min/max) a pixel of a median-of-25
    selection network."""
    ops = []

    def rec(kind):
        def op(a, b):
            ops.append((kind, a, b))
            return len(ops) - 1
        return op
    rows = [[-(5 * r + d + 1) for d in range(5)] for r in range(RUN + 4)]
    outs = run_outputs(rows, rec('min'), rec('max'))
    live, stack = set(), list(outs)
    while stack:
        i = stack.pop()
        if i < 0 or i in live:
            continue
        live.add(i)
        stack += list(ops[i][1:])
    assert len(live) == 570
    assert f'{len(live)} integer min/max a run of {RUN} outputs' in \
        SOURCE.replace('\n//', '')
    assert len(live) / RUN < 99 * 2


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def test_masked_median_u8_nan_inf_vs_jax():
    """NaN, ±inf and out-of-range values in the map; an instance of one
    NaN and one 200 (lower median 0: the NaN's bin), one of NaNs only,
    one of ±inf only, an empty valid slot and invalid slots."""
    rng = np.random.RandomState(3)
    H, W, N = 23, 31, 8
    vals = (rng.rand(H, W) * 300 - 20).astype(np.float32)
    vals[rng.rand(H, W) < 0.1] = np.nan
    vals[rng.rand(H, W) < 0.03] = np.inf
    vals[rng.rand(H, W) < 0.03] = -np.inf
    vals[0, 0], vals[0, 1] = np.nan, 200.0
    vals[1, :4] = [np.nan, NEG_NAN, np.nan, np.nan]
    vals[2, :3] = [np.inf, -np.inf, np.inf]
    masks = rng.rand(N, H, W) < 0.3
    masks[0:3] = False
    masks[0, 0, :2] = True
    masks[1, 1, :4] = True
    masks[2, 2, :3] = True
    masks[5] = False
    valid = np.array([True] * 6 + [False, False])
    got = tdepth.masked_median_u8(torch.from_numpy(vals),
                                  torch.from_numpy(masks),
                                  torch.from_numpy(valid))
    want = np.asarray(jax.device_get(jax.jit(jdepth.masked_median_u8)(
        jnp.asarray(vals), jnp.asarray(masks), jnp.asarray(valid))))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want[:3]) == [0.0, 0.0, 255.0]
    assert np.isinf(want[5:]).all() and (want[5:] < 0).all()

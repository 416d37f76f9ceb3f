"""K12a, the CRF's k-means, on the schedule of its one-launch kernel
(csrc/kmeans.cu): block b owns the points [b·per, (b+1)·per); warp c
sums cluster c's points of its block, lane l its points l, l + 32, ...
in order, then an xor tree over the lanes; every block adds the blocks'
partials in the same order (sum q the blocks q, q + 8, ... in order,
then the 8 sums in order).

On the CPU that summation order is emulated in f32 with numpy for one
block, a cluster of blocks and a cooperative grid, and its labels are
held against the plain version ``_kmeans_labels`` and the JAX
package's ``_kmeans_labels`` on >= 99.9% of points (the sums round
otherwise than the one-hot matmul's, so a point near a tie may take
the other label), at N from a few hundred to ~40,000. The wrapper's
launch plan (``kmeans_plan``: which path a given N takes) is checked
against its rule. The kernel itself is held against the plain version
on the card in tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.ops import crf as tcrf
from torch_cpu import torch_threads  # noqa: F401  (autouse)

SHARE = 0.999       # chip_smoke.py: KMEANS_SHARE
LANES = 32
GROUPS = 8          # csrc/kmeans.cu: kGroups
SMS = 132           # the H100's streaming multiprocessors


def _guide(n, seed=0):
    """n colours in [0, 1] as a crop's guide: flat patches of a few
    colours, a gradient and some noise, quantised to bytes then times
    f32(1/255), as densecrf_binary makes them."""
    rng = np.random.RandomState(seed)
    w = 97
    h = -(-n // w)
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([60 + 0.5 * xx, 90 + 40 * np.sin(yy / 9.0),
                    np.full((h, w), 140.0)], -1)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(5, 30)
        rgb[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    rgb = rgb + rng.randn(h, w, 3) * np.where(rng.rand(h, w, 1) < 0.1, 20, 2)
    u8 = np.clip(rgb, 0, 255).astype(np.uint8).reshape(-1, 3)[:n]
    return u8.astype(np.float32) * np.float32(1 / 255)


def _tree(v):
    """The xor tree over the last-but-one axis (32 lanes), in f32:
    every lane ends with the same sum; lane 0's is returned."""
    idx = np.arange(LANES)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., idx ^ o, :]).astype(np.float32)
    return v[..., 0, :]


def _lane_sums(vals):
    """vals (B, M, 32, F): lane l adds its rows m = 0, 1, ... in order."""
    acc = np.zeros(vals.shape[:1] + vals.shape[2:], np.float32)
    for m in range(vals.shape[1]):
        acc = (acc + vals[:, m]).astype(np.float32)
    return acc


def kmeans_schedule(colors, k, blocks, iters=8):
    """csrc/kmeans.cu's labels for ``blocks`` blocks, its sums in its
    order; the distance as the plain version's ``_sq_dist``."""
    N = colors.shape[0]
    per = -(-N // blocks)
    M = -(-per // LANES)
    # (blocks, M, 32) point index of lane l's m-th point, -1 past the end
    j = np.arange(blocks)[:, None, None] * per + \
        np.arange(M)[None, :, None] * LANES + np.arange(LANES)
    inside = (j < N) & (j - np.arange(blocks)[:, None, None] * per < per)
    pts = np.where(inside[..., None], colors[np.where(inside, j, 0)], 0)
    pts = pts.astype(np.float32)
    centres = colors[np.arange(k) * (N // k)].copy()
    t_colors = torch.from_numpy(colors)
    for _ in range(iters):
        lbl = tcrf._sq_dist(t_colors, torch.from_numpy(centres)).argmin(
            1).numpy()
        lj = np.where(inside, lbl[np.where(inside, j, 0)], -1)
        # (B, M, 32, k, 3) colours times 1 for the cluster, else 0 (the
        # kernel adds that zero)
        onehot = lj[..., None] == np.arange(k)
        vals = (pts[..., None, :] * onehot[..., None]).astype(np.float32)
        part = _tree(_lane_sums(vals.reshape(blocks, M, LANES, k * 3)))
        cnt = onehot.sum((1, 2)).astype(np.float32)            # (B, k)
        part = np.concatenate([part.reshape(blocks, k, 3), cnt[..., None]],
                              -1).reshape(blocks, 4 * k)
        # sum q adds blocks q, q + GROUPS, ... in order; then the GROUPS
        # sums in order
        R = -(-blocks // GROUPS)
        rows = np.zeros((R * GROUPS, 4 * k), np.float32)
        rows[:blocks] = part
        sub = _lane_sums(rows.reshape(1, R, GROUPS, 4 * k))[0]
        tot = _lane_sums(sub[None, :, None])[0, 0].reshape(k, 4)
        c = tot[:, 3:]
        centres = np.where(c > 0, tot[:, :3] / np.maximum(c, 1),
                           centres).astype(np.float32)
    return tcrf._sq_dist(t_colors, torch.from_numpy(centres)).argmin(
        1).numpy()


# (N, blocks): one block, clusters as kmeans_plan picks them, a cluster
# the kernel capped at a card's largest (8, the portable size; 3, whose
# blocks' runs exceed KMEANS_TILE and are read in tiles: a lane's points
# stay in the same order), and a cooperative grid of a block an SM over
# the same points
RUNS = [(300, 1), (5000, 10), (5000, SMS), (40000, 16), (40000, 8),
        (40000, 3), (40000, SMS)]


@pytest.fixture(scope='module')
def references():
    """The plain and the JAX labels of each N's guide (k = 10)."""
    import jax
    from cartoonsegmentation_tpu.ops import crf as jcrf
    out = {}
    for N in sorted({n for n, _ in RUNS}):
        g = _guide(N, seed=N)
        out[N] = (g, tcrf._kmeans_labels(torch.from_numpy(g), 10).numpy(),
                  np.asarray(jax.jit(lambda x: jcrf._kmeans_labels(x, 10))(
                      g)))
    return out


@pytest.mark.parametrize('N,blocks', RUNS)
def test_kmeans_schedule_vs_plain_and_jax(references, N, blocks):
    g, plain, jax_labels = references[N]
    got = kmeans_schedule(g, 10, blocks)
    assert float((got == plain).mean()) >= SHARE
    assert float((got == jax_labels).mean()) >= SHARE
    # the plain version equals JAX here (XLA's contraction)
    np.testing.assert_array_equal(plain, jax_labels)


@pytest.mark.parametrize('k', [1, 16])
def test_kmeans_schedule_k_extremes(k):
    """k = 1 (every label 0) and k = 16 (some clusters empty: they keep
    their centre) on a cluster of 8 blocks."""
    g = _guide(4000, seed=k)
    got = kmeans_schedule(g, k, 8)
    want = tcrf._kmeans_labels(torch.from_numpy(g), k).numpy()
    assert float((got == want).mean()) >= SHARE
    if k == 1:
        assert not got.any()


def test_kmeans_plan_paths():
    """Up to KMEANS_CLUSTER_POINTS points one cluster of a block per
    KMEANS_THREADS points (1 to 16 blocks, no scratch); past it one
    cooperative block an SM with two rows of 16 x 4 floats a block."""
    T, C = tcrf.KMEANS_THREADS, tcrf.KMEANS_CLUSTER_POINTS
    assert tcrf.kmeans_plan(1, SMS) == (1, False, 0)
    assert tcrf.kmeans_plan(T, SMS) == (1, False, 0)
    assert tcrf.kmeans_plan(T + 1, SMS) == (2, False, 0)
    assert tcrf.kmeans_plan(11600, SMS) == (16, False, 0)
    assert tcrf.kmeans_plan(C, 0) == (16, False, 0)
    assert tcrf.kmeans_plan(C + 1, SMS) == (SMS, True, 2 * SMS * 64)
    assert tcrf.kmeans_plan(576 * 1024, SMS) == (SMS, True, 2 * SMS * 64)
    # a cluster's blocks hold their points in shared memory
    assert -(-C // tcrf.KMEANS_CLUSTER_BLOCKS) <= tcrf.KMEANS_TILE
    # the CRF clip's crops (16x176 to 419x101 px) all take a cluster
    for h, w in ((16, 176), (419, 101), (158, 173)):
        assert not tcrf.kmeans_plan(h * w, SMS)[1]


def test_kmeans_wrapper_launch(monkeypatch):
    """On a card the wrapper makes one launch with the plan's blocks and
    one buffer: the labels, then the scratch from a 16-byte boundary."""
    from cartoonsegmentation_torch.ops import _cuda
    calls = []
    monkeypatch.setattr(_cuda, 'launch',
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(_cuda, 'stream_ptr', lambda t: 7)
    monkeypatch.setattr(_cuda, 'sm_count', lambda t: SMS)
    for N in (1000, 70001):
        calls.clear()
        colors = torch.empty((N, 3), device='meta')
        out = tcrf.kmeans_labels(colors, 10)
        assert out.shape == (N,) and out.dtype == torch.int32
        (name, a), = calls
        blocks, coop, scratch = tcrf.kmeans_plan(N, SMS)
        assert name == 'kmeans' and a[1:6] == (N, 10, 8, blocks, int(coop))
        assert a[6] - a[7] == 4 * (-(-N // 4) * 4)

"""K10, the cloud compaction, and the Ken Burns clip's cloud copies, on
the CPU.

- ``csrc/compact.cu``'s plan emulated in numpy: tiles handed out by a
  counter to blocks in any order; each tile's mask, its ranks by
  (round, warp) counts and ballots (or, for a dense tile, its whole
  run); the counts published at once and the look-back over 128 tiles
  a step in a random order of blocks; each tile's run written at its
  offset and cut at the capacity; the count from the last tile; the
  two-slot scratch that each call leaves for the next. Held exactly
  against ``append_masked_plain`` and the JAX package's
  ``PointCloud.append_masked``.
- The clip: ``inpaint_extremes`` appends its two passes to one copy of
  the state's cloud (the inpaint net stubbed), so two calls on one
  state give equal clouds and leave ``state.cloud`` as it was; and
  ``_prepare_state``'s cloud, appended in place, equals JAX's.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.config import KenBurnsConfig as JConfig
from cartoonsegmentation_tpu.instances import Instances as JInstances
from cartoonsegmentation_tpu.pipeline.kenburns import \
    KenBurnsPipeline as JPipeline
from cartoonsegmentation_tpu.pipeline.state import PointCloud as JCloud
from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.instances import Instances
from cartoonsegmentation_torch.pipeline import state as tstate
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from torch_cpu import torch_threads  # noqa: F401  (autouse)

SRC = (Path(tstate.__file__).resolve().parent.parent / 'csrc' /
       'compact.cu').read_text()


def _const(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SRC).group(1))


THREADS, ROUNDS, LOOK = _const('kThreads'), _const('kRounds'), _const('kLook')
TILE = THREADS * ROUNDS
AGG, INCL = 1, 2
FIELDS = ('points', 'colors', 'disparity', 'depth', 'count')
_jax_append = jax.jit(JCloud.append_masked)


def test_tile_matches_the_wrapper():
    assert TILE == tstate.COMPACT_TILE == 2048


def _ranks(m):
    """A sparse tile's ranks as the kernel forms them: entry e = r *
    THREADS + t (warp t // 32, lane t % 32); the (round, warp) counts
    scanned in that order, plus the set lanes below in the warp."""
    m = m.reshape(ROUNDS, THREADS // 32, 32)
    counts = m.sum(-1).ravel()
    before = (np.cumsum(counts) - counts).reshape(ROUNDS, THREADS // 32)
    below = np.cumsum(m, -1) - m
    return (before[..., None] + below).ravel(), int(counts.sum())


def _look_back(status, tile):
    """Warp 0's walk: kLook x 32 tiles a step, lane l the tiles end - l
    - 32 j; the counts down to the nearest inclusive prefix."""
    before, end = 0, tile - 1
    while True:
        dist = np.arange(32 * LOOK)
        t = end - dist
        words = [status[i] if i >= 0 else (AGG, 0) for i in t]
        assert all(f != 0 for f, _ in words)    # every tile published
        incl = [d for d, (f, _) in zip(dist, words) if f == INCL]
        stop = min(incl) if incl else 32 * LOOK
        before += sum(v for d, (_, v) in zip(dist, words) if d <= stop)
        if incl:
            return before
        end -= 32 * LOOK


def emulate(cloud, args, mask, scratch, rng, vec=True):
    """One call of the kernel on numpy copies: ``cloud`` a dict of the
    cloud's arrays (updated in place), ``scratch`` the per-card words
    (a list of ints: the slot word, two counters, two used counts, then
    the status of tile t in slot s at 5 + 2 t + s)."""
    M = mask.shape[0]
    if M == 0:
        return
    P = cloud['points'].shape[0]
    n_tiles = -(-M // TILE)
    slot = scratch[0]
    # the call starts on a zero slot
    assert scratch[1 + slot] == 0
    assert not any(scratch[5 + 2 * t + slot] for t in range(n_tiles))
    scratch[1 + slot] = n_tiles              # every block takes a tile
    status = {}
    start = min(int(cloud['count']), P)
    runs, totals = {}, {}
    pts, col, disp, dep = args
    for t in range(n_tiles):
        m = np.zeros(TILE, bool)
        part = mask[t * TILE:(t + 1) * TILE]
        m[:part.shape[0]] = part
        idx = t * TILE + np.arange(TILE)
        if vec and part.shape[0] == TILE and part.all():
            order = idx                      # the whole run, as it lies
        else:
            rank, total = _ranks(m)
            order = np.empty(total, np.int64)
            order[rank[m]] = idx[m]
            # the ranks are the stable compaction's
            np.testing.assert_array_equal(order, idx[m])
        totals[t] = order.shape[0]
        runs[t] = (pts[order], col[order], disp[order], dep[order])
        status[t] = (INCL, start + totals[t]) if t == 0 else \
            (AGG, totals[t])
    # look-backs in a random order of the blocks
    offs = {0: start}
    for t in rng.permutation(np.arange(1, n_tiles)):
        offs[t] = _look_back(status, t)
        status[t] = (INCL, offs[t] + totals[t])
    prefix = start + np.concatenate([[0], np.cumsum(
        [totals[t] for t in range(n_tiles)])])
    for t in range(n_tiles):
        assert offs[t] == prefix[t]
        off = offs[t]
        n_out = max(0, min(totals[t], P - off))
        for k, v in zip(('points', 'colors', 'disparity', 'depth'), runs[t]):
            cloud[k][off:off + n_out] = v[:n_out]
    last = n_tiles - 1
    cloud['count'] = np.int32(min(offs[last] + totals[last], P))
    # the last tile zeroes the other slot and hands it to the next call
    other = 1 - slot
    for t in range(scratch[3 + other]):
        scratch[5 + 2 * t + other] = 0
    scratch[1 + other] = 0
    scratch[3 + slot] = n_tiles
    scratch[0] = other
    for t in range(n_tiles):                 # what this call leaves
        scratch[5 + 2 * t + slot] = (status[t][0] << 62) | status[t][1]


def _scratch(max_m):
    return [0] * (5 + 2 * -(-max_m // TILE))


def _case(rng, M, share):
    args = (rng.rand(M, 3).astype(np.float32), rng.rand(M, 3).astype(
        np.float32), rng.rand(M).astype(np.float32),
        rng.rand(M).astype(np.float32))
    return args, rng.rand(M) < share


def _check(P, start, calls, vec=True):
    """The calls (args, mask) on one cloud of capacity P whose count
    starts at `start`: the emulated kernel (two block orders), the plain
    version and JAX's append_masked, all equal. Returns the cloud."""
    clouds = []
    for order_seed in (1, 2):
        c = {k: np.zeros((P, 3) if k in ('points', 'colors') else (P,),
                         np.float32) for k in FIELDS[:-1]}
        c['count'] = np.int32(start)
        scratch = _scratch(max([m.shape[0] for _, m in calls] + [1]))
        for args, m in calls:
            emulate(c, args, m, scratch, np.random.RandomState(order_seed),
                    vec)
        clouds.append(c)
    plain = tstate.PointCloud.with_capacity(P)
    plain.count.fill_(start)
    jc = JCloud.with_capacity(P).replace(count=jnp.int32(start))
    for args, m in calls:
        tstate.append_masked_plain(plain, *map(torch.from_numpy, args),
                                   torch.from_numpy(m))
        jc = _jax_append(jc, *map(jnp.asarray, args), jnp.asarray(m))
    for k in FIELDS:
        want = np.asarray(getattr(jc, k))
        np.testing.assert_array_equal(getattr(plain, k).numpy(), want)
        for c in clouds:
            np.testing.assert_array_equal(c[k], want)
    return clouds[0]


@pytest.mark.parametrize('M,share,P,start,vec', [
    (5000, 1.0, 10000, 0, True),        # two dense tiles, a ragged one
    (9000, 0.03, 27000, 123, True),     # the inpainting appends' share
    (7000, 0.9, 3300, 300, True),       # P crossed inside tile 1
    (6144, 1.0, 7000, 2000, True),      # P crossed inside a dense tile
    (2049, 0.5, 5000, 10, True),        # one entry past a tile
    (1, 1.0, 10, 3, True),
    (0, 1.0, 10, 3, True),              # no launch: the cloud as it was
    (5000, 1.0, 10000, 0, False),       # unaligned: every tile ranked
])
def test_emulated_plan_matches_plain_and_jax(M, share, P, start, vec):
    args, mask = _case(np.random.RandomState(M + P), M, share)
    c = _check(P, start, [(args, mask)], vec)
    assert int(c['count']) == min(start + int(mask.sum()), P)


def test_emulated_slots_across_calls():
    """Calls of several sizes on one scratch: each starts on a zero
    slot, the slots alternate, and the cloud grows as JAX's does, its
    last append overflowing."""
    rng = np.random.RandomState(5)
    calls = [_case(rng, M, s) for M, s in (
        (9000, 1.0), (300, 0.5), (20000, 0.03), (4096, 1.0), (7000, 0.7),
        (13000, 0.9))]
    c = _check(24000, 0, calls)
    assert int(c['count']) == 24000


# -- the clip's cloud copies ------------------------------------------
H, W = 24, 32
CFG = dict(detector='none', dtype='float32', render_payload_dtype='float32',
           max_size=32, num_frame=4)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    image = rng.rand(H, W, 3).astype(np.float32)
    disparity = (0.2 + np.sin(xx / 5) * np.cos(yy / 7) ** 2 +
                 rng.rand(H, W) * 0.05).astype(np.float32)[..., None]
    disparity[:3, :4] = 0.0                  # a few invalid pixels
    return image, disparity


def _forward(state, su, sv, ds):
    """A stand-in for the inpaint net: a hole band that moves with the
    camera, its colours and disparity from the state."""
    band = torch.zeros((H, W, 1))
    x0 = int(abs(su)) % (W - 6)
    band[:, x0:x0 + 6] = 1.0
    out = {'image': state.image.flip(1), 'existing': 1.0 - band,
           'disparity': state.disparity * 0.9 + 0.01}
    return out, torch.tensor([su * 0.01, sv * 0.01, 0.0])


def test_inpaint_extremes_copies_the_cloud_once():
    pipe = TPipeline(TConfig(**CFG), device='cpu')
    pipe._inpaint_forward = _forward
    image, disparity = _inputs()
    state = pipe._prepare_state(torch.from_numpy(image),
                                torch.from_numpy(disparity),
                                Instances.empty(4, H, W))
    before = state.cloud.clone()
    boxes = ({'center_u': W / 2, 'center_v': H / 2, 'crop_w': 30,
              'crop_h': 22},
             {'center_u': W / 2 + 9.0, 'center_v': H / 2 - 3.0,
              'crop_w': 26, 'crop_h': 19})
    a = pipe.inpaint_extremes(state, *boxes)
    b = pipe.inpaint_extremes(state, *boxes)
    for k in FIELDS:
        assert torch.equal(getattr(state.cloud, k), getattr(before, k)), k
        assert torch.equal(getattr(a.cloud, k), getattr(b.cloud, k)), k
    # two passes of 6-pixel bands appended after the prepared points
    assert int(a.cloud.count) == H * W + 2 * H * 6
    # the same passes through the functional append, one copy a pass
    ref = state
    for t in (0.0, 1.0):
        ref = pipe.inpaint_pass(ref, *pipe._camera_params(t, *boxes,
                                                          ref)[:3])
    ref = pipe.compact_state(ref)
    for k in FIELDS:
        assert torch.equal(getattr(a.cloud, k), getattr(ref.cloud, k)), k


def test_prepare_state_cloud_matches_jax():
    image, disparity = _inputs(1)
    tp = TPipeline(TConfig(**CFG), device='cpu')
    st = tp._prepare_state(torch.from_numpy(image),
                           torch.from_numpy(disparity),
                           Instances.empty(4, H, W))
    jp = JPipeline(JConfig(**CFG), seed=0)
    sj = jp._prepare_state(jnp.asarray(image), jnp.asarray(disparity),
                           JInstances.empty(4, H, W))
    assert st.cloud.capacity == sj.cloud.capacity == 2 * H * W
    assert int(st.cloud.count) == int(sj.cloud.count) == H * W
    # every entry in its slot, the rest empty: the appended arrays
    # exactly, in the port and in JAX
    for cloud, s in ((st.cloud, st), (sj.cloud, sj)):
        for k, v in (('points', s.raw_points), ('colors', s.image),
                     ('disparity', s.disparity), ('depth', s.depth)):
            got = np.asarray(getattr(cloud, k))
            np.testing.assert_array_equal(got[:H * W],
                                          np.asarray(v).reshape(got[:H * W]
                                                                .shape))
            assert not got[H * W:].any()
    # the appended values agree to the unprojection's f32 rounding
    # (measured 2.7e-7 relative)
    for k in FIELDS[:-1]:
        np.testing.assert_allclose(getattr(st.cloud, k).numpy(),
                                   np.asarray(getattr(sj.cloud, k)),
                                   rtol=1e-6, atol=0)

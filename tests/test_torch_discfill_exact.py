"""K11, the exact disocclusion fill, on the cases its warp-per-hole
kernel (csrc/discfill_exact.cu) must get right: equal squared gaps in
two directions, equal endpoint depths, a band of holes along the whole
border, a frame of holes only, a single valid pixel, a run of holes
longer than 128 steps, K = 16, 32, 128 and 256, C = 1, 3, 4 and 5.

On the CPU: the port's plain version against the JAX package's
``fill_disocclusion``, exactly; and the kernel's warp-a-hole schedule
emulated in Python against the plain version, exactly, on every hole,
with every early stop checked against the direction's unstopped walk
(32 half-lines in batches of 4 steps from the packed step table, each
direction stopped once its two sides' squared offsets reach the best
gap^2; the last few half-lines walked one at a time by the whole warp;
one integer reduce of gap^2·16 + direction for the winner). On the card
(marked ``gpu``) the kernel against its plain version at 576x1024.
JAX is imported only where the JAX results are made, so the card's
tests also run on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_discfill_exact.py
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.ops import discfill as tdiscfill
from torch_cpu import torch_threads  # noqa: F401  (autouse)

CASES = ('blobs', 'ties', 'ring', 'all', 'single', 'c1', 'c3')
H, W = 19, 31
LONG = (4, 300)     # the 'long' case: a run of holes 180 px wide
AHEAD = 4           # csrc/discfill_exact.cu: kAhead
ROUNDS = 4          # kRounds
SWITCH = 8          # kSwitch
NO_GAP = 1 << 24    # kNoGap


def _case(name, h, w, seed=0):
    """(img (h, w, C), depth (h, w)) f32 of case ``name``."""
    rng = np.random.RandomState(seed)
    C = {'c1': 1, 'c3': 3, 'c5': 5}.get(name, 4)
    # c1 and c3 are the first channels of c5 (same depth)
    img = rng.rand(h, w, 5)[..., :C].astype(np.float32)
    depth = (rng.rand(h, w) + 0.5).astype(np.float32)
    if name == 'ties':
        # one depth everywhere: every winner's endpoints tie on depth
        # (the "from" end wins); isolated holes tie on the gap between
        # the vertical and the horizontal direction (the lower wins)
        depth[:] = 1.0
        depth[rng.rand(h, w) < 0.08] = 0.0
        depth[h // 2, 3:9] = 0.0
        depth[2:7, w // 3] = 0.0
    elif name == 'ring':
        # a band of holes along the border, as a render of a cloud moved
        # away from the camera leaves
        depth[:, :7] = 0.0
        depth[:, -5:] = 0.0
        depth[:3] = 0.0
        depth[-4:] = 0.0
    elif name == 'all':
        depth[:] = 0.0
    elif name == 'single':
        depth[:] = 0.0
        depth[h // 3, w // 4] = 0.7
    elif name == 'long':
        # a run of holes 180 px wide across every row: every direction
        # but the horizontal leaves the frame, whose walks from the
        # run's ends need more than 128 steps
        depth[:, 60:240] = 0.0
        depth[rng.rand(h, w) < 0.05] = 0.0
    else:
        # the render's holes: a blob, a border band, speckle; a few
        # negative depths (holes) and NaNs (neither hole nor valid)
        depth[h // 4:h // 2, w // 4:w // 2] = 0.0
        depth[:, :2] = 0.0
        depth[rng.rand(h, w) < 0.1] = 0.0
        depth[rng.rand(h, w) < 0.02] = -1.0
        depth[rng.rand(h, w) < 0.01] = np.nan
    return img, depth


# (case, max_steps) held against JAX; C = 1 and 3 are C = 5's channels
JAX_RUNS = [(name, 128) for name in CASES] + [
    ('blobs', 16), ('ring', 32), ('long', 128), ('long', 256)]


@pytest.fixture(scope='module')
def jax_fills():
    """The JAX package's fill of every (case, max_steps) of JAX_RUNS."""
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.ops import discfill as jdiscfill
    out = {}
    for name, K in JAX_RUNS:
        src = 'c5' if name in ('c1', 'c3') else name
        if (src, K) not in out:
            img, depth = _case(src, *(LONG if src == 'long' else (H, W)))
            out[(src, K)] = np.asarray(jdiscfill.fill_disocclusion(
                jnp.asarray(img), jnp.asarray(depth), max_steps=K))
    for name, K in JAX_RUNS:
        if name in ('c1', 'c3'):
            out[(name, K)] = out[('c5', K)][..., :int(name[1])]
    return out


@pytest.mark.parametrize('name,K', JAX_RUNS)
def test_fill_exact_plain_vs_jax(jax_fills, name, K):
    img, depth = _case(name, *(LONG if name == 'long' else (H, W)))
    got = tdiscfill.fill_disocclusion_plain(torch.from_numpy(img),
                                            torch.from_numpy(depth), K)
    np.testing.assert_array_equal(got.numpy(), jax_fills[(name, K)])


def test_kernel_table_is_the_offset_table():
    """The packed table's words unpack to offset_table's (dy, dx); the
    pad word is 0; the offsets keep each component's sign and the
    larger component is at least 1 (the early stop's premise)."""
    for K in (16, 128, 256):
        tab = tdiscfill.kernel_table(K)
        offs = tdiscfill.offset_table(K)
        assert tab.shape == (K, tdiscfill.TABLE_ROW) and tab.dtype == np.int32
        dy = (tab[:, :16].astype(np.int64) + 32768) >> 16
        dx = tab[:, :16] - dy * 65536
        np.testing.assert_array_equal(dy.T, offs[..., 0])
        np.testing.assert_array_equal(dx.T, offs[..., 1])
        assert not tab[:, 16].any()
        sy = np.sign(tdiscfill._DIR_Y)[:, None]
        sx = np.sign(tdiscfill._DIR_X)[:, None]
        assert (offs[..., 0] * sy >= 0).all() and (offs[..., 1] * sx >= 0).all()
        assert (np.abs(offs).max(-1) >= 1).all()
        r2 = (offs.astype(np.int64) ** 2).sum(-1)
        assert (np.diff(r2, axis=1) >= 0).all()


def _unpack(v):
    dy = (int(v) + 32768) >> 16
    return dy, int(v) - dy * 65536


def _first_event(depth, y0, x0, tab, d, sg, K):
    """One way's first event, unstopped: (found, y, x)."""
    h, w = depth.shape
    for s in range(K):
        dy, dx = _unpack(tab[s, d])
        y, x = y0 + sg * dy, x0 + sg * dx
        if not (0 <= y < h and 0 <= x < w):
            return False, 0, 0
        if depth[y, x] > 0:
            return True, y, x
    return False, 0, 0


def _full_gap(depth, y0, x0, tab, d, K):
    """Direction d's gap^2 when neither way stops early (NO_GAP if a
    way finds nothing)."""
    ff, fy, fx = _first_event(depth, y0, x0, tab, d, -1, K)
    tf, ty, tx = _first_event(depth, y0, x0, tab, d, 1, K)
    return (ty - fy) ** 2 + (tx - fx) ** 2 if ff and tf else NO_GAP


def _settle(lanes):
    """settle over the warp: the pair exchange; returns the best gap^2."""
    for f, t in zip(lanes[::2], lanes[1::2]):
        fs, ts = f['state'], t['state']
        f['state'] = 2 if fs == 0 and ts == 2 else fs
        t['state'] = 2 if ts == 0 and fs == 2 else ts
        gap = NO_GAP
        if f['state'] == 1 and t['state'] == 1:
            gap = (f['ey'] - t['ey']) ** 2 + (f['ex'] - t['ex']) ** 2
        f['gap'] = t['gap'] = gap
    return min(ln['gap'] for ln in lanes)


def _warp_fill(depth, y0, x0, tab, K):
    """csrc/discfill_exact.cu:fill_hole for the hole (y0, x0), a lane at
    a time: returns (source pixel (y, x), rounds of the first phase,
    half-lines walked in the second, the early stops as (direction,
    best gap^2 then))."""
    h, w = depth.shape
    lanes = [dict(d=lane >> 1, sg=1 if lane & 1 else -1, s=0, r2=0, state=0,
                  ey=0, ex=0, ed=0.0, gap=NO_GAP) for lane in range(32)]
    cuts = []
    rounds = 0
    while True:
        for ln in lanes:
            if ln['state'] != 0:
                continue
            for k in range(AHEAD):
                dy, dx = _unpack(tab[ln['s'] + k, ln['d']])
                y, x = y0 + ln['sg'] * dy, x0 + ln['sg'] * dx
                if ln['state'] != 0:
                    continue
                ln['r2'] = dy * dy + dx * dx
                if not (0 <= y < h and 0 <= x < w):
                    ln['state'] = 2
                elif depth[y, x] > 0:
                    ln.update(state=1, ey=y, ex=x, ed=depth[y, x])
            ln['s'] += AHEAD
            if ln['state'] == 0 and ln['s'] >= K:
                ln['state'] = 2
        rounds += 1
        best = _settle(lanes)
        stop = [ln['state'] == 0 and ln['r2'] + lanes[i ^ 1]['r2'] >= best
                for i, ln in enumerate(lanes)]
        for ln, st in zip(lanes, stop):
            if st:
                ln['state'] = 2
                cuts.append((ln['d'], best))
        for f, t in zip(lanes[::2], lanes[1::2]):
            fs, ts = f['state'], t['state']
            f['state'] = 2 if fs == 0 and ts == 2 else fs
            t['state'] = 2 if ts == 0 and fs == 2 else ts
        walking = sum(ln['state'] == 0 for ln in lanes)
        if walking == 0 or (rounds >= ROUNDS and walking < SWITCH):
            break
    for ln in lanes:
        dy, dx = _unpack(tab[K - 1, ln['d']])
        dy, dx = dy * ln['sg'], dx * ln['sg']
        ty = (h - y0) / dy if dy > 0 else (y0 + 1) / -dy if dy < 0 else 3e38
        tx = (w - x0) / dx if dx > 0 else (x0 + 1) / -dx if dx < 0 else 3e38
        ln['to_edge'] = np.float32(min(ty, tx))
    walked = 0
    while any(ln['state'] == 0 for ln in lanes):
        li = min(k for k, ln in enumerate(lanes) if ln['state'] == 0)
        if lanes[li ^ 1]['state'] == 0 and \
                lanes[li ^ 1]['to_edge'] < lanes[li]['to_edge']:
            li ^= 1
        ln, pr2 = lanes[li], lanes[li ^ 1]['r2']
        for ss in range(ln['s'], ln['s'] + 32 * K):
            if ss >= K:
                ln['state'] = 2
                break
            dy, dx = _unpack(tab[ss, ln['d']])
            y, x = y0 + ln['sg'] * dy, x0 + ln['sg'] * dx
            r2 = dy * dy + dx * dx
            if not (0 <= y < h and 0 <= x < w):
                ln['state'] = 2
                break
            if r2 + pr2 >= best:
                ln['state'] = 2
                cuts.append((ln['d'], best))
                break
            if depth[y, x] > 0:
                ln.update(state=1, ey=y, ex=x, ed=depth[y, x], r2=r2)
                break
        walked += 1
        best = _settle(lanes)
    keys = [ln['gap'] * 16 + ln['d'] for ln in lanes if ln['gap'] < NO_GAP]
    if not keys:
        return (y0, x0), rounds, walked, cuts
    f, t = lanes[2 * (min(keys) & 15)], lanes[2 * (min(keys) & 15) + 1]
    src = (t['ey'], t['ex']) if f['ed'] < t['ed'] else (f['ey'], f['ex'])
    return src, rounds, walked, cuts


# (case, max_steps) the schedule is emulated on
SCHEDULE_RUNS = [(name, 128) for name in CASES if name != 'c3'] + [
    ('blobs', 16), ('ties', 32), ('ring', 16), ('long', 256), ('long', 128)]


@pytest.mark.parametrize('name,K', SCHEDULE_RUNS)
def test_fill_exact_warp_schedule_vs_plain(name, K):
    """The kernel's warp-a-hole schedule, emulated, gives the plain
    version's bits on every hole; no early stop drops a direction whose
    unstopped gap^2 is at most the best gap^2 it was stopped against;
    the isolated holes of 'ties' take one round; the warp's second phase
    runs where walks are long."""
    h, w = LONG if name == 'long' else (H, W)
    img, depth = _case(name, h, w)
    tab = tdiscfill.kernel_table(K)
    want = tdiscfill.fill_disocclusion_plain(
        torch.from_numpy(img), torch.from_numpy(depth), K).numpy()
    by_warp = img.copy()
    runs, n_cuts = {}, 0
    for y0, x0 in zip(*np.nonzero(depth <= 0)):
        src, rounds, walked, cuts = _warp_fill(depth, y0, x0, tab, K)
        by_warp[y0, x0] = img[src]
        runs[(y0, x0)] = (rounds, walked)
        for d, best in cuts:
            assert _full_gap(depth, y0, x0, tab, d, K) > best, (y0, x0, d)
        n_cuts += len(cuts)
    np.testing.assert_array_equal(by_warp, want)
    if name in ('blobs', 'ties', 'long'):
        assert n_cuts > 0
    if name == 'ties':
        lone = [(y, x) for (y, x) in runs
                if 0 < y < h - 1 and 0 < x < w - 1
                and (depth[y - 1:y + 2, x - 1:x + 2] > 0).sum() == 8]
        assert lone and all(runs[k] == (1, 0) for k in lone)
    if name in ('long', 'all'):
        assert any(walked for _, walked in runs.values())


def test_fill_exact_ties_pick_the_first_direction():
    """An isolated hole in a flat field: the vertical (direction 1) and
    horizontal (direction 3) gaps tie at 4; the first wins, and of its
    endpoints of equal depth the "from" end (the row above)."""
    img = np.arange(5 * 5 * 4, dtype=np.float32).reshape(5, 5, 4)
    depth = np.ones((5, 5), np.float32)
    depth[2, 2] = 0.0
    tab = tdiscfill.kernel_table(16)
    src, rounds, walked, _ = _warp_fill(depth, 2, 2, tab, 16)
    assert src == (1, 2) and (rounds, walked) == (1, 0)
    got = tdiscfill.fill_disocclusion_plain(torch.from_numpy(img),
                                            torch.from_numpy(depth), 16)
    np.testing.assert_array_equal(got[2, 2].numpy(), img[1, 2])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('name', CASES + ('long', 'c5'))
def test_fill_exact_kernel_edge_cases(cuda, name):
    """At 576x1024 (the long case at its own size, K = 256): the kernel
    equals its plain version bit for bit, also on a misaligned C = 4
    view (the scalar path)."""
    shape, K = (LONG, 256) if name == 'long' else ((576, 1024), 128)
    img, depth = _case(name, *shape)
    img, depth = torch.from_numpy(img).to(cuda), torch.from_numpy(depth).to(
        cuda)
    want = tdiscfill.fill_disocclusion_plain(img, depth, K)
    assert torch.equal(tdiscfill.fill_disocclusion(img, depth, K), want)
    if img.shape[2] == 4:
        buf = torch.empty(img.numel() + 1, device=cuda)
        odd = buf[1:].view(img.shape)
        odd.copy_(img)
        assert torch.equal(tdiscfill.fill_disocclusion(odd, depth, K), want)

"""K3, the disocclusion fill, on the cases its warp-per-hole kernel
(csrc/discfill.cu) must get right: equal squared gaps in two
directions, equal endpoint depths, holes on every border, a band of
holes along the whole border, a hole row
and column across the frame, a frame of holes only, a single valid
pixel, C = 1, 3, 4 and 5.

On the CPU: the port's plain version against the JAX package's
``fill_disocclusion_fast3``, exactly; and the kernel's schedule
(32 half-lines a hole in batches of 4 steps, each stopped once its
direction cannot win; the last few walked one at a time by the whole
warp; one reduce for the winner) emulated in Python against the plain
version, exactly. On the card (marked ``gpu``) the
kernel against its plain version at 576x1024, also under the sync
debug mode. JAX is imported only where the JAX results are made, so
the card's tests also run on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_discfill3.py
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.ops import discfill3 as tdiscfill3
from torch_cpu import torch_threads  # noqa: F401  (autouse)

CASES = ('blobs', 'ties', 'borders', 'ring', 'row', 'all', 'single', 'c1',
         'c3', 'c5')
H, W = 19, 31
AHEAD = 4           # csrc/discfill.cu: kAhead
ROUNDS = 4          # kRounds
SWITCH = 8          # kSwitch
NO_GAP = 1000000    # kNoGap


def _case(name, h, w, seed=0):
    """(img (h, w, C), depth (h, w)) f32 of case ``name``."""
    rng = np.random.RandomState(seed)
    C = {'c1': 1, 'c3': 3, 'c5': 5}.get(name, 4)
    # c1 and c3 are the first channels of c5 (same depth): the fill
    # picks each hole's source from the depth alone
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
    elif name == 'borders':
        depth[0, ::3] = 0.0
        depth[-1, 1::3] = 0.0
        depth[::2, 0] = 0.0
        depth[1::2, -1] = 0.0
        depth[:3, :4] = 0.0
        depth[-2:, -5:] = 0.0
    elif name == 'ring':
        # a band of holes along the border, as a render of a cloud moved
        # away from the camera leaves: only vertical or horizontal
        # half-lines walk on, and no direction completes
        depth[:, :7] = 0.0
        depth[:, -5:] = 0.0
        depth[:3] = 0.0
        depth[-4:] = 0.0
    elif name == 'row':
        depth[h // 3, :] = 0.0
        depth[:, w // 2] = 0.0
    elif name == 'all':
        depth[:] = 0.0
    elif name == 'single':
        depth[:] = 0.0
        depth[h // 3, w // 4] = 0.7
    else:
        # the render's holes: a blob, a border band, speckle; a few
        # negative depths (holes) and NaNs (neither hole nor valid)
        depth[h // 4:h // 2, w // 4:w // 2] = 0.0
        depth[:, :2] = 0.0
        depth[rng.rand(h, w) < 0.1] = 0.0
        depth[rng.rand(h, w) < 0.02] = -1.0
        depth[rng.rand(h, w) < 0.01] = np.nan
    return img, depth


@pytest.fixture(scope='module')
def jax_fills():
    """The JAX package's fill of every case, computed once (two
    compiles: C = 4 and C = 5, whose first channels c1 and c3 take)."""
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.ops import discfill3 as jdiscfill3
    out = {}
    for name in CASES:
        if name not in ('c1', 'c3'):
            img, depth = _case(name, H, W)
            out[name] = np.asarray(jdiscfill3.fill_disocclusion_fast3(
                jnp.asarray(img), jnp.asarray(depth)))
    out['c1'], out['c3'] = out['c5'][..., :1], out['c5'][..., :3]
    return out


@pytest.mark.parametrize('name', CASES)
def test_fill_plain_vs_jax_edge_cases(jax_fills, name):
    img, depth = _case(name, H, W)
    got = tdiscfill3.fill_disocclusion_plain(torch.from_numpy(img),
                                             torch.from_numpy(depth))
    np.testing.assert_array_equal(got.numpy(), jax_fills[name])


def _off(t, p, q):
    """round(t·p/q), half away from zero, t >= 0 (off_arith)."""
    return (2 * p * t + q) // (2 * q) if p >= 0 \
        else -((2 * -p * t + q) // (2 * q))


def _walk(depth, d, to, y0, x0):
    """csrc/discfill.cu:Walk, the half-line of direction d on side
    ``to`` from the hole (y0, x0)."""
    h, w = depth.shape
    dx, dy = tdiscfill3.DIR_X[d], tdiscfill3.DIR_Y[d]
    rows = abs(dy) >= abs(dx)
    p, q = (dx, dy) if rows else (dy, dx)
    a0, b0 = (y0, x0) if rows else (x0, y0)
    return dict(rows=rows, p=p, q=q, a0=a0, b0=b0, na=h if rows else w,
                nb=w if rows else h, step=1 if to else -1,
                qt0=(2 * abs(p) * a0 + q) // (2 * q))


def _b_at(v, a):
    """Walk::b_at: b = b0 + off(a) - off(a0), 0 <= a < na."""
    sgn = 1 if v['p'] >= 0 else -1
    return v['b0'] + sgn * ((2 * abs(v['p']) * a + v['q']) // (2 * v['q'])
                            - v['qt0'])


def _settle(lanes):
    """csrc/discfill.cu:settle over the warp: returns the best gap."""
    for f, t in zip(lanes[::2], lanes[1::2]):
        fs, ts = f['state'], t['state']
        f['state'] = 2 if fs == 0 and ts == 2 else fs
        t['state'] = 2 if ts == 0 and fs == 2 else ts
        gap = NO_GAP
        if f['state'] == 1 and t['state'] == 1:
            gap = min((f['ea'] - t['ea']) ** 2 + (f['eb'] - t['eb']) ** 2,
                      NO_GAP)
        f['gap'] = t['gap'] = gap
    return min(ln['gap'] for ln in lanes)


def _warp_fill(depth, y0, x0):
    """csrc/discfill.cu:fill_hole for the hole (y0, x0), a lane at a
    time: returns (source pixel (y, x), batches of the first phase,
    half-lines walked in the second)."""
    lanes = []
    for lane in range(32):
        v = _walk(depth, lane >> 1, lane & 1, y0, x0)
        two_q = 2 * v['q']
        rem = 2 * abs(v['p']) * v['a0'] + v['q'] - v['qt0'] * two_q
        lanes.append(dict(v=v, d=lane >> 1, a=v['a0'], b=v['b0'],
                          qt=v['qt0'], rem=rem, state=0, ea=0, eb=0,
                          gap=NO_GAP))
    batches = 0
    while True:
        for ln in lanes:
            if ln['state'] != 0:
                continue
            v = ln['v']
            two_q, drem = 2 * v['q'], 2 * abs(v['p']) * v['step']
            for _ in range(AHEAD):
                # off(a) carried as a quotient and a remainder
                ln['a'] += v['step']
                ln['rem'] += drem
                if ln['rem'] >= two_q:
                    ln['rem'] -= two_q
                    ln['qt'] += 1
                if ln['rem'] < 0:
                    ln['rem'] += two_q
                    ln['qt'] -= 1
                sgn = 1 if v['p'] >= 0 else -1
                ln['b'] = v['b0'] + sgn * (ln['qt'] - v['qt0'])
                a, b = ln['a'], ln['b']
                if 0 <= a < v['na']:
                    assert b == _b_at(v, a)
                if ln['state'] != 0:
                    continue
                if not (0 <= a < v['na'] and 0 <= b < v['nb']):
                    ln['state'] = 2
                elif depth[(a, b) if v['rows'] else (b, a)] > 0:
                    ln['state'], ln['ea'], ln['eb'] = 1, a, b
        batches += 1
        best = _settle(lanes)
        for ln in lanes:
            v = ln['v']
            if ln['state'] == 0 and ((ln['a'] - v['a0']) ** 2
                                     + (ln['b'] - v['b0']) ** 2) >= best:
                ln['state'] = 2
        for f, t in zip(lanes[::2], lanes[1::2]):
            fs, ts = f['state'], t['state']
            f['state'] = 2 if fs == 0 and ts == 2 else fs
            t['state'] = 2 if ts == 0 and fs == 2 else ts
        walking = sum(ln['state'] == 0 for ln in lanes)
        if walking == 0 or (batches >= ROUNDS and walking < SWITCH):
            break
    for ln in lanes:
        v = ln['v']
        ln['to_edge'] = v['na'] - ln['a'] if v['step'] > 0 else ln['a'] + 1
    walked = 0
    while any(ln['state'] == 0 for ln in lanes):
        li = min(k for k, ln in enumerate(lanes) if ln['state'] == 0)
        if lanes[li ^ 1]['state'] == 0 and \
                lanes[li ^ 1]['to_edge'] < lanes[li]['to_edge']:
            li ^= 1
        ln = lanes[li]
        v = ln['v']
        s = abs(ln['a'] - v['a0'])
        while ln['state'] == 0:
            s += 1
            a = v['a0'] + v['step'] * s
            b = _b_at(v, a) if 0 <= a < v['na'] else v['b0']
            if not (0 <= a < v['na'] and 0 <= b < v['nb']) or \
                    s * s + (b - v['b0']) ** 2 >= best:
                ln['state'] = 2
            elif depth[(a, b) if v['rows'] else (b, a)] > 0:
                ln['state'], ln['ea'], ln['eb'] = 1, a, b
        walked += 1
        best = _settle(lanes)
    keys = [ln['gap'] * 16 + ln['d'] for ln in lanes if ln['gap'] < NO_GAP]
    if not keys:
        return (y0, x0), batches, walked
    f, t = lanes[2 * (min(keys) & 15)], lanes[2 * (min(keys) & 15) + 1]
    f, t = ((f['ea'], f['eb']) if f['v']['rows'] else (f['eb'], f['ea']),
            (t['ea'], t['eb']) if t['v']['rows'] else (t['eb'], t['ea']))
    return (t if depth[f] < depth[t] else f), batches, walked


@pytest.mark.parametrize('name', CASES)
def test_fill_warp_schedule_vs_plain(name):
    """The kernel's schedule, emulated, gives the plain version's bits;
    the isolated holes of 'ties' take one batch of the first phase, the
    border holes of 'ring' reach the second (at a size where the
    vertical half-lines outlast the first phase's rounds)."""
    h, w = (64, 96) if name == 'ring' else (H, W)
    img, depth = _case(name, h, w)
    want = tdiscfill3.fill_disocclusion_plain(
        torch.from_numpy(img), torch.from_numpy(depth)).numpy()
    got = img.copy()
    runs = {}
    for y0, x0 in zip(*np.nonzero(depth <= 0)):
        src, *runs[(y0, x0)] = _warp_fill(depth, y0, x0)
        got[y0, x0] = img[src]
    np.testing.assert_array_equal(got, want)
    if name == 'ties':
        lone = [(y, x) for (y, x) in runs
                if 0 < y < h - 1 and 0 < x < w - 1
                and (depth[y - 1:y + 2, x - 1:x + 2] > 0).sum() == 8]
        assert lone and all(runs[k] == [1, 0] for k in lone)
    if name == 'ring':
        assert any(walked for _, walked in runs.values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('name', CASES)
def test_fill_kernel_edge_cases(cuda, name):
    """At 576x1024: the kernel equals its plain version bit for bit,
    also on a misaligned C = 4 view (the scalar path)."""
    img, depth = _case(name, 576, 1024)
    img, depth = torch.from_numpy(img).to(cuda), torch.from_numpy(depth).to(
        cuda)
    want = tdiscfill3.fill_disocclusion_plain(img, depth)
    assert torch.equal(tdiscfill3.fill_disocclusion(img, depth), want)
    if img.shape[2] == 4:
        buf = torch.empty(img.numel() + 1, device=cuda)
        odd = buf[1:].view(img.shape)
        odd.copy_(img)
        assert torch.equal(tdiscfill3.fill_disocclusion(odd, depth), want)


@pytest.mark.gpu
def test_fill_kernel_no_host_sync(cuda):
    img, depth = _case('blobs', 576, 1024)
    img, depth = torch.from_numpy(img).to(cuda), torch.from_numpy(depth).to(
        cuda)
    want = tdiscfill3.fill_disocclusion_plain(img, depth)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = tdiscfill3.fill_disocclusion(img, depth)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)

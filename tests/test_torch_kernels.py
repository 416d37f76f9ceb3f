"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA card (a CUDA kernel has no CPU mode)
and skip without one. This file imports neither JAX nor the JAX
package, so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Exact: z-buffer keys, the w > 0 mask, coverage counts, fill output,
the per-instance medians (K6, NaN values in bin 0), the median-5
(NaN where the plain version has it, the sign of a zero free) and
laplacian (K7), the
NMS keep sets (K8, and K14b's, a graph-captured call too), the
RoIAlign's level map (K14a), the colorize (K5b), the cloud compaction
(K10) and the CRF's norm pass (K12b). Within the stated tolerance:
splat sums, bokeh, the dynamic mask heads (K9: probs within 1e-6,
masks >= 99.99% equal), the RoIAlign (K14a: 1e-5
of the range), the frame epilogue (K5a),
SAM's rel-pos attention (K15a), the k-means labels (K12a: their share),
the CRF steps (K12b), SwinV2's window attention (K15b), the push-pull
fill (K13a) and the jitter refine (K13b: the share of equal hole
pixels).
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import maskrcnn as tmaskrcnn
from cartoonsegmentation_torch.models import rtmdet as trtmdet
from cartoonsegmentation_torch.models import sam as tsam
from cartoonsegmentation_torch.ops import _cuda
from cartoonsegmentation_torch.models import swinv2 as tswin
from cartoonsegmentation_torch.ops import bokeh as tbokeh
from cartoonsegmentation_torch.ops import crf as tcrf
from cartoonsegmentation_torch.ops import discfill as tdiscfill
from cartoonsegmentation_torch.ops import discfill3 as tdiscfill3
from cartoonsegmentation_torch.ops import filters as tfilters
from cartoonsegmentation_torch.ops import inpaint_fill as tfill
from cartoonsegmentation_torch.ops import pointcloud as tpc
from cartoonsegmentation_torch.pipeline import depth as tdepth
from cartoonsegmentation_torch.pipeline import state as tstate
from cartoonsegmentation_torch.utils import image as timage
from torch_cpu import torch_threads  # noqa: F401  (autouse)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


def _cloud(rng, P):
    """Random cloud with in-frame tiny-z points whose key 1e6 − f·b/z
    goes negative (f·b = 1920 here) and some invalid (z = 0) slots."""
    pts = np.stack([rng.uniform(-30, 30, P), rng.uniform(-20, 20, P),
                    rng.uniform(0.5, 80, P)], 1).astype(np.float32)
    z = rng.uniform(0.001, 0.0019, 60).astype(np.float32)
    pts[:60, :2] *= z[:, None] / 40.0
    pts[:60, 2] = z
    pts[60:120, 2] = 0.0
    return torch.from_numpy(pts)


def _holes(rng, H, W, C=4):
    img = rng.rand(H, W, C).astype(np.float32)
    depth = rng.rand(H, W).astype(np.float32) + 0.5
    depth[H // 4:H // 2, W // 4:W // 2] = 0.0
    depth[:, :2] = 0.0
    depth[rng.rand(H, W) < 0.1] = 0.0
    img[depth == 0] = 0.0
    return torch.from_numpy(img), torch.from_numpy(depth)


@pytest.mark.gpu
@pytest.mark.parametrize('C', [4, 68, 2, 12, 16])
def test_splat_kernel_vs_plain(rng, cuda, C):
    H, W = 96, 128
    pts = _cloud(rng, 20000).to(cuda)
    data = torch.from_numpy(rng.rand(20000, C).astype(np.float32)).to(cuda)
    rk, wk, zk = tpc.splat(pts, data, H, W, 48.0, 40.0)
    rp, wp, zp = tpc.splat_plain(pts, data, H, W, 48.0, 40.0)
    assert (zp < 0).any()
    assert torch.equal(zk, zp)
    assert torch.equal(wk > 0, wp > 0)
    # f32 atomics sum in another order than index_add_
    torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(wk, wp, rtol=1e-4, atol=1e-5)


def _splat_layout(rng, case, H, W, focal):
    """(points, focal) of a cloud laid out to stress csrc/splat.cu's
    tiles: 'grid' a shifted depth grid with z = 0 slots, 'shuffled' the
    same in random order, 'copies' the grid with 3,000 copies of one
    point in front in its z = 0 slots (an inpainting pass appends such
    copies), 'crowded' every point inside one 16x16 tile, 'borders'
    points whose projections sit on tile borders, on whole pixels
    (zero-weight corners) and at half pixels."""
    if case in ('grid', 'shuffled', 'copies'):
        depth = rng.uniform(20, 40, (H, W)).astype(np.float32)
        depth[H // 3:H // 2, W // 4:W // 2] = 8.0
        pts = tpc.depth_to_points(torch.from_numpy(depth), focal)
        pts = pts.reshape(-1, 3) + torch.tensor([0.9, -0.4, 1.5])
        pts = torch.cat([pts, torch.zeros((H * W // 5, 3))])
        if case == 'copies':
            pts[H * W:H * W + 3000] = torch.tensor([-1.0, 0.5, 6.0])
        if case == 'shuffled':
            pts = pts[torch.from_numpy(rng.permutation(pts.shape[0]))]
        return pts.contiguous(), focal
    n = 30000
    z = rng.uniform(5, 50, n).astype(np.float32)
    if case == 'crowded':
        u = rng.uniform(32, 47.99, n)
        v = rng.uniform(16, 31.99, n)
    else:
        u = rng.choice([15.5, 16.0, 31.5, 32.0, 47.25, 15.0, 16.5], n)
        v = rng.choice([15.5, 16.0, 31.0, 31.5, 47.5, 0.0, 16.5], n)
        u = u + rng.randint(0, W // 16, n) * 16.0
        v = v + rng.randint(0, H // 16, n) * 16.0
    # u = x·f/z + W/2 - 1/2
    x = ((u - 0.5 * W + 0.5) * z / focal).astype(np.float32)
    y = ((v - 0.5 * H + 0.5) * z / focal).astype(np.float32)
    return torch.from_numpy(np.stack([x, y, z], 1)), focal


@pytest.mark.gpu
@pytest.mark.parametrize('C', [2, 4, 68])
@pytest.mark.parametrize('case', ['shuffled', 'crowded', 'borders',
                                  'copies'])
def test_splat_kernel_layouts(rng, cuda, C, case):
    """The tiled splat at a frame size that is no multiple of its tile
    (97x131) and with skewed or border-hugging clouds: the z-buffer
    and the w > 0 mask exact, the sums within tolerance, and (for the
    shuffled grid) the same z-buffer and mask as the grid in order."""
    H, W = 97, 131
    pts, focal = _splat_layout(rng, case, H, W, 60.0)
    data = torch.from_numpy(rng.rand(pts.shape[0], C).astype(np.float32))
    pts, data = pts.to(cuda), data.to(cuda)
    rk, wk, zk = tpc.splat(pts, data, H, W, focal, 40.0)
    rp, wp, zp = tpc.splat_plain(pts, data, H, W, focal, 40.0)
    assert (wp > 0).sum() > 50
    assert torch.equal(zk, zp)
    assert torch.equal(wk > 0, wp > 0)
    # shared-memory atomics sum in another order than index_add_
    torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(wk, wp, rtol=1e-4, atol=1e-5)
    if case == 'shuffled':
        po, fo = _splat_layout(np.random.RandomState(0), 'grid', H, W, 60.0)
        ro, wo, zo = tpc.splat(po.to(cuda), data[:po.shape[0]], H, W, fo,
                               40.0)
        assert torch.equal(zo, zk) and torch.equal(wo > 0, wk > 0)


@pytest.mark.gpu
def test_splat_kernel_skips_non_finite_points(rng, cuda):
    """NaN and infinite coordinates drop out as in the plain version."""
    pts = _cloud(rng, 3000)
    pts[200:260, 0] = float('nan')
    pts[260:300, 1] = float('inf')
    pts[300:340, 2] = float('nan')
    pts, data = pts.to(cuda), torch.from_numpy(
        rng.rand(3000, 4).astype(np.float32)).to(cuda)
    rk, wk, zk = tpc.splat(pts, data, 40, 56, 48.0, 40.0)
    rp, wp, zp = tpc.splat_plain(pts, data, 40, 56, 48.0, 40.0)
    assert torch.equal(zk, zp)
    assert torch.equal(wk > 0, wp > 0)
    torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_splat_kernel_channel_chunks(rng, cuda):
    """C = 1000 takes five channel chunks a tile, the last of 100."""
    assert tpc.splat_plan(40, 56, 1000)[0] == 225
    pts = _cloud(rng, 3000).to(cuda)
    data = torch.from_numpy(rng.rand(3000, 1000).astype(np.float32)).to(cuda)
    rk, wk, zk = tpc.splat(pts, data, 40, 56, 48.0, 40.0)
    rp, wp, zp = tpc.splat_plain(pts, data, 40, 56, 48.0, 40.0)
    assert torch.equal(zk, zp)
    assert torch.equal(wk > 0, wp > 0)
    torch.testing.assert_close(rk, rp, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(wk, wp, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_coverage_kernel_vs_plain(rng, cuda):
    pts = _cloud(rng, 20000).to(cuda)
    shifts = torch.from_numpy(
        rng.uniform(-3, 3, (32, 3)).astype(np.float32)).to(cuda)
    assert torch.equal(tpc.coverage(pts, shifts, 48, 64, 48.0, 40.0),
                       tpc.coverage_plain(pts, shifts, 48, 64, 48.0, 40.0))


def _edge_cloud(H, W):
    """z = 2 (so z/(z + 1e-7) is 1 in f32) and, at focal 2, u = x +
    W/2 - 0.5 exactly: u, v on pixel centres (a zero corner weight), on
    halves, at x0 = -1 and at W - 1, just outside; z just under and over
    0.001; then 8 points with NaN and infinite coordinates."""
    us = np.array([-1.5, -1.0, -0.5, -0.25, 0.0, 0.5, 3.0, 7.25,
                   W - 1.5, W - 1.0, W - 0.5, W - 0.25, W, W + 0.5],
                  np.float32)
    vs = np.array([-1.0, -0.5, 0.0, 0.5, 2.0, H / 2 - 0.5, H - 1.5,
                   H - 1.0, H - 0.5, H], np.float32)
    uu, vv = np.meshgrid(us, vs)
    pts = np.stack([uu.ravel() - np.float32(W / 2 - 0.5),
                    vv.ravel() - np.float32(H / 2 - 0.5),
                    np.full(uu.size, 2.0, np.float32)], 1)
    z1 = np.float32(0.001)
    tiny = np.array([[1e-6, 1e-6, 0.000999], [1e-6, -1e-6, z1],
                     [-1e-6, 1e-6, np.nextafter(z1, np.float32(0))],
                     [1e-6, 1e-6, np.nextafter(z1, np.float32(1))]])
    bad = np.array([[np.nan, 0, 2], [0, np.nan, 2], [0, 0, np.nan],
                    [np.inf, 0, 2], [0, -np.inf, 2], [0, 0, np.inf],
                    [0, 0, -np.inf], [-np.inf, np.inf, 2]])
    return np.concatenate([pts, tiny, bad]).astype(np.float32)


def _coverage_equal(pts, shifts, H, W, focal):
    got = tpc.coverage(pts, shifts, H, W, focal, 40.0)
    want = tpc.coverage_plain(pts, shifts, H, W, focal, 40.0)
    assert torch.equal(got, want), (got != want).nonzero()
    return got


@pytest.mark.gpu
def test_coverage_kernel_edges(rng, cuda):
    """Pixel centres, x0 = -1 and W - 1, z at 0.001, NaN and inf, under
    shifts that keep the points on centres and shifts that move them."""
    H, W = 21, 30
    shifts = np.concatenate([
        np.zeros((1, 3)), [[1, 0, 0], [0, -1, 0], [0.5, 0.5, 0],
                           [0, 0, 0.0005]],
        rng.uniform(-2, 2, (4, 3))]).astype(np.float32)
    _coverage_equal(torch.from_numpy(_edge_cloud(H, W)).to(cuda),
                    torch.from_numpy(shifts).to(cuda), H, W, 2.0)


@pytest.mark.gpu
def test_coverage_kernel_empty(rng, cuda):
    """No points: every count 0; no candidates: no counts."""
    shifts = torch.from_numpy(rng.uniform(-1, 1, (3, 3)).astype(
        np.float32)).to(cuda)
    got = _coverage_equal(torch.zeros((0, 3), device=cuda), shifts, 20, 30,
                          16.0)
    assert not got.any()
    got = tpc.coverage(_cloud(rng, 500).to(cuda),
                       torch.zeros((0, 3), device=cuda), 20, 30, 16.0, 40.0)
    assert got.dtype == torch.int32 and got.shape == (0,)


@pytest.mark.gpu
def test_coverage_kernel_partial_group(rng, cuda):
    """265 candidates in groups of two: the last group holds one. 20,001
    points: the last tile's bulk copy stops 12 bytes short of its last
    point, which its thread reads from global memory."""
    shifts = torch.from_numpy(
        rng.uniform(-3, 3, (265, 3)).astype(np.float32)).to(cuda)
    assert tpc.coverage_plan(265, 48, 64, _cuda.sm_count(shifts))[0] == 2
    _coverage_equal(_cloud(rng, 20001).to(cuda), shifts, 48, 64, 48.0)


@pytest.mark.gpu
def test_coverage_kernel_unaligned_points(rng, cuda):
    """A cloud that starts 12 bytes into its buffer (the bulk copies
    read 16-byte units: the wrapper copies it)."""
    pts = _cloud(rng, 5004).to(cuda)[1:]
    assert pts.data_ptr() % 16 == 12
    shifts = torch.from_numpy(
        rng.uniform(-3, 3, (7, 3)).astype(np.float32)).to(cuda)
    _coverage_equal(pts, shifts, 48, 64, 48.0)


@pytest.mark.gpu
@pytest.mark.parametrize('banded', [False, True])
def test_coverage_kernel_full_raster(rng, cuda, monkeypatch, banded):
    """576x1024 (autozoom_stride 1): a bitmap of 72 KB in one band, and
    with a block's shared memory cut so that the same kernel takes
    bands of 128 rows; points on the bands' edges."""
    H, W = 576, 1024
    if banded:
        monkeypatch.setattr(_cuda, 'SMEM_BYTES', _cuda.COVER_TILES_BYTES
                            + _cuda.COVER_STATIC_BYTES + 128 * W // 8)
    G, band_rows, _ = tpc.coverage_plan(
        256, H, W, _cuda.sm_count(torch.empty(0, device=cuda)))
    assert (G, band_rows) == (1, 128 if banded else H)
    pts = np.stack([rng.uniform(-600, 600, 60000),
                    rng.uniform(-350, 350, 60000),
                    rng.uniform(1.5, 3, 60000)], 1).astype(np.float32)
    edge = np.array([[u - (W / 2 - 0.5), v - (H / 2 - 0.5), 2.0]
                     for u in (3.5, 10.0, 1022.5) for v in (
                         127.0, 127.5, 128.0, 255.5, 511.5, 574.5)])
    pts = np.concatenate([pts, edge]).astype(np.float32)
    shifts = np.concatenate([np.zeros((1, 3)), rng.uniform(
        -40, 40, (255, 3)) * [1, 1, 0.01]]).astype(np.float32)
    _coverage_equal(torch.from_numpy(pts).to(cuda),
                    torch.from_numpy(shifts).to(cuda), H, W, 2.0)


@pytest.mark.gpu
def test_coverage_kernel_grid_cloud(cuda):
    """The autozoom's own input at the main path's size: the stride-2
    miniature of a 576x1024 grid cloud and the 16 x 16 candidates."""
    from cartoonsegmentation_torch.ops import camera as tcamera
    H, W, focal = 576, 1024, 512.0
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing='ij')
    depth = 300 + 200 * torch.sin(xx / 150) * torch.cos(yy / 90)
    depth = torch.where((xx - 500) ** 2 + (yy - 300) ** 2 < 150 ** 2,
                        depth * 0.3, depth).to(cuda)
    pts = tpc.depth_to_points(depth, focal)
    mini = pts[::2, ::2].reshape(-1, 3).contiguous()
    dr = tcamera.depth_range(depth)
    lin = torch.linspace(-100.0, 100.0, 16, device=cuda)
    shifts = tcamera.compute_shift(dr, lin.repeat(16),
                                   lin.repeat_interleave(16), dr.min_val,
                                   dr.min_val * 0.8, W, H, focal)
    got = _coverage_equal(mini, shifts.contiguous(), H // 2, W // 2,
                          focal / 2)
    assert int(got.min()) > 0


@pytest.mark.gpu
def test_fill_kernel_vs_plain(rng, cuda):
    img, depth = _holes(rng, 64, 96)
    img, depth = img.to(cuda), depth.to(cuda)
    assert torch.equal(tdiscfill3.fill_disocclusion(img, depth),
                       tdiscfill3.fill_disocclusion_plain(img, depth))


@pytest.mark.gpu
@pytest.mark.parametrize('max_steps', [16, 40, 128])
def test_fill_exact_kernel_vs_plain(rng, cuda, max_steps):
    """Holes at the frame's edges, a block and scattered pixels; 40
    steps rounds down to 32."""
    img, depth = _holes(rng, 64, 96)
    depth[-3:] = 0.0
    img, depth = img.to(cuda), depth.to(cuda)
    assert torch.equal(
        tdiscfill.fill_disocclusion(img, depth, max_steps),
        tdiscfill.fill_disocclusion_plain(img, depth, max_steps))


# CUgraphNodeType values (cuda.h) of the device operations
_NODE_KINDS = {0: 'kernel', 1: 'memcpy', 2: 'memset', 3: 'host',
               10: 'mem_alloc', 11: 'mem_free'}


def _device_ops(fn, lib):
    """The device operations (kernels, copies, memsets; libcuda's
    empty nodes left out) of one call of fn, after a warm-up call, as
    the nodes of a CUDA graph that captures it; and the launches of the
    kernel library `lib` counted in that call. A graph holds every
    operation a call enqueues, where torch.profiler's device trace on
    the card at times records none."""
    import ctypes
    cu = ctypes.CDLL('libcuda.so.1')
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    before = _cuda.LAUNCHES[lib]
    with torch.cuda.graph(graph):
        fn()
    launches = _cuda.LAUNCHES[lib] - before
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    ops = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        if kind.value != 5:
            ops.append(_NODE_KINDS.get(kind.value, f'type {kind.value}'))
    return ops, launches


def _in_graph(fn):
    """fn() captured in a CUDA graph (after a warm-up on a side stream):
    returns (graph, the captured output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _no_sync(fn):
    """fn() under the sync debug mode 'error': a host sync raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _exact_case(rng, case):
    """(img, depth, max_steps) of a K11 case."""
    C = {'c1': 1, 'c3': 3}.get(case, 4)
    if case == 'k256':
        # a run of holes 400 px wide across every row: the horizontal
        # walks from its middle need more than 128 steps
        img, depth = _holes(rng, 48, 700, C)
        depth[:, 150:550] = 0.0
        return img, depth, 256
    img, depth = _holes(rng, 200, 300, C)
    if case == 'holes_only':
        depth[:] = 0.0
    elif case == 'band':
        for t in (depth[:12], depth[-12:], depth[:, :12], depth[:, -12:]):
            t.zero_()
    return img, depth, 128


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['holes_only', 'band', 'k256', 'c1', 'c3',
                                  'c4', 'unaligned'])
def test_fill_exact_kernel_cases(rng, cuda, case):
    """Bit-exact to the plain version on a frame of holes only, a band
    of holes along the border, K = 256 (where it differs from K = 128),
    C = 1, 3 and 4, and a C = 4 buffer off its 16-byte alignment (the
    scalar path)."""
    img, depth, K = _exact_case(rng, case)
    img, depth = img.to(cuda), depth.to(cuda)
    if case == 'unaligned':
        buf = torch.empty(img.numel() + 1, device=cuda)
        img = buf[1:].view(img.shape).copy_(img)
        assert img.data_ptr() % 16 == 4
    want = tdiscfill.fill_disocclusion_plain(img, depth, K)
    assert torch.equal(tdiscfill.fill_disocclusion(img, depth, K), want)
    if case == 'k256':
        assert not torch.equal(
            want, tdiscfill.fill_disocclusion_plain(img, depth, 128))


@pytest.mark.gpu
def test_fill_exact_kernel_one_launch_graph_no_sync(rng, cuda):
    """One kernel and no copy a call (the step table is cached on the
    card), no host sync, two calls bit-equal, and the call captures in
    a CUDA graph that replays on new inputs."""
    img, depth, _ = _exact_case(rng, 'c4')
    img, depth = img.to(cuda), depth.to(cuda)

    def call():
        return tdiscfill.fill_disocclusion(img, depth, 128)
    ops, launches = _device_ops(call, 'discfill_exact')
    assert ops == ['kernel'] and launches == 1, (ops, launches)
    first = _no_sync(call)
    assert torch.equal(first, call())
    graph, out = _in_graph(call)
    img2, depth2, _ = _exact_case(np.random.RandomState(5), 'band')
    img.copy_(img2)
    depth.copy_(depth2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tdiscfill.fill_disocclusion_plain(img, depth,
                                                              128))


@pytest.mark.gpu
def test_bokeh_kernel_vs_plain(rng, cuda):
    img = torch.from_numpy(rng.rand(64, 96, 3).astype(np.float32)).to(cuda)
    weight = torch.from_numpy(
        rng.rand(64, 96).astype(np.float32) * 5e-4).to(cuda)
    # same samples; sequential sums against the plain version's tree sums
    torch.testing.assert_close(tbokeh.bokeh_core(img, weight, 13.0, 32),
                               tbokeh.bokeh_core_plain(img, weight, 13.0,
                                                       32),
                               rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize('H,W,S,wmax', [(576, 1024, 32, 1.0),
                                        (683, 1024, 32, 0.8),
                                        (97, 131, 32, 0.8),
                                        (192, 256, 64, 1.2)])
def test_bokeh_kernel_tiles(rng, cuda, monkeypatch, H, W, S, wmax):
    """The tiled bokeh at the path's 576x1024 with weights at the clip
    maximum (the full halo, 5 px), at 683x1024, at a size no multiple
    of its 32x16 tile and at S = 64 with weights above the clip;
    then the global path (forced by a shared-memory limit of 0), which
    must give the tiled path's bits."""
    img = torch.from_numpy(rng.rand(H, W, 3).astype(np.float32)).to(cuda)
    w = rng.rand(H, W).astype(np.float32) * 5e-4 * wmax
    w[:H // 3] = 5e-4 * wmax
    weight = torch.from_numpy(w).to(cuda)
    assert tbokeh._tiled(H, W, S)
    got = tbokeh.bokeh_core(img, weight, 13.0, S)
    torch.testing.assert_close(got, tbokeh.bokeh_core_plain(img, weight,
                                                            13.0, S),
                               rtol=0, atol=1e-4)
    monkeypatch.setattr(_cuda, 'SMEM_BYTES', 0)
    assert not tbokeh._tiled(H, W, S)
    assert torch.equal(tbokeh.bokeh_core(img, weight, 13.0, S), got)


def _instance_masks(rng, N, H, W):
    """Discs of several sizes, an empty valid mask (slot 2) and invalid
    slots (from slot N - 3 on) with masks that must not be counted."""
    yy, xx = np.mgrid[0:H, 0:W]
    masks = np.zeros((N, H, W), bool)
    for n in range(N):
        cx, cy, r = rng.uniform(0, W), rng.uniform(0, H), rng.uniform(3, H)
        masks[n] = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
    masks[2] = False
    valid = np.ones((N,), bool)
    valid[N - 3:] = False
    return masks, valid


@pytest.mark.gpu
def test_masked_median_kernel_vs_plain(rng, cuda):
    H, W, N = 72, 130, 12
    masks, valid = _instance_masks(rng, N, H, W)
    vals = torch.from_numpy(rng.rand(H, W).astype(np.float32) * 255)
    args = [torch.from_numpy(a).to(cuda) for a in (masks, valid)]
    got = tdepth.masked_median_u8(vals.to(cuda), *args)
    want = tdepth.masked_median_u8_plain(vals.to(cuda), *args)
    assert torch.equal(got, want)
    assert torch.isinf(got[2]) and torch.isfinite(got[0])


@pytest.mark.gpu
@pytest.mark.parametrize('shape', [(1, 45, 77, 1), (2, 9, 35, 3)])
def test_filter_kernels_vs_plain(rng, cuda, shape):
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)
    x[..., :5, :, :] = (x[..., :5, :, :] > 0.5).float()   # ties, as masks
    assert torch.equal(tfilters.median_filter(x, 5),
                       tfilters.median_filter_plain(x, 5))
    assert torch.equal(tfilters.laplacian_filter(x),
                       tfilters.laplacian_filter_plain(x))


def _median5_plane(rng, shape, kind):
    """(B, H, W, C) f32: 'nan': levels with ±0 and ±inf, NaNs of both
    signs over about half the taps (windows of 12 and 13 NaNs); 'mask':
    0/1, as the main path's `existing`; 'floats': uniform values."""
    if kind == 'floats':
        return rng.rand(*shape).astype(np.float32)
    if kind == 'mask':
        return (rng.rand(*shape) > 0.4).astype(np.float32)
    x = rng.choice(np.array([-2.5, -0.0, 0.0, 1.0, np.inf, -np.inf],
                            np.float32), shape)
    nan = rng.rand(*shape) < 0.5
    neg = np.array([0xffc00001], np.uint32).view(np.float32)[0]
    x[nan] = np.where(rng.rand(int(nan.sum())) < 0.5, np.nan, neg)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize('shape', [(1, 576, 1024, 1), (1, 70, 1024, 1),
                                   (1, 5, 33, 1), (1, 3, 3, 1),
                                   (1, 130, 36, 1), (2, 67, 100, 3)])
@pytest.mark.parametrize('kind', ['nan', 'mask', 'floats'])
def test_median5_kernel_cases(rng, cuda, shape, kind):
    """The tile's 16-byte path (C = 1, W % 4 == 0, a whole tile of
    columns) and its scalar one (a ragged last tile, C > 1), H below a
    tile and not a multiple of it; NaN where the plain version has it
    (13 or more NaN taps), the sign of a zero free."""
    x = torch.from_numpy(_median5_plane(rng, shape, kind)).to(cuda)
    torch.testing.assert_close(tfilters.median_filter(x, 5),
                               tfilters.median_filter_plain(x, 5), rtol=0,
                               atol=0, equal_nan=True)


@pytest.mark.gpu
def test_median5_kernel_unaligned(rng, cuda):
    """A contiguous input 4 bytes off a 16-byte boundary takes the
    scalar loads."""
    x = torch.from_numpy(_median5_plane(rng, (1, 64, 128, 1), 'nan'))
    buf = torch.empty(x.numel() + 1, device=cuda)
    xu = buf[1:].view(x.shape)
    xu.copy_(x.to(cuda))
    assert xu.data_ptr() % 16 == 4
    torch.testing.assert_close(tfilters.median_filter(xu, 5),
                               tfilters.median_filter_plain(xu, 5), rtol=0,
                               atol=0, equal_nan=True)


def _median_values(rng, H, W):
    """A map of [0, 255] values with NaNs of both signs, ±inf and values
    past the ends."""
    vals = (rng.rand(H, W) * 300 - 20).astype(np.float32)
    vals[rng.rand(H, W) < 0.05] = np.nan
    vals[rng.rand(H, W) < 0.02] = np.inf
    vals[rng.rand(H, W) < 0.02] = -np.inf
    vals[rng.rand(H, W) < 0.02] = np.array(
        [0xffc00001], np.uint32).view(np.float32)[0]
    return vals


@pytest.mark.gpu
@pytest.mark.parametrize('N,H,W', [(1, 72, 128), (12, 57, 83),
                                   (256, 40, 64), (100, 576, 1024)])
def test_masked_median_kernel_cases(rng, cuda, N, H, W):
    """NaN (bin 0) and ±inf values, an all-zero valid mask, invalid
    slots with masks; H * W a multiple of 16 (16-byte loads) or not."""
    masks, valid = _instance_masks(rng, max(N, 4), H, W)
    masks, valid = masks[:N], valid[:N]
    if N == 1:
        valid[:] = True
    vals = torch.from_numpy(_median_values(rng, H, W)).to(cuda)
    args = [torch.from_numpy(a).to(cuda) for a in (masks, valid)]
    got = tdepth.masked_median_u8(vals, *args)
    want = tdepth.masked_median_u8_plain(vals, *args)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_masked_median_kernel_unaligned_values(rng, cuda):
    """A values map 4 bytes off a 16-byte boundary takes the scalar
    loads."""
    H, W, N = 48, 64, 9
    masks, valid = _instance_masks(rng, N, H, W)
    buf = torch.empty(H * W + 1, device=cuda)
    vals = buf[1:].view(H, W)
    vals.copy_(torch.from_numpy(_median_values(rng, H, W)))
    args = [torch.from_numpy(a).to(cuda) for a in (masks, valid)]
    assert torch.equal(tdepth.masked_median_u8(vals, *args),
                       tdepth.masked_median_u8_plain(vals, *args))


@pytest.mark.gpu
def test_masked_median_kernel_one_launch_graph_no_sync(rng, cuda):
    """One kernel a call (no memset), no host sync, and a graph that
    replays right on new values copied into the captured map."""
    H, W, N = 72, 128, 100
    masks, valid = (torch.from_numpy(a).to(cuda)
                    for a in _instance_masks(rng, N, H, W))
    vals = torch.from_numpy(_median_values(rng, H, W)).to(cuda)

    def call():
        return tdepth.masked_median_u8(vals, masks, valid)
    ops, launches = _device_ops(call, 'insmedian')
    assert ops == ['kernel'] and launches == 1, (ops, launches)
    _no_sync(call)
    graph, got = _in_graph(call)
    for _ in range(2):
        vals.copy_(torch.from_numpy(_median_values(rng, H, W)))
        graph.replay()
        assert torch.equal(got, tdepth.masked_median_u8_plain(vals, masks,
                                                              valid))


@pytest.mark.gpu
def test_masked_median_kernel_leaves_scratch_zero(rng, cuda):
    """A call leaves its histogram and tickets zero, so the next call,
    of other masks and values, starts from zero."""
    for N, H, W in ((100, 72, 128), (30, 57, 83), (100, 72, 128)):
        masks, valid = (torch.from_numpy(a).to(cuda)
                        for a in _instance_masks(rng, N, H, W))
        vals = torch.from_numpy(_median_values(rng, H, W)).to(cuda)
        got = tdepth.masked_median_u8(vals, masks, valid)
        torch.cuda.synchronize()
        assert not bool(tdepth._scratch[vals.device.index].any())
        assert torch.equal(got, tdepth.masked_median_u8_plain(vals, masks,
                                                              valid))


def _nms_case(rng, K):
    """Clusters of heavily overlapping boxes, exact duplicates and tied
    scores (bf16-valued, as the detector's heads give on the card)."""
    centres = rng.uniform(0, 200, (K // 8 + 1, 2))
    c = centres[rng.randint(0, len(centres), K)] + rng.randn(K, 2) * 3
    wh = rng.uniform(10, 40, (K, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    boxes[K // 2:K // 2 + 5] = boxes[K // 2]
    scores = torch.from_numpy(rng.rand(K).astype(np.float32)).bfloat16()
    return torch.from_numpy(boxes), scores.float()


def _signed_scores(rng, K):
    """Scores in a few values with +0.0, -0.0, NaNs of either sign and
    two payloads, -inf and -1.0 among them: the values whose order
    jnp.argsort canonicalises (-0 as +0, every NaN as +NaN) and
    lax.top_k does not."""
    bits = np.array([0x00000000, 0x80000000, 0x7fc00000, 0xffc00000,
                     0x7f800001, 0xff800000, 0xbf800000, 0x3f000000,
                     0x3e800000], np.uint32)
    return torch.from_numpy(bits[rng.randint(0, len(bits), K)]
                            .view(np.float32).copy())


def _nms_kind(rng, K, kind):
    """_nms_case, its scores made _signed_scores ('signed'), or its
    boxes one cluster (all but one suppressed: 'one')."""
    boxes, scores = _nms_case(rng, K)
    if kind == 'signed':
        scores = _signed_scores(rng, K)
    elif kind == 'one':
        boxes = torch.from_numpy(np.array([10, 10, 50, 50], np.float32)
                                 + rng.uniform(0, 0.5, (K, 4))
                                 .astype(np.float32))
    return boxes, scores


@pytest.mark.gpu
@pytest.mark.parametrize('K', [512, 97, 1])
@pytest.mark.parametrize('kind', ['clusters', 'signed', 'one'])
def test_nms_kernel_vs_plain(rng, cuda, K, kind):
    """Every output slot, index and mask, equal to the plain version's
    at max_out K and 100: clustered boxes with tied scores, the signed
    zeros and NaNs, and one cluster (a box kept)."""
    boxes, scores = (t.to(cuda) for t in _nms_kind(rng, K, kind))
    for max_out in (K, 100):
        ki, km = trtmdet.nms_fixed(boxes, scores, 0.6, max_out)
        pi, pm = trtmdet.nms_fixed_plain(boxes, scores, 0.6, max_out)
        assert torch.equal(ki, pi) and torch.equal(km, pm)
    kept = int(trtmdet.nms_fixed(boxes, scores, 0.6, K)[1].sum())
    if kind == 'clusters' and K > 1:
        assert 0 < kept < K
    if kind == 'one':
        assert kept == 1


@pytest.mark.gpu
def test_nms_kernel_one_launch_graph_no_sync(rng, cuda):
    """One kernel a call and no host sync; the call captures in a CUDA
    graph that replays on new inputs copied into the captured ones."""
    cases = [tuple(t.to(cuda) for t in _nms_kind(rng, 512, kind))
             for kind in ('clusters', 'signed')]
    boxes, scores = (t.clone() for t in cases[0])

    def call():
        return trtmdet.nms_fixed(boxes, scores, 0.6, 100)
    ops, launches = _device_ops(call, 'nms')
    assert ops == ['kernel'] and launches == 1, (ops, launches)
    _no_sync(call)
    graph, (ki, km) = _in_graph(call)
    for b, sc in cases[::-1]:
        boxes.copy_(b)
        scores.copy_(sc)
        graph.replay()
        pi, pm = trtmdet.nms_fixed_plain(b, sc, 0.6, 100)
        assert torch.equal(ki, pi) and torch.equal(km, pm)


def _nms_large_case(rng, K, n_cats):
    """_nms_case's clusters at K candidates, with -inf scores (the
    invalid slots of the Mask R-CNN machinery) and category labels."""
    boxes, scores = _nms_case(rng, K)
    scores[rng.rand(K) < 0.2] = -np.inf
    cats = torch.from_numpy(rng.randint(0, n_cats, K).astype(np.int32))
    return boxes, scores, cats


def _nms_large_kind(rng, K, n_cats, kind):
    """_nms_large_case with its scores or boxes made into one of K14b's
    edge cases: scores tied in 4 values, exactly -1.0 (kept rows keyed
    as the rows not kept), +-0.0, the signed zeros and NaNs of
    _signed_scores, or disjoint boxes (nothing suppressed: the walk
    stops at max_out)."""
    boxes, scores, cats = _nms_large_case(rng, K, n_cats)
    if kind == 'ties':
        scores = torch.from_numpy((rng.randint(0, 4, K) / 4.0)
                                  .astype(np.float32))
    elif kind == 'minus_one':
        scores[torch.from_numpy(rng.rand(K) < 0.3)] = -1.0
        scores[torch.from_numpy(rng.rand(K) < 0.1)] = -2.0
    elif kind == 'zeros':
        scores = torch.from_numpy(np.where(rng.rand(K) < 0.5, 0.0, -0.0)
                                  .astype(np.float32))
    elif kind == 'signed':
        scores = _signed_scores(rng, K)
    elif kind == 'disjoint':
        g = torch.arange(K, dtype=torch.float32)
        boxes = torch.stack([g * 20, g * 0, g * 20 + 10, g * 0 + 10], 1)
    return boxes, scores, cats


@pytest.mark.gpu
@pytest.mark.parametrize('K,thr,max_out,n_cats,kind', [
    pytest.param(4756, 0.7, 1000, 5, 'clusters', id='4756-0.7-1000-5'),
    pytest.param(2048, 0.5, 100, 90, 'clusters', id='2048-0.5-100-90'),
    pytest.param(600, 0.6, 600, 1, 'clusters', id='600-0.6-600-1'),
    pytest.param(97, 0.6, 40, 3, 'clusters', id='97-0.6-40-3'),
    (2048, 0.5, 2048, 3, 'ties'), (1000, 0.5, 300, 3, 'minus_one'),
    (1000, 0.5, 1000, 3, 'minus_one'), (300, 0.5, 300, 2, 'zeros'),
    (2048, 0.5, 100, 90, 'signed'), (300, 0.5, 300, 2, 'signed'),
    (4756, 0.7, 1000, 1, 'disjoint'), (1, 0.5, 1, 1, 'clusters'),
    (65, 0.5, 65, 1, 'clusters'), (16384, 0.7, 1000, 5, 'clusters'),
    (16384, 0.5, 16384, 90, 'minus_one')])
def test_nms_large_kernel_vs_plain(rng, cuda, K, thr, max_out, n_cats,
                                   kind):
    """Every output slot, index and mask, equal to the plain version's,
    through the category offsets of batched_nms_fixed."""
    boxes, scores, cats = (t.to(cuda) for t in _nms_large_kind(
        rng, K, n_cats, kind))
    ki, km = tmaskrcnn.batched_nms_fixed(boxes, scores, cats, thr, max_out)
    extent = boxes.max() + 1.0
    shifted = boxes + (cats.float() * extent)[:, None]
    pi, pm = trtmdet.nms_fixed_plain(shifted, scores, thr, max_out)
    assert torch.equal(ki, pi) and torch.equal(km, pm)
    assert 0 < int(km.sum()) <= K
    if kind in ('clusters', 'ties') and K > 1:
        assert int(km.sum()) < K


@pytest.mark.gpu
def test_nms_large_graph_capture(rng, cuda):
    """A call captured in a CUDA graph: the replay on new inputs copied
    into the captured ones gives the plain version's keep set."""
    cases = [tuple(t.to(cuda) for t in _nms_large_case(rng, 2048, 90))
             for _ in range(2)]
    boxes, scores, cats = (t.clone() for t in cases[0])
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        tmaskrcnn.batched_nms_fixed(boxes, scores, cats, 0.5, 100)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ki, km = tmaskrcnn.batched_nms_fixed(boxes, scores, cats, 0.5, 100)
    for case in cases[::-1]:
        for dst, src in zip((boxes, scores, cats), case):
            dst.copy_(src)
        graph.replay()
        b, sc, c = case
        pi, pm = trtmdet.nms_fixed_plain(
            b + (c.float() * (b.max() + 1.0))[:, None], sc, 0.5, 100)
        assert torch.equal(ki, pi) and torch.equal(km, pm)


def _pyramid(rng, C, H=64, W=96):
    feats = [torch.from_numpy(rng.randn(1, C, H // s, W // s)
                              .astype(np.float32)) for s in (4, 8, 16, 32)]
    boxes = torch.from_numpy(np.array([
        [5., 4., 60., 50.], [0., 0., 250., 180.], [-10., -10., 500., 400.],
        [2., 2., 3.5, 3.5], [80., 40., 700., 600.], [60., 30., 96., 64.],
        [90., 60., 95.5, 63.9]], np.float32))
    return feats, boxes


def _boundary_boxes():
    """Square boxes at the level map's edges: sqrt(area) at 112, 224
    and 448 px, and where floor(4 + log2(sqrt(area) / 224 + 1e-6))
    steps (1e-6 * 224 px below them), each 0 to 3 ulps either side; and
    a box whose samples all fall outside the image."""
    sides = []
    for k in (0.5, 1.0, 2.0):
        for edge in (224.0 * k, (k - 1e-6) * 224.0):
            e = np.float32(edge)
            sides += [e + np.float32(j) * np.spacing(e) for j in range(-3, 4)]
    sides = np.array(sides, np.float32)
    zero = np.zeros_like(sides)
    boxes = np.stack([zero, zero, sides, sides], 1)
    far = np.array([[-900.0, -800.0, -700.0, -650.0]], np.float32)
    return torch.from_numpy(np.concatenate([boxes, far]))


@pytest.mark.gpu
@pytest.mark.parametrize('C,out,boxes,sampling', [
    pytest.param(256, 7, 'mixed', 2, id='256-7'),
    pytest.param(40, 14, 'mixed', 2, id='40-14'),
    pytest.param(300, 7, 'mixed', 2, id='300-7'),
    (256, 14, 'boundary', 2), (36, 7, 'boundary', 2), (256, 7, 'path', 2),
    (256, 14, 'path', 2), (40, 7, 'mixed', 3), (256, 14, 'mixed', 1)])
def test_roi_align_kernel_vs_plain(rng, cuda, C, out, boxes, sampling):
    """Every level, out-of-bounds and edge samples, boxes at the level
    map's edges and the path's shapes (1000 boxes at 7x7, 100 at 14x14
    over the 768x1344 canvas's pyramid), sampling 2 (the path's) and
    others (the kernel's runtime path); the kernel's level map equal to
    roi_levels; f32 sums of the samples in another order."""
    if boxes == 'path':
        n = 1000 if out == 7 else 100
        feats, _ = _pyramid(rng, C, 768, 1344)
        c = rng.uniform(0, 1, (n, 2)) * [1333.0, 750.0]
        side = 8.0 * np.exp(rng.uniform(0, 4.5, (n, 2)))
        bx = torch.from_numpy(np.concatenate([c - side / 2, c + side / 2], 1)
                              .astype(np.float32))
    else:
        feats, bx = _pyramid(rng, C, 512, 768) if boxes == 'boundary' \
            else _pyramid(rng, C)
        if boxes == 'boundary':
            bx = _boundary_boxes()
    pyr = tmaskrcnn.flatten_pyramid([f.to(cuda) for f in feats])
    bx = bx.to(cuda)
    got = tmaskrcnn.roi_align_pyramid(pyr, bx, out, sampling)
    lvl = tmaskrcnn.roi_levels(bx)
    want = tmaskrcnn.roi_align_pyramid_plain(pyr, bx, lvl, out, sampling)
    assert got.shape == (bx.shape[0], C, out, out)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.max() - want.min())
    levels = torch.full_like(lvl, -1)
    tmaskrcnn._roi_align_launch(pyr, bx, out, sampling, levels=levels)
    assert torch.equal(levels, lvl)
    if boxes == 'boundary':
        assert len(set(lvl.tolist())) == 4       # the edges are crossed
        assert not bool(got[-1].any())           # every sample left out


@pytest.mark.gpu
def test_roi_align_nan_away_from_samples(rng, cuda):
    """NaN in every pyramid row no in-bounds sample reads (the whole of
    the levels no box maps to, and the pixels under a box whose samples
    all lie outside the image): the output stays finite and equal to
    the plain version's, which selects such samples out."""
    feats, boxes = _pyramid(rng, 64)
    boxes = torch.cat([boxes[:1], torch.tensor([[100.0, 70.0, 160.0,
                                                  120.0]])])
    pyr = tmaskrcnn.flatten_pyramid([f.to(cuda) for f in feats])
    boxes = boxes.to(cuda)
    lvl = tmaskrcnn.roi_levels(boxes)
    assert lvl.tolist() == [0, 0]
    sizes = pyr.sizes
    flat = pyr.flat.clone()
    flat[sizes[0][0] * sizes[0][1]:] = float('nan')
    # the second box lies right of and below the 96x64 image: its
    # samples' clamped taps would read the last row and column
    h, w = sizes[0]
    grid = flat[:h * w].view(h, w, -1)
    grid[-1] = float('nan')
    grid[:, -1] = float('nan')
    pyr = tmaskrcnn.Pyramid(flat, sizes)
    got = tmaskrcnn.roi_align_pyramid(pyr, boxes, 7)
    want = tmaskrcnn.roi_align_pyramid_plain(pyr, boxes, lvl, 7)
    assert bool(torch.isfinite(got).all()) and bool(
        torch.isfinite(want).all())
    assert not bool(got[1].any())
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.max() - want.min())


def _mask_heads_case(rng, N, h, w, valid_share, dev):
    feat = torch.from_numpy(rng.randn(h, w, 8).astype(np.float32)).to(dev)
    kern = torch.from_numpy(rng.randn(N, 169).astype(np.float32)).to(dev)
    priors = torch.from_numpy(
        rng.randint(0, w, (N, 2)).astype(np.float32) * 8).to(dev)
    strides = torch.from_numpy(
        rng.choice([8.0, 16.0, 32.0], N).astype(np.float32)).to(dev)
    valid = torch.from_numpy(rng.rand(N) < valid_share).to(dev)
    return feat, kern, priors, strides, valid


def _mask_heads_close(got, want):
    """The same sums in the same order; the resample may differ from
    torch's by the FMA contraction of its kernel."""
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    assert float((got[0] == want[0]).float().mean()) >= 0.9999


@pytest.mark.gpu
def test_mask_heads_kernel_vs_plain(rng, cuda):
    N, h, w = 9, 20, 24
    x = _mask_heads_case(rng, N, h, w, 0.7, cuda)
    _mask_heads_close(trtmdet.dynamic_masks(*x, 8 * h, 8 * w, 0.3),
                      trtmdet.dynamic_masks_plain(*x, 8 * h, 8 * w, 0.3))


@pytest.mark.gpu
@pytest.mark.parametrize('N,h,w,H,W,valid', [
    (100, 80, 80, 640, 640, 0.0), (100, 80, 80, 640, 640, 1.0),
    (7, 13, 21, 104, 167, 0.6), (15, 9, 12, 71, 90, 1.0),
    (30, 16, 16, 40, 50, 1.0), (200, 1, 1, 8, 8, 1.0)],
    ids=['invalid', 'valid', 'w-odd', 'h-odd', 'down', 'one-pixel'])
def test_mask_heads_kernel_cases(rng, cuda, N, h, w, H, W, valid):
    """All instances invalid (zeros, probs still written), all valid,
    a width that is not a multiple of 16 (byte stores) with a last band
    of fewer rows, a downsampling resize (source rows owned that no band
    reads) and a 1x1 source."""
    x = _mask_heads_case(rng, N, h, w, valid, cuda)
    got = trtmdet.dynamic_masks(*x, H, W, 0.3)
    _mask_heads_close(got, trtmdet.dynamic_masks_plain(*x, H, W, 0.3))
    if valid == 0.0:
        assert not bool(got[0].any())


@pytest.mark.gpu
def test_mask_heads_kernel_one_launch_graph_no_sync(rng, cuda):
    """One kernel a call and no host sync; the call captures in a CUDA
    graph that replays on new inputs copied into the captured ones."""
    x = [t.clone() for t in _mask_heads_case(rng, 100, 80, 80, 0.8, cuda)]

    def call():
        return trtmdet.dynamic_masks(*x, 640, 640, 0.3)
    ops, launches = _device_ops(call, 'maskhead')
    assert ops == ['kernel'] and launches == 1, (ops, launches)
    _no_sync(call)
    graph, got = _in_graph(call)
    new = _mask_heads_case(np.random.RandomState(7), 100, 80, 80, 0.5, cuda)
    for dst, src in zip(x, new):
        dst.copy_(src)
    graph.replay()
    _mask_heads_close(got, trtmdet.dynamic_masks_plain(*new, 640, 640, 0.3))


def _epilogue_frame(rng, H, W, layout, dev):
    """A frame of values around [0, 1]: 'rgbd' a view of an (H, W, 4)
    buffer, 'rgbd+1' the view one float further (rows off their 16-byte
    boundary), 'rgb' a contiguous (H, W, 3) frame."""
    buf = torch.from_numpy(rng.rand(H, W, 4).astype(np.float32) * 1.2
                           - 0.1).to(dev)
    if layout == 'rgb':
        return buf[..., :3].contiguous()
    return buf[..., 1:] if layout == 'rgbd+1' else buf[..., :3]


def _epilogue_close(got, want):
    # the bilinear sum may sit an ulp from torch's FMA-contracted kernel
    d = (got.int() - want.int()).abs()
    assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.9999


@pytest.mark.gpu
@pytest.mark.parametrize('hw,crop,out,layout', [
    ((64, 128), (60, 100), (60, 100), 'rgbd'),
    ((64, 128), (59, 99), (64, 128), 'rgbd'),
    ((64, 128), (58, 101), (64, 128), 'rgbd'),
    ((576, 1024), (558, 993), (576, 1024), 'rgbd'),
    ((576, 1024), (558, 993), (576, 1024), 'rgb'),
    ((576, 1024), (556, 992), (556, 992), 'rgbd'),
    ((576, 1024), (556, 992), (556, 992), 'rgb'),
    ((576, 1024), (558, 993), (576, 1024), 'rgbd+1'),
    ((683, 1024), (662, 993), (683, 1024), 'rgbd'),
    ((64, 128), (59, 99), (61, 127), 'rgb'),
    ((64, 128), (58, 101), (13, 21), 'rgbd'),
    ((100, 150), (97, 141), (100, 150), 'rgbd'),
    ((600, 600), (599, 599), (20, 20), 'rgb')])
def test_epilogue_kernel_vs_plain(rng, cuda, hw, crop, out, layout):
    """A crop at a half-pixel corner kept at its size and crops resized
    to the frame (integral and mixed corners), with values outside [0,
    1]: the path's sizes in both layouts (the shipped default's crop, a
    crop kept at its size, the 683x1024 clip's BGR only), odd and
    downscaled outputs, tiles cut by every edge, rows off their 16-byte
    boundary, and a tile halved to fit shared memory; I420 where the
    output takes it."""
    frame = _epilogue_frame(rng, *hw, layout, cuda)
    i420 = None
    if out[0] % 4 == 0 and out[1] % 2 == 0:
        i420 = torch.empty((out[0] * 3 // 2, out[1]), dtype=torch.uint8,
                           device=cuda)
    got = timage.frame_epilogue(frame, *crop, *out, i420=i420)
    _epilogue_close(got, timage.frame_epilogue_plain(frame, *crop, *out))
    if i420 is not None:
        assert torch.equal(i420, timage.bgr_to_i420(got[None])[0])


@pytest.mark.gpu
def test_epilogue_kernel_small_tiles(rng, cuda, monkeypatch):
    """A smaller shared-memory limit halves the tile: the same bytes as
    the full tile's."""
    frame = _epilogue_frame(rng, 576, 1024, 'rgbd', cuda)
    full = timage.frame_epilogue(frame, 558, 993, 576, 1024)
    monkeypatch.setattr(_cuda, 'SMEM_BYTES', 8000)
    assert timage.epilogue_plan(558, 993, 576, 1024, 8000)[:2] < \
        timage.EPILOGUE_TILE
    assert torch.equal(timage.frame_epilogue(frame, 558, 993, 576, 1024),
                       full)


@pytest.mark.gpu
@pytest.mark.parametrize('hw,crop,with_i420', [((576, 1024), (558, 993), True),
                                               ((61, 127), (57, 120), False)])
def test_epilogue_plan_slots_and_graph(rng, cuda, hw, crop, with_i420):
    """EpiloguePlan writes each frame into its slot as frame_epilogue
    does (odd sizes put the slots off their 16-byte boundary), and its
    calls capture in a CUDA graph that replays on new frame values."""
    H, W = hw
    T = 3
    bgr = torch.zeros((T, H, W, 3), dtype=torch.uint8, device=cuda)
    i420 = torch.zeros((T, H * 3 // 2, W), dtype=torch.uint8,
                       device=cuda) if with_i420 else None
    plan = timage.EpiloguePlan(*crop, H, W)
    plan.outputs(bgr, i420)
    frames = [_epilogue_frame(rng, H, W, lay, cuda)
              for lay in ('rgbd', 'rgb', 'rgbd')]
    _cuda.reset_launches()
    for t, f in enumerate(frames):
        plan(f, t)
    assert _cuda.LAUNCHES['epilogue'] == T
    for t, f in enumerate(frames):
        one = torch.empty((H * 3 // 2, W), dtype=torch.uint8, device=cuda)
        want = timage.frame_epilogue(f, *crop, H, W,
                                     i420=one if with_i420 else None)
        assert torch.equal(bgr[t], want)
        if with_i420:
            assert torch.equal(i420[t], one)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        plan(frames[0], 0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        plan(frames[0], 1)
    frames[0].copy_(_epilogue_frame(rng, H, W, 'rgb', cuda))
    graph.replay()
    torch.cuda.synchronize()
    _epilogue_close(bgr[1], timage.frame_epilogue_plain(frames[0], *crop,
                                                        H, W))


@pytest.mark.gpu
def test_colorize_kernel_vs_plain(rng, cuda):
    buf = torch.from_numpy(rng.rand(72, 130, 4).astype(np.float32)
                           * 300).to(cuda)
    for x in (buf[..., 3], buf[..., 1].contiguous(), buf[:1, :5, 0]):
        assert torch.equal(tdepth.colorize_gray_r(x),
                           tdepth.colorize_gray_r_plain(x))
    flat = torch.full((9, 11), 2.5, device=cuda)
    assert torch.equal(tdepth.colorize_gray_r(flat),
                       tdepth.colorize_gray_r_plain(flat))


def _same_bits(got, want):
    """Equal bit for bit; NaN where the other has NaN."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _colorize_case(rng, case, dev):
    """(map, its RGBD buffer or None) of each K5b case."""
    buf = torch.from_numpy(rng.rand(77, 131, 4).astype(np.float32)
                           * 300).to(dev)
    if case == 'view':                 # the frame loop's depth channel
        return buf[..., 3]
    if case == 'view_c1':
        return buf[..., 1]
    if case == 'odd':
        return buf[..., 0].contiguous()[:-2, 1:]
    if case == 'contiguous':
        return buf[..., 2].contiguous()
    if case == 'one':
        return buf[:1, :1, 3]
    if case == 'flat':
        return torch.full((9, 11), 2.5, device=dev)
    if case == 'large':                # more than 264 x 512 x 8 values
        return torch.from_numpy(rng.rand(1200, 1100, 4).astype(
            np.float32)).to(dev)[..., 3]
    x = buf[..., 3].clone()
    x[5, 7] = {'nan': float('nan'), 'inf': float('inf'),
               '-inf': float('-inf')}[case]
    return x


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['view', 'view_c1', 'odd', 'contiguous',
                                  'one', 'flat', 'large', 'nan', 'inf',
                                  '-inf'])
def test_colorize_kernel_cases(rng, cuda, case):
    """One launch against the plain version, bit for bit: the stride-4
    channel view (read as 16-byte pixels), odd sizes, a contiguous map,
    one element, a flat map, a map larger than the grid holds, NaN and
    infinite values."""
    x = _colorize_case(rng, case, cuda)
    _cuda.reset_launches()
    got = tdepth.colorize_gray_r(x)
    assert _cuda.LAUNCHES['colorize'] == 1
    assert got.shape == x.shape and got.is_contiguous()
    _same_bits(got, tdepth.colorize_gray_r_plain(x))


@pytest.mark.gpu
def test_colorize_kernel_in_a_cuda_graph(rng, cuda):
    """The cooperative launch captures in a CUDA graph and replays on
    new values of the same buffer."""
    buf = torch.from_numpy(rng.rand(64, 96, 4).astype(np.float32)).to(cuda)
    x = buf[..., 3]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tdepth.colorize_gray_r(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdepth.colorize_gray_r(x)
    for scale in (300.0, 7.0):
        buf.copy_(torch.from_numpy(rng.rand(64, 96, 4).astype(np.float32)
                                   * scale))
        graph.replay()
        torch.cuda.synchronize()
        _same_bits(out, tdepth.colorize_gray_r_plain(x))


def _cloud_args(rng, M, dev):
    return [torch.from_numpy(a).to(dev) for a in (
        rng.rand(M, 3).astype(np.float32), rng.rand(M, 3).astype(np.float32),
        rng.rand(M).astype(np.float32), rng.rand(M).astype(np.float32))]


@pytest.mark.gpu
def test_compact_kernel_vs_plain(rng, cuda):
    """Three appends into a 5000-slot cloud, the last one overflowing,
    with no host sync in the kernel's path."""
    P = 5000
    kern = tstate.PointCloud.with_capacity(P, cuda)
    plain = tstate.PointCloud.with_capacity(P, cuda)
    for M, p in ((3000, 0.5), (2100, 0.9), (4000, 0.7)):
        args = _cloud_args(rng, M, cuda)
        mask = torch.from_numpy(rng.rand(M) < p).to(cuda)
        torch.cuda.set_sync_debug_mode('error')
        try:
            kern = kern.append_masked(*args, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        tstate.append_masked_plain(plain, *args, mask)
        for k in ('points', 'colors', 'disparity', 'depth', 'count'):
            assert torch.equal(getattr(kern, k), getattr(plain, k)), k
    assert int(kern.count) == P


def _compact_slot_zero():
    """The slot the next K10 call takes is zero: its tile counter and
    its status words (tstate._compact_scratch's layout)."""
    buf = tstate._scratch[torch.cuda.current_device()]
    slot = int(buf[0])
    return int(buf[1 + slot]) == 0 and not bool(buf[5 + slot::2].any())


@pytest.mark.gpu
@pytest.mark.parametrize('M,share,P,start,unaligned,planar', [
    (589824, 1.0, 1179648, 0, False, False),  # the prepared cloud's
    # an inpainting pass's: ~3% set, its colours channel-planar
    (589824, 0.03, 1179648, 589824, False, True),
    (9000, 0.9, 5000, 900, False, False),     # P crossed inside a tile
    (6144, 1.0, 7000, 2000, False, False),    # ... inside a dense tile
    (6144, 1.0, 9000, 0, False, True),        # dense tiles, planar
    (2049, 0.7, 3000, 10, True, False),       # an unaligned mask
    (1, 1.0, 10, 3, False, False)])
def test_compact_kernel_cases(rng, cuda, M, share, P, start, unaligned,
                              planar):
    """Dense and ranked tiles, overflow and ragged tails, colours at
    other strides: slots, order and count exact; the slot the next call
    takes left zero."""
    args = _cloud_args(rng, M, cuda)
    if planar:
        args[1] = args[1].t().contiguous().t()
    buf = torch.from_numpy(rng.rand(M + 1) < share).to(cuda)
    mask = buf[1:] if unaligned else buf[:M].clone()
    kern = tstate.PointCloud.with_capacity(P, cuda)
    kern.count.fill_(start)
    plain = kern.clone()
    for _ in range(2):
        _no_sync(lambda: tstate.append_masked_into(kern, *args, mask))
        tstate.append_masked_plain(plain, *args, mask)
    for k in ('points', 'colors', 'disparity', 'depth', 'count'):
        assert torch.equal(getattr(kern, k), getattr(plain, k)), k
    torch.cuda.synchronize()
    assert _compact_slot_zero()


@pytest.mark.gpu
def test_compact_kernel_one_launch_graph(rng, cuda):
    """One kernel a call (no memset), and a graph that replays right on
    new masks copied into the captured one."""
    M, P = 20000, 50000
    args = _cloud_args(rng, M, cuda)
    mask = torch.from_numpy(rng.rand(M) < 0.5).to(cuda)
    cloud = tstate.PointCloud.with_capacity(P, cuda)

    def call():
        cloud.count.zero_()
        tstate.append_masked_into(cloud, *args, mask)
    ops, launches = _device_ops(
        lambda: tstate.append_masked_into(cloud, *args, mask), 'compact')
    assert ops == ['kernel'] and launches == 1, (ops, launches)
    graph, _ = _in_graph(call)
    for share in (0.03, 1.0, 0.5):
        mask.copy_(torch.from_numpy(rng.rand(M) < share))
        for k in ('points', 'colors', 'disparity', 'depth'):
            getattr(cloud, k).zero_()     # the slots a call leaves alone
        graph.replay()
        plain = tstate.PointCloud.with_capacity(P, cuda)
        tstate.append_masked_plain(plain, *args, mask)
        for k in ('points', 'colors', 'disparity', 'depth', 'count'):
            assert torch.equal(getattr(cloud, k), getattr(plain, k)), k
    torch.cuda.synchronize()
    assert _compact_slot_zero()


@pytest.mark.gpu
@pytest.mark.parametrize('B,side,n,hd,kind', [
    (3, 14, 3, 64, 'random'), (1, 20, 3, 64, 'random'),
    (2, 7, 3, 80, 'random'),
    # SAM ViT-B 1024's windowed and global blocks, 12 heads
    (25, 14, 12, 64, 'random'), (1, 64, 12, 64, 'random'),
    (2, 14, 12, 80, 'random'),   # ViT-L/H's head width at side 14
    # k = 8 q: each row's max sits in its own key's tile, so the
    # online softmax rescales its sums through many tiles
    (1, 32, 2, 64, 'k=8q')])
def test_samattn_kernel_vs_plain(rng, cuda, B, side, n, hd, kind):
    """Windowed (14 x 14) and global grids, random q, k, v and rel-pos
    terms; the products in 3xTF32 on the tensor cores and the sums in
    another order than the plain matmuls: within 1e-5 of the range."""
    N = side * side
    x = rng.randn(B, N, 3, n, hd).astype(np.float32)
    if kind == 'k=8q':
        x[:, :, 1] = 8 * x[:, :, 0]
    qkv = torch.from_numpy(x).to(cuda)
    bh = torch.from_numpy(rng.randn(B, n, N, side).astype(np.float32)
                          ).to(cuda)
    bw = torch.from_numpy(rng.randn(B, n, N, side).astype(np.float32)
                          ).to(cuda)
    got = tsam.rel_pos_attention(qkv, bh, bw, side, side)
    want = tsam.rel_pos_attention_plain(qkv, bh, bw, side, side)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _crf_case(rng, H, W):
    """A flat-colour guide with noisy edges and a sloppy disc mask."""
    yy, xx = np.mgrid[0:H, 0:W]
    disc = (yy - H / 2) ** 2 + (xx - W / 3) ** 2 < (H / 3) ** 2
    rgb = np.where(disc[..., None], [200, 60, 60], [60, 160, 60])
    rgb = rgb + rng.randn(H, W, 3) * np.where(rng.rand(H, W, 1) < 0.1,
                                               25, 3)
    unary = np.clip(np.where(disc, 0.8, 0.2) + 0.2 * rng.randn(H, W), 0, 1)
    return (torch.from_numpy(unary.astype(np.float32)),
            torch.from_numpy(np.clip(rgb, 0, 255).astype(np.uint8)))


@pytest.mark.gpu
@pytest.mark.parametrize('H,W', [(37, 53), (200, 300)])
def test_kmeans_kernel_vs_plain(rng, cuda, H, W):
    """Block-ordered cluster sums against the plain one-hot matmul: the
    centres differ in the last bits, >= 99.9% of labels equal."""
    _, rgb = _crf_case(rng, H, W)
    guide = (rgb.float() / 255.0).reshape(-1, 3).to(cuda)
    got = tcrf.kmeans_labels(guide, 10)
    want = tcrf._kmeans_labels(guide, 10)
    assert got.dtype == torch.int32
    assert float((got == want).float().mean()) >= 0.999


def _kmeans_guide(rng, N, dev):
    """N colours of a flat-colour guide with noisy edges (_crf_case)."""
    W = 512
    _, rgb = _crf_case(rng, -(-N // W), W)
    return (rgb.float() / 255.0).reshape(-1, 3)[:N].contiguous().to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize('N,k', [(300, 10), (1000, 10), (20000, 1),
                                 (20000, 16), (65536, 10), (65537, 10),
                                 (1200000, 10)])
def test_kmeans_kernel_paths(rng, cuda, N, k):
    """>= 99.9% of labels equal to the plain version's below one block
    of points, on a cluster (up to 65,536 points), on the cooperative
    grid past it and past what its blocks hold in shared memory
    (1,200,000 points: tiles read again each pass); k = 1 and 16."""
    g = _kmeans_guide(rng, N, cuda)
    got = tcrf.kmeans_labels(g, k)
    want = tcrf._kmeans_labels(g, k)
    assert got.shape == (N,) and got.dtype == torch.int32
    assert float((got == want).float().mean()) >= 0.999
    if k == 1:
        assert not got.any()


@pytest.mark.gpu
@pytest.mark.parametrize('N', [20000, 100000])
def test_kmeans_kernel_one_launch_graph_no_sync(rng, cuda, N):
    """A cluster (20,000 points) and a cooperative grid (100,000): one
    kernel and no copy a call, no host sync, two calls bit-equal, and
    the call captures in a CUDA graph that replays on new colours."""
    g = _kmeans_guide(rng, N, cuda)

    def call():
        return tcrf.kmeans_labels(g, 10)
    ops, launches = _device_ops(call, 'kmeans')
    assert ops == ['kernel'] and launches == 1, (ops, launches)
    first = _no_sync(call)
    assert torch.equal(first, call())
    graph, out = _in_graph(call)
    g.copy_(_kmeans_guide(np.random.RandomState(9), N, cuda))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, tcrf.kmeans_labels(g, 10))
    assert float((out == tcrf._kmeans_labels(g, 10)).float().mean()) >= 0.999


def _crf_inputs(rng, H, W, K, dev):
    unary_fg, rgb = _crf_case(rng, H, W)
    guide = (rgb.float() / 255.0).to(dev)
    labels = tcrf._kmeans_labels(guide.reshape(-1, 3), K).reshape(H, W)
    p = torch.clamp(unary_fg.to(dev), 1e-5, 1 - 1e-5)
    unary = -torch.log(torch.stack([1 - p, p], -1))
    return labels.contiguous(), unary, tcrf._softmax2(-unary)


@pytest.mark.gpu
@pytest.mark.parametrize('H,W,K', [(37, 53, 10), (200, 300, 10),
                                   (576, 1024, 10), (163, 247, 10),
                                   (301, 95, 10), (10, 17, 10), (1, 1, 10),
                                   (37, 53, 1), (120, 90, 16)])
def test_crf_kernel_vs_plain(rng, cuda, H, W, K):
    """The norm pass and its flag exact, one step within 1e-6, the whole
    CRF's mask >= 99.9% equal to the plain versions' on the same labels;
    at 576x1024, crop-like sizes, a crop smaller than one 23-px cell,
    K = 1 and K = 16. A zero norm (a pixel alone in its cluster's
    reach, as at 1x1) sets the flag: the step's NaN where the plain
    version's is, the mask empty; past it the plain version's pool
    spreads the NaN to every cluster (NaN * 0) and the kernel's does
    not, so a dead case compares the one step."""
    labels, unary, q = _crf_inputs(rng, H, W, K, cuda)
    norms, dead = tcrf.crf_norms(labels, num_clusters=K)
    norms_p, dead_p = tcrf.crf_norms_plain(labels, 1.0, 46.0, K)
    assert torch.equal(norms, norms_p) and int(dead) == int(dead_p)
    if H * W == 1:
        assert int(dead) == 1
    got, mask = tcrf.crf_step(q, labels, unary, norms, dead, num_clusters=K)
    want = tcrf.crf_step_plain(q, labels, unary, norms_p, num_clusters=K)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6, equal_nan=True)
    if int(dead):
        assert not mask.any()
        return
    for _ in range(4):
        got, mask = tcrf.crf_step(got, labels, unary, norms, dead,
                                  num_clusters=K)
        want = tcrf.crf_step_plain(want, labels, unary, norms_p,
                                   num_clusters=K)
    assert float((mask == (want[..., 1] > want[..., 0])).float().mean()) \
        >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize('H,W,iterations', [(200, 300, 5), (37, 53, 1),
                                            (37, 53, 2), (1, 1, 5)])
def test_crf_one_call_is_the_steps(rng, cuda, H, W, iterations):
    """densecrf_binary's one call (the norm pass and every step) gives
    the mask of the norm pass and steps called one at a time."""
    unary_fg, rgb = _crf_case(rng, H, W)
    unary_fg, rgb = unary_fg.to(cuda), rgb.to(cuda)
    _cuda.reset_launches()
    got = tcrf.densecrf_binary(unary_fg, rgb, iterations=iterations)
    assert _cuda.LAUNCHES['crf'] == 1
    guide = rgb.float() * torch.tensor(1.0 / 255.0, device=cuda)
    labels = tcrf.kmeans_labels(guide.reshape(-1, 3), 10).reshape(H, W)
    p = torch.clamp(unary_fg, 1e-5, 1 - 1e-5)
    unary = -torch.log(torch.stack([1 - p, p], -1))
    q = tcrf._softmax2(-unary)
    norms, dead = tcrf.crf_norms(labels)
    if iterations == 1:
        dead = torch.zeros_like(dead)
    for _ in range(iterations):
        q, mask = tcrf.crf_step(q, labels, unary, norms, dead)
    assert torch.equal(got, mask)


@pytest.mark.gpu
def test_crf_step_in_a_cuda_graph(rng, cuda):
    """The norm pass and a step capture in a CUDA graph (no copy to the
    card after the first call of a size) and replay on new q."""
    labels, unary, q = _crf_inputs(rng, 163, 247, 10, cuda)
    norms, dead = tcrf.crf_norms(labels)
    tcrf.crf_step(q, labels, unary, norms, dead)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tcrf.crf_step(q, labels, unary, norms, dead)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        n2, d2 = tcrf.crf_norms(labels)
        got, _ = tcrf.crf_step(q, labels, unary, norms, dead)
    q.copy_(tcrf._softmax2(-unary * 1.3))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(n2, norms) and int(d2) == int(dead)
    want = tcrf.crf_step_plain(q, labels, unary, norms)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_densecrf_binary_in_a_cuda_graph(rng, cuda):
    """The whole densecrf_binary (its k-means and its one K12b call)
    copies nothing to the card after the first call of a card, so it
    captures in a CUDA graph; the replay gives the mask of a call."""
    unary_fg, rgb = _crf_case(rng, 120, 90)
    unary_fg, rgb = unary_fg.to(cuda), rgb.to(cuda)
    want = tcrf.densecrf_binary(unary_fg, rgb)
    graph, got = _in_graph(lambda: tcrf.densecrf_binary(unary_fg, rgb))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_crf_step_unaligned_views(rng, cuda):
    """q, the unary and the norms as contiguous views one float past an
    8-byte boundary (the kernel reads a pixel's pair as one float2): the
    step copies them and gives the aligned inputs' result."""
    labels, unary, q = _crf_inputs(rng, 37, 53, 10, cuda)
    norms, dead = tcrf.crf_norms(labels)
    want, mask = tcrf.crf_step(q, labels, unary, norms, dead)

    def odd(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        v = buf[1:].view(t.shape)
        assert v.is_contiguous() and v.data_ptr() % 8 == 4
        return v.copy_(t)
    _cuda.reset_launches()
    got, got_mask = tcrf.crf_step(odd(q), labels, odd(unary), odd(norms),
                                  dead)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES['crf'] == 1
    assert torch.equal(got, want) and torch.equal(got_mask, mask)
    with pytest.raises(ValueError, match='aligned'):
        tcrf._crf_check(labels, 10, 46.0, q=odd(q))


@pytest.mark.gpu
@pytest.mark.parametrize('B,N,n,hd,nW,kind', [
    (196, 64, 4, 32, 0, 'random'), (32, 64, 16, 32, 16, 'random'),
    (12, 16, 2, 16, 4, 'random'),
    # SwinV2-B 448's stages 2 and 3
    (16, 64, 16, 32, 0, 'random'), (4, 64, 32, 32, 4, 'random'),
    # k = q at scale 100: a saturated softmax
    (8, 64, 4, 32, 0, 'k=q'),
    # an all-zero q row: its norm under the 1e-12 clamp
    (8, 64, 4, 32, 4, 'zero q'),
    # odd sizes: 4-byte copies (N = 49, hd = 12), an odd window count
    (5, 49, 3, 12, 0, 'random')])
def test_swinattn_kernel_vs_plain(rng, cuda, B, N, n, hd, nW, kind):
    """SwinV2-B's windows (with and without the shift mask) and small
    windows; the products in 3xTF32 on the tensor cores and the sums in
    another order than the plain matmuls: within 1e-5 of the range."""
    x = rng.randn(B, N, 3, n, hd).astype(np.float32)
    scale = rng.uniform(5, 100, n).astype(np.float32)
    if kind == 'k=q':
        x[:, :, 1] = x[:, :, 0]
        scale[:] = 100.0
    elif kind == 'zero q':
        x[:, 5, 0] = 0.0
    qkv = torch.from_numpy(x).to(cuda)
    scale = torch.from_numpy(scale).to(cuda)
    bias = torch.from_numpy(16 / (1 + np.exp(-rng.randn(n, N, N))).astype(
        np.float32)).to(cuda)
    mask = None
    if nW:
        mask = torch.from_numpy(np.where(rng.rand(nW, N, N) < 0.3, -100.0,
                                         0.0).astype(np.float32)).to(cuda)
    got = tswin.window_attention(qkv, scale, bias, mask)
    want = tswin.window_attention_plain(qkv, scale, bias, mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _fill_case(rng, H, W):
    """An image of gradients and noise with a hole of seeded blobs,
    one of them over the left edge."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([0.5 + 0.4 * np.sin(xx / 23), 0.5 + 0.4 * np.cos(yy / 17),
                    rng.rand(H, W)], -1).astype(np.float32)
    hole = np.zeros((H, W), bool)
    for _ in range(5):
        cy, cx = rng.uniform(0, H), rng.uniform(0, W)
        hole |= (yy - cy) ** 2 + (xx - cx) ** 2 < (0.12 * max(H, W)) ** 2
    hole |= (yy - H / 2) ** 2 + xx ** 2 < (0.1 * max(H, W)) ** 2
    return torch.from_numpy(img), torch.from_numpy(hole)


@pytest.mark.gpu
@pytest.mark.parametrize('H,W', [(37, 53), (27, 1), (1, 1), (448, 768),
                                 (768, 768)])
def test_pushpull_kernel_vs_plain(rng, cuda, H, W):
    """The sums and the blend in the plain version's order: within
    1e-6; an all-hole image fills with zeros, not NaN."""
    img, hole = _fill_case(rng, H, W)
    img, hole = img.to(cuda), hole.to(cuda)
    got = tfill.push_pull_fill(img, hole)
    want = tfill.push_pull_fill_plain(img, hole)
    assert float((got - want).abs().max()) <= 1e-6
    assert torch.equal(got[~hole], img[~hole])
    full = torch.ones_like(hole)
    assert torch.equal(tfill.push_pull_fill(img, full),
                       torch.zeros_like(img))


@pytest.mark.gpu
@pytest.mark.parametrize('H,W,levels', [(1, 77, 0), (77, 1, 0),
                                        (1600, 1200, 0), (448, 768, 3)])
def test_pushpull_kernel_more_sizes(rng, cuda, H, W, levels):
    """1xW and Hx1; 1600x1200, whose coarse levels exceed a block's
    shared memory (block 0 sums them in the scratch behind a second
    barrier); levels given, so that the top lies inside a tile."""
    img, hole = _fill_case(rng, H, W)
    img, hole = img.to(cuda), hole.to(cuda)
    got = tfill.push_pull_fill(img, hole, levels)
    want = tfill.push_pull_fill_plain(img, hole, levels)
    assert float((got - want).abs().max()) <= 1e-6
    assert torch.equal(got[~hole], img[~hole])


@pytest.mark.gpu
def test_pushpull_kernel_one_launch(rng, cuda):
    img, hole = (t.to(cuda) for t in _fill_case(rng, 448, 768))
    ops, launches = _device_ops(lambda: tfill.push_pull_fill(img, hole),
                                'pushpull')
    assert ops == ['kernel'] and launches == 1, (ops, launches)


@pytest.mark.gpu
@pytest.mark.parametrize('H,W,seed', [(448, 768, 0), (37, 53, 5),
                                      (1, 1, 2 ** 40 + 3)])
def test_jitter_offsets_card_equals_cpu(cuda, H, W, seed):
    """The hash's draws, bit for bit, with no copy from the host."""
    got = _no_sync(lambda: tfill.jitter_offsets(H, W, seed, device=cuda))
    assert got.device.type == 'cuda'
    assert torch.equal(got.cpu(), tfill.jitter_offsets(H, W, seed))


@pytest.mark.gpu
@pytest.mark.parametrize('H,W', [(37, 53), (448, 768)])
def test_jitter_kernel_vs_plain(rng, cuda, H, W):
    """The same offsets: >= 99.99% of the hole pixels equal (a tie of
    cost within f32 noise may pick another source)."""
    img, hole = _fill_case(rng, H, W)
    img = tfill.push_pull_fill_plain(img, hole).to(cuda)
    hole = hole.to(cuda)
    off = tfill.jitter_offsets(H, W, seed=1).to(cuda)
    got = tfill.jitter_refine(img, hole, off)
    want = tfill.jitter_refine_plain(img, hole, off)
    assert torch.equal(got[~hole], img[~hole])
    same = (got == want).all(-1)[hole]
    assert float(same.float().mean()) >= 0.9999
    assert not torch.equal(got, img)


@pytest.mark.gpu
def test_wrappers_count_launches_and_check_inputs(rng, cuda):
    _cuda.reset_launches()
    pts = _cloud(rng, 500).to(cuda)
    tpc.splat(pts, pts.clone(), 16, 20, 16.0, 40.0)
    assert _cuda.LAUNCHES['splat'] == 1
    with pytest.raises(TypeError):
        tpc.splat(pts.double(), pts.double(), 16, 20, 16.0, 40.0)
    with pytest.raises(ValueError):
        tpc.splat(pts, pts[:10].clone(), 16, 20, 16.0, 40.0)
    assert _cuda.LAUNCHES['splat'] == 1


def test_wrappers_take_the_plain_version_only_on_cpu(rng, monkeypatch):
    """On a CPU tensor the wrappers run their plain version and never
    reach the kernel loader or its launch counts."""
    def boom(*a, **k):
        raise AssertionError('kernel launched for a CPU tensor')
    monkeypatch.setattr(_cuda, 'launch', boom)
    monkeypatch.setattr(_cuda, 'lib', boom)
    before = dict(_cuda.LAUNCHES)
    pts = _cloud(rng, 500)
    tpc.splat(pts, pts.clone(), 16, 20, 16.0, 40.0)
    tpc.coverage(pts, torch.zeros((2, 3)), 16, 20, 16.0, 40.0)
    img, depth = _holes(rng, 26, 34)
    tdiscfill3.fill_disocclusion(img, depth)
    tbokeh.bokeh_core(img[..., :3].contiguous(), depth * 1e-4, 13.0, 8)
    masks, valid = _instance_masks(rng, 5, 26, 34)
    tdepth.masked_median_u8(depth * 100, torch.from_numpy(masks),
                            torch.from_numpy(valid))
    tfilters.median_filter(img[..., :1], 5)
    tfilters.laplacian_filter(img[..., :1])
    boxes, scores = _nms_case(rng, 40)
    trtmdet.nms_fixed(boxes, scores, 0.6, 10)
    trtmdet.dynamic_masks(torch.zeros((4, 5, 8)), torch.zeros((3, 169)),
                          torch.zeros((3, 2)), torch.ones((3,)),
                          torch.ones((3,), dtype=torch.bool), 32, 40, 0.3)
    timage.frame_epilogue(img[..., :3], 20, 30, 24, 34,
                          i420=torch.empty((36, 34), dtype=torch.uint8))
    tdepth.colorize_gray_r(depth)
    cloud = tstate.PointCloud.with_capacity(40)
    cloud.append_masked(*_cloud_args(rng, 30, 'cpu'), torch.ones(30) > 0)
    tsam.rel_pos_attention(torch.zeros((2, 6, 3, 2, 4)),
                           torch.zeros((2, 2, 6, 2)),
                           torch.zeros((2, 2, 6, 3)), 2, 3)
    tdiscfill.fill_disocclusion(img, depth, 16)
    tmaskrcnn.batched_nms_fixed(*_nms_large_case(rng, 40, 3), 0.6, 10)
    feats, boxes = _pyramid(rng, 8)
    tmaskrcnn.roi_align_pyramid(tmaskrcnn.flatten_pyramid(feats), boxes, 7)
    unary_fg, rgb = _crf_case(rng, 20, 30)
    tcrf.densecrf_binary(unary_fg, rgb, iterations=2)
    tswin.window_attention(torch.zeros((4, 16, 3, 2, 8)), torch.ones(2),
                           torch.zeros((2, 16, 16)),
                           torch.zeros((2, 16, 16)))
    img, hole = _fill_case(rng, 20, 30)
    tfill.jitter_refine(tfill.push_pull_fill(img, hole), hole,
                        tfill.jitter_offsets(20, 30))
    assert _cuda.LAUNCHES == before


def test_kernel_sources_present():
    """Every kernel the loader builds has its source in the package."""
    for name in _cuda.KERNELS:
        assert (_cuda.CSRC / f'{name}.cu').is_file()

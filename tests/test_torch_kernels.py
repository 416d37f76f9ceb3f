"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked ``gpu`` need a CUDA card (a CUDA kernel has no CPU mode)
and skip without one. This file imports neither JAX nor the JAX
package, so it also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Exact: z-buffer keys, the w > 0 mask, coverage counts, fill output,
the per-instance medians (K6), the median-5 and laplacian (K7), the
NMS keep sets (K8), the colorize (K5b), the cloud compaction (K10)
and the CRF's norm pass (K12b). Within the stated tolerance: splat
sums, bokeh, the dynamic mask heads (K9), the frame epilogue (K5a),
SAM's rel-pos attention (K15a), the k-means labels (K12a: their share),
the CRF steps (K12b) and SwinV2's window attention (K15b).
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
from cartoonsegmentation_torch.ops import pointcloud as tpc
from cartoonsegmentation_torch.pipeline import depth as tdepth
from cartoonsegmentation_torch.pipeline import state as tstate
from cartoonsegmentation_torch.utils import image as timage


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
@pytest.mark.parametrize('C', [4, 68])
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


@pytest.mark.gpu
def test_coverage_kernel_vs_plain(rng, cuda):
    pts = _cloud(rng, 20000).to(cuda)
    shifts = torch.from_numpy(
        rng.uniform(-3, 3, (32, 3)).astype(np.float32)).to(cuda)
    assert torch.equal(tpc.coverage(pts, shifts, 48, 64, 48.0, 40.0),
                       tpc.coverage_plain(pts, shifts, 48, 64, 48.0, 40.0))


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


@pytest.mark.gpu
@pytest.mark.parametrize('K', [512, 97])
def test_nms_kernel_vs_plain(rng, cuda, K):
    boxes, scores = _nms_case(rng, K)
    boxes, scores = boxes.to(cuda), scores.to(cuda)
    for max_out in (K, 100):
        ki, km = trtmdet.nms_fixed(boxes, scores, 0.6, max_out)
        pi, pm = trtmdet.nms_fixed_plain(boxes, scores, 0.6, max_out)
        assert torch.equal(ki, pi) and torch.equal(km, pm)
    kept = int(trtmdet.nms_fixed(boxes, scores, 0.6, K)[1].sum())
    assert 0 < kept < K


def _nms_large_case(rng, K, n_cats):
    """_nms_case's clusters at K candidates, with -inf scores (the
    invalid slots of the Mask R-CNN machinery) and category labels."""
    boxes, scores = _nms_case(rng, K)
    scores[rng.rand(K) < 0.2] = -np.inf
    cats = torch.from_numpy(rng.randint(0, n_cats, K).astype(np.int32))
    return boxes, scores, cats


@pytest.mark.gpu
@pytest.mark.parametrize('K,thr,max_out,n_cats', [
    (4756, 0.7, 1000, 5), (2048, 0.5, 100, 90), (600, 0.6, 600, 1),
    (97, 0.6, 40, 3)])
def test_nms_large_kernel_vs_plain(rng, cuda, K, thr, max_out, n_cats):
    """Every output slot, index and mask, equal to the plain version's,
    through the category offsets of batched_nms_fixed."""
    boxes, scores, cats = (t.to(cuda) for t in _nms_large_case(rng, K,
                                                                n_cats))
    ki, km = tmaskrcnn.batched_nms_fixed(boxes, scores, cats, thr, max_out)
    extent = boxes.max() + 1.0
    shifted = boxes + (cats.float() * extent)[:, None]
    pi, pm = trtmdet.nms_fixed_plain(shifted, scores, thr, max_out)
    assert torch.equal(ki, pi) and torch.equal(km, pm)
    assert 0 < int(km.sum()) < K


def _pyramid(rng, C, H=64, W=96):
    feats = [torch.from_numpy(rng.randn(1, C, H // s, W // s)
                              .astype(np.float32)) for s in (4, 8, 16, 32)]
    boxes = torch.from_numpy(np.array([
        [5., 4., 60., 50.], [0., 0., 250., 180.], [-10., -10., 500., 400.],
        [2., 2., 3.5, 3.5], [80., 40., 700., 600.], [60., 30., 96., 64.],
        [90., 60., 95.5, 63.9]], np.float32))
    return feats, boxes


@pytest.mark.gpu
@pytest.mark.parametrize('C,out', [(256, 7), (40, 14), (300, 7)])
def test_roi_align_kernel_vs_plain(rng, cuda, C, out):
    """Every level, out-of-bounds and edge samples; the same level map;
    f32 sums of the 2x2 samples in another order."""
    feats, boxes = _pyramid(rng, C)
    pyr = tmaskrcnn.flatten_pyramid([f.to(cuda) for f in feats])
    boxes = boxes.to(cuda)
    got = tmaskrcnn.roi_align_pyramid(pyr, boxes, out)
    want = tmaskrcnn.roi_align_pyramid_plain(
        pyr, boxes, tmaskrcnn.roi_levels(boxes), out)
    assert got.shape == (7, C, out, out)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.max() - want.min())


@pytest.mark.gpu
def test_mask_heads_kernel_vs_plain(rng, cuda):
    N, h, w = 9, 20, 24
    feat = torch.from_numpy(rng.randn(h, w, 8).astype(np.float32)).to(cuda)
    kern = torch.from_numpy(rng.randn(N, 169).astype(np.float32)).to(cuda)
    priors = torch.from_numpy(
        rng.randint(0, 24, (N, 2)).astype(np.float32) * 8).to(cuda)
    strides = torch.from_numpy(
        rng.choice([8.0, 16.0, 32.0], N).astype(np.float32)).to(cuda)
    valid = torch.from_numpy(rng.rand(N) < 0.7).to(cuda)
    mk, pk = trtmdet.dynamic_masks(feat, kern, priors, strides, valid,
                                   8 * h, 8 * w, 0.3)
    mp, pp = trtmdet.dynamic_masks_plain(feat, kern, priors, strides, valid,
                                         8 * h, 8 * w, 0.3)
    # the same sums in the same order; the resample may differ from
    # torch's by the FMA contraction of its kernel
    torch.testing.assert_close(pk, pp, rtol=0, atol=1e-6)
    assert float((mk == mp).float().mean()) >= 0.9999


@pytest.mark.gpu
@pytest.mark.parametrize('crop,out', [((60, 100), (60, 100)),
                                      ((59, 99), (64, 128)),
                                      ((58, 101), (64, 128))])
def test_epilogue_kernel_vs_plain(rng, cuda, crop, out):
    """A crop at a half-pixel corner kept at its size, and two resized
    to the frame (integral and mixed corners); the frame is a view of
    the filled (H, W, 4) buffer with values outside [0, 1]."""
    buf = torch.from_numpy(rng.rand(64, 128, 4).astype(np.float32) * 1.2
                           - 0.1).to(cuda)
    frame = buf[..., :3]
    i420 = torch.empty((out[0] * 3 // 2, out[1]), dtype=torch.uint8,
                       device=cuda)
    got = timage.frame_epilogue(frame, *crop, *out, i420=i420)
    want = timage.frame_epilogue_plain(frame, *crop, *out)
    d = (got.int() - want.int()).abs()
    # the bilinear sum may sit an ulp from torch's FMA-contracted kernel
    assert int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.9999
    assert torch.equal(i420, timage.bgr_to_i420(got[None])[0])


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


@pytest.mark.gpu
@pytest.mark.parametrize('B,side,hd', [(3, 14, 64), (1, 20, 64), (2, 7, 80)])
def test_samattn_kernel_vs_plain(rng, cuda, B, side, hd):
    """Windowed (14 x 14) and global-like grids, random q, k, v and
    rel-pos terms; f32 sums in another order than the plain matmuls."""
    n, N = 3, side * side
    qkv = torch.from_numpy(rng.randn(B, N, 3, n, hd).astype(np.float32)
                           ).to(cuda)
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


@pytest.mark.gpu
@pytest.mark.parametrize('H,W', [(37, 53), (200, 300)])
def test_crf_kernel_vs_plain(rng, cuda, H, W):
    """The norm pass exact, one step within 1e-6, the whole CRF's mask
    >= 99.9% equal to the plain versions' on the same labels."""
    unary_fg, rgb = _crf_case(rng, H, W)
    guide = (rgb.float() / 255.0).to(cuda)
    labels = tcrf._kmeans_labels(guide.reshape(-1, 3), 10).reshape(H, W)
    norms, dead = tcrf.crf_norms(labels)
    norms_p, dead_p = tcrf.crf_norms_plain(labels, 1.0, 46.0, 10)
    assert torch.equal(norms, norms_p) and int(dead) == int(dead_p) == 0
    p = torch.clamp(unary_fg.to(cuda), 1e-5, 1 - 1e-5)
    unary = -torch.log(torch.stack([1 - p, p], -1))
    q = tcrf._softmax2(-unary)
    got, _ = tcrf.crf_step(q, labels, unary, norms, dead)
    want = tcrf.crf_step_plain(q, labels, unary, norms_p)
    assert float((got - want).abs().max()) <= 1e-6
    for _ in range(4):
        got, mask = tcrf.crf_step(got, labels, unary, norms, dead)
        want = tcrf.crf_step_plain(want, labels, unary, norms_p)
    assert float((mask == (want[..., 1] > want[..., 0])).float().mean()) \
        >= 0.999


@pytest.mark.gpu
@pytest.mark.parametrize('B,N,n,hd,nW', [(196, 64, 4, 32, 0),
                                         (32, 64, 16, 32, 16),
                                         (12, 16, 2, 16, 4)])
def test_swinattn_kernel_vs_plain(rng, cuda, B, N, n, hd, nW):
    """SwinV2-B's windows (with and without the shift mask) and a small
    window; f32 sums in another order than the plain matmuls."""
    qkv = torch.from_numpy(rng.randn(B, N, 3, n, hd).astype(np.float32)
                           ).to(cuda)
    scale = torch.from_numpy(rng.uniform(5, 100, n).astype(np.float32)
                             ).to(cuda)
    bias = torch.from_numpy(16 / (1 + np.exp(-rng.randn(n, N, N))).astype(
        np.float32)).to(cuda)
    mask = None
    if nW:
        mask = torch.from_numpy(np.where(rng.rand(nW, N, N) < 0.3, -100.0,
                                         0.0).astype(np.float32)).to(cuda)
    got = tswin.window_attention(qkv, scale, bias, mask)
    want = tswin.window_attention_plain(qkv, scale, bias, mask)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


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
    assert _cuda.LAUNCHES == before


def test_kernel_sources_present():
    """Every kernel the loader builds has its source in the package."""
    for name in _cuda.KERNELS:
        assert (_cuda.CSRC / f'{name}.cu').is_file()

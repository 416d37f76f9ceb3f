"""The kernels' launch path (cartoonsegmentation_torch/ops/_cuda.py):
each library's one C entry point, bound once from ``SIGNATURES``.

On the CPU: the table against every ``extern "C" int kb_*`` declaration
in csrc/*.cu (the same parameters, ``c_void_p`` for every pointer and
the stream, which ctypes would otherwise cut to 32 bits), and
``launch``'s count and error path with a stand-in entry point. On the
card (marked ``gpu``): the entry points bound once, and one wrapper of
each library, the laplacian first, against its plain version through
that path, its launch counted. This file imports neither JAX nor the
JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_launch.py
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import maskrcnn as tmaskrcnn
from cartoonsegmentation_torch.models import rtmdet as trtmdet
from cartoonsegmentation_torch.models import sam as tsam
from cartoonsegmentation_torch.models import swinv2 as tswin
from cartoonsegmentation_torch.ops import _cuda
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
from test_torch_kernels import (_cloud, _cloud_args, _crf_case, _fill_case,
                                _holes, _instance_masks, _nms_case,
                                _nms_large_case, _pyramid)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

_DECL = re.compile(r'extern\s+"C"\s+int\s+(kb_\w+)\s*\(([^)]*)\)')


def _c_types(params: str):
    """The ctypes type of each parameter of a C declaration."""
    out = []
    for prm in params.split(','):
        prm = ' '.join(prm.replace('const ', ' ').split())
        if prm in ('', 'void'):
            continue
        if '*' in prm:
            out.append(ctypes.c_void_p)
        elif prm.startswith('long long '):
            out.append(ctypes.c_longlong)
        elif prm.startswith('float '):
            out.append(ctypes.c_float)
        elif prm.startswith('int '):
            out.append(ctypes.c_int)
        else:
            raise AssertionError(f'no ctypes type for {prm!r}')
    return out


@pytest.mark.parametrize('name', _cuda.KERNELS)
def test_signature_table_matches_source(name):
    """The source of library ``name`` declares one entry point, the
    table's, with the table's parameters."""
    assert set(_cuda.SIGNATURES) == set(_cuda.KERNELS)
    decls = _DECL.findall((_cuda.CSRC / f'{name}.cu').read_text())
    assert len(decls) == 1, decls
    fn, params = decls[0]
    entry, table = _cuda.SIGNATURES[name]
    assert fn == entry
    assert [_cuda.CTYPES[c] for c in table] == _c_types(params)
    assert params.rstrip().endswith('void* stream') and table[-1] == 'p'


def test_launch_counts_and_raises(monkeypatch):
    """``launch`` calls the bound entry point with the arguments as
    given, counts each call and raises on a nonzero return, with the
    library's error string."""
    seen = []

    class Lib:
        @staticmethod
        def kb_error_string(rc):
            return b'too many resources requested for launch'

    def entry(*args):
        seen.append(args)
        return 0 if len(seen) == 1 else 701
    monkeypatch.setitem(_cuda._libs, 'laplacian', Lib)
    monkeypatch.setitem(_cuda._entries, 'laplacian', entry)
    monkeypatch.setitem(_cuda.LAUNCHES, 'laplacian', 0)
    _cuda.launch('laplacian', 1, 2, 3)
    assert seen == [(1, 2, 3)] and _cuda.LAUNCHES['laplacian'] == 1
    with pytest.raises(RuntimeError, match='kb_laplacian.*701 too many'):
        _cuda.launch('laplacian', 4)
    assert _cuda.LAUNCHES['laplacian'] == 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.gpu
def test_entry_points_bound_once(cuda):
    """Each library loads as a PyDLL (the entry points keep the GIL)
    with its entry point typed from the table; the stream handle is the
    current stream's."""
    x = torch.zeros((8, 9, 1), device=cuda)
    assert _cuda.stream_ptr(x) == torch.cuda.current_stream().cuda_stream
    for name in _cuda.KERNELS:
        so = _cuda.lib(name)
        assert isinstance(so, ctypes.PyDLL)
        f = _cuda._entries[name]
        assert f is getattr(so, _cuda.SIGNATURES[name][0])
        assert list(f.argtypes) == [_cuda.CTYPES[c]
                                    for c in _cuda.SIGNATURES[name][1]]
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert _cuda.stream_ptr(x) == s.cuda_stream != 0


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _exact(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _within(tol):
    """max |got - want| <= tol x the plain version's largest value."""
    def check(got, want):
        assert float((got - want).abs().max()) <= tol * float(
            want.abs().max())
    return check


def _case(name, rng, dev):
    """(kernel call, plain call, check) of one wrapper of library
    ``name`` at a small size; the tolerances are those of
    tests/test_torch_kernels.py."""
    if name == 'laplacian':
        x = _t(rng.rand(2, 37, 53, 3).astype(np.float32), dev)
        return (lambda: tfilters.laplacian_filter(x),
                lambda: tfilters.laplacian_filter_plain(x), _exact)
    if name in ('median5', 'median3'):
        size = int(name[-1])
        x = _t((rng.rand(1, 37, 53, 1) > 0.5).astype(np.float32), dev)
        return (lambda: tfilters.median_filter(x, size),
                lambda: tfilters.median_filter_plain(x, size), _exact)
    if name in ('splat', 'coverage'):
        pts = _cloud(rng, 5000).to(dev)
        if name == 'coverage':
            sh = _t(rng.uniform(-3, 3, (16, 3)).astype(np.float32), dev)
            return (lambda: tpc.coverage(pts, sh, 48, 64, 48.0, 40.0),
                    lambda: tpc.coverage_plain(pts, sh, 48, 64, 48.0, 40.0),
                    _exact)
        data = _t(rng.rand(5000, 4).astype(np.float32), dev)

        def check(got, want):
            assert torch.equal(got[2], want[2])
            assert torch.equal(got[1] > 0, want[1] > 0)
            for g, w in zip(got[:2], want[:2]):
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
        return (lambda: tpc.splat(pts, data, 48, 64, 48.0, 40.0),
                lambda: tpc.splat_plain(pts, data, 48, 64, 48.0, 40.0), check)
    if name in ('discfill', 'discfill_exact'):
        img, depth = (t.to(dev) for t in _holes(rng, 64, 96))
        if name == 'discfill':
            return (lambda: tdiscfill3.fill_disocclusion(img, depth),
                    lambda: tdiscfill3.fill_disocclusion_plain(img, depth),
                    _exact)
        return (lambda: tdiscfill.fill_disocclusion(img, depth, 40),
                lambda: tdiscfill.fill_disocclusion_plain(img, depth, 40),
                _exact)
    if name == 'bokeh':
        img = _t(rng.rand(64, 96, 3).astype(np.float32), dev)
        wgt = _t(rng.rand(64, 96).astype(np.float32) * 5e-4, dev)

        def check(got, want):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        return (lambda: tbokeh.bokeh_core(img, wgt, 13.0, 32),
                lambda: tbokeh.bokeh_core_plain(img, wgt, 13.0, 32), check)
    if name == 'insmedian':
        masks, valid = _instance_masks(rng, 12, 72, 130)
        vals = _t(rng.rand(72, 130).astype(np.float32) * 255, dev)
        masks, valid = _t(masks, dev), _t(valid, dev)
        return (lambda: tdepth.masked_median_u8(vals, masks, valid),
                lambda: tdepth.masked_median_u8_plain(vals, masks, valid),
                _exact)
    if name == 'nms':
        boxes, scores = (t.to(dev) for t in _nms_case(rng, 97))
        return (lambda: trtmdet.nms_fixed(boxes, scores, 0.6, 40),
                lambda: trtmdet.nms_fixed_plain(boxes, scores, 0.6, 40),
                _exact)
    if name == 'nms_large':
        boxes, scores, cats = (t.to(dev) for t in
                               _nms_large_case(rng, 600, 3))
        shifted = boxes + (cats.float() * (boxes.max() + 1.0))[:, None]
        return (lambda: tmaskrcnn.batched_nms_fixed(boxes, scores, cats,
                                                    0.6, 100),
                lambda: trtmdet.nms_fixed_plain(shifted, scores, 0.6, 100),
                _exact)
    if name == 'maskhead':
        N, h, w = 9, 20, 24
        args = (_t(rng.randn(h, w, 8).astype(np.float32), dev),
                _t(rng.randn(N, 169).astype(np.float32), dev),
                _t(rng.randint(0, 24, (N, 2)).astype(np.float32) * 8, dev),
                _t(rng.choice([8.0, 16.0, 32.0], N).astype(np.float32), dev),
                _t(rng.rand(N) < 0.7, dev), 8 * h, 8 * w, 0.3)

        def check(got, want):
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
            assert float((got[0] == want[0]).float().mean()) >= 0.9999
        return (lambda: trtmdet.dynamic_masks(*args),
                lambda: trtmdet.dynamic_masks_plain(*args), check)
    if name == 'epilogue':
        frame = _t(rng.rand(64, 128, 4).astype(np.float32), dev)[..., :3]

        def check(got, want):
            d = (got.int() - want.int()).abs()
            assert int(d.max()) <= 1
            assert float((d == 0).float().mean()) >= 0.9999
        return (lambda: timage.frame_epilogue(frame, 59, 99, 64, 128),
                lambda: timage.frame_epilogue_plain(frame, 59, 99, 64, 128),
                check)
    if name == 'colorize':
        x = _t(rng.rand(72, 130, 4).astype(np.float32) * 300, dev)[..., 3]
        return (lambda: tdepth.colorize_gray_r(x),
                lambda: tdepth.colorize_gray_r_plain(x), _exact)
    if name == 'compact':
        args = _cloud_args(rng, 3000, dev)
        mask = _t(rng.rand(3000) < 0.5, dev)

        def kernel():
            cloud = tstate.PointCloud.with_capacity(5000, dev)
            cloud = cloud.append_masked(*args, mask)
            return cloud.points, cloud.colors, cloud.count

        def plain():
            cloud = tstate.PointCloud.with_capacity(5000, dev)
            tstate.append_masked_plain(cloud, *args, mask)
            return cloud.points, cloud.colors, cloud.count
        return kernel, plain, _exact
    if name == 'samattn':
        qkv = _t(rng.randn(2, 49, 3, 3, 64).astype(np.float32), dev)
        bh = _t(rng.randn(2, 3, 49, 7).astype(np.float32), dev)
        bw = _t(rng.randn(2, 3, 49, 7).astype(np.float32), dev)
        return (lambda: tsam.rel_pos_attention(qkv, bh, bw, 7, 7),
                lambda: tsam.rel_pos_attention_plain(qkv, bh, bw, 7, 7),
                _within(1e-5))
    if name == 'swinattn':
        qkv = _t(rng.randn(8, 64, 3, 4, 32).astype(np.float32), dev)
        scale = _t(rng.uniform(5, 100, 4).astype(np.float32), dev)
        bias = _t(rng.randn(4, 64, 64).astype(np.float32), dev)
        return (lambda: tswin.window_attention(qkv, scale, bias),
                lambda: tswin.window_attention_plain(qkv, scale, bias),
                _within(1e-5))
    if name == 'roialign':
        feats, boxes = _pyramid(rng, 40)
        pyr = tmaskrcnn.flatten_pyramid([f.to(dev) for f in feats])
        boxes = boxes.to(dev)

        def check(got, want):
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.max() - want.min())
        return (lambda: tmaskrcnn.roi_align_pyramid(pyr, boxes, 7),
                lambda: tmaskrcnn.roi_align_pyramid_plain(
                    pyr, boxes, tmaskrcnn.roi_levels(boxes), 7), check)
    if name in ('kmeans', 'crf'):
        _, rgb = _crf_case(rng, 37, 53)
        guide = (rgb.float() / 255.0).to(dev)
        if name == 'kmeans':
            flat = guide.reshape(-1, 3)

            def check(got, want):
                assert float((got == want).float().mean()) >= 0.999
            return (lambda: tcrf.kmeans_labels(flat, 10),
                    lambda: tcrf._kmeans_labels(flat, 10), check)
        labels = tcrf._kmeans_labels(guide.reshape(-1, 3), 10).reshape(37,
                                                                       53)
        def check(got, want):
            assert torch.equal(got[0], want[0])
            assert int(got[1]) == int(want[1]) == 0
        return (lambda: tcrf.crf_norms(labels),
                lambda: tcrf.crf_norms_plain(labels, 1.0, 46.0, 10), check)
    if name in ('pushpull', 'jitter'):
        img, hole = (t.to(dev) for t in _fill_case(rng, 37, 53))
        if name == 'pushpull':
            return (lambda: tfill.push_pull_fill(img, hole),
                    lambda: tfill.push_pull_fill_plain(img, hole),
                    _within(1e-6))
        img = tfill.push_pull_fill_plain(img, hole)
        off = tfill.jitter_offsets(37, 53, seed=1).to(dev)

        def check(got, want):
            same = (got == want).all(-1)[hole]
            assert float(same.float().mean()) >= 0.9999
        return (lambda: tfill.jitter_refine(img, hole, off),
                lambda: tfill.jitter_refine_plain(img, hole, off), check)
    raise AssertionError(f'no case for {name}')


@pytest.mark.gpu
@pytest.mark.parametrize('name', ('laplacian',) + tuple(
    k for k in _cuda.KERNELS if k != 'laplacian'))
def test_each_library_through_the_launch_path(cuda, name):
    kernel, plain, check = _case(name, np.random.RandomState(0), cuda)
    want = plain()
    before = _cuda.LAUNCHES[name]
    got = kernel()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] > before
    check(got, want)

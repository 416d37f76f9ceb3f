"""The port's host helpers, the rest of its ops and model API and its
packages' names against the JAX package's, on the CPU.

- ``data/rle.py``'s ``area`` and ``iou``, ``utils/io.py``'s file, json,
  pickle and grid helpers, ``utils/image.py``'s ``resize_pad``,
  ``square_pad_resize``, ``pad2divisor``, ``to_float_chw`` and
  ``utils/constants.py``: equal to JAX's.
- ``ops/filters.py:spatial_filter`` for its three kinds on planes with
  NaN taps of both signs and ±inf: the NaN outputs where JAX has them
  and every other output bit for bit; csrc/median3.cu's median-of-9
  network read from the source and proved exact over all 2^9 inputs of
  0s and 1s, and the kernel's order keys, reflection and network
  emulated in torch against JAX the same way.
- ``render_coverage`` (K1 with an empty payload): JAX's count exactly.
- ``SwinV2(..., return_features=True)``: within 1e-5 of the features'
  range; ``convert_swinv2`` on timm's key variants.
- ``fill_disocclusion_fast`` exactly and ``bokeh_pass`` within 1e-6 of
  JAX's; both raise for a tensor off the CPU (neither has a kernel).
- Every name of the JAX package's ``ops``, ``utils``, ``models``,
  ``pipeline`` and ``data`` exports in the port's, but
  ``set_multi_processing``; of ``parallel``'s, the detector training
  names (the mesh, tensor-parallel and depth-training names wait for
  their slices).

JAX is imported inside the CPU tests only, so that the ``gpu`` test
(the 3x3 median and K1 at C = 0 against their plain versions on the
card) runs on a machine without it.
"""
import ast
import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.ops import _cuda
from cartoonsegmentation_torch.ops import filters as tfilters
from cartoonsegmentation_torch.ops import pointcloud as tpc
from torch_cpu import torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
NOT_PORTED = {'set_multi_processing'}
NEG_NAN = np.array([0xffc00001], np.uint32).view(np.float32)[0]


def _bits_equal(got, want):
    """NaN exactly where ``want`` has NaN, every other value bit for
    bit."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def _odd_planes(seed=0, shape=(2, 23, 37, 2)):
    """Values in a few levels with NaN of both signs and ±inf (no zero,
    whose sign the order leaves free); runs of NaN so that windows hold
    every count of them."""
    rng = np.random.RandomState(seed)
    x = rng.choice(np.array([-2.5, -1.0, 0.5, 3.0, 7.0, np.inf, -np.inf],
                            np.float32), shape)
    nan = rng.rand(*shape) < np.linspace(0.1, 0.8, shape[1])[:, None, None]
    x[nan] = np.where(rng.rand(*shape) < 0.5, np.float32(np.nan),
                      NEG_NAN)[nan]
    return x


def test_rle_area_iou_vs_jax():
    from cartoonsegmentation_tpu.data import rle as jrle
    from cartoonsegmentation_torch.data import rle as trle
    rng = np.random.RandomState(0)
    masks = rng.rand(4, 21, 17) < np.array([0.0, 0.2, 0.5, 1.0])[
        :, None, None]
    rles = [trle.encode(m) for m in masks]
    assert rles == [jrle.encode(m) for m in masks]
    for r in rles + [{**rles[1], 'counts': rles[1]['counts'].encode()}]:
        assert trle.area(r) == jrle.area(r)
    assert trle.area(rles[3]) == 21 * 17 and trle.area(rles[0]) == 0
    for a, b in itertools.product(rles, rles):
        assert trle.iou(a, b) == jrle.iou(a, b)
    assert trle.iou(rles[0], rles[0]) == 0.0


def test_io_helpers_vs_jax(tmp_path):
    from cartoonsegmentation_tpu.utils import io as jio
    from cartoonsegmentation_torch.utils import io as tio
    for name in ('b.PNG', 'a.jpg', 'c.webp', 'd.txt', 'e.jpeg', 'f.bmp'):
        (tmp_path / name).write_bytes(b'x')
    (tmp_path / 'g.png').mkdir()
    for abs_path in (False, True):
        assert tio.find_all_imgs(str(tmp_path), abs_path) == \
            jio.find_all_imgs(str(tmp_path), abs_path)
    obj = {'a': [1, 2.5, 'ü'], 'b': {'c': None}}
    tio.dict2json(obj, str(tmp_path / 't.json'))
    jio.dict2json(obj, str(tmp_path / 'j.json'))
    assert (tmp_path / 't.json').read_bytes() == \
        (tmp_path / 'j.json').read_bytes()
    assert tio.json2dict(str(tmp_path / 'j.json')) == obj
    tio.save_pickle(obj, str(tmp_path / 't.pkl'))
    assert jio.load_pickle(str(tmp_path / 't.pkl')) == obj
    assert tio.load_pickle(str(tmp_path / 't.pkl')) == obj
    rng = np.random.RandomState(1)
    imgs = [(rng.rand(h, w, 3) * 255).astype(np.uint8)
            for h, w in ((30, 50), (64, 20), (17, 17))]
    imgs.append((rng.rand(40, 30) * 255).astype(np.uint8))
    for ncols in (None, 3):
        np.testing.assert_array_equal(tio.imglist2grid(imgs, 32, ncols),
                                      jio.imglist2grid(imgs, 32, ncols))
    assert tio.imglist2grid([]) is None


@pytest.mark.parametrize('hw', [(30, 50), (64, 20), (100, 100)])
def test_image_helpers_vs_jax(hw):
    from cartoonsegmentation_tpu.utils import image as jimage
    from cartoonsegmentation_torch.utils import image as timage
    rng = np.random.RandomState(2)
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    for tgt in (40, 128):
        g, gp = timage.resize_pad(img, tgt, pad_value=7)
        w, wp = jimage.resize_pad(img, tgt, pad_value=7)
        np.testing.assert_array_equal(g, w)
        assert gp == wp
        got = timage.square_pad_resize(img, tgt)
        want = jimage.square_pad_resize(img, tgt)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    for div in (1, 8, 32):
        g, gp = timage.pad2divisor(img[..., 0], div, value=3)
        w, wp = jimage.pad2divisor(img[..., 0], div, value=3)
        np.testing.assert_array_equal(g, w)
        assert gp == wp
    got = timage.to_float_chw(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jimage.to_float_chw(img))


def test_constants_vs_jax():
    from cartoonsegmentation_tpu.utils import constants as jc
    from cartoonsegmentation_torch.utils import constants as tc
    assert tc.MULTIPLE_TAGS == jc.MULTIPLE_TAGS
    for name in ('DEFAULT_DETECTOR_CKPT', 'DEFAULT_DEPTHREFINE_CKPT',
                 'DEFAULT_INPAINTNET_CKPT', 'DEPTH_ZOE_CKPT', 'CATEGORIES',
                 'PALETTE'):
        assert getattr(tc, name) == getattr(jc, name), name


@pytest.mark.parametrize('kind', ['laplacian', 'median-3', 'median-5'])
def test_spatial_filter_vs_jax(kind):
    from cartoonsegmentation_tpu.ops import filters as jfilters
    x = _odd_planes()
    if kind == 'laplacian':
        x = np.where(np.isfinite(x), x, np.float32(1.5))
    got = tfilters.spatial_filter(torch.from_numpy(x), kind).numpy()
    want = np.asarray(jfilters.spatial_filter(x, kind))
    assert got.shape == x.shape
    if kind == 'laplacian':
        np.testing.assert_array_equal(got, want)
    else:
        _bits_equal(got, want)
        assert np.isnan(want).any() and (~np.isnan(want)).any()
    with pytest.raises(ValueError, match='unknown spatial filter'):
        tfilters.spatial_filter(torch.from_numpy(x), 'median-7')


SOURCE3 = (_cuda.CSRC / 'median3.cu').read_text()


def _median9_pairs():
    text = SOURCE3.replace('\\\n', ' ')
    m = re.search(r'#define KB_MEDIAN9\(X\)(.*)', text)
    assert m, 'KB_MEDIAN9 not in median3.cu'
    return [(int(i), int(j))
            for i, j in re.findall(r'X\((\d+), (\d+)\)', m.group(1))]


def _network(v, pairs):
    """The comparators on the last axis of v: min to i, max to j."""
    v = v.clone()
    for i, j in pairs:
        lo = torch.minimum(v[..., i], v[..., j])
        v[..., j] = torch.maximum(v[..., i], v[..., j])
        v[..., i] = lo
    return v


def test_median3_network_exact_on_all_zero_one_inputs():
    """A comparator network that selects the 5th of every 0-1 input
    selects the 5th of every input; the source's 19 comparators do."""
    pairs = _median9_pairs()
    assert len(pairs) == 19
    bits = torch.tensor(list(itertools.product((0, 1), repeat=9)))
    got = _network(bits, pairs)[:, 4]
    assert torch.equal(got, bits.sort(-1).values[:, 4])


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """csrc/median3.cu's order key: every NaN as +NaN, then b ^ ((b >>
    31) & 0x7fffffff)."""
    b = x.view(torch.int32)
    b = torch.where((b & 0x7fffffff) > 0x7f800000,
                    torch.tensor(0x7fc00000, dtype=torch.int32), b)
    return b ^ ((b >> 31) & 0x7fffffff)


def _median3_emulated(x: torch.Tensor) -> torch.Tensor:
    """The kernel's schedule for (B, H, W, C): a thread an output, its 9
    reflected taps as keys in row-major order through the network."""
    H, W = x.shape[1:3]

    def reflect(i, n):
        i = i.abs()
        return torch.where(i >= n, 2 * (n - 1) - i, i)
    ys, xs = torch.arange(H), torch.arange(W)
    keys = torch.stack([
        _order_key(x[:, reflect(ys + dy, H)][:, :, reflect(xs + dx, W)])
        for dy in (-1, 0, 1) for dx in (-1, 0, 1)], -1)
    k = _network(keys, _median9_pairs())[..., 4]
    return (k ^ ((k >> 31) & 0x7fffffff)).view(torch.float32)


@pytest.mark.parametrize('shape', [(2, 23, 37, 2), (1, 3, 3, 1),
                                   (1, 2, 5, 3)])
def test_median3_kernel_emulated_vs_jax(shape):
    from cartoonsegmentation_tpu.ops import filters as jfilters
    x = _odd_planes(1, shape)
    got = _median3_emulated(torch.from_numpy(x)).numpy()
    _bits_equal(got, np.asarray(jfilters.median_filter(x, 3)))
    # NaN out exactly where 5 or more of the 9 taps are NaN
    plain = tfilters.median_filter_plain(torch.from_numpy(x), 3).numpy()
    _bits_equal(got, plain)


def _depth_cloud(h=36, w=52, seed=0):
    """A cloud unprojected from a smooth depth map with a step, as the
    render paths make them, and shifted toward one side."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = 4.0 + np.sin(xx / 9) + 0.5 * np.cos(yy / 7)
    depth[h // 3:2 * h // 3, w // 4:w // 2] -= 2.0
    depth[rng.rand(h, w) < 0.05] = 0.0
    pts = tpc.depth_to_points(torch.from_numpy(depth.astype(np.float32)),
                              40.0).reshape(-1, 3)
    return tpc.shift_points(pts, torch.tensor([0.3, -0.2, 0.4]))


def test_render_coverage_vs_jax():
    """K1 with an empty payload: the same covered-pixel count as JAX's
    render_coverage (the z-buffered full render's), also for a cloud
    with points behind the camera. K2 at zero shift (the port's
    ``render_coverage_fast``) counts JAX's render_coverage_fast of the
    same points, which skips the z-test and so covers at least as
    many pixels."""
    from cartoonsegmentation_tpu.ops import pointcloud as jpc
    for pts in (_depth_cloud(), _depth_cloud(seed=1) - torch.tensor(
            [0.0, 0.0, 3.0])):
        got = tpc.render_coverage(pts, 36, 52, 40.0, 30.0)
        want = int(jpc.render_coverage(pts.numpy(), 36, 52, 40.0, 30.0))
        assert int(got) == want and 0 < want < 36 * 52
        _, weight, _ = tpc.splat_plain(pts, torch.zeros((len(pts), 0)), 36,
                                       52, 40.0, 30.0)
        assert int((weight > 0).sum()) == want
        fast = int(tpc.render_coverage_fast(pts, torch.zeros((1, 3)), 36, 52,
                                            40.0, 30.0)[0])
        zero = tpc.shift_points(pts, torch.zeros(3)).numpy()
        assert fast == int(jpc.render_coverage_fast(zero, 36, 52, 40.0,
                                                    30.0)) >= want
    assert tpc.render_coverage_fast is tpc.coverage


def _small_swin():
    from test_torch_tagger import KW, _port_swin
    return KW, _port_swin(3)


def test_swinv2_return_features_vs_jax():
    import jax
    from cartoonsegmentation_tpu.models import swinv2 as jswin
    kw, net = _small_swin()
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    variables = jswin.convert_swinv2(sd, kw['depths'])
    x = np.random.RandomState(4).uniform(0, 255, (2, 48, 24, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, a: jswin.SwinV2(**kw).apply(
        v, a, return_features=True))(variables, x))
    with torch.no_grad():
        got = net(torch.from_numpy(x), return_features=True)
        logits = net(torch.from_numpy(x))
        assert torch.equal(net.head.fc(got), logits)
    assert got.shape == want.shape == (2, kw['embed_dim'] * 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.ptp(want))


def test_convert_swinv2_takes_timm_keys():
    """'model.' prefixes, a bare head and timm's derived buffers:
    convert_swinv2's state dict loads strictly."""
    from cartoonsegmentation_torch.models import swinv2 as tswin
    kw, net = _small_swin()
    sd = {('model.' + k).replace('head.fc.', 'head.'): v
          for k, v in net.state_dict().items()}
    sd['model.layers.0.blocks.0.attn.relative_position_index'] = \
        torch.zeros(3)
    out = tswin.convert_swinv2({'state_dict': sd})
    assert set(out) == set(net.state_dict())
    fresh = tswin.SwinV2(**kw)
    tswin.load_swinv2_state_dict(fresh, sd)
    assert all(torch.equal(fresh.state_dict()[k], v)
               for k, v in net.state_dict().items())


def test_fill_fast_and_bokeh_pass_vs_jax():
    from cartoonsegmentation_tpu.ops import bokeh as jbokeh
    from cartoonsegmentation_tpu.ops import discfill as jdiscfill
    from cartoonsegmentation_torch.ops import bokeh as tbokeh
    from cartoonsegmentation_torch.ops import discfill as tdiscfill
    rng = np.random.RandomState(5)
    for H, W in ((24, 31),):
        depth = rng.uniform(1, 10, (H, W)).astype(np.float32)
        depth[rng.rand(H, W) < 0.3] = 0.0
        depth[5:15, 8:20] = 0.0
        img = rng.rand(H, W, 4).astype(np.float32)
        got = tdiscfill.fill_disocclusion_fast(torch.from_numpy(img),
                                               torch.from_numpy(depth))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jdiscfill.fill_disocclusion_fast(
                img, depth)))
        wgt = (rng.rand(H, W) * 6e-4).astype(np.float32)
        for dx, dy in ((math.cos(-math.pi / 6), math.sin(-math.pi / 6)),
                       (0.3, 0.7)):
            got = tbokeh.bokeh_pass(torch.from_numpy(img[..., :3]),
                                    torch.from_numpy(wgt), dx, dy, 32)
            want = np.asarray(jbokeh.bokeh_pass(img[..., :3], wgt, dx, dy,
                                                32))
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    meta = torch.empty((4, 4, 3), device='meta')
    with pytest.raises(NotImplementedError, match='no CUDA kernel'):
        tdiscfill.fill_disocclusion_fast(meta, meta[..., 0])
    with pytest.raises(NotImplementedError, match='no CUDA kernel'):
        tbokeh.bokeh_pass(meta, meta[..., 0], 0.0, 1.0)


def _exported(init: Path) -> set:
    """The names an __init__.py imports (its exports)."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    return names


@pytest.mark.parametrize('pkg', ['ops', 'utils', 'models', 'pipeline',
                                 'data'])
def test_exports_match_jax(pkg):
    import importlib
    want = _exported(ROOT / 'cartoonsegmentation_tpu' / pkg / '__init__.py')
    mod = importlib.import_module(f'cartoonsegmentation_torch.{pkg}')
    missing = {n for n in want - NOT_PORTED if not hasattr(mod, n)}
    assert not missing, missing
    assert NOT_PORTED & want <= ({'set_multi_processing'} if pkg == 'utils'
                                 else set())


def test_parallel_exports_training_names():
    """The detector training names of the JAX package's ``parallel``
    exports are the port's (``TrainState`` a dataclass here); the mesh,
    tensor-parallel and depth-training ones are not ported yet."""
    from cartoonsegmentation_torch import parallel
    want = _exported(ROOT / 'cartoonsegmentation_tpu' / 'parallel' /
                     '__init__.py')
    waiting = {'make_mesh', 'batch_sharding', 'replicated', 'shard_batch',
               'TRANSFORMER_TP_RULES', 'shard_params', 'tp_sharded_fraction',
               'tp_shardings', 'SimpleState', 'make_depth_train_step',
               'make_refine_train_step', 'make_zoe_train_step', 'silog_loss',
               'zoe_optimizer'}
    assert waiting <= want
    missing = {n for n in want - waiting if not hasattr(parallel, n)}
    assert not missing, missing


@pytest.mark.gpu
def test_median3_and_coverage_on_card():
    """The 3x3 median on NaN (both signs), ±inf and ±0 taps against its
    plain version (NaN where it has NaN, the rest equal), launched once;
    render_coverage's K1 at C = 0 launched once, its count equal to the
    plain version's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dev = torch.device('cuda')
    x = torch.from_numpy(_odd_planes(2, (2, 37, 70, 3)))
    x[:, ::7, ::5] = -0.0
    x[:, 3::7, 1::5] = 0.0
    before = _cuda.LAUNCHES['median3']
    got = tfilters.median_filter(x.to(dev), 3).cpu()
    assert _cuda.LAUNCHES['median3'] == before + 1
    want = tfilters.median_filter_plain(x, 3)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got[~torch.isnan(got)], want[~torch.isnan(want)])
    pts = _depth_cloud()
    before = _cuda.LAUNCHES['splat']
    got = tpc.render_coverage(pts.to(dev), 36, 52, 40.0, 30.0)
    assert _cuda.LAUNCHES['splat'] == before + 1
    assert int(got) == int(tpc.render_coverage(pts, 36, 52, 40.0, 30.0))

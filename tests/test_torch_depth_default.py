"""The port's 3D-Ken-Burns depth (``depth_est: default``: the disparity
estimator at its coarse grid, the instance adjustment there, and the
Refine net with ``default_depth_refine``) against the JAX package's, on
the CPU in f32.

The weights are made in the port from numpy at 1/sqrt(fan-in)
(``randomize_nets``), go to Flax through the JAX package's converters
(``convert_disparity``, ``convert_semantics`` with the VGG BatchNorm
statistics, ``convert_refine``) and come back through
``disparity_from_flax`` / ``refine_from_flax``. At these scales the
Refine net's outputs stay O(1) (the JAX package's own torch-twin test
of Refine draws weights whose outputs reach ~7,500, where f32
summation order alone misses its rtol of 1e-4).

The image is 40x320: the estimator fits it into 512 as 64x512 and
returns a 32x256 disparity, so the adjustment runs at image resolution
and back, and Refine upsamples a grid that is not the image's. JAX is
imported only where the JAX side runs (``jx``), so the card-side test
runs where JAX is missing.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.models import convert
from cartoonsegmentation_torch.models.kenburns import (DisparityEstimator,
                                                       Refine)
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from test_torch_refiners import randomize_nets
from torch_cpu import torch_threads  # noqa: F401  (autouse)

H, W = 40, 320
CFG = dict(detector='none', dtype='float32', depth_est='default',
           default_depth_refine=True, max_size=320)


@pytest.fixture(scope='module')
def jx():
    """The JAX package's pieces this file uses."""
    import types
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.config import KenBurnsConfig
    from cartoonsegmentation_tpu.instances import Instances
    from cartoonsegmentation_tpu.models import kenburns
    from cartoonsegmentation_tpu.pipeline.kenburns import KenBurnsPipeline
    return types.SimpleNamespace(jax=jax, jnp=jnp, Config=KenBurnsConfig,
                                 Ins=Instances, kb=kenburns,
                                 Pipeline=KenBurnsPipeline)


def flax_variables(est: DisparityEstimator, ref: Refine):
    """The JAX package's variables of the port's two nets, through its
    own converters (the disparity checkpoint and torchvision's
    vgg19_bn ``features``)."""
    from cartoonsegmentation_tpu.models import convert as jconvert
    sd = {k: v.numpy() for k, v in est.state_dict().items()}
    dis = {k[len('disparity.'):]: v for k, v in sd.items()
           if k.startswith('disparity.')}
    vgg = {'features.' + k[len('semantics.netVgg.'):]: v
           for k, v in sd.items() if k.startswith('semantics.')}
    p, s = jconvert.convert_semantics(vgg)
    dvars = {'params': {'disparity': jconvert.convert_disparity(dis),
                        'semantics': p},
             'batch_stats': {'semantics': s}}
    rvars = {'params': jconvert.convert_refine(
        {k: v.numpy() for k, v in ref.state_dict().items()})}
    return dvars, rvars


def _image(seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 19 + c) * np.cos(yy / 7 - c)
                    for c in range(3)], -1)
    img += rng.randn(H, W, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def _masks():
    """Three instances: two boxes and a disc."""
    yy, xx = np.mgrid[0:H, 0:W]
    m = np.zeros((3, H, W), bool)
    m[0, 5:30, 20:90] = True
    m[1, 10:38, 150:230] = True
    m[2] = (xx - 270) ** 2 + (yy - 20) ** 2 < 15 ** 2
    return m, np.zeros((3, 4), np.float32)


@pytest.fixture(scope='module')
def nets():
    est = randomize_nets(DisparityEstimator(), 3)
    ref = randomize_nets(Refine(), 4)
    return est, ref, *flax_variables(est, ref)


def test_converters_round_trip(nets):
    """disparity_from_flax / refine_from_flax give back the port's
    tensors exactly, every key (the VGG BatchNorm statistics too)."""
    est, ref, dvars, rvars = nets
    for module, back in ((est, convert.disparity_from_flax(dvars)),
                         (ref, convert.refine_from_flax(rvars['params']))):
        for k, v in module.state_dict().items():
            if not k.endswith('num_batches_tracked'):
                assert torch.equal(back[k], v), k


def test_nets_vs_jax(nets, jx):
    """DisparityEstimator on the 40x320 image (a 32x256 disparity) and
    Refine from that grid to 40x320: within 1e-5 of the output's range
    (measured 1.6e-6 and 4.7e-7 of it)."""
    est, ref, dvars, rvars = nets
    x = (_image() / np.float32(255))[None]
    want = np.asarray(jx.jax.jit(jx.kb.DisparityEstimator().apply)(
        dvars, jx.jnp.asarray(x)))
    with torch.no_grad():
        got = est(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (1, 1, 32, 256) and want.shape[1:3] == \
        (32, 256)
    assert 0.05 < (want > 0).mean() < 0.95
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())
    d = (np.random.RandomState(1).rand(1, 32, 256, 1) + 0.5).astype(
        np.float32)
    want = np.asarray(jx.jax.jit(jx.kb.Refine().apply)(
        rvars, jx.jnp.asarray(x), jx.jnp.asarray(d)))
    with torch.no_grad():
        got = ref(torch.from_numpy(x).permute(0, 3, 1, 2),
                  torch.from_numpy(d).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (1, 1, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope='module')
def pipes(nets, jx):
    est, ref, dvars, rvars = nets
    jp = jx.Pipeline(jx.Config(**CFG), seed=0)
    jp.stage_previews = False
    jp._disparity_vars, jp._refine_vars = dvars, rvars
    tp = TPipeline(TConfig(**CFG), device='cpu')
    tp.disparity_net, tp.refine_net = est, ref
    return jp, tp


def test_coarse_grid_adjust_vs_jax(pipes, jx):
    """The instance adjustment of a 32x256 disparity for a 40x320 image:
    resized up without antialias, adjusted, resized back; within 1e-4 of
    JAX's (measured 3.3e-6, the adjustment moving values by up to 4.7)."""
    jp, tp = pipes
    img = _image()
    masks, boxes = _masks()
    image = img.astype(np.float32) / 255.0
    coarse = (np.random.RandomState(2).rand(32, 256, 1) * 5 + 1).astype(
        np.float32)
    want = np.asarray(jp._adjust_disparity(
        jx.jnp.asarray(image), jx.jnp.asarray(coarse),
        jx.Ins.from_numpy(masks, boxes, capacity=4)))
    got = tp._adjust_disparity(
        torch.from_numpy(image), torch.from_numpy(coarse),
        TIns.from_numpy(masks, boxes, capacity=4)).numpy()
    assert got.shape == want.shape == (32, 256, 1)
    assert np.abs(want - coarse).max() > 0.1      # the instances moved it
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_generate_state_vs_jax(pipes, jx):
    """generate_state with depth_est 'default' and default_depth_refine
    on the image and three instances: the disparity (normalised to the
    baseline of 40) within 1e-3 of JAX's (measured 1.2e-4), the depth's
    reciprocal within 1e-4 relative, and the same depth-range anchor."""
    jp, tp = pipes
    img = _image()
    masks, boxes = _masks()
    sj = jp.generate_state(img, jx.Ins.from_numpy(masks, boxes,
                                                  capacity=4))
    st = tp.generate_state(img, TIns.from_numpy(masks, boxes, capacity=4))
    dj = np.asarray(sj.disparity)
    assert st.disparity.shape == dj.shape == (H, W, 1)
    assert dj.std() > 0.5
    np.testing.assert_allclose(st.disparity.numpy(), dj, rtol=0, atol=1e-3)
    np.testing.assert_allclose(1.0 / st.depth.numpy(),
                               1.0 / np.asarray(sj.depth), rtol=1e-4,
                               atol=1e-7)
    assert (int(st.depth_min_u), int(st.depth_min_v)) == \
        (int(sj.depth_min_u), int(sj.depth_min_v))
    assert set(tp.timer.seconds) >= {'depth_estimate', 'depth_adjust',
                                     'depth_refine', 'prepare_state'}


def test_estimate_depth_cli(nets, jx, tmp_path, capsys, monkeypatch):
    """python -m cartoonsegmentation_torch.estimate_depth on the CPU:
    'default' writes the .npy depth and the .png preview at image size,
    equal to the JAX tool's chain on the same nets (the depth's
    reciprocal, the disparity, within 1e-4 of its range); 'zoe' (a small
    ZoeDepth installed for the image's 64x320 grid) writes a finite depth
    map at image size; 'marigold' (a small Marigold model installed)
    writes a finite depth map at image size too."""
    cv2 = pytest.importorskip('cv2')
    import importlib.util
    from pathlib import Path
    from cartoonsegmentation_torch import estimate_depth
    from cartoonsegmentation_torch.pipeline import kenburns as tkb
    est, ref, dvars, rvars = nets
    src = tmp_path / 'pic.png'
    cv2.imwrite(str(src), _image())
    made = []
    orig = tkb.KenBurnsPipeline.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.disparity_net, self.refine_net = est, ref
        made.append(self)
    monkeypatch.setattr(tkb.KenBurnsPipeline, '__init__', init)
    estimate_depth.main(['--in', str(src), '--out', str(tmp_path / 'd.npy'),
                         '--device', 'cpu'])
    assert 'wrote' in capsys.readouterr().out
    depth = np.load(tmp_path / 'd.npy')
    assert depth.shape == (H, W) and depth.dtype == np.float32
    assert cv2.imread(str(tmp_path / 'd.png')).shape[:2] == (H, W)
    spec = importlib.util.spec_from_file_location(
        'jax_estimate_depth',
        Path(__file__).resolve().parent.parent / 'scripts' /
        'estimate_depth.py')
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    jp = jx.Pipeline(jx.Config(depth_est='default', detector='none'), seed=0)
    jp._disparity_vars, jp._refine_vars = dvars, rvars
    _, want = jtool.depthestim(jp, _image())
    np.testing.assert_allclose(1.0 / depth, 1.0 / want, rtol=0,
                               atol=1e-4 * (1.0 / want).max())
    from test_torch_zoedepth import make_zoe

    def init_zoe(self, *a, **k):
        init(self, *a, **k)
        self.zoe_net = make_zoe(False, (64, 320))
    monkeypatch.setattr(tkb.KenBurnsPipeline, '__init__', init_zoe)
    estimate_depth.main(['--in', str(src), '--out', str(tmp_path / 'z.npy'),
                         '--depth-est', 'zoe', '--device', 'cpu'])
    zdepth = np.load(tmp_path / 'z.npy')
    assert zdepth.shape == (H, W) and np.isfinite(zdepth).all()
    assert cv2.imread(str(tmp_path / 'z.png')).shape[:2] == (H, W)
    from test_torch_marigold import tiny_marigold

    def init_marigold(self, *a, **k):
        init(self, *a, **k)
        self.marigold = tiny_marigold()
    monkeypatch.setattr(tkb.KenBurnsPipeline, '__init__', init_marigold)
    estimate_depth.main(['--in', str(src), '--out', str(tmp_path / 'm.npy'),
                         '--depth-est', 'marigold', '--device', 'cpu'])
    mdepth = np.load(tmp_path / 'm.npy')
    assert mdepth.shape == (H, W) and np.isfinite(mdepth).all()
    assert mdepth.std() > 0
    assert cv2.imread(str(tmp_path / 'm.png')).shape[:2] == (H, W)

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
def test_nets_card_vs_cpu(cuda):
    """DisparityEstimator on a 576x1024 image (288x512 in, 144x256 out)
    and Refine from 144x256 to 576x1024, f32 on the card (cuDNN, TF32
    off) against the CPU: within 1e-4 of the output's range."""
    dev = cuda
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 3, 576, 1024, generator=g)
    est = randomize_nets(DisparityEstimator(), 3)
    ref = randomize_nets(Refine(), 4)
    with torch.no_grad():
        a = est(x)
        b = est.to(dev)(x.to(dev)).cpu()
        assert tuple(a.shape) == (1, 1, 144, 256)
        assert (b - a).abs().max() <= 1e-4 * a.abs().max()
        c = ref(x, a)
        d = ref.to(dev)(x.to(dev), a.to(dev)).cpu()
        assert (d - c).abs().max() <= 1e-4 * c.abs().max()

"""The port's LeReS boosting (``depth_est: leres_boost``: the host patch
selection, the pix2pix merge net, ``LeReSBoost``, the pipeline and the
estimate_depth CLI) against the JAX package's, on the CPU in f32.

The sizes are cut as tests/test_boost.py cuts them (the receptive field
64, patches at 128, the merge at 128, R_max 400), the merge net to 6
downs of width 8 and the LeReS trunk to one block a stage. The nets'
weights come from Flax (a reduced LeReS with perturbed BatchNorm
statistics) or from the port through ``convert_pix2pix4depth``. JAX is
imported only inside the fixtures and tests that run it (``jx``), so
the card-side test runs where JAX is missing.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.models import pix2pix4depth as tp2p
from cartoonsegmentation_torch.models.leres import LeReS as TLeReS
from cartoonsegmentation_torch.pipeline import boost as tboost
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from torch_cpu import torch_threads  # noqa: F401  (autouse)

cv2 = pytest.importorskip('cv2')

LAYERS = (1, 1, 1, 1)
SMALL = dict(RECEPTIVE_FIELD=64, PATCH_NETSIZE=128, PIX2PIX_SIZE=128,
             WHOLE_SIZE_THRESHOLD=400)
P2P = dict(num_downs=6, ngf=8)
H, W = 96, 128
CFG = dict(detector='none', dtype='float32', max_size=128,
           depth_est='leres_boost')


@pytest.fixture(scope='module')
def jx():
    """The JAX package's pieces this file uses."""
    import types
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.config import KenBurnsConfig
    from cartoonsegmentation_tpu.models import leres, pix2pix4depth
    from cartoonsegmentation_tpu.pipeline import boost
    from cartoonsegmentation_tpu.pipeline.kenburns import KenBurnsPipeline
    return types.SimpleNamespace(jax=jax, jnp=jnp, boost=boost, leres=leres,
                                 p2p=pix2pix4depth, Config=KenBurnsConfig,
                                 Pipeline=KenBurnsPipeline)


@pytest.fixture
def small(jx, monkeypatch):
    """Both packages' boost constants cut to the test's sizes."""
    for mod in (jx.boost, tboost):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)


def _textured_image(h=300, w=400, seed=0):
    """Flat grey with noise in the top-left quadrant (tests/test_boost.py)
    and a few smooth bands, BGR uint8."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 40 * np.sin(xx / 11 + c) for c in range(3)], -1)
    img[:h // 2, :w // 2] = rng.rand(h // 2, w // 2, 3) * 255
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize('shape', [(300, 400), (160, 200), (97, 131)])
def test_host_selection_equal(jx, shape):
    """generatemask, _resizewithpool, calculateprocessingres and
    generatepatchs (its grid and _adaptiveselection) give JAX's values
    exactly."""
    img = _textured_image(*shape, seed=shape[1])
    h, w = shape
    assert np.array_equal(tboost.generatemask((h, w)),
                          jx.boost.generatemask((h, w)))
    g = np.random.RandomState(1).rand(h, w)
    assert np.array_equal(tboost._resizewithpool(g, 9),
                          jx.boost._resizewithpool(g, 9))
    for base, conf, cap in ((64, 0.2, 400), (448, 0.2, 1600)):
        if 3 * max(shape) <= base:      # an empty search (both raise)
            continue
        assert tboost.calculateprocessingres(img, base, conf, 3, cap) == \
            jx.boost.calculateprocessingres(img, base, conf, 3, cap)
    for base, factor in ((128, 1.0), (64, 0.54)):
        got = tboost.generatepatchs(img, base, factor)
        assert got == jx.boost.generatepatchs(img, base, factor)
    assert tboost.generatepatchs(img, 64, 0.54)


@pytest.fixture(scope='module')
def p2p_nets(jx):
    """The port's small merge net from numpy, its Flax variables through
    ``convert_pix2pix4depth``."""
    net = tp2p.Pix2Pix4Depth(**P2P)
    rng = np.random.RandomState(3)
    net.load_state_dict({k: torch.from_numpy(
        (rng.randn(*v.shape) / np.sqrt(v[0].numel() if v.ndim > 1 else 10)
         ).astype(np.float32)) for k, v in net.state_dict().items()})
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    return net.eval(), jx.p2p.convert_pix2pix4depth(sd, **P2P)


def test_pix2pix_and_merge_vs_jax(jx, p2p_nets):
    """Pix2Pix4Depth at 128 (6 downs, width 8) within 1e-5 of JAX's
    (measured 3.0e-7), merge_depths within 1e-5 (1.8e-7)."""
    net, variables = p2p_nets
    jnet = jx.p2p.Pix2Pix4Depth(**P2P)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 128, 128, 2).astype(np.float32) * 2 - 1
    want = np.asarray(jnet.apply(variables, jx.jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert want.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    a, b = (rng.rand(128, 128).astype(np.float32) * s for s in (3, 0.5))
    want = np.asarray(jx.p2p.merge_depths(jnet, variables, jx.jnp.asarray(a),
                                          jx.jnp.asarray(b)))
    with torch.no_grad():
        got = tp2p.merge_depths(net, torch.from_numpy(a)[None],
                                torch.from_numpy(b)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the checkpoint's key names: latest_net_G.pth's nesting
    keys = set(net.state_dict())
    assert 'model.model.0.weight' in keys and 'model.model.3.bias' in keys
    assert 'model.model.1.model.1.weight' in keys


class _JaxFakeLeres:
    """tests/test_boost.py's stand-ins: inverted brightness; the mean of
    the two merge inputs."""

    def apply(self, variables, rgb):
        return 1.0 - rgb.mean(-1, keepdims=True)


class _JaxFakeP2P:
    def apply(self, variables, x):
        return x.mean(-1, keepdims=True)


class _FakeLeres(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def forward(self, rgb):
        return 1.0 - rgb.mean(1, keepdim=True)


class _FakeP2P(torch.nn.Module):
    def forward(self, x):
        return x.mean(1, keepdim=True)


def _capture(monkeypatch, mod, seen):
    orig = mod.generatepatchs

    def rec(*a, **k):
        out = orig(*a, **k)
        seen.append([tuple(p['rect']) for p in out])
        return out
    monkeypatch.setattr(mod, 'generatepatchs', rec)


@pytest.mark.parametrize('max_res', [2048, 1])
def test_leres_boost_stub_nets_vs_jax(jx, small, monkeypatch, max_res):
    """LeReSBoost with the stand-in nets on both sides (160x200): the
    same patch set, and the boosted depth within 1e-5 of JAX's (the
    blend's polyfit and cv2 resizes on the same inputs); with max_res 1
    only the double estimate, also within 1e-5."""
    img = _textured_image(160, 200, seed=3)
    seen_j, seen_t = [], []
    _capture(monkeypatch, jx.boost, seen_j)
    _capture(monkeypatch, tboost, seen_t)
    want = jx.boost.LeReSBoost(_JaxFakeLeres(), None, _JaxFakeP2P(), None,
                               max_res=max_res)(img)
    monkeypatch.setattr(tboost, 'PATCH_BATCH', 3)
    boost = tboost.LeReSBoost(_FakeLeres(), _FakeP2P(), max_res=max_res)
    got = boost(img)
    assert got.shape == want.shape == (160, 200)
    assert seen_t == seen_j
    if max_res == 1:
        assert seen_t == [] and boost.last_rects == []
    else:
        assert len(boost.last_rects) == len(seen_t[0]) >= 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _leres_variables(jx):
    net = jx.leres.LeReS(encoder_layers=LAYERS)
    v = jx.jax.jit(net.init)(jx.jax.random.PRNGKey(1),
                             jx.jnp.zeros((1, 64, 64, 3), jx.jnp.float32))
    rng = np.random.RandomState(2)

    def perturb(path, a):
        return (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == 'var'
                else rng.randn(*a.shape) * 0.1).astype(np.float32)
    tree = jx.jax.tree_util
    return net, {'params': tree.tree_map(np.asarray, v['params']),
                 'batch_stats': tree.tree_map_with_path(perturb,
                                                        v['batch_stats'])}


def test_generate_state_and_cli_vs_jax(jx, small, p2p_nets, tmp_path,
                                       capsys, monkeypatch):
    """generate_state with depth_est 'leres_boost' on a 96x128 image
    (R_x 128: the double estimate, then the patches): the same patch set
    as JAX's, the disparity (leres_postprocess's 8-bit levels, scaled to
    the baseline 40) within one level everywhere and within 1e-4 at >=
    99% of pixels; then the estimate_depth CLI against the JAX tool's
    depthestim on the same pipeline: the disparity the depth implies
    (focal · 40 / depth) the same way."""
    from cartoonsegmentation_torch import estimate_depth
    from cartoonsegmentation_torch.models.convert import leres_from_flax
    from cartoonsegmentation_torch.pipeline import kenburns as tkb
    net, pvars = p2p_nets
    jleres, lvars = _leres_variables(jx)
    jp = jx.Pipeline(jx.Config(**CFG), seed=0)
    jp.stage_previews = False
    jp._boost = jx.boost.LeReSBoost(jleres, lvars,
                                    jx.p2p.Pix2Pix4Depth(**P2P), pvars)
    leres = TLeReS(LAYERS)
    leres.load_state_dict(leres_from_flax(lvars, leres))

    def install(pipe):
        pipe.leres_net, pipe.p2p_net = leres, net
    tp = TPipeline(TConfig(**CFG), device='cpu')
    install(tp)
    seen_j, seen_t = [], []
    _capture(monkeypatch, jx.boost, seen_j)
    _capture(monkeypatch, tboost, seen_t)
    img = _textured_image(H, W, seed=3)
    sj, st = jp.generate_state(img), tp.generate_state(img)
    assert seen_t == seen_j and len(seen_t[0]) >= 2
    assert tp.last_boost.last_rects and tp.last_boost.last_whole_size == 128
    dj, dt = np.asarray(sj.disparity), st.disparity.numpy()
    assert dt.shape == dj.shape == (H, W, 1) and dj.std() > 1.0
    diff = np.abs(dt - dj)
    assert diff.max() <= 40.0 / 255 + 1e-4
    assert (diff <= 1e-4).mean() >= 0.99

    src = tmp_path / 'pic.png'
    cv2.imwrite(str(src), img)
    orig = tkb.KenBurnsPipeline.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        install(self)
    monkeypatch.setattr(tkb.KenBurnsPipeline, '__init__', init)
    estimate_depth.main(['--in', str(src), '--out', str(tmp_path / 'd.npy'),
                         '--depth-est', 'leres_boost', '--device', 'cpu'])
    assert 'wrote' in capsys.readouterr().out
    depth = np.load(tmp_path / 'd.npy')
    assert depth.shape == (H, W) and depth.dtype == np.float32
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'jax_estimate_depth',
        Path(__file__).resolve().parent.parent / 'scripts' /
        'estimate_depth.py')
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    _, want = jtool.depthestim(jp, img)
    focal = max(H, W) / 2.0
    diff = np.abs(focal * 40.0 / depth - focal * 40.0 / want)
    assert diff.max() <= 40.0 / 255 + 1e-4
    assert (diff <= 1e-4).mean() >= 0.99


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
def test_merge_net_card_vs_cpu(cuda):
    """The full-width merge net at 1024 (10 downs, width 64), f32 on the
    card against the CPU: within 1e-4."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = tp2p.Pix2Pix4Depth().eval()
    g = torch.Generator().manual_seed(1)
    a, b = torch.rand(1024, 1024, generator=g), torch.rand(1024, 1024,
                                                         generator=g)
    with torch.no_grad():
        want = tp2p.merge_depths(net, a[None], b[None])
        got = tp2p.merge_depths(net.to(cuda), a[None].to(cuda),
                                b[None].to(cuda)).cpu()
    assert (got - want).abs().max() <= 1e-4

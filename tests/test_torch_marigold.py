"""The port's Marigold diffusion depth (``depth_est: marigold``) against
the JAX package's, on the CPU in f32.

The model runs at the tiny geometry of tests/test_marigold.py
(processing_res 32, 2 steps, ensemble 2, block_out (32, 64), context
width 16); its weights are drawn in the port and go to Flax through the
JAX package's ``convert_unet`` / ``convert_vae``. JAX draws its noise
with ``jax.random``, which torch cannot repeat, so the port is handed
JAX's start noise and LCM step noises (``jax_noise``, the keys as
``MarigoldDepth.__call__`` splits them). One 32x48 image serves every
comparison, so each scheduler compiles one JAX sampler. Tolerances: the
depth within 1e-4 (measured 4e-6) of [0, 1], the ensemble merge within
1e-5, the pipeline's disparity and the CLI's inverse depth within 1e-4
of their largest value. JAX is imported only inside the fixtures and
tests that run it (``jx``), so the card-side test runs where JAX is
missing.
"""
import types

import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.models import marigold as tm
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from test_torch_ldm import TINY_UNET, TINY_VAE, _legacy, randomized
from torch_cpu import torch_threads  # noqa: F401  (autouse)

H, W = 32, 48
TINY = dict(processing_res=32, denoise_steps=2, ensemble_size=2,
            unet_cfg=dict(TINY_UNET, heads=(1, 1)), vae_cfg=TINY_VAE,
            context_dim=16)
CFG = dict(detector='none', dtype='float32', max_size=48, num_frame=2,
           depth_field=False)
DEPTH_TOL = 1e-4


@pytest.fixture(scope='module')
def jx():
    """The JAX package's pieces this file uses."""
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.config import KenBurnsConfig
    from cartoonsegmentation_tpu.models import marigold
    from cartoonsegmentation_tpu.pipeline.kenburns import KenBurnsPipeline
    return types.SimpleNamespace(jax=jax, jnp=jnp, mg=marigold,
                                 Config=KenBurnsConfig,
                                 Pipeline=KenBurnsPipeline)


def tiny_marigold(scheduler: str = 'lcm', seed: int = 0):
    m = tm.MarigoldDepth(scheduler=scheduler, seed=seed, **TINY)
    m.init_random('cpu')
    randomized(m.unet, seed + 1)
    randomized(m.vae, seed + 2)
    return m


def jax_variables(jx, m):
    unet = m.unet
    ve, vd = jx.mg.convert_vae(m.vae.state_dict(), **TINY_VAE)
    return {'unet': jx.mg.convert_unet(
        unet.state_dict(), block_out=unet.block_out,
        layers_per_block=unet.layers_per_block,
        cross_attn=unet.cross_attn),
        'encoder': ve, 'decoder': vd,
        'text_embed': jx.jnp.asarray(m.text_embed.numpy())}


def jax_noise(jx, m, lh: int, lw: int, seed: int = 0):
    """The noise ``MarigoldDepth.__call__`` of the JAX package draws from
    ``seed``, in ``draw_noise``'s layout (NCHW)."""
    rng = jx.jax.random.PRNGKey(seed)
    knoise, kloop = jx.jax.random.split(rng)
    shape = (m.ensemble_size, lh, lw, 4)

    def nchw(a):
        return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())
    start = nchw(jx.jax.random.normal(knoise, shape, jx.jnp.float32))
    keys = jx.jax.random.split(kloop, m.denoise_steps)
    n = m.denoise_steps - 1 if m.scheduler_kind == 'lcm' else 0
    return start, [nchw(jx.jax.random.normal(keys[i], shape,
                                             jx.jnp.float32))
                   for i in range(n)]


def with_jax_noise(jx, m):
    """``m`` drawing JAX's noise (the seam the pipeline calls)."""
    m.draw_noise = lambda lh, lw, seed=None: jax_noise(
        jx, m, lh, lw, m.seed if seed is None else seed)
    return m


def _image(seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 7 + c) * np.cos(yy / 5 - c)
                    for c in range(3)], -1)
    img += rng.randn(H, W, 3) * 6
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope='module')
def models(jx):
    """Per scheduler: the port's model and the JAX one on its weights."""
    out = {}
    for sch in ('lcm', 'ddim'):
        t = tiny_marigold(sch)
        j = jx.mg.MarigoldDepth(scheduler=sch, **TINY)
        j.variables = jax_variables(jx, t)
        out[sch] = (t, j)
    return out


@pytest.mark.parametrize('E', [2, 3, 5])
def test_ensemble_depths_vs_jax(jx, E):
    """The merge of E members (an even E averages the two middle values,
    as jnp.median does; torch.median would take the lower), within 1e-5;
    ties in the members included."""
    rng = np.random.RandomState(E)
    g = np.cumsum(rng.rand(24, 20), 0).astype(np.float32)
    preds = np.stack([a * g + b + rng.randn(24, 20).astype(np.float32)
                      for a, b in zip((1.0, 3.0, 0.5, 2.0, 1.5),
                                      (0.0, -1.0, 7.0, 2.0, -0.5))][:E])
    preds[:, :3] = np.round(preds[:, :3])
    want = np.asarray(jx.mg.ensemble_depths(jx.jnp.asarray(preds)))
    got = tm.ensemble_depths(torch.from_numpy(preds)).numpy()
    assert got.shape == (24, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('sch', ['lcm', 'ddim'])
def test_marigold_vs_jax(jx, models, sch):
    """MarigoldDepth on a 32x48 image (a 24x32 processing size, a 12x16
    latent, the u8 resize by cv2's rule) against JAX's on JAX's noise:
    the depth at (H, W) within DEPTH_TOL."""
    t, j = models[sch]
    img = _image()
    want = j(img[..., ::-1])
    ph, pw, lh, lw = t.latent_hw(H, W)
    assert (ph, pw, lh, lw) == (24, 32, 12, 16)
    got = t(img[..., ::-1], noise=jax_noise(jx, t, lh, lw)).numpy()
    assert got.shape == (H, W) and np.isfinite(got).all()
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_TOL)


def test_noise_and_random_init_are_seeded():
    """draw_noise: the shapes, E x (steps - 1) LCM noises (none for DDIM),
    the same draw for the same seed; init_random from the seed; the
    forward deterministic on its own noise."""
    m = tiny_marigold('lcm')
    a, b = m.draw_noise(3, 5), m.draw_noise(3, 5)
    assert tuple(a[0].shape) == (2, 4, 3, 5) and len(a[1]) == 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])
    assert not torch.equal(a[0], m.draw_noise(3, 5, seed=1)[0])
    assert tiny_marigold('ddim').draw_noise(3, 5)[1] == []
    x = tm.MarigoldDepth(**TINY).init_random('cpu', 3)
    y = tm.MarigoldDepth(**TINY).init_random('cpu', 3)
    for k, v in x.state_dict().items():
        assert torch.equal(v, y.state_dict()[k]), k
    assert 0.01 < float(x.text_embed.std()) < 0.03
    img = _image(1)
    np.testing.assert_array_equal(m(img).numpy(), m(img).numpy())


def test_checkpoint_loads_as_jax(jx, tmp_path):
    """unet/ and vae/ state dicts saved as torch files (the VAE in the
    legacy attention names, in a 'state_dict' entry) load into the
    pipeline's model as into JAX's: equal to the JAX variables carried
    back, the text embedding zeros without a text tower. The port takes
    the same UNet with its Linear projections saved as 1x1-conv
    weights."""
    from cartoonsegmentation_torch.models.convert import (unet_from_flax,
                                                          vae_from_flax)
    src = tiny_marigold('lcm', seed=7)
    unet_sd = src.unet.state_dict()
    torch.save(unet_sd, tmp_path / 'unet.pt')
    torch.save({k: v[..., None, None] if '.proj_' in k and
                k.endswith('weight') else v for k, v in unet_sd.items()},
               tmp_path / 'unet_conv.pt')
    torch.save({'state_dict': _legacy(src.vae.state_dict())},
               tmp_path / 'vae.pt')
    tp = TPipeline(TConfig(depth_est='marigold', **CFG), device='cpu')
    tp.marigold = tm.MarigoldDepth(**TINY)
    tp.load_marigold_checkpoint(str(tmp_path / 'unet_conv.pt'),
                                str(tmp_path / 'vae.pt'))
    jp = jx.Pipeline(jx.Config(depth_est='marigold', **CFG), seed=0)
    jp._marigold = jx.mg.MarigoldDepth(**TINY)
    jp.load_marigold_checkpoint(str(tmp_path / 'unet.pt'),
                                str(tmp_path / 'vae.pt'))
    v = jp._marigold.variables
    m = tp.marigold
    for want, got in ((unet_from_flax(v['unet'], m.unet), m.unet),
                      (vae_from_flax(v['encoder'], v['decoder'], m.vae),
                       m.vae)):
        for k, t in got.state_dict().items():
            assert torch.equal(t, want[k]), k
    assert not m.text_embed.any() and not np.asarray(v['text_embed']).any()
    assert m.ready('cpu') is m and not m.text_embed.is_meta


@pytest.fixture(scope='module')
def pipes(jx, models):
    """The two pipelines with depth_est 'marigold' on the LCM models, the
    port's drawing JAX's noise."""
    t, j = models['lcm']
    jp = jx.Pipeline(jx.Config(depth_est='marigold', **CFG), seed=0)
    jp.stage_previews = False
    jp._marigold = j
    tp = TPipeline(TConfig(depth_est='marigold', **CFG), device='cpu')
    tp.marigold = with_jax_noise(jx, t)
    return jp, tp


def test_generate_state_vs_jax(pipes):
    """generate_state with depth_est 'marigold' on the 32x48 image: the
    estimator's disparity ((1 - depth) · 255, zeros lifted to the
    smallest positive value) within 1e-4 of its largest value of JAX's,
    then the state's disparity and inverse depth the same."""
    jp, tp = pipes
    img = _image()
    image = img.astype(np.float32) / 255.0
    dj = np.asarray(jp._estimate_disparity(image))
    dt = tp._estimate_disparity(torch.from_numpy(image)).numpy()
    assert dt.shape == dj.shape == (H, W, 1) and dj.min() > 0
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-4 * dj.max())
    sj, st = jp.generate_state(img), tp.generate_state(img)
    d = np.asarray(sj.disparity)
    assert st.disparity.shape == d.shape == (H, W, 1)
    np.testing.assert_allclose(st.disparity.numpy(), d, rtol=0,
                               atol=1e-4 * d.max())
    np.testing.assert_allclose(1.0 / st.depth.numpy(),
                               1.0 / np.asarray(sj.depth), rtol=0,
                               atol=1e-4 * (1.0 / np.asarray(sj.depth)).max())
    assert set(tp.timer.seconds) >= {'depth_estimate', 'prepare_state'}


def test_estimate_depth_cli_marigold(jx, pipes, tmp_path, capsys,
                                     monkeypatch):
    """python -m cartoonsegmentation_torch.estimate_depth --depth-est
    marigold on the CPU: the .npy depth and the .png preview at image
    size, the inverse depth within 1e-4 of its largest value of the JAX
    tool's depthestim on the same model and noise."""
    cv2 = pytest.importorskip('cv2')
    import importlib.util
    from pathlib import Path
    from cartoonsegmentation_torch import estimate_depth
    from cartoonsegmentation_torch.pipeline import kenburns as tkb
    jp, tp = pipes
    img = _image()
    src = tmp_path / 'pic.png'
    cv2.imwrite(str(src), img)
    orig = tkb.KenBurnsPipeline.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.marigold = tp.marigold
    monkeypatch.setattr(tkb.KenBurnsPipeline, '__init__', init)
    estimate_depth.main(['--in', str(src), '--out', str(tmp_path / 'd.npy'),
                         '--depth-est', 'marigold', '--device', 'cpu'])
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
    _, want = jtool.depthestim(jp, img)
    np.testing.assert_allclose(1.0 / depth, 1.0 / want, rtol=0,
                               atol=1e-4 * (1.0 / want).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('sch', ['lcm', 'ddim'])
def test_marigold_card_vs_cpu(cuda, sch):
    """The tiny model in f32 on the card (TF32 off) against the CPU on the
    same host-drawn noise: the depth within DEPTH_TOL; the pipeline's
    marigold disparity on the card finite and of the image's size."""
    m = tiny_marigold(sch)
    img = _image()
    noise = m.draw_noise(*m.latent_hw(H, W)[2:])
    want = m(img, noise=noise).numpy()
    got = m.to(cuda)(img, noise=noise).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=DEPTH_TOL)
    tp = TPipeline(TConfig(depth_est='marigold', **CFG), device=cuda)
    tp.marigold = m
    d = tp._estimate_disparity(torch.from_numpy(
        img.astype(np.float32) / 255.0).to(cuda))
    assert tuple(d.shape) == (H, W, 1) and bool(torch.isfinite(d).all())

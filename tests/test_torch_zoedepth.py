"""The port's ZoeDepth (``depth_est`` 'zoe' and 'zoe_nk') against the JAX
package's, on the CPU in f32.

The nets run at the twin geometry of tests/test_zoedepth_nk.py, cut to 4
blocks: 64x64, dim 64, 4 heads, DPT features 32, 16 bins. Their weights
are made in the port from numpy (``randomize_nets``) and go to Flax
through the JAX package's ``convert_zoedepth`` / ``convert_zoedepth_nk``
(the port keeps the checkpoint's key names, so its state dict is a
checkpoint). The pipeline tests save such a state dict at a 4x4 grid
and load it into both packages at a 4x6 grid, so that both resize the
bias tables. JAX is imported only inside the fixtures and tests that run
it (``jx``), so the card-side test runs where JAX is missing.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.config import KenBurnsConfig as TConfig
from cartoonsegmentation_torch.models import beit as tbeit
from cartoonsegmentation_torch.models import zoedepth as tz
from cartoonsegmentation_torch.pipeline.kenburns import \
    KenBurnsPipeline as TPipeline
from cartoonsegmentation_torch.utils.image import (resize_bilinear_aa,
                                                   resize_cubic)
from torch_cpu import torch_threads  # noqa: F401  (autouse)

GEO = dict(bin_embedding_dim=32, core_features=32,
           core_out_channels=(32, 64, 96, 96), core_dim=64, core_depth=4,
           core_heads=4, core_hooks=(0, 1, 2, 3), btlnck_features=48)
BIN_CONF = (('nyu', 16, 1e-3, 10.0), ('kitti', 16, 1e-3, 80.0))
# the pipeline's image: fitted into 672 by /32 it is 64x96, a 4x6 grid
H, W = 40, 72
CFG = dict(detector='none', dtype='float32', max_size=128)


def randomize_nets(module: torch.nn.Module, seed: int):
    """Every float tensor from numpy: matrices and kernels at
    1/sqrt(fan-in), vectors at 0.1."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        a = rng.randn(*v.shape) * (1 / np.sqrt(v[0].numel()) if v.ndim >= 2
                                   else 0.1)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    module.load_state_dict(sd)
    return module.eval()


def make_zoe(nk: bool, img_size=(64, 64)):
    if nk:
        return tz.ZoeDepthNK(img_size=img_size, bin_conf=BIN_CONF, **GEO)
    return tz.ZoeDepth(img_size=img_size, n_bins=16, **GEO)


def random_zoe(nk: bool, seed: int, img_size=(64, 64)):
    return randomize_nets(make_zoe(nk, img_size), seed)


@pytest.fixture(scope='module')
def jx():
    """The JAX package's pieces this file uses."""
    import types
    import jax
    import jax.numpy as jnp
    from cartoonsegmentation_tpu.config import KenBurnsConfig
    from cartoonsegmentation_tpu.models import beit, convert_zoedepth, zoedepth
    from cartoonsegmentation_tpu.pipeline.kenburns import KenBurnsPipeline
    return types.SimpleNamespace(jax=jax, jnp=jnp, beit=beit, z=zoedepth,
                                 cz=convert_zoedepth, Config=KenBurnsConfig,
                                 Pipeline=KenBurnsPipeline)


def jax_zoe(jx, nk: bool, img_size=(64, 64)):
    if nk:
        return jx.z.ZoeDepthNK(img_size=img_size, bin_conf=BIN_CONF, **GEO)
    return jx.z.ZoeDepth(img_size=img_size, n_bins=16, **GEO)


def _sd(net):
    return {k: v.numpy() for k, v in net.state_dict().items()}


@pytest.mark.parametrize('src,dst', [((48, 64), (96, 128)),
                                     ((96, 128), (48, 64)),
                                     ((37, 53), (91, 20)),
                                     ((100, 80), (33, 160))])
def test_resizes_vs_jax(jx, src, dst):
    """resize_cubic / resize_bilinear_aa against jax.image.resize 'cubic'
    and 'linear' (antialiased): equal enlarging, within 1e-6 shrinking or
    mixed (measured 4.2e-7)."""
    x = np.random.RandomState(0).rand(*src, 3).astype(np.float32)
    for fn, method in ((resize_cubic, 'cubic'), (resize_bilinear_aa,
                                                  'linear')):
        want = np.asarray(jx.jax.image.resize(jx.jnp.asarray(x), dst + (3,),
                                              method=method))
        got = fn(torch.from_numpy(x), *dst).numpy()
        tol = 0.0 if dst[0] >= src[0] and dst[1] >= src[1] else 1e-6
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=method)


@pytest.mark.parametrize('grid', [(4, 4), (3, 5), (24, 42)])
def test_rel_pos_index_equal(jx, grid):
    assert np.array_equal(tbeit.rel_pos_index(*grid),
                          jx.beit.rel_pos_index(*grid))
    assert tbeit.table_rows(grid) == tbeit.rel_pos_index(*grid).max() + 1


def test_beit_block_vs_jax(jx):
    """One BEiT block at dim 64, 4 heads, a 4x6 grid (25 tokens): within
    1e-5 of its largest value of JAX's (measured 2.4e-7 of 6.9); the Flax parameters written from the
    port's by hand."""
    blk = randomize_nets(tbeit.BeitBlock(64, 4, (4, 6)), 2)
    s = _sd(blk)
    p = {'gamma_1': s['gamma_1'], 'gamma_2': s['gamma_2'],
         'norm1': {'scale': s['norm1.weight'], 'bias': s['norm1.bias']},
         'norm2': {'scale': s['norm2.weight'], 'bias': s['norm2.bias']},
         'attn': {'qkv_kernel': s['attn.qkv.weight'].T,
                  'q_bias': s['attn.q_bias'], 'v_bias': s['attn.v_bias'],
                  'rel_pos_table': s['attn.relative_position_bias_table'],
                  'proj': {'kernel': s['attn.proj.weight'].T,
                           'bias': s['attn.proj.bias']}},
         'mlp_fc1': {'kernel': s['mlp.fc1.weight'].T,
                     'bias': s['mlp.fc1.bias']},
         'mlp_fc2': {'kernel': s['mlp.fc2.weight'].T,
                     'bias': s['mlp.fc2.bias']}}
    x = np.random.RandomState(3).randn(2, 25, 64).astype(np.float32)
    want = np.asarray(jx.beit.BeitBlock(64, 4, (4, 6)).apply(
        {'params': p}, jx.jnp.asarray(x)))
    with torch.no_grad():
        got = blk(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope='module')
def nets(jx):
    """N and NK: the port's nets, their Flax variables, jitted applies."""
    out = {}
    for nk in (False, True):
        net = random_zoe(nk, 5 if nk else 4)
        conv = jx.cz.convert_zoedepth_nk if nk else jx.cz.convert_zoedepth
        out[nk] = (net, conv(_sd(net), img_size=(64, 64)),
                   jx.jax.jit(jax_zoe(jx, nk).apply))
    return out


def _x(seed=0, n=2):
    return np.random.RandomState(seed).rand(n, 64, 64, 3).astype(np.float32)


def _run_both(net, variables, apply, x):
    want = apply(variables, x)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got, {k: np.asarray(v) for k, v in want.items()}


def test_dpt_and_zoedepth_vs_jax(nets):
    """ZoeDepth N on two images: the DPT's relative depth within 1e-5 of
    its range of JAX's, the metric depth within 1e-5 relative (measured
    4.5e-6 of the range and 1.0e-6)."""
    net, variables, apply = nets[False]
    got, want = _run_both(net, variables, apply, _x())
    rel, md = want['rel_depth'], want['metric_depth'][..., 0]
    assert got['metric_depth'].shape == (2, 1, 64, 64)
    assert md.std() > 1e-3 and rel.std() > 1e-3
    np.testing.assert_allclose(got['rel_depth'].numpy(), rel, rtol=0,
                               atol=1e-5 * np.ptp(rel))
    np.testing.assert_allclose(got['metric_depth'][:, 0].numpy(), md,
                               rtol=1e-5, atol=1e-5 * np.ptp(md))


@pytest.mark.parametrize('force', [None, 'nyu', 'kitti'])
def test_zoedepth_nk_vs_jax(nets, force):
    """ZoeDepthNK with its router as drawn and forced each way (its last
    bias raised by 100 on one domain): the domain logits within 1e-5 and
    the same vote; the metric depth within 1e-5 relative (measured
    ≤ 1.3e-6)."""
    net, variables, apply = nets[True]
    if force is not None:
        import copy
        net = copy.deepcopy(net)
        variables = copy.deepcopy(variables)
        i = ('nyu', 'kitti').index(force)
        with torch.no_grad():
            net.mlp_classifier[2].bias[i] += 100.0
        variables['params']['mlp_classifier1']['bias'][i] += 100.0
    got, want = _run_both(net, variables, apply, _x(1))
    logits = want['domain_logits']
    np.testing.assert_allclose(got['domain_logits'].numpy(), logits, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(logits).max()))
    kitti = bool(logits.sum(0)[1] > logits.sum(0)[0])
    assert bool(got['domain_logits'].sum(0)[1] >
                got['domain_logits'].sum(0)[0]) == kitti
    if force is not None:
        assert kitti == (force == 'kitti')
    md = want['metric_depth'][..., 0]
    np.testing.assert_allclose(got['metric_depth'][:, 0].numpy(), md,
                               rtol=1e-5, atol=1e-5 * np.ptp(md))


def test_nk_heads_differ(nets):
    """The two forced votes give different depths: the heads are each
    domain's own."""
    net = nets[True][0]
    outs = []
    for i in (0, 1):
        import copy
        n = copy.deepcopy(net)
        with torch.no_grad():
            n.mlp_classifier[2].bias[i] += 100.0
            outs.append(n(torch.from_numpy(_x(1)).permute(0, 3, 1, 2))
                        ['metric_depth'])
    assert (outs[0] - outs[1]).abs().max() > 1e-3


class _Probe(torch.nn.Module):
    """A stand-in net at a fixed grid: a smooth nonlinear map of the
    image, so that the pad, the resizes, the crop and the flip show."""

    def __init__(self, img_size):
        super().__init__()
        self.img_size = img_size

    def forward(self, x):
        return {'metric_depth': x.mean(1, keepdim=True) * 2
                + x[:, :1] ** 2 + torch.linspace(0, 1, x.shape[-1])}


def test_infer_zoe_pad_and_flip_vs_jax(jx):
    """infer_zoe on a 48x56 image for a 64x64 grid (padded to 76x86,
    resized to the grid and back, cropped, flip-averaged) with a stand-in
    net on both sides: within 1e-6 relative of JAX's (values up to ~3,
    measured 1.4e-6 at most)."""
    class Fake:
        img_size = (64, 64)

        @staticmethod
        def apply(variables, x):
            jnp = jx.jnp
            return {'metric_depth': x.mean(-1, keepdims=True) * 2
                    + x[..., :1] ** 2
                    + jnp.linspace(0, 1, x.shape[-2])[:, None]}
    x = np.random.RandomState(4).rand(1, 48, 56, 3).astype(np.float32)
    assert tz.pad_tta_amounts(48, 56) == jx.z.pad_tta_amounts(48, 56) == \
        (14, 15)
    for flip in (False, True):
        want = np.asarray(jx.z.infer_zoe(Fake, None, jx.jnp.asarray(x),
                                         with_flip_aug=flip))
        got = tz.infer_zoe(_Probe((64, 64)),
                           torch.from_numpy(x).permute(0, 3, 1, 2),
                           with_flip_aug=flip)
        assert got.shape == (1, 1, 48, 56)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-6, atol=1e-6)


def test_rel_pos_resize_vs_jax(jx):
    """A table trained at 24x24 resized to the 24x42 grid of a 384x672
    image, and a 4x4 net's state dict loaded into a 4x6 net
    (``load_zoe_state_dict``): the tables within 1e-6 of
    ``_resize_rel_pos``'s."""
    table = np.random.RandomState(6).randn(47 * 47 + 3, 16).astype(
        np.float32)
    want = jx.cz._resize_rel_pos(table, (24, 24), (24, 42))
    got = tz.resize_rel_pos_table(torch.from_numpy(table), (24, 24),
                                  (24, 42)).numpy()
    assert got.shape == want.shape == (47 * 83 + 3, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    src = random_zoe(False, 7)
    dst = make_zoe(False, (64, 96))
    tz.load_zoe_state_dict(dst, {'module.' + k: v for k, v in
                                 src.state_dict().items()})
    key = 'core.core.pretrained.model.blocks.2.attn.' \
          'relative_position_bias_table'
    want = jx.cz._resize_rel_pos(_sd(src)[key], (4, 4), (4, 6))
    np.testing.assert_allclose(dst.state_dict()[key].numpy(), want, rtol=0,
                               atol=1e-6)
    assert torch.equal(dst.state_dict()['conv2.weight'],
                       src.state_dict()['conv2.weight'])
    with pytest.raises(KeyError, match='lacks'):
        tz.load_zoe_state_dict(make_zoe(True), src.state_dict())


@pytest.mark.parametrize('K', [16, 64])
def test_log_binomial_vs_jax(jx, K):
    """log_binomial at p in {0, 1e-6, 0.3, 1} and t in {0.0212, 1, 50}:
    finite at every k (k = K-1 included) and within 1e-6 of JAX's."""
    p = np.array([0.0, 1e-6, 0.3, 1.0], np.float32)
    t = np.array([0.0212, 1.0, 50.0], np.float32)
    pp, tt = (a.reshape(1, 1, 4, 3) for a in np.meshgrid(p, t,
                                                         indexing='ij'))
    want = np.asarray(jx.z.log_binomial(jx.jnp.asarray(pp[0, ..., None]),
                                        jx.jnp.asarray(tt[0, ..., None]), K))
    got = tz.log_binomial(torch.from_numpy(pp), torch.from_numpy(tt),
                          K).numpy()
    assert np.isfinite(tz.log_binomial_coef(K)).all()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    """A 4x4-grid state dict of each variant, saved as a checkpoint."""
    d = tmp_path_factory.mktemp('zoe')
    out = {}
    for nk in (False, True):
        path = d / ('ZoeD_NK.pt' if nk else 'ZoeD_N.pt')
        torch.save(random_zoe(nk, 8 + nk).state_dict(), path)
        out[nk] = str(path)
    return out


def _image(seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 9 + c) * np.cos(yy / 7 - c)
                    for c in range(3)], -1)
    img += rng.randn(H, W, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def _pipes(jx, nk, path):
    est = 'zoe_nk' if nk else 'zoe'
    jp = jx.Pipeline(jx.Config(depth_est=est, **CFG), seed=0)
    jp.stage_previews = False
    jp._zoe_net = jax_zoe(jx, nk, (64, 96))
    jp.load_zoe_checkpoint(path)
    tp = TPipeline(TConfig(depth_est=est, **CFG), device='cpu')
    tp.zoe_net = make_zoe(nk, (64, 96))
    tp.load_zoe_checkpoint(path)
    return jp, tp


@pytest.mark.parametrize('nk', [False, True], ids=['zoe', 'zoe_nk'])
def test_generate_state_vs_jax(jx, ckpts, nk, tmp_path, capsys,
                               monkeypatch):
    """generate_state with depth_est 'zoe' / 'zoe_nk' on a 40x72 image
    (a 64x96 grid; the checkpoint's 4x4 tables resized to 4x6 by both
    packages): the disparity within 1e-4 relative of JAX's (measured
    3.9e-7), the depth's reciprocal within 1e-4 relative; then the
    estimate_depth CLI with --zoe-ckpt against the JAX tool's
    depthestim on the same pipeline (the same jitted function)."""
    cv2 = pytest.importorskip('cv2')
    import importlib.util
    from pathlib import Path
    from cartoonsegmentation_torch import estimate_depth
    from cartoonsegmentation_torch.pipeline import kenburns as tkb
    jp, tp = _pipes(jx, nk, ckpts[nk])
    img = _image(nk)
    sj, st = jp.generate_state(img), tp.generate_state(img)
    dj = np.asarray(sj.disparity)
    assert st.disparity.shape == dj.shape == (H, W, 1)
    assert dj.std() > 1e-3 * dj.mean()
    np.testing.assert_allclose(st.disparity.numpy(), dj, rtol=1e-4,
                               atol=1e-4 * np.abs(dj).max())
    np.testing.assert_allclose(1.0 / st.depth.numpy(),
                               1.0 / np.asarray(sj.depth), rtol=1e-4,
                               atol=1e-7)
    assert tp.zoe_net.img_size == (64, 96)

    src = tmp_path / 'pic.png'
    cv2.imwrite(str(src), img)
    orig = tkb.KenBurnsPipeline.__init__

    def init(self, *a, **k):
        orig(self, *a, **k)
        self.zoe_net = make_zoe(nk, (64, 96))
    monkeypatch.setattr(tkb.KenBurnsPipeline, '__init__', init)
    est = 'zoe_nk' if nk else 'zoe'
    estimate_depth.main(['--in', str(src), '--out', str(tmp_path / 'd.npy'),
                         '--depth-est', est, '--zoe-ckpt', ckpts[nk],
                         '--device', 'cpu'])
    assert 'wrote' in capsys.readouterr().out
    depth = np.load(tmp_path / 'd.npy')
    assert depth.shape == (H, W) and depth.dtype == np.float32
    spec = importlib.util.spec_from_file_location(
        'jax_estimate_depth',
        Path(__file__).resolve().parent.parent / 'scripts' /
        'estimate_depth.py')
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    _, want = jtool.depthestim(jp, img)
    np.testing.assert_allclose(1.0 / depth, 1.0 / want, rtol=1e-4,
                               atol=1e-7)


def test_checkpoint_variant_wins(ckpts, caplog):
    """A loaded NK checkpoint decides the variant under depth_est 'zoe',
    with a warning."""
    tp = TPipeline(TConfig(depth_est='zoe', **CFG), device='cpu')
    tp.zoe_net = make_zoe(True, (64, 96))
    tp.load_zoe_checkpoint(ckpts[True])
    assert tp._zoe_ckpt_is_nk
    net = tp._zoe((64, 96), nk=False)
    assert isinstance(net, tz.ZoeDepthNK) and net is tp.zoe_net
    assert "checkpoint's" in caplog.text


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('nk', [False, True], ids=['zoe', 'zoe_nk'])
def test_zoe_card_vs_cpu(cuda, nk):
    """The full-width net at 384x672 (1,008 tokens) as the pipeline makes
    it, f32 on the card (TF32 off) against the CPU: the metric depth
    within 1e-4 relative (a random net's spans ~1% around 0.68), the same
    vote."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = (tz.ZoeDepthNK if nk else tz.ZoeDepth)(img_size=(384, 672))
    x = torch.rand(1, 3, 384, 672, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net.eval()(x)
        got = net.to(cuda)(x.to(cuda))
    md = want['metric_depth']
    err = (got['metric_depth'].cpu() - md).abs().max()
    assert err <= 1e-4 * md.abs().max()
    if nk:
        lg, lw = got['domain_logits'].cpu(), want['domain_logits']
        assert bool(lg.sum(0)[1] > lg.sum(0)[0]) == \
            bool(lw.sum(0)[1] > lw.sum(0)[0])

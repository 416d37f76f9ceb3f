"""The port's nets against the JAX package's: Flax init from a seed,
carried across by ``inpaint_from_flax`` / ``leres_from_flax``, the same
numpy inputs through both, in f32 on the CPU. Also the checkpoint key
names: the port's state_dict goes through the JAX package's own
converters (the published checkpoints' path) and back."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.models import convert as jconvert
from cartoonsegmentation_tpu.models import leres as jleres
from cartoonsegmentation_tpu.models.kenburns import Inpaint as JInpaint
from cartoonsegmentation_torch.models import leres as tleres
from cartoonsegmentation_torch.models.convert import (inpaint_from_flax,
                                                      leres_from_flax)
from cartoonsegmentation_torch.models.kenburns import Inpaint as TInpaint
from torch_cpu import torch_threads  # noqa: F401  (autouse)

LAYERS = (1, 1, 1, 1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _paths(v, prefix + (k,))
        else:
            out.add(prefix + (k,))
    return out


def _randomize(module, seed):
    """Every float tensor of the module from numpy (BN stats included,
    variances positive), so no layer sits at its init identity."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            sd[k] = v
        elif k.endswith('running_var'):
            sd[k] = torch.from_numpy(
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(
                (rng.randn(*v.shape) * 0.1).astype(np.float32))
    module.load_state_dict(sd)
    return module


@pytest.fixture(scope='module')
def inpaint_vars():
    net = JInpaint()
    init = jax.jit(lambda k, a, b, c: net.init(k, a, b, c, 16.0, 40.0))
    return net, init(jax.random.PRNGKey(0), jnp.zeros((32, 32, 3)),
                     jnp.ones((32, 32, 1)), jnp.zeros((3,)))


def test_inpaint_vs_flax(rng, inpaint_vars):
    net, variables = inpaint_vars
    H, W = 32, 48
    img = rng.rand(H, W, 3).astype(np.float32)
    disp = (rng.rand(H, W, 1) * 30 + 5).astype(np.float32)
    disp[10:20, 12:30] = 40.0                  # a step the shift opens
    shift = np.float32([1.5, -0.7, 2.0])
    seg = (rng.rand(H, W, 1) > 0.7).astype(np.float32)
    want = net.apply(variables, jnp.asarray(img), jnp.asarray(disp),
                     jnp.asarray(shift), 16.0, 40.0,
                     segmasks=jnp.asarray(seg))
    port = TInpaint()
    port.load_state_dict(inpaint_from_flax(_np_tree(variables['params'])))
    with torch.no_grad():
        got = port(torch.from_numpy(img), torch.from_numpy(disp),
                   torch.from_numpy(shift), 16.0, 40.0,
                   segmasks=torch.from_numpy(seg))
    assert (np.asarray(want['existing']) == 0).any()
    # the splat's w > 0 mask and the median gate are exact
    np.testing.assert_array_equal(got['existing'].numpy(),
                                  np.asarray(want['existing']))
    # f32 convs and scatter sums in another order: a few ulp of the
    # de-normalised outputs (image in [0, 1], disparity ~ 5-45)
    np.testing.assert_allclose(got['image'].numpy(),
                               np.asarray(want['image']), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got['disparity'].numpy(),
                               np.asarray(want['disparity']), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got['segmasks'].numpy(),
                               np.asarray(want['segmasks']), rtol=0,
                               atol=1e-6)


def test_inpaint_key_names_round_trip(inpaint_vars):
    """Port state_dict → the JAX package's checkpoint converter → Flax
    paths as Flax's own init has them → back, unchanged."""
    _, variables = inpaint_vars
    port = _randomize(TInpaint(), 1)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params = jconvert.convert_inpaint(sd)
    assert _paths(params) == _paths(variables['params'])
    back = inpaint_from_flax(params)
    assert back.keys() == port.state_dict().keys()
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.fixture(scope='module')
def leres_vars():
    net = jleres.LeReS(encoder_layers=LAYERS)
    variables = jax.jit(net.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 64, 64, 3), jnp.float32))
    rng = np.random.RandomState(2)

    def perturb(path, a):
        """BatchNorm statistics off their init (mean 0, var 1)."""
        return (rng.uniform(0.5, 1.5, a.shape) if path[-1].key == 'var'
                else rng.randn(*a.shape) * 0.1).astype(np.float32)
    stats = jax.tree_util.tree_map_with_path(perturb,
                                             variables['batch_stats'])
    return net, {'params': _np_tree(variables['params']),
                 'batch_stats': stats}


def test_leres_vs_flax(rng, leres_vars):
    net, variables = leres_vars
    x = rng.rand(1, 64, 96, 3).astype(np.float32)
    want = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(x)))
    port = tleres.LeReS(LAYERS)
    port.load_state_dict(leres_from_flax(variables, port))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    # f32 convs through a (1,1,1,1) ResNeXt trunk and the FTB/FFM
    # decoder, summed in another order: relative 1e-4 of the range
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(
        tleres.leres_postprocess(torch.tensor(want[0, ..., 0])).numpy(),
        np.asarray(jleres.leres_postprocess(jnp.asarray(want[0, ..., 0]))))


def test_leres_key_names_round_trip(leres_vars):
    """Port state_dict under res101.pth's prefixed names → the JAX
    package's convert_leres → Flax paths as Flax's own init has them →
    back, unchanged (BatchNorm step counters aside)."""
    _, variables = leres_vars
    port = _randomize(tleres.LeReS(LAYERS), 3)
    sd = port.state_dict()
    ckpt = {('module.depth_model.encoder_modules.encoder.' + k[8:]
             if k.startswith('encoder.') else
             'module.depth_model.decoder_modules.' + k[8:]): v.numpy()
            for k, v in sd.items()}
    assert tleres._normalize_leres_keys(ckpt).keys() == \
        jleres._normalize_leres_keys(ckpt).keys() == sd.keys()
    converted = jleres.convert_leres(ckpt)
    assert _paths(converted['params']) == _paths(variables['params'])
    assert _paths(converted['batch_stats']) == \
        _paths(variables['batch_stats'])
    back = leres_from_flax(converted, tleres.LeReS(LAYERS))
    for k, v in sd.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(back[k], v), k


def test_cspnext_backbone_and_neck_vs_flax(rng):
    """The detector's trunk alone (CSPNeXt at deepen 0.33 / widen 0.25,
    then the PAFPN) on an all-negative input, so SPP's max pools must
    pad with -inf as Flax does: f32 convs within 1e-5 of each level's
    range."""
    from cartoonsegmentation_tpu.models.convert_rtmdet import convert_rtmdet
    from cartoonsegmentation_tpu.models.cspnext import CSPNeXt as JCSPNeXt
    from cartoonsegmentation_tpu.models.cspnext import \
        CSPNeXtPAFPN as JPAFPN
    from cartoonsegmentation_torch.models.rtmdet import AnimeDetector
    from test_torch_detector import randomize
    port = randomize(AnimeDetector(0.33, 0.25), 5)
    v = convert_rtmdet({k: t.numpy() for k, t in port.state_dict().items()},
                       0.33, 0.25)
    x = -np.abs(rng.randn(1, 96, 64, 3)).astype(np.float32)

    def sub(name):
        return {c: v[c][name] for c in ('params', 'batch_stats')}
    feats = JCSPNeXt(0.33, 0.25).apply(sub('backbone'), jnp.asarray(x))
    neck = JPAFPN((64, 128, 256), 64, 1).apply(sub('neck'), feats)
    with torch.no_grad():
        tfeats = port.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
        tneck = port.neck(tfeats)
    for got, want in zip(list(tfeats) + list(tneck), list(feats) + list(neck)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=0, atol=1e-5 * np.abs(want).max())

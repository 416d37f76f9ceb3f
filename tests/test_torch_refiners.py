"""The port's animeseg nets against the JAX package's, on the CPU in
f32: ``U2Net`` (full2 and lite2), ``ISNetGTEncoder`` and ``MODNet`` at
64x64, and ``make_refiner``'s names.

Weights are made in the port from numpy (``randomize_nets``), go to Flax
through the JAX package's own converters (``convert_u2net``,
``convert_isnet_gt``, ``convert_modnet``: the published checkpoints'
path) and come back through the port's ``*_from_flax``. The
``AnimeSegRefiner`` masks are held against JAX's in
tests/test_torch_animeseg.py. JAX is imported only where the JAX side
runs, so the card-side tests run where JAX is missing.
"""
import importlib

import numpy as np
import pytest
import torch
from torch import nn

from cartoonsegmentation_torch.models import convert
from cartoonsegmentation_torch.models.modnet import MODNet
from cartoonsegmentation_torch.models.u2net import ISNetGTEncoder, U2Net
from cartoonsegmentation_torch.pipeline import refine as trefine
from torch_cpu import torch_threads  # noqa: F401  (autouse)

S = 64


def randomize_nets(module: nn.Module, seed: int, scale: float = 1.0):
    """Every float tensor from numpy: conv and linear weights at
    scale/sqrt(fan-in), BatchNorm scales and variances in [0.5, 1.5],
    other vectors at 0.1. A module shared under two names (MODNet's
    backbone) is drawn under each: the last name's draw is the one
    loaded."""
    rng = np.random.RandomState(seed)
    bn = {n for n, m in module.named_modules(remove_duplicate=False)
          if isinstance(m, nn.BatchNorm2d)}
    sd = {}
    for k, v in module.state_dict().items():
        owner, attr = k.rsplit('.', 1)
        if not v.is_floating_point():
            a = v.numpy()
        elif owner in bn and attr in ('weight', 'running_var'):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif v.ndim >= 2:
            a = rng.randn(*v.shape) * scale / np.sqrt(v[0].numel())
        else:
            a = rng.randn(*v.shape) * 0.1
        sd[k] = torch.from_numpy(np.asarray(a, v.numpy().dtype))
    module.load_state_dict(sd)
    return module.eval()


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _paths(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        out |= _paths(v, prefix + (k,)) if isinstance(v, dict) \
            else {prefix + (k,)}
    return out


def jax_side(name: str):
    """(Flax module, JAX converter) of a net (the JAX package's
    models/u2net.py and models/modnet.py)."""
    mod = importlib.import_module('cartoonsegmentation_tpu.models.' + (
        'modnet' if name == 'modnet' else 'u2net'))
    if name == 'modnet':
        return mod.MODNet(), mod.convert_modnet
    if name == 'isnet_gt':
        return mod.ISNetGTEncoder(), mod.convert_isnet_gt
    return mod.U2Net(lite=name == 'u2netl'), mod.convert_u2net


# name: (port module, port converter, input channels)
NETS = {
    'u2net': (lambda: U2Net(), convert.u2net_from_flax, 3),
    'u2netl': (lambda: U2Net(lite=True),
               lambda v: convert.u2net_from_flax(v, U2Net(lite=True)), 3),
    'isnet_gt': (ISNetGTEncoder, convert.isnet_gt_from_flax, 1),
    'modnet': (MODNet, convert.modnet_from_flax, 3),
}


@pytest.fixture(scope='module', params=sorted(NETS))
def net(request):
    """(name, port module, Flax module, Flax variables, input, JAX
    outputs) of one net, its JAX forward jitted once."""
    import jax
    import jax.numpy as jnp
    name = request.param
    make, _, cin = NETS[name]
    jnet, jconv = jax_side(name)
    port = randomize_nets(make(), 5)
    variables = jconv(_sd(port))
    x = np.random.RandomState(1).rand(2, S, S, cin).astype(np.float32)
    if name == 'modnet':
        x = x * 2.0 - 1.0
    want = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    return name, port, jnet, variables, x, want


def test_forward_vs_jax(net):
    """Every output the net returns (U²-Net's fused map and six sides,
    the GT encoder's six sides, MODNet's matte), f32 convs summed in
    another order: within 1e-5 of each output's range (measured ≤ 2.4e-6
    of it)."""
    name, port, _, _, x, want = net
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    if name == 'modnet':
        pairs = [(got[2], want[2])]
        assert got[0] is None and got[1] is None
    else:
        pairs = list(zip(got[0], want[0]))
        assert len(pairs) == (7 if name.startswith('u2net') else 6)
    for g, w in pairs:
        w = np.asarray(w)[..., 0]
        assert g.shape == (2, 1, S, S)
        np.testing.assert_allclose(g[:, 0].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_key_names_round_trip(net):
    """The port's state_dict (the reference checkpoint's names, with
    lightning's 'net.' prefix where the JAX converter strips it: not
    ``convert_u2net``) → the JAX converter → the Flax paths of the Flax
    module's own init → the port's ``*_from_flax`` → unchanged."""
    import jax
    import jax.numpy as jnp
    name, port, jnet, variables, x, _ = net
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, S, S, x.shape[-1])))
    pre = '' if name.startswith('u2net') else 'net.'
    prefixed = jax_side(name)[1]({pre + k: v
                                  for k, v in _sd(port).items()})
    for col in ('params', 'batch_stats'):
        # the inference-time Flax MODNet has no semantic or detail head
        assert _paths(shapes[col]) <= _paths(prefixed[col])
    back = NETS[name][1](variables)
    for k, v in port.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(back[k], v), k


def test_modnet_heads_without_flax_keep_the_module():
    """A Flax MODNet tree from its own init (no semantic or detail head)
    loads: those heads keep the port module's values."""
    import jax
    import jax.numpy as jnp
    v = jax.eval_shape(jax_side('modnet')[0].init, jax.random.PRNGKey(0),
                       jnp.zeros((1, S, S, 3)))
    v = jax.tree_util.tree_map(lambda s: np.ones(s.shape, s.dtype), v)
    module = MODNet()
    sd = convert.modnet_from_flax(v, module)
    for k, t in sd.items():
        if '.conv_lr.' in k or '.conv_hr.' in k:
            assert torch.equal(t, module.state_dict()[k]), k
        elif t.is_floating_point() and 'num_batches' not in k:
            assert torch.all(t == 1.0), k


def test_make_refiner_names():
    """Every name the JAX package's ``make_refiner`` takes
    (tests/test_isnet_refine.py's list and the other bare nets) gives
    the same refiner: its class, net and input size; unknown names
    raise ValueError in both."""
    from cartoonsegmentation_tpu.pipeline import refine as jrefine
    names = ('refinenet_isnet', 'animeseg', 'isnet', 'isnet_is',
             'isnet_gt', 'u2net', 'u2netl', 'modnet', 'animeseg:u2netl',
             'animeseg:modnet', 'animeseg:isnet_gt')
    assert trefine.make_refiner('none', device='cpu') is None
    assert jrefine.make_refiner('none') is None
    for name in names:
        for size in (64, 720, 1536):
            j = jrefine.make_refiner(name, refine_size=size)
            t = trefine.make_refiner(name, refine_size=size, device='cpu')
            assert type(t).__name__ == type(j).__name__, name
            if isinstance(t, trefine.AnimeSegRefiner):
                assert (t.net_name, t.input_size, t.seg_thr) == \
                    (j.net_name, j.input_size, j.seg_thr), name
            else:
                assert (t.refine_size, t.mask_thr) == \
                    (j.refine_size, j.mask_thr), name
    for bad in ('nope', 'animeseg:nope'):
        with pytest.raises(ValueError):
            jrefine.make_refiner(bad)
        with pytest.raises(ValueError):
            trefine.make_refiner(bad, device='cpu')

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(NETS))
def test_nets_card_vs_cpu(name, cuda):
    """Each net in f32 on the card (cuDNN, TF32 off) against the same
    weights on the CPU at 1024x1024: within 1e-4 of the output's
    range."""
    dev = cuda
    make, cin = NETS[name][0], NETS[name][2]
    cpu = randomize_nets(make(), 5)
    card = randomize_nets(make(), 5).to(dev)
    x = torch.rand(1, cin, 1024, 1024,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = cpu(x)
        b = card(x.to(dev))
    a, b = (a[2], b[2]) if name == 'modnet' else (a[0][0], b[0][0])
    err = (b.cpu() - a).abs().max().item()
    assert err <= 1e-4 * a.abs().max().item(), err

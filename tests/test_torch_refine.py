"""The port's ISNet refine against the JAX package's, on the CPU in f32:
``ISNetDIS`` (4 input channels, full width) at 64x64 and
``ISNetRefiner`` at refine_size 64.

Weights are made in the port from numpy, go to Flax through the JAX
package's own converter (``convert_isnet``, the published checkpoints'
path) and come back through ``isnet_from_flax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.instances import Instances as JIns
from cartoonsegmentation_tpu.models import isnet as jisnet
from cartoonsegmentation_tpu.pipeline.refine import ISNetRefiner as JRefiner
from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.models.convert import isnet_from_flax
from cartoonsegmentation_torch.models.isnet import ISNetDIS
from cartoonsegmentation_torch.pipeline.refine import (ISNetRefiner,
                                                       make_refiner)
from test_torch_detector import _paths, randomize
from torch_cpu import torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope='module')
def isnet():
    port = randomize(ISNetDIS(in_ch=4), 3)
    with torch.no_grad():
        # prediction logits of O(1), so that the 0.3 threshold cuts
        port.side1.weight *= 10.0
    variables = jisnet.convert_isnet(
        {k: v.numpy() for k, v in port.state_dict().items()})
    return port, variables


def test_isnet_vs_jax(isnet, rng):
    """All six side outputs (an odd size exercises the ceil-mode pools
    and the upsamples to odd sizes): f32 convs summed in another order,
    within 1e-5 of each side's range."""
    port, variables = isnet
    x = rng.rand(2, 45, 64, 4).astype(np.float32)
    want, _ = jax.jit(jisnet.ISNetDIS(in_ch=4).apply)(variables,
                                                      jnp.asarray(x))
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)[..., 0]
        assert g.shape == (2, 1, 45, 64)
        np.testing.assert_allclose(g[:, 0].numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_isnet_key_names_round_trip(isnet):
    """Port state_dict (the reference's conv_s1 / bn_s1 names, with
    lightning's 'net.' prefix) → convert_isnet → the Flax paths of the
    Flax module's own init → isnet_from_flax → unchanged."""
    port, variables = isnet
    shapes = jax.eval_shape(jisnet.ISNetDIS(in_ch=4).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 4)))
    prefixed = jisnet.convert_isnet(
        {'net.' + k: v.numpy() for k, v in port.state_dict().items()})
    assert _paths(prefixed['params']) == _paths(shapes['params'])
    assert _paths(prefixed['batch_stats']) == _paths(shapes['batch_stats'])
    back = isnet_from_flax(variables)
    for k, v in port.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(back[k], v), k


def _instances(rng, H, W, n_valid, capacity):
    yy, xx = np.mgrid[0:H, 0:W]
    masks = np.zeros((n_valid, H, W), bool)
    for n in range(n_valid):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        rx, ry = rng.uniform(10, W / 2), rng.uniform(10, H / 2)
        masks[n] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 < 1
    boxes = np.zeros((n_valid, 4), np.float32)
    return masks, boxes, capacity


def _img(rng, H, W):
    return (rng.rand(H, W, 3) * 255).astype(np.uint8)


def test_isnet_refiner_vs_jax(isnet, rng):
    """refine_size 64 on a 90x120 image (the image and masks shrink with
    antialias, the probabilities grow back with align_corners), chunk 2
    over 5 valid instances of 8 slots: >= 99.9% of mask pixels equal
    (f32 noise can flip a pixel at the 0.3 threshold), the invalid slots
    empty."""
    port, variables = isnet
    H, W = 90, 120
    img = _img(rng, H, W)
    masks, boxes, cap = _instances(rng, H, W, 5, 8)
    jr = JRefiner(refine_size=64, chunk=2, dtype=None)
    jr._variables = variables
    want = np.asarray(jax.device_get(
        jr(JIns.from_numpy(masks, boxes, capacity=cap), img).masks))
    tr = ISNetRefiner(refine_size=64, chunk=2, dtype='float32', device='cpu')
    tr.net = port
    got = tr(TIns.from_numpy(masks, boxes, capacity=cap), img).masks.numpy()
    assert got.shape == want.shape == (cap, H, W)
    assert not got[5:].any()
    assert 0.01 < want[:5].mean() < 0.99
    assert float((got == want).mean()) >= 0.999


def test_isnet_refiner_chunk_independent(isnet, rng):
    """Chunk 1 against chunk 3 (3 + 2 valid instances): every instance's
    mask depends on its own inputs alone, exactly."""
    port, _ = isnet
    H, W = 50, 70
    img = _img(rng, H, W)
    masks, boxes, cap = _instances(rng, H, W, 5, 7)
    ins = TIns.from_numpy(masks, boxes, capacity=cap)
    outs = []
    for chunk in (1, 3):
        r = ISNetRefiner(refine_size=64, chunk=chunk, dtype='float32',
                         device='cpu')
        r.net = port
        outs.append(r(ins, img).masks)
    assert torch.equal(outs[0], outs[1])


def test_make_refiner_names():
    """'none', the ISNet refine, the animeseg refine (its names against
    the JAX package's: tests/test_torch_refiners.py) and an unknown
    name."""
    from cartoonsegmentation_torch.pipeline.refine import AnimeSegRefiner
    assert make_refiner('none', device='cpu') is None
    assert isinstance(make_refiner('refinenet_isnet', 64, device='cpu'),
                      ISNetRefiner)
    assert isinstance(make_refiner('animeseg', device='cpu'),
                      AnimeSegRefiner)
    with pytest.raises(ValueError):
        make_refiner('nope', device='cpu')

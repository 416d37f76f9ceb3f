"""The port's ``AnimeSegRefiner`` (refine_method 'animeseg' and its
nets) against the JAX package's, on the CPU in f32 at input size 64:
the whole-image net's mask intersected with each instance's where it
keeps more than 30% of the area.

One net of each input convention: ISNet-IS (the 'animeseg' default),
U²-Net lite (the fused map), the ISNet GT encoder (the luma) and MODNet
([-1, 1], the matte). Weights from numpy in the port
(``randomize_nets``), into Flax through the JAX package's converters.
JAX is imported only where the JAX side runs, so the card-side test runs
where JAX is missing.
"""
import importlib

import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.models.isnet import ISNetDIS
from cartoonsegmentation_torch.models.modnet import MODNet
from cartoonsegmentation_torch.models.u2net import ISNetGTEncoder, U2Net
from cartoonsegmentation_torch.pipeline.refine import (AnimeSegRefiner,
                                                       get_refine_net)
from test_torch_refiners import randomize_nets
from torch_cpu import torch_threads  # noqa: F401  (autouse)

H, W, CAP = 48, 80, 6
# the port's net and the JAX package's converter (module, function)
NETS = {'isnet_is': (lambda: ISNetDIS(in_ch=3), ('isnet', 'convert_isnet')),
        'u2netl': (lambda: U2Net(lite=True), ('u2net', 'convert_u2net')),
        'isnet_gt': (ISNetGTEncoder, ('u2net', 'convert_isnet_gt')),
        'modnet': (MODNet, ('modnet', 'convert_modnet'))}
# each net's last conv, whose output is the logit of the probability
LAST = {'isnet_is': lambda n: n.side1, 'u2netl': lambda n: n.outconv,
        'isnet_gt': lambda n: n.side1,
        'modnet': lambda n: n.f_branch.conv_f[1].layers[0]}


def _case(seed=3):
    """A BGR image of smooth colour fields and 5 elliptic instances of 6
    slots, two of them large and three small."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = np.stack([128 + 100 * np.sin(xx / 7 + c) * np.cos(yy / 5 - c)
                    for c in range(3)], -1).astype(np.uint8)
    masks = np.zeros((5, H, W), bool)
    for n, r in enumerate((30, 24, 8, 6, 5)):
        cx, cy = rng.uniform(0, W), rng.uniform(0, H)
        masks[n] = ((xx - cx) / r) ** 2 + ((yy - cy) / (0.7 * r)) ** 2 < 1
    return img, masks, np.zeros((5, 4), np.float32)


def edged(name: str, img: np.ndarray, size: int):
    """The seeded net with its last conv moved so that its logits on the
    refiner's input are 4 (logit - median): the 0.5 threshold then cuts
    the frame about in half (a random net's probabilities sit within
    ~0.1 of 0.5, on one side of it over most of the frame)."""
    net = randomize_nets(NETS[name][0](), 7)
    nh, nw = img.shape[0] * size // max(img.shape[:2]), \
        img.shape[1] * size // max(img.shape[:2])
    x = torch.zeros((1, 3, size, size))
    x[0, :, :nh, :nw] = torch.nn.functional.interpolate(
        torch.from_numpy(img[..., ::-1] / np.float32(255)).permute(
            2, 0, 1)[None], size=(nh, nw), mode='bilinear', antialias=True)[0]
    with torch.no_grad():
        p = get_refine_net(name)[1](net, x)[0, :nh, :nw].double()
        m = float(torch.log(p / (1 - p)).median())
        conv = LAST[name](net)
        conv.bias -= m
        conv.weight *= 4.0
        conv.bias *= 4.0
    return net


@pytest.fixture(scope='module', params=sorted(NETS))
def both(request):
    """(JAX masks, port masks, the port refiner, the case) of one net."""
    import jax
    from cartoonsegmentation_tpu.instances import Instances as JIns
    from cartoonsegmentation_tpu.pipeline.refine import \
        AnimeSegRefiner as JRefiner
    name = request.param
    module, fn = NETS[name][1]
    conv = getattr(importlib.import_module(
        'cartoonsegmentation_tpu.models.' + module), fn)
    img, masks, boxes = _case()
    port = edged(name, img, 64)
    jr = JRefiner(64, net_name=name)
    jr._variables = conv({k: v.numpy() for k, v in port.state_dict().items()})
    want = np.asarray(jax.device_get(
        jr(JIns.from_numpy(masks, boxes, capacity=CAP), img).masks))
    tr = AnimeSegRefiner(64, net_name=name, device='cpu')
    tr.net = port
    got = tr(TIns.from_numpy(masks, boxes, capacity=CAP), img).masks.numpy()
    return want, got, tr, (img, masks, boxes)


def test_masks_equal_jax(both):
    """Every instance mask equal to JAX's (the nets' f32 noise, ~1e-6 of
    the logits, flipped no pixel of the 0.5 threshold here); the empty
    slot stays empty; the refine changed at least one instance."""
    want, got, _, (img, masks, _) = both
    assert got.shape == want.shape == (CAP, H, W)
    np.testing.assert_array_equal(got, want)
    assert not got[5:].any()
    assert any(not np.array_equal(got[n], masks[n]) for n in range(5))


def test_area_rule():
    """A whole-image mask of the left 40 columns: an instance keeping
    50% of its area becomes the intersection, one keeping 25% stays as it
    was, an invalid slot stays empty."""
    tr = AnimeSegRefiner(64, net_name='modnet', device='cpu')
    tr.net = torch.nn.Identity()
    tr._run = lambda net, x: torch.where(
        torch.arange(64) < 32, 0.9, 0.1).expand(1, 64, 64)
    masks = np.zeros((3, H, W), bool)
    masks[0, 10:20, 20:60] = True            # half left of column 40
    masks[1, 10:20, 30:70] = True            # a quarter left of it
    masks[2, 30:40, 0:10] = True             # invalid below
    ins = TIns.from_numpy(masks, np.zeros((3, 4), np.float32), capacity=4)
    ins = ins.replace(valid=torch.tensor([True, True, False, False]))
    got = tr(ins, np.zeros((H, W, 3), np.uint8)).masks.numpy()
    left = np.arange(W) < 40
    np.testing.assert_array_equal(got[0], masks[0] & left)
    np.testing.assert_array_equal(got[1], masks[1])
    assert not got[2:].any()


def test_empty_instances_pass_through(both):
    _, _, tr, _ = both
    ins = TIns.empty(CAP, H, W)
    assert tr(ins, np.zeros((H, W, 3), np.uint8)) is ins

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.device import resolve_device
    return resolve_device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('name', sorted(NETS))
def test_refiner_card_vs_cpu(name, cuda):
    """The refiner at 1024 on the card against the CPU on the same
    weights and case: >= 99.9% of mask pixels equal."""
    img, masks, boxes = _case()
    img = np.ascontiguousarray(np.kron(img, np.ones((8, 8, 1), np.uint8)))
    masks = np.kron(masks, np.ones((1, 8, 8), bool))
    outs = []
    for dev in ('cpu', 'cuda'):
        r = AnimeSegRefiner(1024, net_name=name, device=dev)
        r.net = edged(name, img, 1024)
        outs.append(r(TIns.from_numpy(masks, boxes, capacity=CAP),
                      img).masks.cpu().numpy())
    assert float((outs[0] == outs[1]).mean()) >= 0.999

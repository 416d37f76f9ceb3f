"""The port's danbooru tagger on the CPU against the JAX package's:
SwinV2's window attention (kernel K15b runs its plain version here),
the whole SwinV2 with weights carried both ways (the JAX package's
``convert_swinv2`` on the port's timm-keyed state dict, the port's
``swinv2_from_flax`` back), ``Tagger`` with its 'torch' backend on a
checkpoint and tag CSV on disk, and ``AnimeInsSeg.infer_tags`` on
instances.

A small SwinV2 (embed 32, depths (2, 2, 2, 1), window 4) on a 48 x 24
input runs every branch of the block: padding (12 x 6 → 12 x 8), the
shift mask on both axes, a shift on one axis only (6 x 3: the narrow
axis fits one window), windows shrunk to the map (3 x 2), and the
patch merge's odd-size pad.

Tolerances: attention 1e-5, logits and probabilities 1e-4 (f32
through 7 blocks; LayerNorm variance formulas differ), tags equal
apart from probabilities within 1e-4 of the threshold, the weight
round trip exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from cartoonsegmentation_tpu.instances import Instances as JIns
from cartoonsegmentation_tpu.models import swinv2 as jswin
from cartoonsegmentation_tpu.models.tagger import Tagger as JTagger
from cartoonsegmentation_tpu.pipeline.segment import AnimeInsSeg as JSeg
from cartoonsegmentation_torch.instances import Instances as TIns
from cartoonsegmentation_torch.models import swinv2 as tswin
from cartoonsegmentation_torch.models.convert import swinv2_from_flax
from cartoonsegmentation_torch.models.tagger import Tagger as TTagger
from cartoonsegmentation_torch.ops import _cuda
from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg as TSeg
from torch_cpu import torch_threads  # noqa: F401  (autouse)

NCLS, EMBED, DEPTHS, HEADS, WIN = 12, 32, (2, 2, 2, 1), (2, 4, 8, 8), 4
KW = dict(num_classes=NCLS, embed_dim=EMBED, depths=DEPTHS,
          num_heads=HEADS, window=WIN)
SIZE = 48
TOL = 1e-4


def _port_swin(seed=0):
    """The port's small SwinV2 with every parameter random (biases,
    norms and logit scales too; one head's scale above the clamp)."""
    net = tswin.SwinV2(**KW)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith('logit_scale'):
                v = np.log(rng.uniform(5.0, 150.0, p.shape))
            elif name.endswith('weight') and \
                    'norm' in name.split('.')[-2]:
                v = 1.0 + 0.1 * rng.randn(*p.shape)
            else:
                v = 0.1 * rng.randn(*p.shape)
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return net.eval()


@pytest.fixture(scope='module')
def swin():
    net = _port_swin()
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    variables = jswin.convert_swinv2(sd, DEPTHS)
    x = np.random.RandomState(1).uniform(0, 255, (1, 48, 24, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jswin.SwinV2(**KW).apply)(variables, x))
    return dict(net=net, sd=sd, variables=variables, x=x, want=want)


def test_window_attention_vs_jax():
    """K15b's plain version inside the attention module, with the shift
    mask of an 8 x 8 map in 4 x 4 windows and a clamped logit scale."""
    rng = np.random.RandomState(2)
    x = rng.randn(8, 16, 32).astype(np.float32)   # 2 images x 4 windows
    mask = jswin.shift_attn_mask(8, 8, 4, 2)
    mod = jswin.WindowAttentionV2(32, 4, (4, 4))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32), mod.init(jax.random.PRNGKey(0), x, mask))
    v['params']['logit_scale'][0] = np.log(200.0)
    want = np.asarray(mod.apply(v, x, jnp.asarray(mask)))
    p = v['params']
    att = tswin.WindowAttentionV2(32, 4)
    with torch.no_grad():
        for name, val in (('qkv.weight', p['qkv_kernel'].T),
                          ('q_bias', p['q_bias']), ('v_bias', p['v_bias']),
                          ('logit_scale', p['logit_scale']),
                          ('cpb_mlp.0.weight', p['cpb_fc1']['kernel'].T),
                          ('cpb_mlp.0.bias', p['cpb_fc1']['bias']),
                          ('cpb_mlp.2.weight', p['cpb_fc2']['kernel'].T),
                          ('proj.weight', p['proj']['kernel'].T),
                          ('proj.bias', p['proj']['bias'])):
            att.get_parameter(name).copy_(torch.from_numpy(
                np.ascontiguousarray(val)))
    got = att(torch.from_numpy(x), (4, 4), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-5)


def test_swinv2_vs_jax_and_weights_both_ways(swin):
    _cuda.reset_launches()
    with torch.no_grad():
        got = swin['net'](torch.from_numpy(swin['x'])).numpy()
    assert _cuda.LAUNCHES['swinattn'] == 0
    assert got.shape == (1, NCLS)
    np.testing.assert_allclose(got, swin['want'], rtol=0, atol=TOL)
    back = swinv2_from_flax(swin['variables'], tswin.SwinV2(**KW))
    assert back.keys() == swin['sd'].keys()
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), swin['sd'][k], err_msg=k)


def test_timm_key_variants_load(swin):
    """A lightning-style 'model.' prefix, a bare 'head' and timm's
    derived buffers load into the same weights."""
    sd = {f'model.{k}': torch.from_numpy(v) for k, v in swin['sd'].items()}
    sd['model.head.weight'] = sd.pop('model.head.fc.weight')
    sd['model.head.bias'] = sd.pop('model.head.fc.bias')
    sd['model.layers.0.blocks.0.attn.relative_position_index'] = \
        torch.zeros(16, 16)
    net = tswin.SwinV2(**KW)
    tswin.load_swinv2_state_dict(net, {'state_dict': sd})
    for k, v in net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), swin['sd'][k], err_msg=k)


@pytest.fixture(scope='module')
def tagger_dir(swin, tmp_path_factory):
    """model.pth (the port's timm-keyed state dict) with its
    selected_tags.csv: four rating rows (category 9), one character tag
    (category 4), general tags, white/simple_background among them."""
    d = tmp_path_factory.mktemp('tagger')
    torch.save({k: torch.from_numpy(v) for k, v in swin['sd'].items()},
               d / 'model.pth')
    names = ['general', 'sensitive', 'questionable', 'explicit',
             'char0', 'white_background', 'simple_background'] + \
        [f'tag{i}' for i in range(NCLS - 7)]
    cats = [9, 9, 9, 9, 4] + [0] * (NCLS - 5)
    with open(d / 'selected_tags.csv', 'w') as f:
        f.write('tag_id,name,category,count\n')
        for i, (n, c) in enumerate(zip(names, cats)):
            f.write(f'{i},{n},{c},1\n')
    return str(d / 'model.pth')


def _taggers(path, thr):
    kw = dict(general_thr=thr, character_thr=thr, input_size=SIZE,
              swin_kwargs=KW)
    return JTagger(path, backend='flax', **kw), \
        TTagger(path, backend='torch', device='cpu', **kw)


def _near(probs, thr):
    return {i for i, p in enumerate(probs) if abs(p - thr) <= TOL}


def test_tagger_torch_backend_vs_jax(tagger_dir):
    img = (np.random.RandomState(3).rand(40, 24, 3) * 255).astype(np.uint8)
    jt, tt = _taggers(tagger_dir, 0.5)
    assert tt.backend == 'torch' and tt.names == jt.names
    x = jt._prep(img)
    np.testing.assert_array_equal(tt._prep(img), x)
    pj = np.asarray(jt._fwd(jt._variables, x))[0]
    pt = tt.probs(x)[0]
    np.testing.assert_allclose(pt, pj, rtol=0, atol=TOL)
    tags_j, chars_j = jt.label_cv2_bgr(img)
    tags_t, chars_t = tt.label_cv2_bgr(img)
    skip = {tt.names[i] for i in _near(pj, 0.5)}
    assert [t for t in tags_t if t not in skip] == \
        [t for t in tags_j if t not in skip]
    assert [t for t in chars_t if t not in skip] == \
        [t for t in chars_j if t not in skip]
    assert not set(tags_t) & {'general', 'sensitive', 'questionable',
                              'explicit'}


def test_tagger_backends_and_strictness(tagger_dir):
    """'flax' is the 'torch' backend; 'auto' takes it for a checkpoint;
    strict (the default) raises without one; strict=False gives the
    seeded random net, or the stub without a backend."""
    kw = dict(input_size=SIZE, swin_kwargs=KW, device='cpu')
    assert TTagger(tagger_dir, backend='flax', **kw).backend == 'torch'
    assert TTagger(tagger_dir, **kw).backend == 'torch'
    with pytest.raises(RuntimeError, match='strict'):
        TTagger('', backend='torch', **kw)
    with pytest.raises(RuntimeError, match='strict'):
        TTagger('/nonexistent/model.pth', **kw)
    assert TTagger('', strict=False, **kw).backend == 'stub'
    x = np.full((1, SIZE, SIZE, 3), 128.0, np.float32)
    a = TTagger('', backend='torch', strict=False, seed=5, **kw)
    b = TTagger('', backend='torch', strict=False, seed=5, **kw)
    np.testing.assert_array_equal(a.probs(x), b.probs(x))


def test_infer_tags_vs_jax(tagger_dir):
    """White-backed masked crops of the valid instances, one from the
    grey view; background tags dropped, as the JAX version."""
    rng = np.random.RandomState(4)
    img = (rng.rand(64, 80, 3) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:64, 0:80]
    masks = np.stack([(yy - 20) ** 2 + (xx - 25) ** 2 < 150,
                      (yy > 30) & (xx > 40), np.zeros((64, 80), bool)])
    boxes = np.array([[13, 8, 25, 24], [41, 31, 39, 33], [0, 0, 0, 0]],
                     np.float32)
    jseg = JSeg(det_size=64)
    jseg.init_tagger(tagger_dir, backend='flax', general_thr=0.45,
                     character_thr=0.45, input_size=SIZE, swin_kwargs=KW)
    tseg = TSeg(det_size=64, device='cpu')
    tseg.init_tagger(tagger_dir, general_thr=0.45, character_thr=0.45,
                     input_size=SIZE, swin_kwargs=KW)
    assert tseg.tagger.device.type == 'cpu'
    for grey in (False, True):
        want = jseg.infer_tags(JIns.from_numpy(masks, boxes, capacity=4),
                               img, infer_grey=grey)
        got = tseg.infer_tags(TIns.from_numpy(masks, boxes, capacity=4),
                              img, infer_grey=grey)
        assert len(got[0]) == 3
        assert got == want


def test_onnx_tagger_stays_off_the_card(tmp_path):
    """onnxruntime runs the net on the host, so a tagger meant for the
    card refuses a .onnx model (through ``init_tagger`` too) and names
    the timm checkpoint route instead of running it on the CPU."""
    path = tmp_path / 'model.onnx'
    path.write_bytes(b'')
    for backend in ('auto', 'onnx'):
        with pytest.raises(RuntimeError, match='timm checkpoint'):
            TTagger(str(path), backend=backend, device='cuda')
    with pytest.raises(RuntimeError, match='timm checkpoint'):
        TTagger('', backend='onnx', device='cuda')
    seg = TSeg(det_size=64, device='cpu')
    with pytest.raises(RuntimeError, match='timm checkpoint'):
        seg.init_tagger(str(path), device='cuda')
    assert seg.tagger is None

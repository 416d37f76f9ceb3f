"""The port's anime instance detector against the JAX package's, on the
CPU in f32: the RTMDet-Ins nets at det_size 128 with deepen 0.33 /
widen 0.25 (the sizes of tests/test_detector.py), ``postprocess`` with
its two kernels' plain versions (K8 NMS, K9 dynamic mask heads), and
``AnimeInsSeg.infer``.

Weights are made in the port from numpy, go to Flax through the JAX
package's own converter (``convert_rtmdet``, the published
checkpoints' path) and come back through ``rtmdet_from_flax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartoonsegmentation_tpu.models import rtmdet as jrtmdet
from cartoonsegmentation_tpu.models.convert_rtmdet import convert_rtmdet
from cartoonsegmentation_tpu.pipeline.segment import AnimeInsSeg as JSeg
from cartoonsegmentation_torch.models import rtmdet as trtmdet
from cartoonsegmentation_torch.models.convert import rtmdet_from_flax
from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg as TSeg
from test_torch_kernels import _nms_case, _nms_kind

DEEPEN, WIDEN, SIZE = 0.33, 0.25, 128


def _np(a):
    return np.asarray(jax.device_get(a))


def _paths(tree, prefix=()):
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _paths(v, prefix + (k,))
        else:
            out.add(prefix + (k,))
    return out


# gains of the detector's last 1x1 convs: the random trunk's signals
# shrink with depth, so these bring the heads' outputs to O(1)
_HEAD_GAIN = {'rtm_cls': 100.0, 'rtm_reg': 10.0, 'rtm_kernel': 10.0,
              'projection': 10.0}


def randomize(module, seed):
    """Every float tensor from numpy: conv weights at 1/sqrt(fan-in)
    (times _HEAD_GAIN for the detector's prediction convs), BatchNorm
    scales, means and variances off their identity, so the heads give
    spread scores, boxes that overlap and masks with edges."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if not v.is_floating_point():
            a = v.numpy()
        elif v.ndim == 4:
            gain = max([g for n, g in _HEAD_GAIN.items() if n in k] or [1.0])
            a = rng.randn(*v.shape) * gain / np.sqrt(v[0].numel())
        elif k.endswith('running_var') or k.endswith('bn.weight') or \
                k.endswith('bn_s1.weight'):
            a = rng.uniform(0.5, 1.5, v.shape)
        else:
            a = rng.randn(*v.shape) * 0.1
        sd[k] = torch.from_numpy(np.asarray(a, v.numpy().dtype))
    module.load_state_dict(sd)
    return module.eval()


@pytest.fixture(scope='module')
def det():
    """(port net, Flax module, Flax variables, JAX head maps of one
    normalised canvas, that canvas)."""
    port = randomize(trtmdet.AnimeDetector(DEEPEN, WIDEN), 0)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    net = jrtmdet.AnimeDetector(DEEPEN, WIDEN)
    variables = convert_rtmdet(sd, DEEPEN, WIDEN)
    x = np.random.RandomState(1).randn(1, SIZE, SIZE, 3).astype(np.float32)
    heads = jax.tree_util.tree_map(
        np.array, jax.jit(net.apply)(variables, jnp.asarray(x)))
    return port, net, variables, heads, x


def test_detector_nets_vs_jax(det):
    """Backbone, neck, head and mask features: f32 convs summed in
    another order, within 1e-5 of each map's range."""
    port, _, _, heads, x = det
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g_maps, w_maps in zip(got[:3], heads[:3]):
        for g, w in zip(g_maps, w_maps):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(got[3].numpy(), heads[3], rtol=0,
                               atol=1e-5 * np.abs(heads[3]).max())
    # the random heads do give spread scores and boxes
    assert np.ptp(heads[0][0]) > 2.0 and heads[1][0].max() > 8.0


def test_detector_key_names_round_trip(det):
    """Port state_dict (mmdet names) → convert_rtmdet → the Flax paths
    of the Flax module's own init → rtmdet_from_flax → unchanged (the
    shared head convs included, under every level's key)."""
    port, net, variables, _, _ = det
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))
    assert _paths(variables['params']) == _paths(shapes['params'])
    assert _paths(variables['batch_stats']) == _paths(shapes['batch_stats'])
    back = rtmdet_from_flax(variables,
                            trtmdet.AnimeDetector(DEEPEN, WIDEN))
    sd = port.state_dict()
    assert back.keys() == sd.keys()
    assert 'bbox_head.cls_convs.2.1.conv.weight' in sd
    for k, v in sd.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize('K,max_out', [(512, 100), (512, 512), (97, 100)])
def test_nms_plain_vs_jax(rng, K, max_out):
    """K8's plain version: the keep set and its order exactly, with
    ties in the scores and IoUs > 0.6 everywhere."""
    boxes, scores = _nms_case(rng, K)
    assert len(np.unique(scores.numpy())) < K
    got_i, got_m = trtmdet.nms_fixed(boxes, scores, 0.6, max_out)
    want_i, want_m = jax.jit(jrtmdet.nms_fixed, static_argnums=(2, 3))(
        jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy()), 0.6,
        max_out)
    np.testing.assert_array_equal(got_i.numpy(), _np(want_i))
    np.testing.assert_array_equal(got_m.numpy(), _np(want_m))
    assert 0 < int(got_m.sum()) < min(K, max_out) or max_out < K


# (K, max_out) of the signed-score cases: scores with +0, -0, NaNs of
# either sign, -inf, -1 and ties (test_torch_kernels._signed_scores)
SIGNED = [(97, 100), (160, 60), (512, 100)]


@pytest.fixture(scope='module')
def signed_jax():
    """Each signed case's inputs with JAX's nms_fixed keep set and
    lax.top_k order over all K, computed once."""
    rng = np.random.RandomState(11)
    nms = jax.jit(jrtmdet.nms_fixed, static_argnums=(2, 3))
    cases = []
    for K, max_out in SIGNED:
        boxes, scores = _nms_kind(rng, K, 'signed')
        b, s = jnp.asarray(boxes.numpy()), jnp.asarray(scores.numpy())
        ji, jm = nms(b, s, 0.6, max_out)
        cases.append((boxes, scores, max_out, _np(ji), _np(jm),
                      _np(jax.lax.top_k(s, K)[1])))
    return cases


@pytest.mark.parametrize('i', range(len(SIGNED)),
                         ids=[f'{K}-{m}' for K, m in SIGNED])
def test_nms_plain_vs_jax_signed_scores(signed_jax, i):
    """K8's plain version orders +-0.0 and NaN scores as jnp.argsort
    does (canonicalised): the keep set and its order exactly."""
    boxes, scores, max_out, want_i, want_m, _ = signed_jax[i]
    got_i, got_m = trtmdet.nms_fixed(boxes, scores, 0.6, max_out)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    assert 0 < int(got_m.sum())


@pytest.mark.parametrize('i', range(len(SIGNED)),
                         ids=[f'{K}-{m}' for K, m in SIGNED])
def test_top_k_vs_lax_signed_scores(signed_jax, i):
    """postprocess's pre-NMS top-k and Mask R-CNN's _top_k keep
    lax.top_k's order, which does not canonicalise (+0 before -0, a NaN
    by its sign), on the scores where it differs from jnp.argsort's."""
    from cartoonsegmentation_torch.models import maskrcnn as tmaskrcnn
    _, scores, _, _, _, want = signed_jax[i]
    K = len(want)
    np.testing.assert_array_equal(trtmdet._top_k_order(scores)[:K].numpy(),
                                  want)
    np.testing.assert_array_equal(tmaskrcnn._top_k(scores, K).numpy(), want)
    assert not np.array_equal(trtmdet._stable_argsort_desc(scores).numpy(),
                              want)


def test_dynamic_mask_heads_vs_jax(rng):
    """K9's logits: the 10 → 8 → 8 → 1 sums in input order against
    XLA's einsum, within 1e-5 of their range."""
    N, h, w = 7, 16, 16
    feat = rng.randn(h, w, 8).astype(np.float32)
    kern = rng.randn(N, 169).astype(np.float32)
    priors = (rng.randint(0, 16, (N, 2)) * 8).astype(np.float32)
    strides = rng.choice([8.0, 16.0, 32.0], N).astype(np.float32)
    got = trtmdet.dynamic_mask_heads(*map(torch.from_numpy,
                                          (feat, kern, priors, strides)))
    want = _np(jrtmdet.dynamic_mask_heads(*map(jnp.asarray,
                                               (feat, kern, priors,
                                                strides))))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_postprocess_vs_jax(det):
    """The same head maps through both postprocesses at the detector's
    settings (score 0, mask 0.3, top 512, 100 detections): the NMS keep
    set, boxes and validity exactly, scores to a few ulp (XLA's
    logistic against torch's sigmoid), and >= 99.9% of mask pixels (the dynamic heads sum in another order
    than XLA's einsum, so a pixel within an ulp of 0.3 may flip)."""
    heads = det[3]
    kw = dict(score_thr=0.0, mask_thr=0.3, pre_topk=512, max_det=100,
              input_h=SIZE, input_w=SIZE)
    want = jax.device_get(jrtmdet.postprocess(
        *jax.tree_util.tree_map(jnp.asarray, heads), **kw))
    got = trtmdet.postprocess(*jax.tree_util.tree_map(torch.from_numpy,
                                                      heads), **kw)
    valid = np.asarray(want['valid'])
    assert valid.any()
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['bboxes'].numpy(), want['bboxes'])
    np.testing.assert_allclose(got['scores'].numpy(), want['scores'],
                               rtol=0, atol=1e-6)
    same = float((got['masks'].numpy() == want['masks']).mean())
    assert same >= 0.999, same
    m = np.asarray(want['masks'])[valid]
    assert 0.01 < m.mean() < 0.99


def _image(h, w, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 13) * np.cos(yy / 9),
                    128 + 90 * np.cos(xx / 7 + 1) * np.sin(yy / 11),
                    128 + 90 * np.sin((xx + yy) / 17)], -1)
    img[h // 4:h // 2, w // 3:w // 2] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize('hw', [(100, 150), (300, 200)])
def test_anime_insseg_infer_vs_jax(det, hw):
    """infer() from a BGR image: the letterbox (cv2.resize in the JAX
    package, the port's byte-exact resize_linear_u8), the forward, the
    postprocess and the un-letterbox of masks and boxes — the second
    image shrinks to det_size, the first grows. Validity and boxes
    exactly, masks >= 99.9%."""
    port, net, variables, _, _ = det
    img = _image(*hw)
    js = JSeg(det_size=SIZE, max_instances=100, dtype=None)
    js.model, js._variables = net, variables
    ts = TSeg(det_size=SIZE, max_instances=100, dtype='float32',
              device='cpu', deepen=DEEPEN, widen=WIDEN)
    ts.model = port
    want = jax.device_get(js.infer(img, 0.3))
    got = ts.infer(img, 0.3)
    assert got.masks.shape == (100,) + hw
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    assert want.valid.any()
    np.testing.assert_array_equal(got.bboxes.numpy(), want.bboxes)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=0,
                               atol=1e-6)
    assert float((got.masks.numpy() == want.masks).mean()) >= 0.999


def test_load_torch_checkpoint_takes_an_mmdet_state_dict(det, tmp_path):
    """A lightning-style checkpoint ('state_dict' with 'model.'-prefixed
    mmdet keys, beside other entries) loads into AnimeInsSeg unchanged."""
    port = det[0]
    sd = {'model.' + k: v for k, v in port.state_dict().items()}
    sd['model.data_preprocessor.mean'] = torch.zeros(3)
    path = tmp_path / 'rtmdet.ckpt'
    torch.save({'state_dict': sd, 'meta': {'epoch': 60}}, path)
    seg = TSeg(det_size=SIZE, device='cpu', deepen=DEEPEN, widen=WIDEN)
    seg.load_torch_checkpoint(str(path))
    for k, v in port.state_dict().items():
        assert torch.equal(seg.model.state_dict()[k], v), k

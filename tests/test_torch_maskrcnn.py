"""The port's Mask R-CNN (models/maskrcnn.py, pipeline/maskrcnn_det.py)
against the JAX package's, on the CPU in f32.

One port net at small capacities (pre_nms_top 100, post_nms_top 50,
box_candidates 256, max_det 10) with weights from numpy, carried to
Flax by the JAX package's own ``convert_maskrcnn`` (and back by
``maskrcnn_from_flax``). One class's ``cls_score`` bias is raised on
both sides so that detections pass the 0.05 box threshold: random
weights give every class a softmax near 1/91.

Tolerances (the JAX package's own on the same parts,
tests/test_maskrcnn.py): backbone, FPN and RPN head 2e-4; box and mask
heads 1e-3 relative / 2e-3 absolute; RoIAlign 1e-4 relative / 1e-5
absolute; boxes 5e-3 px. Exact: the anchors, the NMS keep sets (-inf
scores, ties, category offsets, K > 512), the labels and the validity.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cartoonsegmentation_tpu.models import maskrcnn as JM
from cartoonsegmentation_tpu.pipeline import maskrcnn_det as jdet
from cartoonsegmentation_torch.models import maskrcnn as TM
from cartoonsegmentation_torch.models.convert import maskrcnn_from_flax
from cartoonsegmentation_torch.pipeline import maskrcnn_det as tdet
from torch_cpu import torch_threads  # noqa: F401  (autouse)

SMALL = dict(pre_nms_top=100, post_nms_top=50, box_candidates=256,
             max_det=10)
EDGED_CLASS = 5


def randomize(module, seed):
    """Every float tensor from numpy: weights at 1/sqrt(fan-in), biases
    at 0.1, frozen-BN scales and variances in [0.5, 1.5]."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith('running_var') or (k.endswith('weight') and
                                         v.ndim == 1):
            a = rng.uniform(0.5, 1.5, v.shape)
        elif v.ndim >= 2:
            fan = v.shape[0] if 'conv5_mask' in k else v[0].numel()
            a = rng.randn(*v.shape) / np.sqrt(fan)
        else:
            a = rng.randn(*v.shape) * 0.1
        sd[k] = torch.from_numpy(a.astype(np.float32))
    module.load_state_dict(sd)
    return module.eval()


def edged_net(seed=3, **kw):
    net = randomize(TM.MaskRCNN(**{**SMALL, **kw}), seed)
    with torch.no_grad():
        net.roi_heads.box_predictor.cls_score.bias[EDGED_CLASS] += 4.0
    return net


def _np(a):
    return np.asarray(jax.device_get(a))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope='module')
def pair():
    net = edged_net()
    variables = JM.convert_maskrcnn(net.state_dict())
    x = (np.random.RandomState(0).randn(1, 64, 64, 3) * 0.4
         ).astype(np.float32)
    jm = JM.MaskRCNN(**SMALL)
    jfeats = jax.jit(lambda v, a: jm.apply(v, a, method=lambda m, y:
                                           m.features(y)))(variables,
                                                           jnp.asarray(x))
    return dict(net=net, variables=variables, x=x, jm=jm, jfeats=jfeats)


def test_converter_round_trip_and_key_nestings(pair):
    """maskrcnn_from_flax inverts convert_maskrcnn exactly, and the
    loader takes torchvision's newer Conv2dNormActivation nesting."""
    import re
    net = pair['net']
    sd = maskrcnn_from_flax(pair['variables'], TM.MaskRCNN())
    assert sd.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v), k
    newer = {}
    for k, v in net.state_dict().items():
        k = re.sub(r'(fpn\.(?:inner|layer)_blocks\.\d+)\.', r'\1.0.', k)
        k = k.replace('rpn.head.conv.', 'rpn.head.conv.0.0.')
        k = re.sub(r'mask_head\.mask_fcn(\d)\.',
                   lambda m: f'mask_head.{int(m.group(1)) - 1}.0.', k)
        newer[k] = v
    assert 'roi_heads.mask_head.3.0.weight' in newer
    other = TM.MaskRCNN()
    TM.load_maskrcnn_state_dict(other, newer)
    for k, v in net.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k


def test_backbone_fpn_and_rpn_head(pair):
    net, jm, variables = pair['net'], pair['jm'], pair['variables']
    with torch.no_grad():
        tf = net.features(_nchw(pair['x']))
        touts = net.rpn.head(tf)
    jouts = jax.jit(lambda v, f: jm.apply(v, f, method=lambda m, y:
                                          m.rpn_head(y)))(variables,
                                                          pair['jfeats'])
    assert len(tf) == len(pair['jfeats']) == 5
    for a, b in zip(pair['jfeats'], tf):
        np.testing.assert_allclose(_np(a), b.permute(0, 2, 3, 1).numpy(),
                                   rtol=2e-4, atol=2e-4)
    for (jc, jr), (tc, tr) in zip(jouts, touts):
        for a, b in ((jc, tc), (jr, tr)):
            np.testing.assert_allclose(_np(a), b.permute(0, 2, 3, 1).numpy(),
                                       rtol=2e-4, atol=2e-4)


def test_box_and_mask_heads(pair, rng):
    net, jm, variables = pair['net'], pair['jm'], pair['variables']
    roi7 = rng.randn(5, 7, 7, 256).astype(np.float32) * 0.3
    roi14 = rng.randn(5, 14, 14, 256).astype(np.float32) * 0.3
    with torch.no_grad():
        tc, tr = net.box_outputs(_nchw(roi7))
        tm = net.mask_outputs(_nchw(roi14))
    jc, jr = jm.apply(variables, jnp.asarray(roi7),
                      method=lambda m, r: m.box_head(r))
    jmask = jm.apply(variables, jnp.asarray(roi14),
                     method=lambda m, r: m.mask_head(r))
    for a, b in ((jc, tc), (jr, tr)):
        np.testing.assert_allclose(_np(a), b.numpy(), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(_np(jmask), tm.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-3, atol=2e-3)


def test_roi_align_pyramid(rng):
    """All four levels, out-of-bounds samples, the bottom-edge band and
    a box below the minimum RoI size."""
    feats = [rng.randn(64 // s, 96 // s, 8).astype(np.float32)
             for s in JM.FPN_STRIDES[:4]]
    boxes = np.array([[5., 4., 60., 50.], [0., 0., 250., 180.],
                      [-10., -10., 500., 400.], [2., 2., 3.5, 3.5],
                      [80., 40., 700., 600.], [60., 30., 96., 64.],
                      [0., 0., 300., 300.]], np.float32)
    want = _np(JM.roi_align_pyramid([jnp.asarray(f) for f in feats],
                                    jnp.asarray(boxes), out=7))
    pyr = TM.flatten_pyramid([torch.from_numpy(f).permute(2, 0, 1)[None]
                              for f in feats])
    got = TM.roi_align_pyramid(pyr, torch.from_numpy(boxes), 7)
    assert sorted(set(TM.roi_levels(torch.from_numpy(boxes)).tolist())) == \
        [0, 1, 2, 3]
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def test_anchors_and_box_coder(rng):
    for a, b in zip(JM.cell_anchors(), TM.cell_anchors()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        JM.level_anchors(5, 7, 16, JM.cell_anchors()[2]),
        TM.level_anchors(5, 7, 16, TM.cell_anchors()[2]))
    anchors = np.abs(rng.randn(30, 2)) * 50
    anchors = np.concatenate([anchors, anchors + 20 + np.abs(
        rng.randn(30, 2)) * 80], 1).astype(np.float32)
    deltas = (rng.randn(30, 4) * 0.5).astype(np.float32)
    deltas[:3, 2:] = 10.0                        # the clamp
    for w in ((1., 1., 1., 1.), (10., 10., 5., 5.)):
        want = _np(JM.clip_boxes(JM.decode_boxes(
            jnp.asarray(anchors), jnp.asarray(deltas), w), 90.0, 120.0))
        got = TM.clip_boxes(TM.decode_boxes(
            torch.from_numpy(anchors), torch.from_numpy(deltas), w),
            90.0, 120.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-3)


@pytest.mark.parametrize('K,thr,max_out,n_cats', [
    (600, 0.7, 200, 5), (300, 0.5, 40, 20)])
def test_batched_nms_keep_sets(rng, K, thr, max_out, n_cats):
    """Clusters of overlapping boxes, duplicates, tied (bf16-valued) and
    -inf scores, category offsets: every slot equal to the JAX one's."""
    centres = rng.uniform(0, 200, (K // 8 + 1, 2))
    c = centres[rng.randint(0, len(centres), K)] + rng.randn(K, 2) * 3
    wh = rng.uniform(10, 40, (K, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    boxes[K // 2:K // 2 + 5] = boxes[K // 2]
    scores = torch.from_numpy(rng.rand(K).astype(np.float32)).bfloat16()
    scores = scores.float().numpy()
    scores[rng.rand(K) < 0.2] = -np.inf
    cats = rng.randint(0, n_cats, K).astype(np.int32)
    ji, jmask = JM.batched_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                     jnp.asarray(cats), thr, max_out)
    ti, tmask = TM.batched_nms_fixed(torch.from_numpy(boxes),
                                     torch.from_numpy(scores),
                                     torch.from_numpy(cats), thr, max_out)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_array_equal(tmask.numpy(), _np(jmask))
    assert tmask.any()


def test_full_model(pair):
    """Image → detections on a 56x60 image in a 64x64 canvas: the same
    valid slots (at least 5) and labels, boxes within 5e-3 px, scores
    and mask logits within the heads' tolerance."""
    net, jm, variables = pair['net'], pair['jm'], pair['variables']
    hw = (56, 60)
    jout = jax.jit(jm.apply)(variables, jnp.asarray(pair['x']),
                             jnp.asarray(hw, jnp.float32))
    with torch.no_grad():
        tout = net(_nchw(pair['x']), hw)
    v = _np(jout['valid'])
    assert v.sum() >= 5
    np.testing.assert_array_equal(tout['valid'].numpy(), v)
    np.testing.assert_array_equal(tout['labels'].numpy()[v],
                                  _np(jout['labels'])[v])
    np.testing.assert_allclose(tout['boxes'].numpy()[v], _np(jout['boxes'])[v],
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(tout['scores'].numpy(), _np(jout['scores']),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tout['masks'].numpy()[v], _np(jout['masks'])[v],
                               rtol=1e-3, atol=2e-3)


def test_paste_and_normalize(rng):
    """The paste's f32 bilinear against cv2's (the JAX version's), boxes
    inside and across the border; the expand's int64 truncation; the
    normalised canvas with its zero band and (R, B, G) quirk."""
    logits = (rng.randn(4, 28, 28) * 3).astype(np.float32)
    boxes = np.array([[10.7, 6.3, 30.7, 22.3], [-10., -10., 15., 15.],
                      [3., 4., 90., 70.], [20., 30., 33.4, 43.4]], np.float32)
    want = JM.paste_masks(logits, boxes, 60, 80)
    got = TM.paste_masks(torch.from_numpy(logits), boxes, 60, 80).numpy()
    assert want.any() and float((got == want).mean()) >= 0.999
    np.testing.assert_array_equal(TM.expand_boxes(boxes, 28),
                                  JM.expand_boxes(boxes, 28))
    canvas = np.zeros((32, 64, 3), np.uint8)
    canvas[:20, :40] = (rng.rand(20, 40, 3) * 255).astype(np.uint8)
    want = _np(jdet.normalize_pad(jnp.asarray(canvas),
                                  jnp.asarray([20, 40], np.float32)))
    got = tdet.normalize_pad(torch.from_numpy(canvas), (20, 40)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[20:] == 0).all() and (got[:, 40:] == 0).all()


def _image(rng, h=80, w=100):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 11), 128 + 90 * np.cos(yy / 7),
                    128 + 60 * np.sin((xx + yy) / 9)], -1)
    img[20:50, 30:70] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def small_detectors(capacity=6, seed=3):
    """A port and a JAX MaskRCNNDetector on the same edged weights at
    min-side 64 / max-side 96."""
    net = edged_net(seed, max_det=8)
    kw = dict(capacity=capacity, min_size=64, max_size=96)
    t = tdet.MaskRCNNDetector(model=net, device='cpu', **kw)
    j = jdet.MaskRCNNDetector(model=JM.MaskRCNN(**{**SMALL, 'max_det': 8}),
                              **kw)
    j._variables = JM.convert_maskrcnn(net.state_dict())
    return t, j


def test_detector_infer(rng):
    """MaskRCNNDetector.infer on an 80x100 image (a 64x96 canvas): the
    same valid slots (at least 5 of 6) and scores, xywh boxes within
    one pixel of rounding, masks >= 99.9% equal; the detector timer
    records its stages."""
    t, j = small_detectors()
    img = _image(rng)
    ti = t.infer(img, pred_score_thr=0.1)
    ji = j.infer(img, pred_score_thr=0.1)
    valid = _np(ji.valid)
    assert valid.sum() >= 5 and ti.masks.shape == (6, 80, 100)
    np.testing.assert_array_equal(ti.valid.numpy(), valid)
    np.testing.assert_allclose(ti.scores.numpy(), _np(ji.scores), rtol=1e-3,
                               atol=1e-4)
    assert np.abs(ti.bboxes.numpy() - _np(ji.bboxes)).max() <= 1.0
    assert float((ti.masks.numpy() == _np(ji.masks)).mean()) >= 0.999
    assert not ti.masks.numpy()[~valid].any()
    assert {'detector_forward', 'detector_paste'} <= set(t.timer.seconds)

"""The rest of the port's segmentation API against the JAX package's, on
the CPU in f32: ``AnimeInsSeg.infer_batch``, ``infer_embeddings``,
``segment_with_bboxes`` and ``load_variables``, with the detector of
tests/test_torch_detector.py (RTMDet-Ins at det_size 128, deepen 0.33 /
widen 0.25, its weights made in the port and carried to Flax by the
JAX package's converter). K8 and K9 run their plain versions here;
the ``gpu`` test holds K9's probabilities at Q boxes against the plain
version on the card.

Tolerances: validity, the chosen candidates and the rounded boxes
exactly; scores within 1e-6; embedding values within 1e-5 of each
array's range; mask pixels >= 99.9% equal.

JAX is imported inside the CPU fixtures and tests only, so that the
``gpu`` test runs on a machine without it.
"""
import numpy as np
import pytest
import torch

from cartoonsegmentation_torch.models import rtmdet as trtmdet
from cartoonsegmentation_torch.models.convert import rtmdet_from_flax
from cartoonsegmentation_torch.pipeline.segment import AnimeInsSeg as TSeg
from torch_cpu import torch_threads  # noqa: F401  (autouse)

DEEPEN, WIDEN, SIZE = 0.33, 0.25, 128
# one image smaller than det_size (its crop shrinks back to it), one
# larger, one square at det_size
SHAPES = ((60, 90), (300, 200), (128, 128))


def _image(h, w, seed=0):
    """tests/test_torch_detector.py's image: smooth bands and a box."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack([128 + 90 * np.sin(xx / 13) * np.cos(yy / 9),
                    128 + 90 * np.cos(xx / 7 + 1) * np.sin(yy / 11),
                    128 + 90 * np.sin((xx + yy) / 17)], -1)
    img[h // 4:h // 2, w // 3:w // 2] = rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _np(a):
    import jax
    return np.asarray(jax.device_get(a))


@pytest.fixture(scope='module')
def segs():
    from cartoonsegmentation_tpu.models import rtmdet as jrtmdet
    from cartoonsegmentation_tpu.models.convert_rtmdet import convert_rtmdet
    from cartoonsegmentation_tpu.pipeline.segment import AnimeInsSeg as JSeg
    from test_torch_detector import randomize
    port = randomize(trtmdet.AnimeDetector(DEEPEN, WIDEN), 0)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    js = JSeg(det_size=SIZE, max_instances=20, dtype=None)
    js.model = jrtmdet.AnimeDetector(DEEPEN, WIDEN)
    js._variables = convert_rtmdet(sd, DEEPEN, WIDEN)
    ts = TSeg(det_size=SIZE, max_instances=20, dtype='float32',
              device='cpu', deepen=DEEPEN, widen=WIDEN)
    ts.model = port
    return js, ts


def _same_instances(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), _np(want.valid))
    np.testing.assert_array_equal(got.bboxes.numpy(), _np(want.bboxes))
    np.testing.assert_allclose(got.scores.numpy(), _np(want.scores), rtol=0,
                               atol=1e-6)
    assert got.masks.shape == _np(want.masks).shape
    assert float((got.masks.numpy() == _np(want.masks)).mean()) >= 0.999


def test_infer_batch_vs_jax(segs):
    """Three images of different sizes in one batched forward, each
    postprocessed and rescaled to its own size."""
    js, ts = segs
    imgs = [_image(h, w, seed=i) for i, (h, w) in enumerate(SHAPES)]
    want = js.infer_batch(imgs, 0.3)
    got = ts.infer_batch(imgs, 0.3)
    assert len(got) == len(imgs)
    for g, w, im in zip(got, want, imgs):
        assert g.masks.shape[1:] == im.shape[:2]
        _same_instances(g, w)
    assert any(bool(g.valid.any()) for g in got)
    with pytest.raises(NotImplementedError, match='mesh'):
        ts.infer_batch(imgs, 0.3, mesh=object())
    assert ts.infer_batch([]) == []


def _keys(emb):
    """Each candidate by its prior and stride."""
    return [tuple(p) + (st,) for p, st in zip(_np(emb['priors']).tolist(),
                                             _np(emb['strides']).tolist())]


def test_infer_embeddings_vs_jax(segs):
    """The top 512 candidates (all 336 at det_size 128), each
    candidate's values within 1e-5 of each array's range. The port's
    convs sum in another order than XLA's (and than themselves at
    another thread count), so two candidates whose scores lie within
    1e-5 of the range may come in either order: the candidate at each
    position whose score is farther than that from both neighbours' is
    JAX's, and JAX's order read in the port's scores descends up to
    that tolerance."""
    js, ts = segs
    img = _image(*SHAPES[1])
    want, _, wscale, wnn = js.infer_embeddings(img)
    got, gimg, gscale, gnn = ts.infer_embeddings(img)
    assert gimg is img and gscale == wscale and gnn == wnn
    assert set(got) == set(want)
    assert got['scores'].shape == (336,)
    wk, gk = _keys(want), _keys(got)
    assert sorted(gk) == sorted(wk) and len(set(wk)) == len(wk)
    pos = {k: i for i, k in enumerate(gk)}
    perm = np.array([pos[k] for k in wk])        # the port's row of each
    for k in ('scores', 'bboxes', 'kernels'):
        w = _np(want[k])
        np.testing.assert_allclose(got[k].numpy()[perm], w, rtol=0,
                                   atol=1e-5 * np.ptp(w))
    w = _np(want['mask_feat'])
    np.testing.assert_allclose(got['mask_feat'].numpy(), w, rtol=0,
                               atol=1e-5 * np.ptp(w))
    ws = _np(want['scores'])
    tol = 1e-5 * np.ptp(ws)
    apart = np.ones(len(ws), bool)
    apart[:-1] &= ws[:-1] - ws[1:] > tol
    apart[1:] &= ws[:-1] - ws[1:] > tol
    assert apart.any()
    assert all(gk[i] == wk[i] for i in np.flatnonzero(apart))
    s = got['scores'].numpy()
    assert np.all(s[:-1] >= s[1:])
    assert np.all(s[perm][:-1] >= s[perm][1:] - tol)


@pytest.mark.parametrize('hw', SHAPES[:2])
def test_segment_with_bboxes_vs_jax(segs, hw):
    """Boxes around the detector's own instances, a box that overlaps
    none (invalid under min_iou) and one on the image's edge; the
    smaller image's crop shrinks back to it (the antialiased resize)."""
    js, ts = segs
    h, w = hw
    img = _image(h, w, seed=3)
    ins = ts.infer(img, 0.0)
    xywh = ins.bboxes.numpy()[ins.valid.numpy()][:3]
    boxes = np.concatenate([
        np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], 1),
        [[-500.0, -500.0, -400.0, -400.0], [0.0, 0.0, w / 2, h]]]).astype(
            np.float32)
    want = js.segment_with_bboxes(img, boxes)
    got = ts.segment_with_bboxes(img, boxes)
    assert got.masks.shape == (len(boxes), h, w)
    _same_instances(got, want)
    assert not bool(got.valid[len(xywh)])
    assert bool(got.valid.any())


def test_load_variables_vs_jax(segs):
    """JAX variables of a Flax detector drawn from a seed, installed in
    both packages (the port's through rtmdet_from_flax): the same
    instances. A strict load: a missing key raises. The fixture's
    detectors get their weights back after."""
    import jax
    js, ts = segs
    variables = jax.jit(js.model.init)(
        jax.random.PRNGKey(7), np.zeros((1, SIZE, SIZE, 3), np.float32))
    sd = rtmdet_from_flax(jax.tree_util.tree_map(np.asarray, variables),
                          trtmdet.AnimeDetector(DEEPEN, WIDEN))
    kept = js._variables, ts.model
    try:
        js.load_variables(variables)
        ts.load_variables(sd)
        for k, v in sd.items():
            assert torch.equal(ts.model.state_dict()[k], v), k
        img = _image(*SHAPES[1])
        _same_instances(ts.infer(img, 0.0), js.infer(img, 0.0))
        with pytest.raises(RuntimeError, match='Missing'):
            ts.load_variables({k: v for k, v in sd.items()
                               if not k.startswith('neck.')})
    finally:
        js._variables, ts.model = kept


@pytest.mark.gpu
def test_segment_with_bboxes_k9_on_card():
    """K9's probabilities at Q = 5 candidates on the card against its
    plain version within 1e-5; segment_with_bboxes launches it once,
    its masks against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from cartoonsegmentation_torch.ops import _cuda
    ts = TSeg(det_size=SIZE, max_instances=20, dtype='float32',
              device='cpu', deepen=DEEPEN, widen=WIDEN)
    img = _image(300, 200, seed=3)
    emb, _, _, _ = ts.infer_embeddings(img)
    dev = torch.device('cuda')
    idx = torch.arange(5)
    args = [emb['mask_feat'], emb['kernels'][idx], emb['priors'][idx],
            emb['strides'][idx]]
    _, want = trtmdet.dynamic_masks_plain(*args, torch.zeros(5, dtype=bool),
                                          SIZE, SIZE, 0.3)
    _, got = trtmdet.dynamic_masks(*[a.to(dev) for a in args],
                                   torch.zeros(5, dtype=bool, device=dev),
                                   SIZE, SIZE, 0.3)
    assert float((got.cpu() - want).abs().max()) <= 1e-5
    cs = TSeg(det_size=SIZE, max_instances=20, dtype='float32',
              device='cuda', deepen=DEEPEN, widen=WIDEN)
    cs.model = ts._net()
    boxes = emb['bboxes'][idx].numpy() / (SIZE / 300)
    before = _cuda.LAUNCHES['maskhead']
    got = cs.segment_with_bboxes(img, boxes)
    assert _cuda.LAUNCHES['maskhead'] == before + 1
    want = ts.segment_with_bboxes(img, boxes)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert float((got.masks.cpu() == want.masks).float().mean()) >= 0.999

"""The port's COCO metric (cartoonsegmentation_torch/data/metrics.py)
against the JAX package's on random predictions: ``coco_map`` (bbox and
segm, every max_dets and area range), ``coco_summary`` and
``AnimeMangaMetric``, with crowd gts, tied scores, empty images and gts
outside an area range (ignored): equal results, number for number (NaN
where JAX has NaN)."""
import numpy as np
import pytest

from cartoonsegmentation_tpu.data import metrics as jm
from cartoonsegmentation_torch.data import metrics as tm
from torch_cpu import torch_threads  # noqa: F401  (autouse)

S = 48


def _box_mask(box):
    x, y, w, h = (int(round(v)) for v in box)
    m = np.zeros((S, S), bool)
    m[y:y + h, x:x + w] = True
    return m


def _images(seed, n=5, crowd=True, ties=True):
    """Per-image (prediction, gt) dicts: gts of several sizes (small,
    medium, large areas at S x S scaled by 'areas'), detections near the
    gts and false positives, some scores tied; image 2 has no gt, image
    3 no detection."""
    rng = np.random.RandomState(seed)
    preds, gts = [], []
    for i in range(n):
        ng = 0 if i == 2 else rng.randint(1, 5)
        gb = np.stack([rng.uniform(0, S / 2, ng), rng.uniform(0, S / 2, ng),
                       rng.uniform(4, S / 2, ng), rng.uniform(4, S / 2, ng)],
                      -1) if ng else np.zeros((0, 4))
        gt = {'bboxes': gb, 'masks': [_box_mask(b) for b in gb],
              'areas': rng.choice([500.0, 4000.0, 20000.0], ng)}
        if crowd and ng > 1:
            gt['iscrowd'] = np.arange(ng) == 0
        nd = 0 if i == 3 else rng.randint(1, 8)
        base = gb[rng.randint(0, ng, nd)] if ng else \
            np.full((nd, 4), 10.0)
        db = base + rng.randn(nd, 4) * 2.0
        db[:, 2:] = np.abs(db[:, 2:]) + 1.0
        scores = rng.rand(nd)
        if ties and nd > 2:
            scores[1] = scores[2]
        preds.append({'bboxes': db, 'scores': scores,
                      'masks': [_box_mask(b) for b in db]})
        gts.append(gt)
    return preds, gts


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert (np.isnan(a) and np.isnan(b)) or a == b, (a, b)


def test_ious_equal():
    rng = np.random.RandomState(0)
    d = np.abs(rng.randn(6, 4)) * 10
    g = np.abs(rng.randn(4, 4)) * 10
    assert np.array_equal(tm.bbox_iou_xywh(d, g), jm.bbox_iou_xywh(d, g))
    dm = [_box_mask(b) for b in d]
    gm = [_box_mask(b) for b in g]
    assert np.array_equal(tm.mask_iou(dm, gm), jm.mask_iou(dm, gm))
    assert tm.mask_iou([], gm).shape == (0, 4)


@pytest.mark.parametrize('iou_type', ['bbox', 'segm'])
@pytest.mark.parametrize('seed,crowd,ties', [(0, True, True),
                                             (1, False, True),
                                             (2, True, False)])
def test_coco_map_equal(iou_type, seed, crowd, ties):
    preds, gts = _images(seed, crowd=crowd, ties=ties)
    for max_dets in (1, 10, 100):
        for area in (None, 'all', 'small', 'medium', 'large'):
            _same(tm.coco_map(preds, gts, iou_type, max_dets, area),
                  jm.coco_map(preds, gts, iou_type, max_dets, area))


@pytest.mark.parametrize('iou_type', ['bbox', 'segm'])
def test_coco_summary_equal(iou_type):
    preds, gts = _images(4)
    got = tm.coco_summary(preds, gts, iou_type)
    _same(got, jm.coco_summary(preds, gts, iou_type))
    assert len(got) == 12


def test_coco_map_no_gt_is_nan():
    preds, gts = _images(5, n=3)
    empty = [{'bboxes': np.zeros((0, 4)), 'masks': []} for _ in gts]
    got = tm.coco_map(preds, empty, 'bbox')
    _same(got, jm.coco_map(preds, empty, 'bbox'))
    assert np.isnan(got['mAP'])


def test_anime_manga_metric_equal():
    preds, gts = _images(6, n=6)
    a, b = jm.AnimeMangaMetric({2, 4}), tm.AnimeMangaMetric({2, 4})
    for i, (p, g) in enumerate(zip(preds, gts)):
        a.update(i, p, g)
        b.update(i, p, g)
    got = b.compute()
    _same(got, a.compute())
    assert set(got) == {'animeins_bbox', 'animeins_segm', 'manga109_bbox',
                        'manga109_segm'}

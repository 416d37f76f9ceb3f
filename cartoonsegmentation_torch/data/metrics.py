"""COCO-style detection/segmentation mAP (pure numpy) and the
per-source split metric (the port's own copy of
``cartoonsegmentation_tpu/data/metrics.py``).

Parity targets:
- COCO AP@[.5:.95] evaluation protocol (the reference delegates to
  pycocotools via mmdet's CocoMetric — not available here, so this is
  a self-contained implementation of the same protocol: 101-point
  interpolated AP, score-sorted greedy matching, per-IoU thresholds,
  maxDets=100).
- ``AnimeMangaMetric`` (reference animeinsseg/data/metrics.py:23-347):
  splits predictions by image-id source (manga109 vs animeins) and
  reports COCO bbox/segm mAP separately per source.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.linspace(0.0, 1.0, 101)
# pycocotools area ranges (COCOeval.params.areaRng)
AREA_RNG = {'all': (0.0, 1e10), 'small': (0.0, 32.0 ** 2),
            'medium': (32.0 ** 2, 96.0 ** 2),
            'large': (96.0 ** 2, 1e10)}


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(D,4) x (G,4) xywh → (D,G) IoU."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.maximum(0, np.minimum(dx2[:, None], gx2[None]) -
                    np.maximum(dx1[:, None], gx1[None]))
    iy = np.maximum(0, np.minimum(dy2[:, None], gy2[None]) -
                    np.maximum(dy1[:, None], gy1[None]))
    inter = ix * iy
    area_d = dt[:, 2] * dt[:, 3]
    area_g = gt[:, 2] * gt[:, 3]
    return inter / np.maximum(area_d[:, None] + area_g[None] - inter,
                              1e-9)


def mask_iou(dt_masks: Sequence[np.ndarray],
             gt_masks: Sequence[np.ndarray]) -> np.ndarray:
    D, G = len(dt_masks), len(gt_masks)
    out = np.zeros((D, G))
    if D == 0 or G == 0:
        return out
    dt = np.stack([m.astype(bool).reshape(-1) for m in dt_masks])
    gt = np.stack([m.astype(bool).reshape(-1) for m in gt_masks])
    inter = dt.astype(np.float64) @ gt.T.astype(np.float64)
    a_d = dt.sum(1)[:, None].astype(np.float64)
    a_g = gt.sum(1)[None].astype(np.float64)
    return inter / np.maximum(a_d + a_g - inter, 1e-9)


def _bbox_iou_crowd(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Crowd-gt IoU: intersection / det area (maskUtils.iou with
    iscrowd=1)."""
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    ix = np.maximum(0, np.minimum(dx2[:, None], gx2[None]) -
                    np.maximum(dt[:, None, 0], gt[None, :, 0]))
    iy = np.maximum(0, np.minimum(dy2[:, None], gy2[None]) -
                    np.maximum(dt[:, None, 1], gt[None, :, 1]))
    darea = (dt[:, 2] * dt[:, 3])[:, None]
    return ix * iy / np.maximum(darea, 1e-9)


def _mask_iou_crowd(dt_masks, gt_masks) -> np.ndarray:
    dt = np.stack([m.astype(bool).reshape(-1) for m in dt_masks])
    gt = np.stack([m.astype(bool).reshape(-1) for m in gt_masks])
    inter = dt.astype(np.float64) @ gt.T.astype(np.float64)
    return inter / np.maximum(dt.sum(1)[:, None].astype(np.float64),
                              1e-9)


def _match_image(iou: np.ndarray, dt_scores: np.ndarray, n_thr: int,
                 gt_ignore: Optional[np.ndarray] = None,
                 gt_crowd: Optional[np.ndarray] = None):
    """Greedy COCO matching (pycocotools COCOeval.evaluateImg
    semantics): for each IoU threshold, detections in score order
    claim the best still-claimable gt with IoU >= thr. ``gt_ignore``
    is the COMBINED ignore flag (crowd OR out of the area range):
    ignored gts sort last and matching one marks the det ignored
    (neither TP nor FP). ``gt_crowd`` governs re-claimability only —
    crowd gts are claimable repeatedly; area-ignored non-crowd gts
    are claimable once, exactly like pycocotools (`continue` tests
    iscrowd, the sorted `break` tests the combined flag). Returns
    (tp (n_thr, D) bool, dt_ig (n_thr, D) bool) with dt already
    score-sorted by the caller."""
    D, G = iou.shape
    if gt_ignore is None:
        gt_ignore = np.zeros(G, bool)
    if gt_crowd is None:
        gt_crowd = gt_ignore
    # pycocotools sorts gts combined-ignore-last (stable)
    gorder = np.argsort(gt_ignore, kind='mergesort')
    gt_ig = gt_ignore[gorder]
    crowd = np.asarray(gt_crowd, bool)[gorder]
    iou = iou[:, gorder] if G else iou
    tp = np.zeros((n_thr, D), bool)
    dt_ig = np.zeros((n_thr, D), bool)
    for t, thr in enumerate(IOU_THRS[:n_thr]):
        taken = np.zeros(G, bool)
        for d in range(D):
            best = min(thr, 1 - 1e-10)
            best_g = -1
            for g in range(G):
                # claimed non-crowd gts are gone; crowd gts stay
                # claimable
                if taken[g] and not crowd[g]:
                    continue
                # already matched to a real gt: stop at the ignored
                # tail (pycocotools: break to keep the real match)
                if best_g > -1 and not gt_ig[best_g] and gt_ig[g]:
                    break
                if iou[d, g] < best:
                    continue
                best, best_g = iou[d, g], g
            if best_g >= 0:
                taken[best_g] = True
                dt_ig[t, d] = gt_ig[best_g]
                tp[t, d] = not gt_ig[best_g]
    return tp, dt_ig


def _areas(entry: Dict, boxes: np.ndarray, masks, iou_type: str,
           order=None) -> np.ndarray:
    """Per-instance areas: explicit 'areas' key wins (pycocotools uses
    ann['area']); otherwise bbox w*h for bbox eval / mask pixel count
    for segm (what pycocotools' loadRes derives for detections)."""
    if entry.get('areas') is not None:
        a = np.asarray(entry['areas'], float)
    elif iou_type == 'bbox':
        b = np.asarray(boxes, float).reshape(-1, 4)
        a = b[:, 2] * b[:, 3]
    else:
        a = np.asarray([float(np.sum(m)) for m in masks])
    if order is not None:
        a = a[order] if len(a) else a
    return a


def _prepare_images(predictions: List[Dict], gts: List[Dict],
                    iou_type: str, max_cap: int) -> List[Dict]:
    """Per-image IoU matrices / sorted scores / areas, computed ONCE
    (pycocotools computes ious per image and reuses them across every
    areaRng/maxDets slice — mask IoU is the dominant cost)."""
    out = []
    for pred, gt in zip(predictions, gts):
        # stable score sort (pycocotools uses kind='mergesort'; with
        # tied scores an unstable sort changes AP)
        order = np.argsort(-np.asarray(pred.get('scores', [])),
                           kind='mergesort')[:max_cap]
        scores = np.asarray(pred.get('scores', []))[order]
        iscrowd = np.asarray(gt.get('iscrowd',
                                    np.zeros(len(gt.get('bboxes', [])),
                                             bool))).astype(bool)
        if iou_type == 'bbox':
            dt_b = np.asarray(pred.get('bboxes', np.zeros((0, 4))))
            gt_b = np.asarray(gt.get('bboxes', np.zeros((0, 4))))
            dt_b = dt_b[order] if len(dt_b) else dt_b
            iou = bbox_iou_xywh(dt_b, gt_b)
            if iscrowd.any() and len(dt_b):
                # crowd IoU = inter / det area (maskUtils.iou)
                crowd_iou = _bbox_iou_crowd(dt_b, gt_b)
                iou = np.where(iscrowd[None, :len(gt_b)], crowd_iou, iou)
            dt_area = _areas(pred, pred.get('bboxes', np.zeros((0, 4))),
                             None, 'bbox', order)
            gt_area = _areas(gt, gt_b, None, 'bbox')
            n_inst = len(gt_b)
        else:
            dt_m = [pred['masks'][i] for i in order] \
                if pred.get('masks') is not None and len(order) else []
            gt_m = gt.get('masks', [])
            iou = mask_iou(dt_m, gt_m)
            if iscrowd.any() and len(dt_m):
                crowd_iou = _mask_iou_crowd(dt_m, gt_m)
                iou = np.where(iscrowd[None, :len(gt_m)], crowd_iou, iou)
            # NOTE: pass the UNSORTED masks — _areas applies ``order``
            # itself; dt_m is already sorted (double-permute bug found
            # by the pycocotools-oracle cross-check)
            dt_area = _areas(pred, None, pred.get('masks') or [],
                             'segm', order)
            gt_area = _areas(gt, None, gt_m, 'segm')
            n_inst = len(gt_m)
        crowd = iscrowd if len(iscrowd) else np.zeros(n_inst, bool)
        out.append({'scores': scores, 'iou': iou, 'crowd': crowd,
                    'dt_area': dt_area, 'gt_area': gt_area})
    return out


def coco_map(predictions: List[Dict], gts: List[Dict],
             iou_type: str = 'bbox', max_dets: int = 100,
             area_rng=None, _prepared=None) -> Dict:
    """predictions/gts: per-image dicts with keys
    'bboxes' (N,4 xywh), 'scores' (preds), 'masks' (list of HxW bool,
    only for iou_type='segm'), optional 'areas'.
    ``area_rng``: (lo, hi) area range or a name from AREA_RNG —
    gts outside the range are ignored, unmatched dts outside it are
    neither TP nor FP (pycocotools semantics).
    Returns {'mAP', 'mAP_50', 'mAP_75', 'AP_per_iou', 'AR'} where AR
    is the max recall at this max_dets averaged over IoU thresholds."""
    n_thr = len(IOU_THRS)
    if isinstance(area_rng, str):
        area_rng = AREA_RNG[area_rng]
    if _prepared is None:
        _prepared = _prepare_images(predictions, gts, iou_type,
                                    max_dets)
    all_scores, all_tp, all_ig = [], [], []
    n_gt = 0
    for im in _prepared:
        scores = im['scores'][:max_dets]
        iou = im['iou'][:max_dets]
        dt_area = im['dt_area'][:max_dets]
        crowd, gt_area = im['crowd'], im['gt_area']
        if area_rng is not None and len(crowd):
            gt_out = (gt_area < area_rng[0]) | (gt_area > area_rng[1])
            gt_ignore = crowd | gt_out
        else:
            gt_ignore = crowd
        n_gt += int((~gt_ignore).sum())
        all_scores.append(scores)
        tp, ig = _match_image(iou, scores, n_thr, gt_ignore, crowd)
        if area_rng is not None and len(scores):
            dt_out = (dt_area < area_rng[0]) | (dt_area > area_rng[1])
            # unmatched dts outside the range: neither TP nor FP
            ig = ig | (~tp & ~ig & dt_out[None, :])
        all_tp.append(tp)
        all_ig.append(ig)

    if n_gt == 0:
        return {'mAP': float('nan'), 'mAP_50': float('nan'),
                'mAP_75': float('nan'),
                'AP_per_iou': [float('nan')] * n_thr,
                'AR': float('nan')}

    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    tp = np.concatenate(all_tp, axis=1) if all_tp \
        else np.zeros((n_thr, 0), bool)
    ig = np.concatenate(all_ig, axis=1) if all_ig \
        else np.zeros((n_thr, 0), bool)
    order = np.argsort(-scores, kind='mergesort')
    tp = tp[:, order]
    ig = ig[:, order]

    aps = []
    recalls = []
    for t in range(n_thr):
        keep = ~ig[t]
        ctp = np.cumsum(tp[t][keep])
        cfp = np.cumsum(~tp[t][keep])
        recall = ctp / n_gt
        recalls.append(float(recall[-1]) if len(recall) else 0.0)
        precision = ctp / np.maximum(ctp + cfp, 1e-9)
        # monotone precision envelope
        for i in range(len(precision) - 1, 0, -1):
            precision[i - 1] = max(precision[i - 1], precision[i])
        # 101-point interpolation (guard first: an all-ignored slice
        # leaves precision empty and indexing it would raise)
        if len(precision) == 0:
            p = np.zeros_like(REC_THRS)
        else:
            idx = np.searchsorted(recall, REC_THRS, side='left')
            p = np.where(idx < len(precision),
                         precision[np.minimum(idx, len(precision) - 1)],
                         0.0)
        aps.append(p.mean())
    aps = np.asarray(aps)
    return {'mAP': float(aps.mean()),
            'mAP_50': float(aps[0]),
            'mAP_75': float(aps[5]),
            'AP_per_iou': aps.tolist(),
            'AR': float(np.mean(recalls))}


def coco_summary(predictions: List[Dict], gts: List[Dict],
                 iou_type: str = 'bbox') -> Dict[str, float]:
    """The standard 12-number COCO summary (COCOeval.summarize):
    AP@[.5:.95]/50/75, AP small/medium/large (maxDets=100),
    AR@1/10/100 (area all), AR small/medium/large (maxDets=100)."""
    out: Dict[str, float] = {}
    # per-image IoU/areas computed once, reused by every slice
    prepared = _prepare_images(predictions, gts, iou_type, 100)
    base = coco_map(predictions, gts, iou_type, max_dets=100,
                    area_rng='all', _prepared=prepared)
    out['AP'] = base['mAP']
    out['AP_50'] = base['mAP_50']
    out['AP_75'] = base['mAP_75']
    out['AR_100'] = base['AR']
    for name in ('small', 'medium', 'large'):
        m = coco_map(predictions, gts, iou_type, max_dets=100,
                     area_rng=name, _prepared=prepared)
        out[f'AP_{name}'] = m['mAP']
        out[f'AR_{name}'] = m['AR']
    for k in (1, 10):
        out[f'AR_{k}'] = coco_map(predictions, gts, iou_type,
                                  max_dets=k, area_rng='all',
                                  _prepared=prepared)['AR']
    return out


class AnimeMangaMetric:
    """Per-source COCO metric (reference metrics.py:23-347): results
    for image ids in ``manga_ids`` and the rest are evaluated
    separately, for both bbox and segm."""

    def __init__(self, manga_ids: Optional[set] = None):
        self.manga_ids = manga_ids or set()
        self._preds: Dict[int, Dict] = {}
        self._gts: Dict[int, Dict] = {}

    def update(self, image_id: int, prediction: Dict, gt: Dict) -> None:
        self._preds[image_id] = prediction
        self._gts[image_id] = gt

    def compute(self, iou_types=('bbox', 'segm')) -> Dict[str, Dict]:
        out = {}
        for source in ('animeins', 'manga109'):
            ids = [i for i in self._preds
                   if (i in self.manga_ids) == (source == 'manga109')]
            if not ids:
                continue
            preds = [self._preds[i] for i in ids]
            gts = [self._gts[i] for i in ids]
            for it in iou_types:
                out[f'{source}_{it}'] = coco_map(preds, gts, it)
        return out

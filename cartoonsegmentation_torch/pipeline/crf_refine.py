"""Structure-aware depth refinement by segment extraction and a dense
CRF (the ``refine_crf`` option) — the PyTorch port of
``cartoonsegmentation_tpu/pipeline/crf_refine.py``.

Parity: reference kenburns_effect.py:636-809 (refine_depth_crf):
colorize depth → k-means quantize into 5 levels → Canny edges →
connected components per level → distance-transform seed → floodFill
→ dense-CRF boundary snap per segment → hierarchical mask merging →
write the median disparity into each merged segment.

Host/device split as in the JAX version: the per-segment bookkeeping
(connected components, flood fill, merging) stays on the host with cv2;
the colorize (kernel K5b) and each segment's dense CRF (``ops/crf.py``:
kernels K12a and K12b) run on the caller's device, CUDA unless the
caller asks for the CPU."""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..data.augment import quantize_image
from ..device import resolve_device
from ..ops.crf import densecrf_binary
from .depth import colorize_gray_r


def enlarge_window(rect, im_w: int, im_h: int, ratio: float = 2.5,
                   aspect_ratio: float = 1.0) -> List[int]:
    """Grow a rect to ~ratio x area, clipped (kenburns_effect.py:
    165-186)."""
    x1, y1, x2, y2 = rect
    w, h = x2 - x1, y2 - y1
    if w <= 0 or h <= 0:
        return [0, 0, 0, 0]
    coeff = [aspect_ratio, w + h * aspect_ratio, (1 - ratio) * w * h]
    roots = np.roots(coeff)
    roots.sort()
    delta = int(round(roots[-1].real / 2))
    delta_w = int(delta * aspect_ratio)
    delta_w = min(x1, im_w - x2, delta_w)
    delta = min(y1, im_h - y2, delta)
    rect = np.array([x1 - delta_w, y1 - delta, x2 + delta_w, y2 + delta],
                    np.int64)
    rect[::2] = np.clip(rect[::2], 0, im_w)
    rect[1::2] = np.clip(rect[1::2], 0, im_h)
    return rect.tolist()


def _merge_mask(a, b):
    """Try to merge two (mask, rect, area) segments; returns
    ((merged, rect, area), score) or None (kenburns_effect.py:94-142)."""
    msk1, br1, area1 = a
    msk2, br2, area2 = b
    ax1, ay1, ax2, ay2 = br1
    bx1, by1, bx2, by2 = br2
    if min(ax2, bx2) <= max(ax1, bx1) or min(ay2, by2) <= max(ay1, by1):
        return None
    l, t = min(ax1, bx1), min(ay1, by1)
    r, btm = max(ax2, bx2), max(ay2, by2)
    w, h = r - l, btm - t
    m1 = np.zeros((h, w), np.uint8)
    m2 = np.zeros((h, w), np.uint8)
    m1[ay1 - t:ay2 - t, ax1 - l:ax2 - l] = msk1
    m2[by1 - t:by2 - t, bx1 - l:bx2 - l] = msk2
    inter = np.bitwise_and(m1, m2).sum() / 255.0
    score = max(inter / max(area1, 1), inter / max(area2, 1))
    if score > 0.1:
        merged = np.bitwise_or(m1, m2)
        return (merged, [l, t, r, btm], merged.sum() / 255.0), score
    return None


def _try_merge_list(src: List, tgt: List, fin: List) -> None:
    while src:
        seg = src.pop(0)
        best, best_score, best_idx = None, -1.0, -1
        for j, t in enumerate(tgt):
            res = _merge_mask(seg, t)
            if res is not None and res[1] > best_score:
                best, best_score, best_idx = res[0], res[1], j
        if best_idx != -1:
            tgt[best_idx] = best
        else:
            fin.append(seg)


def refine_depth_crf(img_bgr: np.ndarray, disparity: np.ndarray,
                     instance_mask: Optional[np.ndarray] = None,
                     device=None) -> np.ndarray:
    """disparity (H, W) float; instance_mask True where characters are
    (those pixels are excluded, like the reference's inverted compose
    mask). Returns the refined disparity (host)."""
    import cv2
    dev = resolve_device(device)

    rgb = cv2.cvtColor(img_bgr, cv2.COLOR_BGR2RGB)
    im_h, im_w = rgb.shape[:2]
    img_size = im_h * im_w

    ins_free = None if instance_mask is None else ~instance_mask
    depth_u8 = colorize_gray_r(
        torch.from_numpy(np.ascontiguousarray(disparity, np.float32)).to(dev)
    ).cpu().numpy().astype(np.uint8)[..., None]
    quant, centers, _ = quantize_image(depth_u8, 5, mask=ins_free)

    edges = cv2.Canny(depth_u8, 50, 140, L2gradient=True, apertureSize=3)
    el = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    edges = cv2.morphologyEx(edges, cv2.MORPH_CLOSE, el)
    depth_u8 = depth_u8.copy()
    depth_u8[edges > 0] = 255 - depth_u8[edges > 0]

    size_thr = max(img_size / 1000, 5)
    centers = sorted(int(c[0]) for c in centers)

    hier: List[List] = []
    for c in centers:
        hier.append([])
        raw = (quant[..., 0] == c)
        if ins_free is not None:
            raw = np.logical_and(raw, ins_free)
        raw = raw.astype(np.uint8) * 255
        n, labels, stats, _ = cv2.connectedComponentsWithStats(
            raw, connectivity=4)
        for li in range(1, n):
            x, y, w, h, area = stats[li]
            if w * h < size_thr:
                continue
            x2, y2 = x + w, y + h
            local = (labels[y:y2, x:x2] == li).astype(np.uint8) * 255
            cv2.rectangle(local, (0, 0), (local.shape[1], local.shape[0]),
                          0, 1)
            dist = cv2.distanceTransform(local, cv2.DIST_L2, 3)
            sy, sx = np.unravel_index(int(np.argmax(dist)), dist.shape)

            ex1, ey1, ex2, ey2 = enlarge_window([x, y, x2, y2],
                                                im_w, im_h, ratio=4)
            sx2, sy2 = sx - ex1 + x, sy - ey1 + y
            dc = depth_u8[ey1:ey2, ex1:ex2, 0].copy()
            fillmsk = np.zeros((dc.shape[0] + 2, dc.shape[1] + 2),
                               np.uint8)
            if ins_free is not None:
                fillmsk[1:-1, 1:-1] = ~ins_free[ey1:ey2, ex1:ex2]
            try:
                ret, _, mout, _ = cv2.floodFill(
                    dc, mask=fillmsk, seedPoint=(int(sx2), int(sy2)),
                    newVal=255, loDiff=4, upDiff=4,
                    flags=cv2.FLOODFILL_MASK_ONLY | 4)
            except cv2.error:
                continue
            mout = (mout[1:-1, 1:-1] * 255).astype(np.uint8)
            mout = cv2.dilate(mout, el)
            if ins_free is not None:
                mout[~ins_free[ey1:ey2, ex1:ex2]] = 0

            crop_rgb = np.ascontiguousarray(rgb[ey1:ey2, ex1:ex2])
            crf = densecrf_binary(
                torch.from_numpy(mout.astype(np.float32) / 255.0).to(dev),
                torch.from_numpy(crop_rgb).to(dev)
            ).cpu().numpy().astype(np.uint8) * 255
            crf = cv2.morphologyEx(crf, cv2.MORPH_CLOSE, el)
            nz = cv2.findNonZero(crf)
            if nz is None:
                continue
            bx, by, bw, bh = cv2.boundingRect(nz)
            if bw * bh < size_thr:
                continue
            crf = crf[by:by + bh, bx:bx + bw]
            bx += ex1
            by += ey1
            if mout.sum() / (crf.sum() + 0.1) > 0.5:
                hier[-1].append([crf, [bx, by, bx + bw, by + bh],
                                 float(ret)])

    final: List = []
    if hier:
        for i, segs in enumerate(hier[:-1]):
            if not segs:
                continue
            src = [segs.pop(0)]
            _try_merge_list(segs, src, src)
            _try_merge_list(src, hier[i + 1], final)
        last = hier[-1]
        if last:
            src = [last.pop(0)]
            _try_merge_list(last, src, src)
            final += src

    out = disparity.copy()
    ins_free_u8 = None if ins_free is None \
        else ins_free.astype(np.uint8) * 255
    for mask, br, _ in final:
        mask = cv2.dilate(mask, cv2.getStructuringElement(
            cv2.MORPH_ELLIPSE, (5, 5)))
        if ins_free_u8 is not None:
            mask = np.bitwise_and(
                mask, ins_free_u8[br[1]:br[3], br[0]:br[2]])
            ins_free_u8[br[1]:br[3], br[0]:br[2]][mask > 0] = 0
        if mask.sum() / 255 > img_size / 10:
            continue
        sel = mask > 0
        region = out[br[1]:br[3], br[0]:br[2]]
        if sel.any():
            region[sel] = np.median(region[sel])
    return out

"""Fixed-capacity instance container (port of
``cartoonsegmentation_tpu/instances.py``, ``draw`` included).

Masks (N, H, W) bool, boxes (N, 4) xywh, scores (N,), valid (N,);
invalid slots are all-zero and masked out by ``valid``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from .utils.constants import get_color
from .utils.image import resize_bilinear_aa


@dataclass
class Instances:
    masks: torch.Tensor    # (N, H, W) bool
    bboxes: torch.Tensor   # (N, 4) float32, xywh
    scores: torch.Tensor   # (N,) float32
    valid: torch.Tensor    # (N,) bool

    @staticmethod
    def empty(capacity: int, h: int, w: int,
              device: Optional[torch.device] = None) -> 'Instances':
        return Instances(
            masks=torch.zeros((capacity, h, w), dtype=torch.bool,
                              device=device),
            bboxes=torch.zeros((capacity, 4), device=device),
            scores=torch.zeros((capacity,), device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool,
                              device=device))

    @staticmethod
    def from_numpy(masks: Optional[np.ndarray], bboxes: np.ndarray,
                   scores: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None,
                   device: Optional[torch.device] = None) -> 'Instances':
        """Build from ragged host arrays, padding to ``capacity``."""
        n = 0 if masks is None else len(masks)
        if capacity is None:
            capacity = max(n, 1)
        if n == 0:
            h, w = (1, 1) if masks is None else masks.shape[1:3]
            return Instances.empty(capacity, h, w, device)
        h, w = masks.shape[1:3]
        if scores is None:
            scores = np.ones((n,), np.float32)
        out = Instances.empty(capacity, h, w, device)
        k = min(n, capacity)
        out.masks[:k] = torch.as_tensor(np.asarray(masks[:k], bool))
        out.bboxes[:k] = torch.as_tensor(np.asarray(bboxes[:k],
                                                    np.float32))
        out.scores[:k] = torch.as_tensor(np.asarray(scores[:k],
                                                    np.float32))
        out.valid[:k] = True
        return out

    @property
    def capacity(self) -> int:
        return self.masks.shape[0]

    @property
    def shape_hw(self):
        return self.masks.shape[1], self.masks.shape[2]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()

    def is_empty_host(self) -> bool:
        """Host-side emptiness check (reads one scalar)."""
        return int(self.count()) == 0

    def compose_masks(self) -> torch.Tensor:
        """Union of all valid masks, (H, W) bool."""
        return (self.masks & self.valid[:, None, None]).any(0)

    def masked_areas(self) -> torch.Tensor:
        return self.masks.sum((1, 2)).float() * self.valid.float()

    def replace(self, **kw) -> 'Instances':
        return replace(self, **kw)

    def to(self, device) -> 'Instances':
        return replace(self, **{k: getattr(self, k).to(device)
                                for k in ('masks', 'bboxes', 'scores',
                                          'valid')})

    def remove_duplicated(self, overlap_thr: float = 0.8) -> 'Instances':
        """Drop masks mostly covered by the union of larger ones
        (anime_instances.py:84-127): walk the instances by area,
        largest first (stable, so equal areas keep slot order); a mask
        whose overlap with the running union exceeds ``overlap_thr`` of
        its own area is invalidated, the first is always kept; kept
        masks join the union. Returned in that sorted order."""
        areas = self.masked_areas()
        order = torch.sort(-areas, stable=True).indices
        masks, valid, areas = self.masks[order], self.valid[order], \
            areas[order]
        canvas = torch.zeros(self.shape_hw, dtype=torch.bool,
                             device=masks.device)
        keep = torch.zeros_like(valid)
        for i in range(self.capacity):
            inter = (canvas & masks[i]).sum().float()
            dup = inter / areas[i].clamp(min=1.0) > overlap_thr
            k = valid[i] & (~dup if i else torch.ones_like(dup))
            keep[i] = k
            canvas = canvas | (masks[i] & k)
        return Instances(masks=masks & keep[:, None, None],
                         bboxes=self.bboxes[order] * keep[:, None],
                         scores=self.scores[order] * keep, valid=keep)

    def resize(self, h: int, w: int, mask_thr: float = 0.3) -> 'Instances':
        """Masks to (h, w) and boxes rescaled (instances.py:132-155):
        upscales take the nearest source pixel as jax.image.resize
        does (src = floor((i + 0.5)·in/out) in f32), downscales the
        antialiased linear resize; then > mask_thr and the valid gate,
        with the boxes rounded."""
        oh, ow = self.shape_hw
        if (oh, ow) == (h, w):
            return self
        m = self.masks.float()
        if h >= oh and w >= ow:
            dev = m.device
            rows = torch.from_numpy(_nearest_src(oh, h)).to(dev)
            cols = torch.from_numpy(_nearest_src(ow, w)).to(dev)
            m = m.index_select(1, rows).index_select(2, cols)
        else:
            m = resize_bilinear_aa(m.permute(1, 2, 0), h, w).permute(2, 0, 1)
        scale = torch.tensor([w / ow, h / oh, w / ow, h / oh],
                             dtype=torch.float32, device=self.bboxes.device)
        return self.replace(masks=(m > mask_thr) & self.valid[:, None, None],
                            bboxes=torch.round(self.bboxes * scale))

    def draw(self, img: np.ndarray, draw_bbox: bool = True,
             draw_ins_mask: bool = True, tags: Optional[List[str]] = None,
             mask_alpha: float = 0.75,
             draw_contour: bool = False) -> np.ndarray:
        """Host-side visualisation with cv2 (imported here): boxes,
        translucent masks, optional contours and tags, in the JAX
        version's order and f32 arithmetic. Parity:
        anime_instances.py:131-194 (draw_instances)."""
        import cv2
        masks = self.masks.cpu().numpy()
        bboxes = self.bboxes.cpu().numpy()
        valid = self.valid.cpu().numpy()

        drawed = img.copy()
        im_h, im_w = img.shape[:2]
        mh, mw = masks.shape[1:3]
        if (mh, mw) != (im_h, im_w):
            drawed = cv2.resize(drawed, (mw, mh), interpolation=cv2.INTER_AREA)

        idxs = [i for i in range(len(valid)) if valid[i]]
        if draw_bbox:
            lw = max(round(sum(drawed.shape) / 2 * 0.003), 2)
            for i in idxs:
                x, y, w, h = bboxes[i]
                p1, p2 = (int(x), int(y)), (int(x + w), int(y + h))
                cv2.rectangle(drawed, p1, p2, get_color(i), thickness=lw,
                              lineType=cv2.LINE_AA)
        if draw_ins_mask:
            drawed = drawed.astype(np.float32)
            for i in idxs:
                color = np.array(get_color(i), np.float32)
                a = (mask_alpha * masks[i].astype(np.float32))[..., None]
                drawed = drawed * (1 - a) + a * color
            drawed = drawed.astype(np.uint8)
        if draw_contour:
            lw = max(round(sum(drawed.shape) / 2 * 0.002), 2)
            for i in idxs:
                cs, _ = cv2.findContours(
                    masks[i].astype(np.uint8), cv2.RETR_EXTERNAL,
                    cv2.CHAIN_APPROX_SIMPLE)
                cv2.drawContours(drawed, cs, -1, get_color(i),
                                 thickness=lw, lineType=cv2.LINE_AA)
        if tags:
            lw = max(round(sum(drawed.shape) / 2 * 0.002), 2)
            for i in idxs:
                if i < len(tags) and tags[i]:
                    x, y = int(bboxes[i][0]), int(bboxes[i][1]) + 14
                    cv2.putText(drawed, tags[i][:60], (x, y), 0, lw / 3,
                                get_color(i), thickness=max(lw - 1, 1),
                                lineType=cv2.LINE_AA)
        return drawed


def _nearest_src(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize 'nearest' source rows: floor((i + 0.5)·in/out),
    evaluated in f32 in that order."""
    i = np.arange(n_out, dtype=np.float32)
    src = np.floor((i + np.float32(0.5)) * np.float32(n_in)
                   / np.float32(n_out))
    return src.astype(np.int64)

"""Foreground paste layout methods for synthetic composition (the
port's own copy of ``cartoonsegmentation_tpu/data/paste.py``).

Parity: reference animeinsseg/data/paste_methods.py — a partition
tree that subdivides free canvas space (partition_paste :18-221) and
a regular grid layout (regular_paste :226-326). Both return the
composited image plus per-instance masks.
"""
from __future__ import annotations

import random
from typing import List, Optional, Tuple

import numpy as np


def alpha_paste(canvas: np.ndarray, fg_rgba: np.ndarray, x: int, y: int
                ) -> Optional[np.ndarray]:
    """Alpha-blend fg onto canvas at (x, y); returns the full-canvas
    instance mask (bool) or None if nothing landed."""
    H, W = canvas.shape[:2]
    fh, fw = fg_rgba.shape[:2]
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + fw, W), min(y + fh, H)
    if x1 <= x0 or y1 <= y0:
        return None
    crop = fg_rgba[y0 - y:y1 - y, x0 - x:x1 - x]
    alpha = crop[..., 3:].astype(np.float32) / 255.0
    region = canvas[y0:y1, x0:x1].astype(np.float32)
    canvas[y0:y1, x0:x1] = (crop[..., :3] * alpha +
                            region * (1 - alpha)).astype(canvas.dtype)
    mask = np.zeros((H, W), bool)
    mask[y0:y1, x0:x1] = crop[..., 3] > 127
    if not mask.any():
        return None
    return mask


class PartitionNode:
    """Binary space partition over free canvas area."""

    def __init__(self, x0, y0, x1, y1):
        self.box = (x0, y0, x1, y1)
        self.children: List['PartitionNode'] = []
        self.used = False

    def free_leaves(self) -> List['PartitionNode']:
        if not self.children:
            return [] if self.used else [self]
        out = []
        for c in self.children:
            out.extend(c.free_leaves())
        return out

    def place(self, fw: int, fh: int) -> Optional[Tuple[int, int]]:
        x0, y0, x1, y1 = self.box
        if x1 - x0 < fw or y1 - y0 < fh:
            return None
        # random position within the cell
        px = random.randint(x0, x1 - fw)
        py = random.randint(y0, y1 - fh)
        # split remaining space (right + below the placed rect)
        self.used = True
        self.children = [
            PartitionNode(px + fw, y0, x1, y1),
            PartitionNode(x0, py + fh, px + fw, y1),
        ]
        return px, py


def partition_paste(bg: np.ndarray, fgs: List[np.ndarray]
                    ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Paste fgs into successively partitioned free space."""
    canvas = bg.copy()
    root = PartitionNode(0, 0, bg.shape[1], bg.shape[0])
    masks = []
    for fg in fgs:
        placed = False
        leaves = root.free_leaves()
        random.shuffle(leaves)
        for leaf in leaves:
            pos = leaf.place(fg.shape[1], fg.shape[0])
            if pos is not None:
                m = alpha_paste(canvas, fg, pos[0], pos[1])
                if m is not None:
                    masks.append(m)
                placed = True
                break
        if not placed:
            # fallback: random position (may overlap)
            x = random.randint(-fg.shape[1] // 4,
                               max(bg.shape[1] - fg.shape[1] // 2, 1))
            y = random.randint(-fg.shape[0] // 4,
                               max(bg.shape[0] - fg.shape[0] // 2, 1))
            m = alpha_paste(canvas, fg, x, y)
            if m is not None:
                masks.append(m)
    return canvas, masks


def regular_paste(bg: np.ndarray, fgs: List[np.ndarray],
                  jitter: float = 0.15
                  ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Evenly spaced row layout with jitter (paste_methods.py:226-326)."""
    canvas = bg.copy()
    H, W = bg.shape[:2]
    n = len(fgs)
    if n == 0:
        return canvas, []
    masks = []
    cell_w = W / n
    for i, fg in enumerate(fgs):
        fh, fw = fg.shape[:2]
        cx = (i + 0.5) * cell_w + random.uniform(-jitter, jitter) * cell_w
        x = int(round(cx - fw / 2))
        y = H - fh + int(random.uniform(0, 0.1) * H)  # feet near bottom
        m = alpha_paste(canvas, fg, x, y)
        if m is not None:
            masks.append(m)
    return canvas, masks


def bbox_paste(bg: np.ndarray, fgs: List[np.ndarray],
               boxes: List[np.ndarray]
               ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Paste each fg scaled into a sampled person bbox layout."""
    import cv2
    canvas = bg.copy()
    masks = []
    for fg, box in zip(fgs, boxes):
        x, y, w, h = [int(round(v)) for v in box]
        if w < 4 or h < 4:
            continue
        s = min(w / fg.shape[1], h / fg.shape[0])
        nw = max(1, int(fg.shape[1] * s))
        nh = max(1, int(fg.shape[0] * s))
        fg_r = cv2.resize(fg, (nw, nh), interpolation=cv2.INTER_AREA)
        m = alpha_paste(canvas, fg_r, x + (w - nw) // 2, y + h - nh)
        if m is not None:
            masks.append(m)
    return canvas, masks

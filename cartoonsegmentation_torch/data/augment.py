"""Colour quantisation for the CRF depth refine (the port's copy of
``cartoonsegmentation_tpu/data/augment.py:quantize_image``, a numpy
function; the port keeps its own copy and imports nothing of the JAX
package)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def quantize_image(img: np.ndarray, k: int,
                   mask: Optional[np.ndarray] = None,
                   iters: int = 10):
    """k-means colour quantisation. Returns (quantized, centers,
    labels). Parity: reference data/transforms.py:224-271 (cv2.kmeans
    path)."""
    flat = img.reshape(-1, img.shape[-1]).astype(np.float32)
    sel = np.ones(len(flat), bool)
    if mask is not None:
        sel = mask.reshape(-1) > 0
    data = flat[sel]
    if len(data) < k:
        return img.copy(), [tuple(c) for c in flat[:k]], \
            np.zeros(len(flat), np.int32)
    # k-means++ style init: random distinct samples
    rng = np.random.RandomState(0)
    centers = data[rng.choice(len(data), k, replace=False)]
    for _ in range(iters):
        d = ((data[:, None, :] - centers[None]) ** 2).sum(-1)
        lbl = d.argmin(1)
        for j in range(k):
            pts = data[lbl == j]
            if len(pts):
                centers[j] = pts.mean(0)
    d_all = ((flat[:, None, :] - centers[None]) ** 2).sum(-1)
    labels = d_all.argmin(1)
    quant = centers[labels].reshape(img.shape)
    if mask is not None:
        quant = np.where(sel.reshape(img.shape[:2] + (1,))[..., :1]
                         if img.ndim == 3 else sel.reshape(img.shape),
                         quant, img)
    return quant.astype(img.dtype), [tuple(np.round(c).astype(img.dtype))
                                     for c in centers], labels

"""Host-side augmentations + color correction for synthetic data (the
port's own copy of ``cartoonsegmentation_tpu/data/augment.py``, numpy
and cv2 only).

Replaces the reference's albumentations/imgaug stacks
(animeinsseg/data/transforms.py) with dependency-free numpy/cv2
implementations of the same operations: flips, color jitter, blur,
JPEG artifacts, resize-to-height, rotation, k-means quantization
(quantize_image — also used by the CRF refinement path,
kenburns_effect.py:678) and fg/bg histogram matching
(utils/io_utils.py:128-213).
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np


def resize2height(img: np.ndarray, height: int) -> np.ndarray:
    import cv2
    h, w = img.shape[:2]
    return cv2.resize(img, (max(1, int(round(w * height / h))), height),
                      interpolation=cv2.INTER_AREA if height < h
                      else cv2.INTER_LINEAR)


def rotate_image(img: np.ndarray, angle: float) -> np.ndarray:
    """Rotate around center, expanding the canvas (alpha-safe)."""
    import cv2
    h, w = img.shape[:2]
    M = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
    cos, sin = abs(M[0, 0]), abs(M[0, 1])
    nw = int(h * sin + w * cos)
    nh = int(h * cos + w * sin)
    M[0, 2] += nw / 2 - w / 2
    M[1, 2] += nh / 2 - h / 2
    return cv2.warpAffine(img, M, (nw, nh))


def color_jitter(img: np.ndarray, brightness=0.2, contrast=0.2,
                 saturation=0.2) -> np.ndarray:
    import cv2
    out = img.astype(np.float32)
    alpha = None
    if out.shape[2] == 4:
        alpha = out[..., 3:]
        out = out[..., :3]
    out *= 1.0 + random.uniform(-brightness, brightness)
    mean = out.mean()
    out = (out - mean) * (1.0 + random.uniform(-contrast, contrast)) + mean
    grey = cv2.cvtColor(np.clip(out, 0, 255).astype(np.uint8),
                        cv2.COLOR_BGR2GRAY)[..., None].astype(np.float32)
    s = 1.0 + random.uniform(-saturation, saturation)
    out = out * s + grey * (1 - s)
    out = np.clip(out, 0, 255)
    if alpha is not None:
        out = np.concatenate([out, alpha], -1)
    return out.astype(img.dtype)


def jpeg_artifacts(img: np.ndarray, quality: int) -> np.ndarray:
    import cv2
    has_alpha = img.shape[2] == 4
    rgb = img[..., :3]
    ok, enc = cv2.imencode('.jpg', rgb,
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR)
    if has_alpha:
        return np.concatenate([dec, img[..., 3:]], -1)
    return dec


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    import cv2
    k = max(3, int(2 * round(2 * sigma) + 1))
    return cv2.GaussianBlur(img, (k, k), sigma)


def fg_transform(img_rgba: np.ndarray, tgt_size: int,
                 train: bool = True) -> np.ndarray:
    """Foreground aug: hflip / jitter / blur / jpeg, size-capped."""
    import cv2
    h, w = img_rgba.shape[:2]
    if max(h, w) > tgt_size:
        s = tgt_size / max(h, w)
        img_rgba = cv2.resize(img_rgba, (max(1, int(w * s)),
                                         max(1, int(h * s))),
                              interpolation=cv2.INTER_AREA)
    if not train:
        return img_rgba
    if random.random() < 0.5:
        img_rgba = img_rgba[:, ::-1].copy()
    if random.random() < 0.5:
        img_rgba = color_jitter(img_rgba)
    if random.random() < 0.2:
        img_rgba = gaussian_blur(img_rgba, random.uniform(0.5, 1.5))
    if random.random() < 0.3:
        img_rgba = jpeg_artifacts(img_rgba, random.randint(60, 95))
    return img_rgba


def bg_transform(img: np.ndarray, tgt_size: int,
                 train: bool = True) -> np.ndarray:
    """Background: random crop-resize to (tgt_size, tgt_size)."""
    import cv2
    h, w = img.shape[:2]
    if train and min(h, w) > 64 and random.random() < 0.5:
        ch = random.randint(int(0.7 * h), h)
        cw = random.randint(int(0.7 * w), w)
        y0 = random.randint(0, h - ch)
        x0 = random.randint(0, w - cw)
        img = img[y0:y0 + ch, x0:x0 + cw]
    img = cv2.resize(img, (tgt_size, tgt_size),
                     interpolation=cv2.INTER_AREA)
    if train and random.random() < 0.5:
        img = img[:, ::-1].copy()
    return img


# ---------------------------------------------------------------------------
# color correction
# ---------------------------------------------------------------------------

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


def hist_match(source: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching (utils/io_utils.py hist match)."""
    out = np.empty_like(source)
    for c in range(source.shape[-1]):
        s = source[..., c].ravel()
        t = template[..., c].ravel()
        s_vals, s_idx, s_cnt = np.unique(s, return_inverse=True,
                                         return_counts=True)
        t_vals, t_cnt = np.unique(t, return_counts=True)
        s_q = np.cumsum(s_cnt).astype(np.float64) / s.size
        t_q = np.cumsum(t_cnt).astype(np.float64) / t.size
        interp = np.interp(s_q, t_q, t_vals)
        out[..., c] = interp[s_idx].reshape(source.shape[:2])
    return out


def fgbg_hist_matching(fg_rgba: np.ndarray, bg: np.ndarray,
                       strength: float = 0.7) -> np.ndarray:
    """Match fg colors toward bg statistics, blend by strength."""
    fg = fg_rgba[..., :3]
    matched = hist_match(fg, bg)
    blended = (fg.astype(np.float32) * (1 - strength) +
               matched.astype(np.float32) * strength)
    out = fg_rgba.copy()
    out[..., :3] = np.clip(blended, 0, 255).astype(fg_rgba.dtype)
    return out

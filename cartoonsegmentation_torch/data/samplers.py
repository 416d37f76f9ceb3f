"""Random samplers for synthetic data generation (the port's own copy
of ``cartoonsegmentation_tpu/data/samplers.py``, numpy and cv2 only).

Parity: reference animeinsseg/data/sampler.py — NameSampler (discrete
categorical), PoissonSampler, NormalSampler, PersonBBoxSampler (COCO
person-bbox layouts), random fg/bg loaders.
"""
from __future__ import annotations

import json
import random
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


class NameSampler:
    """Categorical over names; residual probability → '' (none)."""

    def __init__(self, name_prob: Dict[str, float]):
        total = sum(name_prob.values())
        assert total <= 1.0 + 1e-9
        self.names = list(name_prob.keys()) + ['']
        self.probs = list(name_prob.values()) + [max(1.0 - total, 0.0)]

    def sample(self) -> str:
        return np.random.choice(self.names, p=self.probs)


class PoissonSampler:
    def __init__(self, lam: float = 3, min_val: int = 1, max_val: int = 8):
        self.lam, self.min_val, self.max_val = lam, min_val, max_val

    def sample(self) -> int:
        return int(np.clip(np.random.poisson(self.lam), self.min_val,
                           self.max_val))


class NormalSampler:
    def __init__(self, loc: float = 0.33, std: float = 0.2,
                 min_scale: float = 0.15, max_scale: float = 0.85,
                 scalar: float = 1, to_int: bool = True):
        self.loc, self.std = loc, std
        self.min_scale, self.max_scale = min_scale, max_scale
        self.scalar, self.to_int = scalar, to_int

    def sample(self):
        v = np.clip(np.random.normal(self.loc, self.std),
                    self.min_scale, self.max_scale) * self.scalar
        return int(round(v)) if self.to_int else v


class PersonBBoxSampler:
    """Layout sampler backed by COCO person-bbox statistics: picks a
    random image's person boxes and scales them to the canvas
    (reference sampler.py:60-155)."""

    def __init__(self, samples: Union[str, List]):
        if isinstance(samples, str):
            with open(samples) as f:
                samples = json.load(f)
        # samples: list of per-image lists of [x, y, w, h, im_w, im_h]
        self.samples = [s for s in samples if len(s) > 0]

    def sample(self, tgt_size: int, size_thres=(0.02, 0.85),
               max_boxes: int = 8) -> List[np.ndarray]:
        entry = random.choice(self.samples)
        boxes = []
        for b in entry[:max_boxes]:
            x, y, w, h, iw, ih = b[:6]
            s = tgt_size / max(iw, ih)
            bw, bh = w * s, h * s
            frac = max(bw, bh) / tgt_size
            if frac < size_thres[0] or frac > size_thres[1]:
                continue
            boxes.append(np.array([x * s, y * s, bw, bh], np.float32))
        return boxes


def load_image_any(path: str) -> Optional[np.ndarray]:
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    return img


def random_load_valid_fg(fg_list: Sequence[Union[str, Dict]],
                         max_tries: int = 20
                         ) -> Tuple[Optional[np.ndarray], Optional[Dict]]:
    """Load a random RGBA foreground with a usable alpha channel."""
    for _ in range(max_tries):
        info = random.choice(fg_list)
        path = info['path'] if isinstance(info, dict) else info
        img = load_image_any(path)
        if img is None or img.ndim != 3 or img.shape[2] != 4:
            continue
        if img[..., 3].max() == 0:
            continue
        return img, (info if isinstance(info, dict) else {'path': path})
    return None, None


def random_load_valid_bg(bg_list: Sequence[str], max_tries: int = 20
                         ) -> Optional[np.ndarray]:
    import cv2
    for _ in range(max_tries):
        img = load_image_any(random.choice(bg_list))
        if img is None:
            continue
        if img.ndim == 2:
            img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        if img.shape[2] == 4:
            img = cv2.cvtColor(img, cv2.COLOR_BGRA2BGR)
        return img
    return None

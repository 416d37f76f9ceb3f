"""Training observability hooks (port of
``cartoonsegmentation_tpu/parallel/hooks.py``).

Parity: reference utils/mmdet_custom_hooks.py:69-223
(InstanceSegVisualizationHook): before each validation pass, run the
current detector on a fixed sample directory, draw the predictions with
``Instances.draw``, tile them into one grid image and hand it to a
logging backend. One process trains, so there is no rank gate.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Callable, List, Optional

import numpy as np

from ..utils.io import find_all_imgs, imglist2grid
from ..utils.logger import LOGGER


class InstanceSegVisualizationHook:

    def __init__(self, sample_dir: str, out_dir: str = '',
                 grid_size: int = 416, max_samples: int = 16,
                 log_fn: Optional[Callable[[str, np.ndarray, int], None]]
                 = None):
        self.sample_dir = sample_dir
        self.out_dir = out_dir or osp.join(sample_dir, 'viz')
        self.grid_size = grid_size
        self.max_samples = max_samples
        self.log_fn = log_fn

    def before_val(self, detector, step: int) -> Optional[np.ndarray]:
        """detector: AnimeInsSeg-compatible (infer(img) → Instances)."""
        import cv2
        paths = find_all_imgs(self.sample_dir, abs_path=True)
        if not paths:
            LOGGER.warning(f'viz hook: no samples in {self.sample_dir}')
            return None
        drawn: List[np.ndarray] = []
        for p in paths[:self.max_samples]:
            img = cv2.imread(p)
            if img is None:
                continue
            ins = detector.infer(img)
            drawn.append(ins.draw(img))
        grid = imglist2grid(drawn, self.grid_size)
        if grid is None:
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        out = osp.join(self.out_dir, f'val_step{step}.jpg')
        cv2.imwrite(out, grid)
        if self.log_fn is not None:
            self.log_fn('val_samples', grid, step)
        LOGGER.info(f'viz hook: wrote {out}')
        return grid

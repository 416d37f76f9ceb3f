"""Experiment-tracking sink for the trainers (the port's own copy of
``cartoonsegmentation_tpu/utils/tracking.py``).

Parity: depth_modules/zoedepth/trainers/base_trainer.py:37-41,155-249
— the reference logs Train/* losses, Metrics/* eval numbers and
prediction images to wandb and accumulates them through
RunningAverageDict (zoedepth/utils/misc.py). Here the durable record
is a dependency-free ``metrics.jsonl`` (one JSON object per log
call: step, wall-clock, namespaced scalars) so runs are greppable
and diffable offline; wandb is mirrored opportunistically when it is
importable AND the caller opts in — never required, never a hard
dependency. Images (e.g. the viz-hook grids) land under
``<run_dir>/images/`` so one directory holds the whole run.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, Optional

import numpy as np

from .logger import LOGGER


class RunningAverageDict:
    """Accumulate dicts of scalars; ``value()`` is the running mean
    per key (reference zoedepth/utils/misc.py RunningAverageDict).
    Keys may appear late; each key averages over its own count."""

    def __init__(self):
        self._sum: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def update(self, new_dict: Optional[Dict[str, float]]) -> None:
        if not new_dict:
            return
        for k, v in new_dict.items():
            v = float(v)
            if not np.isfinite(v):
                continue
            self._sum[k] = self._sum.get(k, 0.0) + v
            self._n[k] = self._n.get(k, 0) + 1

    def value(self) -> Dict[str, float]:
        return {k: self._sum[k] / self._n[k] for k in self._sum}

    def __bool__(self) -> bool:
        return bool(self._sum)


class ExperimentTracker:
    """JSONL-first scalar/image sink.

    - ``log(scalars, step, prefix)`` appends one line to
      ``metrics.jsonl`` (flushed per call: a killed run keeps every
      logged step) and mirrors to wandb when active.
    - ``log_image(name, img_bgr, step)`` writes
      ``images/<name>_step<step>.jpg``; the signature matches the
      viz hook's ``log_fn`` callback (parallel/hooks.py).
    - ``config`` is written once to ``config.json`` (the reference
      passes flatten(config) to wandb.init, base_trainer.py:155).
    """

    def __init__(self, run_dir: str, config: Optional[dict] = None,
                 project: str = 'cartoonsegmentation_torch',
                 name: str = '', use_wandb: bool = False):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        os.makedirs(osp.join(run_dir, 'images'), exist_ok=True)
        self._f = open(osp.join(run_dir, 'metrics.jsonl'), 'a')
        self._t0 = time.time()
        self._wandb = None
        if config is not None:
            with open(osp.join(run_dir, 'config.json'), 'w') as f:
                json.dump({k: _jsonable(v) for k, v in config.items()},
                          f, indent=1, sort_keys=True)
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(
                    project=project, name=name or None, dir=run_dir,
                    config=config or {})
            except Exception as e:  # ImportError / offline / no key
                LOGGER.warning(f'wandb mirror disabled: {e}')
        LOGGER.info(f'tracking run in {run_dir}'
                    + (' (+wandb)' if self._wandb else ''))

    def log(self, scalars: Dict[str, float], step: int,
            prefix: str = '') -> None:
        row = {'step': int(step),
               'wall_s': round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            row[prefix + k] = _jsonable(v)
        self._f.write(json.dumps(row) + '\n')
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({prefix + k: v for k, v in scalars.items()},
                            step=int(step))

    def log_image(self, name: str, img_bgr: np.ndarray,
                  step: int) -> str:
        import cv2
        out = osp.join(self.run_dir, 'images',
                       f'{name}_step{step}.jpg')
        cv2.imwrite(out, img_bgr)
        if self._wandb is not None:
            import wandb
            self._wandb.log(
                {name: wandb.Image(img_bgr[..., ::-1])}, step=int(step))
        return out

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)

"""Danbooru tagger adapter (the SwinV2 WD tagger) — the PyTorch port
of ``cartoonsegmentation_tpu/models/tagger.py``.

Parity: reference utils/booru_tagger.py (Tagger.label_cv2_bgr runs
wd-v1-4-swinv2-tagger-v2 in onnxruntime, thresholds tags at 0.5 and
returns the character subset separately; make_square pads to a white
square at the original resolution, smart_resize then goes AREA when
shrinking / CUBIC when growing — booru_tagger.py:15-38).

Backends:
- 'torch': the port's SwinV2 (models/swinv2.py, attention kernel
           K15b) on the tagger's device, CUDA unless the caller asks
           for the CPU. Loads timm-format checkpoints
           (wd-swinv2-tagger-v3); 'flax', the JAX package's name for
           its native backend, is taken as 'torch'. Random weights
           from ``torch.Generator(seed)`` only with ``strict=False``.
- 'onnx':  the original model.onnx via onnxruntime when available, on
           the CPU only: a tagger on CUDA given a .onnx model or
           ``backend='onnx'`` raises and names the timm checkpoint
           route instead of running the net on the host.
- 'stub':  deterministic pseudo-tags, for tests only: reached only with
           an explicit ``strict=False``; by default a Tagger with no
           usable backend raises instead of fabricating tags.

The net is fed the raw BGR float image in [0, 255], unnormalised, as
the JAX version's ``_prep`` does. The tag CSV (selected_tags.csv next
to the model) follows the WD tagger format: columns name, category (0
general / 4 character / 9 rating)."""
from __future__ import annotations

import csv
import logging
import os.path as osp
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

LOGGER = logging.getLogger('cartoonsegmentation_torch')


def _load_tags(csv_path: str) -> Tuple[List[str], List[int]]:
    names, cats = [], []
    with open(csv_path, newline='', encoding='utf8') as f:
        for row in csv.DictReader(f):
            names.append(row['name'])
            cats.append(int(row.get('category', 0)))
    return names, cats


def make_square(img_bgr: np.ndarray, target_size: int) -> np.ndarray:
    """White-pad to a square of max(longest side, target_size)
    (booru_tagger.py:15-29)."""
    h, w = img_bgr.shape[:2]
    size = max(h, w, target_size)
    top = (size - h) // 2
    left = (size - w) // 2
    out = np.full((size, size, 3), 255, img_bgr.dtype)
    out[top:top + h, left:left + w] = img_bgr
    return out


def smart_resize(img: np.ndarray, size: int) -> np.ndarray:
    """AREA when shrinking, CUBIC when growing (booru_tagger.py:32-38)."""
    import cv2
    if img.shape[0] > size:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    if img.shape[0] < size:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
    return img


class Tagger:
    """label_cv2_bgr(img) → (tags, character_tags); like the reference,
    the first list includes the character tags too."""

    def __init__(self, model_path: str = '', backend: str = 'auto',
                 general_thr: float = 0.5, character_thr: float = 0.5,
                 input_size: int = 448,
                 swin_kwargs: Optional[dict] = None, seed: int = 0,
                 strict: bool = True, device=None):
        self.strict = strict
        self.general_thr = general_thr
        self.character_thr = character_thr
        self.input_size = input_size
        self.names: List[str] = []
        self.cats: List[int] = []
        self._sess = None
        self._net = None
        self.device = None
        backend = 'torch' if backend == 'flax' else backend
        self.backend = backend

        if model_path:
            csv_path = osp.join(osp.dirname(model_path),
                                'selected_tags.csv')
            if osp.exists(csv_path):
                self.names, self.cats = _load_tags(csv_path)

        is_onnx = bool(model_path) and model_path.endswith('.onnx')
        if backend == 'onnx' or (backend == 'auto' and is_onnx):
            # onnxruntime runs the net on the host: only a tagger asked
            # for on the CPU may take it, never one meant for the card
            self.device = resolve_device(device)
            if self.device.type != 'cpu':
                raise RuntimeError(
                    f'Tagger on {self.device}: the onnx backend runs on '
                    'the CPU only; to run on the card, pass the timm '
                    'checkpoint of wd-swinv2-tagger-v3 saved as a torch '
                    "state_dict (model.pth), with backend 'torch' or "
                    "'auto'")
            if is_onnx and osp.exists(model_path):
                try:
                    import onnxruntime as ort
                    self._sess = ort.InferenceSession(
                        model_path, providers=['CPUExecutionProvider'])
                    self.backend = 'onnx'
                    return
                except ImportError:
                    LOGGER.warning('onnxruntime unavailable')
        if backend == 'onnx' and self._sess is None:
            raise RuntimeError('onnx backend requested but unavailable')

        has_ckpt = bool(model_path) and not model_path.endswith('.onnx') \
            and osp.exists(model_path)
        if backend == 'torch' or (backend == 'auto' and has_ckpt):
            from .swinv2 import SwinV2, init_swinv2_, load_swinv2_state_dict
            kw = dict(swin_kwargs or {})
            if self.names and 'num_classes' not in kw:
                kw['num_classes'] = len(self.names)
            net = SwinV2(**kw)
            if has_ckpt:
                load_swinv2_state_dict(net, torch.load(
                    model_path, map_location='cpu', weights_only=False))
            else:
                if self.strict:
                    raise RuntimeError(
                        'Tagger(strict=True): torch backend has no '
                        'checkpoint to load — random weights would '
                        'fabricate tags.')
                LOGGER.warning('Tagger: RANDOM SwinV2 init (no checkpoint)')
                init_swinv2_(net, torch.Generator().manual_seed(seed))
            self.device = resolve_device(device)
            self._net = net.to(self.device).eval()
            self.backend = 'torch'
            return

        if self.strict:
            raise RuntimeError(
                'Tagger(strict=True): no usable model backend — '
                f'model_path={model_path!r}, backend={backend!r}. '
                'The deterministic stub would fabricate tags; pass '
                'strict=False only for plumbing tests.')
        self.backend = 'stub'
        LOGGER.warning('Tagger: using deterministic stub backend '
                       '(no model available)')

    # ------------------------------------------------------------------
    def _prep(self, img_bgr: np.ndarray) -> np.ndarray:
        img = make_square(img_bgr, self.input_size)
        img = smart_resize(img, self.input_size)
        return img[None].astype(np.float32)

    @torch.inference_mode()
    def probs(self, x: np.ndarray) -> np.ndarray:
        """Sigmoid of the net's logits for a prepared (B, S, S, 3) batch."""
        x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return torch.sigmoid(self._net(x)).cpu().numpy()

    def _split(self, probs: Sequence[float]
               ) -> Tuple[List[str], List[str]]:
        tags, character = [], []
        for p, name, cat in zip(probs, self.names, self.cats):
            if cat == 9:          # rating rows are never tag output
                continue
            if p > self.general_thr:
                tags.append(name)
                if cat == 4 and p > self.character_thr:
                    character.append(name)
        return tags, character

    def label_cv2_bgr(self, img_bgr: np.ndarray
                      ) -> Tuple[List[str], List[str]]:
        if self.backend == 'onnx' and self._sess is not None:
            x = self._prep(img_bgr)
            inp = self._sess.get_inputs()[0].name
            probs = self._sess.run(None, {inp: x})[0][0]
            return self._split(probs)

        if self.backend == 'torch':
            probs = self.probs(self._prep(img_bgr))[0]
            if not self.names:
                self.names = [f'tag_{i}' for i in range(len(probs))]
                self.cats = [0] * len(probs)
            return self._split(probs)

        # stub: deterministic tags from image statistics, so prompts
        # and caching behave end-to-end without any model
        mean = img_bgr.reshape(-1, img_bgr.shape[-1]).mean(0)
        tone = ['dark', 'muted', 'bright'][int(mean.mean() // 86)]
        hue = ['blue_theme', 'green_theme', 'red_theme'][
            int(np.argmax(mean))]
        return [f'{tone}', f'{hue}', 'solo'], []

"""Training datasets: COCO-backed detection data with ignore-mask
support, mosaic/mixup mixing, and the mask-refinement dataset (the
port's own copy of ``cartoonsegmentation_tpu/data/dataset.py``; batches
stay numpy, the trainer moves them to the device).

Parity targets (reference animeinsseg/data/dataset.py):
- AnimeMangaMixedDataset (:20-108): concatenate several COCO files
  (e.g. AnimeIns + Manga109) into one index space
- LoadAnnotationsNoSegs / PackDetIputsNoSeg (:160-344): bbox-only
  instances carry an ``ignore_mask`` flag that the mask loss skips
- CachedMosaicNoSeg / CachedMixUpNoSeg (:393, :768): mosaic and
  mix-up that propagate the ignore flags
- MaskRefineDataset (maskrefine_dataset.py:57-199): (image + degraded
  coarse mask) → gt mask pairs for training the ISNet refiner

Output batches are padded to static shapes (max_instances) for the
train step in parallel/train.py.
"""
from __future__ import annotations

import json
import os.path as osp
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import rle as rle_codec


class CocoSource:
    """One COCO json + image root."""

    def __init__(self, ann_file: str, img_root: str,
                 source_name: str = ''):
        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im['id']: im for im in coco['images']}
        self.anns_by_img: Dict[int, List] = {i: [] for i in self.images}
        for a in coco['annotations']:
            if a['image_id'] in self.anns_by_img:
                self.anns_by_img[a['image_id']].append(a)
        self.ids = list(self.images.keys())
        self.img_root = img_root
        self.source_name = source_name or osp.basename(ann_file)

    def __len__(self):
        return len(self.ids)

    def load(self, idx: int):
        img_id = self.ids[idx]
        meta = self.images[img_id]
        import cv2
        img = cv2.imread(osp.join(self.img_root, meta['file_name']))
        anns = self.anns_by_img[img_id]
        boxes, masks, ignore = [], [], []
        h, w = meta['height'], meta['width']
        for a in anns:
            x, y, bw, bh = a['bbox']
            boxes.append([x, y, x + bw, y + bh])
            seg = a.get('segmentation')
            if seg and isinstance(seg, dict):
                masks.append(rle_codec.decode(seg))
                ignore.append(bool(a.get('ignore_mask', False)))
            else:
                # bbox-only instance → mask loss must ignore it
                m = np.zeros((h, w), bool)
                m[int(y):int(y + bh), int(x):int(x + bw)] = True
                masks.append(m)
                ignore.append(True)
        return {
            'image': img,
            'boxes': np.asarray(boxes, np.float32).reshape(-1, 4),
            'masks': (np.stack(masks) if masks
                      else np.zeros((0, h, w), bool)),
            'ignore': np.asarray(ignore, bool),
            'image_id': img_id,
            'source': self.source_name,
        }


class MixedDetDataset:
    """Concatenation of CocoSources (AnimeMangaMixedDataset parity)
    with resize-to-square + optional mosaic/mixup mixing."""

    def __init__(self, sources: Sequence[CocoSource], img_size: int = 640,
                 mosaic_prob: float = 0.5, mixup_prob: float = 0.3,
                 max_instances: int = 16, train: bool = True):
        self.sources = list(sources)
        self.cum = np.cumsum([len(s) for s in self.sources])
        self.img_size = img_size
        self.mosaic_prob = mosaic_prob if train else 0.0
        self.mixup_prob = mixup_prob if train else 0.0
        self.max_instances = max_instances
        self.train = train

    def __len__(self):
        return int(self.cum[-1]) if len(self.cum) else 0

    def _load(self, idx: int):
        si = int(np.searchsorted(self.cum, idx, side='right'))
        base = 0 if si == 0 else int(self.cum[si - 1])
        return self.sources[si].load(idx - base)

    # -- geometric ops ---------------------------------------------------
    def _resize_sample(self, s: Dict, size: int) -> Dict:
        import cv2
        img = s['image']
        h, w = img.shape[:2]
        scale = size / max(h, w)
        nh, nw = int(round(h * scale)), int(round(w * scale))
        canvas = np.full((size, size, 3), 114, np.uint8)
        canvas[:nh, :nw] = cv2.resize(img, (nw, nh))
        masks = np.zeros((len(s['masks']), size, size), bool)
        for i, m in enumerate(s['masks']):
            mr = cv2.resize(m.astype(np.uint8), (nw, nh)) > 0
            masks[i, :nh, :nw] = mr
        return {**s, 'image': canvas, 'boxes': s['boxes'] * scale,
                'masks': masks}

    def _mosaic(self, idx: int) -> Dict:
        """2x2 mosaic with ignore propagation (CachedMosaicNoSeg)."""
        size = self.img_size
        half = size // 2
        idxs = [idx] + [random.randrange(len(self)) for _ in range(3)]
        canvas = np.full((size, size, 3), 114, np.uint8)
        boxes, masks, ignore = [], [], []
        for k, i in enumerate(idxs):
            s = self._resize_sample(self._load(i), half)
            oy, ox = (k // 2) * half, (k % 2) * half
            canvas[oy:oy + half, ox:ox + half] = s['image']
            if len(s['boxes']):
                b = s['boxes'] + np.array([ox, oy, ox, oy], np.float32)
                boxes.append(b)
                pm = np.zeros((len(s['masks']), size, size), bool)
                pm[:, oy:oy + half, ox:ox + half] = s['masks']
                masks.append(pm)
                ignore.append(s['ignore'])
        return {
            'image': canvas,
            'boxes': (np.concatenate(boxes) if boxes
                      else np.zeros((0, 4), np.float32)),
            'masks': (np.concatenate(masks) if masks
                      else np.zeros((0, size, size), bool)),
            'ignore': (np.concatenate(ignore) if ignore
                       else np.zeros((0,), bool)),
        }

    def _mixup(self, a: Dict) -> Dict:
        """50/50 blend with a random other sample (CachedMixUpNoSeg)."""
        b = self._resize_sample(self._load(random.randrange(len(self))),
                                self.img_size)
        img = (a['image'].astype(np.float32) * 0.5 +
               b['image'].astype(np.float32) * 0.5).astype(np.uint8)
        return {
            'image': img,
            'boxes': np.concatenate([a['boxes'], b['boxes']]),
            'masks': np.concatenate([a['masks'], b['masks']]),
            'ignore': np.concatenate([a['ignore'], b['ignore']]),
        }

    def __getitem__(self, idx: int) -> Dict:
        if random.random() < self.mosaic_prob:
            s = self._mosaic(idx)
        else:
            s = self._resize_sample(self._load(idx), self.img_size)
        if random.random() < self.mixup_prob:
            s = self._mixup(s)
        return self._pad(s)

    def _pad(self, s: Dict) -> Dict:
        """Pad to static max_instances for the train step."""
        n = min(len(s['boxes']), self.max_instances)
        size = self.img_size
        boxes = np.zeros((self.max_instances, 4), np.float32)
        masks = np.zeros((self.max_instances, size, size), bool)
        ignore = np.zeros((self.max_instances,), bool)
        valid = np.zeros((self.max_instances,), bool)
        boxes[:n] = s['boxes'][:n]
        masks[:n] = s['masks'][:n]
        ignore[:n] = s['ignore'][:n]
        valid[:n] = True
        # Reference semantics (rtmdet_inshead_custom.py:186-248):
        # bbox-only (``ignore_mask``) instances DO supervise cls/bbox —
        # they stay in gt_valid; only the mask loss skips them (the
        # train step reads gt_ignore for that).
        return {
            'images': s['image'].astype(np.float32) / 255.0,
            'gt_boxes': boxes, 'gt_masks': masks,
            'gt_valid': valid, 'gt_ignore': ignore,
        }

    def batches(self, batch_size: int, steps: int):
        """Simple host-side batch iterator."""
        for _ in range(steps):
            idxs = [random.randrange(len(self)) for _ in range(batch_size)]
            samples = [self[i] for i in idxs]
            yield {k: np.stack([s[k] for s in samples])
                   for k in samples[0]}


class MaskRefineDataset:
    """(image + degraded coarse mask, gt mask) pairs
    (maskrefine_dataset.py:57-199). Degradations: dilate/erode with
    random rectangles, blur, dropout blocks."""

    def __init__(self, source: CocoSource, input_size: int = 720,
                 train: bool = True):
        self.source = source
        self.input_size = input_size
        self.train = train
        # flatten to per-instance index
        self.items: List[Tuple[int, int]] = []
        for i in range(len(source)):
            for j, a in enumerate(
                    source.anns_by_img[source.ids[i]]):
                if isinstance(a.get('segmentation'), dict):
                    self.items.append((i, j))

    def __len__(self):
        return len(self.items)

    def _degrade(self, mask: np.ndarray) -> np.ndarray:
        import cv2
        m = mask.astype(np.uint8) * 255
        k = random.choice((3, 5, 9, 15))
        el = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        if random.random() < 0.5:
            m = cv2.dilate(m, el)
        else:
            m = cv2.erode(m, el)
        # random rectangle add/remove
        h, w = m.shape
        for _ in range(random.randint(0, 3)):
            rh, rw = random.randint(4, h // 4), random.randint(4, w // 4)
            y0, x0 = random.randint(0, h - rh), random.randint(0, w - rw)
            m[y0:y0 + rh, x0:x0 + rw] = 255 if random.random() < 0.5 else 0
        m = cv2.GaussianBlur(m, (9, 9), 3)
        return m.astype(np.float32) / 255.0

    def __getitem__(self, idx: int) -> Dict:
        import cv2
        i, j = self.items[idx]
        sample = self.source.load(i)
        mask = sample['masks'][j]
        img = sample['image']
        s = self.input_size
        img = cv2.resize(img, (s, s))
        gt = cv2.resize(mask.astype(np.uint8), (s, s)) > 0
        coarse = self._degrade(gt) if self.train \
            else gt.astype(np.float32)
        x = np.concatenate([img.astype(np.float32) / 255.0,
                            coarse[..., None]], -1)
        return {'input': x, 'target': gt.astype(np.float32)}

"""Synthetic anime-COCO dataset generator (the port's own copy of
``cartoonsegmentation_tpu/data/syndataset.py``: one seed writes the
same images and annotation JSON as the JAX package).

Parity: reference animeinsseg/data/syndataset.py:20-213
(syn_animecoco_dataset): composite transparent character foregrounds
onto backgrounds with one of three layout policies, optional color
correction (hist match / k-means quantize), export COCO json with RLE
masks. Per-sample failures are logged and skipped, like the
reference's try/except-continue loop (:197-199).
"""
from __future__ import annotations

import json
import os
import os.path as osp
import random
import traceback
from typing import Dict, List, Optional

import numpy as np

from ..utils import LOGGER
from ..utils.constants import CATEGORIES, IMAGE_ID_ZFILL
from . import rle as rle_codec
from .augment import (bg_transform, fg_transform, fgbg_hist_matching,
                      quantize_image, resize2height, rotate_image)
from .paste import bbox_paste, partition_paste, regular_paste
from .samplers import (NameSampler, NormalSampler, PersonBBoxSampler,
                       PoissonSampler, random_load_valid_bg,
                       random_load_valid_fg)


def compose_sample(bg: np.ndarray, fgs: List[np.ndarray], method: str,
                   boxes=None):
    if method == 'regular':
        return regular_paste(bg, fgs)
    if method == 'personbbox' and boxes:
        return bbox_paste(bg, fgs, boxes)
    return partition_paste(bg, fgs)


def syn_animecoco_dataset(
        bg_list: List[str], fg_info_list: List[Dict],
        dataset_save_dir: str, policy: str = 'train', tgt_size: int = 640,
        syn_num_multiplier: float = 2.5, regular_paste_prob: float = 0.4,
        person_paste_prob: float = 0.4, max_syn_num: int = -1,
        image_id_start: int = 0, obj_id_start: int = 0,
        hist_match_prob: float = 0.2, quantize_prob: float = 0.25,
        person_bbox_samples: Optional[str] = None,
        seed: Optional[int] = None) -> str:
    """Generate the dataset; returns the annotation json path."""
    import cv2
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)

    LOGGER.info(f'syn data policy: {policy} '
                f'bg={len(bg_list)} fg={len(fg_info_list)}')
    is_train = policy == 'train'
    numfg_sampler = PoissonSampler(lam=2.5, min_val=1, max_val=9)
    numfg_reg_sampler = PoissonSampler(lam=3.5, min_val=2, max_val=9)
    size_sampler = NormalSampler(scalar=tgt_size, to_int=True,
                                 max_scale=0.75)
    color_sampler = NameSampler({'hist_match': hist_match_prob,
                                 'quantize': quantize_prob})
    pbs = None
    if person_bbox_samples and osp.exists(person_bbox_samples):
        pbs = PersonBBoxSampler(person_bbox_samples)
    method_probs = {'regular': regular_paste_prob,
                    'partition': 1 - regular_paste_prob - person_paste_prob}
    if pbs is not None:
        method_probs['personbbox'] = person_paste_prob
    method_sampler = NameSampler(method_probs)

    img_dir = osp.join(dataset_save_dir, policy)
    ann_dir = osp.join(dataset_save_dir, 'annotations')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    if not fg_info_list:
        raise ValueError('syn_animecoco_dataset: empty fg_info_list')
    syn_num = int(syn_num_multiplier * len(fg_info_list))
    if max_syn_num > 0:
        syn_num = min(syn_num, max_syn_num)
    qualities = [75, 85, 95] if is_train else [95]

    image_id = image_id_start + 1
    obj_id = obj_id_start + 1
    annotations, images_meta = [], []

    for si in range(syn_num):
        try:
            bg = random_load_valid_bg(bg_list)
            if bg is None:
                continue
            bg = bg_transform(bg, tgt_size, is_train)

            method = method_sampler.sample() or 'partition'
            # one color-correction draw per IMAGE (reference
            # syndataset.py draws color_correct once per sample)
            cc = color_sampler.sample()
            boxes = None
            if method == 'personbbox' and pbs is not None:
                boxes = pbs.sample(tgt_size)
                nfg = max(len(boxes), 1)
            elif method == 'regular':
                nfg = numfg_reg_sampler.sample()
            else:
                nfg = numfg_sampler.sample()

            fgs = []
            for _ in range(nfg):
                fg, _info = random_load_valid_fg(fg_info_list)
                if fg is None:
                    continue
                fg = fg_transform(fg, tgt_size, is_train)
                if is_train and random.random() < 0.1:
                    fg = rotate_image(fg, random.uniform(-25, 25))
                h = size_sampler.sample()
                fg = resize2height(fg, max(h, 16))
                if cc == 'hist_match':
                    fg = fgbg_hist_matching(fg, bg)
                fgs.append(fg)
            if not fgs:
                continue

            canvas, masks = compose_sample(bg, fgs, method, boxes)
            if cc == 'quantize':
                # reference quantizes the WHOLE composited image with
                # k in {12,16,32} to unify fg/bg palettes
                # (syndataset.py:131-134)
                canvas, _, _ = quantize_image(
                    canvas, random.choice((12, 16, 32)))
            # occlusion resolution: compose_sample pastes in list
            # order, so later foregrounds cover earlier ones — each
            # mask keeps only its VISIBLE pixels, and mostly-hidden
            # instances are dropped (reference resolves this via the
            # panoptic id map + <25% visibility cull,
            # syndataset.py:137-156)
            resolved = []
            for i, m in enumerate(masks):
                vis = np.asarray(m).astype(bool)
                area = float(vis.sum())
                for later in masks[i + 1:]:
                    vis = vis & ~np.asarray(later).astype(bool)
                if area >= 16 and float(vis.sum()) >= 0.25 * area:
                    resolved.append(vis)
            masks = [m for m in resolved if m.sum() >= 16]
            if not masks:
                continue

            name = str(image_id).zfill(IMAGE_ID_ZFILL) + '.jpg'
            q = random.choice(qualities)
            cv2.imwrite(osp.join(img_dir, name), canvas,
                        [int(cv2.IMWRITE_JPEG_QUALITY), q])
            images_meta.append({'id': image_id, 'height': tgt_size,
                                'width': tgt_size, 'file_name': name})
            for m in masks:
                ys, xs = np.nonzero(m)
                x0, y0 = int(xs.min()), int(ys.min())
                bw, bh = int(xs.max() - x0 + 1), int(ys.max() - y0 + 1)
                annotations.append({
                    'id': obj_id, 'image_id': image_id,
                    'category_id': 0, 'iscrowd': 0,
                    'bbox': [x0, y0, bw, bh],
                    'area': int(m.sum()),
                    'segmentation': rle_codec.encode(m),
                })
                obj_id += 1
            image_id += 1
        except Exception:
            LOGGER.warning('syn sample failed:\n' + traceback.format_exc())
            continue

    ann_path = osp.join(ann_dir, f'{policy}.json')
    with open(ann_path, 'w') as f:
        json.dump({'info': {}, 'licenses': [], 'images': images_meta,
                   'annotations': annotations,
                   'categories': CATEGORIES}, f)
    LOGGER.info(f'{len(images_meta)} images, {len(annotations)} '
                f'annotations -> {ann_path}')
    return ann_path

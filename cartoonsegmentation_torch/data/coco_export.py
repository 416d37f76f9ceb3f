"""COCO-format export (the port's own copy of
``cartoonsegmentation_tpu/data/coco_export.py``). Parity: reference
utils/io_utils.py:327-352 (mask2rle) and animeinsseg/__init__.py:
586-621."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import rle as rle_codec


def mask2rle(mask: np.ndarray) -> Dict:
    """Binary mask → COCO compressed RLE."""
    return rle_codec.encode(np.asarray(mask) > 0)


def rle2mask(rle: Dict) -> np.ndarray:
    return rle_codec.decode(rle)


def instances_to_coco(instances, image_id: int, file_name: str,
                      hw: Tuple[int, int], obj_id_start: int = 0,
                      tags: Optional[List[str]] = None
                      ) -> Tuple[Dict, List[Dict]]:
    """Instances (on any device) → (image record, annotations of the
    valid slots, in slot order)."""
    masks = instances.masks.cpu().numpy()
    bboxes = instances.bboxes.cpu().numpy()
    scores = instances.scores.cpu().numpy()
    valid = instances.valid.cpu().numpy()
    h, w = hw
    image_meta = {'id': image_id, 'height': h, 'width': w,
                  'file_name': file_name}
    anns = []
    oid = obj_id_start
    for i in range(len(valid)):
        if not valid[i]:
            continue
        m = masks[i]
        anns.append({
            'id': oid, 'category_id': 0, 'iscrowd': 0,
            'score': float(scores[i]),
            'segmentation': mask2rle(m),
            'image_id': image_id,
            'area': int(m.sum()),
            'tag_string': (tags[i] if tags and i < len(tags) else ''),
            'tag_string_character': '',
            'bbox': [float(x) for x in bboxes[i]],
        })
        oid += 1
    return image_meta, anns

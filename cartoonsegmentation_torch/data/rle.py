"""COCO compressed RLE in numpy (the port's own copy of
``cartoonsegmentation_tpu/data/rle.py``): column-major runs starting
with a 0-run, delta-coded from the third run on in COCO's modified
LEB128 (5 bits a char, offset 48), so the strings are pycocotools'."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def _counts_from_mask(mask: np.ndarray) -> List[int]:
    """Column-major (Fortran) run lengths, starting with a 0-run."""
    flat = np.asarray(mask, np.uint8).flatten(order='F')
    if flat.size == 0:
        return []
    change = np.nonzero(np.diff(flat))[0] + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()
    return [0] + runs if flat[0] == 1 else runs


def _mask_from_counts(counts: List[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order='F').astype(bool)


def _encode_counts(counts: List[int]) -> str:
    s = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c & 0x10)) or
                        (x == -1 and (c & 0x10)))
            if more:
                c |= 0x20
            s.append(chr(c + 48))
    return ''.join(s)


def _decode_counts(s: str) -> List[int]:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def encode(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask → {'size': [H, W], 'counts': str}."""
    h, w = mask.shape
    return {'size': [int(h), int(w)],
            'counts': _encode_counts(_counts_from_mask(mask))}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, bytes):
        counts = counts.decode('ascii')
    if isinstance(counts, str):
        counts = _decode_counts(counts)
    return _mask_from_counts(counts, h, w)


def area(rle: Dict) -> int:
    """The mask's pixel count, from its run lengths."""
    counts = rle['counts']
    if isinstance(counts, (str, bytes)):
        counts = _decode_counts(counts if isinstance(counts, str)
                                else counts.decode('ascii'))
    return int(sum(counts[1::2]))


def iou(rle_a: Dict, rle_b: Dict) -> float:
    """Intersection over union of two masks (0 for two empty ones)."""
    a, b = decode(rle_a), decode(rle_b)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)

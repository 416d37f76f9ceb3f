"""I/O helpers (port of ``cartoonsegmentation_tpu/utils/io.py``): file
listing, json and pickle round trips, image grids, and the base64 PNG
codecs of the sd-webui seam.

The JAX package encodes with PIL; the port uses cv2's PNG codec, with
the channel order swapped explicitly (RGB ↔ BGR, RGBA ↔ BGRA) so the
arrays are RGB(A) as PIL gives them; 2-D arrays stay grey. PNG is
lossless, so both packages decode each other's strings to the same
arrays (the base64 strings themselves differ).
"""
from __future__ import annotations

import base64
import json
import os
import os.path as osp
import pickle
from typing import Dict, List, Optional

import numpy as np

IMG_EXT = {'.bmp', '.jpg', '.jpeg', '.png', '.webp'}


def find_all_imgs(img_dir: str, abs_path: bool = False) -> List[str]:
    """The image files of ``img_dir`` (by extension), sorted by name;
    joined to the directory with ``abs_path``."""
    return [osp.join(img_dir, f) if abs_path else f
            for f in sorted(os.listdir(img_dir))
            if osp.splitext(f)[1].lower() in IMG_EXT]


def json2dict(path: str) -> Dict:
    with open(path, 'r', encoding='utf8') as f:
        return json.load(f)


def dict2json(obj: Dict, path: str) -> None:
    with open(path, 'w', encoding='utf8') as f:
        json.dump(obj, f, ensure_ascii=False)


def load_pickle(path: str):
    with open(path, 'rb') as f:
        return pickle.load(f)


def save_pickle(obj, path: str) -> None:
    with open(path, 'wb') as f:
        pickle.dump(obj, f)


def imglist2grid(imgs: List[np.ndarray], grid_size: int = 416,
                 ncols: Optional[int] = None) -> Optional[np.ndarray]:
    """The images tiled into a grid of ``grid_size`` cells (each fitted
    into its cell, top-left), ``ncols`` columns (a square grid by
    default); None for no images."""
    import cv2
    if not imgs:
        return None
    n = len(imgs)
    if ncols is None:
        ncols = int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    cell = grid_size
    canvas = np.zeros((nrows * cell, ncols * cell, 3), np.uint8)
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        s = cell / max(h, w)
        nh, nw = int(h * s), int(w * s)
        r = cv2.resize(im, (nw, nh))
        y, x = (i // ncols) * cell, (i % ncols) * cell
        canvas[y:y + nh, x:x + nw] = r if r.ndim == 3 \
            else r[..., None].repeat(3, -1)
    return canvas


def _swap(img: np.ndarray) -> np.ndarray:
    """RGB ↔ BGR and RGBA ↔ BGRA; grey unchanged."""
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        order = [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])
        return np.ascontiguousarray(img[..., order])
    return img


def img2b64(img: np.ndarray) -> str:
    """RGB, RGBA or grey uint8 array → base64 PNG string."""
    import cv2
    ok, buf = cv2.imencode('.png', _swap(np.asarray(img)))
    if not ok:
        raise ValueError(f'cv2 could not encode an array of shape '
                         f'{np.shape(img)} and dtype {np.asarray(img).dtype}')
    return base64.b64encode(buf.tobytes()).decode('utf-8')


def b64_2img(b64: str) -> np.ndarray:
    """base64 PNG (or any image cv2 reads) → RGB, RGBA or grey array."""
    import cv2
    raw = np.frombuffer(base64.b64decode(b64), np.uint8)
    img = cv2.imdecode(raw, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError('cv2 could not decode the base64 image')
    return _swap(img)


def save_encoded_image(b64_image: str, output_path: str) -> None:
    with open(output_path, 'wb') as f:
        f.write(base64.b64decode(b64_image))

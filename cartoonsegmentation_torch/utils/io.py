"""Base64 PNG codecs of the sd-webui seam (port of
``cartoonsegmentation_tpu/utils/io.py:img2b64`` / ``b64_2img`` /
``save_encoded_image``).

The JAX package encodes with PIL; the port uses cv2's PNG codec, with
the channel order swapped explicitly (RGB ↔ BGR, RGBA ↔ BGRA) so the
arrays are RGB(A) as PIL gives them; 2-D arrays stay grey. PNG is
lossless, so both packages decode each other's strings to the same
arrays (the base64 strings themselves differ).
"""
from __future__ import annotations

import base64

import numpy as np


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

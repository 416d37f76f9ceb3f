"""Category list, colour palette, tags and checkpoint paths (the port's
own copy of ``cartoonsegmentation_tpu/utils/constants.py``): the
palette colours the drawn instances, the categories the COCO export."""
from __future__ import annotations

CATEGORIES = [
    {"id": 0, "name": "object", "isthing": 1},
]

# zero-padded width of a synthetic image's file name (its COCO id)
IMAGE_ID_ZFILL = 12

# Ultralytics-style palette for per-instance colours when drawing
_HEXS = (
    'FF1010', '10FF10', 'FFF010', '100FFF', '0018EC', 'FF3838', 'FF9D97',
    'FF701F', 'FFB21D', 'CFD231', '48F90A', '92CC17', '3DDB86', '1A9334',
    '00D4BB', '2C99A8', '00C2FF', '344593', '6473FF', '0018EC', '8438FF',
    '520085', 'CB38FF', 'FF95C8', 'FF37C7',
)


def _hex2rgb(h: str):
    return tuple(int(h[i:i + 2], 16) for i in (0, 2, 4))


PALETTE = [_hex2rgb(c) for c in _HEXS]


def get_color(idx: int, bgr: bool = True):
    """Colour of instance ``idx`` (BGR by default, as cv2 draws)."""
    if idx == -1:
        return (255, 255, 255)
    c = PALETTE[int(idx) % len(PALETTE)]
    return (c[2], c[1], c[0]) if bgr else c


MULTIPLE_TAGS = {
    '2girls', '3girls', '4girls', '5girls', '6+girls', 'multiple_girls',
    '2boys', '3boys', '4boys', '5boys', '6+boys', 'multiple_boys',
    '2others', '3others', '4others', '5others', '6+others', 'multiple_others',
}

# default checkpoint locations (the published torch checkpoints)
DEFAULT_DETECTOR_CKPT = 'models/AnimeInstanceSegmentation/rtmdetl_e60.ckpt'
DEFAULT_DEPTHREFINE_CKPT = \
    'models/AnimeInstanceSegmentation/kenburns_depth_refinenet.ckpt'
DEFAULT_INPAINTNET_CKPT = \
    'models/AnimeInstanceSegmentation/kenburns_inpaintnet.ckpt'
DEPTH_ZOE_CKPT = 'models/AnimeInstanceSegmentation/ZoeD_M12_N.pt'

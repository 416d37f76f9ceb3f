from .image import (  # noqa: F401
    bgr_to_i420, crop_center_resize, i420_to_bgr_host, resize_bilinear,
    resize_bilinear_aa, resize_bilinear_ac, scaledown_maxsize,
    scaledown_size)
from .profiling import StageTimer, trace  # noqa: F401

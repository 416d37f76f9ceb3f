"""Host helpers of the port (its own copies of
``cartoonsegmentation_tpu/utils``: logger, constants, image and I/O
helpers). ``set_multi_processing``, ``save_params`` and ``load_params``
of the JAX package are not ported yet (ROADMAP.md)."""
from .logger import LOGGER, set_logging  # noqa: F401
from .constants import (  # noqa: F401
    CATEGORIES, PALETTE, get_color, MULTIPLE_TAGS,
    DEFAULT_DETECTOR_CKPT, DEFAULT_DEPTHREFINE_CKPT,
    DEFAULT_INPAINTNET_CKPT, DEPTH_ZOE_CKPT,
)
from .image import (  # noqa: F401
    bgr_to_i420, crop_center_resize, i420_to_bgr_host, pad2divisor,
    resize_bilinear, resize_bilinear_aa, resize_bilinear_ac, resize_pad,
    scaledown_maxsize, scaledown_size, square_pad_resize, to_float_chw)
from .io import (  # noqa: F401
    find_all_imgs, json2dict, dict2json, load_pickle, save_pickle, img2b64,
    b64_2img, imglist2grid, save_encoded_image,
)
from .profiling import StageTimer, trace  # noqa: F401

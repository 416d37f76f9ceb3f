"""The port's nets (the JAX package's ``models`` names; where the port's
function has another name, an alias)."""
from .rtmdet import AnimeDetector, postprocess  # noqa: F401
from .kenburns import (  # noqa: F401
    Disparity, DisparityEstimator, Inpaint, Refine, Semantics,
)
from .isnet import ISNetDIS  # noqa: F401
from .u2net import ISNetGTEncoder, U2Net  # noqa: F401
from .modnet import MODNet  # noqa: F401
from .leres import LeReS  # noqa: F401
from .zoedepth import ZoeDepth, infer_zoe  # noqa: F401
from .swinv2 import SwinV2, convert_swinv2, wd_tagger_swinv2  # noqa: F401
from .tagger import Tagger  # noqa: F401

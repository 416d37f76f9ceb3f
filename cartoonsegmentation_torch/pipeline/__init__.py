"""The port's pipelines (the JAX package's ``pipeline`` names)."""
from .state import KenBurnsState, PointCloud  # noqa: F401
from .kenburns import (KenBurnsPipeline, stream_video,  # noqa: F401
                       write_video)
from .segment import AnimeInsSeg  # noqa: F401
from .sam import NativeSAM, SamDetector  # noqa: F401
from .maskrcnn_det import MaskRCNNDetector  # noqa: F401
from .depth import adjust_disparity_by_instances, colorize_gray_r  # noqa: F401

"""Tensor ops of the port. Hand-written CUDA kernels (``csrc/*.cu``,
built by ``_cuda.py``) sit behind wrappers that run their plain
PyTorch version for CPU tensors: here K1 ``pointcloud.splat``, K2
``pointcloud.coverage``, K3 ``discfill3.fill_disocclusion``, K4
``bokeh.bokeh_core``, K7 ``filters.median_filter`` /
``laplacian_filter``, K11 ``discfill.fill_disocclusion`` and K12a
``crf.kmeans_labels`` / K12b ``crf.crf_step``, K13a
``inpaint_fill.push_pull_fill`` and K13b ``inpaint_fill.jitter_refine``;
elsewhere
K5a ``utils/image.py:frame_epilogue``, K5b and K6 in
``pipeline/depth.py``, K8 and K9 in ``models/rtmdet.py``, K10 in
``pipeline/state.py``, K14a and K14b in ``models/maskrcnn.py``, K15a
in ``models/sam.py`` and K15b in ``models/swinv2.py``. The package
exports the JAX package's ``ops`` names; K3's wrapper is also
``fill_disocclusion_fast3`` and K2's ``render_coverage_fast``."""
from .filters import (  # noqa: F401
    spatial_filter, laplacian_filter, median_filter, valid_depth_mask,
)
from .pointcloud import (  # noqa: F401
    depth_to_points, render_pointcloud, render_coverage,
    render_coverage_fast, degrid,
)
from .inpaint_fill import push_pull_fill, jitter_refine  # noqa: F401
from .discfill import (  # noqa: F401
    fill_disocclusion, fill_disocclusion_fast,
)
from .discfill3 import (  # noqa: F401
    fill_disocclusion as fill_disocclusion_fast3,
)
from .bokeh import bokeh_blur, bokeh_pass, bokeh_weight_field  # noqa: F401
from .camera import (  # noqa: F401
    DepthRange, depth_range, compute_shift, shift_points, autozoom,
)

"""Tensor ops of the port. Hand-written CUDA kernels (``csrc/*.cu``,
built by ``_cuda.py``) sit behind wrappers that run their plain
PyTorch version for CPU tensors: here K1 ``pointcloud.splat``, K2
``pointcloud.coverage``, K3 ``discfill3.fill_disocclusion``, K4
``bokeh.bokeh_core``, K7 ``filters.median_filter`` /
``laplacian_filter``, K11 ``discfill.fill_disocclusion`` and K12a
``crf.kmeans_labels`` / K12b ``crf.crf_step``; elsewhere
K5a ``utils/image.py:frame_epilogue``, K5b and K6 in
``pipeline/depth.py``, K8 and K9 in ``models/rtmdet.py``, K10 in
``pipeline/state.py``, K14a and K14b in ``models/maskrcnn.py``, K15a
in ``models/sam.py`` and K15b in ``models/swinv2.py``."""

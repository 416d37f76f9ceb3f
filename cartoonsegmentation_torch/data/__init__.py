"""Data of the port: the RLE codec and COCO export, the synthetic
anime-COCO generator (samplers, augmentations, paste layouts), the
training datasets and the COCO metric."""
from .metrics import (  # noqa: F401
    AnimeMangaMetric, coco_map, coco_summary,
)

"""COCO export of the port: the RLE codec and annotation records."""

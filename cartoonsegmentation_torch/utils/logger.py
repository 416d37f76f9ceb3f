"""The port's logger (its own copy of
``cartoonsegmentation_tpu/utils/logger.py``, under the port's name).
Unlike the JAX package's, it propagates to the root logger by default,
so a host application's handlers and pytest's ``caplog`` see it."""
from __future__ import annotations

import logging
import sys

_FMT = '[%(asctime)s %(levelname)s %(name)s] %(message)s'


def set_logging(name: str = 'cartoonsegmentation_torch',
                level: int = logging.INFO,
                propagate: bool = True) -> logging.Logger:
    """The named logger, writing to stderr at ``level``; its handler
    is added once."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FMT, datefmt='%H:%M:%S'))
        logger.addHandler(handler)
    logger.setLevel(level)
    logger.propagate = propagate
    return logger


LOGGER = set_logging()

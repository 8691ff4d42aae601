"""Structured logging (replaces the reference's bare std::cout prints,
SURVEY.md section 5); the JAX package's ``utils/logging.py``.

``get_logger(name)`` gives one logger per name, writing to stderr in the
format below at the level of ``ACRT_LOG_LEVEL`` (default ``INFO``), read
when the logger is first asked for."""

from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = "acrt") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT, "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("ACRT_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger

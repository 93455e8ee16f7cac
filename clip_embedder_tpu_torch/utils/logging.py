"""Logging helpers: the one-time warning that config resolution gives for
fields it reconstructs from a published architecture (counterpart of
``clip_embedder_tpu.utils.logging.warn_once``). ``CLIP_TPU_LOG`` sets the
level (debug/info/warning/error; warning by default)."""

from __future__ import annotations

import logging
import os


def get_logger(name: str = "clip_embedder_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s", datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        level = os.environ.get("CLIP_TPU_LOG", "warning").upper()
        logger.setLevel(getattr(logging, level, logging.WARNING))
    return logger


_warned_once: set = set()


def warn_once(key: str, msg: str, *args) -> None:
    """Log a warning once per process for ``key`` (tests reset it with
    ``_warned_once.clear()``)."""
    if key in _warned_once:
        return
    _warned_once.add(key)
    get_logger().warning(msg, *args)

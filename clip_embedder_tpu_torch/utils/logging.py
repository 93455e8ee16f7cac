"""Logging and profiling helpers (counterpart of
``clip_embedder_tpu.utils.logging``): an env-filtered logger
(``CLIP_TPU_LOG`` = debug/info/warning/error; warning by default), ``timed``
for the wall-clock time of a block, ``trace`` for a device profile of a
block (``torch.profiler``, written as a Chrome trace; open it in Perfetto or
``chrome://tracing``), and the one-time warning that config resolution
gives for fields it reconstructs from a published architecture."""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from pathlib import Path


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


@contextlib.contextmanager
def timed(label: str, logger: logging.Logger | None = None):
    """Log the wall-clock time of a block at info level (host clock: the
    block must end in a synchronizing call, as ``embed_*`` do, for the time
    to include the device's work)."""
    logger = logger or get_logger()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info("%s: %.1f ms", label, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile a block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write its Chrome trace to
    ``log_dir/trace.json``; ``log_dir`` defaults to ``clip_tpu_trace``
    under the temp directory, the JAX package's default. Yields the
    directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir or Path(tempfile.gettempdir()) / "clip_tpu_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / "trace.json"))


_warned_once: set = set()


def warn_once(key: str, msg: str, *args) -> None:
    """Log a warning once per process for ``key`` (tests reset it with
    ``_warned_once.clear()``)."""
    if key in _warned_once:
        return
    _warned_once.add(key)
    get_logger().warning(msg, *args)

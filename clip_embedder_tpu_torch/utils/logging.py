"""Logging and profiling helpers (counterpart of
``clip_embedder_tpu.utils.logging``): an env-filtered logger
(``CLIP_TPU_LOG`` = debug/info/warning/error; warning by default), ``timed``
for the wall-clock time of a block, ``trace`` for a device profile of a
block (``torch.profiler`` over every thread, written as a Chrome trace; open
it in Perfetto or ``chrome://tracing``), the one-time warning that config
resolution gives for fields it reconstructs from a published architecture,
and the program's own spans and counters.

Spans and counters
------------------
``span(name, trace=None, **attrs)`` times a block on the host. Each span
holds its name, start and end (``time.perf_counter_ns``), its id and its
parent's (the span open on this thread when it began), a trace id shared
by the spans of one batch or one request (given, else the parent's, else
the one ``in_trace`` set on this thread), the thread, ``attrs``, and
``profiled``: whether a ``torch.profiler`` session ran in the process at its
start or its end. While one runs, the span also enters
``record_function(name)``, so it shows in the session's Chrome trace beside
the device's kernels; otherwise it enters nothing (a ``record_function``
costs more than the span).

Spans go into one process-wide ring of the last ``RING_SPANS``, always on
(``CLIP_TPU_TRACE=0`` turns recording off), without a lock: ids and the
recording order (``Span.seq``) come from ``itertools.count``, and a
``deque`` appends atomically. ``spans()`` is a snapshot, oldest first;
the first one's ``seq`` is how many spans the ring has dropped.
``to_unix_ns`` places a span's time on the profiler's clock (Unix time).
Counters (``count``, ``counters``) stay on whatever ``CLIP_TPU_TRACE`` says.

No span opens inside a function being captured as a CUDA graph: the
program's spans sit around a capture and around a replay call.

The spans the program records, and what reads them: ``serving.queue`` (a
request's wait in ``MicroBatcher``, submission to the start of the step
that carries it) and ``serving.step`` (a micro-batch's ``embed_fn`` call,
attr ``items``); ``pipeline.read_back`` (``EmbedPipeline``'s read-back of
a batch); ``preprocess.call`` (``Preprocessor.run``, attr ``drained``: its
stream had no pending work at the start) and ``preprocess.stage`` (its
host half); ``graphs.capture`` (``GraphSet.capture``, attrs ``what`` and
``shapes``). The counter ``graphs.captures`` counts captures by ``what``
(``ClipServer``'s ``/v1/metrics``). The benchmark's per-layer metrics read
the spans.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import tempfile
import threading
import time
from collections import Counter, deque
from pathlib import Path
from typing import Any, NamedTuple

from torch.autograd import profiler as _autograd_profiler
from torch.autograd.profiler import record_function


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


def _profile_every_thread(activities):
    """A ``torch.profiler`` session over the host ops of every thread (a
    server's collector thread too), where this torch has the setting."""
    from torch.profiler import profile

    try:
        from torch._C._profiler import _ExperimentalConfig
        return profile(activities=activities,
                       experimental_config=_ExperimentalConfig(profile_all_threads=True))
    except (ImportError, TypeError):
        return profile(activities=activities)


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile a block with ``torch.profiler`` (CPU activity of every
    thread, and CUDA activity where a card is present) and write its Chrome
    trace to ``log_dir/trace.json``; ``log_dir`` defaults to
    ``clip_tpu_trace`` under the temp directory, the JAX package's default.
    Yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity

    log_dir = Path(log_dir or Path(tempfile.gettempdir()) / "clip_tpu_trace")
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = _profile_every_thread(activities)
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


# -- spans and counters (the module docstring) --------------------------------

RING_SPANS = 65536
RECORDING = os.environ.get("CLIP_TPU_TRACE", "1") != "0"

# one (perf_counter_ns, time_ns) pair: a span's clock placed on Unix time,
# the profiler's trace clock
_CLOCK = (time.perf_counter_ns(), time.time_ns())


class Span(NamedTuple):
    seq: int             # its place among all spans recorded in the process
    name: str
    start: int           # time.perf_counter_ns()
    end: int
    id: int
    parent: int | None   # the span open on its thread when it began
    trace: Any           # shared by the spans of one batch or one request
    thread: int          # threading.get_ident()
    attrs: dict
    profiled: bool       # a profiler session ran at its start or its end


_ring: deque = deque(maxlen=RING_SPANS)
_seq = itertools.count()
_ids = itertools.count(1)
_local = threading.local()
_counts: dict[str, Counter] = {}
_counts_lock = threading.Lock()


def _open_spans() -> list:
    """This thread's stack of (span id, trace) pairs: its open spans and
    ``in_trace`` scopes, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def profiling() -> bool:
    """Whether a ``torch.profiler`` session runs in the process (the flag is
    process-wide; ``torch._C._autograd._profiler_enabled`` is per thread)."""
    return _autograd_profiler._is_profiler_enabled


def to_unix_ns(t: int) -> int:
    """A ``time.perf_counter_ns`` reading (a span's start or end) as Unix
    time in ns: a Chrome trace's ``ts`` × 1000 + ``baseTimeNanoseconds``."""
    return t - _CLOCK[0] + _CLOCK[1]


def record(name: str, start: int, end: int, *, trace: Any = None, profiled: bool = False,
           **attrs) -> None:
    """Record a span, with no parent, that the caller timed: its start and
    end read from ``time.perf_counter_ns`` in different calls, perhaps on
    different threads (a wait; its thread is the one that ends it), and
    ``profiled`` read at its start (``profiling()``)."""
    if RECORDING:
        _ring.append(Span(next(_seq), name, start, end, next(_ids), None, trace,
                          threading.get_ident(), attrs,
                          profiled or _autograd_profiler._is_profiler_enabled))


class _Timed:
    __slots__ = ("name", "trace", "attrs", "_id", "_parent", "_stack", "_profiled", "_range",
                 "_start")

    def __init__(self, name: str, trace: Any, attrs: dict):
        self.name, self.trace, self.attrs = name, trace, attrs

    def __enter__(self):
        stack = _open_spans()
        self._parent, inherited = stack[-1] if stack else (None, None)
        if self.trace is None:
            self.trace = inherited
        self._id = next(_ids)
        stack.append((self._id, self.trace))
        self._stack = stack
        self._profiled = _autograd_profiler._is_profiler_enabled
        self._range = None
        if self._profiled:
            self._range = record_function(self.name)
            self._range.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._stack.pop()
        _ring.append(Span(next(_seq), self.name, self._start, end, self._id, self._parent,
                          self.trace, threading.get_ident(), self.attrs,
                          self._profiled or _autograd_profiler._is_profiler_enabled))


_NOT_RECORDED = contextlib.nullcontext()


def span(name: str, trace: Any = None, **attrs):
    """A context manager that records the block as a span (the module
    docstring); nothing while recording is off."""
    return _Timed(name, trace, attrs) if RECORDING else _NOT_RECORDED


@contextlib.contextmanager
def in_trace(trace: Any):
    """Spans this thread opens inside the block, and their children, take
    ``trace`` unless given one; the block opens no span of its own."""
    stack = _open_spans()
    stack.append((stack[-1][0] if stack else None, trace))
    try:
        yield
    finally:
        stack.pop()


def spans() -> list[Span]:
    """The ring's spans, oldest first: the first one's ``seq`` is how many
    the ring dropped."""
    return list(_ring)


def count(name: str, key: Any, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` under ``key``."""
    with _counts_lock:
        _counts.setdefault(name, Counter())[key] += n


def counters() -> dict[str, dict]:
    """Every counter's counts by key."""
    with _counts_lock:
        return {name: dict(c) for name, c in _counts.items()}

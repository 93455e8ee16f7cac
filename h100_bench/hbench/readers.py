"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader takes the run's inputs (``trace``: the traced session's summary
or None, ``counters``, ``config``, ``traffic``, ``e2e``, ``device_name``)
and returns a number, or None where it finds nothing to read: then the
run leaves the metric out. A share of a roofline or a peak is never
reported as 0 for want of a reading."""

from __future__ import annotations

import math

from .roofline import peaks_for
from .trace import OTHER


def kernel_function(name: str, source: str) -> str | None:
    """The bare function name of a kernel that ``csrc/<source>.cu`` built
    (its kernels live in the namespace ``src_<source>``), or None for
    another source's: ``void clipk::src_flash_packed::flash::rope_kernel<...>(...)``
    gives ``rope_kernel``."""
    tag = f"src_{source}::"
    if tag not in name:
        return None
    rest = name.split(tag, 1)[1].replace("(anonymous namespace)::", "")
    for stop in "(<":
        rest = rest.split(stop, 1)[0]
    return rest.rsplit("::", 1)[-1]


def per_call_ms(trace, source: str, is_call) -> float | None:
    """Mean device ms of one call of an op built from ``csrc/<source>.cu``:
    the time of all that source's kernels over the launches of those whose
    function name ``is_call`` picks (one a call: a pre-pass launched beside
    it counts in the time, not as a call). None without any."""
    if trace is None:
        return None
    total, calls = 0.0, 0
    for name, (s, n) in trace["kernels"].items():
        fn = kernel_function(name, source)
        if fn is not None:
            total += s
            calls += n if is_call(fn) else 0
    return 1e3 * total / calls if calls else None


def roofline_pct(bound_s: float, measured_ms: float | None) -> float | None:
    return None if not measured_ms else 100.0 * bound_s * 1e3 / measured_ms


def session_images_per_s(trace) -> float | None:
    """Images per second over the traced session: its batches of device
    work between two read-backs, over its length on the host clock."""
    if trace is None or not trace.get("batches"):
        return None
    return trace["batches"] * trace["batch_size"] / trace["window_s"]


def other_ms_per_batch(trace) -> float | None:
    if trace is None or not trace.get("batches"):
        return None
    return trace["groups_ms"].get(OTHER, 0.0) / trace["batches"]


def idle_pct(trace) -> float | None:
    if trace is None:
        return None
    return 100.0 * max(0.0, 1.0 - trace["busy_s"] / trace["window_s"])


def preprocess_host_ms(counters) -> float | None:
    ms = counters.get("preprocess_ms")
    return sum(ms) / len(ms) if ms else None


def p95(values) -> float | None:
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)] if s else None


def peaks(inputs) -> dict:
    return peaks_for(inputs.device_name)

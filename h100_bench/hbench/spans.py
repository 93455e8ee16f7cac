"""The program's own spans (``clip_embedder_tpu_torch.utils.logging``),
read for the per-layer metrics of the run that recorded them.

The window is found from the spans themselves. Bulk: the last
``embed_iter`` call's ``pipeline.read_back`` spans of the window's batches,
numbered ``warm_batches`` up to that plus ``counters["batches"]``; the
window runs from the end of the read-back before the first of them to the
end of the last of them. Online: the last batcher's spans, from the start
of its first ``serving.queue`` span on. A span belongs to the window if it
starts inside it.

Host times are read from the window's spans that no profiler session
touched, as the benchmark's own host-clock metrics are: in bulk, the spans
not ``profiled``; online, whose sessions run beside the traffic and leave a
backlog that takes seconds to drain, the spans that began before the first
``profiled`` span of any name.

A program without the recorder, or with recording off, gives no window:
every reader then returns None and the run leaves its metric out."""

from __future__ import annotations

import math

BULK = "pipeline_closed"


def program_spans() -> list | None:
    """The spans the program recorded in this process, oldest first; None
    where the program has no recorder."""
    try:
        from clip_embedder_tpu_torch.utils.logging import spans
    except ImportError:
        return None
    return spans()


def _owner(s) -> object:
    return s.trace[0] if isinstance(s.trace, tuple) and len(s.trace) == 2 else None


def _last_owner(spans: list, name: str) -> object:
    named = [s for s in spans if s.name == name]
    return _owner(max(named, key=lambda s: s.start)) if named else None


def bulk_window(spans: list, warm_batches: int, batches: int) -> list | None:
    """The spans that start between the end of the read-back of batch
    ``warm_batches - 1`` and the end of that of batch ``warm_batches +
    batches - 1``, in the last ``embed_iter`` call."""
    call = _last_owner(spans, "pipeline.read_back")
    ends = {s.trace[1]: s.end for s in spans
            if s.name == "pipeline.read_back" and call is not None and _owner(s) == call}
    first, last = warm_batches - 1, warm_batches + batches - 1
    if first not in ends or last not in ends:
        return None
    return [s for s in spans if ends[first] <= s.start <= ends[last]]


def online_window(spans: list) -> list | None:
    """The spans that start at or after the start of the last batcher's
    first ``serving.queue`` span."""
    batcher = _last_owner(spans, "serving.queue")
    if batcher is None:
        return None
    t0 = min(s.start for s in spans if s.name == "serving.queue" and _owner(s) == batcher)
    return [s for s in spans if s.start >= t0]


def window(inputs, spans: list | None = None) -> list | None:
    """The run's window of spans (the module docstring), by its traffic's
    shape; ``spans`` defaults to the program's."""
    spans = program_spans() if spans is None else spans
    if not spans:
        return None
    if inputs.traffic["shape"] == BULK:
        return bulk_window(spans, inputs.traffic["warm_batches"], inputs.counters["batches"])
    return online_window(spans)


def host_spans(inputs, name: str, spans: list | None = None) -> list | None:
    """The window's spans called ``name`` that no profiler session touched
    (the module docstring); None without a window."""
    found = window(inputs, spans)
    if found is None:
        return None
    if inputs.traffic["shape"] == BULK:
        kept = [s for s in found if not s.profiled]
    else:
        first = min((s.start for s in found if s.profiled), default=math.inf)
        kept = [s for s in found if s.start < first]
    return [s for s in kept if s.name == name]


def ms(s) -> float:
    return (s.end - s.start) / 1e6


def mean_ms(spans: list | None) -> float | None:
    return sum(map(ms, spans)) / len(spans) if spans else None

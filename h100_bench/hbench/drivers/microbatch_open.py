"""Interactive uploads: single-image requests in an open loop through
``MicroBatcher(embedder.embed_images, ...)``.

Requests arrive as a Poisson process at the mix's fixed ``rate_per_s``.
Every seed gets the same set of gaps, the ``rate·seconds`` quantiles of the
exponential distribution, in a seeded order, so that seeds differ in order
and not in load. Request i embeds pool image i (cycled). A request is timed
from its due time in the schedule to the moment its row resolves, so a
stall delays every later request's time, and how late the sender ran is
reported beside it. A request that fails or has not resolved a minute
after the window closes is missing: it counts in ``rows_missing``, and its
time is taken as the wait until then.

A micro-batch is a run of consecutive requests, so of consecutive pool
images. Set-up embeds one batch for every (batch bucket, set of image
sizes) that a run of 1 to ``max_batch`` consecutive pool images can hold:
that captures the tower's graph of every bucket and the preprocess's graph
of every padded shape this traffic can make, so that the window captures
nothing. ``captures.online`` counts any capture in the window all the same
(a shape the program dropped from its caches and met again)."""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from ..cell import Outcome
from ..weights import seed_for

GRACE_S = 60.0


def schedule(rate: float, seconds: float, seed: int, what: str = "arrivals") -> np.ndarray:
    """Due times (s after the window opens) of ``round(rate·seconds)``
    requests: the exponential quantiles at (i + 0.5)/n, shuffled by seed."""
    n = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(np.random.default_rng(seed_for(seed, what)).permutation(gaps))


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all the values."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def _profile_sessions(tracer, plan: dict, t0: float, span: float) -> None:
    """``plan["sessions"]`` profiler sessions of ``plan["seconds"]``, evenly
    spaced over the schedule's ``span`` from its share ``plan["from"]`` on,
    from a thread of their own, so that the sender does not make the calls."""
    first, n = plan["from"], plan["sessions"]
    for k in range(n):
        at = span * (first + (1 - first) * k / n)
        time.sleep(max(0.0, t0 + at - time.perf_counter()))
        tracer.start()
        time.sleep(plan["seconds"])
        tracer.stop()


def open_loop(ctx, batcher, due: np.ndarray, *, tracer_plan=None) -> dict:
    """Send request i (pool image i, cycled) at ``t0 + due[i]``; wait for
    every answer up to ``GRACE_S`` after the last is due. Returns each
    request's due, sent and done times (perf_counter s), the rows, the
    failures, and when the run gives up on a missing answer."""
    pool, n = ctx.pool, len(due)
    sent, done = np.full(n, np.nan), np.full(n, np.nan)
    rows, errors = {}, {}
    lock = threading.Lock()
    all_done = threading.Event()
    remaining = [n]

    def finished(i, fut):
        t = time.perf_counter()
        with lock:
            done[i] = t
            if fut.exception() is None:
                rows[i] = fut.result()
            else:
                errors[i] = repr(fut.exception())
            remaining[0] -= 1
            if remaining[0] == 0:
                all_done.set()

    t0 = time.perf_counter() + 0.005
    due_abs = t0 + due
    profiling = None
    if tracer_plan:
        profiling = threading.Thread(target=_profile_sessions, name="bench-profiler",
                                     args=(ctx.tracer, tracer_plan, t0, due[-1] if n else 0.0))
        profiling.start()
    for i in range(n):
        delay = due_abs[i] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        sent[i] = time.perf_counter()
        fut = batcher.submit((i, pool[i % len(pool)]))
        fut.add_done_callback(lambda f, i=i: finished(i, f))
    if profiling is not None:
        profiling.join()
    last_due = due_abs[-1] if n else t0
    all_done.wait(timeout=max(0.0, last_due + GRACE_S - time.perf_counter()))
    with lock:
        return {"t0": t0, "due": due_abs, "sent": sent, "done": done.copy(), "rows": dict(rows),
                "errors": dict(errors), "give_up": last_due + GRACE_S}


def latencies_ms(res: dict) -> np.ndarray:
    """Due to resolved, in ms; a request that never resolved, or failed,
    waited until the run gave up on it."""
    end = res["done"].copy()
    missing = np.isnan(end)
    missing[list(res["errors"])] = True
    end[missing] = res["give_up"]
    return (end - res["due"]) * 1e3


def make_batcher(ctx, starts: dict, calls: list | None = None):
    """The cell's ``MicroBatcher`` over the embedder, through a wrapper that
    notes when the call carrying each request starts (``starts``; the
    serving layer's wait is from a request's submission to then) and each
    call's start and size (``calls``), and names the call in a traced run."""
    from clip_embedder_tpu_torch.serving import MicroBatcher

    t = ctx.traffic

    def embed_fn(items):
        now = time.perf_counter()
        for i, _ in items:
            starts[i] = now
        if calls is not None:
            calls.append((now, len(items)))
        with ctx.hooks.span("bench.embed"):
            return ctx.embedder.embed_images([a for _, a in items])

    return MicroBatcher(embed_fn, max_batch=t["max_batch"], max_delay_ms=t["max_delay_ms"])


def warm_batches(pool: list, max_batch: int) -> list[list[int]]:
    """One run of consecutive pool indices for each (batch bucket, set of
    image sizes) that a run of 1 to ``max_batch`` of them can hold: the
    shapes the embedder pads a micro-batch to follow from those two (the
    bucket is the program's own power-of-two rounding)."""
    from clip_embedder_tpu_torch.ops.preprocess import bucket_batch

    found: dict = {}
    for k in range(1, max_batch + 1):
        for start in range(len(pool)):
            run = [(start + j) % len(pool) for j in range(k)]
            key = (bucket_batch(k), frozenset(pool[i].shape[:2] for i in run))
            found.setdefault(key, run)
    return list(found.values())


def warm_up(ctx) -> None:
    for run in warm_batches(ctx.pool, ctx.traffic["max_batch"]):
        ctx.embedder.embed_images([ctx.pool[i] for i in run])


def run(ctx) -> Outcome:
    t = ctx.traffic
    with ctx.hooks.span("bench.warmup"):
        warm_up(ctx)
    due = schedule(t["rate_per_s"], ctx.seconds, ctx.seed)
    starts: dict = {}
    calls: list = []
    setup_s = time.monotonic() - ctx.t_start
    batcher = make_batcher(ctx, starts, calls)
    try:
        ctx.hooks.open_window()
        res = open_loop(ctx, batcher, due, tracer_plan=t["trace"] if ctx.tracer else None)
        ctx.hooks.close_window()
    finally:
        batcher.close()

    # A session holds up the host for up to seconds (starting and stopping
    # it), and at this load the queue it leaves takes seconds more to drain:
    # the host-clock per-layer metrics are read before the first session.
    first = ctx.tracer.spans[0][0] if ctx.tracer is not None and ctx.tracer.spans else math.inf

    def quiet(t0, t1):
        return t1 < first

    lat = latencies_ms(res)
    missing = len(due) - len(res["rows"])
    close = res["t0"] + ctx.seconds
    late = (res["sent"] - res["due"]) * 1e3
    waits = [(starts[i] - res["sent"][i]) * 1e3 for i in range(len(due))
             if i in starts and quiet(res["sent"][i], starts[i])]
    sizes = [n for at, n in calls if quiet(at, at)]
    done_by_close = int(np.sum(res["done"] <= close))
    due_by_close = int(np.sum(res["due"] <= close))
    return Outcome(
        setup_s=setup_s, window_s=ctx.seconds,
        e2e={"request_p95_ms": percentile(lat, 95), "request_p50_ms": percentile(lat, 50)},
        answers=res["rows"], image_of=lambda i: i % len(ctx.pool),
        attempted=len(due), missing=missing,
        counters={"batches": len(sizes), "items": sum(sizes), "wait_ms": waits,
                  **ctx.hooks.counters(quiet),
                  "sender_late_p95_ms": percentile(late, 95),
                  "sender_late_max_ms": float(np.nanmax(late)),
                  "done_by_close": done_by_close, "due_by_close": due_by_close,
                  "errors": list(res["errors"].values())[:3]})

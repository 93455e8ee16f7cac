"""Bulk indexing: a closed loop through ``EmbedPipeline.embed_iter`` over an
endless stream of the pool's images, cycled in order.

The pipeline keeps one batch in flight while the previous one reads back.
Set-up runs ``warm_batches`` batches through the same iterator (the
captures of the bucket's graphs and the preprocess's shape, which every
batch of a stratified pool shares), then the window opens at a batch's
read-back and counts every row read back until the first read-back at or
after ``--seconds``: ``images_per_s`` is those rows over that time.

A traced run profiles ``trace.sessions`` stretches of ``trace.batches``
batches each, ``trace.gap_batches`` apart, the first opening after the
window's ``trace.first_batch``-th batch; each opens and closes at a
read-back, so that it holds as many batches of device work as it counts
(see ``hbench.trace``)."""

from __future__ import annotations

import itertools
import time

from ..cell import Outcome


def run(ctx) -> Outcome:
    from clip_embedder_tpu_torch.parallel.pipeline import EmbedPipeline

    t = ctx.traffic
    size, pool = t["batch_size"], ctx.pool
    stream = (pool[i % len(pool)] for i in itertools.count())
    batches = EmbedPipeline(ctx.embedder, batch_size=size).embed_iter(stream)
    with ctx.hooks.span("bench.warmup"):
        for _ in range(t["warm_batches"]):
            next(batches)
    pos = t["warm_batches"] * size
    plan = t["trace"]
    starts = {plan["first_batch"] + k * (plan["batches"] + plan["gap_batches"])
              for k in range(plan["sessions"])} if ctx.tracer else set()
    answers, short, first = {}, 0, None
    setup_s = time.monotonic() - ctx.t_start
    ctx.hooks.open_window()
    t0 = now = time.perf_counter()
    n = 0
    try:
        while now - t0 < ctx.seconds:
            if n in starts:
                ctx.tracer.start()
                first = n
            with ctx.hooks.span("bench.batch"):
                rows = next(batches)
            now = time.perf_counter()
            n += 1
            if ctx.tracer and ctx.tracer.active and n - plan["batches"] == first:
                ctx.tracer.stop(batches=n - first, batch_size=size)
            short += size - len(rows)
            for r in rows:
                answers[pos] = r
                pos += 1
    finally:
        if ctx.tracer and ctx.tracer.active:
            ctx.tracer.stop(batches=n - first, batch_size=size)
        ctx.hooks.close_window()
        batches.close()
    window_s = now - t0
    return Outcome(
        setup_s=setup_s, window_s=window_s,
        e2e={"images_per_s": len(answers) / window_s},
        answers=answers, image_of=lambda p: p % len(pool),
        attempted=n * size, missing=short,
        # a closed loop leaves no backlog after a session: its calls outside
        # the sessions are the undisturbed ones
        counters={"batches": n,
                  **ctx.hooks.counters(ctx.tracer.outside if ctx.tracer else None)})

"""The port's span recorder and counters (``utils.logging``) on the CPU:
ids, parents and traces, the ring's bound, ``CLIP_TPU_TRACE=0``, spans from
other threads, the process-wide profiler flag, the spans of an
``EmbedPipeline`` and a ``MicroBatcher`` run, and a span's times on the
profiler's clock."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from clip_embedder_tpu_torch.ops.preprocess import Preprocessor
from clip_embedder_tpu_torch.parallel.pipeline import EmbedPipeline
from clip_embedder_tpu_torch.serving import MicroBatcher
from clip_embedder_tpu_torch.utils import logging as tracing

REPO = Path(__file__).resolve().parents[1]


def next_seq():
    """The ``seq`` the next span recorded will take."""
    tracing.record("test.mark", 0, 0)
    return tracing.spans()[-1].seq + 1


def recorded_since(mark):
    return [s for s in tracing.spans() if s.seq >= mark]


class TinyEmbedder:
    """A real ``Preprocessor`` on the CPU and a tower that keeps four
    pixels: ``embed_images_device`` as ``VisionEmbedder``'s."""

    def __init__(self):
        self.preprocessor = Preprocessor(image_size=8, mean=(0.5,) * 3, std=(0.25,) * 3,
                                         interpolation="bicubic", resize_mode="shortest",
                                         device="cpu")

    def embed_images_device(self, images):
        return self.preprocessor(list(images)).flatten(1)[:, :4], len(images)

    def embed_images(self, images):
        rows, n = self.embed_images_device(images)
        return rows[:n].numpy()


def images(n):
    rng = np.random.default_rng(3)
    return [rng.integers(0, 255, (20 + 3 * (i % 3), 30, 3), dtype=np.uint8) for i in range(n)]


def test_ids_parents_and_traces():
    mark = next_seq()
    with tracing.span("outer", trace=("t", 1)):
        with tracing.span("inner", k=2):
            pass
        with tracing.in_trace(("t", 2)):
            with tracing.span("scoped"):
                pass
    with tracing.span("alone"):
        pass
    got = {s.name: s for s in recorded_since(mark)}
    assert got["outer"].parent is None
    assert got["inner"].parent == got["outer"].id and got["inner"].trace == ("t", 1)
    assert got["inner"].attrs == {"k": 2}
    # in_trace sets the trace, not the parent: the open span stays the parent
    assert got["scoped"].parent == got["outer"].id and got["scoped"].trace == ("t", 2)
    assert got["alone"].parent is None and got["alone"].trace is None
    assert len({s.id for s in got.values()}) == 4
    assert got["outer"].start <= got["inner"].start <= got["inner"].end <= got["outer"].end
    assert not any(s.profiled for s in got.values())


def test_the_ring_is_bounded_and_counts_what_it_dropped():
    first = next_seq()
    for i in range(tracing.RING_SPANS + 5):
        tracing.record("test.fill", i, i + 1)
    kept = tracing.spans()
    assert len(kept) == tracing.RING_SPANS
    assert kept[-1].seq == first + tracing.RING_SPANS + 4
    assert kept[0].seq == first + 5  # the ring dropped every span before it
    assert [s.start for s in kept[:2]] == [5, 6]


def test_recording_off_keeps_the_counters():
    code = ("from clip_embedder_tpu_torch.utils import logging as t\n"
            "with t.span('x'):\n    pass\n"
            "t.record('y', 1, 2)\n"
            "t.count('graphs.captures', 'a')\n"
            "print(len(t.spans()), t.RECORDING, t.counters())\n")
    env = {**os.environ, "CLIP_TPU_TRACE": "0"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "0 False {'graphs.captures': {'a': 1}}"


def test_counters_count_by_key():
    before = tracing.counters().get("test.count", {})
    tracing.count("test.count", "a")
    tracing.count("test.count", "a", 2)
    tracing.count("test.count", "b")
    after = tracing.counters()["test.count"]
    assert after["a"] - before.get("a", 0) == 3 and after["b"] - before.get("b", 0) == 1


def test_batcher_spans_from_the_collector_thread():
    mark = next_seq()

    def embed(items):
        with tracing.span("test.embed"):
            return np.stack([np.full(2, float(v), np.float32) for v in items])

    with MicroBatcher(embed, max_batch=4, max_delay_ms=20) as mb:
        futs = [mb.submit(i) for i in range(6)]
        assert [f.result(timeout=10)[0] for f in futs] == list(range(6))
        collector = mb._worker.ident
    got = recorded_since(mark)
    queue = [s for s in got if s.name == "serving.queue"]
    steps = [s for s in got if s.name == "serving.step"]
    assert sorted(s.trace for s in queue) == [(mb.name, i) for i in range(6)]
    assert all(s.thread == collector and s.parent is None for s in queue + steps)
    assert sum(s.attrs["items"] for s in steps) == 6 and len(steps) == mb.batches
    assert [s.trace for s in steps] == [(f"{mb.name}.step", k) for k in range(len(steps))]
    for s in (s for s in got if s.name == "test.embed"):
        step = next(p for p in steps if p.id == s.parent)
        assert s.thread == collector and s.trace == step.trace
    # a request waits from submission to the start of its step
    for q in queue:
        assert any(q.end <= p.start for p in steps)


def test_profiled_is_process_wide():
    from torch.profiler import ProfilerActivity, profile

    mark = next_seq()
    flags = {}

    def other():
        flags["thread"] = tracing.profiling()
        with tracing.span("test.other"):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    with tracing.span("test.after"):
        pass
    got = {s.name: s for s in recorded_since(mark)}
    assert flags == {"thread": True}
    assert got["test.other"].profiled and not got["test.after"].profiled


def test_pipeline_and_batcher_spans_by_name_and_nesting():
    mark = next_seq()
    tiny = TinyEmbedder()
    rows = list(EmbedPipeline(tiny, batch_size=4, decode_workers=2).embed_iter(images(10)))
    assert [len(r) for r in rows] == [4, 4, 2]
    got = recorded_since(mark)
    by_id = {s.id: s for s in got}
    calls = [s for s in got if s.name == "preprocess.call"]
    (call,) = {s.trace[0] for s in calls}
    assert call.startswith("embed_iter-")
    for name in ("preprocess.call", "preprocess.stage", "pipeline.read_back"):
        assert sorted(s.trace for s in got if s.name == name) == [(call, b) for b in range(3)]
    for s in (s for s in got if s.name == "preprocess.stage"):
        assert by_id[s.parent].name == "preprocess.call" and by_id[s.parent].trace == s.trace
    assert all(s.attrs == {"drained": True} for s in calls)  # the CPU queues nothing

    mark = next_seq()
    with MicroBatcher(tiny.embed_images, max_batch=4, max_delay_ms=20) as mb:
        futs = [mb.submit(a) for a in images(6)]
        for f in futs:
            f.result(timeout=30)
    got = recorded_since(mark)
    by_id = {s.id: s for s in got}
    assert sum(s.name == "serving.queue" for s in got) == 6
    stages = [s for s in got if s.name == "preprocess.stage"]
    assert stages and len(stages) == mb.batches
    for s in stages:
        call = by_id[s.parent]
        step = by_id[call.parent]
        assert (call.name, step.name) == ("preprocess.call", "serving.step")
        assert s.trace == call.trace == step.trace


def test_span_times_land_on_the_profiler_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    mark = next_seq()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for name in ("test.clock_warm", "test.clock"):  # the first range costs more
            with tracing.span(name):
                time.sleep(0.02)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    trace = json.loads((tmp_path / "t.json").read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    (event,) = [e for e in trace["traceEvents"]
                if e.get("cat") == "user_annotation" and e.get("name") == "test.clock"]
    (s,) = [s for s in recorded_since(mark) if s.name == "test.clock"]
    start_ns = float(event["ts"]) * 1000 + base
    end_ns = start_ns + float(event["dur"]) * 1000
    assert s.profiled
    assert abs(tracing.to_unix_ns(s.start) - start_ns) < 1e6
    assert abs(tracing.to_unix_ns(s.end) - end_ns) < 1e6

"""The window and session selection of the readers of the program's spans
(``hbench.spans``), on synthetic spans whose answers are known."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, NamedTuple

import pytest

import tiny  # noqa: F401  (puts the benchmark and the repo on sys.path)
from hbench import spans as hspans
from hbench.cell import reader

MS = 1_000_000  # ns


class S(NamedTuple):
    name: str
    start: int
    end: int
    trace: Any = None
    attrs: dict = {}
    profiled: bool = False


def bulk_inputs(warm=2, batches=3):
    return SimpleNamespace(traffic={"shape": "pipeline_closed", "warm_batches": warm},
                           counters={"batches": batches})


ONLINE = SimpleNamespace(traffic={"shape": "microbatch_open"}, counters={})


def bulk_spans():
    """An earlier ``embed_iter`` call, then the run's: batch b reads back
    over [10b + 8, 10b + 10] ms and preprocesses over [10b + 1, 10b + 3]
    ms (a 2 ms call, drained but for batch 3); batch 3's spans are
    profiled."""
    out = [S("pipeline.read_back", 0, 50 * MS, ("embed_iter-0", 0))]
    for b in range(7):
        t, p = 100 + 10 * b, b == 3
        out += [S("preprocess.call", (t + 1) * MS, (t + 3) * MS, ("embed_iter-1", b),
                  {"drained": b != 5}, p),
                S("preprocess.stage", (t + 1) * MS, (t + 2) * MS, ("embed_iter-1", b), {}, p),
                S("pipeline.read_back", (t + 8) * MS, (t + 10) * MS, ("embed_iter-1", b), {}, p)]
    return out


def test_bulk_window_runs_between_the_window_batches_read_backs():
    got = hspans.bulk_window(bulk_spans(), warm_batches=2, batches=3)
    # from the end of batch 1's read-back (120 ms) to the end of batch 4's (150 ms)
    assert min(s.start for s in got) >= 120 * MS and max(s.start for s in got) <= 150 * MS
    assert sorted({s.trace[1] for s in got}) == [2, 3, 4]
    assert all(s.trace[0] == "embed_iter-1" for s in got)
    assert hspans.bulk_window(bulk_spans(), warm_batches=2, batches=6) is None
    assert hspans.bulk_window(bulk_spans()[:1], warm_batches=1, batches=1) is None


def test_bulk_host_spans_leave_out_the_profiled_ones():
    kept = hspans.host_spans(bulk_inputs(), "pipeline.read_back", bulk_spans())
    assert [s.trace[1] for s in kept] == [2, 4]
    assert hspans.mean_ms(kept) == pytest.approx(2.0)


def online_spans():
    """An earlier batcher, then the run's: requests every 5 ms from 100 ms,
    each waiting 3 ms, steps of 4 items; a capture at 130 ms; the first
    profiled span is request 8's, at 140 ms."""
    out = [S("serving.queue", 0, 10 * MS, ("batcher-0", 0)),
           S("graphs.capture", 20 * MS, 30 * MS)]
    for r in range(12):
        t = (100 + 5 * r) * MS
        out.append(S("serving.queue", t, t + 3 * MS, ("batcher-1", r), {}, r >= 8))
    for k in range(3):
        t = (103 + 20 * k) * MS
        out += [S("serving.step", t, t + 6 * MS, ("batcher-1.step", k), {"items": 4 + k}, k == 2),
                S("preprocess.call", t, t + 2 * MS, ("batcher-1.step", k), {"drained": True},
                  k == 2)]
    out.append(S("graphs.capture", 130 * MS, 131 * MS, None, {"what": "the preprocess resize"}))
    return out


def test_online_window_starts_at_the_last_batchers_first_request():
    got = hspans.online_window(online_spans())
    assert min(s.start for s in got) == 100 * MS
    assert not any(s.trace == ("batcher-0", 0) for s in got)
    assert sum(s.name == "graphs.capture" for s in got) == 1


def test_online_host_spans_stop_at_the_first_profiled_span():
    queue = hspans.host_spans(ONLINE, "serving.queue", online_spans())
    assert [s.trace[1] for s in queue] == list(range(8))  # started before 140 ms
    steps = hspans.host_spans(ONLINE, "serving.step", online_spans())
    assert [s.attrs["items"] for s in steps] == [4, 5]  # the third starts at 143 ms


@pytest.mark.parametrize("spans", [[], None])
def test_no_spans_no_window(spans, monkeypatch):
    monkeypatch.setattr(hspans, "program_spans", lambda: spans)
    assert hspans.window(ONLINE) is None and hspans.window(bulk_inputs()) is None
    assert reader("graphs.captures.online")(ONLINE) is None
    assert reader("preprocess.call_ms.bulk")(bulk_inputs()) is None


def test_readers_on_synthetic_spans(monkeypatch):
    monkeypatch.setattr(hspans, "program_spans", online_spans)
    assert reader("serving.queue_p95_ms")(ONLINE) == pytest.approx(3.0)
    assert reader("serving.step_ms")(ONLINE) == pytest.approx(6.0)
    assert reader("serving.step_items")(ONLINE) == pytest.approx(4.5)
    assert reader("preprocess.call_ms.online")(ONLINE) == pytest.approx(2.0)
    assert reader("graphs.captures.online")(ONLINE) == 1
    monkeypatch.setattr(hspans, "program_spans",
                        lambda: [s for s in online_spans() if s.name != "graphs.capture"])
    assert reader("graphs.captures.online")(ONLINE) == 0  # none: 0, not None
    monkeypatch.setattr(hspans, "program_spans", bulk_spans)
    inputs = bulk_inputs(warm=2, batches=4)  # batches 2-5, batch 3 profiled
    assert reader("preprocess.call_ms.bulk")(inputs) == pytest.approx(2.0)
    assert reader("preprocess.stage_ms.bulk")(inputs) == pytest.approx(1.0)
    # the calls of batches 2, 4 and 5 (6's starts after the window), 5's not drained
    assert reader("preprocess.drained_share.bulk")(inputs) == pytest.approx(200 / 3)
    assert reader("pipeline.read_back_ms")(inputs) == pytest.approx(2.0)

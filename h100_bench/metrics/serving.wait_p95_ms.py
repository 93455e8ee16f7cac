"""95th percentile, over the window's requests, of the wait in the serving
layer: from a request's submission to ``MicroBatcher.submit`` to the start
of the ``embed_fn`` call that carries it (the benchmark's wrapper of the
function it hands to ``MicroBatcher``), over the requests sent and
started before the traced run's first profiler session."""

from hbench.readers import p95


def read(inputs):
    return p95(inputs.counters.get("wait_ms", []))

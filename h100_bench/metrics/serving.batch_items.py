"""Items per micro-batch over the window: the calls of the ``embed_fn``
that ``MicroBatcher`` runs (``MicroBatcher.items`` over ``.batches``),
counted by the benchmark's wrapper of it, before the traced run's first
profiler session (a session holds up the host, and the queue it leaves
takes seconds to drain)."""


def read(inputs):
    c = inputs.counters
    return c["items"] / c["batches"] if c.get("batches") else None

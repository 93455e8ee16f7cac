"""CUDA graphs captured during the window (``GraphSet.capture`` calls,
counted by the benchmark's wrapper): a shape first met, or met again after
the program's caches dropped it, in the window."""


def read(inputs):
    return inputs.counters.get("captures")

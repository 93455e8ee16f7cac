"""Host ms of one ``Preprocessor.__call__`` (staging and enqueue), the mean
over the window's calls that miss the profiler's sessions, in the bulk
cells."""

from hbench.readers import preprocess_host_ms


def read(inputs):
    return preprocess_host_ms(inputs.counters)

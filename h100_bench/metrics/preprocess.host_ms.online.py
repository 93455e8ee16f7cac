"""Host ms of one ``Preprocessor.__call__`` (staging and enqueue), the mean
over the window's calls before the traced run's first profiler session,
in the online cells."""

from hbench.readers import preprocess_host_ms


def read(inputs):
    return preprocess_host_ms(inputs.counters)

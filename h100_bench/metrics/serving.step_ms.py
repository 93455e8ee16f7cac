"""Mean host ms of the program's ``serving.step`` spans: one
``MicroBatcher`` micro-batch's ``embed_fn`` call (stage, replay, read
back), over the window's steps before the first span a profiler session
touched (``hbench.spans``)."""

from hbench.spans import host_spans, mean_ms


def read(inputs):
    return mean_ms(host_spans(inputs, "serving.step"))

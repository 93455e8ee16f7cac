"""Mean host ms of the program's ``pipeline.read_back`` spans:
``EmbedPipeline``'s read-back of a batch's rows, which waits for the
device's stream, over the window's batches that no profiler session
touched (``hbench.spans``)."""

from hbench.spans import host_spans, mean_ms


def read(inputs):
    return mean_ms(host_spans(inputs, "pipeline.read_back"))

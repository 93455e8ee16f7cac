"""95th percentile (nearest rank) of the program's ``serving.queue`` spans:
a request's wait in ``MicroBatcher``, from its submission to the start of
the ``embed_fn`` call that carries it, over the window's requests that
began before the first span a profiler session touched
(``hbench.spans``)."""

from hbench.readers import p95
from hbench.spans import host_spans, ms


def read(inputs):
    spans = host_spans(inputs, "serving.queue")
    return p95([ms(s) for s in spans]) if spans else None

"""Mean ``items`` of the program's ``serving.step`` spans: requests a
micro-batch, over the window's steps before the first span a profiler
session touched (``hbench.spans``)."""

from hbench.spans import host_spans


def read(inputs):
    spans = host_spans(inputs, "serving.step")
    return sum(s.attrs["items"] for s in spans) / len(spans) if spans else None

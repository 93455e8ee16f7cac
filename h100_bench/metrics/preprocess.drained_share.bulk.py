"""Share (%) of the window's ``preprocess.call`` spans that no profiler
session touched (``hbench.spans``) whose ``drained`` attr is set: the
stream the call enqueues on had no pending work as it began, so the device
sat idle while the host staged. In the bulk cells."""

from hbench.spans import host_spans


def read(inputs):
    spans = host_spans(inputs, "preprocess.call")
    return 100.0 * sum(bool(s.attrs["drained"]) for s in spans) / len(spans) if spans else None

"""Mean host ms of the program's ``preprocess.call`` spans
(``Preprocessor.run``: staging and enqueue), over the window's calls that
no profiler session touched (``hbench.spans``), in the bulk cells."""

from hbench.spans import host_spans, mean_ms


def read(inputs):
    return mean_ms(host_spans(inputs, "preprocess.call"))

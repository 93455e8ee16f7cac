"""Mean host ms of the program's ``preprocess.call`` spans
(``Preprocessor.run``: staging and enqueue), over the window's calls before
the first span a profiler session touched (``hbench.spans``), in the online
cells."""

from hbench.spans import host_spans, mean_ms


def read(inputs):
    return mean_ms(host_spans(inputs, "preprocess.call"))

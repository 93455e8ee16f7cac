"""Mean host ms of the program's ``preprocess.stage`` spans, the host half
of a ``Preprocessor`` call (the wait for the last copy out of the
page-locked buffer, the padded rows zeroed, the images written, the resize
matrices looked up), over the window's calls that no profiler session
touched (``hbench.spans``), in the bulk cells."""

from hbench.spans import host_spans, mean_ms


def read(inputs):
    return mean_ms(host_spans(inputs, "preprocess.stage"))

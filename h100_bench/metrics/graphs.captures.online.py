"""CUDA graphs captured in the window: the program's ``graphs.capture``
spans (``GraphSet.capture``) that start in it (``hbench.spans``), profiled
or not; 0 where there are none."""

from hbench.spans import window


def read(inputs):
    spans = window(inputs)
    return None if spans is None else sum(s.name == "graphs.capture" for s in spans)

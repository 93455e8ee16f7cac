"""The share of the traced session in which no kernel, copy or memset ran
on the device, in the online cells."""

from hbench.readers import idle_pct


def read(inputs):
    return idle_pct(inputs.trace)

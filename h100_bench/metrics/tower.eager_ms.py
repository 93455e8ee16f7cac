"""Device ms a batch in kernels outside the named groups (elementwise ops,
LayerNorm, gelu, copies: ``kernel_group``'s "other", frozen in
``hbench.trace``), over the traced session's batches. The preprocess's
elementwise kernels fall here too."""

from hbench.readers import other_ms_per_batch


def read(inputs):
    return other_ms_per_batch(inputs.trace)

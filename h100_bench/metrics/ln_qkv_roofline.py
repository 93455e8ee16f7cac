"""``ln_qkv``'s share of its roofline: the bound of LayerNorm + the q/k/v
product over the batch's rows (``hbench.roofline.ln_qkv_work``) over the
mean device time of one call: the traced session's time in the kernels of
``csrc/ln_qkv.cu`` (the LayerNorm pass and the product) over the launches
of its product kernel."""

from hbench.readers import peaks, per_call_ms, roofline_pct
from hbench.roofline import bound_s, ln_qkv_work


def read(inputs):
    v = inputs.config["vision"]
    rows = inputs.traffic["batch_size"] * v["tokens"]
    return roofline_pct(bound_s(*ln_qkv_work(rows, v["width"]), peaks(inputs)),
                        per_call_ms(inputs.trace, "ln_qkv", lambda fn: "qkv" in fn))

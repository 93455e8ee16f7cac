"""``flash_attention_packed``'s share of its roofline: the bound of the
batch's attention (with PE-Core's 2-D rope where the configuration has it;
``hbench.roofline.attention_work``) over the mean device time of one call:
the traced session's time in the kernels of ``csrc/flash_packed.cu`` (the
attention kernel and, with rope, its rotation pre-pass) over the launches
of the attention kernel."""

from hbench.readers import peaks, per_call_ms, roofline_pct
from hbench.roofline import attention_work, bound_s


def read(inputs):
    v = inputs.config["vision"]
    work = attention_work(inputs.traffic["batch_size"], v["heads"], v["tokens"],
                          v["width"] // v["heads"], rope=v["rope_2d"])
    return roofline_pct(bound_s(*work, peaks(inputs)),
                        per_call_ms(inputs.trace, "flash_packed", lambda fn: "flash" in fn))

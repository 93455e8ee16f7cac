"""The vision forward's share of the card's bf16 peak: model FLOP per real
image (the configuration's layout's ``flop_per_image``, from its published
widths) times the images per second of the traced session, over
the published bf16 dense peak (989 TFLOP/s on the SXM part)."""

from hbench import layouts
from hbench.readers import peaks, session_images_per_s


def read(inputs):
    rate = session_images_per_s(inputs.trace)
    if rate is None:
        return None
    flop = layouts.of(inputs.config).flop_per_image(inputs.config["vision"])
    return 100.0 * flop * rate / peaks(inputs)["bf16"]

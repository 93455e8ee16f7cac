"""The vision forward's share of the card's bf16 peak: model FLOP per real
image (``hbench.roofline.vision_flop_per_image``, from the configuration's
published widths) times the images per second of the traced session, over
the published bf16 dense peak (989 TFLOP/s on the SXM part)."""

from hbench.readers import peaks, session_images_per_s
from hbench.roofline import vision_flop_per_image


def read(inputs):
    rate = session_images_per_s(inputs.trace)
    if rate is None:
        return None
    return 100.0 * vision_flop_per_image(inputs.config["vision"]) * rate / peaks(inputs)["bf16"]

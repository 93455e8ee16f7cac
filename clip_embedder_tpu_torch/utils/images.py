"""Image input handling: any of {PIL image, numpy array, path, bytes} →
an RGB uint8 [H, W, 3] array (reference: src/vision.rs:168-169). Decoding
goes through Pillow."""

from __future__ import annotations

import io
from pathlib import Path
from typing import Any

import numpy as np

from ..errors import ImageError


def to_rgb_array(image: Any) -> np.ndarray:
    """Convert any supported image input to an RGB uint8 [H, W, 3] array.

    Float arrays are interpreted by range: values all ≤ 1.0 are treated as
    the standard 0–1 convention and scaled by 255; anything else is treated
    as already 0–255.
    """
    if isinstance(image, np.ndarray):
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if image.ndim != 3 or image.shape[-1] not in (3, 4):
            raise ImageError(f"Unsupported array shape {image.shape}")
        if image.shape[-1] == 4:
            image = image[..., :3]
        if image.dtype != np.uint8:
            arr = np.asarray(image, dtype=np.float32)
            if arr.max() <= 1.0:
                arr = arr * 255.0
            image = np.clip(arr, 0, 255).astype(np.uint8)
        return np.ascontiguousarray(image)

    if isinstance(image, (str, Path)):
        try:
            data = Path(image).read_bytes()
        except OSError as e:
            raise ImageError(f"Image error: {e}") from e
        return to_rgb_array(data)

    if isinstance(image, (bytes, bytearray)):
        try:
            from PIL import Image

            with Image.open(io.BytesIO(bytes(image))) as img:
                return np.asarray(img.convert("RGB"))
        except ImportError as e:
            raise ImageError("Pillow required to decode image bytes") from e
        except OSError as e:
            raise ImageError(f"Image error: {e}") from e

    # PIL image (duck-typed so PIL is optional)
    if hasattr(image, "convert"):
        return np.asarray(image.convert("RGB"))

    raise ImageError(f"Unsupported image input type {type(image)!r}")

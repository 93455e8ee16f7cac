"""Image input handling: any of {PIL image, numpy array, path, bytes} →
an RGB uint8 [H, W, 3] array (reference: src/vision.rs:168-169). JPEG bytes
take the native libjpeg decode (``native.decode_jpeg``) where
``native/libclippre.so`` is built and ``CLIP_TPU_NO_NATIVE_DECODE`` is unset;
everything else, and any native failure, goes through Pillow."""

from __future__ import annotations

import io
import os
from pathlib import Path
from typing import Any

import numpy as np

from ..errors import ImageError


def _native_decode_jpeg(data: bytes):
    """JPEG bytes → RGB array through the native library, or None to fall
    back to Pillow (switched off, library not built, or malformed data:
    Pillow then raises the canonical ImageError)."""
    if os.environ.get("CLIP_TPU_NO_NATIVE_DECODE"):
        return None
    from .. import native

    if not native.available():
        return None
    try:
        return native.decode_jpeg(data)
    except ImageError:
        return None


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
        data = bytes(image)
        if data[:2] == b"\xff\xd8":
            # JPEG: the libjpeg decode gives Pillow's pixels (both wrap
            # libjpeg-turbo) and releases the GIL, so server threads decode
            # in parallel
            decoded = _native_decode_jpeg(data)
            if decoded is not None:
                return decoded
        try:
            from PIL import Image

            with Image.open(io.BytesIO(data)) as img:
                return np.asarray(img.convert("RGB"))
        except ImportError as e:
            raise ImageError("Pillow required to decode image bytes") from e
        except OSError as e:
            raise ImageError(f"Image error: {e}") from e

    # PIL image (duck-typed so PIL is optional)
    if hasattr(image, "convert"):
        return np.asarray(image.convert("RGB"))

    raise ImageError(f"Unsupported image input type {type(image)!r}")

"""ctypes binding for the native host library ``native/libclippre.so``
(``native/preprocess.cc``, ``native/decode.cc``; build it with
``make -C native``), the same library the JAX package loads.

``host_preprocess_batch`` runs the resize + normalize of ``ops.preprocess``
on the CPU, multithreaded, with the same Pillow sampling math (the
reference's rayon + fast_image_resize pipeline, reference:
src/vision.rs:120-135); ``decode_jpeg`` is the libjpeg decode that
``utils.images.to_rgb_array`` takes for JPEG bytes. Without the library,
``available()`` is False and both raise ``ImageError``.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np

from .errors import ImageError

# where the library is looked for (tests point it at a build of their own,
# then call ``_lib.cache_clear()``)
LIBRARY = Path(__file__).resolve().parent.parent / "native" / "libclippre.so"

_FILTERS = {"bicubic": 0, "bilinear": 1, "nearest": 2}
_MODES = {"shortest": 0, "squash": 1}
_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_INTP = ctypes.POINTER(ctypes.c_int)


@lru_cache(maxsize=1)
def _lib():
    if not LIBRARY.is_file():
        return None
    lib = ctypes.CDLL(str(LIBRARY))
    lib.clip_preprocess_batch.argtypes = [
        ctypes.POINTER(_U8P), _INTP, _INTP, ctypes.c_int, _F32P, ctypes.c_int, _F32P, _F32P,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.clip_preprocess_batch.restype = None
    # a library built before decode.cc existed still serves the preprocess
    if hasattr(lib, "clip_decode_jpeg"):
        lib.clip_decode_jpeg.argtypes = [_U8P, ctypes.c_ulong, _U8P, _INTP, _INTP]
        lib.clip_decode_jpeg.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _lib() is not None


def host_preprocess_batch(
    arrays: list[np.ndarray],
    *,
    image_size: int,
    mean,
    std,
    interpolation: str = "bicubic",
    resize_mode: str = "shortest",
    chw: bool = True,
    n_threads: int = 0,
) -> np.ndarray:
    """u8 [H, W, 3] arrays → a normalized f32 batch ([B, 3, S, S] when
    ``chw``, else [B, S, S, 3]) on the host, through the native library."""
    lib = _lib()
    if lib is None:
        raise ImageError("native preprocessing library not built (run `make -C native`)")
    if interpolation not in _FILTERS:
        raise ImageError(f"Unsupported interpolation '{interpolation}'")
    batch = len(arrays)
    arrays = [np.ascontiguousarray(a, dtype=np.uint8) for a in arrays]
    for a in arrays:
        if a.ndim != 3 or a.shape[2] != 3:
            raise ImageError(f"Expected [H, W, 3] u8 arrays, got {a.shape}")
        if a.shape[0] == 0 or a.shape[1] == 0:
            raise ImageError(f"Empty image dimension: {a.shape}")

    shape = (batch, 3, image_size, image_size) if chw else (batch, image_size, image_size, 3)
    out = np.empty(shape, dtype=np.float32)
    srcs = (_U8P * batch)(*[a.ctypes.data_as(_U8P) for a in arrays])
    hs = (ctypes.c_int * batch)(*[a.shape[0] for a in arrays])
    ws = (ctypes.c_int * batch)(*[a.shape[1] for a in arrays])
    mean_arr = np.asarray(mean, dtype=np.float32)
    std_arr = np.asarray(std, dtype=np.float32)
    lib.clip_preprocess_batch(
        srcs, hs, ws, batch, out.ctypes.data_as(_F32P), image_size,
        mean_arr.ctypes.data_as(_F32P), std_arr.ctypes.data_as(_F32P),
        _FILTERS[interpolation], _MODES.get(resize_mode, 0), 1 if chw else 0, n_threads,
    )
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → RGB u8 [H, W, 3] through libjpeg (the header for the
    size, then the decode into a numpy buffer). ctypes releases the GIL for
    the call. Raises ImageError on malformed data, on a size past Pillow's
    decompression-bomb limit, or without the library."""
    lib = _lib()
    if lib is None or not hasattr(lib, "clip_decode_jpeg"):
        raise ImageError("native decode library not built (run `make -C native`)")
    buf = np.frombuffer(data, dtype=np.uint8)
    src = buf.ctypes.data_as(_U8P)
    w = ctypes.c_int(0)
    h = ctypes.c_int(0)
    rc = lib.clip_decode_jpeg(src, len(data), None, ctypes.byref(w), ctypes.byref(h))
    if rc != 0 or w.value <= 0 or h.value <= 0:
        raise ImageError(f"Image error: JPEG header decode failed (rc={rc})")
    # the header's size is the sender's to choose (a few-KB JPEG can declare
    # 65500 x 65500): refuse past Pillow's MAX_IMAGE_PIXELS, so the caller
    # falls back to Pillow and its own DecompressionBombError
    try:
        from PIL import Image as _PILImage
        max_pixels = _PILImage.MAX_IMAGE_PIXELS
    except ImportError:
        max_pixels = 178956970
    if max_pixels is not None and h.value * w.value > max_pixels:
        raise ImageError(f"Image error: {h.value}x{w.value} JPEG exceeds the "
                         f"{max_pixels}-pixel decompression-bomb limit")
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.clip_decode_jpeg(src, len(data), out.ctypes.data_as(_U8P), ctypes.byref(w),
                              ctypes.byref(h))
    if rc != 0:
        raise ImageError(f"Image error: JPEG decode failed (rc={rc})")
    return out

"""The torch port's ctypes loader for ``native/libclippre.so``
(``clip_embedder_tpu_torch.native``) and the libjpeg fast path of
``utils.images.to_rgb_array``, on a build of the library that the test makes
in its own temp dir (never in ``native/``, whose build decides whether
tests/test_native.py runs) from ``native/*.cc`` with the Makefile's flags.
The test skips only when that build fails."""

import io
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from clip_embedder_tpu_torch import native
from clip_embedder_tpu_torch.errors import ImageError
from clip_embedder_tpu_torch.ops.preprocess import Preprocessor
from clip_embedder_tpu_torch.utils import images

NATIVE = Path(__file__).resolve().parents[1] / "native"
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    out = tmp_path_factory.mktemp("native") / "libclippre.so"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared",
           "-pthread", "-o", str(out), str(NATIVE / "preprocess.cc"),
           str(NATIVE / "decode.cc"), "-ljpeg"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        pytest.skip(f"no g++ to build libclippre.so: {e}")
    if proc.returncode != 0:
        pytest.skip(f"libclippre.so did not build: {proc.stderr[-500:]}")
    return out


@pytest.fixture()
def lib(built, monkeypatch):
    """The port's loader pointed at the test's build."""
    monkeypatch.setattr(native, "LIBRARY", built)
    native._lib.cache_clear()
    yield native
    native._lib.cache_clear()


def _jpeg(shape, quality, seed) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (*shape, 3), np.uint8)
                    ).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_loads_the_build_it_is_pointed_at(lib, tmp_path, monkeypatch):
    assert lib.available()
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "missing.so")
    native._lib.cache_clear()
    assert not native.available()
    with pytest.raises(ImageError, match="not built"):
        native.decode_jpeg(_jpeg((8, 8), 90, 0))
    with pytest.raises(ImageError, match="not built"):
        native.host_preprocess_batch([np.zeros((8, 8, 3), np.uint8)], image_size=4,
                                     mean=MEAN, std=STD)


@pytest.mark.parametrize("shape,quality", [((37, 53), 92), ((128, 96), 75), ((1, 1), 95)])
def test_decode_jpeg_matches_pillow(lib, shape, quality):
    """Pixel for pixel, as tests/test_native.py holds the JAX loader: both
    wrap libjpeg-turbo with its default IDCT."""
    data = _jpeg(shape, quality, 3)
    ours = lib.decode_jpeg(data)
    theirs = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_decode_jpeg_rejects_garbage_and_bombs(lib):
    with pytest.raises(ImageError):
        lib.decode_jpeg(b"\xff\xd8not actually a jpeg")
    data = bytearray(_jpeg((16, 16), 90, 0))
    sof = data.find(b"\xff\xc0")
    assert sof > 0
    data[sof + 5:sof + 9] = (65500).to_bytes(2, "big") * 2  # SOF0 height, width
    with pytest.raises(ImageError, match="decompression-bomb"):
        lib.decode_jpeg(bytes(data))


@pytest.mark.parametrize("interp", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("mode", ["shortest", "squash"])
def test_host_preprocess_matches_the_device_resize(lib, interp, mode):
    """The native host resize against the port's own resize + normalize
    (``ops.preprocess``, two f32 matmuls) run on the CPU, at the atol
    tests/test_native.py allows between the library and the weight math."""
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 255, (57, 101, 3), dtype=np.uint8),
              rng.integers(0, 255, (120, 80, 3), dtype=np.uint8)]
    out = lib.host_preprocess_batch(arrays, image_size=48, mean=MEAN, std=STD,
                                    interpolation=interp, resize_mode=mode, chw=True)
    pre = Preprocessor(image_size=48, mean=MEAN, std=STD, interpolation=interp,
                       resize_mode=mode, device="cpu", layout="nchw")
    with torch.inference_mode():
        ref = pre(arrays)[:2].numpy()
    assert out.shape == ref.shape == (2, 3, 48, 48)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    hwc = lib.host_preprocess_batch(arrays, image_size=48, mean=MEAN, std=STD,
                                    interpolation=interp, resize_mode=mode, chw=False)
    np.testing.assert_allclose(hwc.transpose(0, 3, 1, 2), out, atol=1e-6)


def test_host_preprocess_threads_and_input_checks(lib):
    rng = np.random.default_rng(2)
    arrays = [rng.integers(0, 255, (40 + i, 60, 3), dtype=np.uint8) for i in range(8)]
    one = lib.host_preprocess_batch(arrays, image_size=32, mean=MEAN, std=STD, n_threads=1)
    four = lib.host_preprocess_batch(arrays, image_size=32, mean=MEAN, std=STD, n_threads=4)
    np.testing.assert_array_equal(one, four)
    with pytest.raises(ImageError, match="interpolation"):
        lib.host_preprocess_batch(arrays, image_size=32, mean=MEAN, std=STD,
                                  interpolation="lanczos")
    with pytest.raises(ImageError, match="Expected"):
        lib.host_preprocess_batch([np.zeros((4, 4), np.uint8)], image_size=8, mean=MEAN,
                                  std=STD)
    with pytest.raises(ImageError, match="Empty"):
        lib.host_preprocess_batch([np.zeros((0, 4, 3), np.uint8)], image_size=8, mean=MEAN,
                                  std=STD)


def test_to_rgb_array_takes_the_native_path(lib, monkeypatch):
    """JPEG bytes go through ``native.decode_jpeg`` unless
    CLIP_TPU_NO_NATIVE_DECODE is set; PNG bytes and undecodable JPEGs
    through Pillow, with the same pixels and Pillow's errors."""
    calls = []
    real = lib.decode_jpeg
    monkeypatch.setattr(native, "decode_jpeg", lambda d: calls.append(len(d)) or real(d))
    data = _jpeg((24, 31), 90, 4)
    fast = images.to_rgb_array(data)
    assert len(calls) == 1
    monkeypatch.setenv("CLIP_TPU_NO_NATIVE_DECODE", "1")
    slow = images.to_rgb_array(data)
    assert len(calls) == 1
    np.testing.assert_array_equal(fast, slow)
    monkeypatch.delenv("CLIP_TPU_NO_NATIVE_DECODE")

    img = Image.fromarray(np.random.default_rng(5).integers(0, 255, (9, 7, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    np.testing.assert_array_equal(images.to_rgb_array(buf.getvalue()), np.asarray(img))
    assert len(calls) == 1
    with pytest.raises(ImageError, match="Image error"):
        images.to_rgb_array(b"\xff\xd8not actually a jpeg")
    assert len(calls) == 2  # tried natively, then Pillow raised


def test_to_rgb_array_falls_back_without_the_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "missing.so")
    native._lib.cache_clear()
    try:
        data = _jpeg((12, 10), 90, 6)
        np.testing.assert_array_equal(images.to_rgb_array(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    finally:
        native._lib.cache_clear()

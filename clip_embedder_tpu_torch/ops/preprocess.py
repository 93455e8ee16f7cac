"""Image preprocessing: resize + center-crop + normalize as two matmuls.

Counterpart of ``clip_embedder_tpu.ops.preprocess``. A convolution resize
(what PIL and fast_image_resize implement — reference: src/vision.rs:142-259)
is, per axis, a linear map, so the whole resize is two small matmuls:

    out[o, p] = Σ_h Σ_w  Wh[o, h] · img[h, w] · Ww[p, w]

The per-image weight matrices are built on the host by the numpy builders
below (copied verbatim from the JAX package: exact Pillow CatmullRom /
bilinear / nearest math, antialias support widening, edge renormalization,
the centered "shortest" crop folded into the sampling coordinates). The
device side runs both contractions in full f32: TF32 or bf16 passes would
cost about two u8 pixel steps after the /std and break Pillow parity, so
the embedders turn TF32 off on the card (``vision.resolve_device``).

Variable source sizes are padded into 128-multiple buckets; the weight
matrices are zero beyond each image's true extent.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from ..errors import ImageError


# ---------------------------------------------------------------------------
# filter kernels (Pillow/fast_image_resize "Convolution" family)
# ---------------------------------------------------------------------------

def _catmull_rom(x: np.ndarray) -> np.ndarray:
    """Keys cubic with a = -0.5 — Pillow's BICUBIC and fir's CatmullRom."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    a = -0.5
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {
    "bicubic": (_catmull_rom, 2.0),
    "bilinear": (_bilinear, 1.0),
}


def resize_weights(
    out_size: int,
    in_size: int,
    *,
    crop_start: float = 0.0,
    crop_size: float | None = None,
    interpolation: str = "bicubic",
    padded_in_size: int | None = None,
) -> np.ndarray:
    """Build the [out_size, padded_in_size] convolution-resize weight matrix
    mapping a source axis (optionally restricted to a crop window) onto the
    output axis. Implements Pillow's precompute_coeffs math: antialiased
    support scaling and edge-window renormalization.
    """
    if in_size <= 0:
        raise ImageError(f"Invalid source dimension {in_size}")
    if crop_size is None:
        crop_size = float(in_size)
    padded = padded_in_size or in_size
    weights = np.zeros((out_size, padded), dtype=np.float32)
    scale = crop_size / out_size

    if interpolation in _FILTERS:
        kernel, support = _FILTERS[interpolation]
        filterscale = max(scale, 1.0)
        support = support * filterscale
        for i in range(out_size):
            center = crop_start + (i + 0.5) * scale
            xmin = max(int(center - support + 0.5), 0)
            xmax = min(int(center + support + 0.5), in_size)
            xs = np.arange(xmin, xmax, dtype=np.float64)
            w = kernel((xs + 0.5 - center) / filterscale)
            total = w.sum()
            if total != 0:
                w = w / total
            weights[i, xmin:xmax] = w
    elif interpolation == "nearest":
        for i in range(out_size):
            src = int(crop_start + (i + 0.5) * scale)
            src = min(max(src, 0), in_size - 1)
            weights[i, src] = 1.0
    else:
        raise ImageError(f"Unsupported interpolation '{interpolation}'")
    return weights


def shortest_crop_box(width: int, height: int) -> tuple[float, float, float]:
    """The reference's "shortest" resize mode: centered square crop of side
    min(w, h) (reference: src/vision.rs:184-192). Returns
    (crop_x, crop_y, crop_side) as floats.
    """
    side = float(min(width, height))
    return ((width - side) / 2.0, (height - side) / 2.0, side)


def preprocess_weights_for(
    width: int,
    height: int,
    target: int,
    *,
    interpolation: str = "bicubic",
    resize_mode: str = "shortest",
    padded_h: int | None = None,
    padded_w: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-image (Wh [target, padded_h], Ww [target, padded_w]) weight pair
    encoding crop + resize for one source size."""
    if resize_mode == "squash":
        cx, cy, cw, ch = 0.0, 0.0, float(width), float(height)
    else:
        cx, cy, side = shortest_crop_box(width, height)
        cw = ch = side
    wh = resize_weights(
        target, height, crop_start=cy, crop_size=ch,
        interpolation=interpolation, padded_in_size=padded_h,
    )
    ww = resize_weights(
        target, width, crop_start=cx, crop_size=cw,
        interpolation=interpolation, padded_in_size=padded_w,
    )
    return wh, ww


# ---------------------------------------------------------------------------
# device-side resize + normalize
# ---------------------------------------------------------------------------

def _resize_body(images_u8, wh, ww, mean, std, out_dtype, layout):
    x = images_u8.to(torch.float32)
    whs = wh * (1.0 / 255.0)
    # rows: Σ_h img[h, (w,c)] · Wh[s, h] -> [B, Wp, C, S]
    x = torch.einsum("bhwc,bsh->bwcs", x, whs)
    # cols: Σ_w x1[w, (c,s)] · Ww[t, w] -> [B, C, S, T]
    x = torch.einsum("bwcs,btw->bcst", x, ww)
    x = (x - mean[None, :, None, None]) / std[None, :, None, None]
    if layout == "nchw":
        return x.to(out_dtype)
    if layout != "nhwc":
        raise ImageError(f"Unknown preprocess layout '{layout}'")
    return x.permute(0, 2, 3, 1).to(out_dtype)


def resize_normalize(
    images_u8: torch.Tensor,   # [B, Hp, Wp, 3] uint8 (zero-padded)
    wh: torch.Tensor,          # [B, S, Hp] f32
    ww: torch.Tensor,          # [B, S, Wp] f32
    mean: torch.Tensor,        # [3]
    std: torch.Tensor,         # [3]
    out_dtype: torch.dtype = torch.float32,
    layout: str = "nhwc",
) -> torch.Tensor:
    """u8 → f32/255 → crop+resize (two f32 matmuls) → (x − mean)/std.
    Returns [B, S, S, 3] (``layout="nhwc"``) or [B, 3, S, S] (``"nchw"``)
    in ``out_dtype``."""
    return _resize_body(images_u8, wh, ww, mean, std, out_dtype, layout)


def resize_normalize_indexed(
    images_u8: torch.Tensor,   # [B, Hp, Wp, 3] uint8 (zero-padded)
    whs_u: torch.Tensor,       # [U, S, Hp] f32 — unique row-resize matrices
    wws_u: torch.Tensor,       # [U, S, Wp] f32
    idx: torch.Tensor,         # [B] int — image i uses matrices idx[i]
    mean: torch.Tensor,
    std: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
    layout: str = "nhwc",
) -> torch.Tensor:
    """``resize_normalize`` with deduplicated weight matrices: the host
    stages only the unique matrices plus a [B] index, gathered on device."""
    return _resize_body(images_u8, whs_u[idx], wws_u[idx], mean, std,
                        out_dtype, layout)


def bucket_size(n: int, *, multiple: int = 128) -> int:
    """Round a source dimension up to a 128-multiple bucket so arbitrary
    image sizes reuse a bounded program set (every size, including >4096px
    giants, lands on a multiple — never an exact per-image size)."""
    return max(multiple, math.ceil(n / multiple) * multiple)


def bucket_batch(n: int) -> int:
    """Round batch size up to a power of two (min 1)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class Preprocessor:
    """Batches heterogeneous images into bucketed device tensors.

    Host side does only: decode → np.asarray → weight-matrix build (µs);
    everything pixel-heavy runs on ``device``. This replaces the reference's
    rayon-parallel host loop (reference: src/vision.rs:120-135).
    """

    def __init__(self, *, image_size: int, mean, std, interpolation: str,
                 resize_mode: str, device: torch.device,
                 out_dtype: torch.dtype = torch.float32, layout: str = "nhwc"):
        self.image_size = image_size
        self.device = torch.device(device)
        self.mean = torch.tensor(mean, dtype=torch.float32, device=self.device)
        self.std = torch.tensor(std, dtype=torch.float32, device=self.device)
        self.interpolation = interpolation
        self.resize_mode = resize_mode
        self.out_dtype = out_dtype
        self.layout = layout  # "nhwc" | "nchw" (zero-transpose ViT handoff)
        self._weights_cache: dict[tuple, tuple[np.ndarray, np.ndarray]] = {}
        self._weights_lock = threading.Lock()

    _WEIGHTS_CACHE_MAX = 128  # matrices are MBs each but µs to rebuild:
    # keep a small LRU so heterogeneous bulk workloads can't grow the host
    # cache unboundedly.

    def _weights(self, w: int, h: int, ph: int, pw: int):
        """The resize matrices for one (source, padded) size, from an LRU
        shared by every thread that embeds through this preprocessor (a
        server's handler threads and its micro-batcher). The lock covers
        only the cache's bookkeeping; a miss builds its matrices outside
        it, so one slow miss does not hold up the hits (two threads that
        miss on one key both build it, and the second insert wins)."""
        key = (w, h, ph, pw)
        with self._weights_lock:
            hit = self._weights_cache.pop(key, None)
            if hit is not None:  # LRU touch: back to the end
                self._weights_cache[key] = hit
                return hit
        hit = preprocess_weights_for(
            w, h, self.image_size,
            interpolation=self.interpolation, resize_mode=self.resize_mode,
            padded_h=ph, padded_w=pw,
        )
        with self._weights_lock:
            self._weights_cache.pop(key, None)
            while len(self._weights_cache) >= self._WEIGHTS_CACHE_MAX:
                self._weights_cache.pop(next(iter(self._weights_cache)))
            self._weights_cache[key] = hit
        return hit

    def stage_host_batch_unique(
        self, arrays: list[np.ndarray]
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Host staging with deduplicated weight matrices: returns
        (batch_u8, whs_u [U, S, Hp], wws_u [U, S, Wp], idx [B]).
        U is bucketed to a power of two (bounded program set); padded batch
        rows index slot 0. For homogeneous bulk streams this cuts the
        staged bytes ~3× (one matrix pair instead of one per image)."""
        if not arrays:
            raise ImageError("Empty batch")
        bb = bucket_batch(len(arrays))
        ph = bucket_size(max(a.shape[0] for a in arrays))
        pw = bucket_size(max(a.shape[1] for a in arrays))

        batch = np.zeros((bb, ph, pw, 3), dtype=np.uint8)
        idx = np.zeros((bb,), dtype=np.int32)
        slots: dict[tuple[int, int], int] = {}
        pairs: list[tuple[np.ndarray, np.ndarray]] = []
        for i, a in enumerate(arrays):
            h, w = a.shape[:2]
            batch[i, :h, :w] = a
            slot = slots.get((w, h))
            if slot is None:
                slot = slots[(w, h)] = len(pairs)
                pairs.append(self._weights(w, h, ph, pw))
            idx[i] = slot
        ub = bucket_batch(len(pairs))
        whs_u = np.zeros((ub, self.image_size, ph), dtype=np.float32)
        wws_u = np.zeros((ub, self.image_size, pw), dtype=np.float32)
        for j, (wh, ww) in enumerate(pairs):
            whs_u[j] = wh
            wws_u[j] = ww
        return batch, whs_u, wws_u, idx

    def __call__(self, arrays: list[np.ndarray]) -> torch.Tensor:
        """list of [H, W, 3] uint8 arrays → [B, S, S, 3] (or [B, 3, S, S]
        for layout="nchw") preprocessed batch (padded to the batch bucket;
        caller slices to len(arrays))."""
        batch, whs_u, wws_u, idx = self.stage_host_batch_unique(arrays)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        return resize_normalize_indexed(
            dev(batch), dev(whs_u), dev(wws_u), dev(idx).long(), self.mean,
            self.std, out_dtype=self.out_dtype, layout=self.layout,
        )

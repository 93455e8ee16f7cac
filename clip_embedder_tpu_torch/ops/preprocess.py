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
matrices are zero beyond each image's true extent, so the pixels past an
image are never zeroed (``Preprocessor``'s staging buffers are reused as
they are); only the rows past the batch are, so that a padded row is the
normalised zero image, as the JAX package's is. On the card the resize of
each padded shape is captured once as a CUDA graph and replayed
(``utils.captured``), as the JAX package jits it per shape.
"""

from __future__ import annotations

import math
import threading
import warnings

import numpy as np
import torch

from ..errors import ImageError
from ..utils import captured
from ..utils import logging as tracing


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


def _unique_sizes(arrays, lookup) -> tuple[list, list[int]]:
    """``lookup(w, h)`` of each distinct (w, h) size in the batch, in order
    of first appearance, and each image's slot among them."""
    found: dict[tuple[int, int], int] = {}
    pairs, slots = [], []
    for a in arrays:
        h, w = a.shape[:2]
        if (w, h) not in found:
            found[(w, h)] = len(pairs)
            pairs.append(lookup(w, h))
        slots.append(found[(w, h)])
    return pairs, slots


class _Staging:
    """The reused buffers of one (device, batch bucket, Hp, Wp) shape: the
    uint8 batch and the [B] slot index on the host (page-locked on the
    card) and on the device (on the CPU the same tensors), the resize
    matrices' device buffers by U (``matrices``), and the event of the last
    copy out of the host buffers (``copied``; None on the CPU).

    The pixels of a real row past its image are never zeroed: they meet
    only zero weights (``resize_weights`` gives every column at or past the
    image's extent exactly 0), and uint8 is always finite. A padded row
    (past the batch) must be the zero image, as the JAX package's zero-filled
    staging makes it, so that it resizes to (0 - mean) / std: ``rows`` is
    the number of leading host rows that may hold pixels (the whole bucket
    while the buffer is as ``torch.empty`` left it), and ``zero_past``
    clears those past a call's images. A padded row reads slot 0."""

    def __init__(self, device: torch.device, bb: int, ph: int, pw: int, image_size: int):
        card = device.type == "cuda"
        self.device, self.image_size = device, image_size
        self.host = torch.empty((bb, ph, pw, 3), dtype=torch.uint8, pin_memory=card)
        self.rows = bb
        self.host_idx = torch.zeros((bb,), dtype=torch.int64, pin_memory=card)
        self.images = torch.empty_like(self.host, device=device) if card else self.host
        self.idx = torch.zeros((bb,), dtype=torch.int64, device=device) if card else self.host_idx
        self.copied = torch.cuda.Event() if card else None
        self.matrices: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def zero_past(self, n: int) -> None:
        """Zero the host rows from ``n`` up to ``rows`` (those a call of
        ``n`` images leaves padded that may hold pixels); ``rows`` is then
        ``n``, which the call's images fill."""
        if n < self.rows:
            self.host[n:self.rows].zero_()
        self.rows = n

    def matrices_for(self, u: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The [U, S, Hp] and [U, S, Wp] f32 matrix buffers (zero at first,
        so that an unfilled slot is finite)."""
        if u not in self.matrices:
            s, (_, ph, pw, _) = self.image_size, self.host.shape
            self.matrices[u] = (torch.zeros((u, s, ph), dtype=torch.float32, device=self.device),
                                torch.zeros((u, s, pw), dtype=torch.float32, device=self.device))
        return self.matrices[u]


class Preprocessor:
    """Batches heterogeneous images into bucketed device tensors.

    Host side does only: decode → np.asarray → weight-matrix build (µs);
    everything pixel-heavy runs on ``device``. This replaces the reference's
    rayon-parallel host loop (reference: src/vision.rs:120-135).

    A call (``run``) writes each image once into the reused staging
    buffers of its (device, batch bucket, Hp, Wp) shape (``_Staging``: on
    the card page-locked, copied to the device ``non_blocking``; at most
    ``_STAGING_MAX`` shapes and ``_STAGING_BYTES`` bytes of host batch
    kept, least recently used first out; the rows past the batch zeroed
    where an earlier call, or ``torch.empty``, left them holding bytes, so
    that each padded row is the normalised zero image, as the JAX package's
    is), assembles the unique resize
    matrices on the device from a device LRU of them (``_device_weights``,
    at most ``_DEVICE_WEIGHTS_BYTES`` a preprocessor: one pair at Hp = 768,
    Wp = 1024 is 2.75 MB), and resizes: on the card by replaying the
    shape's captured graph (``utils.captured``, per (device, bucket, Hp,
    Wp, U, layout, out_dtype), as the JAX package jits
    ``resize_normalize_indexed`` per shape; one pool for all of them, the
    products in full f32), on the CPU eagerly. One lock serialises the
    calls: ``ClipServer`` calls one preprocessor from its handler threads
    and its micro-batcher at once. ``eager`` is the plain route the staged
    one is held to.
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
        self._device_weights_cache: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        self._device_weights_bytes = 0
        self._device_weights_lock = threading.Lock()
        self._staging: dict[tuple, _Staging] = {}
        self._norms = {self.device: (self.mean, self.std)}
        self._lock = threading.Lock()

    _WEIGHTS_CACHE_MAX = 128  # matrices are MBs each but µs to rebuild:
    # keep a small LRU so heterogeneous bulk workloads can't grow the host
    # cache unboundedly.
    _DEVICE_WEIGHTS_BYTES = 256 << 20
    # page-locked memory is slow to allocate and finite, and a shape's first
    # call also captures its graph: keep room for a server's six micro-batch
    # buckets (1-32) over five padded sizes, within the byte bound (its
    # device buffers take as much again)
    _STAGING_MAX = 32
    _STAGING_BYTES = 2 << 30

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

    def _device_weights(self, device: torch.device, w: int, h: int, ph: int, pw: int):
        """``_weights``' matrices as f32 tensors on ``device``, from an LRU
        beside the host one, keyed by device and the same key, with the
        same locking: a bulk stream of a few sizes uploads no matrix after
        its first batch. It holds at most ``_DEVICE_WEIGHTS_BYTES``; a
        miss uploads outside the lock."""
        key = (device, w, h, ph, pw)
        with self._device_weights_lock:
            hit = self._device_weights_cache.pop(key, None)
            if hit is not None:
                self._device_weights_cache[key] = hit
                return hit
        hit = tuple(torch.from_numpy(m).to(device) for m in self._weights(w, h, ph, pw))
        nbytes = sum(m.nbytes for m in hit)
        with self._device_weights_lock:
            cache = self._device_weights_cache
            old = cache.pop(key, None)
            if old is not None:
                self._device_weights_bytes -= sum(m.nbytes for m in old)
            while cache and self._device_weights_bytes + nbytes > self._DEVICE_WEIGHTS_BYTES:
                self._device_weights_bytes -= sum(m.nbytes for m in cache.pop(next(iter(cache))))
            cache[key] = hit
            self._device_weights_bytes += nbytes
        return hit

    def padded_size(self, arrays: list[np.ndarray]) -> tuple[int, int]:
        """(Hp, Wp): the 128-multiple buckets of the batch's largest sizes."""
        return (bucket_size(max(a.shape[0] for a in arrays)),
                bucket_size(max(a.shape[1] for a in arrays)))

    def stage_host_batch(
        self, arrays: list[np.ndarray], *, batch_bucket: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense staging: per-image weight matrices ([B, S, Hp/Wp]).
        Thin expansion over ``stage_host_batch_unique`` (the library paths
        all use the deduplicated form; this keeps the dense layout
        available for debugging/tools without duplicating staging logic)."""
        batch, whs_u, wws_u, idx = self.stage_host_batch_unique(
            arrays, batch_bucket=batch_bucket)
        return batch, whs_u[idx], wws_u[idx]

    def stage_host_batch_unique(
        self, arrays: list[np.ndarray], *, batch_bucket: int | None = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Host staging with deduplicated weight matrices: returns
        (batch_u8, whs_u [U, S, Hp], wws_u [U, S, Wp], idx [B]), B being
        ``batch_bucket`` (default: the power-of-two bucket of the batch).
        U is bucketed to a power of two (bounded program set); padded batch
        rows index slot 0. For homogeneous bulk streams this cuts the
        staged bytes ~3× (one matrix pair instead of one per image)."""
        if not arrays:
            raise ImageError("Empty batch")
        bb = batch_bucket or bucket_batch(len(arrays))
        ph, pw = self.padded_size(arrays)

        batch = np.zeros((bb, ph, pw, 3), dtype=np.uint8)
        idx = np.zeros((bb,), dtype=np.int32)
        for i, a in enumerate(arrays):
            h, w = a.shape[:2]
            batch[i, :h, :w] = a
        pairs, slots = _unique_sizes(arrays, lambda w, h: self._weights(w, h, ph, pw))
        idx[:len(slots)] = slots
        ub = bucket_batch(len(pairs))
        whs_u = np.zeros((ub, self.image_size, ph), dtype=np.float32)
        wws_u = np.zeros((ub, self.image_size, pw), dtype=np.float32)
        for j, (wh, ww) in enumerate(pairs):
            whs_u[j] = wh
            wws_u[j] = ww
        return batch, whs_u, wws_u, idx

    def eager(self, arrays: list[np.ndarray]) -> torch.Tensor:
        """The plain route (the reference ``run`` is held to): a zero-filled
        host batch and the stacked matrices made anew, copied from pageable
        memory, resized eagerly on ``device``."""
        batch, whs_u, wws_u, idx = self.stage_host_batch_unique(arrays)

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        return resize_normalize_indexed(
            dev(batch), dev(whs_u), dev(wws_u), dev(idx).long(), self.mean,
            self.std, out_dtype=self.out_dtype, layout=self.layout,
        )

    def __call__(self, arrays: list[np.ndarray]) -> torch.Tensor:
        """list of [H, W, 3] uint8 arrays → [B, S, S, 3] (or [B, 3, S, S]
        for layout="nchw") preprocessed batch, padded to the batch bucket:
        each padded row the normalised zero image, as the JAX package's
        (the caller slices to len(arrays))."""
        return self.run(arrays)

    def run(self, arrays: list[np.ndarray], *, device: torch.device | str | None = None,
            batch_bucket: int | None = None,
            padded: tuple[int, int] | None = None) -> torch.Tensor:
        """``__call__`` on ``device`` (default: the preprocessor's) with the
        batch bucket and (Hp, Wp) given or taken from the batch: the staged
        route (class docstring). A mesh shard passes the whole batch's
        (Hp, Wp) and its own rows, which may be none: then every row is
        the normalised zero image. Timed as the span ``preprocess.call``
        (``utils.logging``; attr ``drained``: the device's current stream had
        no pending work as the call began, always true on the CPU)."""
        if not arrays and batch_bucket is None:
            raise ImageError("Empty batch")
        device = self.device if device is None else torch.device(device)
        if device.type == "cuda" and device.index is None:  # one key a card
            device = torch.device("cuda", torch.cuda.current_device())
        bb = batch_bucket or bucket_batch(len(arrays))
        ph, pw = padded or self.padded_size(arrays)
        # on the card, whether the stream this call enqueues on had drained
        drained = device.type != "cuda" or torch.cuda.current_stream(device).query()
        with tracing.span("preprocess.call", drained=drained):
            with torch.inference_mode(), self._lock:
                entry, pairs = self._stage(arrays, device, bb, ph, pw)
                return self._resize(entry, pairs)

    def _staging_for(self, device: torch.device, bb: int, ph: int, pw: int) -> _Staging:
        """The shape's staging buffers (made at its first call; the least
        recently used shapes dropped, with their graphs, past the bounds).
        The caller holds ``_lock``."""
        key = (device, bb, ph, pw)
        entry = self._staging.pop(key, None)
        if entry is None:
            nbytes = bb * ph * pw * 3
            while self._staging and (
                    len(self._staging) >= self._STAGING_MAX
                    or sum(e.host.nbytes for e in self._staging.values()) + nbytes
                    > self._STAGING_BYTES):
                self._drop(next(iter(self._staging)))
            entry = _Staging(device, bb, ph, pw, self.image_size)
        self._staging[key] = entry
        return entry

    def _drop(self, key: tuple) -> None:
        del self._staging[key]
        graphs = captured.graphs_of(self)
        if graphs is not None:
            with graphs.lock:
                for k in [k for k in graphs.graphs if k[:4] == key]:
                    del graphs.graphs[k]

    def _stage(self, arrays, device, bb, ph, pw) -> tuple[_Staging, list]:
        """The host half of a call: the rows past the batch zeroed where
        they may hold pixels (``_Staging.zero_past``) and each image written
        once into the shape's host buffer (after the last copy out of it has
        finished), its slot index beside it, and the unique matrices' device
        pairs. The caller holds ``_lock``. Timed as the span
        ``preprocess.stage``."""
        with tracing.span("preprocess.stage"):
            entry = self._staging_for(device, bb, ph, pw)
            if entry.copied is not None:
                entry.copied.synchronize()
            entry.zero_past(len(arrays))
            with warnings.catch_warnings():
                # decoded images are read-only arrays; their tensors are only read
                warnings.filterwarnings("ignore", "The given NumPy array is not writable")
                for i, a in enumerate(arrays):
                    h, w = a.shape[:2]
                    entry.host[i, :h, :w].copy_(torch.from_numpy(np.ascontiguousarray(a)))
            pairs, slots = _unique_sizes(
                arrays, lambda w, h: self._device_weights(device, w, h, ph, pw))
            entry.host_idx.copy_(torch.tensor(slots + [0] * (bb - len(slots)),
                                              dtype=torch.int64))
            return entry, pairs

    def _norm(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        if device not in self._norms:
            self._norms[device] = (self.mean.to(device), self.std.to(device))
        return self._norms[device]

    def _resize(self, entry: _Staging, pairs: list) -> torch.Tensor:
        """The device half of a call: the copies to the device, the unique
        matrices stacked into the U buffers, and the resize, replayed on the
        card. The caller holds ``_lock``."""
        device = entry.device
        u = bucket_batch(len(pairs))
        whs, wws = entry.matrices_for(u)
        mean, std = self._norm(device)

        def resize():
            return resize_normalize_indexed(entry.images, whs, wws, entry.idx, mean, std,
                                            out_dtype=self.out_dtype, layout=self.layout)

        def fill():
            if pairs:
                torch.stack([wh for wh, _ in pairs], out=whs[:len(pairs)])
                torch.stack([ww for _, ww in pairs], out=wws[:len(pairs)])

        if device.type != "cuda":
            fill()
            return resize()
        graphs = captured.graphs_of(self, create=True)
        key = (device, *entry.host.shape[:3], u, self.layout, self.out_dtype)
        with graphs.lock, torch.cuda.device(device), graphs.in_order(device) as stream:
            entry.images.copy_(entry.host, non_blocking=True)
            entry.idx.copy_(entry.host_idx, non_blocking=True)
            entry.copied.record(stream)
            fill()
            g = graphs.graphs.get(key)
            if g is None:
                # full f32 products, whatever the process's TF32 flag
                g = graphs.graphs[key] = graphs.capture(
                    resize, device, (entry.images, whs, wws, entry.idx),
                    what="the preprocess resize", tf32=False)
            g.replay()
            return g.output.clone()

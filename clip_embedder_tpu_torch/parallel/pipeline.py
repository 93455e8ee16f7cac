"""Asynchronous bulk-embedding pipeline: host decode overlapped with device
compute.

Counterpart of ``clip_embedder_tpu.parallel.pipeline`` (reference:
examples/search.rs:49, rayon preprocessing src/vision.rs:128-132): a host
thread pool decodes the next batches while the device embeds the current
one. Kernel launches are asynchronous, so the pipeline keeps batch N's
rows on the device (``embed_images_device``) until batch N+1 has been
launched, and only then reads N back.

Each ``embed_iter`` call numbers its batches from 0: the spans of batch b
(``utils.logging``), its preprocess's and its read-back's
(``pipeline.read_back``), share the trace ``("embed_iter-<k>", b)``, k
numbering the calls in the process.
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
from typing import Any, Iterable, Iterator, Sequence

import numpy as np

from ..errors import InferenceError
from ..utils import logging as tracing
from ..utils.images import to_rgb_array

_calls = itertools.count()


def _read_back(embs, n: int) -> np.ndarray:
    with tracing.span("pipeline.read_back"):
        return embs[:n].float().cpu().numpy()


def _read_back_batch(trace, embs, n: int) -> np.ndarray:
    with tracing.in_trace(trace):
        return _read_back(embs, n)


class EmbedPipeline:
    """Stream images through a (possibly mesh-sharded) vision embedder.

    embedder: VisionEmbedder or ShardedVisionEmbedder (anything with
    ``embed_images``; ``embed_images_device`` where it has one).
    ``batch_size`` is the device batch; ``prefetch`` bounds how many
    decoded batches may wait ahead of the device.
    """

    def __init__(self, embedder, *, batch_size: int = 32, decode_workers: int = 8,
                 prefetch: int = 2):
        self.embedder = embedder
        self.batch_size = batch_size
        self.decode_workers = decode_workers
        self.prefetch = max(1, prefetch)

    @staticmethod
    def _submit_batch(pool: cf.Executor, batch: Sequence[Any]) -> list[cf.Future]:
        # per-image futures: every worker decodes for the batches in flight,
        # so decode-bound streams use the whole pool
        return [pool.submit(to_rgb_array, img) for img in batch]

    def embed_iter(self, images: Iterable[Any]) -> Iterator[np.ndarray]:
        """Yield one [batch, D] embedding array per input batch, in order.
        Decode of batch N+prefetch proceeds while batch N computes."""
        items = iter(images)

        def take() -> list[Any] | None:
            chunk = []
            for img in items:
                chunk.append(img)
                if len(chunk) == self.batch_size:
                    break
            return chunk or None

        embed_dev = getattr(self.embedder, "embed_images_device", None)
        call = f"embed_iter-{next(_calls)}"
        batch_numbers = itertools.count()

        with cf.ThreadPoolExecutor(self.decode_workers) as pool:
            pending: list[list[cf.Future]] = []
            for _ in range(self.prefetch):  # prime the decode pipeline
                chunk = take()
                if chunk is None:
                    break
                pending.append(self._submit_batch(pool, chunk))

            # batch N's read-back happens only after batch N+1 has been
            # staged and launched, so N+1's upload and compute overlap the
            # wait for N
            dev_pending: list[tuple[tuple, Any, int]] = []
            while pending:
                try:
                    arrays = [fut.result() for fut in pending.pop(0)]
                    chunk = take()
                    if chunk is not None:
                        pending.append(self._submit_batch(pool, chunk))
                    if embed_dev is None:  # duck-typed, no async variant
                        yield self.embedder.embed_images(arrays)
                        continue
                    trace = (call, next(batch_numbers))
                    with tracing.in_trace(trace):
                        dev_pending.append((trace, *embed_dev(arrays)))
                except Exception:
                    # a failed batch must not swallow the earlier batches
                    # still in flight: yield them, then raise
                    for pending_batch in dev_pending:
                        yield _read_back_batch(*pending_batch)
                    raise
                while len(dev_pending) > 1:
                    yield _read_back_batch(*dev_pending.pop(0))
            for pending_batch in dev_pending:
                yield _read_back_batch(*pending_batch)

    def embed_all(self, images: Sequence[Any]) -> np.ndarray:
        """Embed a full collection, returning [N, D]."""
        outs = list(self.embed_iter(images))
        if not outs:
            raise InferenceError("Empty batch")
        return np.concatenate(outs, axis=0)

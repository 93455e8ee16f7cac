"""Device-resident sharded corpus search — semantic search at index scale.

Counterpart of ``clip_embedder_tpu.parallel.search`` (reference:
examples/search.rs:26-58, src/clip.rs:136-170 rank_images). The embedding
corpus lives row-sharded over one mesh axis, shard ``i`` on the first
device of that axis's entry ``i``; each shard scores the queries against
its rows alone ([Q, n_local], one ``torch.matmul``) and takes a local
top-k; the per-shard candidates (k values and global ids, not scores) are
concatenated on the first shard's device and the global top-k taken there.
The [Q, N] score matrix never exists in one piece and no corpus row moves
between devices.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from ..errors import InferenceError
from ..ops.preprocess import bucket_batch
from .mesh import DATA_AXIS, Mesh

PRECISIONS = ("highest", None)


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for f32 matmuls on or off while the block runs (a process-wide
    flag, restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _sharded_topk(queries: np.ndarray, shards: list[torch.Tensor], counts: list[int], *,
                  k: int, precision) -> tuple[torch.Tensor, torch.Tensor]:
    """Per shard: [Q, n_local] scores (rows past the shard's ``count`` are
    padding, scored -inf), the local top-min(k, n_local) and their global
    ids; then the global top-k over the concatenated candidates, on the
    first shard's device. Scores are f32 products in full f32 unless
    ``precision`` is None (TF32 allowed)."""
    first = shards[0].device
    vals, ids = [], []
    with torch.inference_mode(), _tf32(precision is None):
        q_on = {}
        for i, (shard, count) in enumerate(zip(shards, counts)):
            dev, n_local = shard.device, shard.shape[0]
            if dev not in q_on:
                q_on[dev] = torch.from_numpy(queries).to(dev, shard.dtype)
            scores = torch.matmul(q_on[dev], shard.T)
            scores[:, count:] = float("-inf")
            v, idx = torch.topk(scores, min(k, n_local), dim=1)
            vals.append(v.to(first))
            ids.append((idx + i * n_local).to(first))
        mvals, mpos = torch.topk(torch.cat(vals, dim=1), k, dim=1)
        return mvals, torch.gather(torch.cat(ids, dim=1), 1, mpos)


class CorpusIndex:
    """An [N, D] embedding corpus sharded row-wise over the mesh.

    Embeddings are expected L2-normalized (the embedders guarantee it), so
    the scores are cosine similarities. Rows added through ``add`` keep
    their insertion order as global ids; ``search`` returns those ids.
    ``precision="highest"`` scores in full f32; None lets f32 products use
    TF32 on the card.
    """

    def __init__(self, mesh: Mesh, embed_dim: int, *, dtype: torch.dtype = torch.float32,
                 axis: str = DATA_AXIS, precision: str | None = "highest"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.mesh = mesh
        self.embed_dim = int(embed_dim)
        self.dtype = dtype
        self.axis = axis
        self.precision = precision
        # shard i on the first device of the axis's entry i
        self.devices = list(mesh.devices[:, 0] if axis == DATA_AXIS else mesh.devices[0, :])
        self._n = 0
        self._shards: list[torch.Tensor] = []  # [n_local, D] each, zero-padded
        self._counts: list[int] = []           # real rows of each shard
        # host mirror of the unpadded rows: adds restage from host memory
        # instead of reading the corpus back from the devices
        self._host: np.ndarray | None = None

    @classmethod
    def build(cls, embeddings, mesh: Mesh, **kw) -> "CorpusIndex":
        embeddings = np.asarray(embeddings)
        index = cls(mesh, embeddings.shape[-1], **kw)
        index.add(embeddings)
        return index

    def __len__(self) -> int:
        return self._n

    @property
    def rows_per_shard(self) -> int:
        return self._shards[0].shape[0] if self._shards else 0

    def add(self, embeddings) -> None:
        """Append rows. Restages the sharded corpus (O(N) host bytes) —
        batch additions rather than adding row-by-row."""
        new = np.asarray(embeddings, dtype=np.float32)
        if new.ndim == 1:
            new = new[None, :]
        if new.ndim != 2 or new.shape[1] != self.embed_dim:
            raise InferenceError(f"corpus rows must be [*, {self.embed_dim}], got {new.shape}")
        if self._host is not None:
            new = np.concatenate([self._host, new], axis=0)
        self._host = new
        n, n_dev = new.shape[0], len(self.devices)
        # rows per shard bucket to powers of two: a growing corpus keeps
        # O(log N) shard shapes (the JAX package's compiled-program bound)
        n_local = bucket_batch(-(-n // n_dev))
        shards, counts = [], []
        for i, dev in enumerate(self.devices):
            rows = new[i * n_local:(i + 1) * n_local]
            shard = torch.zeros(n_local, self.embed_dim, dtype=self.dtype, device=dev)
            shard[: rows.shape[0]] = torch.from_numpy(rows).to(dev, self.dtype)
            shards.append(shard)
            counts.append(rows.shape[0])
        self._shards, self._counts, self._n = shards, counts, n

    def search(self, queries, k: int):
        """Top-k rows by cosine similarity for each query.

        ``queries``: [Q, D] or a single [D] vector. Returns
        ``(scores [Q, k], ids [Q, k])`` as numpy, scores descending; for a
        single vector the leading axis is dropped.
        """
        if self._n == 0:
            raise InferenceError("Empty corpus")
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        if q.shape[-1] != self.embed_dim:
            raise InferenceError(f"query dim {q.shape[-1]} != corpus dim {self.embed_dim}")
        k = int(k)
        if not 1 <= k <= self._n:
            raise InferenceError(f"k={k} must be in [1, {self._n}]")
        # Q and k bucket to powers of two, so searches of varying shapes
        # take a bounded set of product shapes (the zero query rows and the
        # k..kb candidate tail are sliced off; each shard still gives
        # min(k, n_local) candidates, so the true top-k survives)
        n_q = q.shape[0]
        qb = bucket_batch(n_q)
        if qb != n_q:
            q = np.concatenate([q, np.zeros((qb - n_q, q.shape[1]), q.dtype)])
        kb = min(bucket_batch(k), self.rows_per_shard * len(self._shards))
        vals, idx = _sharded_topk(q, self._shards, self._counts, k=kb,
                                  precision=self.precision)
        vals = vals.float().cpu().numpy()[:n_q, :k]
        idx = idx.cpu().numpy()[:n_q, :k]
        if single:
            return vals[0], idx[0]
        return vals, idx

    def search_texts(self, clip, texts: Sequence[str], k: int):
        """Text-to-corpus search through a ``Clip``'s text embedder — the
        scaled ``rank_images`` (reference: src/clip.rs:136-170): embed the
        queries, return the corpus top-k per query."""
        return self.search(clip.text.embed_texts(list(texts)), k)

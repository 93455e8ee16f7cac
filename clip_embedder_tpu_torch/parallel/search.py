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

On the card a search is captured as CUDA graphs once per (Q bucket, k
bucket) and the shards of one ``add`` (``utils.captured``), as the JAX
package jits ``_sharded_topk``: after the queries' upload, each device
replays one graph over its own shards (products, the ``-inf`` tail, the
local top-k), and the merge and the final top-k run on the first device
after the replays. ``add`` drops the graphs, which read the shards it
replaces.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from ..errors import InferenceError
from ..ops.preprocess import bucket_batch
from ..utils import captured
from .mesh import DATA_AXIS, Mesh

PRECISIONS = ("highest", None)


def _shard_candidates(q: torch.Tensor, shards: list[torch.Tensor], counts: list[int],
                      offsets: list[int], k: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per shard: [Q, n_local] scores (rows past the shard's ``count`` are
    padding, scored -inf), the local top-min(k, n_local) values and their
    global ids (the shard's row plus its ``offset``)."""
    out = []
    for shard, count, offset in zip(shards, counts, offsets):
        scores = torch.matmul(q, shard.T)
        scores[:, count:].fill_(float("-inf"))  # a fill on the device, capturable
        v, idx = torch.topk(scores, min(k, shard.shape[0]), dim=1)
        out.append((v, idx + offset))
    return out


def _merge(cands: list[tuple[torch.Tensor, torch.Tensor]], k: int,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The global top-k over the shards' candidates, in shard order, on
    ``device``."""
    mvals, mpos = torch.topk(torch.cat([v.to(device) for v, _ in cands], dim=1), k, dim=1)
    return mvals, torch.gather(torch.cat([i.to(device) for _, i in cands], dim=1), 1, mpos)


def _device_search(q, shards, counts, offsets, k: int):
    """What one device's search graph computes from its static queries
    ``q``: its shards' candidates, flat (values, ids, values, ...)."""
    def fn():
        cands = _shard_candidates(q, shards, counts, offsets, k)
        return tuple(t for pair in cands for t in pair)
    return fn


def _sharded_topk(queries: np.ndarray, shards: list[torch.Tensor], counts: list[int], *,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The search, eager: each shard's candidates (``_shard_candidates``)
    and the global top-k over them on the first shard's device. The f32
    products take the process's TF32 flag (off unless a caller turned it
    on; none on the CPU)."""
    first = shards[0].device
    with torch.inference_mode():
        q_on = {}
        cands = []
        for i, shard in enumerate(shards):
            dev = shard.device
            if dev not in q_on:
                q_on[dev] = torch.from_numpy(queries).to(dev, shard.dtype)
            cands += _shard_candidates(q_on[dev], [shard], [counts[i]], [i * shard.shape[0]], k)
        return _merge(cands, k, first)


class CorpusIndex:
    """An [N, D] embedding corpus sharded row-wise over the mesh.

    Embeddings are expected L2-normalized (the embedders guarantee it), so
    the scores are cosine similarities. Rows added through ``add`` keep
    their insertion order as global ids; ``search`` returns those ids.
    ``precision="highest"`` scores in full f32; None lets f32 products use
    TF32 on the card. One lock serialises the searches and adds.
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
        # each search key's runner (``_runner``), over the shards of one add
        self._runs: dict[tuple, object] = {}
        self._lock = threading.Lock()

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
        with self._lock:
            # the runners read the shards replaced here: a stale one would
            # search the old rows
            self._runs.clear()
            graphs = captured.graphs_of(self)
            if graphs is not None:
                with graphs.lock:
                    graphs.graphs.clear()
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
        with self._lock:
            key = (qb, kb, self.precision, tuple(tuple(s.shape) for s in self._shards),
                   tuple(self._counts))
            run = self._runs.get(key)
            if run is None:
                run = self._runs[key] = self._runner(qb, kb)
            vals, idx = run(q)
            vals = vals.float().cpu().numpy()[:n_q, :k]
            idx = idx.cpu().numpy()[:n_q, :k]
        if single:
            return vals[0], idx[0]
        return vals, idx

    def _runner(self, qb: int, kb: int):
        """The search of ``qb`` queries for ``kb`` candidates over the
        present shards, as a function of the [qb, D] queries: on the CPU
        ``_sharded_topk``; on the card the captured graphs (module
        docstring). The caller holds ``_lock``."""
        shards, counts, precision = self._shards, self._counts, self.precision
        first = shards[0].device
        if first.type != "cuda":
            return lambda q: _sharded_topk(q, shards, counts, k=kb)
        graphs = captured.graphs_of(self, create=True)
        on: dict[torch.device, list[int]] = {}
        for i, shard in enumerate(shards):
            on.setdefault(shard.device, []).append(i)
        n_local = shards[0].shape[0]
        parts = []
        for dev, ids in on.items():
            q = torch.zeros((qb, self.embed_dim), dtype=self.dtype, device=dev)
            fn = _device_search(q, [shards[i] for i in ids], [counts[i] for i in ids],
                                [i * n_local for i in ids], kb)
            with graphs.lock, torch.cuda.device(dev), graphs.in_order(dev):
                g = graphs.graphs[(dev, qb, kb, precision, len(ids))] = graphs.capture(
                    fn, dev, (q,), what="the corpus search", tf32=precision is None)
            parts.append((q, g, ids))

        def run(queries: np.ndarray):
            host = torch.from_numpy(queries)
            cands = {}
            with graphs.lock:
                for q, g, ids in parts:
                    with torch.cuda.device(q.device), graphs.in_order(q.device):
                        q.copy_(host)
                        g.replay()
                    cands.update(zip(ids, zip(g.output[::2], g.output[1::2])))
                # the shards' candidates in shard order, merged on the first
                # device before a later replay overwrites them
                with graphs.in_order(first):
                    return _merge([cands[i] for i in range(len(shards))], kb, first)

        return run

    def search_texts(self, clip, texts: Sequence[str], k: int):
        """Text-to-corpus search through a ``Clip``'s text embedder — the
        scaled ``rank_images`` (reference: src/clip.rs:136-170): embed the
        queries, return the corpus top-k per query."""
        return self.search(clip.text.embed_texts(list(texts)), k)

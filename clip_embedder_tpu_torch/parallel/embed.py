"""Mesh-sharded bulk embedding.

Counterpart of ``clip_embedder_tpu.parallel.embed``. The batch buckets to a
power of two aligned to the data axis, padded to the whole batch's (Hp, Wp);
data shard ``i`` then runs the inner embedder's preprocess on its rows
(``Preprocessor.run``: the shard's staging buffers, the resize matrices from
the preprocessor's device LRU) and its tower on the first device of mesh
row ``i`` — with the kernels, in every mode (DP, and DP under ``int8`` /
``int8_all``), as the JAX package's ``shard_map`` keeps its Pallas kernels
on local blocks — and the rows are gathered to the first device. On the
card each shard's preprocess resize and tower forward replay their captured
graphs (``utils.captured``, one a shard shape; mesh entries of one device
share the preprocessor's and the tower's graphs), as the JAX package
compiles one program per shard layout.

With ``tensor_parallel`` (the ``vit`` family only; other families fall back
to DP, as in the JAX package) each mesh row runs the tower's
tensor-parallel form over its model ranks (``parallel.tensor_parallel``),
on the eager attention core: a kernel ``attn_impl`` is overridden to
``"eager"`` with a one-time warning, as the JAX package overrides Pallas to
XLA. Quantized embedders refuse TP. On the card a row whose model ranks all
lie on one device (two ``cuda:0`` entries) replays its ``TPViT``'s captured
graph, one a shard shape, as the JAX package jits its tensor-parallel
forward; a row over several distinct cards runs its forward eagerly, a
route chosen by the layout (``captured.several_devices``): PyTorch's graph
capture does not span devices.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..errors import ConfigError, InferenceError
from ..ops.attention import KERNEL_IMPLS
from ..ops.preprocess import bucket_batch
from ..text import pad_batch, tower_kwargs
from ..utils import captured
from ..utils.images import to_rgb_array
from ..utils.logging import warn_once
from .mesh import DATA_AXIS, Mesh, pad_to_multiple, replicate
from .tensor_parallel import TPViT, tower_tree


def _batch_bucket(n: int, n_data: int) -> int:
    """Power-of-two batch bucket, aligned to the data-axis size."""
    return pad_to_multiple(bucket_batch(n), n_data)


def _gather(outs: list[torch.Tensor]) -> torch.Tensor:
    """The shards' rows, in order, on the first shard's device."""
    first = outs[0].device
    return torch.cat([o.to(first) for o in outs])


class ShardedVisionEmbedder:
    """Wraps a VisionEmbedder for data-parallel (optionally tensor-parallel)
    bulk embedding over a mesh."""

    def __init__(self, embedder, mesh: Mesh, *, tensor_parallel: bool = False):
        self.inner = embedder
        self.mesh = mesh
        if tensor_parallel and getattr(embedder, "quantize", None):
            raise ConfigError(
                "tensor_parallel is not supported with quantized embedders "
                "(TP partition specs describe full-precision param trees)")
        self.tensor_parallel = tensor_parallel = (
            tensor_parallel and embedder.spec.family == "vit")
        # each data shard runs on the first device of its mesh row
        self.devices = list(mesh.devices[:, 0])
        self.attn_impl = embedder.attn_impl
        if tensor_parallel:
            if self.attn_impl in KERNEL_IMPLS:
                warn_once(
                    "tp-kernel-override",
                    "tensor_parallel: overriding attn_impl=%r to 'eager' (the kernels take "
                    "whole heads on one device; the sharded forward runs the eager core)",
                    self.attn_impl)
                self.attn_impl = "eager"
            tree = tower_tree(embedder.tower)
            towers: dict[tuple, TPViT] = {}  # mesh rows over the same devices share one
            for row in mesh.devices:
                if tuple(row) not in towers:
                    towers[tuple(row)] = TPViT(embedder.spec.cfg, tree, row)
            self.towers = [towers[tuple(row)] for row in mesh.devices]
        else:
            replicas = replicate(embedder.tower, mesh)
            self.towers = [replicas[d] for d in self.devices]

    def embed_images(self, images: Sequence[Any]) -> np.ndarray:
        embs, n = self.embed_images_device(images)
        return embs[:n].float().cpu().numpy()

    def embed_images_device(self, images: Sequence[Any]) -> tuple[torch.Tensor, int]:
        """Async variant (see ``VisionEmbedder.embed_images_device``): the
        [bucket, D] rows on the first device, and n; no host sync."""
        if len(images) == 0:
            raise InferenceError("Empty batch")
        arrays = [to_rgb_array(img) for img in images]
        pp = self.inner.preprocessor
        padded = pp.padded_size(arrays)
        n_data = self.mesh.shape[DATA_AXIS]
        per = _batch_bucket(len(arrays), n_data) // n_data
        outs = []
        with torch.inference_mode():
            for i, (dev, tower) in enumerate(zip(self.devices, self.towers)):
                pixels = pp.run(arrays[i * per:(i + 1) * per], device=dev, batch_bucket=per,
                                padded=padded)
                if self.tensor_parallel and captured.several_devices(self.mesh.devices[i]):
                    outs.append(tower(pixels, attn_impl=self.attn_impl, channels_first=True))
                else:
                    outs.append(captured.forward(tower, pixels, attn_impl=self.attn_impl,
                                                 channels_first=True))
            return _gather(outs), len(arrays)


class ShardedTextEmbedder:
    """Data-parallel bulk text embedding over a mesh."""

    def __init__(self, embedder, mesh: Mesh):
        self.inner = embedder
        self.mesh = mesh
        self.devices = list(mesh.devices[:, 0])
        replicas = replicate(embedder.tower, mesh)
        self.towers = [replicas[d] for d in self.devices]

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        if len(texts) == 0:
            raise InferenceError("Empty batch")
        ids, mask = self.inner.tokenize(texts)
        n_data = self.mesh.shape[DATA_AXIS]
        ids, mask = pad_batch(ids, mask, _batch_bucket(len(texts), n_data), self.inner.pad_id)
        per = ids.shape[0] // n_data
        outs = []
        for i, (dev, tower) in enumerate(zip(self.devices, self.towers)):
            rows = slice(i * per, (i + 1) * per)
            # the tokenizer's mask is authoritative where the tower takes one
            outs.append(captured.forward(tower, torch.from_numpy(ids[rows]).to(dev),
                                         attn_impl=self.inner.attn_impl,
                                         **tower_kwargs(self.inner.spec, mask[rows], dev)))
        return _gather(outs)[: len(texts)].float().cpu().numpy()

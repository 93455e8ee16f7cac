"""Tensor-parallel partition specs for the tower parameter trees.

Counterpart of ``clip_embedder_tpu.parallel.sharding``: Megatron-style
sharding. The residual stream (embeddings, LayerNorms, projections) stays
replicated; attention q/k/v and MLP fc shard their *output* features
(heads / hidden) over the 'model' axis ("col") and the attention
out-projection / MLP proj their *input* features ("row"), so each sublayer
ends in one sum over the model axis, after which the row-parallel bias is
added once ("repl": every rank holds it).

The JAX package states this as ``PartitionSpec``s and leaves the rest to
GSPMD; here a ``Spec`` names the kind and the sharded dimension, counting
the leading layer axis of stacked blocks, and ``shard_params`` slices one
model rank's local tree (the counterpart of ``device_put`` with a
``NamedSharding``). ``parallel.tensor_parallel`` runs the forward on those
local trees.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..errors import ConfigError


class Spec(NamedTuple):
    """How one leaf lies over the model axis: ``kind`` is "col", "row" or
    "repl"; ``dim`` the dimension split over the model ranks (None for a
    replicated leaf). The JAX spec ``P(None, None, "model")`` is
    ``Spec("col", 2)``; ``P()`` is ``REPL``."""

    kind: str
    dim: int | None = None


REPL = Spec("repl")  # fully replicated leaf


class Sharded:
    """One leaf held as equal ``parts`` along ``dim``, each on its own device:
    the training path's tensor-parallel shards (``shard_params`` takes rank
    r's part as it is) and FSDP chunks (``gather`` joins them where a
    forward needs the whole leaf). The parts are the tensors an optimizer
    steps."""

    def __init__(self, parts: list, dim: int):
        self.parts, self.dim = list(parts), dim

    def dims(self) -> int:
        return self.parts[0].dim()

    def gather(self, device):
        """The whole leaf on ``device`` (autograd-tracked moves)."""
        return torch.cat([p.to(device) for p in self.parts], dim=self.dim)


def _linear_col(params: dict, *, stacked: bool) -> dict:
    """Column-parallel: shard output features."""
    lead = 1 if stacked else 0
    spec = {"w": Spec("col", lead + 1)}
    if "b" in params:
        spec["b"] = Spec("col", lead)
    return spec


def _linear_row(params: dict, *, stacked: bool) -> dict:
    """Row-parallel: shard input features; bias replicated (applied after
    the sum over the model axis)."""
    spec = {"w": Spec("row", 1 if stacked else 0)}
    if "b" in params:
        spec["b"] = REPL
    return spec


def _attn_specs(attn_params: dict, *, stacked: bool) -> dict:
    return {
        "q": _linear_col(attn_params["q"], stacked=stacked),
        "k": _linear_col(attn_params["k"], stacked=stacked),
        "v": _linear_col(attn_params["v"], stacked=stacked),
        "out": _linear_row(attn_params["out"], stacked=stacked),
    }


def _mlp_specs(mlp_params: dict, *, stacked: bool) -> dict:
    return {
        "fc": _linear_col(mlp_params["fc"], stacked=stacked),
        "proj": _linear_row(mlp_params["proj"], stacked=stacked),
    }


def _replicated_like(tree):
    if isinstance(tree, dict):
        return {k: _replicated_like(v) for k, v in tree.items()}
    return REPL


def tp_param_specs(params: dict, *, tower: str) -> dict:
    """A ``Spec`` tree matching ``params`` for 2-way+ tensor parallelism.
    tower: "vit" | "text". Leaves not named here (pos/cls/token embeddings,
    LNs, final projection) are replicated."""
    if tower not in ("vit", "text"):
        raise ValueError(f"Unknown tower '{tower}'")

    specs = {k: _replicated_like(v) for k, v in params.items()}
    block_params = params["blocks"]
    specs["blocks"] = {
        "ln1": _replicated_like(block_params["ln1"]),
        "ln2": _replicated_like(block_params["ln2"]),
        "attn": _attn_specs(block_params["attn"], stacked=True),
        "mlp": _mlp_specs(block_params["mlp"], stacked=True),
    }
    if "ls1" in block_params:
        # layer-scale gammas multiply sublayer outputs after the sum
        # (replicated activations): keep them replicated
        specs["blocks"]["ls1"] = REPL
        specs["blocks"]["ls2"] = REPL
    if "attn_pool" in params:
        # both pooler layouts: SigLIP/PE MAP pool ({probe, attn, ln, mlp})
        # and CoCa's AttentionalPooler ({query, ln_q, ln_k, attn}) —
        # queries/LNs replicate, the pooler attention shards by heads like
        # any attention, the MAP MLP like any MLP
        pool = params["attn_pool"]
        pool_specs = {k: _replicated_like(v) for k, v in pool.items()
                      if k not in ("attn", "mlp")}
        pool_specs["attn"] = _attn_specs(pool["attn"], stacked=False)
        if "mlp" in pool:
            pool_specs["mlp"] = _mlp_specs(pool["mlp"], stacked=False)
        specs["attn_pool"] = pool_specs
    return specs


def shard_params(params: dict, specs: dict, rank: int, n: int, *, path: str = "") -> dict:
    """Model rank ``rank``'s local tree of ``params`` over ``n`` ranks: each
    "col"/"row" leaf narrowed to its ``1/n`` slice of ``spec.dim`` (a view),
    every replicated leaf as it is. A dimension that ``n`` does not divide
    raises ``ConfigError`` naming the leaf and its width (JAX's
    ``device_put`` refuses such a sharding too). A ``Sharded`` leaf split
    the same way gives its part ``rank``."""
    out = {}
    for k, v in params.items():
        spec, where = specs[k], f"{path}{k}"
        if isinstance(v, dict):
            out[k] = shard_params(v, spec, rank, n, path=f"{where}.")
        elif isinstance(v, Sharded):
            if v.dim != spec.dim or len(v.parts) != n:
                raise ConfigError(f"{where} is held in {len(v.parts)} parts along dim {v.dim}, "
                                  f"not {n} along {spec.dim}")
            out[k] = v.parts[rank]
        elif spec.dim is None:
            out[k] = v
        else:
            width = v.shape[spec.dim]
            if width % n:
                raise ConfigError(f"tensor_parallel over {n} ranks: {where} has width "
                                  f"{width} on dim {spec.dim}, which {n} does not divide")
            size = width // n
            out[k] = v.narrow(spec.dim, rank * size, size)
    return out

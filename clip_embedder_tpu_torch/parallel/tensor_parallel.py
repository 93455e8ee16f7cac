"""The tensor-parallel forward of the ViT and text towers over one model
row of a mesh.

The JAX package gets it from GSPMD: its towers run unchanged on parameters
placed by ``tp_param_specs``, and XLA inserts one all-reduce per sublayer.
Here it is written out. Each model rank holds its local tree
(``sharding.shard_params``) on its device and runs the port's own
``multi_head_attention`` / ``mlp`` on it, with ``heads // n`` heads and the
eager core (the kernels are not on this path, as the JAX package's TP
forces its sharding-native attention core). The partial outputs of the
row-parallel linears (attention out-projection, MLP proj) are summed on the
activations' device (the first of the row), in at least f32; then their
bias is added once, and then the residual once. The local trees carry no
row-parallel bias: ``linear`` would add it on every rank, and a block that
passes ``residual=x`` into the out-projection would add the residual on
every rank too.

PE-Core's rope tables are head-tiled [S, H·D]; each rank gets the columns
of its heads. The pooler attention (SigLIP/PE MAP pool, CoCa's attentional
pooler) shards by heads like a block's, the MAP MLP like any MLP.

Heads that the ranks do not divide (12 heads over 8 ranks: ViT-B's 768
columns divide, its heads do not) are taken as the JAX package takes them:
GSPMD splits the H·D columns of q/k/v evenly, whatever the heads. The
ranks' q/k/v columns then come together on the activations' device, the
whole attention runs there (eager), and each rank takes back its columns
of the result for its row-parallel out-projection. A width that the ranks
do not divide (H·D, an MLP's hidden) raises ``ConfigError``, as JAX's
``device_put`` of such a sharding raises.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch

from ..models.text_transformer import TextTransformer
from ..models.vit import ViT, check_ported
from ..ops.attention import _split_heads, attention_core, multi_head_attention
from ..ops.layers import ACTIVATIONS, layer_norm, linear, mlp, promote
from ..ops.rope import apply_rope
from ..weights import ParamTree, unstack
from .mesh import tree_to
from .sharding import shard_params, tp_param_specs


def tower_tree(tower: ParamTree) -> dict:
    """The parameter tree of a ViT or text tower in the JAX package's layout
    (blocks stacked on axis 0: a copy), the layout ``tp_param_specs``
    describes."""
    def as_dict(node):
        return {k: as_dict(node[k]) if isinstance(node[k], ParamTree) else node[k].detach()
                for k in node.keys()}

    def stack(trees):
        if isinstance(trees[0], Mapping):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    tree = as_dict(tower)
    tree["blocks"] = stack([as_dict(b) for b in tower.blocks])
    return tree


def _strip_row_bias(local: dict, specs: dict) -> dict:
    """``local`` without the bias of each row-parallel linear: it is added
    once, after the sum over the ranks."""
    out = {}
    for k, v in local.items():
        if not isinstance(v, dict):
            out[k] = v
        elif getattr(specs[k].get("w"), "kind", None) == "row":
            out[k] = {n: t for n, t in v.items() if n != "b"}
        else:
            out[k] = _strip_row_bias(v, specs[k])
    return out


def _replicated(tree: dict, specs: dict) -> dict:
    """``tree``'s replicated leaves alone."""
    return {k: _replicated(v, specs[k]) if isinstance(v, dict) else v
            for k, v in tree.items() if isinstance(v, dict) or specs[k].dim is None}


def rank_trees(tree: dict, specs: dict, devices, *, path: str) -> list[dict]:
    """Each model rank's local tree on its device, row-parallel biases
    stripped."""
    n = len(devices)
    return [tree_to(_strip_row_bias(shard_params(tree, specs, r, n, path=path), specs), d)
            for r, d in enumerate(devices)]


def reduce_ranks(parts: list[torch.Tensor], bias: torch.Tensor | None,
                 like: torch.Tensor) -> torch.Tensor:
    """The model axis's sum: the ranks' partial outputs moved to ``like``'s
    device and summed in at least f32, the bias added once, one rounding to
    ``like``'s dtype."""
    ct = promote(like.dtype)
    acc = parts[0].to(like.device, ct)
    for p in parts[1:]:
        acc = acc + p.to(like.device, ct)
    if bias is not None:
        acc = acc + bias.to(like.device, ct)
    return acc.to(like.dtype)


class TPAttention:
    """One attention of ``heads`` heads over a model row: ``ranks[r]`` is
    rank r's {"q","k","v","out"} tree (``out`` without its bias), ``pre_ln``
    its LayerNorm ({r: tree} per rank, or None). Where the ranks divide the
    heads, each runs its own heads' attention; otherwise the attention core
    runs whole on the activations' device (``_gathered``)."""

    def __init__(self, ranks, devices, *, heads: int, bias, pre_ln=None, ln_eps=1e-6):
        self.ranks, self.devices, self.heads = ranks, devices, heads
        self.bias, self.pre_ln, self.ln_eps = bias, pre_ln, ln_eps

    def __call__(self, x, *, kv=None, mask=None, rope=None) -> torch.Tensor:
        n = len(self.devices)
        if self.heads % n:
            return self._gathered(x, kv, mask, rope)
        parts = []
        for r, (d, p) in enumerate(zip(self.devices, self.ranks)):
            parts.append(multi_head_attention(
                p, x.to(d), num_heads=self.heads // n, kv=None if kv is None else kv.to(d),
                mask=None if mask is None else mask.to(d), impl="eager",
                pre_ln=None if self.pre_ln is None else self.pre_ln[r], ln_eps=self.ln_eps,
                rope=None if rope is None else rope[r]))
        return reduce_ranks(parts, self.bias, x)

    def _gathered(self, x, kv, mask, rope) -> torch.Tensor:
        """Heads the ranks do not divide: each rank projects its even share
        of the q/k/v columns (its local tree), the shares are joined on
        ``x``'s device, rope (the ranks' table columns joined) and the
        eager core run on all heads there, and each rank's out-projection
        takes its share of the result's columns."""
        cols = {"q": [], "k": [], "v": []}
        for r, (d, p) in enumerate(zip(self.devices, self.ranks)):
            xr = x.to(d)
            if self.pre_ln is not None:
                xr = layer_norm(self.pre_ln[r], xr, eps=self.ln_eps)
            src = xr if kv is None else kv.to(d)
            for name, inp in (("q", xr), ("k", src), ("v", src)):
                cols[name].append(linear(p[name], inp).to(x.device))
        q, k, v = (torch.cat(cols[name], dim=-1) for name in "qkv")
        if rope is not None:
            tables = (torch.cat([t[i].to(x.device) for t in rope], dim=-1) for i in range(2))
            sin, cos = tables
            q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        out = attention_core(*(_split_heads(t, self.heads) for t in (q, k, v)), mask=mask)
        b, h, s, dh = out.shape
        out = out.transpose(1, 2).reshape(b, s, h * dh)
        w = out.shape[-1] // len(self.devices)
        parts = [linear(p["out"], out[..., r * w:(r + 1) * w].to(d))
                 for r, (d, p) in enumerate(zip(self.devices, self.ranks))]
        return reduce_ranks(parts, self.bias, x)


class TPMlp:
    """One MLP sharded by its hidden over a model row (``proj`` without its
    bias in ``ranks``)."""

    def __init__(self, ranks, devices, *, activation, bias, pre_ln=None, ln_eps=1e-6):
        self.ranks, self.devices, self.activation = ranks, devices, activation
        self.bias, self.pre_ln, self.ln_eps = bias, pre_ln, ln_eps

    def __call__(self, x) -> torch.Tensor:
        parts = [mlp(p, x.to(d), activation=self.activation,
                     pre_ln=None if self.pre_ln is None else self.pre_ln[r], ln_eps=self.ln_eps)
                 for r, (d, p) in enumerate(zip(self.devices, self.ranks))]
        return reduce_ranks(parts, self.bias, x)


class TPBlock:
    """``models.vit.Block``'s function over a model row: x + attn(ln1(x)),
    then x + mlp(ln2(x)), each sublayer summed over the ranks, with its
    bias, its layer scale and its residual applied once."""

    def __init__(self, full: dict, ranks: list[dict], devices, *, heads: int,
                 activation: str, ln_eps: float):
        self.attn = TPAttention([r["attn"] for r in ranks], devices, heads=heads,
                                bias=full["attn"]["out"].get("b"),
                                pre_ln=[r["ln1"] for r in ranks], ln_eps=ln_eps)
        self.mlp = TPMlp([r["mlp"] for r in ranks], devices, activation=ACTIVATIONS[activation],
                         bias=full["mlp"]["proj"].get("b"), pre_ln=[r["ln2"] for r in ranks],
                         ln_eps=ln_eps)
        self.ls1, self.ls2 = full.get("ls1"), full.get("ls2")

    def __call__(self, x, *, impl: str, mask=None, rope=None) -> torch.Tensor:
        h = self.attn(x, mask=mask, rope=rope)
        x = x + (h if self.ls1 is None else h * self.ls1)
        h = self.mlp(x)
        return x + (h if self.ls2 is None else h * self.ls2)


def tp_blocks(tree: dict, specs: dict, devices, *, layers: int, heads: int,
              activation: str, ln_eps: float) -> list[TPBlock]:
    ranks = rank_trees(tree["blocks"], specs["blocks"], devices, path="blocks.")
    full = _replicated(tree["blocks"], specs["blocks"])
    return [TPBlock(unstack(full, i), [unstack(r, i) for r in ranks], devices,
                    heads=heads, activation=activation, ln_eps=ln_eps)
            for i in range(layers)]


class TPViT(ViT):
    """``models.vit.ViT`` over a model row: ``forward`` is the ViT's own;
    its blocks, its rope tables and its pooler are the sharded ones. The
    replicated leaves and the activations live on the row's first
    device.

    ``tree`` may hold ``sharding.Sharded`` leaves, rank r reading its part.
    The forward reads the tree's own tensors (``ParamTree(trainable=True)``)
    or autograd-tracked moves of them, so a backward pass reaches a training
    tree's leaves; a serving tree's tensors require no grad. It reads no
    tensor on the host and copies none from it once its rope tables are
    made, so a row on one card is one CUDA graph (``utils.captured``:
    ``parallel.embed`` and the train step capture it)."""

    def __init__(self, cfg, tree: dict, devices):
        check_ported(cfg)
        devices = list(devices)
        tree = tree_to(tree, devices[0])
        specs = tp_param_specs(tree, tower="vit")
        rest = {k: v for k, v in tree.items() if k not in ("blocks", "attn_pool")}
        pool = tree.get("attn_pool")
        if pool is not None:  # the pooler's replicated leaves (probe/query, LNs)
            rest["attn_pool"] = {k: v for k, v in pool.items() if k not in ("attn", "mlp")}
        ParamTree.__init__(self, rest, trainable=True)
        self.cfg, self.devices = cfg, devices
        self.act = ACTIVATIONS[cfg.activation]
        self._rope = {}
        self.blocks = tp_blocks(tree, specs, devices, layers=cfg.layers, heads=cfg.heads,
                                activation=cfg.activation, ln_eps=cfg.ln_eps)
        if pool is not None:
            ranks = rank_trees(pool, specs["attn_pool"], devices, path="attn_pool.")
            self.pool_attn = TPAttention([r["attn"] for r in ranks], devices,
                                         heads=cfg.pool_heads or cfg.heads,
                                         bias=pool["attn"]["out"].get("b"))
            if "mlp" in pool:
                self.pool_mlp = TPMlp([r["mlp"] for r in ranks], devices, activation=self.act,
                                      bias=pool["mlp"]["proj"].get("b"),
                                      pre_ln=[r["ln"] for r in ranks], ln_eps=cfg.ln_eps)

    def rope_tables(self, device: torch.device):
        """Per rank, the columns of its heads of PE-Core's head-tiled
        [S, H·D] tables, on the rank's device; None without rope. Made at
        the first call, which on the card is a graph's eager warm-up: a
        captured forward reads them where they lie."""
        full = super().rope_tables(device)
        if full is None:
            return None
        key = ("ranks", device)
        if key not in self._rope:
            w = full[0].shape[1] // len(self.devices)
            self._rope[key] = [tuple(t[:, r * w:(r + 1) * w].to(d).contiguous() for t in full)
                               for r, d in enumerate(self.devices)]
        return self._rope[key]

    def _map_pool(self, x: torch.Tensor, impl: str = "eager") -> torch.Tensor:
        # ``impl`` unread: the sharded forward runs eager (``parallel.embed``)
        cfg, p = self.cfg, self["attn_pool"]
        probe = p["probe"].to(x.dtype).expand(x.shape[0], 1, cfg.width)
        pooled = self.pool_attn(probe, kv=x)
        return (pooled + self.pool_mlp(pooled))[:, 0]

    def _attn_pool(self, x: torch.Tensor) -> torch.Tensor:
        cfg, p = self.cfg, self["attn_pool"]
        dm = cfg.attn_pool_dim or cfg.width
        keys = layer_norm(p["ln_k"], x, eps=cfg.ln_eps)
        q = layer_norm(p["ln_q"], p["query"].to(x.dtype), eps=cfg.ln_eps)
        q = q[None].expand(x.shape[0], cfg.attn_pool_queries, dm)
        pooled = self.pool_attn(q, kv=keys)
        return layer_norm(self["ln_post"], pooled, eps=cfg.ln_eps)[:, 0]


class TPTextTransformer(TextTransformer):
    """``models.text_transformer.TextTransformer`` over a model row (its
    ``forward``, sharded blocks); ``tree`` as ``TPViT``'s."""

    def __init__(self, cfg, tree: dict, devices):
        devices = list(devices)
        tree = tree_to(tree, devices[0])
        specs = tp_param_specs(tree, tower="text")
        ParamTree.__init__(self, {k: v for k, v in tree.items() if k != "blocks"},
                           trainable=True)
        self.cfg, self.devices = cfg, devices
        self.blocks = tp_blocks(tree, specs, devices, layers=cfg.layers, heads=cfg.heads,
                                activation=cfg.activation, ln_eps=cfg.ln_eps)


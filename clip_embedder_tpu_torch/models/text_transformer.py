"""Text transformer towers.

Counterpart of ``clip_embedder_tpu.models.text_transformer``:

* classic CLIP text tower: causal mask, argmax-EOT pooling (the position of
  the highest token id), bias-free projection, quick_gelu option;
* SigLIP text tower: bidirectional (``no_causal_mask``), "last"-token
  pooling, projection with bias, tanh-gelu.

The blocks are the vision tower's (``models.vit.Block``). The CoCa text
tower (``embed_cls``) is not yet ported and is refused with ``ConfigError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from ..errors import ConfigError
from ..ops.attention import causal_mask
from ..ops.layers import layer_norm, linear
from ..ops.normalize import l2_normalize
from ..weights import ParamTree
from .vit import _init_linear, _init_ln, _normal, blocks_from_tree, init_blocks


@dataclass(frozen=True)
class TextCfgResolved:
    """Resolved text-tower architecture (same fields as the JAX package's;
    built by ``models.build.resolve_text``)."""

    context_length: int
    vocab_size: int
    width: int
    heads: int
    layers: int
    mlp_hidden: int
    embed_dim: int
    activation: str = "gelu"
    causal: bool = True
    pool: str = "argmax"       # argmax (CLIP EOT) | last | first | mean
    proj_bias: bool = False
    use_proj: bool = True
    ln_eps: float = 1e-5
    embed_cls: bool = False
    pad_id: int = 0

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


def check_ported(cfg: TextCfgResolved) -> None:
    if cfg.embed_cls:
        raise ConfigError("the CoCa text tower (embed_cls) is not yet ported to "
                          "the torch package")


def init(cfg: TextCfgResolved, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout."""
    check_ported(cfg)
    g, dev, dt = generator, device, dtype
    params = {
        "token_embed": _normal((cfg.vocab_size, cfg.width), 0.02, g, dev, dt),
        "pos_embed": _normal((cfg.context_length, cfg.width), 0.01, g, dev, dt),
        "ln_final": _init_ln(cfg.width, device=dev, dtype=dt),
        "blocks": init_blocks(g, layers=cfg.layers, width=cfg.width,
                              mlp_hidden=cfg.mlp_hidden, device=dev, dtype=dt),
    }
    if cfg.use_proj:
        params["proj"] = _init_linear(g, cfg.width, cfg.embed_dim, bias=cfg.proj_bias,
                                      device=dev, dtype=dt)
    return params


class TextTransformer(ParamTree):
    """The text tower over a parameter tree from ``init`` or
    ``weights.load_pytree``."""

    def __init__(self, cfg: TextCfgResolved, params: Mapping):
        check_ported(cfg)
        super().__init__({k: v for k, v in params.items() if k != "blocks"})
        self.cfg = cfg
        self.blocks = blocks_from_tree(params["blocks"], layers=cfg.layers, heads=cfg.heads,
                                       activation=cfg.activation, ln_eps=cfg.ln_eps)

    def forward(self, input_ids: torch.Tensor, *, attn_impl: str = "eager",
                normalize: bool = True) -> torch.Tensor:
        """[B, context_length] token ids → [B, embed_dim]."""
        cfg = self.cfg
        ids = input_ids.long()
        x = self["token_embed"][ids]
        x = x + self["pos_embed"].to(x.dtype)[None, : x.shape[1]]
        mask = causal_mask(x.shape[1], device=x.device) if cfg.causal else None
        for blk in self.blocks:
            x = blk(x, impl=attn_impl, mask=mask)
        x = layer_norm(self["ln_final"], x, eps=cfg.ln_eps)

        if cfg.pool == "argmax":
            eot = ids.argmax(dim=-1)
            pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        elif cfg.pool == "last":
            pooled = x[:, -1]
        elif cfg.pool == "first":
            pooled = x[:, 0]
        else:  # mean
            pooled = x.mean(dim=1)

        if cfg.use_proj and "proj" in self:
            pooled = linear(self["proj"], pooled)
        return l2_normalize(pooled) if normalize else pooled

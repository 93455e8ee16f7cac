"""Text transformer towers.

Counterpart of ``clip_embedder_tpu.models.text_transformer``:

* classic CLIP text tower: causal mask, argmax-EOT pooling (the position of
  the highest token id), bias-free projection, quick_gelu option;
* SigLIP text tower: bidirectional (``no_causal_mask``), "last"-token
  pooling, projection with bias, tanh-gelu;
* CoCa text tower (``embed_cls``): a learned cls token appended to the
  sequence, the causal mask plus open_clip's cls mask (``cls_mask``: a
  [B, 1, S+1, S+1] block per batch row, the packed attention kernel's full
  per-batch form), pooled at the cls position with ``ln_final`` after
  pooling.

The blocks are the vision tower's (``models.vit.Block``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from ..ops.attention import causal_mask
from ..ops.layers import layer_norm, linear
from ..ops.normalize import l2_normalize
from ..weights import ParamTree
from .vit import _init_linear, _init_ln, _normal, blocks_from_tree, init_blocks, run_blocks


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


def init(cfg: TextCfgResolved, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout."""
    g, dev, dt = generator, device, dtype
    num_pos = cfg.context_length + (1 if cfg.embed_cls else 0)
    params = {
        "token_embed": _normal((cfg.vocab_size, cfg.width), 0.02, g, dev, dt),
        "pos_embed": _normal((num_pos, cfg.width), 0.01, g, dev, dt),
        "ln_final": _init_ln(cfg.width, device=dev, dtype=dt),
        "blocks": init_blocks(g, layers=cfg.layers, width=cfg.width,
                              mlp_hidden=cfg.mlp_hidden, device=dev, dtype=dt),
    }
    if cfg.embed_cls:
        params["cls_emb"] = _normal((1, 1, cfg.width), 0.01, g, dev, dt)
    if cfg.use_proj:
        params["proj"] = _init_linear(g, cfg.width, cfg.embed_dim, bias=cfg.proj_bias,
                                      device=dev, dtype=dt)
    return params


def cls_mask(input_ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    """open_clip ``TextTransformer.build_cls_mask``, copied literally (as
    the JAX package's ``_cls_mask``): for ids [B, S] an additive f32
    [B, 1, S+1, S+1] mask whose rows 0..S-1 (the text queries) are zero and
    whose last row (the cls query) is -inf at column j + 1 where token j is
    padding, column 0 always open. The one-column shift is open_clip's
    ``F.pad(cls_mask, (1, 0, S, 0), value=True)``, kept because the
    reference runs graphs exported from that code."""
    b, s = input_ids.shape
    dev = input_ids.device
    keep = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev), input_ids != pad_id],
                     dim=1)                                                   # [B, S+1]
    last_row = torch.where(keep, 0.0, float("-inf"))[:, None, :]              # [B, 1, S+1]
    is_cls_row = (torch.arange(s + 1, device=dev) == s)[None, :, None]        # [1, S+1, 1]
    return torch.where(is_cls_row, last_row, 0.0)[:, None]                    # [B, 1, S+1, S+1]


class TextTransformer(ParamTree):
    """The text tower over a parameter tree from ``init`` or
    ``weights.load_pytree``; ``trainable`` as ``models.vit.ViT``'s."""

    def __init__(self, cfg: TextCfgResolved, params: Mapping, *, trainable: bool = False):
        super().__init__({k: v for k, v in params.items() if k != "blocks"},
                         trainable=trainable)
        self.cfg = cfg
        self.blocks = blocks_from_tree(params["blocks"], layers=cfg.layers, heads=cfg.heads,
                                       activation=cfg.activation, ln_eps=cfg.ln_eps,
                                       trainable=trainable)

    def forward(self, input_ids: torch.Tensor, *, attn_impl: str = "eager",
                normalize: bool = True, remat: bool = False) -> torch.Tensor:
        """[B, context_length] token ids → [B, embed_dim]. ``remat``:
        ``models.vit.run_blocks``."""
        cfg = self.cfg
        ids = input_ids.long()
        x = self["token_embed"][ids]
        if cfg.embed_cls:
            cls = self["cls_emb"].to(x.dtype).expand(x.shape[0], 1, cfg.width)
            x = torch.cat([x, cls], dim=1)
        x = x + self["pos_embed"].to(x.dtype)[None, : x.shape[1]]
        mask = causal_mask(x.shape[1], device=x.device) if cfg.causal else None
        if cfg.embed_cls:
            cls_add = cls_mask(ids, cfg.pad_id)
            mask = cls_add if mask is None else mask + cls_add
        x = run_blocks(self.blocks, x, remat=remat, impl=attn_impl, mask=mask)

        if cfg.embed_cls:  # the appended cls (last position), then ln_final on it alone
            pooled = layer_norm(self["ln_final"], x[:, -1], eps=cfg.ln_eps)
            if cfg.use_proj and "proj" in self:
                pooled = linear(self["proj"], pooled)
            return l2_normalize(pooled) if normalize else pooled

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

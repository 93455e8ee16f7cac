"""HF (BERT/RoBERTa-style) text towers: the ``hf_model_name`` branch of
open_clip text configs (BiomedCLIP's PubMedBERT, and relatives).

Counterpart of ``clip_embedder_tpu.models.hf_text``: a post-LN BERT encoder
(word + position + token-type embeddings and a LayerNorm, then blocks of
self-attention → residual + LN → MLP → residual + LN) under an additive
[B, 1, 1, L] key-padding mask, then an open_clip pooler (CLS, the BERT
pooler head, masked mean or masked max) and projection (linear, MLP or
none). The key mask comes from the tokenizer's ``attention_mask`` when one
is given, else from the pad id. RoBERTa-class models differ only in the
embeddings: position ids derived from the pad id (pads at ``padding_idx``,
real tokens from ``padding_idx + 1``) into a ``max_position_embeddings``
table.

On the kernel impls the mask reaches the packed attention kernel as its
per-batch key form where the heads form a 128-lane group (BERT-base's 12 x
64), and ``attention_core`` otherwise (``ops.attention``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..errors import ConfigError, WeightError
from ..ops.attention import multi_head_attention
from ..ops.layers import ACTIVATIONS, gelu, layer_norm, linear, mlp
from ..ops.normalize import l2_normalize
from ..weights import (ParamTree, _get, _linear, _ln, _max_index, _stack_blocks, strip_prefix,
                       unstack)
from .vit import _init_attn, _init_linear, _init_ln, _normal


@dataclass(frozen=True)
class BertCfg:
    """Resolved HF text-tower architecture (same fields as the JAX
    package's; built by ``resolve_hf_text``)."""

    context_length: int
    vocab_size: int
    width: int
    heads: int
    layers: int
    mlp_hidden: int
    embed_dim: int
    pad_id: int = 0
    activation: str = "gelu"
    pooler: str = "cls"          # cls | cls_pooler | mean | max
    proj: str = "linear"         # linear | mlp | none
    ln_eps: float = 1e-12
    position_style: str = "bert"  # bert (0..L-1) | roberta (pad-id offset)
    max_pos: int = 0             # position-table rows; 0 → context_length


def resolve_hf_text(model_cfg) -> BertCfg:
    """A ``BertCfg`` from open_clip's text_cfg. The dims come from
    ``text_cfg.hf_config`` (written into the model dir at conversion time:
    the dir contract carries no HF config.json)."""
    t = model_cfg.text_cfg
    hf_cfg = t.extra.get("hf_config")
    if not hf_cfg:
        raise ConfigError(
            "hf_model_name text towers need text_cfg.hf_config "
            "(written by pull_weights.py at conversion time)")
    # open_clip pooler types: cls_pooler (BERT pooler_output), the raw CLS
    # (cls_last_hidden_state_pooler), mean_pooler, max_pooler; the keys are
    # spelled per open_clip era ("pooler_type"/"proj" in BiomedCLIP-class
    # configs, "hf_pooler_type"/"hf_proj_type" now, "proj_type" in fixtures)
    pooler_type = next((t.extra[k] for k in ("hf_pooler_type", "pooler_type")
                        if t.extra.get(k)), "cls_last_hidden_state_pooler")
    if pooler_type == "cls_pooler":
        pooler = "cls_pooler"
    elif "mean" in pooler_type:
        pooler = "mean"
    elif "max" in pooler_type:
        pooler = "max"
    else:
        pooler = "cls"
    # open_clip's HFTextEncoder projects with an MLP when the width differs
    # from embed_dim, and not at all when they are equal
    default_proj = "none" if int(hf_cfg["hidden_size"]) == model_cfg.embed_dim else "mlp"
    proj_type = next((t.extra[k] for k in ("hf_proj_type", "proj", "proj_type")
                      if t.extra.get(k)), default_proj)
    model_type = str(hf_cfg.get("model_type", "bert")).replace("_", "-")
    roberta = model_type in ("roberta", "xlm-roberta", "xlm-roberta-xl", "camembert")
    return BertCfg(
        context_length=t.context_length,
        vocab_size=int(hf_cfg["vocab_size"]),
        width=int(hf_cfg["hidden_size"]),
        heads=int(hf_cfg["num_attention_heads"]),
        layers=int(hf_cfg["num_hidden_layers"]),
        mlp_hidden=int(hf_cfg["intermediate_size"]),
        embed_dim=model_cfg.embed_dim,
        pad_id=int(hf_cfg.get("pad_token_id", 1 if roberta else 0)),
        pooler=pooler,
        proj={"mlp": "mlp", "none": "none"}.get(proj_type, "linear"),
        ln_eps=float(hf_cfg.get("layer_norm_eps", 1e-5 if roberta else 1e-12)),
        position_style="roberta" if roberta else "bert",
        max_pos=int(hf_cfg.get("max_position_embeddings", 0)),
    )


def init(cfg: BertCfg, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout (blocks
    stacked on axis 0). ``device="meta"`` gives the shapes alone."""
    g, dev, dt = generator, device, dtype
    kw = {"layers": cfg.layers, "device": dev, "dtype": dt}
    params = {
        "word_embed": _normal((cfg.vocab_size, cfg.width), 0.02, g, dev, dt),
        "pos_embed": _normal((cfg.max_pos or cfg.context_length, cfg.width), 0.02, g, dev, dt),
        "type_embed": _normal((2, cfg.width), 0.02, g, dev, dt),
        "embed_ln": _init_ln(cfg.width, device=dev, dtype=dt),
        "blocks": {
            "attn": _init_attn(g, cfg.width, **kw),
            "attn_ln": _init_ln(cfg.width, **kw),
            "mlp": {"fc": _init_linear(g, cfg.width, cfg.mlp_hidden, **kw),
                    "proj": _init_linear(g, cfg.mlp_hidden, cfg.width, **kw)},
            "mlp_ln": _init_ln(cfg.width, **kw),
        },
    }
    if cfg.pooler == "cls_pooler":  # the declared architecture has the pooler head
        params["pooler"] = _init_linear(g, cfg.width, cfg.width, device=dev, dtype=dt)
    if cfg.proj == "linear":
        params["proj"] = _init_linear(g, cfg.width, cfg.embed_dim, bias=False, device=dev,
                                      dtype=dt)
    elif cfg.proj == "mlp":
        hidden = (cfg.width + cfg.embed_dim) // 2
        params["proj"] = {
            "fc": _init_linear(g, cfg.width, hidden, device=dev, dtype=dt),
            "out": _init_linear(g, hidden, cfg.embed_dim, bias=False, device=dev, dtype=dt)}
    return params


class BertBlock(ParamTree):
    """One post-LN block: LN(x + attn(x)), then LN(x + mlp(x))."""

    def __init__(self, params: Mapping, *, heads: int, activation: str, ln_eps: float):
        super().__init__(params)
        self.heads = heads
        self.act = ACTIVATIONS[activation]
        self.ln_eps = ln_eps

    def forward(self, x: torch.Tensor, *, mask: torch.Tensor, impl: str) -> torch.Tensor:
        h = multi_head_attention(self["attn"], x, num_heads=self.heads, mask=mask, impl=impl)
        x = layer_norm(self["attn_ln"], x + h, eps=self.ln_eps)
        h = mlp(self["mlp"], x, activation=self.act)
        return layer_norm(self["mlp_ln"], x + h, eps=self.ln_eps)


class HFText(ParamTree):
    """The BERT/RoBERTa text tower over a parameter tree from ``init``,
    ``map_hf_text`` or ``weights.load_pytree``."""

    def __init__(self, cfg: BertCfg, params: Mapping):
        super().__init__({k: v for k, v in params.items() if k != "blocks"})
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            BertBlock(unstack(params["blocks"], i), heads=cfg.heads,
                      activation=cfg.activation, ln_eps=cfg.ln_eps)
            for i in range(cfg.layers))

    def forward(self, input_ids: torch.Tensor, *, attn_impl: str = "eager",
                normalize: bool = True,
                attention_mask: torch.Tensor | None = None) -> torch.Tensor:
        """[B, L] ids → [B, embed_dim]. The key mask is the tokenizer's
        ``attention_mask`` when given (its pad id can differ from the HF
        config's ``pad_token_id``), else ``ids != cfg.pad_id``."""
        cfg = self.cfg
        ids = input_ids.long()
        valid = ((attention_mask if attention_mask is not None else ids != cfg.pad_id)
                 .to(torch.float32))
        x = self["word_embed"][ids]
        pos = self["pos_embed"].to(x.dtype)
        if cfg.position_style == "roberta":
            # transformers create_position_ids_from_input_ids: from the ids
            # against the HF pad id, not from the attention mask
            real = (ids != cfg.pad_id).long()
            x = x + pos[torch.cumsum(real, dim=1) * real + cfg.pad_id]
        else:
            x = x + pos[None, : x.shape[1]]
        x = x + self["type_embed"].to(x.dtype)[0][None, None, :]
        x = layer_norm(self["embed_ln"], x, eps=cfg.ln_eps)

        # additive [B, 1, 1, L] key mask: -1e30 on padded keys
        mask = torch.where(valid != 0, 0.0, -1e30)[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, mask=mask, impl=attn_impl)

        if cfg.pooler == "mean":
            denom = valid.sum(-1, keepdim=True).clamp_min(1.0)
            pooled = (x * valid[..., None]).sum(1) / denom
        elif cfg.pooler == "max":
            neg = torch.full((), -1e30, dtype=x.dtype, device=x.device)
            pooled = torch.where(valid[..., None] > 0, x, neg).amax(dim=1)
        elif cfg.pooler == "cls_pooler":
            if "pooler" not in self:
                # raw CLS in its place would give embeddings that are
                # silently wrong
                raise WeightError("pooler_type 'cls_pooler' requires the BERT pooler weights "
                                  "(pooler.dense.*): the checkpoint was exported without them")
            pooled = torch.tanh(linear(self["pooler"], x[:, 0]))
        else:
            pooled = x[:, 0]

        proj = self.get("proj")
        if proj is not None:
            if cfg.proj == "mlp":
                pooled = linear(proj["out"], gelu(linear(proj["fc"], pooled)))
            else:
                pooled = linear(proj, pooled)
        return l2_normalize(pooled) if normalize else pooled


def map_hf_text(sd: Mapping[str, np.ndarray]) -> dict:
    """An open_clip HFTextEncoder state dict (``text.transformer.*`` in HF
    BERT naming, and ``text.proj``) → the ``init`` tree, as numpy arrays."""
    sd = strip_prefix(sd, "model.", "text.")
    sd = strip_prefix(sd, "transformer.")
    sd = strip_prefix(sd, "bert.")
    sd = strip_prefix(sd, "roberta.")

    n = _max_index(sd, r"encoder\.layer\.(\d+)\.attention\.self\.query\.weight")
    blocks = []
    for i in range(n):
        p = f"encoder.layer.{i}"
        blocks.append({
            "attn": {"q": _linear(sd, f"{p}.attention.self.query"),
                     "k": _linear(sd, f"{p}.attention.self.key"),
                     "v": _linear(sd, f"{p}.attention.self.value"),
                     "out": _linear(sd, f"{p}.attention.output.dense")},
            "attn_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            "mlp": {"fc": _linear(sd, f"{p}.intermediate.dense"),
                    "proj": _linear(sd, f"{p}.output.dense")},
            "mlp_ln": _ln(sd, f"{p}.output.LayerNorm"),
        })
    params = {
        "word_embed": _get(sd, "embeddings.word_embeddings.weight"),
        "pos_embed": _get(sd, "embeddings.position_embeddings.weight"),
        "type_embed": _get(sd, "embeddings.token_type_embeddings.weight"),
        "embed_ln": _ln(sd, "embeddings.LayerNorm"),
        "blocks": _stack_blocks(blocks),
    }
    if "pooler.dense.weight" in sd:
        params["pooler"] = _linear(sd, "pooler.dense")
    if "proj.weight" in sd:  # linear proj
        params["proj"] = _linear(sd, "proj")
    elif "proj.0.weight" in sd:  # mlp proj: Linear, GELU, Linear
        params["proj"] = {"fc": _linear(sd, "proj.0"), "out": _linear(sd, "proj.2")}
    return params

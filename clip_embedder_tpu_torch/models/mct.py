"""MCT-class hybrid text towers (MobileCLIP-S0's ``mct`` text encoder).

Counterpart of ``clip_embedder_tpu.models.mct``. The MobileCLIP text encoder
replaces the lower transformer layers with 1-D convolutional token-mixing
blocks (reparameterized at inference to one depthwise conv per block)
followed by standard transformer layers. The reference runs this family only
as an exported graph through ONNX Runtime (reference: src/onnx.rs:13-29,
src/text.rs:150-169); here it is a native tower, so it takes the same
kernels as every other text tower.

No source of truth for the real MCT block structure is in the repository,
so this tower never loads from a hand-written config: its architecture is
derived from the exported graph itself (``onnx_reader.derive_mct_cfg``), its
weights recovered by consumption order (``onnx_reader._structural_mct``), and
the conversion is checked against the graph executor at load
(``onnx_reader.probe_verify``); a mismatch falls back to the executor
(``text.py``).

Architecture (inference form):

    token_embed + pos_embed
    -> N conv blocks:   x = x + dwconv1d(x)            (token mixing)
                        x = x + fc2(act(fc1(ln(x))))   (ConvFFN, optional)
    -> M transformer blocks (pre-LN MHA + MLP: ``models.vit.Block``)
    -> ln_final -> pool (argmax-EOT | last) -> projection -> L2 normalize

The depthwise conv runs as k shifted multiplies on the [B, T, C] block
(T <= 77, k <= 11), as in the JAX package; the ConvFFN is ``ops.layers.mlp``
(the fused int8 MLP kernel under ``int8``), the transformer blocks take the
attention and LayerNorm + q/k/v kernels through ``attn_impl``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from ..ops.attention import causal_mask
from ..ops.layers import ACTIVATIONS, layer_norm, linear, mlp
from ..ops.normalize import l2_normalize
from ..weights import ParamTree
from .vit import _init_linear, _init_ln, _normal, blocks_from_tree, init_blocks


@dataclass(frozen=True)
class MctCfg:
    """Resolved hybrid-text architecture; every field is graph-derived
    (``onnx_reader.derive_mct_cfg``) — see the module docstring."""

    context_length: int
    vocab_size: int
    width: int
    heads: int
    layers: int                       # transformer layers
    mlp_hidden: int                   # transformer MLP hidden
    embed_dim: int
    # per conv block: (dw kernel size, ffn hidden dim; 0 = no ConvFFN)
    conv_blocks: tuple[tuple[int, int], ...]
    activation: str = "gelu"
    causal: bool = True
    pool: str = "argmax"              # argmax (CLIP EOT) | last
    proj_bias: bool = False
    use_proj: bool = True
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


def init(cfg: MctCfg, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout (tests; real
    weights come from converted graphs). ``device="meta"`` gives the shapes
    alone."""
    g, dev, dt = generator, device, dtype
    params = {
        "token_embed": _normal((cfg.vocab_size, cfg.width), 0.02, g, dev, dt),
        "pos_embed": _normal((cfg.context_length, cfg.width), 0.01, g, dev, dt),
        "ln_final": _init_ln(cfg.width, device=dev, dtype=dt),
    }
    conv_blocks = []
    for k, ffn_hidden in cfg.conv_blocks:
        block: dict = {"mixer": {"w": _normal((k, cfg.width), 1.0 / k, g, dev, dt),
                                 "b": torch.zeros(cfg.width, device=dev, dtype=dt)}}
        if ffn_hidden:
            block["ffn"] = {
                "ln": _init_ln(cfg.width, device=dev, dtype=dt),
                "fc": _init_linear(g, cfg.width, ffn_hidden, std=0.02, device=dev, dtype=dt),
                "proj": _init_linear(g, ffn_hidden, cfg.width, std=0.02, device=dev, dtype=dt),
            }
        conv_blocks.append(block)
    params["conv_blocks"] = conv_blocks
    params["blocks"] = init_blocks(g, layers=cfg.layers, width=cfg.width,
                                   mlp_hidden=cfg.mlp_hidden, device=dev, dtype=dt)
    if cfg.use_proj:
        params["proj"] = _init_linear(g, cfg.width, cfg.embed_dim, bias=cfg.proj_bias,
                                      std=cfg.width ** -0.5, device=dev, dtype=dt)
    return params


def dwconv1d(p, x: torch.Tensor) -> torch.Tensor:
    """Depthwise 1-D conv over the sequence axis of [B, T, C], SAME padding,
    as k shifted multiplies (``p["w"]``: [k, C], ``p["b"]``: [C])."""
    w = p["w"].to(x.dtype)
    k, t = w.shape[0], x.shape[1]
    pad_l = (k - 1) // 2
    xp = torch.nn.functional.pad(x, (0, 0, pad_l, k - 1 - pad_l))
    y = xp[:, 0:t] * w[0]
    for j in range(1, k):
        y = y + xp[:, j:j + t] * w[j]
    return y + p["b"].to(x.dtype)


class Mct(ParamTree):
    """The hybrid text tower over a parameter tree from ``init`` or
    ``weights.load_pytree``."""

    def __init__(self, cfg: MctCfg, params: Mapping):
        super().__init__({k: v for k, v in params.items()
                          if k not in ("blocks", "conv_blocks")})
        self.cfg = cfg
        self.conv_blocks = torch.nn.ModuleList(ParamTree(b) for b in params["conv_blocks"])
        self.blocks = blocks_from_tree(params["blocks"], layers=cfg.layers, heads=cfg.heads,
                                       activation=cfg.activation, ln_eps=cfg.ln_eps)
        self.act = ACTIVATIONS[cfg.activation]

    def forward(self, input_ids: torch.Tensor, *, attn_impl: str = "eager",
                normalize: bool = True) -> torch.Tensor:
        """[B, context_length] token ids → [B, embed_dim]."""
        cfg = self.cfg
        ids = input_ids.long()
        x = self["token_embed"][ids]
        x = x + self["pos_embed"].to(x.dtype)[None, : x.shape[1]]
        for block in self.conv_blocks:
            x = x + dwconv1d(block["mixer"], x)
            if "ffn" in block:
                f = block["ffn"]
                x = mlp(f, x, activation=self.act, pre_ln=f["ln"], ln_eps=cfg.ln_eps,
                        residual=True)
        mask = causal_mask(x.shape[1], device=x.device) if cfg.causal else None
        for blk in self.blocks:
            x = blk(x, impl=attn_impl, mask=mask)
        x = layer_norm(self["ln_final"], x, eps=cfg.ln_eps)
        if cfg.pool == "argmax":
            pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        else:  # last
            pooled = x[:, -1]
        if cfg.use_proj and "proj" in self:
            pooled = linear(self["proj"], pooled)
        return l2_normalize(pooled) if normalize else pooled

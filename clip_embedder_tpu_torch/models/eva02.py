"""EVA02 vision towers (timm ``eva02_*_clip_*`` under open_clip).

Counterpart of ``clip_embedder_tpu.models.eva02``: a ViT with

* separate q/k/v projections (k bias-free);
* 2-D axial rope on q and k over the patch tokens (the class token is not
  rotated), on top of a learned absolute pos-embed: timm's
  ``RotaryEmbeddingCat(in_pixels=False)``, y bands first, coordinates
  rescaled to the 16×16 pretrain grid (``ops.rope.axial_rope_table``);
* sub-LN: a LayerNorm on the merged attention output before the
  out-projection, and one inside the FFN before its down-projection;
* the SwiGLU FFN in f32: silu(w_gate·x) ⊙ (w_x·x) → ffn_ln → w_out.

Attention, as the JAX package routes it:

* ``"kernel"`` / ``"kernel_fast"`` where the heads form a 128-lane group:
  q, k and v by plain ``linear`` (not ``ln_qkv``, whose boundary the JAX
  package measured as a loss here), then kernel 2
  (``flash_attention_packed``) with rope from head-tiled tables whose row 0
  is the identity, so the class token passes through unrotated;
  ``kernel_fast`` is the clamped softmax only, with no bf16 exp;
* otherwise rope on the patch tokens outside, then ``flash_attention``
  (kernel 3) on the kernel impls or ``attention_core`` on ``"eager"``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..errors import ConfigError, WeightError
from ..ops.attention import ATTN_IMPLS, KERNEL_IMPLS, _split_heads, attention_core
from ..ops.flash import flash_attention, flash_attention_packed, head_group
from ..ops.layers import layer_norm, linear
from ..ops.normalize import l2_normalize
from ..ops.rope import apply_rope, axial_rope_table, head_tiled_tables
from ..weights import (ParamTree, _conv_to_patch, _get, _linear, _ln, _max_index,
                       _stack_blocks, strip_prefix, unstack)
from .vit import _init_linear, _init_ln, _normal, patchify


@dataclass(frozen=True)
class Eva02Cfg:
    """Resolved EVA02 architecture (the JAX package's fields)."""

    image_size: int
    patch_size: int
    width: int
    layers: int
    heads: int
    mlp_hidden: int        # SwiGLU hidden size
    embed_dim: int
    use_proj: bool = True
    rope_temperature: float = 10000.0
    # the pretrain grid (timm ref_feat_shape; 16 for every eva02 clip variant)
    rope_ref_grid: int | None = 16
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


# width, layers, heads, swiglu hidden for the eva02 clip variants
_EVA02_VARIANTS: dict[str, tuple[int, int, int, int]] = {
    "base": (768, 12, 12, 2048),
    "large": (1024, 24, 16, 2730),
}


def resolve_eva02(name: str, vcfg, embed_dim: int) -> Eva02Cfg:
    size_key = next((k for k in _EVA02_VARIANTS if f"_{k}_" in name), None)
    if size_key is None:
        raise ConfigError(f"Unsupported EVA02 variant '{name}' (supported sizes: "
                          f"{', '.join(_EVA02_VARIANTS)})")
    m = re.search(r"patch(\d+)", name)
    if not m:
        raise ConfigError(f"No patch size in '{name}'")
    width, layers, heads, hidden = _EVA02_VARIANTS[size_key]
    override = vcfg.extra.get("eva02_cfg", {})
    return Eva02Cfg(
        image_size=vcfg.image_size,
        patch_size=int(m.group(1)),
        width=override.get("width", width),
        layers=override.get("layers", layers),
        heads=override.get("heads", heads),
        mlp_hidden=override.get("mlp_hidden", hidden),
        embed_dim=embed_dim,
        use_proj=(vcfg.timm_proj or "linear") not in ("none", ""),
        rope_temperature=override.get("rope_temperature", 10000.0),
        rope_ref_grid=override.get("rope_ref_grid", 16),
        ln_eps=override.get("ln_eps", 1e-6),
    )


def derive_eva02_cfg_from_sd(sd) -> dict:
    """EVA02 dims from a checkpoint state dict's shapes. ``heads`` is not
    shape-derivable (square q/k/v for any head count) and stays table- or
    override-seeded. Raises WeightError when the dict is not an
    EVA02-shaped tower."""
    sd = {k: np.asarray(v).shape for k, v in strip_prefix(
        dict(sd), "model.", "visual.", "trunk.").items()}
    patch = sd.get("patch_embed.proj.weight")
    if patch is None or len(patch) != 4 or patch[1] != 3:
        raise WeightError("state dict has no [width, 3, p, p] patch conv "
                          "(patch_embed.proj.weight)")
    layers = _max_index(sd, r"blocks\.(\d+)\.norm1\.weight")
    gate = sd.get("blocks.0.mlp.fc1_g.weight")
    if layers == 0 or gate is None:
        raise WeightError("state dict has no EVA02 SwiGLU blocks (blocks.*.mlp.fc1_g)")
    return {"width": int(patch[0]), "layers": layers, "mlp_hidden": int(gate[0])}


def rope_embed(grid: int, head_dim: int, temperature: float = 10000.0,
               ref_grid: int | None = None, prefix: int = 0) -> np.ndarray:
    """Axial 2-D rope angle table [prefix + grid², head_dim]: per position the
    head dim holds [y bands, x bands] (timm ``RotaryEmbeddingCat``)."""
    return axial_rope_table(grid, head_dim, temperature, order="yx", ref_grid=ref_grid,
                            prefix=prefix)


def init(cfg: Eva02Cfg, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout (blocks
    stacked on axis 0). ``device="meta"`` gives the shapes alone."""
    g, kw = generator, {"device": device, "dtype": dtype}
    patch_dim = cfg.patch_size ** 2 * 3
    w, hid, lkw = cfg.width, cfg.mlp_hidden, {"layers": cfg.layers, **kw}
    params = {
        "patch_embed": _init_linear(g, patch_dim, w, std=patch_dim ** -0.5, **kw),
        "cls_token": _normal((1, 1, w), 0.02, g, device, dtype),
        "pos_embed": _normal((1, cfg.grid ** 2 + 1, w), 0.02, g, device, dtype),
        "ln_post": _init_ln(w, **kw),
        "blocks": {
            "ln1": _init_ln(w, **lkw),
            "attn": {"q": _init_linear(g, w, w, **lkw),
                     "k": _init_linear(g, w, w, bias=False, **lkw),
                     "v": _init_linear(g, w, w, **lkw),
                     "inner_ln": _init_ln(w, **lkw),
                     "out": _init_linear(g, w, w, **lkw)},
            "ln2": _init_ln(w, **lkw),
            "mlp": {"w_gate": _init_linear(g, w, hid, **lkw),
                    "w_x": _init_linear(g, w, hid, **lkw),
                    "ffn_ln": _init_ln(hid, **lkw),
                    "w_out": _init_linear(g, hid, w, **lkw)},
        },
    }
    if cfg.use_proj:
        params["proj"] = _init_linear(g, w, cfg.embed_dim, **kw)
    return params


class Eva02(ParamTree):
    """The EVA02 tower over a parameter tree from ``init`` or
    ``weights.load_pytree`` (optionally quantized)."""

    def __init__(self, cfg: Eva02Cfg, params: Mapping):
        super().__init__({k: v for k, v in params.items() if k != "blocks"})
        self.cfg = cfg
        self.blocks = nn.ModuleList(ParamTree(unstack(params["blocks"], i))
                                    for i in range(cfg.layers))
        self._rope: dict[tuple[torch.device, bool], tuple[torch.Tensor, torch.Tensor]] = {}

    def rope_tables(self, device: torch.device, packed: bool):
        """(sin, cos) f32 tables on ``device``, built once: head-tiled
        [S, H·D] with an identity row 0 for the packed kernel, else [N, D]
        for the patch tokens."""
        key = (device, packed)
        if key not in self._rope:
            cfg = self.cfg
            ang = rope_embed(cfg.grid, cfg.head_dim, cfg.rope_temperature, cfg.rope_ref_grid,
                             prefix=int(packed))
            self._rope[key] = tuple(t.to(device) for t in head_tiled_tables(
                ang, cfg.heads if packed else 1))
        return self._rope[key]

    def _attention(self, a, h: torch.Tensor, impl: str, packed: bool) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = (linear(a[n], h) for n in "qkv")
        sin, cos = self.rope_tables(h.device, packed)
        if packed:  # rope in the kernel; the identity row covers the class token
            return flash_attention_packed(q, k, v, num_heads=cfg.heads, rope=(sin, cos),
                                          fast_softmax=impl == "kernel_fast")
        q, k, v = (_split_heads(t, cfg.heads) for t in (q, k, v))
        q, k = (torch.cat([t[:, :, :1], apply_rope(t[:, :, 1:], sin, cos)], dim=2)
                for t in (q, k))
        if impl in KERNEL_IMPLS:
            o = flash_attention(q, k, v, fast_softmax=impl == "kernel_fast")
        else:
            o = attention_core(q, k, v)
        b, hh, s, d = o.shape
        return o.transpose(1, 2).reshape(b, s, hh * d)

    def forward(self, pixels: torch.Tensor, *, attn_impl: str = "eager",
                channels_first: bool = False, normalize: bool = True) -> torch.Tensor:
        """[B, H, W, 3] preprocessed pixels ([B, 3, H, W] with
        ``channels_first``) → [B, embed_dim]."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"Unknown attention impl '{attn_impl}' (choices: "
                             f"{', '.join(ATTN_IMPLS)})")
        cfg, eps = self.cfg, self.cfg.ln_eps
        packed = attn_impl in KERNEL_IMPLS and head_group(cfg.heads, cfg.head_dim) is not None
        x = linear(self["patch_embed"], patchify(pixels, cfg.patch_size, channels_first))
        cls = self["cls_token"].to(x.dtype).expand(x.shape[0], 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self["pos_embed"].to(x.dtype)
        for blk in self.blocks:
            a = blk["attn"]
            o = self._attention(a, layer_norm(blk["ln1"], x, eps=eps), attn_impl, packed)
            x = x + linear(a["out"], layer_norm(a["inner_ln"], o, eps=eps))  # sub-LN
            m = blk["mlp"]
            h = layer_norm(blk["ln2"], x, eps=eps)
            hidden = F.silu(linear(m["w_gate"], h).float()) * linear(m["w_x"], h).float()
            hidden = layer_norm(m["ffn_ln"], hidden.to(h.dtype), eps=eps)
            x = x + linear(m["w_out"], hidden)
        pooled = layer_norm(self["ln_post"], x[:, 0], eps=eps)
        if cfg.use_proj and "proj" in self:
            pooled = linear(self["proj"], pooled)
        return l2_normalize(pooled) if normalize else pooled


def map_eva02_visual(sd: Mapping[str, np.ndarray]) -> dict:
    """A timm eva02 state dict (``visual.trunk.*``) → the EVA02 tree (numpy).
    timm naming: blocks.N.{norm1,norm2}, attn.{q_proj,k_proj,v_proj,norm,
    proj}, mlp.{fc1_g,fc1_x,norm,fc2}; patch_embed.proj, cls_token,
    pos_embed, norm; the projection is open_clip's ``head.proj``
    (``timm_proj="linear"``) or, where open_clip leaves ``timm_proj`` unset
    (its EVA02 configs) and builds the trunk with ``num_classes=embed_dim``,
    the trunk's own ``head``. The JAX package's mapper reads ``head.proj``
    alone, so such a tree lacks ``proj`` there and fails validation."""
    sd = {k: np.asarray(v) for k, v in strip_prefix(
        dict(sd), "model.", "visual.", "trunk.").items()}
    n = _max_index(sd, r"blocks\.(\d+)\.norm1\.weight")
    blocks = []
    for i in range(n):
        p = f"blocks.{i}"
        blocks.append({
            "ln1": _ln(sd, f"{p}.norm1"),
            "attn": {"q": _linear(sd, f"{p}.attn.q_proj"),
                     "k": _linear(sd, f"{p}.attn.k_proj"),
                     "v": _linear(sd, f"{p}.attn.v_proj"),
                     "inner_ln": _ln(sd, f"{p}.attn.norm"),
                     "out": _linear(sd, f"{p}.attn.proj")},
            "ln2": _ln(sd, f"{p}.norm2"),
            "mlp": {"w_gate": _linear(sd, f"{p}.mlp.fc1_g"),
                    "w_x": _linear(sd, f"{p}.mlp.fc1_x"),
                    "ffn_ln": _ln(sd, f"{p}.mlp.norm"),
                    "w_out": _linear(sd, f"{p}.mlp.fc2")},
        })
    pos = np.asarray(_get(sd, "pos_embed"))
    if pos.ndim == 2:
        pos = pos[None]
    params: dict = {
        "patch_embed": {"w": _conv_to_patch(_get(sd, "patch_embed.proj.weight")),
                        "b": _get(sd, "patch_embed.proj.bias")},
        "cls_token": np.asarray(_get(sd, "cls_token")).reshape(1, 1, -1),
        "pos_embed": pos,
        "blocks": _stack_blocks(blocks),
        "ln_post": _ln(sd, "norm"),
    }
    if "head.proj.weight" in sd:
        params["proj"] = _linear(sd, "head.proj")
    elif "head.weight" in sd:
        params["proj"] = _linear(sd, "head")
    return params

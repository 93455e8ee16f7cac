"""Config-driven architecture resolution: ``open_clip_config.json`` →
``TowerSpec``.

Counterpart of ``clip_embedder_tpu.models.build``: timm ViTs (SigLIP/SigLIP2,
gap/avg/tok pools, register tokens, the linear or mlp ``timm_proj`` head),
PE-Core (``vit_pe_core_*``: 2-D axial rope, map pool), EVA02
(``eva02_*``), FastViT / MobileCLIP (``fastvit_*``, ``mci*``,
``mobileclip*``), ConvNeXt (``convnext_*``), ModifiedResNet (list-valued
``layers``), classic open_clip ViTs (with CoCa's boolean attentional
pooler), open_clip text transformers (with CoCa's ``embed_cls``) and HF
BERT/RoBERTa text towers (``hf_model_name``) and the MCT hybrid text tower
(``text_cfg.mct_cfg``, which only a conversion from an ONNX graph writes:
``onnx_reader.derive_mct_cfg``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any

from ..config import ModelCfg
from ..errors import ConfigError
from ..utils.logging import warn_once
from .convnext import resolve_convnext
from .eva02 import resolve_eva02
from .fastvit import resolve_fastvit
from .hf_text import resolve_hf_text
from .mct import MctCfg
from .resnet import ResNetCfg
from .text_transformer import TextCfgResolved
from .vit import ViTCfg

# PE-Core (Meta Perception Encoder, timm vit_pe_core_*): width, layers, heads,
# mlp_hidden per size name, from the published perception_models
# architecture. Wrong dims fail at weight load, and every field can be
# overridden through vision_cfg.extra["pe_cfg"].
_PE_CORE_SIZES: dict[str, tuple[int, int, int, int]] = {
    "base": (768, 12, 12, 3072),
    "large": (1024, 24, 16, 4096),
    "gigantic": (1536, 50, 16, 8960),
    "bigg": (1536, 50, 16, 8960),
}

# width, layers, heads, mlp_hidden for timm ViT size names.
_TIMM_VIT_SIZES: dict[str, tuple[int, int, int, int]] = {
    "tiny": (192, 12, 3, 768),
    "small": (384, 12, 6, 1536),
    "base": (768, 12, 12, 3072),
    "large": (1024, 24, 16, 4096),
    "huge": (1280, 32, 16, 5120),
    "so150m": (896, 18, 14, 2304),
    "so400m": (1152, 27, 16, 4304),
    "giant": (1408, 40, 16, 6144),
    "giantopt": (1536, 40, 16, 6144),
    "gopt": (1536, 40, 16, 6144),
}


@dataclass(frozen=True)
class TowerSpec:
    """A resolved tower: family name + its config object."""

    # "vit" | "eva02" | "fastvit" | "convnext" | "resnet" | "text_transformer" | "hf_bert"
    # | "mct" | "onnx" (the graph executor: cfg is an ``onnx_exec.OnnxCfg``)
    family: str
    cfg: Any


def _parse_timm_vit(name: str, vcfg, embed_dim: int, timm_pool: str | None,
                    timm_proj: str | None) -> ViTCfg:
    """Resolve a timm ViT name like ``vit_so400m_patch16_siglip_384``."""
    size_key = None
    for key in sorted(_TIMM_VIT_SIZES, key=len, reverse=True):
        if f"_{key}_" in name or name.endswith(f"_{key}"):
            size_key = key
            break
    if size_key is None:
        raise ConfigError(f"Unknown timm ViT size in '{name}'")
    width, layers, heads, mlp_hidden = _TIMM_VIT_SIZES[size_key]
    override = vcfg.extra.get("vit_cfg", {})  # test/fixture hook
    width = override.get("width", width)
    layers = override.get("layers", layers)
    heads = override.get("heads", heads)
    mlp_hidden = override.get("mlp_hidden", mlp_hidden)

    m = re.search(r"patch(\d+)", name)
    if not m:
        raise ConfigError(f"No patch size in timm model name '{name}'")
    patch = int(m.group(1))
    reg = re.search(r"_reg(\d+)", name)
    reg_tokens = int(reg.group(1)) if reg else 0

    is_siglip = "siglip" in name
    norm_after_pool = False
    if timm_pool:
        pool = timm_pool
    elif "gap" in name.split("_"):
        pool = "gap"
    elif is_siglip:
        pool = "map"
    else:
        pool = "tok"
    if pool == "avg":
        pool = "gap"
        norm_after_pool = True

    # open_clip's TimmModel takes a linear projection when timm_proj is
    # omitted; SigLIP configs set 'none'; 'mlp' loads as head.fc1/head.fc2
    use_proj = (timm_proj or "linear") not in ("none", "")
    return ViTCfg(
        image_size=vcfg.image_size,
        patch_size=patch,
        width=width,
        layers=layers,
        heads=heads,
        mlp_hidden=mlp_hidden,
        embed_dim=embed_dim if use_proj else width,
        activation="gelu_tanh" if is_siglip else "gelu",
        use_class_token=(not is_siglip and pool != "gap" and reg_tokens == 0),
        use_ln_pre=False,
        pool=pool,
        use_proj=use_proj,
        proj_bias=True,
        ln_eps=1e-6,
        pos_embed_cls=(not is_siglip and pool != "gap" and reg_tokens == 0),
        norm_after_pool=norm_after_pool,
        reg_tokens=reg_tokens,
    )


def _parse_pe_core(name: str, vcfg, embed_dim: int) -> ViTCfg:
    """Resolve a PE-Core name (``vit_pe_core_gigantic_patch14_448``): a ViT
    with a class token, a learned absolute pos embed, ln_pre, 2-D axial rope
    (x bands first), a map pool (8 heads, ratio-4 MLP) and a linear
    projection. Size keys match case-insensitively (the flagship is spelled
    bigG); every field can be overridden through ``vision_cfg.extra["pe_cfg"]``,
    and a warning names the fields taken from the size table."""
    size_key = next((k for k in _PE_CORE_SIZES if f"_{k}_" in name.lower()), None)
    if size_key is None:
        raise ConfigError(f"Unsupported PE-Core variant '{name}' (supported sizes: "
                          f"{', '.join(sorted(_PE_CORE_SIZES))})")
    width, layers, heads, mlp_hidden = _PE_CORE_SIZES[size_key]
    m = re.search(r"patch(\d+)", name)
    if not m:
        raise ConfigError(f"No patch size in timm model name '{name}'")
    o = vcfg.extra.get("pe_cfg", {})
    missing = [k for k in ("width", "layers", "heads", "mlp_hidden") if k not in o]
    if missing:
        warn_once(name,
                  "PE-Core tower '%s': field(s) %s taken from the published Perception "
                  "Encoder architecture, not from the model dir (override them through "
                  "vision_cfg.extra['pe_cfg']).", name, ",".join(missing))
    width = o.get("width", width)
    return ViTCfg(
        image_size=vcfg.image_size,
        patch_size=int(o.get("patch_size", m.group(1))),
        width=width,
        layers=o.get("layers", layers),
        heads=o.get("heads", heads),
        mlp_hidden=o.get("mlp_hidden", mlp_hidden),
        embed_dim=embed_dim,
        activation=o.get("activation", "gelu"),
        use_class_token=o.get("use_class_token", True),
        use_ln_pre=o.get("use_ln_pre", True),
        pool=o.get("pool", "map"),
        use_proj=o.get("use_proj", True),
        proj_bias=False,
        use_layer_scale=o.get("use_layer_scale", False),
        ln_eps=o.get("ln_eps", 1e-5),
        pos_embed_cls=o.get("pos_embed_cls", True),
        rope_2d=True,
        rope_temperature=o.get("rope_temperature", 10000.0),
        pool_heads=o.get("pool_heads", 8),
        pool_mlp_hidden=o.get("pool_mlp_hidden", 4 * width),
    )


def resolve_vision(model_cfg: ModelCfg) -> TowerSpec:
    """open_clip vision_cfg → TowerSpec."""
    v = model_cfg.vision_cfg
    embed_dim = model_cfg.embed_dim

    if v.timm_model_name:
        name = v.timm_model_name
        if "_pe_core_" in name or name.startswith("pe_core"):
            return TowerSpec("vit", _parse_pe_core(name, v, embed_dim))
        # EVA01 (eva_giant_*) is a timm ViT; EVA02 (eva02_*) has rope and SwiGLU
        if name.startswith("eva02_"):
            return TowerSpec("eva02", resolve_eva02(name, v, embed_dim))
        if name.startswith(("vit_", "eva_")):
            return TowerSpec(
                "vit", _parse_timm_vit(name, v, embed_dim, v.timm_pool, v.timm_proj))
        if name.startswith(("fastvit", "mci", "mobileclip")):
            return TowerSpec("fastvit", resolve_fastvit(name, v, embed_dim, model_cfg))
        if name.startswith("convnext"):
            return TowerSpec("convnext", resolve_convnext(name, v, embed_dim, model_cfg))
        raise ConfigError(f"Unsupported timm vision tower '{name}'")

    # ModifiedResNet towers declare per-stage depths as a list (RN50 =
    # [3, 4, 6, 3]); resnet_cfg carries overrides (an ONNX graph's attnpool
    # head count, which the open_clip config implies only through head_width)
    if isinstance(v.layers, (list, tuple)):
        o = v.extra.get("resnet_cfg", {})
        width = o.get("width", v.width or 64)
        head_width = v.head_width or 64
        return TowerSpec("resnet", ResNetCfg(
            image_size=v.image_size,
            embed_dim=o.get("embed_dim", embed_dim),
            layers=tuple(o.get("layers", v.layers)),
            width=width,
            heads=o.get("heads", width * 32 // head_width),
        ))

    # Classic open_clip ViT.
    if v.layers is None or v.width is None:
        raise ConfigError("vision_cfg requires layers/width or timm_model_name")
    if v.patch_size is None:
        raise ConfigError("vision_cfg requires patch_size for ViT towers")
    # CoCa: the legacy boolean attentional_pool swaps CLS pooling for a
    # 256-query pooler in the embed space; the string 'parallel'/'cascade'
    # forms are marked WIP upstream and have no released checkpoints
    attn_pool = v.extra.get("attentional_pool", False)
    if isinstance(attn_pool, str):
        raise ConfigError(f"attentional_pool='{attn_pool}' (parallel/cascade) is not "
                          "supported; only the boolean CoCa-style pooler is")
    head_width = v.head_width or 64
    mlp_ratio = v.mlp_ratio or 4.0
    return TowerSpec(
        "vit",
        ViTCfg(
            image_size=v.image_size,
            patch_size=v.patch_size,
            width=v.width,
            layers=v.layers,
            heads=v.width // head_width,
            mlp_hidden=int(round(v.width * mlp_ratio)),
            embed_dim=embed_dim,
            activation="quick_gelu" if model_cfg.quick_gelu else "gelu",
            use_class_token=True,
            use_ln_pre=True,
            pool="attn" if attn_pool else "cls",
            use_proj=True,
            proj_bias=False,
            ln_eps=1e-5,
            attn_pool_queries=int(v.extra.get("attn_pooler_queries", 256)) if attn_pool else 0,
            attn_pool_dim=embed_dim if attn_pool else 0,
            pool_heads=int(v.extra.get("attn_pooler_heads", 8)) if attn_pool else 0,
        ),
    )


def resolve_text(model_cfg: ModelCfg) -> TowerSpec:
    """open_clip text_cfg → TowerSpec."""
    t = model_cfg.text_cfg
    if t.hf_model_name or t.extra.get("hf_model_name"):
        return TowerSpec("hf_bert", resolve_hf_text(model_cfg))
    mct_raw = t.extra.get("mct_cfg")
    if mct_raw:
        # the cfg dict was derived from the exported graph and persisted by
        # text.py after a conversion passed its self-check; JSON turned the
        # conv-block tuples into lists
        mc = dict(mct_raw)
        mc["conv_blocks"] = tuple(tuple(b) for b in mc["conv_blocks"])
        return TowerSpec("mct", MctCfg(**mc))

    width = t.width or 512
    heads = t.heads or width // 64
    layers = t.layers or 12
    vocab = t.vocab_size or 49408
    mlp_ratio = t.extra.get("mlp_ratio", 4.0)
    no_causal = bool(t.extra.get("no_causal_mask", False))
    pool = t.extra.get("pool_type", "last" if no_causal else "argmax")
    proj_bias = bool(t.extra.get("proj_bias", False))
    act_kwargs = t.extra.get("act_kwargs") or {}
    if model_cfg.quick_gelu:
        activation = "quick_gelu"
    elif act_kwargs.get("approximate") == "tanh":
        activation = "gelu_tanh"
    else:
        activation = "gelu"
    norm_kwargs = t.extra.get("norm_kwargs") or {}
    ln_eps = float(norm_kwargs.get("eps", 1e-5))
    # CoCa text tower: embed_cls appends a learned cls token, pooled at the
    # last position (open_clip's TextTransformer defaults pad_id to 0 for its
    # cls mask; the embedder puts in the tokenizer's)
    embed_cls = bool(t.extra.get("embed_cls", False))

    return TowerSpec(
        "text_transformer",
        TextCfgResolved(
            context_length=t.context_length,
            vocab_size=vocab,
            width=width,
            heads=heads,
            layers=layers,
            mlp_hidden=int(round(width * mlp_ratio)),
            embed_dim=model_cfg.embed_dim,
            activation=activation,
            causal=not no_causal,
            pool="last" if embed_cls else pool,
            proj_bias=proj_bias,
            ln_eps=ln_eps,
            embed_cls=embed_cls,
            pad_id=int(t.extra.get("pad_id", 0)),
        ),
    )

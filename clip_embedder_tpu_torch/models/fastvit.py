"""FastViT / MobileCLIP "MCi" vision towers, inference (reparameterized) form.

Counterpart of ``clip_embedder_tpu.models.fastvit`` (MobileCLIP2-S2/S3/S4:
reference tests/integration_test.rs:13, pull_onnx.py:110-116):

  stem: conv3x3 s2 → dw3x3 s2 → pw1x1 (each conv + bias + gelu)
  4 stages of blocks, with a downsample (dw7x7 s2 [→ gelu] → pw1x1 → gelu)
  between stages:
    - RepMixer block: the fused dw3x3 token mixer, then ConvFFN (dw7x7 →
      pw expand → gelu → pw project) with layer scale;
    - attention block: a per-channel affine (the folded BatchNorm) → MHA over
      the flattened tokens (plain attention, head dim 32) → layer scale, then
      ConvFFN with layer scale;
    - RepCPE (a fused dw7x7 positional conv) at stage entry where set;
  final: expand conv (dw3x3, ×2 channels) → gelu → f32 mean pool → head →
  L2-normalize.

Activations are NHWC, as in the JAX package; the convs run through
``ops.layers.conv2d`` (cuDNN on the card, channels-last). Under int8 the
ConvFFN's 1×1 convs are quantized matmuls (``ops.quant.quantize_tree``) and go
through ``linear``: kernel 6 (``int8_linear_fused``) on the card at 128 rows
or more.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..errors import ConfigError, WeightError
from ..ops.attention import multi_head_attention
from ..ops.layers import conv2d, gelu, linear, nhwc
from ..ops.normalize import l2_normalize
from ..weights import (ParamTree, _conv_hwio, _linear, _split_qkv, _stack_blocks, conv_tree,
                       fold_bn_affine, strip_prefix, unstack)
from .vit import _conv_init, _init_attn, _init_linear, _normal


@dataclass(frozen=True)
class FastViTCfg:
    """Resolved FastViT architecture (the JAX package's fields)."""

    image_size: int
    embed_dim: int
    depths: tuple[int, ...]
    dims: tuple[int, ...]
    mlp_ratios: tuple[float, ...]
    mixers: tuple[str, ...]          # "repmixer" | "attention"
    pos_embs: tuple[bool, ...]       # RepCPE at stage entry
    head_dim: int = 32
    final_conv_ratio: float = 2.0
    use_head_proj: bool = True
    # timm lkc_use_act: the mci (MobileCLIP) family applies an activation
    # after the large-kernel downsample conv; classic fastvit variants don't
    lkc_act: bool = False


# timm fastvit variants (inference-form shapes), as in the JAX package
_FASTVIT_VARIANTS: dict[str, dict] = {
    "fastvit_t8": dict(depths=(2, 2, 4, 2), dims=(48, 96, 192, 384),
                       mlp_ratios=(3, 3, 3, 3),
                       mixers=("repmixer",) * 4, pos_embs=(False,) * 4),
    "fastvit_t12": dict(depths=(2, 2, 6, 2), dims=(64, 128, 256, 512),
                        mlp_ratios=(3, 3, 3, 3),
                        mixers=("repmixer",) * 4, pos_embs=(False,) * 4),
    "fastvit_s12": dict(depths=(2, 2, 6, 2), dims=(64, 128, 256, 512),
                        mlp_ratios=(4, 4, 4, 4),
                        mixers=("repmixer",) * 4, pos_embs=(False,) * 4),
    "fastvit_sa12": dict(depths=(2, 2, 6, 2), dims=(64, 128, 256, 512),
                         mlp_ratios=(4, 4, 4, 4),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    "fastvit_sa24": dict(depths=(4, 4, 12, 4), dims=(64, 128, 256, 512),
                         mlp_ratios=(4, 4, 4, 4),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    "fastvit_sa36": dict(depths=(6, 6, 18, 6), dims=(64, 128, 256, 512),
                         mlp_ratios=(4, 4, 4, 4),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    "fastvit_ma36": dict(depths=(6, 6, 18, 6), dims=(76, 152, 304, 608),
                         mlp_ratios=(4, 4, 4, 4),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    # MobileCLIP image encoders
    "fastvit_mci0": dict(lkc_act=True, depths=(2, 6, 10, 2), dims=(64, 128, 256, 512),
                         mlp_ratios=(3, 3, 3, 3),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    "fastvit_mci1": dict(lkc_act=True, depths=(4, 12, 20, 4), dims=(64, 128, 256, 512),
                         mlp_ratios=(3, 3, 3, 3),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    "fastvit_mci2": dict(lkc_act=True, depths=(4, 12, 24, 4), dims=(80, 160, 320, 640),
                         mlp_ratios=(3, 3, 3, 3),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    # MobileCLIP2-S3/S4 (MCi3/MCi4): dims from the published scaling;
    # conversion derives them from the checkpoint (derive_fastvit_cfg_from_sd)
    "fastvit_mci3": dict(lkc_act=True, depths=(4, 12, 24, 4), dims=(96, 192, 384, 768),
                         mlp_ratios=(3, 3, 3, 3),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
    "fastvit_mci4": dict(lkc_act=True, depths=(4, 12, 24, 4), dims=(128, 256, 512, 1024),
                         mlp_ratios=(3, 3, 3, 3),
                         mixers=("repmixer",) * 3 + ("attention",),
                         pos_embs=(False, False, False, True)),
}

_ALIASES = {
    "mobileclip_s0": "fastvit_mci0", "mobileclip_s1": "fastvit_mci1",
    "mobileclip_s2": "fastvit_mci2", "mobileclip2_s2": "fastvit_mci2",
    "mobileclip2_s3": "fastvit_mci3", "mobileclip2_s4": "fastvit_mci4",
}

# Variants whose structure comes from the published scaling recipe only: no
# checkpoint in the repo has confirmed their dims.
_UNANCHORED_VARIANTS = frozenset({"fastvit_mci3", "fastvit_mci4"})


def resolve_fastvit(name: str, vcfg, embed_dim: int, model_cfg) -> FastViTCfg:
    resolved = name if name in _FASTVIT_VARIANTS else _ALIASES.get(name, "")
    base = _FASTVIT_VARIANTS.get(resolved)
    if base is None:
        # bare aliases like "mci2"
        for key in _FASTVIT_VARIANTS:
            if key.endswith(name) or name.endswith(key.removeprefix("fastvit_")):
                base, resolved = _FASTVIT_VARIANTS[key], key
                break
    if base is None:
        raise ConfigError(f"Unknown FastViT variant '{name}'")
    override = vcfg.extra.get("fastvit_cfg", {})
    if resolved in _UNANCHORED_VARIANTS and "dims" not in override:
        # a converted checkpoint carries derived dims in the override; only a
        # table-seeded load without them warns
        from ..utils.logging import warn_once

        warn_once(
            resolved,
            "FastViT variant '%s' uses structure-from-paper dims that have "
            "no independent anchor in this build (golden fixtures pin "
            "today's numerics; real-checkpoint conversion re-checks shapes "
            "and fails loudly on mismatch)", resolved)
    merged = {**base, **override}
    return FastViTCfg(
        image_size=vcfg.image_size,
        embed_dim=embed_dim,
        depths=tuple(merged["depths"]),
        dims=tuple(merged["dims"]),
        mlp_ratios=tuple(merged["mlp_ratios"]),
        mixers=tuple(merged["mixers"]),
        pos_embs=tuple(merged["pos_embs"]),
        head_dim=int(merged.get("head_dim", 32)),
        final_conv_ratio=float(merged.get("final_conv_ratio", 2.0)),
        use_head_proj=bool(merged.get("use_head_proj", True)),
        lkc_act=bool(merged.get("lkc_act", False)),
    )


def derive_fastvit_cfg_from_sd(sd: Mapping[str, np.ndarray]) -> dict:
    """The stage architecture from a reparameterized timm fastvit state
    dict's shapes, so a conversion never leans on the table's unanchored
    rows. Not shape-derivable, kept from the family defaults: ``head_dim``
    (32 in every timm variant) and ``lkc_act`` (an activation's placement).
    Raises WeightError when the dict is not fastvit-shaped."""
    shapes = {k: tuple(np.asarray(v).shape) for k, v in strip_prefix(
        dict(sd), "model.", "visual.", "trunk.").items()}

    def conv_shape(*prefixes):
        for p in prefixes:
            s = shapes.get(f"{p}.weight")
            if s is not None:
                return s
        return None

    stem0 = conv_shape("stem.0.reparam_conv", "stem.0.conv")
    if stem0 is None or len(stem0) != 4 or stem0[1] != 3:
        raise WeightError("state dict has no fastvit RGB stem conv (stem.0.reparam_conv)")
    stage_ids = sorted({int(m.group(1)) for k in shapes
                        if (m := re.match(r"stages\.(\d+)\.", k))})
    if not stage_ids or stage_ids != list(range(len(stage_ids))):
        raise WeightError("state dict has no contiguous fastvit stages")

    depths, dims, ratios, mixers, pos_embs = [], [], [], [], []
    cur = int(stem0[0])
    for si in stage_ids:
        sp = f"stages.{si}"
        ds = conv_shape(f"{sp}.downsample.proj.1.reparam_conv", f"{sp}.downsample.proj.1.conv")
        if ds is not None:
            cur = int(ds[0])
        elif si > 0:
            raise WeightError(f"fastvit stage {si} has no downsample")
        dims.append(cur)
        block_ids = sorted({int(m.group(1)) for k in shapes
                            if (m := re.match(rf"stages\.{si}\.blocks\.(\d+)\.", k))})
        if not block_ids:
            raise WeightError(f"fastvit stage {si} has no blocks")
        depths.append(len(block_ids))
        mixers.append("attention" if f"{sp}.blocks.0.token_mixer.qkv.weight" in shapes
                      else "repmixer")
        pos_embs.append(f"{sp}.pos_emb.reparam_conv.weight" in shapes)
        fc1 = conv_shape(f"{sp}.blocks.0.mlp.fc1")
        if fc1 is None:
            raise WeightError(f"fastvit stage {si} has no ConvFFN fc1")
        ratios.append(int(fc1[0]) / cur)

    fin = conv_shape("final_conv.reparam_conv", "final_conv.conv")
    if fin is None:
        raise WeightError("state dict has no final expand conv")
    return {
        "depths": tuple(depths),
        "dims": tuple(dims),
        "mlp_ratios": tuple(ratios),
        "mixers": tuple(mixers),
        "pos_embs": tuple(pos_embs),
        "final_conv_ratio": int(fin[0]) / dims[-1],
        "use_head_proj": any(f"{k}.weight" in shapes for k in ("head.fc", "head.proj", "head")),
    }


# -- init --------------------------------------------------------------------



def init(cfg: FastViTCfg, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout: HWIO convs,
    each stage's blocks stacked on axis 0. ``device="meta"`` gives the
    shapes alone."""
    g, kw = generator, {"device": device, "dtype": dtype}
    c0 = cfg.dims[0]
    params = {
        "stem": [_conv_init(g, 3, 3, c0, **kw),
                 _conv_init(g, 3, c0, c0, groups=c0, **kw),
                 _conv_init(g, 1, c0, c0, **kw)],
        "stages": [],
    }
    for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage: dict = {}
        if i > 0:
            prev = cfg.dims[i - 1]
            stage["downsample"] = {"dw": _conv_init(g, 7, prev, prev, groups=prev, **kw),
                                   "pw": _conv_init(g, 1, prev, dim, **kw)}
        if cfg.pos_embs[i]:
            stage["cpe"] = _conv_init(g, 7, dim, dim, groups=dim, **kw)
        hidden = int(dim * cfg.mlp_ratios[i])
        lkw = {"layers": depth, **kw}
        block: dict = {"ffn": {
            "dw": _conv_init(g, 7, dim, dim, groups=dim, **lkw),
            "fc1": _conv_init(g, 1, dim, hidden, **lkw),
            "fc2": _conv_init(g, 1, hidden, dim, **lkw),
            "ls": torch.full((depth, dim), 1e-5, **kw)}}
        if cfg.mixers[i] == "repmixer":
            block["mixer"] = _conv_init(g, 3, dim, dim, groups=dim, **lkw)
        else:
            block["mixer"] = {
                "affine": {"scale": torch.ones((depth, dim), **kw),
                           "bias": torch.zeros((depth, dim), **kw)},
                "attn": _init_attn(g, dim, **lkw),
                "ls": torch.full((depth, dim), 1e-5, **kw)}
        stage["blocks"] = block
        params["stages"].append(stage)
    c_last = cfg.dims[-1]
    c_final = int(c_last * cfg.final_conv_ratio)
    params["final_conv"] = _conv_init(g, 3, c_last, c_final, groups=c_last, **kw)
    if cfg.use_head_proj:
        params["head"] = _init_linear(g, c_final, cfg.embed_dim, bias=False, **kw)
    return params


# -- forward -----------------------------------------------------------------









def _conv(p, x: torch.Tensor, *, stride: int = 1, groups: int = 1) -> torch.Tensor:
    if "w_q" in p:
        # an int8-quantized 1×1 conv (quantize_tree squeezes it to a matmul):
        # on NHWC, a matmul over the channel axis
        if stride != 1 or groups != 1:
            raise ValueError("a quantized conv must be stride-1 and ungrouped")
        return linear(p, x)
    pad = (p["w"].shape[-1] - 1) // 2
    return conv2d(x, p["w"], p.get("b"), stride=stride, padding=pad, groups=groups)


def _convffn(p, x: torch.Tensor) -> torch.Tensor:
    y = _conv(p["dw"], x, groups=x.shape[-1])
    y = gelu(_conv(p["fc1"], y))
    y = _conv(p["fc2"], y)
    return x + p["ls"].to(x.dtype) * y


def _attention_mix(p, x: torch.Tensor, head_dim: int) -> torch.Tensor:
    b, h, w, c = x.shape
    y = x * p["affine"]["scale"].to(x.dtype) + p["affine"]["bias"].to(x.dtype)
    mixed = multi_head_attention(p["attn"], y.reshape(b, h * w, c), num_heads=c // head_dim)
    return x + p["ls"].to(x.dtype) * mixed.reshape(b, h, w, c)


class FastViT(nn.Module):
    """The FastViT tower over a parameter tree from ``init`` or
    ``weights.load_pytree`` (optionally quantized)."""

    def __init__(self, cfg: FastViTCfg, params: Mapping):
        super().__init__()
        self.cfg = cfg
        self.stem = nn.ModuleList(conv_tree(p) for p in params["stem"])
        self.stages = nn.ModuleList()
        for depth, stage in zip(cfg.depths, params["stages"]):
            mod = conv_tree({k: v for k, v in stage.items() if k != "blocks"})
            mod.blocks = nn.ModuleList(conv_tree(unstack(stage["blocks"], j))
                                       for j in range(depth))
            self.stages.append(mod)
        self.final_conv = conv_tree(params["final_conv"])
        self.head = ParamTree(params["head"]) if "head" in params else None

    def forward(self, pixels: torch.Tensor, *, attn_impl: str = "eager",
                channels_first: bool = False, normalize: bool = True) -> torch.Tensor:
        """[B, H, W, 3] preprocessed pixels ([B, 3, H, W] with
        ``channels_first``) → [B, embed_dim]. The attention here is plain
        torch whatever ``attn_impl`` says: ``vision.resolve_attn_impl``
        refuses the kernel impls for this family."""
        cfg = self.cfg
        x = nhwc(pixels, channels_first)
        s = self.stem
        x = gelu(_conv(s[0], x, stride=2))
        x = gelu(_conv(s[1], x, stride=2, groups=x.shape[-1]))
        x = gelu(_conv(s[2], x))
        for mixer, stage in zip(cfg.mixers, self.stages):
            if "downsample" in stage:
                d = stage["downsample"]
                x = _conv(d["dw"], x, stride=2, groups=x.shape[-1])
                if cfg.lkc_act:  # timm lkc_use_act (mci family only)
                    x = gelu(x)
                x = gelu(_conv(d["pw"], x))
            if "cpe" in stage:
                x = _conv(stage["cpe"], x, groups=x.shape[-1])
            for block in stage.blocks:
                if mixer == "repmixer":
                    x = _conv(block["mixer"], x, groups=x.shape[-1])
                else:
                    x = _attention_mix(block["mixer"], x, cfg.head_dim)
                x = _convffn(block["ffn"], x)
        x = gelu(_conv(self.final_conv, x, groups=x.shape[-1]))
        # f32 pooling accumulation, as the JAX package pools
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
        if self.head is not None:
            pooled = linear(self.head, pooled)
        return l2_normalize(pooled) if normalize else pooled


# -- weight mapping (timm fastvit naming, reparameterized checkpoints) --------



def map_fastvit_visual(sd: Mapping[str, np.ndarray]) -> dict:
    """A reparameterized timm fastvit state dict (``visual.trunk.*``) → the
    FastViT tree (numpy): MobileOne, RepMixer and RepCPE as
    ``reparam_conv``, ConvFFN's fused dw conv with its unfused BatchNorm
    folded in, the attention block's BatchNorm folded into its affine."""
    sd = {k: np.asarray(v) for k, v in strip_prefix(
        dict(sd), "model.", "visual.", "trunk.").items()}

    def conv_any(*prefixes):
        for p in prefixes:
            if f"{p}.weight" in sd:
                return _conv_hwio(sd, p, zero_bias=True)
        raise WeightError(f"None of {prefixes} found in checkpoint")

    params: dict = {
        "stem": [conv_any("stem.0.reparam_conv", "stem.0.conv"),
                 conv_any("stem.1.reparam_conv", "stem.1.conv"),
                 conv_any("stem.2.reparam_conv", "stem.2.conv")],
        "stages": [],
    }
    stage_ids = sorted({int(m.group(1)) for k in sd if (m := re.match(r"stages\.(\d+)\.", k))})
    for si in stage_ids:
        sp = f"stages.{si}"
        stage: dict = {}
        if f"{sp}.downsample.proj.0.lkb_reparam.weight" in sd or \
           f"{sp}.downsample.proj.0.reparam_conv.weight" in sd:
            stage["downsample"] = {
                "dw": conv_any(f"{sp}.downsample.proj.0.lkb_reparam",
                               f"{sp}.downsample.proj.0.reparam_conv"),
                "pw": conv_any(f"{sp}.downsample.proj.1.reparam_conv",
                               f"{sp}.downsample.proj.1.conv"),
            }
        if f"{sp}.pos_emb.reparam_conv.weight" in sd:
            stage["cpe"] = _conv_hwio(sd, f"{sp}.pos_emb.reparam_conv", zero_bias=True)
        block_ids = sorted({int(m.group(1)) for k in sd
                            if (m := re.match(rf"stages\.{si}\.blocks\.(\d+)\.", k))})
        blocks = []
        for bi in block_ids:
            bp = f"{sp}.blocks.{bi}"
            block: dict = {}
            if f"{bp}.token_mixer.reparam_conv.weight" in sd:
                block["mixer"] = _conv_hwio(sd, f"{bp}.token_mixer.reparam_conv", zero_bias=True)
                ls_key = f"{bp}.layer_scale.gamma"
            else:
                qkv = sd.get(f"{bp}.token_mixer.qkv.weight")
                if qkv is None:
                    raise WeightError(f"Block '{bp}' has neither repmixer nor attention")
                attn = _split_qkv(qkv, sd.get(f"{bp}.token_mixer.qkv.bias"))
                attn["out"] = _linear(sd, f"{bp}.token_mixer.proj")
                # the (unfused) BatchNorm as a per-channel affine. A norm
                # without running statistics is not one (the JAX mapper takes
                # it as a plain affine): refused, not guessed
                mean_ = sd.get(f"{bp}.norm.running_mean")
                var_ = sd.get(f"{bp}.norm.running_var")
                if mean_ is None or var_ is None:
                    raise WeightError(f"'{bp}.norm' has no running statistics: the FastViT "
                                      "mapper takes a BatchNorm there, and no other norm")
                scale, bias = fold_bn_affine(sd[f"{bp}.norm.weight"], sd[f"{bp}.norm.bias"],
                                             mean_, var_)
                block["mixer"] = {
                    "affine": {"scale": scale.astype(np.float32),
                               "bias": bias.astype(np.float32)},
                    "attn": attn,
                    "ls": np.asarray(sd[f"{bp}.layer_scale_1.gamma"]).reshape(-1),
                }
                ls_key = f"{bp}.layer_scale_2.gamma"
            ffn_prefix = f"{bp}.mlp"
            dw = conv_any(f"{ffn_prefix}.conv.conv", f"{ffn_prefix}.conv")
            # timm ConvMlp's depthwise conv is ConvNormAct: a bias-free conv
            # and a BatchNorm that reparameterize_model does not fuse
            bn_prefix = f"{ffn_prefix}.conv.bn"
            if f"{bn_prefix}.weight" in sd:
                scale, bn_bias = fold_bn_affine(
                    sd[f"{bn_prefix}.weight"], sd[f"{bn_prefix}.bias"],
                    sd[f"{bn_prefix}.running_mean"], sd[f"{bn_prefix}.running_var"])
                dw["w"] = (dw["w"] * scale[None, None, None, :]).astype(np.float32)
                dw["b"] = (np.asarray(dw["b"], np.float64) * scale + bn_bias).astype(np.float32)
            block["ffn"] = {
                "dw": dw,
                "fc1": _conv_hwio(sd, f"{ffn_prefix}.fc1", zero_bias=True),
                "fc2": _conv_hwio(sd, f"{ffn_prefix}.fc2", zero_bias=True),
                "ls": np.asarray(sd[ls_key]).reshape(-1),
            }
            blocks.append(block)
        stage["blocks"] = _stack_blocks(blocks)
        params["stages"].append(stage)

    params["final_conv"] = conv_any("final_conv.reparam_conv", "final_conv.conv")
    for head_key in ("head.fc", "head.proj", "head"):
        if f"{head_key}.weight" in sd:
            params["head"] = _linear(sd, head_key)
            break
    return params

"""ConvNeXt vision towers (laion CLIP-convnext_base_w / _large_d / _xxlarge:
the timm ``convnext_*`` branch of open_clip vision configs).

Counterpart of ``clip_embedder_tpu.models.convnext``, inference form on NHWC
activations: a 4×4/s4 stem conv and LayerNorm; stages of blocks (7×7
depthwise conv → channel LayerNorm → fc1 → gelu → fc2 → optional layer scale
``gamma`` → residual) with LayerNorm + 2×2/s2 conv downsamples between
stages; then either the global average pool and ``head_norm``, or, for
head_norm_first checkpoints, ``pre_norm`` before the pool; then the open_clip
projection: ``linear``, ``mlp`` (fc1 → gelu → fc2) or ``none``.

The block's fc1 and fc2 are [*, C] matmuls on NHWC; under int8 they take
kernel 6 (``int8_linear_fused``) on the card at 128 rows or more.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
from torch import nn

from ..errors import ConfigError
from ..ops.layers import conv2d, gelu, layer_norm, linear, nhwc
from ..ops.normalize import l2_normalize
from ..weights import (ParamTree, _conv_hwio, _linear, _ln, _stack_blocks, conv_layout,
                       conv_tree, mlp_head_keys, strip_prefix, unstack)
from .vit import _conv_init, _init_linear, _init_ln


@dataclass(frozen=True)
class ConvNeXtCfg:
    """Resolved ConvNeXt architecture (the JAX package's fields)."""

    image_size: int
    embed_dim: int
    depths: tuple[int, ...]
    dims: tuple[int, ...]
    proj: str = "linear"          # linear | mlp | none
    ln_eps: float = 1e-6


_CONVNEXT_VARIANTS: dict[str, dict] = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "convnext_xlarge": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)),
    "convnext_xxlarge": dict(depths=(3, 4, 30, 3), dims=(384, 768, 1536, 3072)),
}


def resolve_convnext(name: str, vcfg, embed_dim: int, model_cfg) -> ConvNeXtCfg:
    base = _CONVNEXT_VARIANTS.get(name)
    if base is None:
        raise ConfigError(f"Unknown ConvNeXt variant '{name}'")
    merged = {**base, **vcfg.extra.get("convnext_cfg", {})}
    proj = vcfg.timm_proj or "linear"
    return ConvNeXtCfg(
        image_size=vcfg.image_size,
        embed_dim=embed_dim,
        depths=tuple(merged["depths"]),
        dims=tuple(merged["dims"]),
        proj={"mlp": "mlp", "none": "none", "": "none"}.get(proj, "linear"),
    )


def init(cfg: ConvNeXtCfg, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout: HWIO convs,
    each stage's blocks stacked on axis 0, layer scale on every block and
    ``head_norm`` after the pool. ``device="meta"`` gives the shapes alone."""
    g, kw = generator, {"device": device, "dtype": dtype}
    c0 = cfg.dims[0]
    params = {
        "stem_conv": _conv_init(g, 4, 3, c0, **kw),
        "stem_norm": _init_ln(c0, **kw),
        "stages": [],
        "head_norm": _init_ln(cfg.dims[-1], **kw),
    }
    for i, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage: dict = {}
        if i > 0:
            stage["downsample_norm"] = _init_ln(cfg.dims[i - 1], **kw)
            stage["downsample_conv"] = _conv_init(g, 2, cfg.dims[i - 1], dim, **kw)
        lkw = {"layers": depth, **kw}
        stage["blocks"] = {
            "dw": _conv_init(g, 7, dim, dim, groups=dim, **lkw),
            "norm": _init_ln(dim, **lkw),
            "fc1": _init_linear(g, dim, dim * 4, **lkw),
            "fc2": _init_linear(g, dim * 4, dim, **lkw),
            "gamma": torch.full((depth, dim), 1e-6, **kw),
        }
        params["stages"].append(stage)
    if cfg.proj == "linear":
        params["proj"] = _init_linear(g, cfg.dims[-1], cfg.embed_dim, **kw)
    elif cfg.proj == "mlp":  # open_clip's TimmModel: Mlp(dims[-1], 2·embed_dim, embed_dim)
        hidden = 2 * cfg.embed_dim
        params["proj"] = {"fc1": _init_linear(g, cfg.dims[-1], hidden, **kw),
                          "fc2": _init_linear(g, hidden, cfg.embed_dim, **kw)}
    return params


def _conv(p, x: torch.Tensor, *, stride: int = 1, groups: int = 1) -> torch.Tensor:
    pad = (p["w"].shape[-1] - 1) // 2 if stride == 1 else 0
    return conv2d(x, p["w"], p.get("b"), stride=stride, padding=pad, groups=groups)


def _block(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    y = _conv(p["dw"], x, groups=x.shape[-1])
    y = layer_norm(p["norm"], y, eps=eps)
    y = linear(p["fc2"], gelu(linear(p["fc1"], y)))
    if "gamma" in p:
        y = y * p["gamma"].to(y.dtype)
    return x + y


class ConvNeXt(ParamTree):
    """The ConvNeXt tower over a parameter tree from ``init`` or
    ``weights.load_pytree`` (optionally quantized). A tree with ``pre_norm``
    in place of ``head_norm``, or blocks without ``gamma``, is taken as it
    is."""

    def __init__(self, cfg: ConvNeXtCfg, params: Mapping):
        super().__init__(conv_layout({k: v for k, v in params.items() if k != "stages"}))
        self.cfg = cfg
        self.stages = nn.ModuleList()
        for depth, stage in zip(cfg.depths, params["stages"]):
            mod = conv_tree({k: v for k, v in stage.items() if k != "blocks"})
            mod.blocks = nn.ModuleList(conv_tree(unstack(stage["blocks"], j))
                                       for j in range(depth))
            self.stages.append(mod)

    def forward(self, pixels: torch.Tensor, *, attn_impl: str = "eager",
                channels_first: bool = False, normalize: bool = True) -> torch.Tensor:
        """[B, H, W, 3] preprocessed pixels ([B, 3, H, W] with
        ``channels_first``) → [B, embed_dim]. The attention here is plain
        torch whatever ``attn_impl`` says: ``vision.resolve_attn_impl``
        refuses the kernel impls for this family."""
        cfg, eps = self.cfg, self.cfg.ln_eps
        x = _conv(self["stem_conv"], nhwc(pixels, channels_first), stride=4)
        x = layer_norm(self["stem_norm"], x, eps=eps)
        for stage in self.stages:
            if "downsample_norm" in stage:
                x = layer_norm(stage["downsample_norm"], x, eps=eps)
                x = _conv(stage["downsample_conv"], x, stride=2)
            for block in stage.blocks:
                x = _block(block, x, eps)
        if "pre_norm" in self:  # head_norm_first checkpoints: LayerNorm before the pool
            x = layer_norm(self["pre_norm"], x, eps=eps)
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype)
        if "pre_norm" not in self:
            pooled = layer_norm(self["head_norm"], pooled, eps=eps)
        proj = self.get("proj")
        if proj is not None:
            if cfg.proj == "mlp":
                pooled = linear(proj["fc2"], gelu(linear(proj["fc1"], pooled)))
            else:
                pooled = linear(proj, pooled)
        return l2_normalize(pooled) if normalize else pooled


# -- weight mapping (timm convnext under open_clip's visual.trunk) -------------



def map_convnext_visual(sd: Mapping[str, np.ndarray]) -> dict:
    """A timm convnext state dict (``visual.trunk.*``) → the ConvNeXt tree
    (numpy), with ``head_norm`` (timm's ``head.norm``, after the pool) or
    ``pre_norm`` (``norm_pre``, head_norm_first checkpoints) and open_clip's
    ``head.proj`` or mlp projection (``mlp_head_keys``)."""
    sd = {k: np.asarray(v) for k, v in strip_prefix(
        dict(sd), "model.", "visual.", "trunk.").items()}
    params: dict = {
        "stem_conv": _conv_hwio(sd, "stem.0"),
        "stem_norm": _ln(sd, "stem.1"),
        "stages": [],
    }
    stage_ids = sorted({int(m.group(1)) for k in sd if (m := re.match(r"stages\.(\d+)\.", k))})
    for si in stage_ids:
        sp = f"stages.{si}"
        stage: dict = {}
        if f"{sp}.downsample.0.weight" in sd:
            stage["downsample_norm"] = _ln(sd, f"{sp}.downsample.0")
            stage["downsample_conv"] = _conv_hwio(sd, f"{sp}.downsample.1")
        block_ids = sorted({int(m.group(1)) for k in sd
                            if (m := re.match(rf"stages\.{si}\.blocks\.(\d+)\.", k))})
        blocks = []
        for bi in block_ids:
            bp = f"{sp}.blocks.{bi}"
            block = {"dw": _conv_hwio(sd, f"{bp}.conv_dw"),
                     "norm": _ln(sd, f"{bp}.norm"),
                     "fc1": _linear(sd, f"{bp}.mlp.fc1"),
                     "fc2": _linear(sd, f"{bp}.mlp.fc2")}
            if f"{bp}.gamma" in sd:
                block["gamma"] = np.asarray(sd[f"{bp}.gamma"]).reshape(-1)
            blocks.append(block)
        stage["blocks"] = _stack_blocks(blocks)
        params["stages"].append(stage)
    if "head.norm.weight" in sd:
        params["head_norm"] = _ln(sd, "head.norm")
    else:
        params["pre_norm"] = _ln(sd, "norm_pre")
    if "head.proj.weight" in sd:
        params["proj"] = _linear(sd, "head.proj")
    elif (mlp := mlp_head_keys(sd)) is not None:
        params["proj"] = {"fc1": _linear(sd, mlp[0]), "fc2": _linear(sd, mlp[1])}
    return params

"""CLIP's ModifiedResNet vision tower (RN50/RN101/RN50x4-class models).

Counterpart of ``clip_embedder_tpu.models.resnet``, inference form on NHWC
activations: the 3-conv stem with a 2×2 average-pool downsample; Bottleneck
blocks whose stride lives in an average pool after the 3×3 conv (and before
the downsample branch's 1×1 conv), not in a strided conv; BatchNorms as
folded per-channel affines after their convs (``weights.fold_bn_affine``);
then AttentionPool2d: the mean token plus the positional embedding, one query
cross-attending over all tokens through the plain ``attention_core``, then
the output projection.

No subtree quantizes (no MLP block and no ``attn`` subtree), so
``quantize="int8"`` and ``"int8_all"`` raise ``ConfigError``, as in the JAX
package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..errors import WeightError
from ..ops.attention import _split_heads, attention_core
from ..ops.layers import conv2d, linear, nhwc
from ..ops.normalize import l2_normalize
from ..weights import (ParamTree, _conv_hwio, _linear, conv_layout, conv_tree, fold_bn_affine,
                       strip_prefix)
from .vit import _init_linear, _normal

EXPANSION = 4


@dataclass(frozen=True)
class ResNetCfg:
    """Resolved ModifiedResNet architecture (the JAX package's fields)."""

    image_size: int
    embed_dim: int
    layers: tuple[int, int, int, int]
    width: int = 64
    heads: int = 32          # attnpool heads = width * 32 // 64
    ln_unused: float = 0.0   # the JAX package's field (read nowhere there either)

    @property
    def pool_tokens(self) -> int:
        return (self.image_size // 32) ** 2 + 1


def _conv_w(g, k, cin, cout, device, dtype):
    return _normal((k, k, cin, cout), (k * k * cin) ** -0.5, g, device, dtype)


def _affine(c, device, dtype):
    return {"scale": torch.ones((c,), device=device, dtype=dtype),
            "bias": torch.zeros((c,), device=device, dtype=dtype)}


def init(cfg: ResNetCfg, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout (bias-free HWIO
    convs, a list of blocks per stage). ``device="meta"`` gives the shapes
    alone."""
    g, dev, dt = generator, device, dtype
    w = cfg.width
    params = {
        "conv1": _conv_w(g, 3, 3, w // 2, dev, dt), "bn1": _affine(w // 2, dev, dt),
        "conv2": _conv_w(g, 3, w // 2, w // 2, dev, dt), "bn2": _affine(w // 2, dev, dt),
        "conv3": _conv_w(g, 3, w // 2, w, dev, dt), "bn3": _affine(w, dev, dt),
        "stages": [],
    }
    cin = w
    for stage_idx, depth in enumerate(cfg.layers):
        planes = w * (2 ** stage_idx)
        cout = planes * EXPANSION
        stage = []
        for block_idx in range(depth):
            block = {
                "conv1": _conv_w(g, 1, cin, planes, dev, dt), "bn1": _affine(planes, dev, dt),
                "conv2": _conv_w(g, 3, planes, planes, dev, dt), "bn2": _affine(planes, dev, dt),
                "conv3": _conv_w(g, 1, planes, cout, dev, dt), "bn3": _affine(cout, dev, dt),
            }
            if block_idx == 0 and cin != cout:
                block["downsample"] = {"conv": _conv_w(g, 1, cin, cout, dev, dt),
                                       "bn": _affine(cout, dev, dt)}
            stage.append(block)
            cin = cout
        params["stages"].append(stage)
    params["attnpool"] = {
        "pos_embed": _normal((cfg.pool_tokens, cin), cin ** -0.5, g, dev, dt),
        **{n: _init_linear(g, cin, cin, device=dev, dtype=dt) for n in ("q", "k", "v")},
        "out": _init_linear(g, cin, cfg.embed_dim, device=dev, dtype=dt),
    }
    return params


def _conv(w: torch.Tensor, x: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    return conv2d(x, w, stride=stride, padding=(w.shape[-1] - 1) // 2)


def _bn(p, x: torch.Tensor) -> torch.Tensor:
    return x * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
    return F.avg_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def _bottleneck(p, x: torch.Tensor, *, stride: int) -> torch.Tensor:
    out = torch.relu(_bn(p["bn1"], _conv(p["conv1"], x)))
    out = torch.relu(_bn(p["bn2"], _conv(p["conv2"], out)))
    if stride > 1:
        out = _avgpool(out, stride)
    out = _bn(p["bn3"], _conv(p["conv3"], out))
    identity = x
    if "downsample" in p:
        if stride > 1:
            identity = _avgpool(identity, stride)
        identity = _bn(p["downsample"]["bn"], _conv(p["downsample"]["conv"], identity))
    return torch.relu(out + identity)


class ResNet(ParamTree):
    """The ModifiedResNet tower over a parameter tree from ``init`` or
    ``weights.load_pytree``."""

    def __init__(self, cfg: ResNetCfg, params: Mapping):
        super().__init__(conv_layout({k: v for k, v in params.items() if k != "stages"}))
        self.cfg = cfg
        self.stages = nn.ModuleList(nn.ModuleList(conv_tree(b) for b in stage)
                                    for stage in params["stages"])

    def forward(self, pixels: torch.Tensor, *, attn_impl: str = "eager",
                channels_first: bool = False, normalize: bool = True) -> torch.Tensor:
        """[B, H, W, 3] preprocessed pixels ([B, 3, H, W] with
        ``channels_first``) → [B, embed_dim]. The attention here is plain
        torch whatever ``attn_impl`` says: ``vision.resolve_attn_impl``
        refuses the kernel impls for this family."""
        x = nhwc(pixels, channels_first)
        x = torch.relu(_bn(self["bn1"], _conv(self["conv1"], x, stride=2)))
        x = torch.relu(_bn(self["bn2"], _conv(self["conv2"], x)))
        x = torch.relu(_bn(self["bn3"], _conv(self["conv3"], x)))
        x = _avgpool(x, 2)
        for stage_idx, stage in enumerate(self.stages):
            for block_idx, block in enumerate(stage):
                stride = 2 if stage_idx > 0 and block_idx == 0 else 1
                x = _bottleneck(block, x, stride=stride)

        # AttentionPool2d: the mean token queries the spatial tokens
        p = self["attnpool"]
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        mean_tok = tokens.float().mean(dim=1, keepdim=True).to(tokens.dtype)
        tokens = torch.cat([mean_tok, tokens], dim=1) + p["pos_embed"].to(tokens.dtype)
        heads = self.cfg.heads
        q = _split_heads(linear(p["q"], tokens[:, :1]), heads)
        k, v = (_split_heads(linear(p[n], tokens), heads) for n in ("k", "v"))
        out = attention_core(q, k, v)
        pooled = linear(p["out"], out.transpose(1, 2).reshape(b, 1, c)[:, 0])
        return l2_normalize(pooled) if normalize else pooled


# -- weight mapping (open_clip ModifiedResNet naming) --------------------------

def _fold_bn(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    scale, bias = fold_bn_affine(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"],
                                 sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"])
    return {"scale": scale.astype(np.float32), "bias": bias.astype(np.float32)}




def map_resnet_visual(sd: Mapping[str, np.ndarray]) -> dict:
    """An open_clip ModifiedResNet state dict (``visual.*``) → the ResNet
    tree (numpy), every BatchNorm folded into a per-channel affine."""
    sd = {k: np.asarray(v) for k, v in strip_prefix(dict(sd), "model.", "visual.").items()}
    if "conv1.weight" not in sd:
        raise WeightError("Not a ModifiedResNet checkpoint (no conv1.weight)")
    params: dict = {
        "conv1": _conv_hwio(sd, "conv1")["w"], "bn1": _fold_bn(sd, "bn1"),
        "conv2": _conv_hwio(sd, "conv2")["w"], "bn2": _fold_bn(sd, "bn2"),
        "conv3": _conv_hwio(sd, "conv3")["w"], "bn3": _fold_bn(sd, "bn3"),
        "stages": [],
    }
    for stage_idx in range(1, 5):
        depth = 1 + max((int(m.group(1)) for k in sd
                         if (m := re.match(rf"layer{stage_idx}\.(\d+)\.conv1\.weight", k))),
                        default=-1)
        if depth == 0:
            raise WeightError(f"layer{stage_idx} missing from checkpoint")
        stage = []
        for i in range(depth):
            p = f"layer{stage_idx}.{i}"
            block = {
                "conv1": _conv_hwio(sd, f"{p}.conv1")["w"], "bn1": _fold_bn(sd, f"{p}.bn1"),
                "conv2": _conv_hwio(sd, f"{p}.conv2")["w"], "bn2": _fold_bn(sd, f"{p}.bn2"),
                "conv3": _conv_hwio(sd, f"{p}.conv3")["w"], "bn3": _fold_bn(sd, f"{p}.bn3"),
            }
            # open_clip downsample: Sequential(avgpool, conv(-1), bn(0/1))
            for conv_key, bn_key in ((f"{p}.downsample.0", f"{p}.downsample.1"),
                                     (f"{p}.downsample.1", f"{p}.downsample.2")):
                if f"{conv_key}.weight" in sd:
                    block["downsample"] = {"conv": _conv_hwio(sd, conv_key)["w"],
                                           "bn": _fold_bn(sd, bn_key)}
                    break
            stage.append(block)
        params["stages"].append(stage)
    params["attnpool"] = {
        "pos_embed": np.asarray(sd["attnpool.positional_embedding"]),
        "q": _linear(sd, "attnpool.q_proj"),
        "k": _linear(sd, "attnpool.k_proj"),
        "v": _linear(sd, "attnpool.v_proj"),
        "out": _linear(sd, "attnpool.c_proj"),
    }
    return params

# Frozen copy of compute_axial_cis, apply_rotary_cis, PEAttention, LayerScale, PEBlock,
# PEAttentionPooling and PECoreViT.forward from tests/torch_ref.py at commit
# 4365e722da82de69a44f96d71d1126ef91d02509 (initialisers dropped: every weight is
# loaded from the benchmark's tree; the real-arithmetic rope route, which only the
# ONNX export took, left out).
"""The plain f32 reference of a PE-Core vision tower (Meta perception_models:
class token, ln_pre, 2-D axial rope in complex arithmetic on q and k, the
MAP pool with its own heads, a bias-free projection), as stages that
``hbench.reference.run`` applies layer by layer."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .siglip_vit import conv_weight
from .tree import f32, linear_sd, ln_sd, loaded, qkv_sd


def compute_axial_cis(dim, end_x, end_y, theta=10000.0):
    """SAM2/PE ``compute_axial_cis``: [end_x*end_y, dim/2] complex rotations,
    x-axis bands first, raw integer grid coordinates."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 4)[: dim // 4].float() / dim))
    t = torch.arange(end_x * end_y, dtype=torch.float32)
    t_x = t % end_x
    t_y = torch.div(t, end_x, rounding_mode="floor")
    freqs_x = torch.outer(t_x, freqs)
    freqs_y = torch.outer(t_y, freqs)
    cis_x = torch.polar(torch.ones_like(freqs_x), freqs_x)
    cis_y = torch.polar(torch.ones_like(freqs_y), freqs_y)
    return torch.cat([cis_x, cis_y], dim=-1)


def apply_rotary_cis(x, freqs_cis):
    """x: [B, H, S, D]; freqs_cis: [S, D/2] complex. Adjacent-lane pairs
    as complex numbers, rotated by complex multiply."""
    x_ = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2))
    out = torch.view_as_real(x_ * freqs_cis).flatten(-2)
    return out.type_as(x)


class PEAttention(nn.Module):
    """Packed-qkv self-attention with rope on q/k (Meta SelfAttention
    naming: in_proj_weight / in_proj_bias / out_proj)."""

    def __init__(self, width, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, rope):
        b, s, w = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.chunk(3, dim=-1)
        d = w // self.heads
        q = q.view(b, s, self.heads, d).transpose(1, 2)
        k = k.view(b, s, self.heads, d).transpose(1, 2)
        v = v.view(b, s, self.heads, d).transpose(1, 2)
        q = apply_rotary_cis(q, rope)
        k = apply_rotary_cis(k, rope)
        out = F.scaled_dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, s, w)
        return self.out_proj(out)


class LayerScale(nn.Module):
    def __init__(self, width):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(width))

    def forward(self, x):
        return x * self.gamma


class PEBlock(nn.Module):
    def __init__(self, width, heads, mlp_hidden, layer_scale=False):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = PEAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, mlp_hidden))
        self.mlp.add_module("gelu", nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(mlp_hidden, width))
        if layer_scale:
            self.ls_1 = LayerScale(width)
            self.ls_2 = LayerScale(width)
        else:
            self.ls_1 = nn.Identity()
            self.ls_2 = nn.Identity()

    def forward(self, x, rope):
        x = x + self.ls_1(self.attn(self.ln_1(x), rope))
        x = x + self.ls_2(self.mlp(self.ln_2(x)))
        return x


class PEAttentionPooling(nn.Module):
    """big_vision MAP head as used by PE: learned probe, MHA, LN+MLP
    residual (Meta naming: probe / attn / layernorm / mlp.c_fc|c_proj)."""

    def __init__(self, width, heads, mlp_hidden):
        super().__init__()
        self.probe = nn.Parameter(torch.empty(1, 1, width))
        self.attn = nn.MultiheadAttention(width, heads, batch_first=True)
        self.layernorm = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, mlp_hidden))
        self.mlp.add_module("gelu", nn.GELU())
        self.mlp.add_module("c_proj", nn.Linear(mlp_hidden, width))

    def forward(self, x):
        probe = self.probe.expand(x.shape[0], -1, -1)
        y, _ = self.attn(probe, x, x, need_weights=False)
        y = y + self.mlp(self.layernorm(y))
        return y[:, 0]


def stages(v: dict, tree: dict, device):
    """PECoreViT.forward as a sequence of functions of the activations:
    conv1, class token, position and ln_pre; each block with the rope of
    its head dim (the class token's row the identity); ln_post, the pool,
    the projection and the L2 normalisation."""
    w, p, grid = v["width"], v["patch_size"], v["image_size"] // v["patch_size"]
    cis = compute_axial_cis(w // v["heads"], grid, grid)
    rope = torch.cat([torch.ones(1, cis.shape[-1], dtype=cis.dtype), cis]).to(device)

    def embed():
        conv = loaded(lambda: nn.Conv2d(3, w, p, p, bias=False),
                      {"weight": conv_weight(tree["patch_embed"]["w"], p)}, device)
        ln_pre = loaded(lambda: nn.LayerNorm(w), ln_sd(tree["ln_pre"], ""), device)
        cls = f32(tree["cls_token"], device).reshape(w)
        pos = f32(tree["pos_embed"], device).reshape(-1, w)

        def run(x):
            x = conv(x)
            x = x.reshape(x.shape[0], x.shape[1], -1).permute(0, 2, 1)
            x = torch.cat([cls.expand(x.shape[0], 1, -1), x], dim=1)
            return ln_pre(x + pos)
        return run

    yield embed
    for i in range(v["layers"]):
        def block(i=i):
            b = tree["blocks"]
            sd = {**ln_sd(b["ln1"], "ln_1", i), **ln_sd(b["ln2"], "ln_2", i),
                  **qkv_sd(b["attn"], "attn", i, names=("in_proj_weight", "in_proj_bias")),
                  **linear_sd(b["attn"]["out"], "attn.out_proj", i),
                  **linear_sd(b["mlp"]["fc"], "mlp.c_fc", i),
                  **linear_sd(b["mlp"]["proj"], "mlp.c_proj", i)}
            blk = loaded(lambda: PEBlock(w, v["heads"], v["mlp_hidden"]), sd, device)
            return lambda x: blk(x, rope)
        yield block

    def head():
        ln_post = loaded(lambda: nn.LayerNorm(w), ln_sd(tree["ln_post"], ""), device)
        ap = tree["attn_pool"]
        sd = {"probe": ap["probe"],
              **qkv_sd(ap["attn"], "attn", names=("in_proj_weight", "in_proj_bias")),
              **linear_sd(ap["attn"]["out"], "attn.out_proj"), **ln_sd(ap["ln"], "layernorm"),
              **linear_sd(ap["mlp"]["fc"], "mlp.c_fc"), **linear_sd(ap["mlp"]["proj"], "mlp.c_proj")}
        pool = loaded(lambda: PEAttentionPooling(w, v["pool_heads"], v["pool_mlp_hidden"]),
                      sd, device)
        proj = f32(tree["proj"]["w"], device)
        return lambda x: F.normalize(pool(ln_post(x)) @ proj, dim=-1)

    yield head

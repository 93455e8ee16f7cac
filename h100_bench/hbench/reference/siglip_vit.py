# Frozen copy of TimmAttention, TimmMlp, TimmBlock, AttentionPoolLatent, PatchEmbed
# and TimmSiglipViT.forward from tests/torch_ref.py at commit
# 4365e722da82de69a44f96d71d1126ef91d02509 (initialisers dropped: every weight is
# loaded from the benchmark's tree).
"""The plain f32 reference of a timm SigLIP vision tower (no class token,
tanh-gelu blocks, the MAP attention pool, no head), as stages that
``hbench.reference.run`` applies layer by layer."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .tree import f32, linear_sd, ln_sd, loaded, qkv_sd


class TimmAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, D = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, D // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        x = F.scaled_dot_product_attention(q, k, v)
        x = x.transpose(1, 2).reshape(B, N, D)
        return self.proj(x)


class TimmMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU(approximate="tanh")
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class TimmBlock(nn.Module):
    def __init__(self, dim, heads, mlp_hidden, ln_eps=1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = TimmAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = TimmMlp(dim, mlp_hidden)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        x = x + self.mlp(self.norm2(x))
        return x


class AttentionPoolLatent(nn.Module):
    """timm's MAP head as used by SigLIP towers."""

    def __init__(self, dim, heads, mlp_hidden, ln_eps=1e-6):
        super().__init__()
        self.heads = heads
        self.latent = nn.Parameter(torch.empty(1, 1, dim))
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, dim * 2)
        self.proj = nn.Linear(dim, dim)
        self.norm = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = TimmMlp(dim, mlp_hidden)

    def forward(self, x):
        B, N, D = x.shape
        q = self.q(self.latent.expand(B, -1, -1))
        q = q.reshape(B, 1, self.heads, D // self.heads).transpose(1, 2)
        kv = self.kv(x).reshape(B, N, 2, self.heads, D // self.heads)
        k, v = kv.permute(2, 0, 3, 1, 4).unbind(0)
        out = F.scaled_dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(B, 1, D)
        out = self.proj(out)
        out = out + self.mlp(self.norm(out))
        return out[:, 0]


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, width):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch_size, patch_size)

    def forward(self, x):
        x = self.proj(x)
        return x.flatten(2).transpose(1, 2)


def stages(v: dict, tree: dict, device):
    """TimmSiglipViT.forward as a sequence of functions of the activations:
    patch embedding + position, each block, the final norm, the pool and the
    L2 normalisation. Each stage's module is built when it is reached."""
    w, p, eps = v["width"], v["patch_size"], v["ln_eps"]

    def embed():
        pe = loaded(lambda: PatchEmbed(p, w), {
            "proj.weight": conv_weight(tree["patch_embed"]["w"], p),
            "proj.bias": tree["patch_embed"]["b"]}, device)
        pos = f32(tree["pos_embed"], device)
        return lambda x: pe(x) + pos

    yield embed
    for i in range(v["layers"]):
        def block(i=i):
            b = tree["blocks"]
            sd = {**ln_sd(b["ln1"], "norm1", i), **ln_sd(b["ln2"], "norm2", i),
                  **qkv_sd(b["attn"], "attn.qkv", i), **linear_sd(b["attn"]["out"], "attn.proj", i),
                  **linear_sd(b["mlp"]["fc"], "mlp.fc1", i),
                  **linear_sd(b["mlp"]["proj"], "mlp.fc2", i)}
            return loaded(lambda: TimmBlock(w, v["heads"], v["mlp_hidden"], eps), sd, device)
        yield block

    def head():
        norm = loaded(lambda: nn.LayerNorm(w, eps=eps), ln_sd(tree["ln_post"], ""), device)
        ap = tree["attn_pool"]
        sd = {"latent": ap["probe"], **linear_sd(ap["attn"]["q"], "q"),
              **qkv_sd(ap["attn"], "kv", parts=("k", "v")),
              **linear_sd(ap["attn"]["out"], "proj"), **ln_sd(ap["ln"], "norm"),
              **linear_sd(ap["mlp"]["fc"], "mlp.fc1"), **linear_sd(ap["mlp"]["proj"], "mlp.fc2")}
        pool = loaded(lambda: AttentionPoolLatent(w, v["pool_heads"], v["pool_mlp_hidden"], eps),
                      sd, device)
        return lambda x: F.normalize(pool(norm(x)), dim=-1)

    yield head


def conv_weight(w: torch.Tensor, p: int) -> torch.Tensor:
    """A patch embedding stored as [P·P·3, W] rows in (py, px, c) order, as
    the [W, 3, P, P] weight of a Conv2d."""
    return w.reshape(p, p, 3, -1).permute(3, 2, 0, 1)

"""Multi-head attention.

Counterpart of ``clip_embedder_tpu.ops.attention``. ``impl`` selects:

* ``"eager"`` — plain PyTorch (``attention_core``: f32 logits and softmax);
* ``"kernel"`` — self-attention with a ``pre_ln`` runs the fused LayerNorm +
  q/k/v kernel (``ops.qkv``: ``ln_qkv_int8`` for int8 projections on the
  card, else ``ln_qkv``), then the attention kernels of ``ops.flash``, exact
  softmax, routed as the JAX package's ``pallas`` routes them: the packed
  kernel (which also applies rope) where the heads form a 128-lane group
  (``head_group``) and rope does not come with a mask; otherwise rope
  applied outside (``ops.rope.apply_rope``), the heads split and
  ``flash_attention``;
* ``"kernel_fast"`` — the same kernels with the clamped softmax, plus, on
  the packed kernel only, the bf16 exp when the head dim is below 96 (as
  the JAX package's ``pallas_fast``).

On the kernel impls the block's other LayerNorm and its MLP's activation
take ``ops.rows``' single-pass kernels too (``ops.layers.norm``,
``ops.layers.activate``, routed from ``ops.layers.mlp``).

Cross-attention (``kv=``, e.g. the map-pool probe) ends on
``attention_core`` on every impl, as in the JAX package. On every impl a
quantized out-projection with a residual takes the fused int8 linear with
the residual in its epilogue (``ops.int8_mlp.int8_linear_fused``) for 128
rows or more on the card.
"""

from __future__ import annotations

import torch

from .flash import flash_attention, flash_attention_packed, head_group
from .int8_mlp import fits_fused_linear, int8_linear_fused
from .layers import KERNEL_IMPLS, layer_norm, linear, promote
from .qkv import fits_fused_qkv, fits_fused_qkv_int8, ln_qkv, ln_qkv_int8
from .rope import apply_rope

ATTN_IMPLS = ("eager",) + KERNEL_IMPLS


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Scaled dot-product attention over [B, H, S, D] tensors. ``mask`` is
    an additive bias broadcastable to [B, H, Sq, Sk] (-inf disallows).
    Logits and softmax run in ≥f32; p·v accumulates in ≥f32."""
    ct = promote(q.dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.matmul(q.to(ct), k.to(ct).transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.to(ct)
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype).to(ct), v.to(ct))
    return out.to(v.dtype)


def _split_heads(t: torch.Tensor, h: int) -> torch.Tensor:
    b, s, hd = t.shape
    return t.reshape(b, s, h, hd // h).transpose(1, 2)


def multi_head_attention(
    params,
    x: torch.Tensor,
    *,
    num_heads: int,
    mask: torch.Tensor | None = None,
    kv: torch.Tensor | None = None,
    impl: str = "eager",
    pre_ln=None,
    ln_eps: float = 1e-6,
    residual: torch.Tensor | None = None,
    rope=None,
) -> torch.Tensor:
    """[LayerNorm →] project → attend → merge → out-project [→ + residual].

    ``params``: {"q","k","v","out"} linears ({"w": [d, d'], "b"}). ``kv``
    enables cross-attention. ``pre_ln`` applies the pre-attention LayerNorm
    inside this call, so the kernel impls fuse it with the projections.
    ``residual`` returns ``residual + out_proj(attention)``. ``rope``:
    (sin, cos) head-tiled [S, H·D] f32 tables from ``ops.rope`` that rotate
    q and k after the projections.
    """
    if impl not in ATTN_IMPLS:
        raise ValueError(f"Unknown attention impl '{impl}' (choices: "
                         f"{', '.join(ATTN_IMPLS)})")
    kernel = impl in KERNEL_IMPLS
    fuse_qkv = pre_ln is not None and kv is None and kernel
    if fuse_qkv and fits_fused_qkv_int8(params, x):  # int8_all towers
        q, k, v = ln_qkv_int8(params, pre_ln, x, eps=ln_eps)
    elif fuse_qkv and fits_fused_qkv(params, x):
        q, k, v = ln_qkv(params, pre_ln, x, eps=ln_eps)
    else:
        if pre_ln is not None:
            x = layer_norm(pre_ln, x, eps=ln_eps)
        src = x if kv is None else kv
        q = linear(params["q"], x)
        k = linear(params["k"], src)
        v = linear(params["v"], src)

    d = q.shape[-1] // num_heads
    if (kernel and q.shape == k.shape and head_group(num_heads, d) is not None
            and (rope is None or mask is None)):
        out = flash_attention_packed(
            q, k, v, num_heads=num_heads, mask=mask, rope=rope,
            fast_softmax=impl == "kernel_fast",
            exp_bf16=impl == "kernel_fast" and d < 96)
    else:
        if rope is not None:
            q, k = (apply_rope(t, *rope) for t in (q, k))
        q, k, v = (_split_heads(t, num_heads) for t in (q, k, v))
        if kernel:
            out = flash_attention(q, k, v, mask=mask, fast_softmax=impl == "kernel_fast")
        else:
            out = attention_core(q, k, v, mask=mask)
        b, h, s, d = out.shape
        out = out.transpose(1, 2).reshape(b, s, h * d)
    outp = params["out"]
    if (residual is not None and "w_q" in outp and out.numel() // out.shape[-1] >= 128
            and fits_fused_linear(outp, out)):
        return int8_linear_fused(outp, out, residual=residual)
    h = linear(outp, out)
    return h if residual is None else residual + h


def causal_mask(seq_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, S, S] (-inf above the diagonal)."""
    full = torch.full((seq_len, seq_len), float("-inf"), dtype=dtype, device=device)
    return torch.triu(full, diagonal=1)[None, None]

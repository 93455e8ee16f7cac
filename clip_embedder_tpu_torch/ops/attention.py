"""Multi-head attention.

Counterpart of ``clip_embedder_tpu.ops.attention``. ``impl`` selects:

* ``"eager"`` — plain PyTorch (``attention_core``: f32 logits and softmax);
* ``"kernel"`` — self-attention with a ``pre_ln`` runs the fused LayerNorm +
  q/k/v kernel (``ops.qkv``: ``ln_qkv_int8`` for int8 projections on the
  card, else ``ln_qkv``) and then the packed-head attention kernel
  (``ops.flash``), exact softmax;
* ``"kernel_fast"`` — the same kernels with the clamped softmax, plus the
  bf16 exp when the head dim is below 96 (as the JAX package's
  ``pallas_fast``).

Cross-attention (``kv=``, e.g. the map-pool probe) stays on
``attention_core`` on every impl, as in the JAX package. On every impl a
quantized out-projection with a residual takes the fused int8 linear with
the residual in its epilogue (``ops.int8_mlp.int8_linear_fused``) for 128
rows or more on the card.
"""

from __future__ import annotations

import torch

from .flash import fits_packed, flash_attention_packed
from .int8_mlp import fits_fused_linear, int8_linear_fused
from .layers import layer_norm, linear, promote
from .qkv import fits_fused_qkv, fits_fused_qkv_int8, ln_qkv, ln_qkv_int8

KERNEL_IMPLS = ("kernel", "kernel_fast")
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
    ``residual`` returns ``residual + out_proj(attention)``.
    """
    if rope is not None:
        raise NotImplementedError("rope (ops/rope.py) is not yet ported")
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

    if kernel and fits_packed(q, k, v, num_heads):
        d = q.shape[-1] // num_heads
        out = flash_attention_packed(
            q, k, v, num_heads=num_heads, mask=mask,
            fast_softmax=impl == "kernel_fast",
            exp_bf16=impl == "kernel_fast" and d < 96)
    else:
        out = attention_core(*(_split_heads(t, num_heads) for t in (q, k, v)),
                             mask=mask)
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

"""Packed-head self-attention (``csrc/flash_packed.cu``).

Counterpart of ``clip_embedder_tpu.ops.flash.flash_attention_packed``:
per head, softmax(q·scale·kᵀ + mask)·v on q/k/v in the [B, S, H·D]
projection layout, output in the same layout, with

* the scale folded into q and rounded to the input dtype;
* f32 logits, row max and denominator;
* ``fast_softmax``: exp(clamp(logits, ±60)) in place of the max pass;
* ``exp_bf16``: the exp's argument and result rounded to bf16;
* the denominator summing p as rounded to v's dtype when D is not a
  multiple of 128 (the TPU kernel's default ``mxu_denom``, which takes the
  row sums from the p·v matmul), and p itself otherwise.

Masks: None or one additive mask shared by every batch row and head
([S, S], [1, 1, S, S] or [1, 1, 1, S]). Per-batch masks ([B,1,1,S],
[B,1,S,S]) and in-kernel rope are not yet ported and raise.

``flash_attention_packed`` launches the CUDA kernel for tensors on the card
and runs ``flash_attention_packed_plain`` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda

MAX_HEAD_DIM = 128


def fits_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_heads: int) -> bool:
    """The kernel takes these operands: self-attention shapes, f32 or
    bf16, head dim at most 128."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in cuda.DTYPE_CODES:
        return False
    hd = q.shape[-1]
    return hd % num_heads == 0 and hd // num_heads <= MAX_HEAD_DIM


def shared_mask(mask: torch.Tensor | None, batch: int, seq: int) -> torch.Tensor | None:
    """The [S, S] f32 form of a mask shared by every batch row and head;
    raise for the per-batch forms, which the kernel does not take yet."""
    if mask is None:
        return None
    m = mask
    if m.dim() == 2 and tuple(m.shape) == (seq, seq):
        return m.to(torch.float32).contiguous()
    if (m.dim() == 4 and m.shape[0] == 1 and m.shape[1] == 1
            and m.shape[2] in (1, seq) and m.shape[3] == seq):
        return m.to(torch.float32).expand(1, 1, seq, seq)[0, 0].contiguous()
    if m.dim() == 4 and m.shape[0] == batch and m.shape[1] == 1:
        raise ValueError(
            f"per-batch mask {tuple(m.shape)} is not yet ported to the packed "
            "attention kernel")
    raise ValueError(f"unsupported mask shape {tuple(m.shape)}")


def _check(q, k, v, num_heads, rope):
    if rope is not None:
        raise NotImplementedError("in-kernel rope is not yet ported")
    if not fits_packed(q, k, v, num_heads):
        raise ValueError(
            f"packed attention takes q/k/v of one [B, S, H·D] shape and dtype "
            f"(f32/bf16, D ≤ {MAX_HEAD_DIM}); got {tuple(q.shape)}/"
            f"{tuple(k.shape)}/{tuple(v.shape)} {q.dtype}, {num_heads} heads")


def flash_attention_packed_plain(q, k, v, *, num_heads: int, mask=None, rope=None,
                                 fast_softmax: bool = False,
                                 exp_bf16: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (its CPU path and the
    reference it is held to on the card)."""
    _check(q, k, v, num_heads, rope)
    b, s, hd = q.shape
    d = hd // num_heads
    m2 = shared_mask(mask, b, s)

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2)

    qs = (heads(q).float() * (1.0 / d ** 0.5)).to(q.dtype)
    logits = torch.matmul(qs.float(), heads(k).float().transpose(-1, -2))
    if m2 is not None:
        logits = logits + m2
    if fast_softmax:
        arg = logits.clamp(-60.0, 60.0)
    else:
        m = logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
        arg = logits - m
    p = torch.exp(arg.to(torch.bfloat16)) if exp_bf16 else torch.exp(arg)
    pv = p.to(v.dtype)
    denom = (pv if d % 128 else p).float().sum(dim=-1, keepdim=True)
    out = torch.matmul(pv.float(), heads(v).float()) * (1.0 / denom)
    return out.to(q.dtype).transpose(1, 2).reshape(b, s, hd)


def flash_attention_packed(q, k, v, *, num_heads: int, mask=None, rope=None,
                           fast_softmax: bool = False,
                           exp_bf16: bool = False) -> torch.Tensor:
    """Fused attention on the [B, S, H·D] projection layout. CUDA tensors
    launch the kernel (raising on anything it does not take); CPU tensors
    run ``flash_attention_packed_plain``."""
    if q.device.type == "cpu":
        return flash_attention_packed_plain(
            q, k, v, num_heads=num_heads, mask=mask, rope=rope,
            fast_softmax=fast_softmax, exp_bf16=exp_bf16)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: unsupported device {q.device}")
    _check(q, k, v, num_heads, rope)
    b, s, hd = q.shape
    d = hd // num_heads
    m2 = shared_mask(mask, b, s)
    for t in (q, k, v) + ((m2,) if m2 is not None else ()):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention_packed: operands must be "
                             f"contiguous on {q.device}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = cuda.library("flash_packed").flash_packed_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float] \
        + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    code = fn(cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(m2), cuda.ptr(out),
              b, s, num_heads, d, float(1.0 / d ** 0.5), int(fast_softmax),
              int(exp_bf16), int(d % 128 != 0), cuda.DTYPE_CODES[q.dtype],
              cuda.stream_ptr(q))
    cuda.check(code, "flash_attention_packed")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0  # kernel launches, for showing a run went through it

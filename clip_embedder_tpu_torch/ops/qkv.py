"""Fused pre-attention LayerNorm + q/k/v projections (``csrc/ln_qkv.cu``).

Counterpart of ``clip_embedder_tpu.ops.qkv.ln_qkv``:

    x → f32 LayerNorm → one rounding to x's dtype → (x̂Wq+bq, x̂Wk+bk, x̂Wv+bv)

with f32 accumulation and f32 biases, each output rounded once to x's
dtype. For a tensor on the card ``ln_qkv`` launches the CUDA kernel (a
LayerNorm pass that writes x̂ once, then the tiled product); for a tensor on
the CPU it runs ``ln_qkv_plain``, the same function in plain PyTorch. Used
by ``ops.attention.multi_head_attention`` on the kernel impls when
``fits_fused_qkv`` holds.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda
from .layers import layer_norm, promote


def tile_config(width: int, dtype: torch.dtype) -> tuple[int, int] | None:
    """(rows, columns) of the kernel's block tile for this width (the tiles
    ln_qkv.cu instantiates), or None when the kernel does not take it:
    f32 or bf16, and a width that is a multiple of 64."""
    if width % 64 or dtype not in cuda.DTYPE_CODES:
        return None
    if dtype == torch.bfloat16 and width % 128 == 0:
        return 256, 128
    return 64, 64


def fits_fused_qkv(params, x: torch.Tensor) -> bool:
    """The kernel takes these projections: unquantized square [W, W]
    weights in x's dtype (f32 or bf16), and a width ``tile_config`` takes."""
    width = x.shape[-1]
    for name in ("q", "k", "v"):
        p = params.get(name)
        if p is None or "w_q" in p or "w" not in p:
            return False
        w = p["w"]
        if w.dim() != 2 or tuple(w.shape) != (width, width) or w.dtype != x.dtype:
            return False
    return tile_config(width, x.dtype) is not None


def ln_qkv_plain(params, pre_ln, x: torch.Tensor, *, eps: float = 1e-6):
    """The kernel's function in plain PyTorch (its CPU path and the
    reference it is held to on the card)."""
    y = layer_norm(pre_ln, x, eps=eps)
    ct = promote(x.dtype)
    outs = []
    for name in ("q", "k", "v"):
        p = params[name]
        o = torch.matmul(y.to(ct), p["w"].to(ct))
        b = p.get("b")
        if b is not None:
            o = o + b.to(ct)
        outs.append(o.to(x.dtype))
    return tuple(outs)


def _f32_vector(t: torch.Tensor | None, width: int, like: torch.Tensor) -> torch.Tensor:
    if t is None:
        return torch.zeros(width, dtype=torch.float32, device=like.device)
    if t.shape != (width,) or t.device != like.device:
        raise ValueError(f"ln_qkv: expected a [{width}] vector on {like.device}, "
                         f"got {tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).contiguous()


def ln_qkv(params, pre_ln, x: torch.Tensor, *, eps: float = 1e-6):
    """Fused LayerNorm + q/k/v projections.

    ``params``: {"q","k","v"} linears ({"w": [W, W], "b"?}); ``pre_ln``:
    {"scale","bias"}; ``x``: [..., W], f32 or bf16. Returns (q, k, v), each
    shaped like x. Runs the CUDA kernel for a CUDA tensor (raising on any
    input it does not take) and ``ln_qkv_plain`` for a CPU tensor.
    """
    if x.device.type == "cpu":
        return ln_qkv_plain(params, pre_ln, x, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_qkv: unsupported device {x.device}")
    width = x.shape[-1]
    cfg = tile_config(width, x.dtype)
    if cfg is None:
        raise ValueError(f"ln_qkv: the kernel does not take width {width} "
                         f"in {x.dtype}; gate callers on fits_fused_qkv")
    if not fits_fused_qkv(params, x):
        raise ValueError("ln_qkv: q/k/v weights must be square [W, W] in "
                         "x's dtype")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("ln_qkv: x must be contiguous and 16-byte aligned")
    bm, bn = cfg
    rows = x.numel() // width
    ws = []
    for name in ("q", "k", "v"):
        w = params[name]["w"]
        if w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"ln_qkv: weight {name} must be contiguous and 16-byte "
                             f"aligned on {x.device}")
        ws.append(w)
    bs = [_f32_vector(params[n].get("b"), width, x) for n in ("q", "k", "v")]
    gamma = _f32_vector(pre_ln["scale"], width, x)
    beta = _f32_vector(pre_ln["bias"], width, x)
    if gamma.data_ptr() % 16 or beta.data_ptr() % 16:
        raise ValueError("ln_qkv: the LayerNorm scale and bias must be 16-byte aligned")
    outs = [torch.empty_like(x) for _ in range(3)]
    if rows == 0:
        return tuple(outs)
    xn = torch.empty_like(x)  # the normalized rows, rounded to x's dtype
    fn = cuda.library("ln_qkv").ln_qkv_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2 + [ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    code = fn(cuda.ptr(x), cuda.ptr(xn), cuda.ptr(gamma), cuda.ptr(beta),
              *(cuda.ptr(w) for w in ws), *(cuda.ptr(b) for b in bs),
              *(cuda.ptr(o) for o in outs), rows, width, float(eps),
              cuda.DTYPE_CODES[x.dtype], bm, bn, cuda.stream_ptr(x))
    cuda.check(code, "ln_qkv")
    ln_qkv.launches += 1
    return tuple(outs)


ln_qkv.launches = 0  # kernel launches, for showing a run went through it

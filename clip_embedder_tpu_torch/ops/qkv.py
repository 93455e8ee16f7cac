"""Fused pre-attention LayerNorm + q/k/v projections (``csrc/ln_qkv.cu``,
``csrc/ln_qkv_int8.cu``).

Counterpart of ``clip_embedder_tpu.ops.qkv.ln_qkv``:

    x → f32 LayerNorm → one rounding to x's dtype → (x̂Wq+bq, x̂Wk+bk, x̂Wv+bv)

with f32 accumulation and f32 biases, each output rounded once to x's
dtype; and of ``ln_qkv_int8`` (``quantize="int8_all"``):

    x → f32 LayerNorm → one per-row int8 quantization (no rounding of x̂
      to x's dtype first) → three int8 products → acc·(xs·s) + b

For a tensor on the card the wrappers launch the CUDA kernel (a LayerNorm
pass that writes x̂, or its int8 codes, once; then the tiled product); for
a tensor on the CPU they run ``ln_qkv_plain`` / ``ln_qkv_int8_plain``, the
same functions in plain PyTorch. Used by
``ops.attention.multi_head_attention`` on the kernel impls when
``fits_fused_qkv_int8`` or ``fits_fused_qkv`` holds.
"""

from __future__ import annotations

import torch

from . import cuda
from .int8_mlp import dequant, kernel_dims_ok, layer_norm_f32, on_card, qlinear_operands, row_quant
from .layers import layer_norm, promote
from .quant import int_matmul


def tile_config(width: int, dtype: torch.dtype) -> tuple[int, int] | None:
    """(rows, columns) of the kernel's block tile for this width (the tiles
    ln_qkv.cu instantiates), or None when the kernel does not take it:
    f32 or bf16, and a width that is a multiple of 64. bf16 widths that are
    multiples of 128 take the TMA + wgmma product's 256 x 128 tile, the
    others the 64 x 64 mma.sync (bf16) or FMA (f32) one."""
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
    cuda.no_grad_operands("ln_qkv", params, pre_ln, x)
    width = x.shape[-1]
    cfg = tile_config(width, x.dtype)
    if cfg is None:
        raise ValueError(f"ln_qkv: the kernel does not take width {width} "
                         f"in {x.dtype}; gate callers on fits_fused_qkv")
    if not fits_fused_qkv(params, x):
        raise ValueError("ln_qkv: q/k/v weights must be square [W, W] in "
                         "x's dtype")
    cuda.check_input(x, "ln_qkv")
    bm, bn = cfg
    rows = x.numel() // width
    ws = []
    for name in ("q", "k", "v"):
        w = params[name]["w"]
        if w.device != x.device or not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"ln_qkv: weight {name} must be contiguous and 16-byte "
                             f"aligned on {x.device}")
        ws.append(w)
    bs = [cuda.f32_vector(params[n].get("b"), width, x, "ln_qkv") for n in ("q", "k", "v")]
    gamma = cuda.f32_vector(pre_ln["scale"], width, x, "ln_qkv")
    beta = cuda.f32_vector(pre_ln["bias"], width, x, "ln_qkv")
    outs = [torch.empty_like(x) for _ in range(3)]
    if rows == 0:
        return tuple(outs)
    xn = torch.empty_like(x)  # the normalized rows, rounded to x's dtype
    fn = cuda.kernel("ln_qkv", "ln_qkv_launch", (cuda.VOID_P,) * 13 + (cuda.INT,) * 2
                     + (cuda.FLOAT,) + (cuda.INT,) * 3 + (cuda.VOID_P,))
    cuda.launch(fn, "ln_qkv", x,
                cuda.ptr(x), cuda.ptr(xn), cuda.ptr(gamma), cuda.ptr(beta),
                *(cuda.ptr(w) for w in ws), *(cuda.ptr(b) for b in bs),
                *(cuda.ptr(o) for o in outs), rows, width, float(eps),
                cuda.DTYPE_CODES[x.dtype], bm, bn)
    cuda.count(ln_qkv)
    return tuple(outs)


ln_qkv.launches = 0  # kernel launches, for showing a run went through it


# -- int8 (quantize="int8_all") ---------------------------------------------

def fits_fused_qkv_int8(params, x: torch.Tensor) -> bool:
    """``ln_qkv_int8`` takes these projections: quantized square [W, W]
    weights, a width the kernel takes, and x on the card (on the CPU the
    layers take the unfused path, as the JAX package does there)."""
    width = x.shape[-1]
    if not on_card(x):
        return False
    for name in ("q", "k", "v"):
        p = params.get(name)
        w = p.get("w_q") if p is not None else None
        if w is None or w.dim() != 2 or tuple(w.shape) != (width, width):
            return False
    return kernel_dims_ok(width)


def ln_qkv_int8_plain(params, pre_ln, x: torch.Tensor, *, eps: float = 1e-6):
    """The int8 kernel's function in plain PyTorch: f32 LayerNorm → one
    shared per-row quantization → three exact int8 products →
    ``acc·(xs·s) + b`` → x's dtype."""
    width = x.shape[-1]
    y = layer_norm_f32(x.reshape(-1, width).to(torch.float32), pre_ln, eps)
    yq, xs = row_quant(y)
    return tuple(dequant(int_matmul(yq, params[n]["w_q"]), xs, params[n])
                 .to(x.dtype).reshape(x.shape) for n in ("q", "k", "v"))


def ln_qkv_int8(params, pre_ln, x: torch.Tensor, *, eps: float = 1e-6):
    """Fused LayerNorm + W8A8 q/k/v projections (``quantize="int8_all"``).

    ``params``: {"q","k","v"} quantized linears ({"w_q": [W, W] int8,
    "w_scale", "b"?}); ``pre_ln``: {"scale","bias"}; ``x``: [..., W], f32 or
    bf16. Returns (q, k, v), each shaped like x. Runs the CUDA kernel (a
    LayerNorm + row-quant pass that writes the int8 rows once, then one
    product over the three weights) for a CUDA tensor and
    ``ln_qkv_int8_plain`` for a CPU tensor.
    """
    if x.device.type == "cpu":
        return ln_qkv_int8_plain(params, pre_ln, x, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_qkv_int8: unsupported device {x.device}")
    cuda.no_grad_operands("ln_qkv_int8", params, pre_ln, x)
    cuda.check_input(x, "ln_qkv_int8")
    width = x.shape[-1]
    ops = [qlinear_operands(params[n], width, x, f"ln_qkv_int8 {n}") for n in ("q", "k", "v")]
    if any(w.shape[1] != width for w, _, _ in ops):
        raise ValueError("ln_qkv_int8: q/k/v weights must be square [W, W]")
    gamma = cuda.f32_vector(pre_ln["scale"], width, x, "ln_qkv_int8 pre_ln")
    beta = cuda.f32_vector(pre_ln["bias"], width, x, "ln_qkv_int8 pre_ln")
    outs = [torch.empty_like(x) for _ in range(3)]
    rows = x.numel() // width
    if rows == 0:
        return tuple(outs)
    xq = torch.empty(rows, width, dtype=torch.int8, device=x.device)
    xs = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = cuda.kernel("ln_qkv_int8", "ln_qkv_int8_launch", (cuda.VOID_P,) * 17
                     + (cuda.INT,) * 2 + (cuda.FLOAT,) + (cuda.INT,) + (cuda.VOID_P,))
    cuda.launch(fn, "ln_qkv_int8", x,
                cuda.ptr(x), cuda.ptr(gamma), cuda.ptr(beta), cuda.ptr(xq), cuda.ptr(xs),
                *(cuda.ptr(w) for w, _, _ in ops), *(cuda.ptr(s) for _, s, _ in ops),
                *(cuda.ptr(b) for _, _, b in ops), *(cuda.ptr(o) for o in outs),
                rows, width, float(eps), cuda.DTYPE_CODES[x.dtype])
    cuda.count(ln_qkv_int8)
    return tuple(outs)


ln_qkv_int8.launches = 0  # kernel launches, for showing a run went through it

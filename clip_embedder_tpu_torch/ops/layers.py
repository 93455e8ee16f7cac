"""Core transformer layers as plain functions on tensors.

Counterpart of ``clip_embedder_tpu.ops.layers``, with the same numerics
contract:

* LayerNorm statistics, softmax and activations compute in
  ``promote(dtype, float32)`` — at least f32, so bf16 activations get f32
  math, and f64 stays f64 for numerics checks;
* a linear layer accumulates in f32 and adds its bias before the single
  rounding to the activation dtype (``torch.addmm``; on the card cuBLAS
  applies the bias in its f32 epilogue).

On the kernel impls (``KERNEL_IMPLS``) a block's LayerNorm and its MLP's
activation go through ``norm`` and ``activate``: each runs the single-pass
CUDA kernel of ``ops.rows`` where that kernel takes the call (a CUDA tensor
in f32 or bf16, a width it takes, no operand that requires grad), and the
plain function otherwise; the eager impl always runs the plain function.

Parameters use the JAX package's layout (see ``weights.py``): a linear is
``{"w": [in, out], "b": [out]}`` (or, quantized by ``ops.quant``,
``{"w_q", "w_scale", "b"}``), a LayerNorm ``{"scale": [d], "bias": [d]}``.
Any mapping with ``__getitem__``/``get``/``in`` works — nested dicts of
tensors, or the ``weights.ParamTree`` modules the towers hold.

The convolutional towers keep the JAX package's NHWC activations; ``conv2d``
runs ``F.conv2d`` (cuDNN on the card) on them seen as channels-last NCHW
tensors, with kernels turned from the stored HWIO into OIHW once, when a
tower is built (``conv_weight``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from . import rows
from .int8_mlp import (fits_fused_linear, fits_fused_mlp, fits_streamed_mlp, int8_linear_fused,
                       int8_mlp, int8_mlp_streamed)
from .quant import int8_linear

# the impls that run the port's CUDA kernels (``ops.attention`` names them all)
KERNEL_IMPLS = ("kernel", "kernel_fast")


def promote(dtype: torch.dtype) -> torch.dtype:
    """Compute dtype: at least f32, f64 kept."""
    return torch.promote_types(dtype, torch.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — original CLIP's approximation, in ≥f32."""
    x32 = x.to(promote(x.dtype))
    return (x32 * torch.sigmoid(1.702 * x32)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu, in ≥f32."""
    return F.gelu(x.to(promote(x.dtype)), approximate="none").to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate gelu (timm default; SigLIP towers), in ≥f32."""
    return F.gelu(x.to(promote(x.dtype)), approximate="tanh").to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu,
    "gelu_tanh": gelu_tanh,
    "quick_gelu": quick_gelu,
    "relu": relu,
}

ACTIVATION_NAMES = {fn: name for name, fn in ACTIVATIONS.items()}


def layer_norm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: f32 statistics (two-pass variance),
    affine in the compute dtype, one rounding back to ``x.dtype``."""
    ct = promote(x.dtype)
    x32 = x.to(ct)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(ct) + params["bias"].to(ct)
    return y.to(x.dtype)


def norm(params, x: torch.Tensor, *, eps: float = 1e-5, impl: str = "eager") -> torch.Tensor:
    """``layer_norm``; on a kernel impl ``rows.norm_rows`` (the same
    function in one pass) where its kernel takes x."""
    if impl in KERNEL_IMPLS and rows.takes(x, params) and rows.fits_norm(x):
        return rows.norm_rows(params, x, eps=eps)
    return layer_norm(params, x, eps=eps)


def activate(activation: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
             impl: str = "eager") -> torch.Tensor:
    """``activation(x)``; on a kernel impl ``rows.act_rows`` (the same
    function in one pass) where its kernel takes x and the activation."""
    name = ACTIVATION_NAMES.get(activation)
    if impl in KERNEL_IMPLS and name in rows.ACT_CODES and rows.takes(x):
        return rows.act_rows(x, name)
    return activation(x)


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """Affine map on the last axis. ``w: [in, out]``; bias optional.
    A quantized linear (``w_q`` from ``ops.quant.quantize_tree``) takes the
    fused int8 kernel for 128 rows or more where ``fits_fused_linear``
    holds, else the unfused ``int8_linear``."""
    if "w_q" in params:
        rows = x.numel() // x.shape[-1]
        if rows >= 128 and fits_fused_linear(params, x):
            return int8_linear_fused(params, x.contiguous())
        return int8_linear(params, x)
    w = params["w"].to(x.dtype)
    b = params.get("b")
    x2 = x.reshape(-1, x.shape[-1])
    if b is None:
        y = x2 @ w
    else:
        y = torch.addmm(b.to(x.dtype), x2, w)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def conv_weight(w: torch.Tensor) -> torch.Tensor:
    """An HWIO conv kernel (the JAX package's layout, as the npz holds it)
    → OIHW, the layout ``F.conv2d`` takes, stored channels-last."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def nhwc(pixels: torch.Tensor, channels_first: bool) -> torch.Tensor:
    """Pixels as contiguous NHWC: every conv of a tower then reads and
    writes channels-last memory."""
    return (pixels.permute(0, 2, 3, 1) if channels_first else pixels).contiguous()


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding: int = 0, groups: int = 1) -> torch.Tensor:
    """2-D convolution of NHWC activations with an OIHW kernel from
    ``conv_weight``. The NHWC tensor goes in as a channels-last NCHW view and
    the channels-last result comes back as an NHWC view: no copies when x is
    contiguous. The product accumulates in f32; in bf16 it rounds once before
    the bias and once after (the JAX package adds the bias in f32 before its
    one rounding)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), None if b is None else b.to(x.dtype),
                 stride=stride, padding=padding, groups=groups)
    return y.permute(0, 2, 3, 1)


def mlp(
    params,
    x: torch.Tensor,
    *,
    activation: Callable[[torch.Tensor], torch.Tensor],
    pre_ln=None,
    ln_eps: float = 1e-6,
    residual: bool = False,
    impl: str = "eager",
) -> torch.Tensor:
    """Transformer MLP block: [LayerNorm →] linear → act → linear.

    ``params``: {"fc": linear, "proj": linear}. ``residual=True`` (requires
    ``pre_ln``) returns ``x + mlp(ln(x))``. A quantized block takes the
    fused int8 MLP kernel (``ops.int8_mlp``, LayerNorm and residual inside)
    where ``fits_fused_mlp`` holds, the streamed one (per-slab
    requantization) where ``fits_streamed_mlp`` holds, as the JAX package
    routes them; elsewhere the unfused int8 linears run. An unquantized
    block on a kernel impl (``impl``) runs its LayerNorm and activation
    through ``norm`` and ``activate``; the products stay ``torch.addmm``
    with their biases.
    """
    if residual and pre_ln is None:
        raise ValueError("mlp(residual=True) requires pre_ln")
    fc = params.get("fc")
    if fc is not None and "w_q" in fc:
        name = ACTIVATION_NAMES.get(activation)
        if name and fits_fused_mlp(params, name, x):
            return int8_mlp(params, x, activation=name, pre_ln=pre_ln, ln_eps=ln_eps,
                            add_residual=residual)
        if name and fits_streamed_mlp(params, name, x.numel() // x.shape[-1], x):
            return int8_mlp_streamed(params, x, activation=name, pre_ln=pre_ln,
                                     ln_eps=ln_eps, add_residual=residual)
        impl = "eager"  # the unfused int8 route stays as it is
    res = x if residual else None
    if pre_ln is not None:
        x = norm(pre_ln, x, eps=ln_eps, impl=impl)
    h = activate(activation, linear(params["fc"], x), impl)
    h = linear(params["proj"], h)
    return h if res is None else res + h

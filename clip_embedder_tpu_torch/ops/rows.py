"""A transformer block's LayerNorm and MLP activation, each one pass over
the rows (``csrc/block_rows.cu``).

The port's own kernels, with no TPU counterpart: the JAX package leaves
these functions to XLA, which fuses each into one pass; eager PyTorch runs
``ops.layers.layer_norm`` as about ten kernels and each activation as
three, every one a round trip of an f32 tensor through device memory.

* ``norm_rows(params, x, eps=...)``: ``ops.layers.layer_norm`` (f32
  statistics, two-pass variance, the affine step in f32, one rounding to
  x's dtype), for widths of whole 16-byte pieces, at most 512 of them
  (``fits_norm``);
* ``act_rows(x, name)``: ``ops.layers.gelu`` (the exact erf),
  ``gelu_tanh`` or ``quick_gelu`` (``ACT_CODES``), in f32 with one
  rounding, for any shape.

Each kernel reads x once and writes its result once, in x's dtype (f32 or
bf16). For a tensor on the card the wrappers launch the kernel (raising on
what it does not take); for a CPU tensor they run the plain functions.
``takes`` is the routing's gate (``ops.layers.norm``, ``ops.layers.activate``):
a kernel impl sends a call here only when it holds.
"""

from __future__ import annotations

import torch

from . import cuda

ACT_CODES = {"gelu": 0, "gelu_tanh": 1, "quick_gelu": 2}
MAX_PIECES = 512  # 16-byte pieces of a row norm_kernel holds in a warp's registers


def on_card(x: torch.Tensor) -> bool:
    """x lies on the card, in a dtype the kernels take."""
    return x.device.type == "cuda" and x.dtype in cuda.DTYPE_CODES


def takes(x: torch.Tensor, *operands) -> bool:
    """The kernels take a call on x: x on the card in f32 or bf16,
    contiguous and 16-byte aligned, and no operand (x, or trees of tensors
    in ``operands``) that requires grad while autograd is on."""
    return (on_card(x) and x.is_contiguous() and x.data_ptr() % 16 == 0
            and not cuda.requires_grad(x, *operands))


def fits_norm(x: torch.Tensor) -> bool:
    """``norm_rows`` takes x's width: whole 16-byte pieces, at most
    ``MAX_PIECES`` of them."""
    nbytes = x.shape[-1] * x.element_size() if x.dim() else 0
    return nbytes > 0 and nbytes % 16 == 0 and nbytes // 16 <= MAX_PIECES


def norm_rows(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, ``ops.layers.layer_norm``'s function.

    ``params``: {"scale", "bias"} [W]; ``x``: [..., W], f32 or bf16.
    Runs the CUDA kernel for a CUDA tensor and ``layer_norm`` for a CPU
    tensor."""
    if x.device.type == "cpu":
        from .layers import layer_norm  # ops.layers routes its calls here

        return layer_norm(params, x, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"norm_rows: unsupported device {x.device}")
    cuda.no_grad_operands("norm_rows", params, x)
    cuda.check_input(x, "norm_rows")
    if not fits_norm(x):
        raise ValueError(f"norm_rows: the kernel does not take width {x.shape[-1]} in "
                         f"{x.dtype}; gate callers on fits_norm")
    width = x.shape[-1]
    gamma = cuda.f32_vector(params["scale"], width, x, "norm_rows")
    beta = cuda.f32_vector(params["bias"], width, x, "norm_rows")
    y = torch.empty_like(x)
    rows = x.numel() // width
    if rows == 0:
        return y
    fn = cuda.kernel("block_rows", "norm_rows_launch", (cuda.VOID_P,) * 4 + (cuda.INT,) * 2
                     + (cuda.FLOAT, cuda.INT, cuda.VOID_P))
    cuda.launch(fn, "norm_rows", x, cuda.ptr(x), cuda.ptr(gamma), cuda.ptr(beta), cuda.ptr(y),
                rows, width, float(eps), cuda.DTYPE_CODES[x.dtype])
    cuda.count(norm_rows)
    return y


norm_rows.launches = 0  # kernel launches, for showing a run went through it


def act_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """The activation ``name`` (a key of ``ACT_CODES``) of x, element by
    element, ``ops.layers.ACTIVATIONS[name]``'s function. Runs the CUDA
    kernel for a CUDA tensor and that function for a CPU tensor."""
    if name not in ACT_CODES:
        raise ValueError(f"act_rows: no kernel for activation {name!r} "
                         f"(choices: {', '.join(ACT_CODES)})")
    if x.device.type == "cpu":
        from .layers import ACTIVATIONS  # ops.layers routes its calls here

        return ACTIVATIONS[name](x)
    if x.device.type != "cuda":
        raise ValueError(f"act_rows: unsupported device {x.device}")
    cuda.no_grad_operands("act_rows", x)
    cuda.check_input(x, "act_rows")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = cuda.kernel("block_rows", "act_rows_launch",
                     (cuda.VOID_P, cuda.VOID_P, cuda.LONG, cuda.INT, cuda.INT, cuda.VOID_P))
    cuda.launch(fn, "act_rows", x, cuda.ptr(x), cuda.ptr(y), x.numel(), ACT_CODES[name],
                cuda.DTYPE_CODES[x.dtype])
    cuda.count(act_rows)
    return y


act_rows.launches = 0

"""Fused W8A8 transformer MLP and linear (``csrc/int8_mlp.cu``,
``csrc/int8_mlp_streamed.cu``, ``csrc/int8_linear.cu``).

Counterpart of ``clip_embedder_tpu.ops.int8_mlp``:

* ``int8_mlp``: x → [f32 LayerNorm] → row quant → int8 fc1 → dequant + bias
  → activation (f32) → row requant with the *global* row amax over the
  whole hidden → int8 fc2 → dequant + bias [+ residual] → x's dtype;
* ``int8_mlp_streamed``: the same MLP with the hidden cut into slabs of
  ``chunk`` columns, each requantized with its own row amax, and fc2's
  int32 sums dequantized slab by slab into an f32 accumulator
  (``acc += part_j·(as_j·s2)``), then + bias [+ residual];
* ``int8_linear_fused``: x → row quant → int8 product → dequant + bias
  [+ residual] → x's dtype.

Dequantization is ``acc·(xs·s) + b`` and a residual is added in f32 before
the one rounding to the output dtype, the TPU kernels' order of operations
(the unfused ``ops.quant.int8_linear`` computes ``acc·xs·s``, another f32
rounding). Weights use ``ops.quant`` layout: ``{"w_q": [in, out] int8,
"w_scale": [out] f32, "b"?}``, ``w_q`` stored K-major (``quant.kmajor``),
which the kernels require (``check_weight_layout``).

For a tensor on the card the wrappers launch the CUDA kernels, raising on
anything they do not take; for a tensor on the CPU they run the
``*_plain`` versions, the same functions in plain PyTorch. The ``fits_*``
gates mirror the JAX package's with "the tensor is on CUDA" in place of
"the backend is a TPU", so on the CPU the layers take the unfused path as
the JAX package does there. The TPU's VMEM budgets are dropped, except the
20 MB line between the resident MLP (global requant) and the streamed one
(per-slab requant): it decides whose numerics apply.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda
from .quant import int_matmul, true_div

ACT_CODES = {"gelu_tanh": 0, "gelu": 1, "quick_gelu": 2, "relu": 3}
# int8 weight bytes (fc + proj) above which the JAX package streams the MLP
# in hidden slabs with per-slab requantization (``int8_mlp_streamed``).
FUSED_MLP_MAX_BYTES = 20 * 1024 * 1024
# hidden columns per slab of the streamed MLP: the unit of its activation
# requantization, so part of its numerics (the JAX package's default)
STREAM_CHUNK = 1792
_GELU_TANH_C = 0.7978845608028654  # sqrt(2/pi), rounded to f32 in use, as jax.nn.gelu does


def row_quant(x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, K] f32 → (int8 codes, [T, 1] f32 scales), per-row symmetric."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax == 0, 1.0, true_div(amax, 127.0))
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def layer_norm_f32(x32: torch.Tensor, pre_ln, eps: float) -> torch.Tensor:
    """The kernels' LayerNorm: f32 statistics (two-pass variance), f32
    affine, no rounding of the result. Divisions and the square root are
    IEEE-rounded, as in the kernels (``torch.rsqrt`` and ``mean`` on the
    card are not); only the order of the row sums differs."""
    n = x32.shape[-1]
    mean = true_div(x32.sum(dim=-1, keepdim=True), n)
    d = x32 - mean
    var = true_div(d.square().sum(dim=-1, keepdim=True), n)
    y = d * (1.0 / torch.sqrt(var + eps))
    return y * pre_ln["scale"].to(torch.float32) + pre_ln["bias"].to(torch.float32)


def dequant(acc: torch.Tensor, xs: torch.Tensor, p) -> torch.Tensor:
    """acc·(xs·s) + b in f32, the fused kernels' epilogue."""
    y = acc.to(torch.float32) * (xs * p["w_scale"].to(torch.float32))
    b = p.get("b")
    return y if b is None else y + b.to(torch.float32)


def _erf(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7): the erf the TPU
    kernel computes, kept so that the exact-gelu MLP matches it."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _act(h: torch.Tensor, name: str) -> torch.Tensor:
    """The in-kernel activations, in f32, written in the JAX package's
    order of operations."""
    if name == "gelu_tanh":
        return h * (0.5 * (1.0 + torch.tanh(_GELU_TANH_C * (h + 0.044715 * (h * h * h)))))
    if name == "gelu":
        return 0.5 * h * (1.0 + _erf(h * (2.0 ** -0.5)))
    if name == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if name == "relu":
        return F.relu(h)
    raise ValueError(f"unsupported in-kernel activation '{name}'")


def int8_mlp_plain(params, x: torch.Tensor, *, activation: str = "gelu_tanh",
                   pre_ln=None, ln_eps: float = 1e-6,
                   add_residual: bool = False) -> torch.Tensor:
    """The fused MLP's function in plain PyTorch (its CPU path and the
    reference the kernel is held to on the card)."""
    if add_residual and pre_ln is None:
        raise ValueError("add_residual requires the fused pre_ln (the raw input "
                         "must be the residual stream)")
    fc, pr = params["fc"], params["proj"]
    x2 = x.reshape(-1, fc["w_q"].shape[0]).to(torch.float32)
    res = x2 if add_residual else None
    if pre_ln is not None:
        x2 = layer_norm_f32(x2, pre_ln, ln_eps)
    xq, xs = row_quant(x2)
    h = _act(dequant(int_matmul(xq, fc["w_q"]), xs, fc), activation)
    aq, hs = row_quant(h)
    y = dequant(int_matmul(aq, pr["w_q"]), hs, pr)
    if res is not None:
        y = y + res
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def int8_mlp_streamed_plain(params, x: torch.Tensor, *, activation: str = "gelu_tanh",
                            pre_ln=None, ln_eps: float = 1e-6, add_residual: bool = False,
                            chunk: int = STREAM_CHUNK) -> torch.Tensor:
    """The streamed MLP's function in plain PyTorch: per-slab requantization
    of the hidden, fc2 dequantized slab by slab into an f32 sum."""
    if add_residual and pre_ln is None:
        raise ValueError("add_residual requires the fused pre_ln")
    fc, pr = params["fc"], params["proj"]
    x2 = x.reshape(-1, fc["w_q"].shape[0]).to(torch.float32)
    res = x2 if add_residual else None
    if pre_ln is not None:
        x2 = layer_norm_f32(x2, pre_ln, ln_eps)
    xq, xs = row_quant(x2)
    h = _act(dequant(int_matmul(xq, fc["w_q"]), xs, fc), activation)
    s2 = pr["w_scale"].to(torch.float32)
    acc = torch.zeros(h.shape[0], pr["w_q"].shape[1], dtype=torch.float32, device=x.device)
    for off in range(0, h.shape[1], chunk):
        aq, as_ = row_quant(h[:, off:off + chunk])
        acc = acc + int_matmul(aq, pr["w_q"][off:off + chunk]).to(torch.float32) * (as_ * s2)
    b2 = pr.get("b")
    y = acc if b2 is None else acc + b2.to(torch.float32)
    if res is not None:
        y = y + res
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def int8_linear_fused_plain(params, x: torch.Tensor, *,
                            residual: torch.Tensor | None = None) -> torch.Tensor:
    """The fused linear's function in plain PyTorch."""
    x2 = x.reshape(-1, params["w_q"].shape[0]).to(torch.float32)
    xq, xs = row_quant(x2)
    y = dequant(int_matmul(xq, params["w_q"]), xs, params)
    if residual is not None:
        y = y + residual.reshape(y.shape).to(torch.float32)
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


# -- gates ----------------------------------------------------------------

def _qweight(p) -> torch.Tensor | None:
    w = p.get("w_q") if p is not None else None
    return w if w is not None and w.dim() == 2 else None


def kernel_dims_ok(*dims: int) -> bool:
    """The MLP and q/k/v kernels move int8 rows and write outputs in 16-byte
    pieces: every in/out width a multiple of 16. (The fused linear takes
    any width.)"""
    return all(d > 0 and d % 16 == 0 for d in dims)


def on_card(x: torch.Tensor) -> bool:
    """The gates' stand-in for the JAX package's "the backend is a TPU":
    x lies on the card, in a dtype the kernels take."""
    return x.device.type == "cuda" and x.dtype in cuda.DTYPE_CODES


def fits_fused_linear(params, x: torch.Tensor) -> bool:
    """The fused linear takes this: a 2-D quantized weight whose input
    width is x's, and x on the card. Like the JAX gate, no rule on the
    widths: the kernel takes any."""
    w = _qweight(params)
    return (w is not None and on_card(x) and w.shape[0] == x.shape[-1]
            and min(w.shape) > 0)


def _mlp_weights(params):
    fc, pr = params.get("fc"), params.get("proj")
    w1, w2 = _qweight(fc), _qweight(pr)
    return (w1, w2) if w1 is not None and w2 is not None else None


def fits_fused_mlp(params, activation_name: str, x: torch.Tensor) -> bool:
    """The fused MLP takes this block: both linears quantized (2-D), an
    in-kernel activation, chained widths the kernel takes, x on the card,
    and at most 20 MB of int8 weights (above, the JAX package streams)."""
    ws = _mlp_weights(params)
    if ws is None or activation_name not in ACT_CODES or not on_card(x):
        return False
    w1, w2 = ws
    return (w1.shape[0] == x.shape[-1] and w1.shape[1] == w2.shape[0]
            and kernel_dims_ok(*w1.shape, w2.shape[1])
            and w1.numel() + w2.numel() <= FUSED_MLP_MAX_BYTES)


def fits_streamed_mlp(params, activation_name: str, rows: int, x: torch.Tensor) -> bool:
    """Where the JAX package takes the weight-streamed MLP
    (``int8_mlp_streamed``): over 20 MB of int8 weights, at least 512 rows,
    an in-kernel activation, x on the card."""
    ws = _mlp_weights(params)
    if ws is None or activation_name not in ACT_CODES or not on_card(x):
        return False
    return ws[0].numel() + ws[1].numel() > FUSED_MLP_MAX_BYTES and rows >= 512


# -- wrappers -------------------------------------------------------------

def check_weight_layout(w: torch.Tensor, what: str) -> None:
    """The kernels read a quantized [in, out] weight in its K-major storage
    (``quant.kmajor``, as ``quant.quantize_weight`` stores it): the [out,
    in] rows contiguous, 16-byte aligned and a multiple of 16 bytes apart
    (an ``in`` that is no multiple of 16 is stored in padded rows on the
    card). An N-contiguous weight raises ``ValueError``: no wrapper copies
    or transposes a weight per call."""
    if w.dim() != 2 or not (w.t().is_contiguous() or w.stride(0) == 1) \
            or w.stride(1) < w.shape[0] or w.stride(1) % 16:
        raise ValueError(f"{what}: the kernel reads the int8 weight stored K-major "
                         f"([out, in] rows a multiple of 16 bytes apart, seen as [in, out]; "
                         f"ops.quant.kmajor on the card), got shape {tuple(w.shape)} with "
                         f"strides {w.stride()}")
    if w.data_ptr() % 16:
        raise ValueError(f"{what}: the weight must be 16-byte aligned")


def qlinear_operands(p, k_in: int, x: torch.Tensor, what: str, *, any_width: bool = False):
    """(w_q, scale, bias) of one quantized linear, checked for the kernels:
    a [k_in, N] int8 weight on x's device, stored K-major and 16-byte
    aligned (``check_weight_layout``) with k_in and N multiples of 16
    (unless ``any_width``: the fused linear), and f32 [N] scale and bias.
    The kernels take ``w_q.data_ptr()`` as the [N, k_in] storage, its rows
    ``w_q.stride(1)`` bytes apart (k_in, but for ``any_width``)."""
    w = p["w_q"]
    if (w.dtype != torch.int8 or w.dim() != 2 or w.shape[0] != k_in
            or not (min(w.shape) > 0 if any_width else kernel_dims_ok(*w.shape))):
        raise ValueError(f"{what}: the kernel takes a [{k_in}, N] int8 weight"
                         f"{'' if any_width else ' with widths that are multiples of 16'}, "
                         f"got {tuple(w.shape)} {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"{what}: the weight must be on {x.device}, got {w.device}")
    check_weight_layout(w, what)
    if not any_width and w.shape[1] > 1 and w.stride(1) != k_in:
        raise ValueError(f"{what}: the kernel reads unpadded [N, {k_in}] weight rows, got "
                         f"strides {w.stride()}")
    n = w.shape[1]
    return w, cuda.f32_vector(p["w_scale"], n, x, what), cuda.f32_vector(p.get("b"), n, x, what)


def _launch_mlp(wrapper, params, x, activation, pre_ln, ln_eps, add_residual,
                chunk=None) -> torch.Tensor:
    """The checks, scratch and launch of the two MLP kernels on the card:
    ``int8_mlp`` (one requantization scale a row) without ``chunk``,
    ``int8_mlp_streamed`` (one a slab of ``chunk`` columns) with it. Counts
    the launch on ``wrapper``."""
    what = wrapper.__name__
    cuda.no_grad_operands(what, params, pre_ln, x)
    if add_residual and pre_ln is None:
        raise ValueError("add_residual requires the fused pre_ln")
    if activation not in ACT_CODES:
        raise ValueError(f"{what}: unsupported in-kernel activation '{activation}'")
    if chunk is not None and (chunk <= 0 or chunk % 128):
        raise ValueError(f"{what}: the kernel takes slabs of a multiple of 128 columns, "
                         f"got chunk={chunk}")
    cuda.check_input(x, what)
    k_in = x.shape[-1]
    w1, s1, b1 = qlinear_operands(params["fc"], k_in, x, f"{what} fc")
    hidden = w1.shape[1]
    w2, s2, b2 = qlinear_operands(params["proj"], hidden, x, f"{what} proj")
    k_out = w2.shape[1]
    if add_residual and k_out != k_in:
        raise ValueError(f"{what}: add_residual needs out width == in width")
    ln = pre_ln is not None
    gamma = cuda.f32_vector(pre_ln["scale"] if ln else None, k_in, x, f"{what} pre_ln")
    beta = cuda.f32_vector(pre_ln["bias"] if ln else None, k_in, x, f"{what} pre_ln")
    rows = x.numel() // k_in
    out = torch.empty(*x.shape[:-1], k_out, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    dev = x.device
    slabs = 1 if chunk is None else (hidden + chunk - 1) // chunk
    xq = torch.empty(rows, k_in, dtype=torch.int8, device=dev)
    xs = torch.empty(rows, dtype=torch.float32, device=dev)
    h = torch.empty(rows, hidden, dtype=torch.float32, device=dev)   # act(fc1), f32
    hq = torch.empty(rows, hidden, dtype=torch.int8, device=dev)
    hs = torch.empty(rows, slabs, dtype=torch.float32, device=dev)   # hidden amax, then scales
    extra = () if chunk is None else (chunk,)
    fn = cuda.kernel(what, f"{what}_launch", (cuda.VOID_P,) * 15 + (cuda.INT,) * (4 + len(extra))
                     + (cuda.FLOAT,) + (cuda.INT,) * 4 + (cuda.VOID_P,))
    cuda.launch(fn, what, x,
                cuda.ptr(x), cuda.ptr(gamma), cuda.ptr(beta), cuda.ptr(xq), cuda.ptr(xs),
                cuda.ptr(w1), cuda.ptr(s1), cuda.ptr(b1), cuda.ptr(h), cuda.ptr(hq),
                cuda.ptr(hs), cuda.ptr(w2), cuda.ptr(s2), cuda.ptr(b2), cuda.ptr(out),
                rows, k_in, hidden, k_out, *extra, float(ln_eps), ACT_CODES[activation],
                int(ln), int(add_residual), cuda.DTYPE_CODES[x.dtype])
    cuda.count(wrapper)
    return out


def int8_mlp(params, x: torch.Tensor, *, activation: str = "gelu_tanh",
             pre_ln=None, ln_eps: float = 1e-6, add_residual: bool = False) -> torch.Tensor:
    """Fused quantized MLP block. ``params``: {"fc", "proj"} quantized
    linears; ``x``: [..., K], f32 or bf16; ``pre_ln`` ({"scale", "bias"})
    fuses the pre-MLP LayerNorm; ``add_residual`` (requires ``pre_ln``)
    returns ``x + mlp(ln(x))``. Runs the CUDA kernel for a CUDA tensor and
    ``int8_mlp_plain`` for a CPU tensor."""
    if x.device.type == "cpu":
        return int8_mlp_plain(params, x, activation=activation, pre_ln=pre_ln,
                              ln_eps=ln_eps, add_residual=add_residual)
    if x.device.type != "cuda":
        raise ValueError(f"int8_mlp: unsupported device {x.device}")
    return _launch_mlp(int8_mlp, params, x, activation, pre_ln, ln_eps, add_residual)


int8_mlp.launches = 0  # kernel launches, for showing a run went through it


def int8_mlp_streamed(params, x: torch.Tensor, *, activation: str = "gelu_tanh",
                      pre_ln=None, ln_eps: float = 1e-6, add_residual: bool = False,
                      chunk: int = STREAM_CHUNK) -> torch.Tensor:
    """Fused quantized MLP block with per-slab requantization of the hidden
    (slabs of ``chunk`` columns; the last may be ragged). Arguments as
    ``int8_mlp``. Runs the CUDA kernel for a CUDA tensor (``chunk`` a
    multiple of 128) and ``int8_mlp_streamed_plain`` for a CPU tensor."""
    if x.device.type == "cpu":
        return int8_mlp_streamed_plain(params, x, activation=activation, pre_ln=pre_ln,
                                       ln_eps=ln_eps, add_residual=add_residual, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"int8_mlp_streamed: unsupported device {x.device}")
    return _launch_mlp(int8_mlp_streamed, params, x, activation, pre_ln, ln_eps, add_residual,
                       chunk)


int8_mlp_streamed.launches = 0  # kernel launches, for showing a run went through it


def _pad_to(n: int, m: int) -> int:
    return n + (-n) % m


def int8_linear_fused(params, x: torch.Tensor, *,
                      residual: torch.Tensor | None = None) -> torch.Tensor:
    """Fused W8A8 affine map: row quant → int8 product → ``acc·(xs·s) + b``
    [+ residual, same leading shape as the output]. Runs the CUDA kernel
    for a CUDA tensor and ``int8_linear_fused_plain`` for a CPU tensor.

    Any widths: the kernel writes an output whose width is no multiple of 8
    into rows padded to one and returns the view of its columns (a residual
    of such a width is copied into padded rows first); an input width that
    is no multiple of 16 needs the weight in padded rows (``quant.kmajor``
    on the card)."""
    if x.device.type == "cpu":
        return int8_linear_fused_plain(params, x, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"int8_linear_fused: unsupported device {x.device}")
    cuda.no_grad_operands("int8_linear_fused", params, x, residual)
    cuda.check_input(x, "int8_linear_fused")
    k_in = x.shape[-1]
    w, s, b = qlinear_operands(params, k_in, x, "int8_linear_fused", any_width=True)
    k_out = w.shape[1]
    shape = (*x.shape[:-1], k_out)
    if residual is not None:
        if (tuple(residual.shape) != shape or residual.dtype != x.dtype
                or residual.device != x.device):
            raise ValueError(f"int8_linear_fused: residual must be {shape} "
                             f"{x.dtype} on {x.device}")
        cuda.check_input(residual, "int8_linear_fused residual")
    rows = x.numel() // k_in
    lda = _pad_to(k_in, 16)   # the codes' rows: TMA's 16-byte stride rule
    ldo = _pad_to(k_out, 8)   # the output's rows: its 16-byte stores
    out = torch.empty(rows, ldo, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out[:, :k_out].reshape(shape)
    if residual is not None and ldo != k_out:
        padded = torch.empty_like(out)
        padded[:, :k_out] = residual.reshape(rows, k_out)
        residual = padded
    xq = torch.empty(rows, lda, dtype=torch.int8, device=x.device)
    xs = torch.empty(rows, dtype=torch.float32, device=x.device)
    fn = cuda.kernel("int8_linear", "int8_linear_fused_launch",
                     (cuda.VOID_P,) * 8 + (cuda.INT,) * 7 + (cuda.VOID_P,))
    cuda.launch(fn, "int8_linear_fused", x,
                cuda.ptr(x), cuda.ptr(xq), cuda.ptr(xs), cuda.ptr(w), cuda.ptr(s), cuda.ptr(b),
                cuda.ptr(residual), cuda.ptr(out), rows, k_in, k_out, lda, w.stride(1), ldo,
                cuda.DTYPE_CODES[x.dtype])
    cuda.count(int8_linear_fused)
    return out[:, :k_out].reshape(shape)


int8_linear_fused.launches = 0  # kernel launches, for showing a run went through it

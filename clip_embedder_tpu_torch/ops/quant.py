"""Opt-in int8 quantization (W8A8, dynamic) of the matmul-heavy layers.

Counterpart of ``clip_embedder_tpu.ops.quant``, with the same scheme:
per-output-channel symmetric int8 weights (static, computed at load),
per-row symmetric int8 activations (dynamic), an exact int32 product, and
the dequantization fused into the output:

    y[t, o] = (Σ_k x̂[t,k] ŵ[k,o]) · sx[t] · sw[o]  (+ bias)

``quantize="int8"`` on the embedders converts the MLP blocks,
``"int8_all"`` the attention projections too. Only linears converted by
``quantize_tree`` (``{"w_q": [in, out] int8, "w_scale": [out] f32, "b"?}``)
run quantized; LayerNorm, softmax and attention keep full precision.

``w_q`` has the JAX package's shape, ``[..., in, out]``, but is stored
K-major: a contiguous ``[..., out, in]`` tensor seen through
``transpose(-1, -2)`` (``kmajor``), so that ``w_q.t()`` of one layer is
contiguous. That is the layout the CUDA kernels' int8 products read as it is
(the s8 wgmma takes its B operand K-major only); no second copy exists, and
everything that treats ``w_q`` as a tensor (``int_matmul``, slicing,
``.numpy()``) sees the same values as before.

The clip search runs in torch on the weights' device with the JAX
package's arithmetic (f32 division, round half to even, clip to ±127, the
``err < best_err`` choice), so a full tower quantizes on the card in well
under a second.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..errors import ConfigError

QUANTIZE_MODES = ("int8", "int8_all")

# MLP-block subtree names across the vision families: vit/text 'mlp',
# fastvit 'ffn', convnext block linears 'fc1'/'fc2'.
DEFAULT_QUANT_PATHS = ("mlp", "ffn", "fc1", "fc2")
# "int8_all" also quantizes the attention projections (q/k/v/out).
QUANT_PATHS_ALL = DEFAULT_QUANT_PATHS + ("attn",)

# The 13 clip ratios the MSE search tries (numpy's f64 linspace, as the
# JAX package computes them).
_CLIP_ALPHAS = tuple(float(a) for a in np.linspace(0.70, 1.0, 13))


def true_div(a: torch.Tensor, c: float) -> torch.Tensor:
    """a / c by IEEE division on every device. (PyTorch multiplies a CUDA
    tensor by the reciprocal of a Python number it is divided by, which
    rounds differently: a scale one unit off flips int8 codes.) The divisor
    is filled on a's device, not copied from the host, so that a captured
    forward (``utils.captured``) holds it."""
    return a / torch.full((), c, dtype=a.dtype, device=a.device)


def kmajor(w: torch.Tensor, *, pad: bool | None = None) -> torch.Tensor:
    """``w`` ([..., in, out]) with the same values, stored K-major: its last
    two dims transposed in memory (a contiguous [..., out, in] tensor seen
    through ``transpose(-1, -2)``). With ``pad`` (the default on the card)
    an ``in`` that is no multiple of 16 is stored in rows padded with zeros
    to the next one (a contiguous [..., out, in_padded] tensor, its first
    ``in`` columns seen the same way): TMA, which loads the int8 products'
    operands, takes only row strides that are multiples of 16 bytes.
    Returns ``w`` itself when it already is so stored."""
    k = w.shape[-2]
    kp = k + (-k) % 16 if (w.is_cuda if pad is None else pad) else k
    t = w.transpose(-1, -2)
    if kp == k:
        return w if t.is_contiguous() else t.contiguous().transpose(-1, -2)
    want, step = [], 1
    for n in (*t.shape[:-1], kp)[::-1]:
        want.append(step)
        step *= n
    if t.stride() == tuple(want[::-1]):
        return w
    buf = w.new_zeros(*t.shape[:-1], kp)
    buf[..., :k] = t
    return buf[..., :k].transpose(-1, -2)


def quantize_weight(w: torch.Tensor, *, clip: str = "mse") -> dict:
    """[..., in, out] float weight → per-output-channel symmetric int8
    (leading dims, e.g. the stacked-layer axis, quantize independently);
    ``w_q`` stored K-major (``kmajor``).

    ``clip="mse"`` searches a per-channel clip ratio α ∈ [0.70, 1.0] that
    minimizes the channel's round-trip squared error; ``clip="max"`` scales
    by the channel's absolute max."""
    w = w.to(torch.float32)
    amax = w.abs().amax(dim=-2, keepdim=True)
    amax = torch.where(amax == 0, 1.0, amax)
    if clip == "mse":
        best_scale = best_err = None
        for alpha in _CLIP_ALPHAS:
            # alpha·amax/127 in f64, rounded once to f32 (numpy's promotion)
            scale = true_div(amax.double() * alpha, 127.0).float()
            q = torch.clamp(torch.round(w / scale), -127, 127)
            err = (q * scale - w).square().sum(dim=-2, keepdim=True)
            if best_err is None:
                best_err, best_scale = err, scale
            else:
                take = err < best_err
                best_err = torch.where(take, err, best_err)
                best_scale = torch.where(take, scale, best_scale)
        scale = best_scale
    else:
        scale = true_div(amax, 127.0)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"w_q": kmajor(w_q), "w_scale": scale.squeeze(-2)}


def quantize_tree(params: Mapping, *, paths: tuple[str, ...] = DEFAULT_QUANT_PATHS,
                  exclude: tuple[str, ...] = (), clip: str = "mse") -> dict:
    """Convert the linear leaves under the given subtree names (default:
    the MLP blocks of every family) to int8. Only matmul weights quantize
    (2-D, or 3-D stacked-layer, or 1×1 convs squeezed to that); other
    leaves are untouched. ``exclude`` names subtrees kept in full
    precision even under a target path. The root-level ``proj`` (the
    tower's output projection) never quantizes. Returns a new tree."""

    def walk(node: Any, under_target: bool, depth: int = 0):
        if isinstance(node, Mapping):
            if under_target and "w" in node:
                w = node["w"]
                # 1×1 convs ([1, 1, in, out], optionally stacked) are matmuls
                if w.dim() in (4, 5) and w.shape[-4] == 1 and w.shape[-3] == 1:
                    w = w.reshape(w.shape[:-4] + w.shape[-2:])
                if w.dim() in (2, 3):
                    out = {k: v for k, v in node.items() if k != "w"}
                    out.update(quantize_weight(w, clip=clip))
                    return out
                return dict(node)
            return {k: (v if (depth == 0 and k == "proj") or k in exclude
                        else walk(v, under_target or k in paths, depth + 1))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, under_target, depth + 1) for v in node]
        return node

    return walk(params, False)


def _has_quantized(node: Any) -> bool:
    if isinstance(node, Mapping):
        return "w_q" in node or any(_has_quantized(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_has_quantized(v) for v in node)
    return False


def quantize_tree_checked(params: Mapping, family: str, *, mode: str = "int8",
                          paths: tuple[str, ...] | None = None) -> dict:
    """``quantize_tree`` that raises ``ConfigError`` when nothing quantized
    (a silent no-op ``quantize="int8"`` would hide a perf bug). ``mode``:
    "int8" (MLP blocks) or "int8_all" (MLP + attention projections)."""
    if paths is None:
        paths = QUANT_PATHS_ALL if mode == "int8_all" else DEFAULT_QUANT_PATHS
    qparams = quantize_tree(params, paths=paths)
    if not _has_quantized(qparams):
        raise ConfigError(f"int8 quantization found no quantizable (matmul) layers "
                          f"for the '{family}' family")
    return qparams


def check_quantize_mode(quantize: str | None) -> None:
    if quantize is not None and quantize not in QUANTIZE_MODES:
        raise ConfigError(f"Unknown quantize mode '{quantize}' (choices: None, "
                          f"{', '.join(QUANTIZE_MODES)})")


def int_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 codes ([M, K] · [K, N]), computed in
    f64 on every device: its 53-bit mantissa holds every sum of up to 2^38
    products of ±127 exactly. (``torch.matmul`` takes no integer types on
    CUDA, an f32 product is inexact past 2^24, and an int32 product on the
    CPU runs without BLAS, tens of times slower than f64.)"""
    return torch.matmul(a_q.to(torch.float64), w_q.to(torch.float64)).to(torch.int32)


def int8_linear(params, x: torch.Tensor) -> torch.Tensor:
    """Quantized affine map, unfused: dynamic per-row activation quant →
    exact int8 product → dequant ``acc·sx·sw`` (+ bias) → x's dtype.
    ``params``: {"w_q": [in, out] int8, "w_scale": [out] f32, "b"?}."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    amax = x2.abs().amax(dim=-1, keepdim=True)
    x_scale = torch.where(amax == 0, 1.0, true_div(amax, 127.0))
    x_q = torch.clamp(torch.round(x2 / x_scale), -127, 127).to(torch.int8)
    y = int_matmul(x_q, params["w_q"]).to(torch.float32) * x_scale \
        * params["w_scale"].to(torch.float32)
    b = params.get("b")
    if b is not None:
        y = y + b.to(torch.float32)
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)

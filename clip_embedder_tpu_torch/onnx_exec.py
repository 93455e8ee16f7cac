"""Generic ONNX-graph executor on PyTorch — the "run any exported model" path.

Counterpart of ``clip_embedder_tpu.onnx_exec``. The reference runs
*arbitrary* exported open_clip graphs because ONNX Runtime executes whatever
``visual.onnx``/``text.onnx`` contains (reference: src/onnx.rs:13-29). The
native towers cover the families worth hand-optimizing; for anything else
this module interprets the ONNX graph op by op, eagerly, on an explicit
device, so a model dir keeps its "any open_clip model" capability.

Execution model:

* The graph (``onnx_reader.read_onnx``, which parses full node attributes)
  is walked in file order — torch exports are topologically sorted.
* Two kinds of value. Host constants are numpy arrays: ``Constant``
  outputs, ``Shape`` results, integer initializers and whatever is computed
  from them alone. Activations and float weights are ``torch.Tensor`` on the
  tower's device. A node whose inputs are all host constants evaluates with
  numpy (``_NP_FOLD``), so the standard torch-export shape chain (Shape →
  Gather → Mod → Reshape → Slice ends) stays Python integers; an argument
  that must be static (a shape, a slice bound, axes) but is a tensor raises
  ``WeightError`` instead of reading the device. A host constant that an op
  takes as a tensor is copied to the device once per tower and content
  (``_Env.const``), so that from its second call on a forward reads nothing
  from the host, and on the card it is captured as a CUDA graph per batch
  bucket (``utils.captured``), as the JAX package traces it.
* ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the two operands of
  MatMul/Gemm/Conv to that type, products accumulating in f32, and casts the
  result back to the graph's dtype; ``quant`` names MatMul weights that
  ``OnnxTower`` quantized at load, which then run W8A8 (``ops.quant``'s
  scheme, plain torch).

Unsupported ops raise ``WeightError`` naming the op, mirroring the typed
failure the reference surfaces for unrunnable graphs. ``If`` runs the branch
its (static) condition picks; the branch sees the outer values, and its own
initializers shadow them, as ONNX scoping requires (the JAX package lets the
outer values win).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .errors import ConfigError, WeightError
from .onnx_reader import _DTYPES, OnnxGraph, read_onnx

Value = Any  # np.ndarray (host constant) | torch.Tensor


class _Env(dict):
    """Value name → value, plus the device activations live on and the
    device tensors made of static values (``consts``: content → tensor,
    shared by every call of one tower)."""

    def __init__(self, device: torch.device, consts: dict | None = None):
        super().__init__()
        self.device = device
        self.consts = {} if consts is None else consts

    def t(self, name: str) -> torch.Tensor:
        """The value as a tensor on the device (``const``)."""
        return self.const(self[name])

    def const(self, v: Value) -> torch.Tensor:
        """``v`` as a tensor on the device: a tensor as it is; a static value
        made at its first use and reused after (f64 becomes f32, as the JAX
        package's arrays take it), so that a forward copies nothing from
        the host once its static values have been seen and can be captured
        (``utils.captured``). Keyed by content, so a value computed from the
        input's shape (a Reshape target, a ConstantOfShape) is one tensor a
        batch bucket."""
        if isinstance(v, torch.Tensor):
            return v
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        key = (a.dtype.str, a.shape, a.tobytes())
        t = self.consts.get(key)
        if t is None:
            t = self.consts.setdefault(key, _tensor(a, self.device))
        return t


def _tensor(v: Value, device: torch.device) -> torch.Tensor:
    a = np.asarray(v)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)


def _is_static(v: Value) -> bool:
    return not isinstance(v, torch.Tensor)


def _static_ints(v: Value, what: str) -> list[int]:
    if not _is_static(v):
        raise WeightError(
            f"ONNX executor: {what} is data-dependent (a tensor; dynamic shapes "
            "are not supported)")
    return [int(x) for x in np.asarray(v).reshape(-1)]


def _static_scalar(v: Value, what: str) -> float:
    if not _is_static(v):
        raise WeightError(f"ONNX executor: {what} must be static")
    return float(np.asarray(v).reshape(()))


_CAST = {code: np.dtype(dt) for code, dt in _DTYPES.items()}
_CAST[16] = np.dtype(np.float32)  # bf16 attr tensors arrive upcast

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32, np.dtype(np.uint64): torch.uint64,
}


def _axes_arg(inputs, env, attrs, idx=1):
    """Reduce*/Squeeze/Unsqueeze axes: attr (≤opset 13) or input (18)."""
    if "axes" in attrs:
        return list(attrs["axes"]) if isinstance(attrs["axes"], list) else [
            attrs["axes"]]
    if len(inputs) > idx and inputs[idx]:
        return _static_ints(env[inputs[idx]], "axes")
    return None


def _reduce(fn, x: torch.Tensor, axes, keepdims) -> torch.Tensor:
    dims = tuple(range(x.ndim)) if axes is None else tuple(a % x.ndim for a in axes)
    return fn(x, dims, bool(keepdims))


def _prod(x, dims, keepdim):
    for d in sorted(dims, reverse=True):
        x = x.prod(dim=d, keepdim=keepdim)
    return x


def _conv(x: torch.Tensor, w: torch.Tensor, b, attrs) -> torch.Tensor:
    spatial = x.ndim - 2
    if spatial not in (1, 2, 3):
        raise WeightError(f"ONNX executor: {spatial}-D Conv not supported")
    group = int(attrs.get("group", 1))
    strides = tuple(attrs.get("strides", [1] * spatial))
    dil = tuple(attrs.get("dilations", [1] * spatial))
    if attrs.get("auto_pad", b"NOTSET") not in (b"NOTSET", "NOTSET"):
        raise WeightError("ONNX executor: auto_pad convs not supported")
    pads = list(attrs.get("pads", [0] * (2 * spatial)))
    lo, hi = pads[:spatial], pads[spatial:]
    if lo != hi:  # asymmetric: pad explicitly (F.pad takes the last axis first)
        x = F.pad(x, [p for i in reversed(range(spatial)) for p in (lo[i], hi[i])])
        lo = [0] * spatial
    conv = (F.conv1d, F.conv2d, F.conv3d)[spatial - 1]
    # accumulate in f32, one rounding to x's dtype, then the bias in x's dtype
    y = conv(x, w.to(x.dtype), None, stride=strides, padding=tuple(lo), dilation=dil,
             groups=group)
    if b is not None:
        y = y + b.to(y.dtype).reshape((1, -1) + (1,) * spatial)
    return y


def _pool(x: torch.Tensor, attrs, kind: str) -> torch.Tensor:
    """Max/AveragePool with torch's semantics (the source of these
    exports): the explicit pads, then windows over the padded input, the
    last one allowed to run past it under ``ceil_mode``. An average divides
    by the window's cells inside the input, plus the explicit padding under
    ``count_include_pad``, never the ceil-mode overhang."""
    spatial = x.ndim - 2
    if spatial not in (1, 2, 3):
        raise WeightError(f"ONNX executor: {spatial}-D pooling not supported")
    ks = tuple(attrs["kernel_shape"])
    strides = tuple(attrs.get("strides", [1] * spatial))
    if any(d != 1 for d in attrs.get("dilations", [1] * spatial)):
        raise WeightError("Pool dilations != 1 not supported")
    pads = list(attrs.get("pads", [0] * (2 * spatial)))
    fpad = [p for i in reversed(range(spatial)) for p in (pads[i], pads[i + spatial])]
    ceil = bool(int(attrs.get("ceil_mode", 0)))
    one_d = spatial == 1
    if one_d:  # pool 1-D as 2-D over a unit axis
        x, ks, strides, fpad = x.unsqueeze(-2), (1,) + ks, (1,) + strides, fpad + [0, 0]
    nd = len(ks)
    if kind == "max":
        fill = float("-inf") if x.is_floating_point() else int(torch.iinfo(x.dtype).min)
        xp = F.pad(x, fpad, value=fill) if any(fpad) else x
        y = (F.max_pool2d if nd == 2 else F.max_pool3d)(xp, ks, strides, ceil_mode=ceil)
    else:
        pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
        ct = torch.promote_types(x.dtype, torch.float32)
        xp = F.pad(x.to(ct), fpad) if any(fpad) else x.to(ct)
        sums = pool(xp, ks, strides, ceil_mode=ceil, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=ct, device=x.device)
        counted = 1.0 if int(attrs.get("count_include_pad", 0)) else 0.0
        if any(fpad):
            ones = F.pad(ones, fpad, value=counted)
        counts = pool(ones, ks, strides, ceil_mode=ceil, divisor_override=1)
        y = (sums / counts).to(x.dtype)
    return y.squeeze(-2) if one_d else y


def _gemm(env, inputs, attrs):
    a = env.t(inputs[0])
    b = env.t(inputs[1])
    if int(attrs.get("transA", 0)):
        a = a.T
    if int(attrs.get("transB", 0)):
        b = b.T
    y = torch.matmul(a, b.to(a.dtype)).to(torch.promote_types(a.dtype, torch.float32))
    y = y * float(attrs.get("alpha", 1.0))
    if len(inputs) > 2 and inputs[2]:
        y = y + float(attrs.get("beta", 1.0)) * env.t(inputs[2])
    return y.to(a.dtype)


def _matmul(env, inputs, attrs):
    x, y = env.t(inputs[0]), env.t(inputs[1])
    return torch.matmul(x, y.to(x.dtype))


def _slice_op(env, inputs, attrs):
    x = env[inputs[0]]
    if "starts" in attrs:  # opset 9 attribute form
        starts = list(attrs["starts"])
        ends = list(attrs["ends"])
        axes = list(attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = _static_ints(env[inputs[1]], "Slice starts")
        ends = _static_ints(env[inputs[2]], "Slice ends")
        axes = (_static_ints(env[inputs[3]], "Slice axes")
                if len(inputs) > 3 and inputs[3] else list(range(len(starts))))
        steps = (_static_ints(env[inputs[4]], "Slice steps")
                 if len(inputs) > 4 and inputs[4] else [1] * len(starts))
    ndim = np.ndim(x) if _is_static(x) else x.ndim
    index: list[slice] = [slice(None)] * ndim
    flips: list[tuple[int, range]] = []
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        # ONNX Slice semantics: negative indices count from the end BEFORE
        # clamping; for negative steps an end below 0 (e.g. INT_MIN) means
        # "run past the first element" (python stop=None).
        ax = ax % ndim
        dim = x.shape[ax]
        st2 = st + dim if st < 0 else st
        en2 = en + dim if en < 0 else en
        if sp > 0:
            lo = min(max(st2, 0), dim)
            hi = min(max(en2, 0), dim)
            index[ax] = slice(lo, hi, sp) if sp != 1 else slice(lo, hi)
        else:
            lo = min(max(st2, 0), dim - 1)
            stop = None if en2 < 0 else min(en2, dim - 1)
            if _is_static(x):
                index[ax] = slice(lo, stop, sp)
            else:  # tensors take no negative steps: gather the indices
                flips.append((ax, range(lo, -1 if stop is None else stop, sp)))
    y = x[tuple(index)]
    for ax, idx in flips:
        y = y.index_select(ax, torch.arange(idx.start, idx.stop, idx.step, device=y.device))
    return y


def _reshape(env, inputs, attrs):
    x = env.t(inputs[0])
    shape = _static_ints(env[inputs[1]], "Reshape shape")
    out = [x.shape[i] if s == 0 and not int(attrs.get("allowzero", 0)) else s
           for i, s in enumerate(shape)]
    return x.reshape(out)


def _expand(env, inputs):
    x = env.t(inputs[0])
    shape = _static_ints(env[inputs[1]], "Expand shape")
    # ONNX Expand is bidirectional broadcast
    nd = max(x.ndim, len(shape))
    xs = (1,) * (nd - x.ndim) + tuple(x.shape)
    sh = [1] * (nd - len(shape)) + list(shape)
    target = tuple(max(a, b) for a, b in zip(xs, sh))
    return x.reshape(xs).expand(target)


def _index(idx: torch.Tensor, dim: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where(idx < 0, idx + dim, idx)


def _gather(env, inputs, attrs):
    x = env.t(inputs[0])
    axis = int(attrs.get("axis", 0)) % x.ndim
    idx = _index(env.t(inputs[1]), x.shape[axis])
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _gather_nd(data: torch.Tensor, indices: torch.Tensor, batch_dims=0) -> torch.Tensor:
    b = batch_dims
    lead = data.shape[:b]
    n = int(np.prod(lead)) if b else 1
    d = data.reshape((n,) + data.shape[b:])
    i = indices.long().reshape((n,) + indices.shape[b:])
    parts = tuple(_index(p, d.shape[1 + j]) for j, p in enumerate(i.movedim(-1, 0)))
    rows = torch.arange(n, device=d.device).reshape((n,) + (1,) * (i.ndim - 2))
    out = d[(rows,) + parts]
    return out.reshape(lead + out.shape[1:])


def _layer_norm(env, inputs, attrs):
    x = env.t(inputs[0])
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("epsilon", 1e-5))
    ct = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(ct)
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = x32.mean(dim=axes, keepdim=True)
    var = (x32 - mean).square().mean(dim=axes, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * env.t(inputs[1]).to(ct)
    if len(inputs) > 2 and inputs[2]:
        y = y + env.t(inputs[2]).to(ct)
    return y.to(x.dtype)


def _batch_norm(env, inputs, attrs):
    x, scale, bias, mean, var = (env.t(n) for n in inputs[:5])
    eps = float(attrs.get("epsilon", 1e-5))
    ct = torch.promote_types(x.dtype, torch.float32)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    y = (x.to(ct) - mean.to(ct).reshape(shape)) * torch.rsqrt(
        var.to(ct).reshape(shape) + eps)
    y = y * scale.to(ct).reshape(shape) + bias.to(ct).reshape(shape)
    return y.to(x.dtype)


def _pow(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ONNX Pow: inputs may differ in type; compute in the promoted type
    and cast back to the base's dtype (casting the exponent to an integer
    base's dtype would truncate e.g. 0.5 → 0)."""
    ct = torch.promote_types(x.dtype, y.dtype)
    return torch.pow(x.to(ct), y.to(ct)).to(x.dtype)


def _div(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """ONNX Div: C-style truncation toward zero for integer operands
    (matching the host-fold path's _np_div), true division otherwise."""
    if not x.is_floating_point() and not y.is_floating_point():
        return torch.div(x, y, rounding_mode="trunc")
    return x / y


def _arg_minmax(fn, x: torch.Tensor, attrs) -> torch.Tensor:
    axis = int(attrs.get("axis", 0))
    return fn(x, dim=axis, keepdim=bool(int(attrs.get("keepdims", 1)))).long()


def _unsqueeze(x: torch.Tensor, axes: list[int]) -> torch.Tensor:
    rank = x.ndim + len(axes)
    for ax in sorted(a % rank for a in axes):
        x = x.unsqueeze(ax)
    return x


def _softmax(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.softmax(x.to(torch.promote_types(x.dtype, torch.float32)),
                         dim=axis).to(x.dtype)


def _resolve_ops() -> dict[str, Callable]:
    e: dict[str, Callable] = {}  # each takes (env, inputs, attrs)

    def unary(fn):
        return lambda env, i, a: fn(env.t(i[0]))

    def binary(fn):
        return lambda env, i, a: fn(env.t(i[0]), env.t(i[1]))

    def variadic(fn):
        return lambda env, i, a: functools.reduce(fn, (env.t(n) for n in i))

    e["Identity"] = lambda env, i, a: env[i[0]]
    e["Dropout"] = lambda env, i, a: env[i[0]]
    e["Add"] = binary(torch.add)
    e["Sub"] = binary(torch.sub)
    e["Mul"] = binary(torch.mul)
    e["Div"] = binary(_div)
    e["Pow"] = binary(_pow)
    e["MatMul"] = _matmul
    e["Gemm"] = _gemm
    e["Neg"] = unary(torch.neg)
    e["Abs"] = unary(torch.abs)
    e["Exp"] = unary(torch.exp)
    e["Log"] = unary(torch.log)
    e["Sqrt"] = unary(torch.sqrt)
    e["Reciprocal"] = unary(torch.reciprocal)
    e["Erf"] = unary(torch.erf)
    e["Tanh"] = unary(torch.tanh)
    e["Sin"] = unary(torch.sin)
    e["Cos"] = unary(torch.cos)
    e["Floor"] = unary(torch.floor)
    e["Ceil"] = unary(torch.ceil)
    e["Round"] = unary(torch.round)  # half to even, as ONNX
    e["Sigmoid"] = unary(torch.sigmoid)
    e["Relu"] = unary(torch.relu)
    e["LeakyRelu"] = lambda env, i, a: F.leaky_relu(env.t(i[0]), a.get("alpha", 0.01))
    e["Elu"] = lambda env, i, a: F.elu(env.t(i[0]), a.get("alpha", 1.0))
    e["Gelu"] = lambda env, i, a: F.gelu(
        env.t(i[0]), approximate="tanh" if a.get("approximate", b"none") == b"tanh" else "none")
    e["Softplus"] = unary(F.softplus)
    e["HardSigmoid"] = lambda env, i, a: torch.clamp(
        a.get("alpha", 0.2) * env.t(i[0]) + a.get("beta", 0.5), 0.0, 1.0)
    e["HardSwish"] = unary(lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))
    # Min/Max are variadic (1..N inputs) since opset 8
    e["Min"] = variadic(torch.minimum)
    e["Max"] = variadic(torch.maximum)
    e["Equal"] = binary(torch.eq)
    e["Greater"] = binary(torch.gt)
    e["GreaterOrEqual"] = binary(torch.ge)
    e["Less"] = binary(torch.lt)
    e["LessOrEqual"] = binary(torch.le)
    e["Not"] = unary(torch.logical_not)
    e["And"] = binary(torch.logical_and)
    e["Or"] = binary(torch.logical_or)
    e["Where"] = lambda env, i, a: torch.where(env.t(i[0]).bool(), env.t(i[1]), env.t(i[2]))
    e["Clip"] = lambda env, i, a: torch.clamp(
        env.t(i[0]),
        None if len(i) < 2 or not i[1] else env.t(i[1]),
        None if len(i) < 3 or not i[2] else env.t(i[2]))
    e["Softmax"] = lambda env, i, a: _softmax(env.t(i[0]), int(a.get("axis", -1)))
    e["Transpose"] = lambda env, i, a: (
        env.t(i[0]).permute(a["perm"]) if "perm" in a else env.t(i[0]).permute(
            *reversed(range(env.t(i[0]).ndim))))
    e["Concat"] = lambda env, i, a: torch.cat([env.t(n) for n in i], dim=int(a["axis"]))
    e["Flatten"] = lambda env, i, a: env.t(i[0]).reshape(
        int(np.prod(env[i[0]].shape[:int(a.get("axis", 1))] or (1,))), -1)
    e["Reshape"] = _reshape
    e["Expand"] = lambda env, i, a: _expand(env, i)
    e["Mod"] = lambda env, i, a: (torch.fmod if int(a.get("fmod", 0)) else torch.remainder)(
        env.t(i[0]), env.t(i[1]))
    e["Slice"] = _slice_op
    e["Squeeze"] = lambda env, i, a: (
        env.t(i[0]).squeeze() if _axes_arg(i, env, a) is None
        else env.t(i[0]).squeeze(tuple(_axes_arg(i, env, a))))
    e["Unsqueeze"] = lambda env, i, a: _unsqueeze(env.t(i[0]), _axes_arg(i, env, a))
    e["Gather"] = _gather
    e["GatherElements"] = lambda env, i, a: torch.gather(
        env.t(i[0]), int(a.get("axis", 0)),
        _index(env.t(i[1]), env.t(i[0]).shape[int(a.get("axis", 0))]))
    e["GatherND"] = lambda env, i, a: _gather_nd(
        env.t(i[0]), env.t(i[1]), int(a.get("batch_dims", 0)))
    e["Cast"] = lambda env, i, a: env.t(i[0]).to(_TORCH_DTYPES[_CAST[int(a["to"])]])
    e["CastLike"] = lambda env, i, a: env.t(i[0]).to(env.t(i[1]).dtype)
    e["ReduceMean"] = lambda env, i, a: _reduce(
        lambda x, d, k: x.mean(dim=d, keepdim=k), env.t(i[0]), _axes_arg(i, env, a),
        a.get("keepdims", 1))
    e["ReduceSum"] = lambda env, i, a: _reduce(
        lambda x, d, k: x.sum(dim=d, keepdim=k), env.t(i[0]), _axes_arg(i, env, a),
        a.get("keepdims", 1))
    e["ReduceMax"] = lambda env, i, a: _reduce(
        lambda x, d, k: x.amax(dim=d, keepdim=k), env.t(i[0]), _axes_arg(i, env, a),
        a.get("keepdims", 1))
    e["ReduceMin"] = lambda env, i, a: _reduce(
        lambda x, d, k: x.amin(dim=d, keepdim=k), env.t(i[0]), _axes_arg(i, env, a),
        a.get("keepdims", 1))
    e["ReduceProd"] = lambda env, i, a: _reduce(
        _prod, env.t(i[0]), _axes_arg(i, env, a), a.get("keepdims", 1))
    e["ReduceL2"] = lambda env, i, a: _reduce(
        lambda x, d, k: x.square().sum(dim=d, keepdim=k).sqrt(),
        env.t(i[0]).float(), _axes_arg(i, env, a), a.get("keepdims", 1))
    e["LpNormalization"] = lambda env, i, a: env.t(i[0]) / torch.linalg.vector_norm(
        env.t(i[0]).float(), ord=int(a.get("p", 2)), dim=int(a.get("axis", -1)),
        keepdim=True).to(env.t(i[0]).dtype)
    e["ArgMax"] = lambda env, i, a: _arg_minmax(torch.argmax, env.t(i[0]), a)
    e["ArgMin"] = lambda env, i, a: _arg_minmax(torch.argmin, env.t(i[0]), a)
    e["Shape"] = lambda env, i, a: np.asarray(
        tuple(env[i[0]].shape)[int(a.get("start", 0)):
                               (int(a["end"]) if "end" in a else None)], dtype=np.int64)
    e["Size"] = lambda env, i, a: np.asarray(int(np.prod(tuple(env[i[0]].shape))), np.int64)
    e["Range"] = lambda env, i, a: torch.arange(
        _static_scalar(env[i[0]], "Range start"),
        _static_scalar(env[i[1]], "Range limit"),
        _static_scalar(env[i[2]], "Range delta"), device=env.device)
    e["ConstantOfShape"] = lambda env, i, a: np.full(
        tuple(_static_ints(env[i[0]], "ConstantOfShape")),
        a["value"].reshape(()) if "value" in a else np.float32(0))
    e["Trilu"] = lambda env, i, a: (torch.tril if int(a.get("upper", 1)) == 0 else torch.triu)(
        env.t(i[0]), 0 if len(i) < 2 or not i[1] else int(_static_scalar(env[i[1]], "Trilu k")))
    e["Einsum"] = lambda env, i, a: torch.einsum(
        a["equation"].decode() if isinstance(a["equation"], bytes) else a["equation"],
        *[env.t(n) for n in i])
    e["Conv"] = lambda env, i, a: _conv(
        env.t(i[0]), env.t(i[1]), env.t(i[2]) if len(i) > 2 and i[2] else None, a)
    e["MaxPool"] = lambda env, i, a: _pool(env.t(i[0]), a, "max")
    e["AveragePool"] = lambda env, i, a: _pool(env.t(i[0]), a, "avg")
    e["GlobalAveragePool"] = lambda env, i, a: env.t(i[0]).mean(
        dim=tuple(range(2, env.t(i[0]).ndim)), keepdim=True)
    e["LayerNormalization"] = _layer_norm
    e["BatchNormalization"] = _batch_norm
    e["Pad"] = _pad_op
    e["Split"] = _split
    return e


_PAD_MODES = {"constant", "reflect", "edge", "wrap"}


def _pad_op(env, inputs, attrs):
    x = env.t(inputs[0])
    mode = attrs.get("mode", b"constant")
    mode = mode.decode() if isinstance(mode, bytes) else mode
    if mode not in _PAD_MODES:
        raise WeightError(f"Pad mode '{mode}' not supported")
    pads = _static_ints(env[inputs[1]], "Pad pads")
    pairs = [(0, 0)] * x.ndim
    if len(inputs) > 3 and inputs[3]:
        # opset-18 optional axes input: pads applies to these axes only
        axes = [ax % x.ndim for ax in _static_ints(env[inputs[3]], "Pad axes")]
        n = len(axes)
        for j, ax in enumerate(axes):
            pairs[ax] = (pads[j], pads[j + n])
    else:
        pairs = [(pads[k], pads[k + x.ndim]) for k in range(x.ndim)]
    if mode == "constant":
        value = (0 if len(inputs) < 3 or not inputs[2]
                 else _static_scalar(env[inputs[2]], "Pad value"))
        return F.pad(x, [p for lo, hi in reversed(pairs) for p in (lo, hi)], value=value)
    # the other modes index each padded axis with numpy's own index map
    for ax, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(ax, env.const(np.pad(np.arange(x.shape[ax]), (lo, hi), mode=mode)))
    return x


def _split(env, inputs, attrs):
    x = env.t(inputs[0])
    axis = int(attrs.get("axis", 0))
    if len(inputs) > 1 and inputs[1]:
        sizes = _static_ints(env[inputs[1]], "Split sizes")
    elif "split" in attrs:
        sizes = list(attrs["split"])
    else:
        n = int(attrs["num_outputs"])
        base = -(-x.shape[axis] // n)
        sizes = [base] * (n - 1) + [x.shape[axis] - base * (n - 1)]
    return tuple(torch.split(x, sizes, dim=axis))


_OPS = _resolve_ops()

_MULTI_OUTPUT = {"Split"}


# --------------------------------------------------------------------------
# Host-side constant folding: a node whose inputs are all host constants
# evaluates with numpy, keeping the whole shape chain concrete.
# --------------------------------------------------------------------------

def _np_div(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if np.issubdtype(a.dtype, np.integer) and np.issubdtype(b.dtype, np.integer):
        # ONNX int Div truncates toward zero
        return (np.sign(a) * np.sign(b) * (np.abs(a) // np.abs(b))).astype(a.dtype)
    return np.divide(a, b)


def _np_reshape(env, i, a):
    x = np.asarray(env[i[0]])
    shape = [int(s) for s in np.asarray(env[i[1]]).reshape(-1)]
    out = [x.shape[k] if s == 0 and not int(a.get("allowzero", 0)) else s
           for k, s in enumerate(shape)]
    return x.reshape(out)


def _np_expand(env, i):
    x = np.asarray(env[i[0]])
    shape = [int(s) for s in np.asarray(env[i[1]]).reshape(-1)]
    nd = max(x.ndim, len(shape))
    xs = (1,) * (nd - x.ndim) + x.shape
    sh = [1] * (nd - len(shape)) + list(shape)
    target = tuple(max(a_, b_) for a_, b_ in zip(xs, sh))
    return np.broadcast_to(x.reshape(xs), target)


_NP_FOLD: dict[str, Callable] = {
    "Identity": lambda env, i, a: env[i[0]],
    "Add": lambda env, i, a: np.add(env[i[0]], env[i[1]]),
    "Sub": lambda env, i, a: np.subtract(env[i[0]], env[i[1]]),
    "Mul": lambda env, i, a: np.multiply(env[i[0]], env[i[1]]),
    "Div": lambda env, i, a: _np_div(env[i[0]], env[i[1]]),
    "Mod": lambda env, i, a: (np.fmod if int(a.get("fmod", 0)) else np.mod)(
        env[i[0]], env[i[1]]),
    "Neg": lambda env, i, a: np.negative(env[i[0]]),
    "Abs": lambda env, i, a: np.abs(env[i[0]]),
    "Floor": lambda env, i, a: np.floor(env[i[0]]),
    "Ceil": lambda env, i, a: np.ceil(env[i[0]]),
    "Sqrt": lambda env, i, a: np.sqrt(env[i[0]]),
    "Min": lambda env, i, a: functools.reduce(np.minimum, (env[n] for n in i)),
    "Max": lambda env, i, a: functools.reduce(np.maximum, (env[n] for n in i)),
    "Equal": lambda env, i, a: np.equal(env[i[0]], env[i[1]]),
    "Greater": lambda env, i, a: np.greater(env[i[0]], env[i[1]]),
    "Less": lambda env, i, a: np.less(env[i[0]], env[i[1]]),
    "Not": lambda env, i, a: np.logical_not(env[i[0]]),
    "Where": lambda env, i, a: np.where(env[i[0]], env[i[1]], env[i[2]]),
    "Cast": lambda env, i, a: np.asarray(env[i[0]]).astype(_CAST[int(a["to"])]),
    "Concat": lambda env, i, a: np.concatenate(
        [np.atleast_1d(np.asarray(env[n])) for n in i], axis=int(a["axis"])),
    "Gather": lambda env, i, a: np.take(
        np.asarray(env[i[0]]), np.asarray(env[i[1]]), axis=int(a.get("axis", 0))),
    "Unsqueeze": lambda env, i, a: np.expand_dims(
        np.asarray(env[i[0]]), tuple(_axes_arg(i, env, a))),
    "Squeeze": lambda env, i, a: np.squeeze(
        np.asarray(env[i[0]]),
        axis=None if _axes_arg(i, env, a) is None else tuple(_axes_arg(i, env, a))),
    "Reshape": _np_reshape,
    "Slice": _slice_op,  # pure indexing — stays numpy on numpy inputs
    "Transpose": lambda env, i, a: np.transpose(np.asarray(env[i[0]]), a.get("perm")),
    "Range": lambda env, i, a: np.arange(
        np.asarray(env[i[0]]).reshape(()),
        np.asarray(env[i[1]]).reshape(()),
        np.asarray(env[i[2]]).reshape(())),
    "ConstantOfShape": lambda env, i, a: np.full(
        tuple(int(x) for x in np.asarray(env[i[0]]).reshape(-1)),
        a["value"].reshape(()) if "value" in a else np.float32(0)),
    "ReduceProd": lambda env, i, a: np.prod(
        np.asarray(env[i[0]]),
        axis=None if _axes_arg(i, env, a) is None else tuple(_axes_arg(i, env, a)),
        keepdims=bool(a.get("keepdims", 1))),
    "Expand": lambda env, i, a: _np_expand(env, i),
}


def _int8_matmul(env, inputs: list[str]) -> torch.Tensor:
    """Quantized MatMul against a weight ``OnnxTower`` quantized at load:
    dynamic per-row activation quant → exact int8 product → dequant, the
    W8A8 scheme of ``ops.quant.int8_linear`` (any-rank lhs)."""
    from .ops.quant import int8_linear

    return int8_linear({"w_q": env[inputs[1] + "#q"], "w_scale": env[inputs[1] + "#scale"]},
                       env.t(inputs[0]))


# FLOPs-heavy ops eligible for compute-dtype casting. Only the first two
# inputs (data × weight) are cast — biases and everything around the op
# stay in the graph's exported dtype.
_AUTOCAST_OPS = frozenset({"MatMul", "Gemm", "Conv"})


def _autocast(env, op_type: str, inputs: list[str], attrs, compute_dtype) -> Value:
    x = env.t(inputs[0])
    if not x.is_floating_point():
        return _OPS[op_type](env, inputs, attrs)
    local = _Env(env.device, env.consts)
    local.update(env)
    for n in inputs[:2]:
        a = env.t(n)
        if a.is_floating_point():
            local[n] = a.to(compute_dtype)
    # the products accumulate in f32; the result re-enters the graph in the
    # exported dtype
    return _OPS[op_type](local, inputs, attrs).to(x.dtype)


def _constant(attrs) -> np.ndarray:
    val = attrs.get("value")
    if val is not None:
        return val
    for key, dt in (("value_int", np.int64), ("value_ints", np.int64),
                    ("value_float", np.float32), ("value_floats", np.float32)):
        if key in attrs:
            return np.asarray(attrs[key], dt)
    raise WeightError("ONNX executor: unsupported Constant")


def execute_graph(g: OnnxGraph, feeds: dict[str, Value],
                  params: dict[str, Value] | None = None, *,
                  device: torch.device | str = "cpu",
                  compute_dtype: torch.dtype | None = None,
                  quant: frozenset = frozenset(),
                  outer: dict[str, Value] | None = None,
                  consts: dict | None = None) -> list[Value]:
    """Run the graph on the given input feeds; returns the graph outputs.

    ``params`` overrides the initializer values (``OnnxTower`` passes its
    device copies); defaults to the graph's own initializers. ``outer``:
    the enclosing graph's values, for an ``If`` branch — the branch's own
    initializers shadow them. ``compute_dtype`` and ``quant``: see the
    module docstring. ``consts``: the device tensors of static values
    already made (``_Env.const``; ``OnnxTower`` keeps one for its calls).
    """
    env = _Env(torch.device(device), consts)
    if outer:
        env.update(outer)
    env.update(g.initializers)
    if params:
        env.update(params)
    env.update(feeds)

    for op_type, inputs, outputs, attrs in g.nodes:
        if op_type == "If":
            # torch exports guard shape-dependent paths with If over a
            # statically-foldable condition; the executor runs the chosen
            # branch (a subgraph capturing outer values by name). A
            # condition computed on the device is rejected.
            cond = env.get(inputs[0])
            if not _is_static(cond):
                raise WeightError(
                    "ONNX executor: 'If' with a non-static condition "
                    f"(outputs {outputs[:1]})")
            branch = attrs.get("then_branch" if bool(np.asarray(cond).reshape(()))
                               else "else_branch")
            if branch is None or not getattr(branch, "nodes", None):
                raise WeightError(
                    f"ONNX executor: 'If' branch subgraph missing (outputs {outputs[:1]})")
            results = execute_graph(branch, {}, device=env.device, compute_dtype=compute_dtype,
                                    quant=quant, outer=env, consts=env.consts)
            for name, r in zip(outputs, results):
                env[name] = r
            continue
        if op_type == "MatMul" and inputs[1] in quant and not _is_static(env.get(inputs[0])):
            env[outputs[0]] = _int8_matmul(env, inputs)
            continue
        if op_type == "Constant":
            env[outputs[0]] = _constant(attrs)
            continue
        fn = _OPS.get(op_type)
        if fn is None and op_type not in _NP_FOLD:
            raise WeightError(
                f"ONNX executor: unsupported op '{op_type}' (outputs {outputs[:1]})")
        missing = [n for n in inputs if n and n not in env]
        if missing:
            raise WeightError(f"ONNX executor: {op_type} consumes undefined values {missing}")
        if op_type in _NP_FOLD and all(
                isinstance(env[n], np.ndarray) or np.isscalar(env[n]) for n in inputs if n):
            result = _NP_FOLD[op_type](env, inputs, attrs)
        elif compute_dtype is not None and op_type in _AUTOCAST_OPS:
            result = _autocast(env, op_type, inputs, attrs, compute_dtype)
        else:
            result = fn(env, inputs, attrs)
        if op_type in _MULTI_OUTPUT:
            for name, r in zip(outputs, result):
                env[name] = r
        else:
            env[outputs[0]] = result

    missing_outs = [n for n in g.outputs if n not in env]
    if missing_outs:
        raise WeightError(f"ONNX executor: graph outputs {missing_outs} were never produced")
    return [env[n] for n in g.outputs]


class OnnxCfg:
    """The ``TowerSpec`` payload of the executor family: the graph by path
    + (mtime, size) + execution mode, so the tower cache can't serve a
    stale parse after the file changes or for another mode."""

    def __init__(self, path: str, *, compute_dtype: str | None = None,
                 quantize: bool = False):
        self.path = str(path)
        self.compute_dtype = compute_dtype  # dtype NAME ("bfloat16") or None
        self.quantize = bool(quantize)
        st = Path(path).stat()
        self._key = (self.path, st.st_mtime_ns, st.st_size, compute_dtype, self.quantize)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, OnnxCfg) and self._key == other._key

    def __repr__(self):
        return (f"OnnxCfg({self.path!r}, compute_dtype={self.compute_dtype!r}, "
                f"quantize={self.quantize})")


def fallback_cfg(path, *, dtype: torch.dtype | None = None,
                 quantize: str | None = None) -> OnnxCfg:
    """Map the embedder-level ``dtype``/``quantize`` knobs onto the executor
    spec: a sub-f32 float dtype becomes the MatMul/Gemm/Conv compute dtype
    (the graph itself stays in its exported dtype), and ``"int8"`` /
    ``"int8_all"`` turn on W8A8 MatMuls (the executor has no MLP-vs-attention
    split — every eligible MatMul weight quantizes in both modes)."""
    name = None
    if dtype is not None and dtype.is_floating_point and dtype.itemsize < 4:
        name = str(dtype).removeprefix("torch.")
    return OnnxCfg(str(path), compute_dtype=name, quantize=quantize in ("int8", "int8_all"))


_TOWER_CACHE: dict[tuple, "OnnxTower"] = {}
_TOWER_CACHE_MAX = 8  # parsed graphs hold every initializer: evict LRU, so
# stale entries (a regenerated .onnx with a new mtime) don't pin memory


def get_tower(cfg: OnnxCfg, device: torch.device | str = "cpu") -> "OnnxTower":
    """Parse-once LRU cache of ``OnnxTower``s keyed by ``OnnxCfg`` identity
    (path, mtime, size, execution mode) and device."""
    key = cfg._key + (str(torch.device(device)),)
    tower = _TOWER_CACHE.pop(key, None)
    if tower is None:
        tower = OnnxTower(cfg.path, device=device, quantize=cfg.quantize,
                          compute_dtype=None if cfg.compute_dtype is None
                          else getattr(torch, cfg.compute_dtype))
    _TOWER_CACHE[key] = tower  # (re-)insert as most recent
    while len(_TOWER_CACHE) > _TOWER_CACHE_MAX:
        _TOWER_CACHE.pop(next(iter(_TOWER_CACHE)))
    return tower


def load_tower(cfg: OnnxCfg, device: torch.device | str) -> "OnnxTower":
    """``get_tower`` for an embedder: a quantized mode that finds nothing to
    quantize raises ``ConfigError`` (a silent no-op would hide the slow
    path), as the JAX package's loaders do."""
    tower = get_tower(cfg, device)
    if cfg.quantize and not tower.quant_names:
        raise ConfigError("int8 quantization found no quantizable (MatMul) "
                          f"initializers in {cfg.path}")
    return tower


# a MatMul rhs must be at least this wide/deep before W8A8 pays for the
# activation quant passes
_QUANT_MIN_DIM = 64


class OnnxTower:
    """A tower served directly from its ONNX graph (the executor family).

    Loads the graph once and keeps its float initializers on ``device`` (in
    the exported dtype; integer ones stay host constants); ``tower(feeds)``
    returns the graph's first output. ``compute_dtype`` casts the
    MatMul/Gemm/Conv operands (f32 accumulation); ``quantize`` turns every
    2-D float initializer consumed only as a MatMul rhs into per-output-
    channel int8 (W8A8 with dynamic activation scales, ``ops.quant``'s
    scheme). ``graph``: the parsed file, where the caller has it.
    """

    def __init__(self, path: Path | str, *, device: torch.device | str = "cpu",
                 compute_dtype: torch.dtype | None = None, quantize: bool = False,
                 graph: OnnxGraph | None = None):
        self.path = Path(path)
        self.device = torch.device(device)
        self.graph = read_onnx(self.path) if graph is None else graph
        if not self.graph.inputs:
            raise WeightError(f"No graph inputs found in {self.path}")
        self.input_names = [n for n in self.graph.inputs if n not in self.graph.initializers]
        self.params: dict[str, Value] = {
            k: _tensor(v, self.device) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in self.graph.initializers.items()}
        self.compute_dtype = compute_dtype
        self.quant_names: frozenset[str] = frozenset()
        if quantize:
            self.quant_names = self._quantize_params()
        self._consts: dict = {}  # the device tensors of static values (``_Env.const``)

    def _quantize_params(self) -> frozenset:
        from .ops.quant import quantize_weight

        # eligible = consumed ONLY as a MatMul rhs (a weight shared with a
        # Gemm/Transpose/etc. must stay float for those consumers)
        usage: dict[str, bool] = {}
        for op_type, inputs, _, _ in self.graph.nodes:
            for idx, n in enumerate(inputs):
                if n in self.graph.initializers:
                    usage[n] = usage.get(n, True) and op_type == "MatMul" and idx == 1
        quantized = []
        for name, ok in usage.items():
            w = self.graph.initializers[name]
            if not (ok and w.ndim == 2 and np.issubdtype(w.dtype, np.floating)
                    and min(w.shape) >= _QUANT_MIN_DIM):
                continue
            q = quantize_weight(self.params.pop(name))
            self.params[name + "#q"] = q["w_q"]
            self.params[name + "#scale"] = q["w_scale"]
            quantized.append(name)
        return frozenset(quantized)

    def __call__(self, feeds: dict[str, Value]) -> torch.Tensor:
        outs = execute_graph(self.graph, feeds, params=self.params, device=self.device,
                             compute_dtype=self.compute_dtype, quant=self.quant_names,
                             consts=self._consts)
        return _Env(self.device, self._consts).const(outs[0])

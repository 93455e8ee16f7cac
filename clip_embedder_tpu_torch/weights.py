"""Parameters: the native npz weight format, numpy → torch conversion, and
load-time validation of a tower's weight tree.

Layout (the JAX package's, kept as it is so that the same ``visual.npz`` /
``text.npz`` files load in both and the kernels read the weights directly):

* a linear is ``{"w": [in, out], "b": [out]}`` — ``w`` is the transpose of
  ``torch.nn.Linear.weight``; ``y = x @ w + b``;
* a LayerNorm is ``{"scale": [d], "bias": [d]}``;
* the per-layer transformer blocks are stacked on axis 0 (``blocks/...``
  leaves have a leading [layers] axis); the towers unstack them into an
  ``nn.ModuleList`` of views, one block each;
* the npz holds a flat map of '/'-joined key paths.

Floating leaves take the requested dtype, except int8 dequantization
scales (``w_scale``), which stay f32.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch import nn

from .errors import WeightError
from .ops.quant import kmajor


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict/list tree."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _to_numpy(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:  # numpy has no bf16
            a = a.to(torch.float32)
        return a.numpy()
    return np.asarray(a)


def save_pytree(path: Path | str, tree: Mapping) -> None:
    """Write a tree (of tensors or arrays) as a flat npz of key paths."""
    np.savez(path, **{k: _to_numpy(v) for k, v in _flatten(tree).items()})


def _relistify(node):
    """A dict whose keys are all decimal strings was a list before
    flattening."""
    if not isinstance(node, dict):
        return node
    node = {k: _relistify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[k] for k in sorted(node, key=int)]
    return node


def params_from_numpy(tree: Any, *, device: torch.device | str,
                      dtype: torch.dtype) -> Any:
    """A tree of arrays (numpy, or anything ``np.asarray`` takes — e.g. the
    JAX package's parameters) → the same tree of tensors on ``device``, as
    ``to_device_tree`` types them."""
    def conv(a):
        arr = np.asarray(a)
        if np.issubdtype(arr.dtype, np.floating) and arr.dtype not in (np.float32, np.float64):
            arr = arr.astype(np.float32)
        return torch.tensor(arr)  # a copy: npz and JAX arrays are read-only

    return to_device_tree(tree_map(conv, tree), device=device, dtype=dtype)


def to_device_tree(tree: Any, *, device: torch.device | str, dtype: torch.dtype) -> Any:
    """A tree of tensors → the same tree on ``device``, floating leaves in
    ``dtype`` except the int8 dequantization scales (``w_scale``), which
    stay f32 (rounding them to bf16 would add a systematic per-channel
    error on top of the int8 budget); integer leaves (``w_q``) keep their
    dtype and are stored K-major (``ops.quant.kmajor``: a tree that arrives
    quantized elsewhere, e.g. from numpy, gets the kernels' layout too).
    Counterpart of the JAX package's ``vision.to_device_tree``."""
    def walk(node, key):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, None) for v in node]
        if not node.is_floating_point():
            node = node.to(device=device)
            return kmajor(node) if key == "w_q" and node.dim() >= 2 else node
        return node.to(device=device, dtype=torch.float32 if key == "w_scale" else dtype)

    return walk(tree, None)


def load_pytree(path: Path | str, *, device: torch.device | str,
                dtype: torch.dtype) -> dict:
    """Read a native npz weight file into a tree of tensors on ``device``."""
    try:
        data_ctx = np.load(path)
    except Exception as e:  # zipfile.BadZipFile / OSError / ValueError
        raise WeightError(f"Failed to read weight file '{path}': {e}") from e
    with data_ctx as data:
        tree: dict = {}
        for key in data.files:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return params_from_numpy(_relistify(tree), device=device, dtype=dtype)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: dict leaves become (frozen)
    parameters or buffers, dict nodes child ``ParamTree``s, so ``.to()``,
    ``state_dict()`` and ``parameters()`` see every weight. Reads like the
    dict it was built from (``p["w"]``, ``"b" in p``, ``p.get("b")``), which
    is what the ops take."""

    def __init__(self, tree: Mapping):
        super().__init__()
        self._names: tuple[str, ...] = tuple(tree)
        for key, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(key, ParamTree(val))
            elif val.is_floating_point():
                self.register_parameter(key, nn.Parameter(val, requires_grad=False))
            else:
                self.register_buffer(key, val)

    def __getitem__(self, key: str):
        if key not in self._names:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: object) -> bool:
        return key in self._names

    def get(self, key: str, default=None):
        return self[key] if key in self._names else default

    def keys(self) -> tuple[str, ...]:
        return self._names


def unstack(tree: Mapping, i: int) -> dict:
    """Layer ``i`` of a tree stacked on axis 0 (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


def _flat_shapes(tree: Any) -> dict[str, tuple]:
    return {k: tuple(v.shape) for k, v in _flatten(tree).items()}


def _family_init(family: str):
    """The family's ``init(cfg, ...)`` — the canonical tree layout."""
    if family == "vit":
        from .models import vit
        return vit.init
    if family == "text_transformer":
        from .models import text_transformer
        return text_transformer.init
    if family == "hf_bert":
        from .models import hf_text
        return hf_text.init
    return None


def validate_tower_pytree(params: Mapping, spec, *, source) -> None:
    """Check a loaded weight tree against the family's canonical layout —
    the shapes of its ``init`` on the meta device (no memory, no FLOPs) —
    so a mismatched file fails here as a typed ``WeightError`` naming the
    offending paths, not inside the forward. Shapes only; dtype is a
    load-time knob. A missing bias beside a correct weight is allowed
    (biases are optional by the ops contract)."""
    init = _family_init(spec.family)
    if init is None:
        return
    expected = _flat_shapes(init(spec.cfg, device="meta"))
    got = _flat_shapes(params)

    def optional_bias(k: str) -> bool:
        head, _, leaf = k.rpartition("/")
        if leaf != "b":
            return False
        sib = f"{head}/w" if head else "w"
        return sib in got and got[sib] == expected.get(sib)

    missing = sorted(k for k in set(expected) - set(got) if not optional_bias(k))
    unexpected = sorted(set(got) - set(expected))
    wrong = sorted(k for k in set(got) & set(expected) if got[k] != expected[k])
    if not (missing or unexpected or wrong):
        return

    def head(items, fmt):
        shown = [fmt(k) for k in items[:5]]
        if len(items) > 5:
            shown.append(f"... +{len(items) - 5} more")
        return ", ".join(shown)

    parts = []
    if missing:
        parts.append(f"missing: {head(missing, str)}")
    if unexpected:
        parts.append(f"unexpected: {head(unexpected, str)}")
    if wrong:
        parts.append("shape mismatch: " + head(
            wrong, lambda k: f"{k} {got[k]} != {expected[k]}"))
    raise WeightError(
        f"Weight tree from {source} does not match the '{spec.family}' "
        f"tower layout — {'; '.join(parts)}")


# -- state-dict helpers (torch checkpoints → the layout above, numpy) --------

def _t(w) -> np.ndarray:
    """torch Linear [out, in] → [in, out]."""
    return np.ascontiguousarray(np.asarray(w).T)


def _get(sd: Mapping[str, Any], key: str) -> np.ndarray:
    if key not in sd:
        raise WeightError(f"Missing weight '{key}' in checkpoint")
    return np.asarray(sd[key])


def _ln(sd, prefix: str) -> dict:
    return {"scale": _get(sd, f"{prefix}.weight"), "bias": _get(sd, f"{prefix}.bias")}


def _linear(sd, prefix: str, *, bias: bool = True) -> dict:
    p = {"w": _t(_get(sd, f"{prefix}.weight"))}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = np.asarray(sd[f"{prefix}.bias"])
    return p


def _stack_blocks(blocks: list) -> Any:
    """Per-layer trees → one tree with the leaves stacked on a new axis 0."""
    if isinstance(blocks[0], Mapping):
        return {k: _stack_blocks([b[k] for b in blocks]) for k in blocks[0]}
    return np.stack([np.asarray(b) for b in blocks])


def strip_prefix(sd: Mapping[str, Any], *prefixes: str) -> dict:
    """Drop a leading module prefix (e.g. an export wrapper's ``model.``)
    from every key that has it, where any key has it."""
    out = dict(sd)
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in out):
            out = {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in out.items()}
    return out


def _max_index(sd: Mapping[str, Any], pattern: str) -> int:
    rx = re.compile(pattern)
    idx = [int(m.group(1)) for k in sd if (m := rx.match(k))]
    if not idx:
        raise WeightError(f"No blocks matching '{pattern}' in checkpoint")
    return max(idx) + 1

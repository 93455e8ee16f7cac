"""Parameters: the native npz weight format, numpy → torch conversion,
load-time validation of a tower's weight tree, and the state-dict mappers
that turn an open_clip / timm / Meta PE / HF BERT checkpoint into that
format (``map_state_dict``; numpy in, numpy out, as in the JAX package).

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


def _conv_to_patch(w) -> np.ndarray:
    """torch Conv2d patch kernel [D, C, P, P] → [P·P·C, D], the (py, px, c)
    flatten order of the ViT's patchify."""
    w = np.asarray(w)
    d = w.shape[0]
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0).reshape(-1, d))


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


def _split_qkv(w, b) -> dict:
    """Packed [3D, D] qkv (+bias) → separate q/k/v linear trees."""
    d = w.shape[0] // 3
    out: dict = {}
    for i, name in enumerate(("q", "k", "v")):
        p = {"w": _t(w[i * d: (i + 1) * d])}
        if b is not None:
            p["b"] = np.asarray(b[i * d: (i + 1) * d])
        out[name] = p
    return out


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


def fold_bn_affine(gamma, beta, mean, var, *, eps: float = 1e-5):
    """Inference BatchNorm fold → per-channel affine (f64 intermediate):
    ``scale = γ/√(var+ε)``, ``bias = β − mean·scale`` (the FastViT and
    ResNet mappers' fold)."""
    gamma = np.asarray(gamma, np.float64)
    beta = np.asarray(beta, np.float64)
    scale = gamma / np.sqrt(np.asarray(var, np.float64) + eps)
    bias = beta - np.asarray(mean, np.float64) * scale
    return scale, bias


def _select_prefix(sd: Mapping[str, Any], prefix: str) -> dict:
    """Where ``prefix`` exists, keep only the prefixed keys (stripped). A
    whole-model classic-CLIP dict has its text tower at top level
    (``transformer.resblocks.*``): stripping ``visual.`` without dropping
    the rest would let the text keys overwrite the visual ones."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return dict(sd)


# -- classic open_clip towers (CLIP ViT + text transformer) ------------------

def _openclip_resblock(sd, prefix: str) -> dict:
    attn = _split_qkv(_get(sd, f"{prefix}.attn.in_proj_weight"),
                      sd.get(f"{prefix}.attn.in_proj_bias"))
    attn["out"] = _linear(sd, f"{prefix}.attn.out_proj")
    return {
        "ln1": _ln(sd, f"{prefix}.ln_1"),
        "attn": attn,
        "ln2": _ln(sd, f"{prefix}.ln_2"),
        "mlp": {"fc": _linear(sd, f"{prefix}.mlp.c_fc"),
                "proj": _linear(sd, f"{prefix}.mlp.c_proj")},
    }


def map_clip_visual(sd: Mapping[str, Any]) -> dict:
    """Classic open_clip VisionTransformer state dict (``visual.*``, or
    already stripped to ``conv1`` etc.) → ViT tree, with CoCa's
    attentional pooler where the dict has one."""
    sd = _select_prefix(strip_prefix(sd, "model."), "visual.")
    n_blocks = _max_index(sd, r"transformer\.resblocks\.(\d+)\.ln_1\.weight")
    blocks = [_openclip_resblock(sd, f"transformer.resblocks.{i}") for i in range(n_blocks)]
    params: dict = {
        "patch_embed": {"w": _conv_to_patch(_get(sd, "conv1.weight"))},
        "cls_token": np.asarray(_get(sd, "class_embedding")).reshape(1, 1, -1),
        "pos_embed": np.asarray(_get(sd, "positional_embedding"))[None],
        "ln_pre": _ln(sd, "ln_pre"),
        "blocks": _stack_blocks(blocks),
        "ln_post": _ln(sd, "ln_post"),
    }
    if "conv1.bias" in sd:
        params["patch_embed"]["b"] = np.asarray(sd["conv1.bias"])
    if "attn_pool.query" in sd:
        # CoCa's AttentionalPooler: queries in embed-dim space, MHA with
        # kdim = vdim = width, so torch keeps separate q/k/v_proj_weight and
        # one [3·dm] in_proj_bias (it packs in_proj only when they match)
        dm = np.asarray(sd["attn_pool.query"]).shape[-1]
        if "attn_pool.attn.in_proj_weight" in sd:
            pool_attn = _split_qkv(_get(sd, "attn_pool.attn.in_proj_weight"),
                                   sd.get("attn_pool.attn.in_proj_bias"))
        else:
            b = sd.get("attn_pool.attn.in_proj_bias")
            pool_attn = {}
            for i, name in enumerate(("q", "k", "v")):
                p = {"w": _t(_get(sd, f"attn_pool.attn.{name}_proj_weight"))}
                if b is not None:
                    p["b"] = np.asarray(b[i * dm:(i + 1) * dm])
                pool_attn[name] = p
        pool_attn["out"] = _linear(sd, "attn_pool.attn.out_proj")
        params["attn_pool"] = {
            "query": np.asarray(sd["attn_pool.query"]),
            "ln_q": _ln(sd, "attn_pool.ln_q"),
            "ln_k": _ln(sd, "attn_pool.ln_k"),
            "attn": pool_attn,
        }
    if "proj" in sd:
        params["proj"] = {"w": np.asarray(sd["proj"])}  # stored [width, embed]
    return params


def _pick(sd, *prefixes: str) -> str:
    """The first prefix whose ``.weight`` is in ``sd``, else a WeightError."""
    for p in prefixes:
        if f"{p}.weight" in sd:
            return p
    raise WeightError(
        f"None of {prefixes} found in checkpoint (keys near: "
        f"{sorted(k for k in sd if k.startswith(prefixes[0].split('.')[0]))[:8]})")


def map_pe_visual(sd: Mapping[str, Any]) -> dict:
    """Meta Perception Encoder (PE-Core) vision state dict (CLIP-lineage
    naming: ``conv1``, ``transformer.resblocks.N`` with optional
    ``ls_1/ls_2.gamma``, ``attn_pool.{probe, attn, layernorm, mlp}``,
    ``proj``) → ViT tree."""
    sd = _select_prefix(strip_prefix(sd, "model."), "visual.")
    n_blocks = _max_index(sd, r"transformer\.resblocks\.(\d+)\.ln_1\.weight")
    blocks = []
    for i in range(n_blocks):
        prefix = f"transformer.resblocks.{i}"
        block = _openclip_resblock(sd, prefix)
        for ours, theirs in (("ls1", "ls_1"), ("ls2", "ls_2")):
            if f"{prefix}.{theirs}.gamma" in sd:
                block[ours] = np.asarray(sd[f"{prefix}.{theirs}.gamma"])
        blocks.append(block)

    pos = np.asarray(_get(sd, "positional_embedding"))
    if pos.ndim == 2:
        pos = pos[None]
    params: dict = {
        "patch_embed": {"w": _conv_to_patch(_get(sd, "conv1.weight"))},
        "pos_embed": pos,
        "blocks": _stack_blocks(blocks),
        "ln_post": _ln(sd, "ln_post"),
    }
    if "conv1.bias" in sd:
        params["patch_embed"]["b"] = np.asarray(sd["conv1.bias"])
    if "class_embedding" in sd:
        params["cls_token"] = np.asarray(sd["class_embedding"]).reshape(1, 1, -1)
    if "ln_pre.weight" in sd:
        params["ln_pre"] = _ln(sd, "ln_pre")
    if "attn_pool.probe" in sd:
        pool_attn = _split_qkv(_get(sd, "attn_pool.attn.in_proj_weight"),
                               sd.get("attn_pool.attn.in_proj_bias"))
        pool_attn["out"] = _linear(sd, "attn_pool.attn.out_proj")
        params["attn_pool"] = {
            "probe": np.asarray(sd["attn_pool.probe"]).reshape(1, 1, -1),
            "attn": pool_attn,
            "ln": _ln(sd, _pick(sd, "attn_pool.layernorm", "attn_pool.norm", "attn_pool.ln")),
            "mlp": {
                "fc": _linear(sd, _pick(sd, "attn_pool.mlp.c_fc", "attn_pool.mlp.fc1")),
                "proj": _linear(sd, _pick(sd, "attn_pool.mlp.c_proj", "attn_pool.mlp.fc2")),
            },
        }
    if "proj" in sd:
        params["proj"] = {"w": np.asarray(sd["proj"])}  # stored [width, embed]
    elif "proj.weight" in sd:
        params["proj"] = _linear(sd, "proj")
    return params


def derive_pe_cfg_from_sd(sd: Mapping[str, Any]) -> dict:
    """PE-Core dims from a checkpoint's shapes, so a conversion never leans
    on the size table (``models.build._PE_CORE_SIZES``) for a field the
    checkpoint fixes. ``heads`` is not shape-derivable (the packed in_proj
    is [3w, w] for any head count) and stays table- or override-seeded.
    Raises WeightError when the dict is not a PE-Core-shaped ViT."""
    sd = _select_prefix(strip_prefix(sd, "model."), "visual.")
    conv1 = sd.get("conv1.weight")
    if conv1 is None or np.asarray(conv1).ndim != 4 or np.asarray(conv1).shape[1] != 3:
        raise WeightError("state dict has no [width, 3, p, p] patch conv (conv1.weight)")
    width = int(np.asarray(conv1).shape[0])
    patch = int(np.asarray(conv1).shape[2])
    layers = _max_index(sd, r"transformer\.resblocks\.(\d+)\.ln_1\.weight")
    fc = sd.get("transformer.resblocks.0.mlp.c_fc.weight")
    if fc is None:
        raise WeightError("state dict has no mlp.c_fc weights")
    cfg = {
        "width": width,
        "patch_size": patch,
        "layers": layers,
        "mlp_hidden": int(np.asarray(fc).shape[0]),
        "use_class_token": "class_embedding" in sd,
        "use_ln_pre": "ln_pre.weight" in sd,
        "pool": "map" if "attn_pool.probe" in sd else "tok",
    }
    for key in ("attn_pool.mlp.c_fc.weight", "attn_pool.mlp.fc1.weight"):
        if key in sd:
            cfg["pool_mlp_hidden"] = int(np.asarray(sd[key]).shape[0])
            break
    return cfg


def map_clip_text(sd: Mapping[str, Any]) -> dict:
    """Classic open_clip text transformer state dict (whole-model naming,
    ``token_embedding.weight``…, or custom-text ``text.*``) → tree, with
    CoCa's ``cls_emb`` and either projection form."""
    sd = strip_prefix(sd, "model.", "text.")
    n_blocks = _max_index(sd, r"transformer\.resblocks\.(\d+)\.ln_1\.weight")
    blocks = [_openclip_resblock(sd, f"transformer.resblocks.{i}") for i in range(n_blocks)]
    params: dict = {
        "token_embed": _get(sd, "token_embedding.weight"),
        "pos_embed": _get(sd, "positional_embedding"),
        "blocks": _stack_blocks(blocks),
        "ln_final": _ln(sd, "ln_final"),
    }
    if "cls_emb" in sd:  # CoCa's embed_cls token (appended at the end)
        params["cls_emb"] = np.asarray(sd["cls_emb"]).reshape(1, 1, -1)
    if "text_projection.weight" in sd:  # nn.Linear projection (SigLIP)
        params["proj"] = _linear(sd, "text_projection")
    elif "text_projection" in sd:  # bare Parameter [width, embed]
        params["proj"] = {"w": np.asarray(sd["text_projection"])}
    return params


# -- timm ViT towers (SigLIP / SigLIP2) ---------------------------------------

def _timm_block(sd, prefix: str) -> dict:
    qkv_bias = sd.get(f"{prefix}.attn.qkv.bias")
    if qkv_bias is None and f"{prefix}.attn.q_bias" in sd:
        # EVA attention: separate q/v biases, no k bias
        q_b = np.asarray(sd[f"{prefix}.attn.q_bias"])
        v_b = np.asarray(sd[f"{prefix}.attn.v_bias"])
        qkv_bias = np.concatenate([q_b, np.zeros_like(q_b), v_b])
    attn = _split_qkv(_get(sd, f"{prefix}.attn.qkv.weight"), qkv_bias)
    attn["out"] = _linear(sd, f"{prefix}.attn.proj")
    block = {
        "ln1": _ln(sd, f"{prefix}.norm1"),
        "attn": attn,
        "ln2": _ln(sd, f"{prefix}.norm2"),
        "mlp": {"fc": _linear(sd, f"{prefix}.mlp.fc1"),
                "proj": _linear(sd, f"{prefix}.mlp.fc2")},
    }
    if f"{prefix}.ls1.gamma" in sd:
        block["ls1"] = np.asarray(sd[f"{prefix}.ls1.gamma"])
        block["ls2"] = np.asarray(sd[f"{prefix}.ls2.gamma"])
    return block


def map_timm_visual(sd: Mapping[str, Any]) -> dict:
    """timm ViT state dict (open_clip TimmModel: ``visual.trunk.*``) → ViT
    tree, with the SigLIP attention-pool (map) head and open_clip's
    ``head.*`` projections."""
    sd = strip_prefix(sd, "model.", "visual.", "trunk.")
    n_blocks = _max_index(sd, r"blocks\.(\d+)\.norm1\.weight")
    blocks = [_timm_block(sd, f"blocks.{i}") for i in range(n_blocks)]

    pos = np.asarray(_get(sd, "pos_embed"))
    if pos.ndim == 2:
        pos = pos[None]
    params: dict = {
        "patch_embed": {"w": _conv_to_patch(_get(sd, "patch_embed.proj.weight")),
                        "b": _get(sd, "patch_embed.proj.bias")},
        "pos_embed": pos,
        "blocks": _stack_blocks(blocks),
        # global_pool='avg' checkpoints carry fc_norm (after the pool) in
        # place of the trunk norm (models.build sets norm_after_pool)
        "ln_post": _ln(sd, "norm" if "norm.weight" in sd else "fc_norm"),
    }
    if "cls_token" in sd:
        params["cls_token"] = np.asarray(sd["cls_token"]).reshape(1, 1, -1)
    if "reg_token" in sd:  # timm register tokens
        reg = np.asarray(sd["reg_token"])
        params["reg_tokens"] = reg.reshape(1, -1, reg.shape[-1])
    if "attn_pool.latent" in sd:
        kv = _get(sd, "attn_pool.kv.weight")
        kvb = sd.get("attn_pool.kv.bias")
        d = kv.shape[0] // 2
        pool_attn = {"q": _linear(sd, "attn_pool.q"), "k": {"w": _t(kv[:d])},
                     "v": {"w": _t(kv[d:])}, "out": _linear(sd, "attn_pool.proj")}
        if kvb is not None:
            pool_attn["k"]["b"] = np.asarray(kvb[:d])
            pool_attn["v"]["b"] = np.asarray(kvb[d:])
        params["attn_pool"] = {
            "probe": np.asarray(sd["attn_pool.latent"]).reshape(1, 1, -1),
            "attn": pool_attn,
            "ln": _ln(sd, "attn_pool.norm"),
            "mlp": {"fc": _linear(sd, "attn_pool.mlp.fc1"),
                    "proj": _linear(sd, "attn_pool.mlp.fc2")},
        }
    # open_clip TimmModel heads: 'linear' → head.proj, 'mlp' → head.fc1/fc2;
    # a bare head.weight is the trunk's own classifier-style head
    if "head.proj.weight" in sd:
        params["proj"] = _linear(sd, "head.proj")
    elif "head.fc1.weight" in sd:
        params["proj"] = {"fc": _linear(sd, "head.fc1"), "out": _linear(sd, "head.fc2")}
    elif "head.weight" in sd:
        params["proj"] = _linear(sd, "head")
    return params


# -- entry point ---------------------------------------------------------------

# the families models.build resolves but the port does not build yet, by the
# name its not-yet-ported error gives them
_UNPORTED_VISUAL = {"fastvit": "The FastViT (MobileCLIP) vision tower",
                    "resnet": "The ModifiedResNet vision tower",
                    "convnext": "The ConvNeXt vision tower",
                    "eva02": "The EVA02 vision tower"}


def map_state_dict(sd: Mapping[str, Any], *, tower: str, family: str) -> dict:
    """Map a torch state dict (arrays or CPU tensors) onto a tower tree of
    numpy arrays. ``tower``: "visual" | "text"; ``family``: a
    ``TowerSpec.family``. The families not yet ported raise ConfigError."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if tower == "visual":
        if family == "vit":
            keys = set(sd)
            if any(".trunk." in k or k.startswith("trunk.") or "blocks.0.norm1.weight" in k
                   for k in keys):
                return map_timm_visual(sd)
            if any(k.endswith("attn_pool.probe") for k in keys):
                return map_pe_visual(sd)  # Meta PE-Core naming
            return map_clip_visual(sd)
        if family in _UNPORTED_VISUAL:
            from .models.build import _not_ported

            raise _not_ported(_UNPORTED_VISUAL[family])
        raise WeightError(f"Unknown visual family '{family}'")
    if tower == "text":
        if family == "text_transformer":
            return map_clip_text(sd)
        if family == "hf_bert":
            from .models.hf_text import map_hf_text

            return map_hf_text(sd)
        raise WeightError(f"Unknown text family '{family}'")
    raise WeightError(f"Unknown tower '{tower}'")

"""Reading the benchmark's weight tree into the reference's modules.

The tree is the one ``hbench.weights`` makes from the seed: linear weights
stored [in, out], LayerNorms as ``scale``/``bias``, blocks stacked on axis 0.
Every leaf is copied to f32 on the reference's device; a module is built on
the meta device and filled by a strict ``load_state_dict``, so a leaf that
the reference does not fill is an error, not a random weight."""

from __future__ import annotations

import torch


def f32(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=torch.float32)


def _key(prefix: str, name: str) -> str:
    return f"{prefix}.{name}" if prefix else name


def _at(t: torch.Tensor, i):
    return t if i is None else t[i]


def linear_sd(node: dict, prefix: str, i=None) -> dict:
    """An ``nn.Linear``'s entries ([out, in] weight) from a tree linear."""
    sd = {_key(prefix, "weight"): _at(node["w"], i).t()}
    if "b" in node:
        sd[_key(prefix, "bias")] = _at(node["b"], i)
    return sd


def ln_sd(node: dict, prefix: str, i=None) -> dict:
    return {_key(prefix, "weight"): _at(node["scale"], i),
            _key(prefix, "bias"): _at(node["bias"], i)}


def qkv_sd(attn: dict, prefix: str, i=None, parts=("q", "k", "v"), *,
           names=("weight", "bias")) -> dict:
    """One packed projection from the tree's separate ``parts``, concatenated
    along the output (q, then k, then v)."""
    return {_key(prefix, names[0]): torch.cat([_at(attn[n]["w"], i).t() for n in parts], 0),
            _key(prefix, names[1]): torch.cat([_at(attn[n]["b"], i) for n in parts], 0)}


def loaded(make, sd: dict, device) -> torch.nn.Module:
    """``make()`` built on the meta device, moved to ``device`` and filled
    from ``sd`` (strict), in f32, in eval mode."""
    with torch.device("meta"):
        mod = make()
    mod = mod.to_empty(device=device)
    mod.load_state_dict({k: f32(v, device) for k, v in sd.items()}, strict=True)
    return mod.eval()

"""The weights of a configuration, made from the seed on the device.

The tree's leaves are those of the configuration's layout
(``hbench.layouts``: its ``leaves``), in the tree that the program's
``build_tower`` takes for the family: linear weights [in, out] with biases,
LayerNorms as ``scale``/``bias``, blocks stacked on axis 0.

Leaves are drawn in a few large calls: one ``randn`` in the served dtype a
kind of leaf, then one scale (and shift) for the whole kind, and every leaf
a view of its kind's buffer. Weight matrices get std 1/sqrt(fan-in), so
that activations keep their scale through the depth; biases, LayerNorm
shifts and the embeddings std 0.02; LayerNorm scales 1 + 0.05·z."""

from __future__ import annotations

import hashlib

import torch

from . import layouts

SMALL = 0.02
LN_SCALE_STD = 0.05


def seed_for(seed: int, what: str) -> int:
    """A 63-bit seed for one use (``what``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def _fill(buf: torch.Tensor, kind: str) -> None:
    if kind == "ln_scale":
        buf.mul_(LN_SCALE_STD).add_(1.0)
    elif kind == "small":
        buf.mul_(SMALL)
    else:
        buf.mul_(float(kind.removeprefix("std=")))


def make_tree(config: dict, seed: int, device) -> dict:
    """The configuration's weight tree in its ``dtype``, drawn on ``device``
    from ``seed``: the same seed gives the same weights."""
    leaves = layouts.of(config).leaves(config["vision"])
    dtype = getattr(torch, config["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, "weights"))
    tree: dict = {}
    for kind in sorted({k for _, _, k in leaves}):
        mine = [(path, shape) for path, shape, k in leaves if k == kind]
        buf = torch.randn(sum(torch.Size(s).numel() for _, s in mine), generator=gen,
                          device=device, dtype=dtype)
        _fill(buf, kind)
        at = 0
        for path, shape in mine:
            n = torch.Size(shape).numel()
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = buf[at:at + n].view(shape)
            at += n
    return tree

"""The weights of a configuration, made from the seed on the device.

The tree has the layout that the program's ``build_tower`` takes for the
ViT family (``layout: "vit"``): linear weights [in, out] with biases,
LayerNorms as ``scale``/``bias``, blocks stacked on axis 0, the patch
embedding as [P·P·3, W] rows in (py, px, c) order. Its shapes come from the
configuration file's published widths alone.

Leaves are drawn in a few large calls: one ``randn`` in the served dtype a
kind of leaf, then one scale (and shift) for the whole kind, and every leaf
a view of its kind's buffer. Weight matrices get std 1/sqrt(fan-in), so
that activations keep their scale through the depth; biases, LayerNorm
shifts and the embeddings std 0.02; LayerNorm scales 1 + 0.05·z."""

from __future__ import annotations

import hashlib

import torch

SMALL = 0.02
LN_SCALE_STD = 0.05


def seed_for(seed: int, what: str) -> int:
    """A 63-bit seed for one use (``what``) of the run's ``--seed``."""
    digest = hashlib.sha256(f"{seed}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def vit_layout(v: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf; a kind is ``"std=<x>"``,
    ``"small"`` or ``"ln_scale"``."""
    w, L, m, p = v["width"], v["layers"], v["mlp_hidden"], v["patch_size"]
    pm = v["pool_mlp_hidden"]
    leaves = []

    def linear(path, d_in, d_out, lead=(), bias=True):
        leaves.append((path + ("w",), lead + (d_in, d_out), f"std={d_in ** -0.5!r}"))
        if bias:
            leaves.append((path + ("b",), lead + (d_out,), "small"))

    def ln(path, lead=()):
        leaves.append((path + ("scale",), lead + (w,), "ln_scale"))
        leaves.append((path + ("bias",), lead + (w,), "small"))

    linear(("patch_embed",), p * p * 3, w, bias=v["patch_bias"])
    leaves.append((("pos_embed",), (1, v["tokens"], w), "small"))
    if v["class_token"]:
        leaves.append((("cls_token",), (1, 1, w), "small"))
    if v["ln_pre"]:
        ln(("ln_pre",))
    for name in ("ln1", "ln2"):
        ln(("blocks", name), (L,))
    for name in ("q", "k", "v", "out"):
        linear(("blocks", "attn", name), w, w, (L,))
    linear(("blocks", "mlp", "fc"), w, m, (L,))
    linear(("blocks", "mlp", "proj"), m, w, (L,))
    ln(("ln_post",))
    if v["pool"] == "map":
        leaves.append((("attn_pool", "probe"), (1, 1, w), "small"))
        for name in ("q", "k", "v", "out"):
            linear(("attn_pool", "attn", name), w, w)
        ln(("attn_pool", "ln"))
        linear(("attn_pool", "mlp", "fc"), w, pm)
        linear(("attn_pool", "mlp", "proj"), pm, w)
    else:
        raise ValueError(f"pool '{v['pool']}' has no layout here")
    if v["proj"]:
        linear(("proj",), w, v["embed_dim"], bias=v["proj_bias"])
    return leaves


LAYOUTS = {"vit": vit_layout}


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
    leaves = LAYOUTS[config["layout"]](config["vision"])
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

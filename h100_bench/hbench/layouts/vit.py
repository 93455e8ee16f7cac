"""The ViT family (``"layout": "vit"``): timm and open_clip ViTs with a MAP
pool, SigLIP's and PE-Core's among them (the program's ``models/vit.py``).

The tree is the one the program's ``build_tower`` takes for a ``ViTCfg``:
linear weights [in, out] with biases, LayerNorms as ``scale``/``bias``,
blocks stacked on axis 0, the patch embedding as [P·P·3, W] rows in
(py, px, c) order. Its shapes come from the configuration file's published
widths alone."""

from __future__ import annotations

# the program's resolved field for each published width of the config file
RESOLVED = {
    "image_size": "image_size", "patch_size": "patch_size", "width": "width",
    "layers": "layers", "heads": "heads", "mlp_hidden": "mlp_hidden",
    "embed_dim": "embed_dim", "activation": "activation", "class_token": "use_class_token",
    "ln_pre": "use_ln_pre", "pool": "pool", "proj": "use_proj", "ln_eps": "ln_eps",
    "rope_2d": "rope_2d", "tokens": "seq_len", "layer_scale": "use_layer_scale",
}


def leaves(v: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf; a kind is ``"std=<x>"``,
    ``"small"`` or ``"ln_scale"``."""
    w, L, m, p = v["width"], v["layers"], v["mlp_hidden"], v["patch_size"]
    pm = v["pool_mlp_hidden"]
    out = []

    def linear(path, d_in, d_out, lead=(), bias=True):
        out.append((path + ("w",), lead + (d_in, d_out), f"std={d_in ** -0.5!r}"))
        if bias:
            out.append((path + ("b",), lead + (d_out,), "small"))

    def ln(path, lead=()):
        out.append((path + ("scale",), lead + (w,), "ln_scale"))
        out.append((path + ("bias",), lead + (w,), "small"))

    linear(("patch_embed",), p * p * 3, w, bias=v["patch_bias"])
    out.append((("pos_embed",), (1, v["tokens"], w), "small"))
    if v["class_token"]:
        out.append((("cls_token",), (1, 1, w), "small"))
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
        out.append((("attn_pool", "probe"), (1, 1, w), "small"))
        for name in ("q", "k", "v", "out"):
            linear(("attn_pool", "attn", name), w, w)
        ln(("attn_pool", "ln"))
        linear(("attn_pool", "mlp", "fc"), w, pm)
        linear(("attn_pool", "mlp", "proj"), pm, w)
    else:
        raise ValueError(f"pool '{v['pool']}' has no layout here")
    if v["proj"]:
        linear(("proj",), w, v["embed_dim"], bias=v["proj_bias"])
    return out


def resolved(cfg) -> dict:
    """The widths of a ``ViTCfg``; the pool's heads and MLP fall back to
    the blocks' where the program leaves them unset."""
    got = {k: getattr(cfg, attr) for k, attr in RESOLVED.items()}
    got["pool_heads"] = cfg.pool_heads or cfg.heads
    got["pool_mlp_hidden"] = cfg.pool_mlp_hidden or cfg.mlp_hidden
    return got


def flop_per_image(v: dict) -> float:
    """Model FLOP of one image through a ViT tower: patch embedding, per
    block q/k/v, the output projection, the MLP and attention's 4·S²·W; the
    MAP pool (one query: its q and output projection, k/v over the tokens,
    attention, its MLP) and the projection. Padding rows are not images."""
    w, m, s = v["width"], v["mlp_hidden"], v["tokens"]
    p = v["patch_size"]
    patches = (v["image_size"] // p) ** 2
    flop = 2.0 * patches * p * p * 3 * w
    per_block = 2.0 * s * w * 3 * w + 2.0 * s * w * w + 2 * 2.0 * s * w * m + 4.0 * s * s * w
    flop += v["layers"] * per_block
    if v["pool"] == "map":
        flop += 2.0 * w * w + 2.0 * s * w * 2 * w + 4.0 * s * w + 2.0 * w * w
        flop += 2 * 2.0 * w * v["pool_mlp_hidden"]
    if v["proj"]:
        flop += 2.0 * w * v["embed_dim"]
    return flop


def shrink(config: dict, *, width: int, layers: int, heads: int, mlp: int) -> None:
    """The tower at ``width``/``layers``/``heads``/``mlp`` and an image of
    4 × 4 patches, through the program's override hook (``pe_cfg`` for
    PE-Core's rope, ``vit_cfg`` otherwise)."""
    v, oc = config["vision"], config["open_clip"]["vision_cfg"]
    image = 4 * v["patch_size"]
    pool_mlp = 4 * width if v["rope_2d"] else mlp
    v.update(image_size=image, width=width, layers=layers, heads=heads, head_dim=width // heads,
             mlp_hidden=mlp, tokens=16 + (1 if v["class_token"] else 0),
             pool_heads=v["pool_heads"] if v["rope_2d"] else heads, pool_mlp_hidden=pool_mlp)
    if not v["proj"]:
        v["embed_dim"] = width
    oc["image_size"] = image
    key = "pe_cfg" if v["rope_2d"] else "vit_cfg"
    oc[key] = {"width": width, "layers": layers, "heads": heads, "mlp_hidden": mlp}

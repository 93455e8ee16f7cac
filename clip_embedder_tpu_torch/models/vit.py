"""Vision Transformer towers.

Counterpart of ``clip_embedder_tpu.models.vit``: one config-driven tower for

* classic CLIP ViTs (class token, ln_pre, quick_gelu option, bias-free
  projection, CLS pooling);
* timm/SigLIP ViTs (no class token, tanh-gelu, the attention-pool "map"
  head with a learned probe, layer scale, register tokens, gap pooling);
* PE-Core (class token, ln_pre, 2-D axial rope on q and k in every block,
  ``rope_2d``, and the map head);
* CoCa (``pool="attn"``: open_clip's legacy attentional pooler, a bank of
  learned queries in the embed space cross-attending over the tokens, then
  ``ln_post`` and query 0);
* open_clip's ``timm_proj="mlp"`` head: a ``proj`` of ``fc`` → gelu →
  ``out`` (``weights.map_timm_visual`` maps ``head.fc1``/``head.fc2`` to it).

Patch embedding is one [B, N, P²·3] × [P²·3, D] matmul (patch rows in
(py, px, c) order, matching the weight layout of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial
from typing import Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..errors import ConfigError
from ..ops.attention import multi_head_attention
from ..ops.layers import ACTIVATIONS, gelu, layer_norm, linear, mlp, norm
from ..ops.normalize import l2_normalize
from ..ops.rope import axial_rope_table, head_tiled_tables
from ..weights import ParamTree, unstack


@dataclass(frozen=True)
class ViTCfg:
    """Resolved architecture of one vision tower (same fields as the JAX
    package's ``ViTCfg``; built by ``models.build.resolve_vision``)."""

    image_size: int
    patch_size: int
    width: int
    layers: int
    heads: int
    mlp_hidden: int
    embed_dim: int
    activation: str = "gelu"          # gelu | gelu_tanh | quick_gelu
    use_class_token: bool = True
    use_ln_pre: bool = True
    pool: str = "cls"                 # cls | map | gap | tok
    use_proj: bool = True
    proj_bias: bool = False
    use_layer_scale: bool = False
    ln_eps: float = 1e-5
    pos_embed_cls: bool = True
    norm_after_pool: bool = False
    reg_tokens: int = 0
    rope_2d: bool = False
    rope_temperature: float = 10000.0
    pool_heads: int = 0
    pool_mlp_hidden: int = 0
    attn_pool_queries: int = 0
    attn_pool_dim: int = 0

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def prefix_tokens(self) -> int:
        return (1 if self.use_class_token else 0) + self.reg_tokens

    @property
    def seq_len(self) -> int:
        return self.num_patches + self.prefix_tokens

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


def check_ported(cfg: ViTCfg) -> None:
    if cfg.pool not in ("cls", "tok", "map", "gap", "attn"):
        raise ConfigError(f"vision pool '{cfg.pool}' is not yet ported to the "
                          "torch package")


def _normal(shape, std, gen, device, dtype):
    t = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (t * std).to(dtype)


def _init_linear(gen, d_in, d_out, *, bias=True, std=None, layers=None,
                 device="cpu", dtype=torch.float32):
    lead = () if layers is None else (layers,)
    std = std if std is not None else d_in ** -0.5
    p = {"w": _normal(lead + (d_in, d_out), std, gen, device, dtype)}
    if bias:
        p["b"] = torch.zeros(lead + (d_out,), device=device, dtype=dtype)
    return p


def _conv_init(g, k, cin, cout, *, groups=1, layers=None, device="cpu", dtype=torch.float32):
    """A conv in the stored layout: {"w": HWIO [k, k, cin/groups, cout], "b"}
    (with a leading [layers] axis for stacked blocks): the convolutional
    towers' init."""
    lead = () if layers is None else (layers,)
    fan_in = k * k * cin // groups
    return {"w": _normal(lead + (k, k, cin // groups, cout), fan_in ** -0.5, g, device, dtype),
            "b": torch.zeros(lead + (cout,), device=device, dtype=dtype)}


def _init_ln(d, *, layers=None, device="cpu", dtype=torch.float32):
    lead = () if layers is None else (layers,)
    return {"scale": torch.ones(lead + (d,), device=device, dtype=dtype),
            "bias": torch.zeros(lead + (d,), device=device, dtype=dtype)}


def _init_attn(gen, width, *, layers=None, device="cpu", dtype=torch.float32):
    return {n: _init_linear(gen, width, width, layers=layers, device=device, dtype=dtype)
            for n in ("q", "k", "v", "out")}


def init_blocks(gen, *, layers, width, mlp_hidden, layer_scale=False,
                device="cpu", dtype=torch.float32) -> dict:
    """Stacked block parameters ([layers, ...] leaves)."""
    kw = {"layers": layers, "device": device, "dtype": dtype}
    blocks = {
        "ln1": _init_ln(width, **kw),
        "attn": _init_attn(gen, width, **kw),
        "ln2": _init_ln(width, **kw),
        "mlp": {"fc": _init_linear(gen, width, mlp_hidden, **kw),
                "proj": _init_linear(gen, mlp_hidden, width, **kw)},
    }
    if layer_scale:
        for n in ("ls1", "ls2"):
            blocks[n] = torch.full((layers, width), 1e-5, device=device, dtype=dtype)
    return blocks


def init(cfg: ViTCfg, *, generator: torch.Generator | None = None,
         device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32) -> dict:
    """Random-init parameter tree in the JAX package's layout (blocks
    stacked on axis 0). ``device="meta"`` gives the shapes alone (and takes
    no generator)."""
    check_ported(cfg)
    g, dev, dt = generator, device, dtype
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    params = {
        "patch_embed": _init_linear(g, patch_dim, cfg.width, device=dev, dtype=dt),
        "pos_embed": _normal(
            (1, cfg.num_patches + (1 if cfg.pos_embed_cls else 0), cfg.width),
            0.02, g, dev, dt),
        "ln_post": _init_ln(cfg.width, device=dev, dtype=dt),
    }
    if cfg.use_class_token:
        params["cls_token"] = _normal((1, 1, cfg.width), 0.02, g, dev, dt)
    if cfg.reg_tokens:
        params["reg_tokens"] = _normal((1, cfg.reg_tokens, cfg.width), 0.02, g, dev, dt)
    if cfg.use_ln_pre:
        params["ln_pre"] = _init_ln(cfg.width, device=dev, dtype=dt)
    params["blocks"] = init_blocks(
        g, layers=cfg.layers, width=cfg.width, mlp_hidden=cfg.mlp_hidden,
        layer_scale=cfg.use_layer_scale, device=dev, dtype=dt)
    if cfg.pool == "map":
        pool_hidden = cfg.pool_mlp_hidden or cfg.mlp_hidden
        params["attn_pool"] = {
            "probe": _normal((1, 1, cfg.width), 0.02, g, dev, dt),
            "attn": _init_attn(g, cfg.width, device=dev, dtype=dt),
            "ln": _init_ln(cfg.width, device=dev, dtype=dt),
            "mlp": {"fc": _init_linear(g, cfg.width, pool_hidden, device=dev, dtype=dt),
                    "proj": _init_linear(g, pool_hidden, cfg.width, device=dev, dtype=dt)},
        }
    proj_in = cfg.width
    if cfg.pool == "attn":
        dm = proj_in = cfg.attn_pool_dim or cfg.width
        params["ln_post"] = _init_ln(dm, device=dev, dtype=dt)  # over the pooler's d_model
        params["attn_pool"] = {
            "query": _normal((cfg.attn_pool_queries, dm), dm ** -0.5, g, dev, dt),
            "ln_q": _init_ln(dm, device=dev, dtype=dt),
            "ln_k": _init_ln(cfg.width, device=dev, dtype=dt),
            "attn": {"q": _init_linear(g, dm, dm, device=dev, dtype=dt),
                     "k": _init_linear(g, cfg.width, dm, device=dev, dtype=dt),
                     "v": _init_linear(g, cfg.width, dm, device=dev, dtype=dt),
                     "out": _init_linear(g, dm, dm, device=dev, dtype=dt)},
        }
    if cfg.use_proj:
        params["proj"] = _init_linear(g, proj_in, cfg.embed_dim, bias=cfg.proj_bias,
                                      device=dev, dtype=dt)
    return params


def patchify(x: torch.Tensor, patch_size: int, channels_first: bool = False) -> torch.Tensor:
    """[B, H, W, 3] (or [B, 3, H, W] with ``channels_first``) → [B, N, P·P·3]
    patch rows in (py, px, c) order."""
    p = patch_size
    if channels_first:
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 3, 5, 1)
    else:
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def block_forward(p, x: torch.Tensor, *, heads: int, act, ln_eps: float, impl: str,
                  mask=None, rope=None) -> torch.Tensor:
    """One pre-LN transformer block over the block tree ``p``: x + attn(ln1(x)),
    then x + mlp(ln2(x)), with optional layer scale (``ls1``/``ls2``). On a
    kernel impl the MLP half's LayerNorm and activation take ``ops.rows``'
    kernels where they take the call (``ops.layers.mlp``)."""
    if "ls1" in p:
        h = multi_head_attention(p["attn"], x, num_heads=heads, mask=mask, impl=impl,
                                 pre_ln=p["ln1"], ln_eps=ln_eps, rope=rope)
        x = x + h * p["ls1"]
    else:
        x = multi_head_attention(p["attn"], x, num_heads=heads, mask=mask, impl=impl,
                                 pre_ln=p["ln1"], ln_eps=ln_eps, residual=x, rope=rope)
    if "ls2" in p:
        h = mlp(p["mlp"], x, activation=act, pre_ln=p["ln2"], ln_eps=ln_eps, impl=impl)
        return x + h * p["ls2"]
    return mlp(p["mlp"], x, activation=act, pre_ln=p["ln2"], ln_eps=ln_eps, residual=True,
               impl=impl)


class Block(ParamTree):
    """``block_forward`` over one block's (frozen) weights. Shared by the text
    tower."""

    def __init__(self, params: Mapping, *, heads: int, activation: str, ln_eps: float):
        super().__init__(params)
        self.heads = heads
        self.act = ACTIVATIONS[activation]
        self.ln_eps = ln_eps

    def forward(self, x: torch.Tensor, *, impl: str, mask=None, rope=None) -> torch.Tensor:
        return block_forward(self, x, heads=self.heads, act=self.act, ln_eps=self.ln_eps,
                             impl=impl, mask=mask, rope=rope)


class StackedBlock:
    """``block_forward`` over layer ``i`` of the stacked block leaves,
    indexed inside the call, so that autograd carries the block's gradient
    into the stacked leaves themselves (a trainable tower's blocks)."""

    def __init__(self, stacked: Mapping, i: int, *, heads: int, activation: str,
                 ln_eps: float):
        self.stacked, self.i = stacked, i
        self.heads, self.act, self.ln_eps = heads, ACTIVATIONS[activation], ln_eps

    def __call__(self, x: torch.Tensor, *, impl: str, mask=None, rope=None) -> torch.Tensor:
        return block_forward(unstack(self.stacked, self.i), x, heads=self.heads, act=self.act,
                             ln_eps=self.ln_eps, impl=impl, mask=mask, rope=rope)


def blocks_from_tree(stacked: Mapping, *, layers: int, heads: int, activation: str,
                     ln_eps: float, trainable: bool = False):
    """The tower's blocks: frozen per-layer modules (views of the stacked
    leaves), or with ``trainable`` a ``StackedBlock`` a layer over the
    stacked tree as given."""
    kw = {"heads": heads, "activation": activation, "ln_eps": ln_eps}
    if trainable:
        return [StackedBlock(stacked, i, **kw) for i in range(layers)]
    return nn.ModuleList(Block(unstack(stacked, i), **kw) for i in range(layers))


def run_blocks(blocks, x: torch.Tensor, *, remat: bool, **kw) -> torch.Tensor:
    """x through ``blocks`` in order; with ``remat`` each block's activations
    are recomputed on the backward pass (``jax.checkpoint`` in the JAX
    package) and only its input is kept."""
    for blk in blocks:
        if remat:
            # no RNG runs in a block, so none is stashed for the recompute:
            # reading the CUDA generator's state is no op a CUDA graph holds
            # (the train step is captured)
            x = checkpoint(partial(blk, **kw), x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = blk(x, **kw)
    return x


@lru_cache(maxsize=8)
def _rope_tables(cfg: ViTCfg, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Made outside inference mode whatever the caller's: the tables are
    shared by every tower of the config and device, and a trainable tower's
    backward saves them (autograd refuses to save an inference tensor)."""
    ang = axial_rope_table(cfg.grid, cfg.head_dim, cfg.rope_temperature, order="xy",
                           prefix=cfg.prefix_tokens)
    with torch.inference_mode(False):
        return tuple(t.to(device) for t in head_tiled_tables(ang, cfg.heads))


class ViT(ParamTree):
    """The vision tower over a parameter tree from ``init`` or
    ``weights.load_pytree``; with ``trainable`` over the tree's own tensors
    (``ParamTree``, ``StackedBlock``), so that a backward pass reaches them."""

    def __init__(self, cfg: ViTCfg, params: Mapping, *, trainable: bool = False):
        check_ported(cfg)
        super().__init__({k: v for k, v in params.items() if k != "blocks"},
                         trainable=trainable)
        self.cfg = cfg
        self.blocks = blocks_from_tree(params["blocks"], layers=cfg.layers, heads=cfg.heads,
                                       activation=cfg.activation, ln_eps=cfg.ln_eps,
                                       trainable=trainable)
        self.act = ACTIVATIONS[cfg.activation]

    def rope_tables(self, device: torch.device):
        """PE-Core's (sin, cos) [S, H·D] f32 tables on ``device`` (Meta's
        ``compute_axial_cis``: x bands first, raw integer coordinates, identity
        rows for the prefix tokens), built once per device; None without
        ``rope_2d``. They are made once per config and device, beside the
        towers: a train step builds its towers anew (and a captured step
        inside its graph, where no copy from the host can run)."""
        if not self.cfg.rope_2d:
            return None
        return _rope_tables(self.cfg, device)

    def _map_pool(self, x: torch.Tensor, impl: str = "eager") -> torch.Tensor:
        """timm AttentionPoolLatent: a learned probe cross-attends over the
        tokens (plain attention on every impl), then a residual MLP (its
        LayerNorm and activation routed by ``impl``, as a block's)."""
        cfg, p = self.cfg, self["attn_pool"]
        probe = p["probe"].to(x.dtype).expand(x.shape[0], 1, cfg.width)
        pooled = multi_head_attention(p["attn"], probe, kv=x,
                                      num_heads=cfg.pool_heads or cfg.heads)
        pooled = pooled + mlp(p["mlp"], norm(p["ln"], pooled, eps=cfg.ln_eps, impl=impl),
                              activation=self.act, impl=impl)
        return pooled[:, 0]

    def _attn_pool(self, x: torch.Tensor) -> torch.Tensor:
        """CoCa's legacy attentional pool (open_clip AttentionalPooler with
        the VisionTransformer's boolean ``attentional_pool``): ``ln_k`` over
        the tokens, ``ln_q`` over the learned queries, a cross-attention
        whose k/v come in at the tower's width (plain attention, as in the
        JAX package), ``ln_post`` over the pooled queries, then query 0."""
        cfg, p = self.cfg, self["attn_pool"]
        dm = cfg.attn_pool_dim or cfg.width
        keys = layer_norm(p["ln_k"], x, eps=cfg.ln_eps)
        q = layer_norm(p["ln_q"], p["query"].to(x.dtype), eps=cfg.ln_eps)
        q = q[None].expand(x.shape[0], cfg.attn_pool_queries, dm)
        pooled = multi_head_attention(p["attn"], q, kv=keys,
                                      num_heads=cfg.pool_heads or cfg.heads)
        return layer_norm(self["ln_post"], pooled, eps=cfg.ln_eps)[:, 0]

    def forward(self, pixels: torch.Tensor, *, attn_impl: str = "eager",
                channels_first: bool = False, normalize: bool = True,
                remat: bool = False) -> torch.Tensor:
        """[B, H, W, 3] preprocessed pixels ([B, 3, H, W] with
        ``channels_first``) → [B, embed_dim]. ``remat``: ``run_blocks``. On
        a kernel ``attn_impl``, ``ln_pre``, ``ln_post`` and the map pool's
        LayerNorm and MLP take ``ops.rows``' kernels where they take the
        call, as the blocks' MLP halves do."""
        cfg = self.cfg
        x = linear(self["patch_embed"], patchify(pixels, cfg.patch_size, channels_first))
        b = x.shape[0]
        pos = self["pos_embed"].to(x.dtype)
        prefix = []
        if cfg.use_class_token:
            prefix.append(self["cls_token"].to(x.dtype).expand(b, 1, cfg.width))
        if cfg.reg_tokens:
            prefix.append(self["reg_tokens"].to(x.dtype).expand(b, cfg.reg_tokens, cfg.width))
        if pos.shape[1] == cfg.num_patches and prefix:
            # timm no_embed_class: pos covers patches only
            x = torch.cat(prefix + [x + pos], dim=1)
        else:
            x = torch.cat(prefix + [x], dim=1) if prefix else x
            x = x + pos
        if cfg.use_ln_pre:
            x = norm(self["ln_pre"], x, eps=cfg.ln_eps, impl=attn_impl)

        x = run_blocks(self.blocks, x, remat=remat, impl=attn_impl,
                       rope=self.rope_tables(x.device))

        if cfg.pool == "attn":
            pooled = self._attn_pool(x)
        elif cfg.pool == "map":
            pooled = self._map_pool(norm(self["ln_post"], x, eps=cfg.ln_eps, impl=attn_impl),
                                    attn_impl)
        elif cfg.pool == "gap":
            start = cfg.prefix_tokens
            if cfg.norm_after_pool:
                pooled = norm(self["ln_post"], x[:, start:].mean(dim=1), eps=cfg.ln_eps,
                              impl=attn_impl)
            else:
                x = norm(self["ln_post"], x, eps=cfg.ln_eps, impl=attn_impl)
                pooled = x[:, start:].mean(dim=1)
        else:  # cls / tok
            pooled = norm(self["ln_post"], x[:, 0], eps=cfg.ln_eps, impl=attn_impl)

        if cfg.use_proj and "proj" in self:
            proj = self["proj"]
            if "fc" in proj:  # open_clip timm_proj='mlp': Linear → gelu → Linear
                pooled = linear(proj["out"], gelu(linear(proj["fc"], pooled)))
            else:
                pooled = linear(proj, pooled)
        return l2_normalize(pooled) if normalize else pooled

"""The PE-Core slice of the torch port against the JAX package, on the CPU.

* ``ops.rope``: the angle tables equal the JAX package's; the rotation is
  within one unit in the last place;
* the kernels' plain versions against the JAX Pallas kernels in interpret
  mode: ``flash_attention_packed`` with in-kernel rope (kernel 2),
  ``flash_attention`` on the [B, H, S, D] layout (kernel 3) and
  ``int8_mlp_streamed`` (kernel 7);
* ``multi_head_attention``'s routing: head layouts with no 128-lane group go
  to ``flash_attention`` with the f32 exp, as the JAX package's ``pallas``
  routes them, and rope is applied inside or outside the kernel as there;
* a small PE-Core tower, the config resolution of the PE-Core names, and
  ``Clip.from_local_dir`` on a PE-Core model dir under ``quantize=None``,
  ``"int8"`` and ``"int8_all"`` against the JAX ``Clip``.

Tolerances: f32 attention at atol 2e-5 (the JAX package's own for its
attention kernels, tests/test_flash.py), bf16 at 2e-2 (one bf16 step of
outputs near 1); the int8 MLP as tests/test_torch_quant.py holds kernel 4;
towers at the golden fixtures' cosine > 1 - 1e-6 and atol 5e-4.
"""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu import Clip as JaxClip
from clip_embedder_tpu.config import ModelCfg as JModelCfg
from clip_embedder_tpu.config import OpenClipConfig as JOpenClipConfig
from clip_embedder_tpu.models import build as jbuild
from clip_embedder_tpu.models import text_transformer as jtext
from clip_embedder_tpu.models import vit as jvit
from clip_embedder_tpu.ops import attention as jattn
from clip_embedder_tpu.ops import flash as jflash
from clip_embedder_tpu.ops import rope as jrope
from clip_embedder_tpu.ops.int8_mlp import int8_mlp_streamed as jstreamed
from clip_embedder_tpu.weights import save_pytree as jsave_pytree
from clip_embedder_tpu_torch import Clip
from clip_embedder_tpu_torch import weights as tweights
from clip_embedder_tpu_torch.config import ModelCfg
from clip_embedder_tpu_torch.models import build as tbuild
from clip_embedder_tpu_torch.models import vit as tvit
from clip_embedder_tpu_torch.ops import attention as tattn
from clip_embedder_tpu_torch.ops import flash, int8_mlp, layers, qkv
from clip_embedder_tpu_torch.ops import rope as trope
from test_tokenizer import make_clip_style_spec
from test_torch_quant import _jax_tree, _ln, _mlp_step, _qlinear, _torch_tree, assert_int8_close

FIXTURES = Path(__file__).parent / "fixtures"
# the dims of tests/test_pe_core.py: head dim 32 (8 rope bands), 4·32 = 128
# lanes, so the packed kernel takes the heads as one group
W, HEADS, LAYERS, MLP, EMBED = 128, 4, 2, 256, 48


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _ulp(x, dtype):
    """One unit in the last place of ``dtype`` at each element's magnitude."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.spacing(mag.astype(np.float32)) if dtype == "float32" \
        else 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.fixture()
def jax_kernels_interpreted(monkeypatch):
    """The JAX package's attention kernels in interpret mode, where its
    layers look them up, so that its ``pallas`` impls run on the CPU."""
    for name in ("flash_attention", "flash_attention_packed"):
        monkeypatch.setattr(jflash, name, functools.partial(getattr(jflash, name),
                                                            interpret=True))


# -- ops.rope ------------------------------------------------------------------

@pytest.mark.parametrize("order", ["yx", "xy"])
@pytest.mark.parametrize("kw", [{}, {"prefix": 1}, {"ref_grid": 16, "prefix": 2},
                                {"temperature": 100.0}],
                         ids=["plain", "prefix", "ref_grid_prefix", "temperature"])
def test_axial_rope_table_equals_jax(order, kw):
    got = trope.axial_rope_table(6, 32, order=order, **kw)
    ref = jrope.axial_rope_table(6, 32, order=order, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_axial_rope_table_rejects_unknown_order():
    with pytest.raises(ValueError, match="order"):
        trope.axial_rope_table(4, 16, order="zz")


def test_head_tiled_tables_match_jax():
    ang = trope.axial_rope_table(32, 96, order="xy", prefix=1)  # PE-Core-bigG's
    got = trope.head_tiled_tables(ang, 16)
    ref = jrope.head_tiled_tables(ang, 16)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and tuple(g.shape) == (1025, 16 * 96)
        r = np.asarray(r)
        assert (np.abs(g.numpy() - r) <= _ulp(r, "float32")).all()
    np.testing.assert_array_equal(got[0].numpy()[0], 0.0)  # the cls row: identity
    np.testing.assert_array_equal(got[1].numpy()[0], 1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "bhsd"])
def test_apply_rope_matches_jax(dtype, layout):
    grid, d, h = 5, 32, 3
    ang = trope.axial_rope_table(grid, d, order="xy", prefix=1)
    rng = np.random.default_rng(0)
    if layout == "packed":
        sin, cos = trope.head_tiled_tables(ang, h)
        x = _arr(rng, 2, grid * grid + 1, h * d)
    else:
        sin, cos = (torch.from_numpy(f(ang).astype(np.float32)) for f in (np.sin, np.cos))
        x = _arr(rng, 2, h, grid * grid + 1, d)
    ref = np.asarray(jrope.apply_rope(jnp.asarray(x, getattr(jnp, dtype)),
                                      jnp.asarray(sin.numpy()), jnp.asarray(cos.numpy()))
                     .astype(jnp.float32))
    got = trope.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), sin, cos)
    assert got.dtype == getattr(torch, dtype)
    assert (np.abs(got.float().numpy() - ref) <= _ulp(ref, dtype)).all()
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    cls = (slice(None), 0) if layout == "packed" else (slice(None), slice(None), 0)
    np.testing.assert_array_equal(got.float().numpy()[cls], xt[cls])  # the identity row


# -- kernel 2 with rope ----------------------------------------------------------

def _pe_tables(grid, d, h):
    sin, cos = trope.head_tiled_tables(trope.axial_rope_table(grid, d, order="xy", prefix=1), h)
    return (sin, cos), (jnp.asarray(sin.numpy()), jnp.asarray(cos.numpy()))


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("fast", [False, True])
def test_flash_packed_rope_plain_matches_jax_kernel(d, dtype, tol, fast):
    b, h, grid = 2, 4, 4
    s = grid * grid + 1
    (tsin, tcos), (jsin, jcos) = _pe_tables(grid, d, h)
    rng = np.random.default_rng(d)
    arrs = [_arr(rng, b, s, h * d) for _ in range(3)]
    ref = jflash.flash_attention_packed(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
                                        num_heads=h, rope=(jsin, jcos), fast_softmax=fast,
                                        interpret=True)
    got = flash.flash_attention_packed(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                         for a in arrs),
                                       num_heads=h, rope=(tsin, tcos), fast_softmax=fast)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


def test_flash_packed_rope_refuses_a_mask_and_bad_tables():
    q = torch.zeros(1, 9, 4 * 32)
    (sin, cos), _ = _pe_tables(2, 32, 4)
    from clip_embedder_tpu_torch.ops.attention import causal_mask

    with pytest.raises(ValueError, match="rope with a mask"):
        flash.flash_attention_packed(q, q, q, num_heads=4, rope=(sin, cos),
                                     mask=causal_mask(9))
    with pytest.raises(ValueError, match=r"rope tables must be \[S, H·D\]"):
        flash.flash_attention_packed(q, q, q, num_heads=4, rope=(sin[:8], cos[:8]))
    with pytest.raises(ValueError, match="rope tables"):
        flash.flash_attention_packed(q, q, q, num_heads=4, rope=(sin[:, :64], cos[:, :64]))


# -- kernel 3: flash_attention on [B, H, S, D] ----------------------------------

@pytest.mark.parametrize("b,h,s,d", [(2, 4, 13, 16), (1, 3, 20, 72), (2, 2, 9, 128),
                                     (1, 4, 64, 16)])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("mode", ["exact", "fast", "causal", "causal_fast"])
def test_flash_attention_plain_matches_jax_kernel(b, h, s, d, dtype, tol, mode):
    """S not a multiple of 8 (the TPU kernel pads it), D below, between and
    at the 128 lanes."""
    rng = np.random.default_rng(s + d)
    arrs = [_arr(rng, b, h, s, d) for _ in range(3)]
    fast = mode.endswith("fast")
    causal = mode.startswith("causal")
    ref = jflash.flash_attention(*(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs),
                                 mask=jattn.causal_mask(s) if causal else None,
                                 fast_softmax=fast, interpret=True)
    before = flash.flash_attention.launches
    got = flash.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs),
                                mask=tattn.causal_mask(s) if causal else None,
                                fast_softmax=fast)
    assert flash.flash_attention.launches == before  # the plain version on the CPU
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (b, h, s, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ["cross", "v_unlike_k", "key_padding", "per_batch_full"])
def test_flash_attention_hands_other_calls_to_attention_core(case, monkeypatch):
    """Cross-attention and per-batch masks end on ``attention_core``, as
    the JAX kernel hands them to its XLA core."""
    rng = np.random.default_rng(3)
    b, h, s, d = 2, 4, 10, 16
    q = _arr(rng, b, h, s, d)
    k = _arr(rng, b, h, 7 if case == "cross" else s, d)
    v = _arr(rng, b, h, 7 if case == "cross" else s, 8 if case == "v_unlike_k" else d)
    mask = None
    if case == "key_padding":
        mask = np.where(rng.random((b, 1, 1, s)) < 0.3, -np.inf, 0.0).astype(np.float32)
        mask[..., 0] = 0.0
    elif case == "per_batch_full":
        mask = _arr(rng, b, 1, s, s)
    ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 mask=None if mask is None else jnp.asarray(mask),
                                 interpret=True)
    calls = []
    real = tattn.attention_core
    monkeypatch.setattr(tattn, "attention_core",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                mask=None if mask is None else torch.from_numpy(mask))
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-5)


def test_head_group_matches_jax():
    for h in (1, 2, 3, 4, 8, 12, 16, 20):
        for d in (8, 16, 32, 64, 72, 80, 96, 128):
            assert flash.head_group(h, d) == jflash._head_group(h, d), (h, d)


# -- the routing repair -------------------------------------------------------

def _attn_params(rng, width):
    return {n: {"w": _arr(rng, width, width, scale=width ** -0.5),
                "b": _arr(rng, width, scale=0.1)} for n in ("q", "k", "v", "out")}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


JAX_IMPL = {"eager": "xla", "kernel": "pallas", "kernel_fast": "pallas_fast"}


@pytest.mark.parametrize("masked", [False, True], ids=["none", "causal"])
def test_kernel_fast_without_head_group_takes_flash_attention(masked, jax_kernels_interpreted,
                                                              monkeypatch):
    """4 heads x 16 (the golden fixtures') form no 128-lane group: the JAX
    package's pallas_fast sends them to flash_attention, exp in f32. The
    port takes the same kernel and matches it at f32 precision (it used to
    take the packed kernel with the bf16 exp: ~1e-2 off)."""
    rng = np.random.default_rng(21)
    jp, tp = _both(_attn_params(rng, 64))
    x = _arr(rng, 2, 12, 64)
    jmask, tmask = (jattn.causal_mask(12), tattn.causal_mask(12)) if masked else (None, None)
    ref = jattn.multi_head_attention(jp, jnp.asarray(x), num_heads=4, mask=jmask,
                                     impl="pallas_fast")
    calls = []
    real = flash.flash_attention
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **kw: calls.append(kw["fast_softmax"]) or real(*a, **kw))
    got = tattn.multi_head_attention(tp, torch.from_numpy(x), num_heads=4, mask=tmask,
                                     impl="kernel_fast")
    assert calls == [True]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("impl", ["eager", "kernel", "kernel_fast"])
@pytest.mark.parametrize("width,heads,masked", [(128, 4, False), (96, 3, False),
                                               (128, 4, True)],
                         ids=["packed", "no_group", "masked"])
def test_multi_head_attention_rope_matches_jax(impl, width, heads, masked,
                                               jax_kernels_interpreted):
    """Rope in the packed kernel (a head group, no mask), or applied
    outside before the heads split (3 heads x 32: no head group; or a
    mask)."""
    grid = 3
    s = grid * grid + 1
    d = width // heads
    (tsin, tcos), (jsin, jcos) = _pe_tables(grid, d, heads)
    rng = np.random.default_rng(heads)
    jp, tp = _both(_attn_params(rng, width))
    x = _arr(rng, 2, s, width)
    jmask, tmask = (jattn.causal_mask(s), tattn.causal_mask(s)) if masked else (None, None)
    ref = jattn.multi_head_attention(jp, jnp.asarray(x), num_heads=heads, mask=jmask,
                                     rope=(jsin, jcos), impl=JAX_IMPL[impl])
    got = tattn.multi_head_attention(tp, torch.from_numpy(x), num_heads=heads, mask=tmask,
                                     rope=(tsin, tcos), impl=impl)
    # kernel_fast on the packed kernel rounds the exp to bf16 (d = 32 < 96)
    tol = 2e-2 if impl == "kernel_fast" and not masked and width == 128 else 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol)


# -- kernel 7: int8_mlp_streamed ----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
@pytest.mark.parametrize("variant", ["plain", "pre_ln", "pre_ln_residual"])
def test_int8_mlp_streamed_plain_matches_jax_kernel(dtype, act, variant):
    """k 128 → hidden 576 → 128 in slabs of 256: the last slab is ragged."""
    rng = np.random.default_rng(30 + len(act))
    params = {"fc": _qlinear(rng, 128, 576, dtype), "proj": _qlinear(rng, 576, 128, dtype)}
    ln, x = _ln(rng, 128), _arr(rng, 2, 61, 128)
    pre = variant != "plain"
    res = variant == "pre_ln_residual"
    ref = jstreamed(_jax_tree(params, dtype), jnp.asarray(x, getattr(jnp, dtype)),
                    activation=act, pre_ln=_jax_tree(ln, "float32") if pre else None,
                    add_residual=res, chunk=256, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = int8_mlp.int8_mlp_streamed.launches
    got = int8_mlp.int8_mlp_streamed(_torch_tree(params, dtype), tx, activation=act,
                                     pre_ln=_torch_tree(ln, "float32") if pre else None,
                                     add_residual=res, chunk=256)
    assert int8_mlp.int8_mlp_streamed.launches == before
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_int8_close(got.float().numpy(), ref, dtype,
                      _mlp_step(params, tx, act, _torch_tree(ln, "float32") if pre else None))


def test_int8_mlp_streamed_slabs_are_part_of_the_numerics():
    """One slab over the whole hidden is the resident kernel's global
    requantization; narrower slabs give another result."""
    rng = np.random.default_rng(40)
    params = _torch_tree({"fc": _qlinear(rng, 64, 512, "float32"),
                          "proj": _qlinear(rng, 512, 64, "float32")}, "float32")
    x = torch.from_numpy(_arr(rng, 9, 64))
    whole = int8_mlp.int8_mlp_streamed(params, x, activation="gelu", chunk=512)
    torch.testing.assert_close(whole, int8_mlp.int8_mlp_plain(params, x, activation="gelu"),
                               atol=1e-6, rtol=1e-6)
    slabs = int8_mlp.int8_mlp_streamed(params, x, activation="gelu", chunk=128)
    assert not torch.allclose(slabs, whole, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="pre_ln"):
        int8_mlp.int8_mlp_streamed(params, x, add_residual=True)


@pytest.fixture()
def card_gates(monkeypatch):
    """The gates as on the card, for CPU tensors (each kernel wrapper then
    runs its plain version)."""
    monkeypatch.setattr(int8_mlp, "on_card", lambda x: True)
    monkeypatch.setattr(qkv, "on_card", lambda x: True)


@pytest.mark.parametrize("rows,want", [(512, "int8_mlp_streamed"), (511, "unfused")])
def test_layers_mlp_routes_to_kernel_7_where_jax_streams(card_gates, monkeypatch, rows, want):
    """PE-Core-bigG's 27.5 MB of int8 MLP weights: at 512 rows or more the
    JAX package streams them (per-slab requantization), so does the port."""
    rng = np.random.default_rng(41)
    big = {"fc": {"w_q": torch.from_numpy(rng.integers(-127, 128, (1536, 8960), np.int8)),
                  "w_scale": torch.full((8960,), 1e-3)},
           "proj": {"w_q": torch.from_numpy(rng.integers(-127, 128, (8960, 1536), np.int8)),
                    "w_scale": torch.full((1536,), 1e-3)}}
    x = torch.from_numpy(_arr(rng, rows, 1536))
    assert not int8_mlp.fits_fused_mlp(big, "gelu", x)
    assert int8_mlp.fits_streamed_mlp(big, "gelu", rows, x) == (want != "unfused")
    calls = []
    real = int8_mlp.int8_mlp_streamed
    monkeypatch.setattr(layers, "int8_mlp_streamed",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    with torch.inference_mode():
        got = layers.mlp(big, x, activation=layers.gelu)
    assert len(calls) == (1 if want != "unfused" else 0)
    if calls:
        assert calls[0]["activation"] == "gelu"
        torch.testing.assert_close(got, int8_mlp.int8_mlp_streamed_plain(
            big, x, activation="gelu"), atol=0, rtol=0)


# -- the tower, the config, the entry point -------------------------------------

def _pe_model_cfg(image=32, patch=8, **pe):
    return {"embed_dim": EMBED,
            "vision_cfg": {"image_size": image,
                           "timm_model_name": f"vit_pe_core_gigantic_patch{patch}_448",
                           "pe_cfg": {"width": W, "layers": LAYERS, "heads": HEADS,
                                      "mlp_hidden": MLP, **pe}},
            "text_cfg": {"context_length": 12, "vocab_size": 512, "width": 64,
                         "heads": 4, "layers": 2}}


@pytest.mark.parametrize("name", ["vit_pe_core_bigG_patch14_448", "vit_pe_core_bigg_patch14_448",
                                  "vit_pe_core_gigantic_patch14_448",
                                  "vit_pe_core_large_patch14_336",
                                  "vit_pe_core_base_patch16_224"])
def test_resolve_pe_core_matches_jax(name):
    vision = {"image_size": 448, "timm_model_name": name, "timm_proj": "linear"}
    got = tbuild.resolve_vision(ModelCfg.from_dict(
        {"embed_dim": 1280, "vision_cfg": vision, "text_cfg": {}}))
    ref = jbuild.resolve_vision(JModelCfg.from_dict(
        {"embed_dim": 1280, "vision_cfg": vision, "text_cfg": {}}))
    assert got.family == ref.family == "vit"
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)
    assert got.cfg.rope_2d and got.cfg.pool == "map" and got.cfg.pool_heads == 8


def test_resolve_pe_core_overrides_and_warning(caplog):
    from clip_embedder_tpu_torch.utils import logging as tlogging

    tlogging._warned_once.clear()
    over = {"width": 256, "layers": 3, "heads": 8, "mlp_hidden": 512, "patch_size": 16,
            "ln_eps": 1e-6, "pool_heads": 4, "pool_mlp_hidden": 640,
            "use_layer_scale": True, "rope_temperature": 100.0}
    vision = {"image_size": 64, "timm_model_name": "vit_pe_core_large_patch14_336",
              "pe_cfg": over}
    got = tbuild.resolve_vision(ModelCfg.from_dict(
        {"embed_dim": 32, "vision_cfg": vision, "text_cfg": {}}))
    ref = jbuild.resolve_vision(JModelCfg.from_dict(
        {"embed_dim": 32, "vision_cfg": vision, "text_cfg": {}}))
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)
    assert (got.cfg.width, got.cfg.patch_size, got.cfg.pool_mlp_hidden) == (256, 16, 640)
    assert "taken from the published" not in caplog.text  # every table field was given
    with pytest.raises(Exception, match="Unsupported PE-Core variant"):
        tbuild.resolve_vision(ModelCfg.from_dict(
            {"embed_dim": 32, "vision_cfg": {"image_size": 64,
                                             "timm_model_name": "vit_pe_core_tiny_patch14_224"},
             "text_cfg": {}}))
    logger = tlogging.get_logger()
    logger.addHandler(caplog.handler)
    try:
        tbuild.resolve_vision(ModelCfg.from_dict(
            {"embed_dim": 32, "vision_cfg": {"image_size": 448,
                                             "timm_model_name": "vit_pe_core_bigG_patch14_448"},
             "text_cfg": {}}))
    finally:
        logger.removeHandler(caplog.handler)
    assert "width,layers,heads,mlp_hidden" in caplog.text


def _jax_pe_tower(image=32, patch=8, seed=0):
    spec = jbuild.resolve_vision(JModelCfg.from_dict(_pe_model_cfg(image, patch)))
    params = jax.tree.map(np.asarray, jvit.init(jax.random.key(seed), spec.cfg))
    return spec.cfg, params


def test_pe_core_init_layout_is_the_jax_layout():
    jcfg, params = _jax_pe_tower()
    pcfg = tvit.ViTCfg(**dataclasses.asdict(jcfg))
    tshapes = {k: tuple(v.shape) for k, v in tweights._flatten(
        tvit.init(pcfg, device="meta")).items()}
    assert tshapes == {k: v.shape for k, v in tweights._flatten(params).items()}
    for key in ("ln_pre/scale", "cls_token", "attn_pool/mlp/fc/w", "attn_pool/probe"):
        assert key in tshapes
    assert tshapes["pos_embed"] == (1, jcfg.num_patches + 1, W)
    tower_tree = tweights.params_from_numpy(params, device="cpu", dtype=torch.float32)
    tweights.validate_tower_pytree(tower_tree, tbuild.TowerSpec("vit", pcfg), source="mem")


@pytest.mark.parametrize("impl", ["eager", "kernel", "kernel_fast"])
def test_pe_core_tower_matches_jax(impl, jax_kernels_interpreted):
    """Port ``eager`` against JAX ``xla``; port ``kernel``/``kernel_fast``
    against JAX ``pallas``/``pallas_fast`` with its kernels interpreted."""
    jcfg, params = _jax_pe_tower()
    pixels = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvit.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(pixels), jcfg,
                                attn_impl=JAX_IMPL[impl]))
    tower = tvit.ViT(tvit.ViTCfg(**dataclasses.asdict(jcfg)),
                     tweights.params_from_numpy(params, device="cpu", dtype=torch.float32))
    with torch.inference_mode():
        got = tower(torch.from_numpy(pixels), attn_impl=impl).numpy()
    assert got.shape == ref.shape == (2, EMBED)
    assert _cos_min(got, ref) > 1 - 1e-6, impl
    np.testing.assert_allclose(got, ref, atol=5e-4)


@pytest.fixture(scope="module")
def pe_model_dir(tmp_path_factory):
    """A PE-Core model dir at PE-Core-bigG's geometry (448 px, patch 14: 1024
    patches and the cls token) and narrow widths, weights from the JAX
    package's init written by its save_pytree."""
    d = tmp_path_factory.mktemp("pe_core_model")
    occ = {"model_cfg": _pe_model_cfg(image=448, patch=14),
           "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5],
                              "interpolation": "bilinear", "resize_mode": "squash"}}
    (d / "open_clip_config.json").write_text(json.dumps(occ))
    (d / "model_config.json").write_text(json.dumps(
        {"tokenizer_needs_lowercase": False, "activation_function": "softmax",
         "logit_scale": 100.0, "logit_bias": 0.0, "pad_id": 0, "vocab_size": 512}))
    (d / "tokenizer.json").write_text(json.dumps(make_clip_style_spec()))
    cfg = JOpenClipConfig.from_dict(occ).model_cfg
    jsave_pytree(d / "visual.npz", jvit.init(jax.random.key(0), jbuild.resolve_vision(cfg).cfg))
    jsave_pytree(d / "text.npz",
                 jtext.init(jax.random.key(1), jbuild.resolve_text(cfg).cfg))
    return d


@pytest.mark.parametrize("mode", [None, "int8", "int8_all"])
def test_pe_core_clip_from_local_dir_matches_jax_clip(pe_model_dir, mode):
    """None at the golden tolerances, int8 at the cosine 1 - 1e-5 that the
    SigLIP towers hold. int8_all's image embedding at 1 - 3e-4: this
    2-layer, 48-wide random model with 1025 tokens a row turns one flipped
    int8 code into a large move. A 1e-7 relative perturbation of the pixels
    moves the port's own int8_all embedding by 9.2e-5 in cosine; the port
    against the JAX package differs by 1.6e-4, the same size (both measured
    on the CPU)."""
    clip = Clip.from_local_dir(pe_model_dir, device="cpu", quantize=mode)
    jclip = JaxClip.from_local_dir(pe_model_dir, quantize=mode)
    cfg = clip.vision.tower.cfg
    assert (cfg.rope_2d, cfg.seq_len, cfg.head_dim) == (True, 1025, 32)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in ((300, 500), (97, 61))]
    pixels = clip.vision.preprocess_batch(images)
    assert pixels.shape == (2, 3, 448, 448)
    np.testing.assert_allclose(pixels, jclip.vision.preprocess_batch(images), atol=1e-5)
    texts = ["a photo of a cat", "the dog!"]
    got_v, ref_v = clip.vision.embed_images(images), jclip.vision.embed_images(images)
    got_t, ref_t = clip.text.embed_texts(texts), jclip.text.embed_texts(texts)
    np.testing.assert_allclose(np.linalg.norm(got_v, axis=-1), 1.0, atol=1e-5)
    if mode is None:
        for g, r in ((got_v, ref_v), (got_t, ref_t)):
            assert _cos_min(g, r) > 1 - 1e-6
            np.testing.assert_allclose(g, r, atol=5e-4)
    else:
        assert "w_q" in clip.vision.tower.blocks[0]["mlp"]["fc"]
        assert _cos_min(got_v, ref_v) >= 1 - (3e-4 if mode == "int8_all" else 1e-5)
        assert _cos_min(got_t, ref_t) >= 1 - 1e-5
    labels = ["a cat", "a dog", "a car"]
    assert [r[0] for r in clip.classify(images[0], labels)] == \
        [r[0] for r in jclip.classify(images[0], labels)]


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_pe_core_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 7 (PE-Core-bigG-14-448 at full width, cut to one
    layer a tower and a small vocabulary) and its fixture phase on the CPU:
    every mode builds, embeds and classifies, the plain paths run, and no
    kernel is launched."""
    smoke = _chip_smoke()
    out = smoke.phase_pe_core("cpu", torch.float32, layers=1, vocab_size=512, batch=2,
                              timed=False)
    for label in ("float32", "int8", "int8_all"):
        assert set(out[label]["launches"].values()) == {0}
    _, vspec, tspec = smoke.build_clip("cpu", torch.float32, layers=1, vocab_size=512,
                                       model=smoke.PE_CORE_BIGG_448,
                                       preprocess=smoke.PE_PREPROCESS)
    v, t = vspec.cfg, tspec.cfg
    assert (v.width, v.heads, v.head_dim, v.seq_len, v.mlp_hidden, v.pool, v.rope_2d,
            v.pool_heads, v.pool_mlp_hidden, v.embed_dim) == \
        (1536, 16, 96, 1025, 8960, "map", True, 8, 6144, 1280)
    assert flash.head_group(v.heads, v.head_dim) is not None  # the packed kernel, with rope
    assert (t.width, t.heads, t.mlp_hidden, t.context_length, t.pool, t.causal) == \
        (1280, 20, 5120, 72, "argmax", True)
    assert set(smoke.phase_fixtures("cpu").values()) == {0}

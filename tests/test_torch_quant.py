"""The torch port's int8 (W8A8) slice against the JAX package, on the CPU.

* ``ops.quant``: the quantized weights equal the JAX package's;
* the fused kernels' plain versions (``int8_mlp``, ``ln_qkv_int8``,
  ``int8_linear_fused``) against the JAX Pallas kernels in interpret mode;
* the layers' routing of quantized weights (on the card's gates, with the
  plain versions standing in for the kernels);
* a 2-layer ViT and the ``golden_siglip`` ``Clip`` under ``quantize="int8"``
  and ``"int8_all"`` against the JAX package's same mode.

Tolerances. f32 outputs: atol 2e-5, the JAX package's own for its int8
kernels (tests/test_quant.py). bf16 outputs: one bf16 rounding step. On top
of that, the two frameworks sum a LayerNorm's row (and fuse the epilogue's
multiply-add) in different orders, which can move an f32 value by one unit
in the last place and so flip an int8 code by one. A flipped code moves
its row's outputs by at most one activation step (the row's amax / 127)
times the product's largest |dequantized weight|. So a few rows (at most
2% of them, and at least one allowed) may sit outside the base tolerance,
by at most ``FLIPS`` such steps.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu import Clip as JaxClip
from clip_embedder_tpu.models import hf_text as jhf
from clip_embedder_tpu.models import text_transformer as jtext
from clip_embedder_tpu.models import vit as jvit
from clip_embedder_tpu.ops import quant as jquant
from clip_embedder_tpu.ops.int8_mlp import int8_linear_fused as jlinear_fused
from clip_embedder_tpu.ops.int8_mlp import int8_mlp as jmlp
from clip_embedder_tpu.ops.qkv import ln_qkv_int8 as jln_qkv_int8
from clip_embedder_tpu_torch import Clip, TextEmbedder, VisionEmbedder
from clip_embedder_tpu_torch import weights as tweights
from clip_embedder_tpu_torch.errors import ConfigError
from clip_embedder_tpu_torch.models import hf_text as thf
from clip_embedder_tpu_torch.models import text_transformer as ttext
from clip_embedder_tpu_torch.models import vit as tvit
from clip_embedder_tpu_torch.ops import attention as tattn
from clip_embedder_tpu_torch.ops import int8_mlp, layers, qkv, quant

FIXTURES = Path(__file__).parent / "fixtures"
FLIPS = 4
ACTS = ["gelu_tanh", "gelu", "quick_gelu", "relu"]


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _qlinear(rng, k, n, dtype):
    """A quantized linear (the JAX package's quantize_weight) as numpy, the
    bias rounded to ``dtype`` as a loaded tree holds it."""
    q = jquant.quantize_weight(_arr(rng, k, n, scale=k ** -0.5))
    b = np.asarray(jnp.asarray(_arr(rng, n, scale=0.1), getattr(jnp, dtype)), np.float32)
    return {"w_q": q["w_q"], "w_scale": q["w_scale"], "b": b}


def _jax_tree(tree, dtype):
    def conv(k, v):
        return jnp.asarray(v, getattr(jnp, dtype)) if k == "b" else jnp.asarray(v)
    return {k: (_jax_tree(v, dtype) if isinstance(v, dict) else conv(k, v))
            for k, v in tree.items()}


def _torch_tree(tree, dtype):
    def conv(k, v):
        t = torch.from_numpy(np.array(v))
        return t.to(getattr(torch, dtype)) if k == "b" else t
    return {k: (_torch_tree(v, dtype) if isinstance(v, dict) else conv(k, v))
            for k, v in tree.items()}


def _ln(rng, width):
    return {"scale": 1 + _arr(rng, width, scale=0.1), "bias": _arr(rng, width, scale=0.1)}


def _step(x32, wq, ws):
    """One activation step times the product's largest |dequantized weight|."""
    amax = np.abs(x32).max(axis=-1)
    return float(amax.max() / 127.0 * (np.abs(wq.astype(np.float32)) * ws).max())


def assert_int8_close(got, ref, dtype, step):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if dtype == "float32":
        base = np.full(ref.shape, 2e-5, np.float32)
    else:
        mag = np.maximum(np.maximum(np.abs(got), np.abs(ref)), 1e-3)
        base = 2.0 ** (np.floor(np.log2(mag)) - 7)  # one bf16 step
    diff = np.abs(got - ref)
    off_rows = (diff > base).reshape(-1, ref.shape[-1]).any(axis=-1)
    assert off_rows.sum() <= max(1, int(0.02 * off_rows.size)), (off_rows.sum(), diff.max())
    assert (diff <= base + FLIPS * step).all(), (diff.max(), step)


# -- ops.quant ---------------------------------------------------------------

@pytest.mark.parametrize("clip", ["mse", "max"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40)], ids=["2d", "stacked"])
def test_quantize_weight_matches_jax(clip, shape):
    w = _arr(np.random.default_rng(0), *shape, scale=0.05)
    w[..., 3] = 0.0  # an all-zero channel takes scale amax = 1
    ref = jquant.quantize_weight(w, clip=clip)
    got = quant.quantize_weight(torch.from_numpy(w), clip=clip)
    assert got["w_q"].dtype == torch.int8 and got["w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_q"].numpy(), ref["w_q"])
    np.testing.assert_array_equal(got["w_scale"].numpy(), ref["w_scale"])


def test_quantize_weight_from_bf16_matches_jax():
    """The embedders quantize the tree as loaded in the working dtype."""
    w = jnp.asarray(_arr(np.random.default_rng(1), 64, 32, scale=0.05), jnp.bfloat16)
    ref = jquant.quantize_weight(np.asarray(w))
    got = quant.quantize_weight(torch.from_numpy(np.asarray(w, np.float32)).bfloat16())
    np.testing.assert_array_equal(got["w_q"].numpy(), ref["w_q"])
    np.testing.assert_array_equal(got["w_scale"].numpy(), ref["w_scale"])


def _tree_for_quant(rng):
    lin = lambda *s: {"w": _arr(rng, *s, scale=0.1), "b": _arr(rng, s[-1])}  # noqa: E731
    return {
        "proj": {"fc1": lin(16, 32), "fc2": lin(32, 16)},     # root proj: never quantized
        "blocks": {"attn": {n: lin(2, 16, 16) for n in ("q", "k", "v", "out")},
                   "mlp": {"fc": lin(2, 16, 64), "proj": lin(2, 64, 16)},
                   "ln1": {"scale": _arr(rng, 2, 16), "bias": _arr(rng, 2, 16)}},
        "stages": [{"ffn": {"fc1": {"w": _arr(rng, 1, 1, 16, 32)}}}],   # 1x1 conv
        "head": {"mlp": {"fc": lin(16, 8), "norm": {"scale": _arr(rng, 8)}}},
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("kw", [{}, {"paths": jquant.QUANT_PATHS_ALL},
                                {"paths": jquant.QUANT_PATHS_ALL, "exclude": ("out",)},
                                {"clip": "max"}],
                         ids=["default", "all", "all_exclude_out", "max"])
def test_quantize_tree_matches_jax(kw):
    tree = _tree_for_quant(np.random.default_rng(2))
    ref = _flat(jquant.quantize_tree(tree, **kw))
    got = _flat(quant.quantize_tree(tweights.to_device_tree(
        tweights.params_from_numpy(tree, device="cpu", dtype=torch.float32),
        device="cpu", dtype=torch.float32), **kw))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert "proj/fc1/w" in got and "stages/0/ffn/fc1/w_q" in got
    assert ("blocks/attn/out/w_q" in got) == ("paths" in kw and "exclude" not in kw)


def test_quantize_tree_checked_raises_when_nothing_quantizes():
    no_matmul = {"stem": {"conv": {"w": torch.zeros(3, 3, 3, 8)}}}
    for family in ("vit", "text_transformer"):
        with pytest.raises(ConfigError, match="no quantizable"):
            quant.quantize_tree_checked(no_matmul, family)
    got = quant.quantize_tree_checked({"blocks": {"attn": {"q": {"w": torch.ones(4, 4)}}}},
                                      "vit", mode="int8_all")
    assert "w_q" in got["blocks"]["attn"]["q"]


def test_to_device_tree_keeps_scales_f32_and_codes_int8():
    tree = {"w_q": torch.ones(4, 4, dtype=torch.int8), "w_scale": torch.ones(4),
            "b": torch.ones(4), "ln": [{"scale": torch.ones(4, dtype=torch.float64)}]}
    out = tweights.to_device_tree(tree, device="cpu", dtype=torch.bfloat16)
    assert out["w_q"].dtype == torch.int8 and out["w_scale"].dtype == torch.float32
    assert out["b"].dtype == torch.bfloat16 and out["ln"][0]["scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_int8_linear_matches_jax(dtype):
    rng = np.random.default_rng(3)
    p = _qlinear(rng, 64, 48, dtype)
    x = _arr(rng, 4, 10, 64)
    ref = jquant.int8_linear(_jax_tree(p, dtype), jnp.asarray(x, getattr(jnp, dtype)))
    got = quant.int8_linear(_torch_tree(p, dtype), torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert_int8_close(got.float().numpy(), ref, dtype, _step(x, p["w_q"], p["w_scale"]))


# -- the kernels' plain versions against the Pallas kernels ------------------

def _mlp_case(seed, dtype, k=64, hidden=272):
    """hidden 272: a multiple of 16 that no 128-wide tile divides."""
    rng = np.random.default_rng(seed)
    params = {"fc": _qlinear(rng, k, hidden, dtype), "proj": _qlinear(rng, hidden, k, dtype)}
    return params, _ln(rng, k), _arr(rng, 2, 61, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("variant", ["plain", "pre_ln", "pre_ln_residual"])
def test_int8_mlp_plain_matches_jax_kernel(dtype, act, variant):
    params, ln, x = _mlp_case(10 + ACTS.index(act), dtype)
    pre = variant != "plain"
    res = variant == "pre_ln_residual"
    ref = jmlp(_jax_tree(params, dtype), jnp.asarray(x, getattr(jnp, dtype)), activation=act,
               pre_ln=_jax_tree(ln, "float32") if pre else None, add_residual=res,
               interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = int8_mlp.int8_mlp(_torch_tree(params, dtype), tx, activation=act,
                            pre_ln=_torch_tree(ln, "float32") if pre else None,
                            add_residual=res)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_int8_close(got.float().numpy(), ref, dtype,
                      _mlp_step(params, tx, act, _torch_tree(ln, "float32") if pre else None))


def _mlp_step(params, tx, act, ln):
    """The MLP's flip allowance: the hidden's step (its row amax / 127)
    times fc2's largest |dequantized weight|."""
    x32 = tx.float().reshape(-1, tx.shape[-1])
    if ln is not None:
        x32 = int8_mlp.layer_norm_f32(x32, ln, 1e-6)
    xq, xs = int8_mlp.row_quant(x32)
    fc = _torch_tree(params["fc"], "float32")
    h = int8_mlp._act(int8_mlp.dequant(quant.int_matmul(xq, fc["w_q"]), xs, fc), act)
    return _step(h.numpy(), params["proj"]["w_q"], params["proj"]["w_scale"])


def test_int8_mlp_residual_requires_pre_ln():
    params, _, x = _mlp_case(20, "float32")
    with pytest.raises(ValueError, match="pre_ln"):
        int8_mlp.int8_mlp(_torch_tree(params, "float32"), torch.from_numpy(x),
                          add_residual=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_int8_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(30)
    width = 128
    params = {n: _qlinear(rng, width, width, dtype) for n in "qkv"}
    ln, x = _ln(rng, width), _arr(rng, 2, 61, width)
    ref = jln_qkv_int8(_jax_tree(params, dtype), _jax_tree(ln, "float32"),
                       jnp.asarray(x, getattr(jnp, dtype)), eps=1e-6, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = qkv.ln_qkv_int8(_torch_tree(params, dtype), _torch_tree(ln, "float32"), tx, eps=1e-6)
    y = int8_mlp.layer_norm_f32(tx.float(), _torch_tree(ln, "float32"), 1e-6).numpy()
    for n, g, r in zip("qkv", got, ref):
        assert g.dtype == tx.dtype and g.shape == tx.shape
        assert_int8_close(g.float().numpy(), r, dtype,
                          _step(y, params[n]["w_q"], params[n]["w_scale"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_int8_linear_fused_plain_matches_jax_kernel(dtype, with_residual):
    rng = np.random.default_rng(40)
    p = _qlinear(rng, 96, 80, dtype)
    x, r = _arr(rng, 2, 61, 96), _arr(rng, 2, 61, 80)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jlinear_fused(_jax_tree(p, dtype), jnp.asarray(x, jd),
                        residual=jnp.asarray(r, jd) if with_residual else None, interpret=True)
    got = int8_mlp.int8_linear_fused(_torch_tree(p, dtype), torch.from_numpy(x).to(td),
                                     residual=torch.from_numpy(r).to(td) if with_residual
                                     else None)
    assert got.dtype == td
    assert_int8_close(got.float().numpy(), ref, dtype, _step(x, p["w_q"], p["w_scale"]))


# -- routing ----------------------------------------------------------------

def test_gates_keep_the_cpu_on_the_unfused_path():
    rng = np.random.default_rng(50)
    params, _, x = _mlp_case(50, "float32")
    tp, tx = _torch_tree(params, "float32"), torch.from_numpy(x)
    assert not int8_mlp.fits_fused_mlp(tp, "gelu_tanh", tx)
    assert not int8_mlp.fits_fused_linear(tp["fc"], tx)
    sq = {n: _torch_tree(_qlinear(rng, 64, 64, "float32"), "float32") for n in "qkv"}
    assert not qkv.fits_fused_qkv_int8(sq, tx)
    assert not qkv.fits_fused_qkv(sq, tx)
    # and the unfused MLP is the JAX package's unfused MLP
    jx = jnp.asarray(x)
    from clip_embedder_tpu.ops.layers import gelu_tanh as jgelu_tanh
    from clip_embedder_tpu.ops.layers import mlp as jax_mlp
    ref = jax_mlp(_jax_tree(params, "float32"), jx, activation=jgelu_tanh)
    got = layers.mlp(tp, tx, activation=layers.gelu_tanh)
    assert_int8_close(got.numpy(), ref, "float32", 1.0)


@pytest.fixture()
def card_gates(monkeypatch):
    """The gates as on the card, for CPU tensors: each kernel wrapper then
    runs its plain version, so the routing is what the card would take."""
    monkeypatch.setattr(int8_mlp, "on_card", lambda x: True)
    monkeypatch.setattr(qkv, "on_card", lambda x: True)


def test_card_gates_on_kernel_shapes(card_gates):
    x = torch.zeros(2, 3, 64)
    q = {"w_q": torch.zeros(64, 32, dtype=torch.int8), "w_scale": torch.ones(32)}
    assert int8_mlp.fits_fused_linear(q, x)
    # any width, as the JAX gate: the kernel pads what is no multiple of 16
    assert int8_mlp.fits_fused_linear({**q, "w_q": torch.zeros(64, 24, dtype=torch.int8)}, x)
    assert not int8_mlp.fits_fused_linear({**q, "w_q": torch.zeros(48, 32, dtype=torch.int8)},
                                          x)  # another input width
    assert not int8_mlp.fits_fused_linear({"w": torch.zeros(64, 32)}, x)
    mlp = {"fc": {"w_q": torch.zeros(64, 272, dtype=torch.int8)},
           "proj": {"w_q": torch.zeros(272, 64, dtype=torch.int8)}}
    assert int8_mlp.fits_fused_mlp(mlp, "gelu", x)
    assert not int8_mlp.fits_fused_mlp(mlp, "silu", x)
    assert not int8_mlp.fits_streamed_mlp(mlp, "gelu", 4096, x)
    sq = {n: {"w_q": torch.zeros(64, 64, dtype=torch.int8)} for n in "qkv"}
    assert qkv.fits_fused_qkv_int8(sq, x)
    assert not qkv.fits_fused_qkv_int8({**sq, "v": {"w": torch.zeros(64, 64)}}, x)


def test_streamed_mlp_takes_kernel_7_not_kernel_4(card_gates, monkeypatch):
    """Over 20 MB of int8 weights the JAX package streams the MLP (per-slab
    requantization, kernel 7): the port routes it to ``int8_mlp_streamed``,
    never to the resident kernel's numerics (tests/test_torch_pe_core.py
    holds the streamed numerics against the JAX kernel)."""
    big = {"fc": {"w_q": torch.zeros(1536, 8960, dtype=torch.int8, device="meta")},
           "proj": {"w_q": torch.zeros(8960, 1536, dtype=torch.int8, device="meta")}}
    x = torch.zeros(2, 256, 1536, device="meta")
    assert not int8_mlp.fits_fused_mlp(big, "gelu", x)
    assert int8_mlp.fits_streamed_mlp(big, "gelu", 512, x)
    calls = []
    monkeypatch.setattr(layers, "int8_mlp", lambda *a, **kw: calls.append("int8_mlp"))
    monkeypatch.setattr(layers, "int8_mlp_streamed",
                        lambda p, t, **kw: calls.append(("streamed", kw)) or t)
    assert layers.mlp(big, x, activation=layers.gelu) is x
    assert calls == [("streamed", {"activation": "gelu", "pre_ln": None, "ln_eps": 1e-6,
                                   "add_residual": False})]


SIGLIP_VIT = jvit.ViTCfg(
    image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_hidden=128,
    embed_dim=64, activation="gelu_tanh", use_class_token=False, use_ln_pre=False,
    pool="map", use_proj=False, ln_eps=1e-6, pos_embed_cls=False)
SIGLIP_TEXT = jtext.TextCfgResolved(
    context_length=12, vocab_size=300, width=64, heads=4, layers=2, mlp_hidden=128,
    embed_dim=64, activation="gelu_tanh", causal=False, pool="last", proj_bias=True,
    ln_eps=1e-6)


def _cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _quantized_towers(mode):
    jp = jax.tree.map(np.asarray, jvit.init(jax.random.key(0), SIGLIP_VIT))
    tp = tweights.params_from_numpy(jp, device="cpu", dtype=torch.float32)
    jq = jquant.quantize_tree_checked(jp, "vit", mode=mode)
    tq = quant.quantize_tree_checked(tp, "vit", mode=mode)
    return jq, tvit.ViT(tvit.ViTCfg(**dataclasses.asdict(SIGLIP_VIT)), tq)


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_vit_quantized_matches_jax(mode):
    jq, tower = _quantized_towers(mode)
    pixels = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvit.apply(jax.tree.map(jnp.asarray, jq), pixels, SIGLIP_VIT))
    for impl in ("eager", "kernel"):
        with torch.inference_mode():
            got = tower(torch.from_numpy(pixels), attn_impl=impl).numpy()
        assert _cos_min(got, ref) >= 1 - 1e-5, impl


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_text_quantized_matches_jax(mode):
    jp = jax.tree.map(np.asarray, jtext.init(jax.random.key(3), SIGLIP_TEXT))
    tp = tweights.params_from_numpy(jp, device="cpu", dtype=torch.float32)
    jq = jquant.quantize_tree_checked(jp, "text_transformer", mode=mode)
    tower = ttext.TextTransformer(ttext.TextCfgResolved(**dataclasses.asdict(SIGLIP_TEXT)),
                                  quant.quantize_tree_checked(tp, "text_transformer", mode=mode))
    ids = np.random.default_rng(4).integers(1, 300, (3, 12)).astype(np.int32)
    ref = np.asarray(jtext.apply(jax.tree.map(jnp.asarray, jq), ids, SIGLIP_TEXT))
    with torch.inference_mode():
        got = tower(torch.from_numpy(ids)).numpy()
    assert _cos_min(got, ref) >= 1 - 1e-5


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_vit_on_card_gates_launches_and_agrees(mode, card_gates, monkeypatch):
    """With the card's gates, one ViT forward (2 blocks + map pool) calls
    the int8 wrappers as often as chip_smoke.py asserts per tower forward,
    and agrees with the unfused path."""
    calls = {"int8_mlp": 0, "ln_qkv_int8": 0, "int8_linear_fused": 0, "ln_qkv": 0}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(layers, "int8_mlp")
    spy(layers, "int8_linear_fused")
    spy(tattn, "int8_linear_fused")
    spy(tattn, "ln_qkv_int8")
    spy(tattn, "ln_qkv")
    _, tower = _quantized_towers(mode)
    # batch 8: 8 x 16 tokens = 128 rows, the fused linear's least
    pixels = torch.from_numpy(
        np.random.default_rng(2).standard_normal((8, 32, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        got = tower(pixels, attn_impl="kernel").numpy()
    layers_n = SIGLIP_VIT.layers
    want = ({"int8_mlp": layers_n + 1, "ln_qkv": layers_n, "ln_qkv_int8": 0,
             "int8_linear_fused": 0} if mode == "int8" else
            {"int8_mlp": layers_n + 1, "ln_qkv": 0, "ln_qkv_int8": layers_n,
             "int8_linear_fused": layers_n + 2})
    assert calls == want
    monkeypatch.undo()
    with torch.inference_mode():
        ref = tower(pixels, attn_impl="eager").numpy()
    assert _cos_min(got, ref) >= 1 - 1e-5


BERT = jhf.BertCfg(context_length=40, vocab_size=120, width=128, heads=2, layers=2,
                   mlp_hidden=256, embed_dim=96, pooler="mean", proj="mlp")


def _bert_ids(batch):
    ids = np.random.default_rng(5).integers(3, 120, (batch, 40)).astype(np.int32)
    for i in range(batch):
        ids[i, 40 - 7 * i:] = 0  # a key length per row
    return ids


def _quantized_bert(mode):
    jp = jax.tree.map(np.asarray, jhf.init(jax.random.key(6), BERT))
    tp = tweights.params_from_numpy(jp, device="cpu", dtype=torch.float32)
    jq = jquant.quantize_tree_checked(jp, "hf_bert", mode=mode)
    tq = quant.quantize_tree_checked(tp, "hf_bert", mode=mode)
    assert "w_q" not in tq["proj"]["fc"]  # the root proj stays in full precision
    return jq, thf.HFText(thf.BertCfg(**dataclasses.asdict(BERT)), tq)


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_bert_quantized_matches_jax(mode):
    jq, tower = _quantized_bert(mode)
    ids = _bert_ids(3)
    ref = np.asarray(jhf.apply(jax.tree.map(jnp.asarray, jq), jnp.asarray(ids), BERT))
    for impl in ("eager", "kernel"):
        with torch.inference_mode():
            got = tower(torch.from_numpy(ids), attn_impl=impl).numpy()
        assert _cos_min(got, ref) >= 1 - 1e-5, impl


@pytest.mark.parametrize("batch", [4, 2], ids=["160rows", "80rows"])
@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_bert_on_card_gates_routes_as_jax(mode, batch, card_gates, monkeypatch):
    """BERT is post-LN, so with the card's gates: each block's MLP takes
    kernel 4 (int8_mlp) with no LayerNorm and no residual; under int8_all
    q, k, v and the out-projection go through ``linear``'s gate, as in the
    JAX package's ``ops.layers.linear``: kernel 6 (int8_linear_fused) with no
    residual at 128 rows or more, the unfused int8_linear below; neither
    ln_qkv_int8 nor ln_qkv runs (no pre_ln). The kernel path agrees with the
    unfused one."""
    calls = []

    def spy(module, name, keys=()):
        real = getattr(module, name)

        def wrapped(*a, **kw):
            calls.append((name,) + tuple(kw.get(k) is not None and kw.get(k) is not False
                                         for k in keys))
            return real(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)

    spy(layers, "int8_mlp", ("pre_ln", "add_residual"))
    spy(layers, "int8_linear_fused", ("residual",))
    spy(tattn, "int8_linear_fused", ("residual",))
    spy(layers, "int8_linear")
    spy(tattn, "ln_qkv_int8")
    spy(tattn, "ln_qkv")
    _, tower = _quantized_bert(mode)
    ids = torch.from_numpy(_bert_ids(batch))
    with torch.inference_mode():
        got = tower(ids, attn_impl="kernel").numpy()
    linears = ([("int8_linear_fused", False)] if batch * 40 >= 128
               else [("int8_linear",)]) * 4 if mode == "int8_all" else []
    per_block = linears + [("int8_mlp", False, False)]
    # the pooled rows' MLP projection (B rows) stays unquantized: no call
    assert calls == per_block * BERT.layers
    monkeypatch.undo()
    with torch.inference_mode():
        ref = tower(ids, attn_impl="eager").numpy()
    assert _cos_min(got, ref) >= 1 - 1e-5


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_clip_quantized_matches_jax_clip(mode):
    fixture = FIXTURES / "golden_siglip"
    clip = Clip.from_local_dir(fixture, device="cpu", quantize=mode)
    jclip = JaxClip.from_local_dir(fixture, quantize=mode)
    assert clip.vision.quantize == clip.text.quantize == mode
    assert "w_q" in clip.vision.tower.blocks[0]["mlp"]["fc"]
    assert ("w_q" in clip.vision.tower.blocks[0]["attn"]["q"]) == (mode == "int8_all")
    img = np.load(fixture / "golden_image.npy")
    rng = np.random.default_rng(0)
    images = [img, rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)]
    texts = ["a photo of a cat", "the dog!", "an unusually long caption " * 8]
    assert _cos_min(clip.vision.embed_images(images), jclip.vision.embed_images(images)) \
        >= 1 - 1e-5
    assert _cos_min(clip.text.embed_texts(texts), jclip.text.embed_texts(texts)) >= 1 - 1e-5
    labels = ["a cat", "a dog", "a car", "the ocean"]
    assert [r[0] for r in clip.classify(img, labels)] == \
        [r[0] for r in jclip.classify(img, labels)]
    dup = clip.duplicate()
    assert dup.vision.quantize == dup.text.quantize == mode
    np.testing.assert_array_equal(dup.vision.embed_image(img), clip.vision.embed_image(img))


def test_unknown_quantize_mode_raises():
    fixture = FIXTURES / "golden_siglip"
    for entry in (Clip, VisionEmbedder, TextEmbedder):
        with pytest.raises(ConfigError, match="Unknown quantize mode"):
            entry.from_local_dir(fixture, device="cpu", quantize="fp4")


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_int8_paths_rehearse_on_cpu():
    """chip_smoke.py's int8 phase (SO400M at full width, cut to one layer and
    a small vocabulary) on the CPU: both modes build, quantize, embed and
    classify, the plain-wrapper swap runs, and no kernel is launched."""
    smoke = _chip_smoke()
    out = smoke.phase_int8_paths("cpu", torch.float32, layers=1, vocab_size=512, batch=3,
                                 timed=False)
    for mode in ("int8", "int8_all"):
        assert set(out[mode]["launches"].values()) == {0}
    smoke.phase_fixtures_quantized("cpu")


def test_chip_smoke_expected_int8_launches_match_the_routing():
    """The counts chip_smoke.py asserts on the card, per tower forward, are
    the ones the card's gates give (test_vit_on_card_gates_launches_and_agrees
    counts the same routing on the CPU)."""
    smoke = _chip_smoke()
    assert smoke.expected_int8_launches("int8", 27, 27) == {
        "ln_qkv": 81, "flash_attention_packed": 81, "flash_attention": 0, "int8_mlp": 83,
        "int8_mlp_streamed": 0, "ln_qkv_int8": 0, "int8_linear_fused": 0}
    assert smoke.expected_int8_launches("int8_all", 27, 27) == {
        "ln_qkv": 0, "flash_attention_packed": 81, "flash_attention": 0, "int8_mlp": 83,
        "int8_mlp_streamed": 0, "ln_qkv_int8": 81, "int8_linear_fused": 85}
    # PE-Core-bigG: 50 vision blocks stream their MLPs, 24 text blocks and
    # the two map-pool heads take int8_mlp
    assert smoke.expected_int8_launches(None, 50, 24, streamed=True) == {
        "ln_qkv": 124, "flash_attention_packed": 124, "flash_attention": 0, "int8_mlp": 0,
        "int8_mlp_streamed": 0, "ln_qkv_int8": 0, "int8_linear_fused": 0}
    assert smoke.expected_int8_launches("int8", 50, 24, streamed=True) == {
        "ln_qkv": 124, "flash_attention_packed": 124, "flash_attention": 0, "int8_mlp": 26,
        "int8_mlp_streamed": 100, "ln_qkv_int8": 0, "int8_linear_fused": 0}
    assert smoke.expected_int8_launches("int8_all", 50, 24, streamed=True) == {
        "ln_qkv": 0, "flash_attention_packed": 124, "flash_attention": 0, "int8_mlp": 26,
        "int8_mlp_streamed": 100, "ln_qkv_int8": 124, "int8_linear_fused": 128}

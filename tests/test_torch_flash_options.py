"""Kernel 2's int8 and schedule options (``quant_qk``, ``quant_pv``,
``mxu_denom``, ``pair_exp``, ``group_mult``): the port's plain version
against the JAX Pallas kernel in interpret mode (the schedule options where
the JAX kernel applies them and where it ignores them).

The JAX side is compiled with ``xla_allow_excess_precision`` off: by default
XLA on the CPU keeps f32 where the kernel rounds to bf16 (``exp_bf16``'s
round trip, and the bf16 p/scale of ``quant_pv`` under it), which the port
and the TPU both do. One input set per shape is shared by every case, since
a JAX compile per flag set is what the file costs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu.ops.attention import causal_mask as jcausal
from clip_embedder_tpu.ops.flash import flash_attention_packed as jflash
from clip_embedder_tpu.ops.rope import apply_rope as japply_rope
from clip_embedder_tpu_torch.ops import flash
from clip_embedder_tpu_torch.ops.rope import head_tiled_tables

SO400M_LIKE = (2, 61, 16, 72)  # ragged S, the main path's head dim, g = 16
TEXT_LIKE = (2, 64, 2, 64)     # g = 2: pair_exp acts, group_mult=2 does not
WIDE = (2, 64, 2, 128)         # g = 1: group_mult=2 acts, pair_exp alone does not

# tools/profile_attn_variants.py's flag sets, and each new option alone
PROFILER = {
    "exact": {}, "exp_bf16": {"exp_bf16": True}, "quant_qk": {"quant_qk": True},
    "quant_qk+exp_bf16": {"quant_qk": True, "exp_bf16": True},
    "fast": {"fast_softmax": True}, "fast+exp_bf16": {"fast_softmax": True, "exp_bf16": True},
    "fast+pair_exp": {"fast_softmax": True, "pair_exp": True}, "pair_exp": {"pair_exp": True},
    "fast+group_mult2": {"fast_softmax": True, "group_mult": 2},
    "fast+pair+gm2": {"fast_softmax": True, "pair_exp": True, "group_mult": 2},
}
OPTIONS = {
    "quant_pv": {"quant_pv": True}, "quant_qk+quant_pv": {"quant_qk": True, "quant_pv": True},
    "quant_pv+exp_bf16": {"quant_pv": True, "exp_bf16": True},
    "quant_pv+fast+exp_bf16": {"quant_pv": True, "fast_softmax": True, "exp_bf16": True},
    "quant_qk+fast": {"quant_qk": True, "fast_softmax": True},
    "mxu_denom=False": {"mxu_denom": False}, "group_mult2": {"group_mult": 2},
}


@functools.lru_cache(maxsize=None)
def _inputs(b, s, h, d):
    rng = np.random.default_rng(11)
    qkv = tuple(rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(3))
    sin, cos = head_tiled_tables(rng.standard_normal((s, d)), h)
    masks = {"none": None, "causal": np.asarray(jcausal(s), np.float32),
             # a different key length in every batch row
             "key": np.where(np.arange(s)[None, :] < np.array([s, s // 3])[:b, None], 0.0,
                             -1e30).astype(np.float32)[:, None, None, :]}
    return qkv, (sin.numpy(), cos.numpy()), masks


def _both(shape, dtype, mask="none", rope=None, **flags):
    """(port, JAX) outputs as f32 numpy arrays on one input set. ``rope``:
    "kernel" hands the tables to the JAX kernel, "outside" rotates q and k
    with the JAX package's ``apply_rope`` first (the port takes the tables
    either way)."""
    b, s, h, d = shape
    qkv, tables, masks = _inputs(*shape)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    m = masks[mask]
    extra = {}
    if m is not None:
        extra["mask"] = jnp.asarray(m)
    args = tuple(jnp.asarray(a, jdt) for a in qkv)
    jtables = tuple(jnp.asarray(t) for t in tables)
    if rope == "kernel":
        extra["rope"] = jtables
    elif rope == "outside":
        args = (*(japply_rope(t, *jtables) for t in args[:2]), args[2])

    def call(q, k, v, kw):
        return jflash(q, k, v, num_heads=h, interpret=True, **kw, **flags)

    compiled = jax.jit(call).lower(*args, extra).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref = np.asarray(compiled(*args, extra), np.float32)
    got = flash.flash_attention_packed(
        *(torch.from_numpy(a).to(tdt) for a in qkv), num_heads=h,
        mask=None if m is None else torch.from_numpy(m.copy()),
        rope=tuple(torch.from_numpy(t) for t in tables) if rope else None, **flags)
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h * d)
    return got.float().numpy(), ref


def _close(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


QUANT = ["quant_qk", "quant_pv", "quant_qk+quant_pv", "quant_qk+exp_bf16", "quant_pv+exp_bf16",
         "quant_pv+fast+exp_bf16", "quant_qk+fast"]
UNQUANT = sorted((set(PROFILER) | set(OPTIONS)) - set(QUANT) - {"exact", "fast"})


@pytest.mark.parametrize("name", QUANT)
def test_plain_matches_jax_kernel_f32(name):
    flags = {**PROFILER, **OPTIONS}[name]
    _close(*_both(SO400M_LIKE, "float32", **flags), "float32")


@pytest.mark.parametrize("name", UNQUANT)
def test_plain_matches_jax_kernel_f32_unquantized(name):
    """The profiler's other flag sets and mxu_denom=False, at 2 x 64 heads
    (g = 2: pair_exp acts)."""
    flags = {**PROFILER, **OPTIONS}[name]
    _close(*_both(TEXT_LIKE, "float32", **flags), "float32")


@pytest.mark.parametrize("name", ["quant_qk", "quant_pv", "quant_qk+quant_pv",
                                  "quant_qk+exp_bf16", "quant_pv+exp_bf16", "fast+pair+gm2",
                                  "mxu_denom=False"])
def test_plain_matches_jax_kernel_bf16(name):
    flags = {**PROFILER, **OPTIONS}[name]
    _close(*_both(SO400M_LIKE, "bfloat16", **flags), "bfloat16")


@pytest.mark.parametrize("mask", ["causal", "key"])
@pytest.mark.parametrize("name", ["quant_qk", "quant_pv", "quant_qk+quant_pv",
                                  "quant_qk+fast", "quant_pv+fast+exp_bf16"])
def test_plain_matches_jax_kernel_masked(mask, name):
    """The masked path dequantizes q·kᵀ to f32 logits before the add; a key
    row masked after S/3 keys quantizes its p over the keys left."""
    flags = {**PROFILER, **OPTIONS}[name]
    _close(*_both(TEXT_LIKE, "float32", mask=mask, **flags), "float32")


@pytest.mark.parametrize("dtype,name", [
    ("float32", "quant_qk"), ("float32", "quant_qk+quant_pv"), ("bfloat16", "quant_qk"),
    ("bfloat16", "quant_pv"), ("bfloat16", "quant_qk+quant_pv")])
def test_plain_matches_jax_kernel_rope(dtype, name):
    """The codes are made from the rotated q and k."""
    flags = {**PROFILER, **OPTIONS}[name]
    _close(*_both(SO400M_LIKE, dtype, rope="kernel", **flags), dtype)


@pytest.mark.parametrize("name", ["quant_pv", "quant_qk+quant_pv"])
def test_plain_matches_jax_kernel_on_rotated_inputs_f32(name):
    """quant_pv with rope in f32, against the JAX kernel fed q and k rotated
    by the JAX package's ``apply_rope`` (bitwise the port's rotation). The
    JAX kernel's own in-kernel rotation, compiled by XLA on the CPU,
    contracts x·cos + rot·sin into an FMA (1 ulp off on 26% of the elements
    at this shape); under ``quant_pv`` the f32 logits carry that into p, and
    a p at a rounding boundary flips its code (up to 1.6e-3 on 0.05% of the
    elements): ROADMAP.md §3's standing divergences."""
    flags = {**PROFILER, **OPTIONS}[name]
    _close(*_both(SO400M_LIKE, "float32", rope="outside", **flags), "float32")


@pytest.mark.parametrize("name", ["pair_exp", "group_mult2", "fast+pair+gm2"])
def test_plain_matches_jax_kernel_where_the_schedule_options_act(name):
    """d = 128, 2 heads: the JAX group is g = 1, which group_mult=2 doubles
    (and pair_exp then pairs); pair_exp alone is ignored there."""
    flags = {**PROFILER, **OPTIONS}[name]
    _close(*_both(WIDE, "float32", **flags), "float32")


def test_option_routes_and_checks():
    """A quantized call routes to an int8 kernel whatever its dtype and head
    dim (bf16 with D a multiple of 8 to the TMA one, the rest to the first
    design); mxu_denom=False at a head dim that is no multiple of 128 leaves
    the TMA kernel; a group_mult of 1 or less is ignored, as in the JAX
    kernel; the schedule options change no value and a CPU call counts no
    launch."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in (8, 36, 72, 96, 128):
            tma = dtype == torch.bfloat16 and d % 8 == 0
            assert flash.kernel_route(d, dtype, quant=True) == (
                "int8_tma" if tma else "int8_wgmma")
        assert flash.kernel_route(129, dtype, quant=True) is None
    assert flash.kernel_route(72, torch.bfloat16, mxu_denom=False) == "mma_sync"
    assert flash.kernel_route(128, torch.bfloat16, mxu_denom=False) == "tma_wgmma"
    assert flash.kernel_route(72, torch.float32, mxu_denom=False) == "fma_f32"
    q = torch.randn(2, 8, 128)
    before = (flash.flash_attention_packed.launches,
              dict(flash.flash_attention_packed.quant_launches))
    base = flash.flash_attention_packed(q, q, q, num_heads=2)
    for kw in ({"pair_exp": True}, {"group_mult": 2}, {"pair_exp": True, "group_mult": 2},
               {"group_mult": 0}):
        assert torch.equal(flash.flash_attention_packed(q, q, q, num_heads=2, **kw), base)
    flash.flash_attention_packed(q, q, q, num_heads=2, quant_qk=True, quant_pv=True)
    assert (flash.flash_attention_packed.launches,
            flash.flash_attention_packed.quant_launches) == before


def test_int8_route_by_dtype_and_head_dim():
    """Every head dim the packed wrapper takes keeps an int8 route: bf16 with
    D a multiple of 8 the TMA kernel (csrc/flash_int8_tma.cu), f32 and any
    other D the first design (csrc/flash_int8.cu); quantized or not, the
    same shapes reach TMA."""
    for d in range(1, flash.MAX_HEAD_DIM + 1):
        want = "int8_tma" if d % 8 == 0 else "int8_wgmma"
        assert flash.kernel_route(d, torch.bfloat16, quant=True) == want
        assert flash.kernel_route(d, torch.float32, quant=True) == "int8_wgmma"
        assert (want == "int8_tma") == (flash.kernel_route(d, torch.bfloat16) == "tma_wgmma")
    assert flash.kernel_route(20, torch.bfloat16, quant=True) == "int8_wgmma"
    assert flash.kernel_route(72, torch.float32, quant=True) == "int8_wgmma"


def test_int8_tma_key_order_is_the_accumulator_fragment():
    """v's codes keep each 32 keys in ``frag_pos`` order: thread t of a quad
    holds keys 8m + 2t + (0, 1) of q·kᵀ's n8 tile m, and s8 wgmma's A
    fragment takes its 4 codes a register at 4t (tiles 0-1) and 16 + 4t
    (tiles 2-3) of each 32, so those keys land where its p codes go; a
    permutation within each 32 keys (p·v sums over keys in any order)."""
    keys = torch.arange(4 * 64)
    pos = flash.frag_pos(keys)
    assert torch.equal(pos.sort().values, keys)
    assert torch.equal(pos // 32, keys // 32)
    for m in range(4):
        for t in range(4):
            for j in range(2):
                key = 8 * m + 2 * t + j
                assert int(pos[key]) == 16 * (m // 2) + 4 * t + 2 * (m % 2) + j


def test_quantized_plain_is_exact_on_representable_inputs():
    """Inputs whose codes are exact (q·scale, k and v already multiples of
    their int8 step, one-hot softmax rows): the int8 products give the
    unquantized result, so the options change nothing but the rounding."""
    d, s = 64, 16
    eye = torch.eye(s, d) * 127.0 * d ** 0.5  # q·kᵀ·scale: 127² · 8 on the diagonal
    v = torch.randint(-127, 128, (1, s, d), generator=torch.Generator().manual_seed(0)).float()
    v[0, 0] = 127.0  # every column's scale is 1
    q = k = eye[None]
    exact = flash.flash_attention_packed(q, k, v, num_heads=1)
    torch.testing.assert_close(exact, v, atol=0, rtol=0)
    for kw in ({"quant_qk": True}, {"quant_pv": True}, {"quant_qk": True, "quant_pv": True}):
        got = flash.flash_attention_packed(q, k, v, num_heads=1, **kw)
        # (p's scale is the f32 1/127: one rounding off 1)
        torch.testing.assert_close(got, exact, atol=0, rtol=1e-6)


def test_quant_codes_plain_layout_and_rounding():
    """The codes the int8 kernel's pre-pass is held to on the card: per
    (batch·head), q's rows each reach ±127 at their max, k's slab at its
    max, v's columns at theirs; codes round half to even."""
    b, s, h, d = 2, 5, 2, 64
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, s, h * d, generator=g) for _ in range(3))
    c = flash.quant_codes(q, k, v, num_heads=h)  # a CPU tensor: the plain version
    assert c["q"].dtype == c["k"].dtype == c["v"].dtype == torch.int8
    assert tuple(c["q"].shape) == tuple(c["k"].shape) == tuple(c["v"].shape) == (b * h, s, d)
    assert (tuple(c["q_scale"].shape), tuple(c["k_scale"].shape), tuple(c["v_scale"].shape)) == (
        (b * h, s), (b * h,), (b * h, d))
    assert (c["q"].abs().amax(dim=-1) == 127).all()
    assert (c["k"].abs().amax(dim=(-2, -1)) == 127).all()
    assert (c["v"].abs().amax(dim=-2) == 127).all()
    heads_k = k.reshape(b, s, h, d).transpose(1, 2).reshape(b * h, s, d)
    assert torch.equal(c["k_scale"], heads_k.abs().amax(dim=(-2, -1)) / 127.0)
    # 2.5 steps rounds to 2, 3.5 to 4; a zero row has scale 1
    x = torch.zeros(1, 2, 64)
    x[0, 0, :3] = torch.tensor([127.0, 2.5, 3.5]) * 8.0  # × √64: the scale folded into q
    c = flash.quant_codes(x, x, x, num_heads=1)
    assert c["q"][0, 0, :3].tolist() == [127, 2, 4] and c["q_scale"][0].tolist() == [1.0, 1.0]

"""The CUDA kernels' plain PyTorch versions against the JAX Pallas kernels
(run in interpret mode on the CPU), and the wrappers' dispatch and gates.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu.ops.attention import causal_mask as jcausal
from clip_embedder_tpu.ops.flash import flash_attention_packed as jflash
from clip_embedder_tpu.ops.qkv import ln_qkv as jln_qkv
from clip_embedder_tpu_torch.ops import attention as tattn
from clip_embedder_tpu_torch.ops import flash, qkv


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _qkv_case(width=256, rows=(2, 61), seed=0):
    rng = np.random.default_rng(seed)
    params = {n: {"w": _arr(rng, width, width, scale=0.03), "b": _arr(rng, width, scale=0.01)}
              for n in "qkv"}
    pre_ln = {"scale": 1 + _arr(rng, width, scale=0.1), "bias": _arr(rng, width, scale=0.01)}
    return params, pre_ln, _arr(rng, *rows, width)


def _tree(tree, fn):
    return {k: _tree(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _bf16_ulp(x):
    """One bf16 unit in the last place at each element's magnitude."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_plain_matches_jax_kernel(dtype):
    params, pre_ln, x = _qkv_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jln_qkv(_tree(params, lambda a: jnp.asarray(a, jdt)),
                  _tree(pre_ln, jnp.asarray), jnp.asarray(x, jdt), eps=1e-6, interpret=True)
    got = qkv.ln_qkv(_tree(params, lambda a: torch.from_numpy(a).to(tdt)),
                     _tree(pre_ln, torch.from_numpy), torch.from_numpy(x).to(tdt), eps=1e-6)
    for g, r in zip(got, ref):
        assert g.dtype == tdt and g.shape == (2, 61, 256)
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
        else:
            # x̂ rounds to bf16 after f32 statistics summed in another
            # order: an output may land one rounding step away (ulps
            # taken at ≥1e-3, as near-zero outputs are cancellations)
            mag = np.maximum(np.maximum(np.abs(g), np.abs(r)), 1e-3)
            assert (np.abs(g - r) <= _bf16_ulp(mag)).all()


def _attn_case(b, s, h, d, dtype, seed=5):
    rng = np.random.default_rng(seed)
    return [_arr(rng, b, s, h * d) for _ in range(3)]


def _run_both(arrs, dtype, h, **kw):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmask = kw.pop("mask", None)
    tmask = None if jmask is None else torch.from_numpy(np.array(jmask))
    ref = jflash(*(jnp.asarray(a, jdt) for a in arrs), num_heads=h, mask=jmask,
                 interpret=True, **kw)
    got = flash.flash_attention_packed(*(torch.from_numpy(a).to(tdt) for a in arrs),
                                       num_heads=h, mask=tmask, **kw)
    return got.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("b,h,s,d", [(2, 16, 61, 72), (2, 8, 64, 64), (1, 16, 33, 8)])
@pytest.mark.parametrize("fast", [False, True])
def test_flash_plain_matches_jax_kernel(b, h, s, d, fast):
    got, ref = _run_both(_attn_case(b, s, h, d, "float32"), "float32", h, fast_softmax=fast)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


def test_flash_plain_matches_jax_kernel_causal():
    b, h, s, d = 2, 8, 77, 64
    got, ref = _run_both(_attn_case(b, s, h, d, "float32", seed=6), "float32", h,
                         mask=jcausal(s))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_flash_plain_matches_jax_kernel_bf16_exp_bf16(fast):
    b, h, s, d = 2, 16, 32, 72
    got, ref = _run_both(_attn_case(b, s, h, d, "bfloat16", seed=7), "bfloat16", h,
                         fast_softmax=fast, exp_bf16=True)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("fast", [False, True])
def test_flash_plain_matches_jax_kernel_f32_exp_bf16(fast):
    """exp_bf16 on f32 inputs, against the JAX kernel compiled with
    ``xla_allow_excess_precision`` off: XLA on the CPU otherwise keeps the
    exp's argument and result in f32 where the kernel rounds them to bf16
    (up to 1.5e-3 on 97% of the elements at this shape; ROADMAP.md §3)."""
    import jax

    b, h, s, d = 2, 16, 61, 72
    arrs = _attn_case(b, s, h, d, "float32", seed=9)
    args = [jnp.asarray(a) for a in arrs]
    kw = {"fast_softmax": fast, "exp_bf16": True}
    compiled = jax.jit(lambda q, k, v: jflash(q, k, v, num_heads=h, interpret=True, **kw)).lower(
        *args).compile(compiler_options={"xla_allow_excess_precision": False})
    ref = np.asarray(compiled(*args), np.float32)
    got = flash.flash_attention_packed(*(torch.from_numpy(a) for a in arrs), num_heads=h, **kw)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_flash_plain_lane_multiple_head_dim_sums_unrounded_p():
    """D a multiple of 128: the denominator is the f32 sum of p itself."""
    b, h, s, d = 1, 2, 16, 128
    got, ref = _run_both(_attn_case(b, s, h, d, "bfloat16", seed=8), "bfloat16", h)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


def test_flash_mask_forms():
    """The packed kernel's mask forms (``packed_mask``), as the JAX kernel
    tests them: key rows per batch element and full blocks per batch
    element beside the shared forms, each with its strides; a per-head mask
    and a key mask of the wrong width raise with the shape in the message."""
    q = torch.zeros(2, 8, 32)
    forms = ((torch.zeros(8, 8), (0, 8), "shared"), (torch.zeros(1, 1, 8, 8), (0, 8), "shared"),
             (torch.zeros(1, 1, 1, 8), (0, 0), "shared"),
             (torch.zeros(2, 1, 1, 8), (8, 0), "key"), (torch.zeros(2, 1, 8, 8), (64, 8), "full"))
    for m, strides, form in forms:
        got, sb, sr = flash.packed_mask(m, 2, 8)
        assert (sb, sr) == strides and flash.mask_form(sb, sr) == form
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert got.numel() == (2 if sb else 1) * (8 if sr else 1) * 8
        assert flash.flash_attention_packed(q, q, q, num_heads=4, mask=m).shape == q.shape
    # one batch row: a [1, 1, 1, S] mask is the shared key row, as in JAX
    assert flash.packed_mask(torch.zeros(1, 1, 1, 8), 1, 8)[1:] == (0, 0)
    with pytest.raises(ValueError, match=r"unsupported mask shape \(2, 4, 8, 8\)"):
        flash.flash_attention_packed(q, q, q, num_heads=4, mask=torch.zeros(2, 4, 8, 8))
    with pytest.raises(ValueError, match=r"unsupported mask shape \(2, 1, 1, 16\)"):
        flash.flash_attention_packed(q, q, q, num_heads=4, mask=torch.zeros(2, 1, 1, 16))
    with pytest.raises(ValueError, match="rope with a mask"):
        flash.flash_attention_packed(q, q, q, num_heads=4, mask=torch.zeros(2, 1, 1, 8),
                                     rope=(q[0], q[0]))
    with pytest.raises(ValueError, match="rope tables"):  # [S, H·D] tables, not q's shape
        flash.flash_attention_packed(q, q, q, num_heads=4, rope=(q, q))


def key_mask(lengths, s):
    """[B, 1, 1, S] additive key mask (-1e30 past each row's length; a
    length of 0 masks every key of that row), as the BERT tower builds it."""
    valid = np.arange(s)[None, :] < np.asarray(lengths)[:, None]
    return np.where(valid, 0.0, -1e30).astype(np.float32)[:, None, None, :]


def full_mask(pads, s, pad_id=0):
    """CoCa text's [B, 1, S, S] mask over S - 1 ids and the appended cls:
    causal plus the JAX ``_cls_mask`` of ids whose trailing pad counts are
    ``pads`` (every batch row's cls row differs)."""
    from clip_embedder_tpu.models.text_transformer import _cls_mask

    ids = np.full((len(pads), s - 1), 7, np.int32)
    for i, n in enumerate(pads):
        if n:
            ids[i, -n:] = pad_id
    return np.array(jcausal(s) + _cls_mask(jnp.asarray(ids), pad_id), np.float32)


MASK_CASES = {
    # lengths that differ in every row, one row with every key masked
    "key": (4, 40, lambda: key_mask([40, 17, 0, 5], 40)),
    # 17 = 16 ids + cls: a ragged key tile on the card
    "full": (3, 17, lambda: full_mask([0, 5, 11], 17)),
}


@pytest.mark.parametrize("form", sorted(MASK_CASES))
@pytest.mark.parametrize("heads,d", [(2, 64), (4, 32)], ids=["2x64", "4x32"])
@pytest.mark.parametrize("dtype,softmax", [("float32", "exact"), ("float32", "fast"),
                                           ("bfloat16", "exact"), ("bfloat16", "fast")])
def test_flash_plain_matches_jax_kernel_per_batch_masks(form, heads, d, dtype, softmax):
    """Kernel 2's per-batch masks, plain version against the JAX kernel in
    interpret mode: f32 at atol 2e-5 / rtol 1e-5, bf16 at 2e-2, exact and
    fast softmax (bf16 fast with the bf16 exp), a fully masked row's output
    finite (the uniform average of v, as JAX's guard gives)."""
    b, s, make = MASK_CASES[form]
    mask = make()
    kw = {"fast_softmax": softmax == "fast",
          "exp_bf16": softmax == "fast" and dtype == "bfloat16"}
    got, ref = _run_both(_attn_case(b, s, heads, d, dtype, seed=12), dtype, heads,
                         mask=jnp.asarray(mask), **kw)
    assert np.isfinite(got).all()
    tol = (2e-5, 1e-5) if dtype == "float32" else (2e-2, 2e-2)
    np.testing.assert_allclose(got, ref, atol=tol[0], rtol=tol[1])
    if form == "full":  # the cls query, the tower's pooled output, on its own
        np.testing.assert_allclose(got[:, -1], ref[:, -1], atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("form", sorted(MASK_CASES))
@pytest.mark.parametrize("impl", ["kernel", "kernel_fast"])
def test_mha_sends_per_batch_masks_to_the_packed_kernel(form, impl, monkeypatch):
    """multi_head_attention on the kernel impls routes both per-batch forms
    to flash_attention_packed (a 128-lane head group, no rope), and matches
    the JAX package's multi_head_attention on the same weights."""
    from clip_embedder_tpu.ops.attention import multi_head_attention as jmha

    b, s, make = MASK_CASES[form]
    mask = make()
    width, heads = 128, 2
    rng = np.random.default_rng(13)
    p = {n: {"w": _arr(rng, width, width, scale=width ** -0.5), "b": _arr(rng, width, scale=0.1)}
         for n in ("q", "k", "v", "out")}
    x = _arr(rng, b, s, width)
    seen = []
    real = flash.flash_attention_packed

    def spy(*a, **kw):
        seen.append(tuple(kw["mask"].shape))
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_packed", spy)
    got = tattn.multi_head_attention(_tree(p, torch.from_numpy), torch.from_numpy(x),
                                     num_heads=heads, mask=torch.from_numpy(mask), impl=impl)
    ref = jmha(_tree(p, jnp.asarray), jnp.asarray(x), num_heads=heads, mask=jnp.asarray(mask))
    assert seen == [mask.shape]
    assert np.isfinite(got.numpy()).all()
    # kernel_fast's clamp gives masked keys exp(-60) and its bf16 exp rounds p
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=1e-2 if impl == "kernel_fast" else 2e-5)


def test_kernel_gates():
    assert qkv.tile_config(1152, torch.bfloat16) == (256, 128)
    assert qkv.tile_config(1536, torch.bfloat16) == (256, 128)
    assert qkv.tile_config(1728, torch.bfloat16) == (64, 64)     # not a 128-multiple
    assert qkv.tile_config(64, torch.bfloat16) == (64, 64)
    assert qkv.tile_config(1152, torch.float32) == (64, 64)
    assert qkv.tile_config(64, torch.float32) == (64, 64)
    assert qkv.tile_config(100, torch.float32) is None          # not a 64-multiple
    assert qkv.tile_config(1152, torch.float16) is None         # dtype
    x = torch.zeros(2, 3, 64)
    square = {n: {"w": torch.zeros(64, 64)} for n in "qkv"}
    assert qkv.fits_fused_qkv(square, x)
    assert not qkv.fits_fused_qkv({**square, "v": {"w": torch.zeros(64, 32)}}, x)
    assert not qkv.fits_fused_qkv(square, x.to(torch.bfloat16))     # weight dtype
    assert not qkv.fits_fused_qkv({**square, "k": {"w_q": torch.zeros(64, 64)}}, x)
    t = torch.zeros(2, 5, 4 * 72)
    assert flash.fits_packed(t, t, t, 4)
    assert not flash.fits_packed(t, t[:, :3], t[:, :3], 4)           # cross-attention
    assert not flash.fits_packed(*(torch.zeros(1, 5, 2 * 160),) * 3, 2)  # D > 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_width_and_head_dim_keeps_a_kernel_route(dtype):
    """Every width ln_qkv's kernel took (each multiple of 64) keeps a tile:
    bf16 multiples of 128 the TMA + wgmma one, the rest the 64 x 64 one; and
    every head dim the packed wrapper accepts (1..128) has a kernel in
    flash.cuh: bf16 multiples of 8 the TMA + wgmma one, other bf16 head dims
    the mma.sync one, f32 the FMA one."""
    for width in range(64, 8193, 64):
        tma = dtype == torch.bfloat16 and width % 128 == 0
        assert qkv.tile_config(width, dtype) == ((256, 128) if tma else (64, 64))
    for d in range(1, flash.MAX_HEAD_DIM + 1):
        t = torch.zeros(1, 3, 2 * d, dtype=dtype)
        assert flash.fits_packed(t, t, t, 2)
        want = ("fma_f32" if dtype == torch.float32 else
                "tma_wgmma" if d % 8 == 0 else "mma_sync")
        assert flash.kernel_route(d, dtype) == want
    assert flash.kernel_route(flash.MAX_HEAD_DIM + 1, dtype) is None
    assert flash.kernel_route(64, torch.float16) is None


@pytest.mark.parametrize("impl", ["kernel", "kernel_fast"])
@pytest.mark.parametrize("width,heads", [(64, 4), (128, 2)], ids=["4x16", "2x64"])
def test_mha_kernel_impl_dispatches_to_both_kernels(impl, width, heads, monkeypatch):
    """On the kernel impls, pre-LN self-attention goes through ln_qkv and an
    attention kernel (their plain versions on the CPU), routed as the JAX
    package's pallas: 2 heads x 64 form a 128-lane head group and take
    flash_attention_packed, with kernel_fast's bf16 exp (d < 96); 4 heads x
    16 form none and take flash_attention, exp in f32."""
    calls = []
    real_qkv = qkv.ln_qkv
    real = {"packed": flash.flash_attention_packed, "bhsd": flash.flash_attention}

    def spy_qkv(*a, **kw):
        calls.append("ln_qkv")
        return real_qkv(*a, **kw)

    def spy(kind):
        def wrapped(*a, **kw):
            calls.append((kind, kw["fast_softmax"], kw.get("exp_bf16")))
            return real[kind](*a, **kw)
        return wrapped

    monkeypatch.setattr(tattn, "ln_qkv", spy_qkv)
    monkeypatch.setattr(tattn, "flash_attention_packed", spy("packed"))
    monkeypatch.setattr(tattn, "flash_attention", spy("bhsd"))
    rng = np.random.default_rng(9)
    p = {n: {"w": torch.from_numpy(_arr(rng, width, width, scale=width ** -0.5)),
             "b": torch.from_numpy(_arr(rng, width, scale=0.1))}
         for n in ("q", "k", "v", "out")}
    ln = {"scale": torch.ones(width), "bias": torch.zeros(width)}
    x = torch.from_numpy(_arr(rng, 2, 9, width))
    got = tattn.multi_head_attention(p, x, num_heads=heads, impl=impl, pre_ln=ln, residual=x)
    ref = tattn.multi_head_attention(p, x, num_heads=heads, impl="eager", pre_ln=ln,
                                     residual=x)
    fast = impl == "kernel_fast"
    if heads == 2:
        assert calls == ["ln_qkv", ("packed", fast, fast)]
    else:
        assert calls == ["ln_qkv", ("bhsd", fast, None)]
    # exp_bf16 rounds the softmax weights to bf16
    np.testing.assert_allclose(got.numpy(), ref.numpy(),
                               atol=1e-2 if fast and heads == 2 else 1e-5)

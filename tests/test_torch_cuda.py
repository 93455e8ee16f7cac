"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the ``dev`` fixture, never at import). This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; the repo's conftest imports JAX, hence::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``chip_smoke.py`` is the full gate (main-path shapes, end to end); these
are the small shapes the CPU tests also use.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_embedder_tpu_torch.ops import flash, int8_mlp, layers, qkv, rows
from clip_embedder_tpu_torch.ops.attention import causal_mask
from clip_embedder_tpu_torch.ops.quant import quantize_weight
from clip_embedder_tpu_torch.ops.rope import axial_rope_table, head_tiled_tables

FIXTURES = Path(__file__).parent / "fixtures"
REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv_inputs(rows, width, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
            dev, dt)

    params = {n: {"w": t(width, width, scale=width ** -0.5), "b": t(width, scale=0.1)}
              for n in "qkv"}
    pre_ln = {"scale": 1 + t(width, scale=0.1), "bias": t(width, scale=0.1)}
    return params, pre_ln, t(rows, width)


@pytest.mark.parametrize("rows,width", [(2 * 61, 256), (3 * 17, 64), (100, 192),
                                        (2 * 576, 1152)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_qkv_kernel_matches_plain(dev, rows, width, dtype):
    params, pre_ln, x = _qkv_inputs(rows, width, dtype, dev)
    before = qkv.ln_qkv.launches
    got = qkv.ln_qkv(params, pre_ln, x, eps=1e-6)
    torch.cuda.synchronize()
    assert qkv.ln_qkv.launches == before + 1
    ref = qkv.ln_qkv_plain(params, pre_ln, x, eps=1e-6)
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            # f32 sums in another order: ~1e-6 relative over W terms
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
        else:
            # bf16 outputs may differ by one rounding step (2^-8 relative)
            torch.testing.assert_close(g, r, atol=1e-2, rtol=2 ** -7)


@pytest.mark.parametrize("rows,width", [(1, 128), (300, 128), (2 * 61, 768), (257, 1024),
                                        (3 * 77, 1280), (2 * 257, 1536)])
def test_ln_qkv_tma_kernel_widths(dev, rows, width):
    """The TMA + wgmma product (bf16, widths that are multiples of 128) at
    the repo's widths, row counts not a multiple of its 256-row tile. (1,
    128) is one tile per weight: x^ through the swizzled K-major
    descriptor, the weights through the swizzled MN-major one."""
    assert qkv.tile_config(width, torch.bfloat16) == (256, 128)
    params, pre_ln, x = _qkv_inputs(rows, width, torch.bfloat16, dev, seed=rows)
    got = qkv.ln_qkv(params, pre_ln, x, eps=1e-6)
    torch.cuda.synchronize()
    for g, r in zip(got, qkv.ln_qkv_plain(params, pre_ln, x, eps=1e-6)):
        torch.testing.assert_close(g.float(), r.float(), atol=1e-2, rtol=2 ** -7)


@pytest.mark.parametrize("b,h,s,d", [(2, 16, 61, 72), (2, 8, 64, 64), (1, 16, 33, 8),
                                     (1, 4, 130, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "fast", "fast_bf16exp"])
def test_flash_kernel_matches_plain(dev, b, h, s, d, dtype, mode):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    kw = {"fast_softmax": mode != "exact", "exp_bf16": mode == "fast_bf16exp"}
    before = flash.flash_attention_packed.launches
    got = flash.flash_attention_packed(q, k, v, num_heads=h, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention_packed.launches == before + 1
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, **kw)
    tol = 2e-5 if dtype == torch.float32 and mode != "fast_bf16exp" else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_causal_mask(dev, dtype):
    b, h, s, d = 2, 8, 77, 64
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    mask = causal_mask(s, device=dev)
    got = flash.flash_attention_packed(q, k, v, num_heads=h, mask=mask)
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, mask=mask)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def _packed(b, h, s, d, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32)).to(dev, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("b,h,s,d,causal", [
    (2, 16, 576, 72, False), (2, 16, 577, 72, False),    # SO400M vision, and ragged
    (3, 16, 64, 72, False), (3, 16, 64, 72, True),       # SigLIP text, with and without the mask
    (2, 20, 72, 64, True),                               # PE-Core text
    (2, 4, 130, 80, False), (2, 16, 200, 96, False), (1, 8, 300, 128, True)])
@pytest.mark.parametrize("mode", ["exact", "fast", "fast_bf16exp"])
def test_flash_tma_kernel_main_path_shapes(dev, b, h, s, d, causal, mode):
    """The TMA + wgmma kernel (bf16, D a multiple of 8) at the towers' head
    layouts and sequence lengths, every softmax mode."""
    assert flash.kernel_route(d, torch.bfloat16) == "tma_wgmma"
    q, k, v = _packed(b, h, s, d, torch.bfloat16, dev, seed=13)
    kw = {"fast_softmax": mode != "exact", "exp_bf16": mode == "fast_bf16exp",
          "mask": causal_mask(s, device=dev) if causal else None}
    before = flash.flash_attention_packed.launches
    got = flash.flash_attention_packed(q, k, v, num_heads=h, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention_packed.launches == before + 1
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, **kw)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [8, 16, 24, 40, 56, 64, 72, 128])
def test_flash_tma_kernel_one_tile_layouts(dev, d):
    """One head, one 64-key tile, each layout alone and together: below 64
    columns K and V come in 8-column chunks (q.k^T's K-major and p.v's
    MN-major no-swizzle descriptors; d = 8 and 24 pad the depth with a zero
    chunk); d = 64 takes one swizzled block (both swizzled descriptors), 72
    one block and a chunk, 128 two blocks. Keys 0..63 carry distinct values,
    so a descriptor that reads the wrong core matrix moves the output."""
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, d)).astype(np.float32) * 2)
               .to(dev, torch.bfloat16) for _ in range(3))
    got = flash.flash_attention_packed(q, k, v, num_heads=1)
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=1)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("d", [36, 60, 100, 127])
def test_flash_mma_sync_kernel_takes_other_head_dims(dev, d):
    """Head dims that are not a multiple of 8 (rows TMA cannot move) keep
    the mma.sync kernel."""
    assert flash.kernel_route(d, torch.bfloat16) == "mma_sync"
    q, k, v = _packed(2, 2, 77, d, torch.bfloat16, dev, seed=14)
    got = flash.flash_attention_packed(q, k, v, num_heads=2)
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=2)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_flash_kernel_refuses_per_head_mask(dev):
    q = torch.zeros(2, 8, 4 * 16, device=dev)
    before = flash.flash_attention_packed.launches
    with pytest.raises(ValueError, match=r"unsupported mask shape \(2, 4, 8, 8\)"):
        flash.flash_attention_packed(q, q, q, num_heads=4,
                                     mask=torch.zeros(2, 4, 8, 8, device=dev))
    assert flash.flash_attention_packed.launches == before


def _key_mask(b, s, dev):
    """[B, 1, 1, S]: a different key length in every batch row, one row with
    every key masked (bucket padding), -1e30 on the masked keys."""
    lengths = [s, s // 2 + 3, 0, 1, s - 5][:b]
    valid = torch.arange(s)[None, :] < torch.tensor(lengths)[:, None]
    return torch.where(valid, 0.0, -1e30)[:, None, None, :].to(dev)


def _full_mask(b, s, dev):
    """CoCa text's [B, 1, S, S]: causal plus the cls mask of S - 1 ids whose
    pad counts differ in every batch row (only the cls row, query S - 1,
    differs between rows)."""
    from clip_embedder_tpu_torch.models.text_transformer import cls_mask

    ids = torch.full((b, s - 1), 7)
    for i, n in enumerate([0, 3, s // 3, s - 2, 1][:b]):
        if n:
            ids[i, -n:] = 0
    return (causal_mask(s) + cls_mask(ids, 0)).to(dev)


@pytest.mark.parametrize("form", ["key", "full"])
@pytest.mark.parametrize("s", [256, 77, 133])
@pytest.mark.parametrize("h,d,dtype,mode", [
    (12, 64, torch.bfloat16, "exact"), (12, 64, torch.bfloat16, "fast_bf16exp"),
    (12, 64, torch.float32, "exact"), (12, 64, torch.float32, "fast"),
    (4, 36, torch.bfloat16, "exact")], ids=["wgmma", "wgmma-fast", "f32", "f32-fast",
                                           "mma_sync"])
def test_flash_kernel_per_batch_masks(dev, form, s, h, d, dtype, mode):
    """Kernel 2's per-batch masks (BERT's key rows, CoCa's full blocks) at
    BERT-base's 256, CoCa text's 77 and a ragged 133 (a last key tile of 5):
    masks that differ in every batch row, a row with every key masked, each
    head layout's route (12 x 64 bf16 on TMA + wgmma, f32 on FMA, 4 x 36
    bf16 on mma.sync); the cls query (the CoCa tower's pooled row) held on
    its own."""
    b = 4
    mask = (_key_mask if form == "key" else _full_mask)(b, s, dev)
    q, k, v = _packed(b, h, s, d, dtype, dev, seed=21)
    kw = {"fast_softmax": mode != "exact", "exp_bf16": mode == "fast_bf16exp"}
    before = dict(flash.flash_attention_packed.mask_launches)
    got = flash.flash_attention_packed(q, k, v, num_heads=h, mask=mask, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention_packed.mask_launches[form] == before[form] + 1
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, mask=mask, **kw)
    assert torch.isfinite(got).all()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got[:, -1].float(), ref[:, -1].float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,s,d", [(2, 4, 65, 32), (2, 16, 1025, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [False, True])
def test_flash_kernel_rope_matches_plain(dev, b, h, s, d, dtype, fast):
    """In-kernel 2-D rope (PE-Core's tables: a cls identity row, then the
    patch grid, x bands first)."""
    grid = int(round((s - 1) ** 0.5))
    sin, cos = (t.to(dev) for t in head_tiled_tables(
        axial_rope_table(grid, d, order="xy", prefix=1), h))
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    before = flash.flash_attention_packed.launches
    got = flash.flash_attention_packed(q, k, v, num_heads=h, rope=(sin, cos),
                                       fast_softmax=fast)
    torch.cuda.synchronize()
    assert flash.flash_attention_packed.launches == before + 1
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, rope=(sin, cos),
                                             fast_softmax=fast)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_kernel_rope_refuses_mask_and_bad_tables(dev):
    q = torch.zeros(1, 9, 4 * 32, device=dev)
    tab = torch.zeros(9, 4 * 32, device=dev)
    with pytest.raises(ValueError, match="rope with a mask"):
        flash.flash_attention_packed(q, q, q, num_heads=4, rope=(tab, tab),
                                     mask=causal_mask(9, device=dev))
    with pytest.raises(ValueError, match="rope tables"):
        flash.flash_attention_packed(q, q, q, num_heads=4, rope=(tab[:8], tab[:8]))


QUANT = {"qk": {"quant_qk": True}, "pv": {"quant_pv": True},
         "both": {"quant_qk": True, "quant_pv": True}}
MODES = {"exact": {}, "fast": {"fast_softmax": True}, "exp_bf16": {"exp_bf16": True},
         "fast_bf16exp": {"fast_softmax": True, "exp_bf16": True}}


def _held_int8(q, k, v, h, quant, **kw):
    """The int8 kernel against the plain version: one launch, counted as
    quantized and on the route ``kernel_route`` names (the plain version is
    never its fallback)."""
    route = flash.kernel_route(q.shape[-1] // h, q.dtype, quant=True)
    counts = flash.flash_attention_packed.route_launches
    before = (flash.flash_attention_packed.launches,
              flash.flash_attention_packed.quant_launches[quant], dict(counts))
    got = flash.flash_attention_packed(q, k, v, num_heads=h, **QUANT[quant], **kw)
    torch.cuda.synchronize()
    assert (flash.flash_attention_packed.launches,
            flash.flash_attention_packed.quant_launches[quant]) == (before[0] + 1, before[1] + 1)
    assert {n: c - before[2][n] for n, c in counts.items() if c != before[2][n]} == {
        f"{route} {quant}": 1}
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, **QUANT[quant], **kw)
    assert torch.isfinite(got).all()
    # f32: the codes agree exactly, only sums' order differs; bf16: the
    # kernel's exp (ex2.approx) can move a p code by one
    tol = 2e-5 if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("b,h,s,d", [(2, 16, 61, 72), (2, 2, 64, 64), (1, 4, 130, 128),
                                     (2, 3, 33, 40), (2, 4, 577, 72), (1, 2, 1025, 96),
                                     (2, 4, 100, 8), (2, 4, 70, 36)])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", sorted(QUANT))
def test_flash_int8_kernel_matches_plain(dev, b, h, s, d, mode, dtype, quant):
    """quant_qk / quant_pv / both on the int8 kernels, every softmax mode:
    bf16 with D a multiple of 8 on the TMA one (csrc/flash_int8_tma.cu),
    f32 and D = 36 on the first one (csrc/flash_int8.cu). SO400M's head dim
    over a ragged S and over 577 tokens, one 64-key tile, D = 128 over three
    tiles, D = 40 and 8 (codes padded to 64 and 32), PE-Core's 96 over
    1025 tokens."""
    want = "int8_tma" if dtype == torch.bfloat16 and d % 8 == 0 else "int8_wgmma"
    assert flash.kernel_route(d, dtype, quant=True) == want
    q, k, v = _packed(b, h, s, d, dtype, dev, seed=31)
    _held_int8(q, k, v, h, quant, **MODES[mode])


@pytest.mark.parametrize("form", ["causal", "key", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", sorted(QUANT))
@pytest.mark.parametrize("fast", [False, True])
def test_flash_int8_kernel_masks(dev, form, dtype, quant, fast):
    """Every mask form of packed_mask on the int8 kernels, at CoCa text's 77
    tokens, with and without fast_softmax: the shared causal mask, BERT's
    key rows (a row with every key masked) and CoCa's full blocks; counted
    by form too."""
    b, h, s, d = 4, 12, 77, 64
    mask = {"causal": lambda: causal_mask(s, device=dev), "key": lambda: _key_mask(b, s, dev),
            "full": lambda: _full_mask(b, s, dev)}[form]()
    q, k, v = _packed(b, h, s, d, dtype, dev, seed=32)
    kind = "shared" if form == "causal" else form
    before = flash.flash_attention_packed.mask_launches[kind]
    _held_int8(q, k, v, h, quant, mask=mask, fast_softmax=fast)
    assert flash.flash_attention_packed.mask_launches[kind] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", sorted(QUANT))
def test_flash_int8_kernel_rope(dev, dtype, quant):
    """The codes come from the rotated q and k (PE-Core's tables, 16 x 96)."""
    b, h, s, d = 2, 16, 65, 96
    sin, cos = (t.to(dev) for t in head_tiled_tables(
        axial_rope_table(8, d, order="xy", prefix=1), h))
    q, k, v = _packed(b, h, s, d, dtype, dev, seed=33)
    _held_int8(q, k, v, h, quant, rope=(sin, cos))


@pytest.mark.parametrize("d", [72, 128, 36])
@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_int8_codes_match_plain(dev, d, rope, dtype):
    """Both int8 routes divide and round as the plain version does: every
    code and scale of q, k and v equal (the TMA route's q codes written back
    by its attention kernel, its k and v codes by its prep pass, v's keys
    put back in order)."""
    b, h, s = 2, 16 if d < 128 else 4, 65
    tables = None
    if rope:
        tables = tuple(t.to(dev) for t in head_tiled_tables(
            axial_rope_table(8, d, order="xy", prefix=1), h))
    q, k, v = _packed(b, h, s, d, dtype, dev, seed=34)
    got = flash.quant_codes(q, k, v, num_heads=h, rope=tables)
    ref = flash.quant_codes_plain(q, k, v, num_heads=h, rope=tables)
    for name in ref:
        assert torch.equal(got[name], ref[name]), name


@pytest.mark.parametrize("b,h,s,d,dtype", [
    (2, 16, 61, 72, torch.bfloat16), (2, 16, 130, 96, torch.bfloat16),
    (2, 2, 64, 128, torch.bfloat16), (2, 32, 50, 36, torch.bfloat16),
    (2, 16, 61, 72, torch.float32)], ids=["tma-72", "tma-96", "tma-128", "mma_sync", "f32"])
@pytest.mark.parametrize("fast", [False, True])
def test_flash_schedule_options_are_bitwise_the_default(dev, b, h, s, d, dtype, fast):
    """group_mult and pair_exp change the TPU's schedule alone, and the card
    has no counterpart: on each route the launch writes the bytes of the
    default one."""
    q, k, v = _packed(b, h, s, d, dtype, dev, seed=35)
    base = flash.flash_attention_packed(q, k, v, num_heads=h, fast_softmax=fast)
    for kw in ({"pair_exp": True}, {"group_mult": 2}, {"group_mult": 2, "pair_exp": True},
               {"group_mult": 4}):
        got = flash.flash_attention_packed(q, k, v, num_heads=h, fast_softmax=fast, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, base), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_mxu_denom_false(dev, dtype):
    """mxu_denom=False sums p unrounded: on bf16 at D = 72 the mma.sync
    kernel (the TMA kernel's denominator is its ones column)."""
    q, k, v = _packed(2, 16, 61, 72, dtype, dev, seed=36)
    want = "mma_sync" if dtype == torch.bfloat16 else "fma_f32"
    assert flash.kernel_route(72, dtype, mxu_denom=False) == want
    got = flash.flash_attention_packed(q, k, v, num_heads=16, mxu_denom=False)
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=16, mxu_denom=False)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_int8_never_runs_the_plain_version(dev, monkeypatch):
    """No fallback: with a quant flag on the card the int8 kernel launches
    (its counter moves) and the plain version is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    q, k, v = _packed(2, 16, 61, 72, torch.bfloat16, dev, seed=37)
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=16, quant_qk=True,
                                             quant_pv=True)
    monkeypatch.setattr(flash, "flash_attention_packed_plain", refuse)
    before = flash.flash_attention_packed.quant_launches["both"]
    got = flash.flash_attention_packed(q, k, v, num_heads=16, quant_qk=True, quant_pv=True)
    torch.cuda.synchronize()
    assert flash.flash_attention_packed.quant_launches["both"] == before + 1
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,h,s,d", [(2, 4, 16, 16), (2, 4, 61, 72), (1, 3, 130, 128),
                                     (2, 16, 576, 72)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "fast", "causal"])
def test_flash_bhsd_kernel_matches_plain(dev, b, h, s, d, dtype, mode):
    """Kernel 3 on the [B, H, S, D] layout: no mask or the shared causal
    mask, exact or clamped softmax, the f32 exp."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    kw = {"fast_softmax": mode == "fast",
          "mask": causal_mask(s, device=dev) if mode == "causal" else None}
    before = flash.flash_attention.launches
    got = flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention.launches == before + 1
    ref = flash.flash_attention_plain(q, k, v, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_bhsd_hands_cross_attention_and_per_batch_masks_on(dev):
    q = torch.randn(2, 4, 8, 16, device=dev)
    kv = torch.randn(2, 4, 12, 16, device=dev)
    before = flash.flash_attention.launches
    flash.flash_attention(q, kv, kv)
    flash.flash_attention(q, q, q, mask=torch.zeros(2, 1, 1, 8, device=dev))
    assert flash.flash_attention.launches == before


@pytest.mark.parametrize("name", ["golden_siglip", "golden_model"])
def test_golden_fixture_through_kernels(dev, name):
    """The fixtures' 4 heads x 16 form no 128-lane head group, so their
    self-attention takes kernel 3 (flash_attention), as on the TPU."""
    from clip_embedder_tpu_torch import Clip

    fixture = FIXTURES / name
    clip = Clip.from_local_dir(fixture, device="cuda")
    assert clip.vision.attn_impl == "kernel"
    img = np.load(fixture / "golden_image.npy")
    golden = np.load(fixture / "golden_outputs.npz")
    n_qkv, n_attn = qkv.ln_qkv.launches, flash.flash_attention.launches
    np.testing.assert_allclose(clip.vision.embed_image(img), golden["image_embedding"],
                               atol=5e-4)
    np.testing.assert_allclose(clip.text.embed_texts(["a photo of a cat", "the dog!"]),
                               golden["text_embeddings"], atol=5e-4)
    assert qkv.ln_qkv.launches > n_qkv and flash.flash_attention.launches > n_attn
    expect = json.loads((fixture / "golden_classify.json").read_text())
    results = clip.classify(img, [label for label, _ in expect])
    assert [r[0] for r in results] == [e[0] for e in expect]
    np.testing.assert_allclose([r[1] for r in results], [e[1] for e in expect], atol=1e-4)


# -- the int8 kernels --------------------------------------------------------

def _qlinear(rng, k, n, dtype, dev):
    q = quantize_weight(torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)
                                         * k ** -0.5).to(dev))
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1).to(dev, dtype)
    return {**q, "b": b}


def assert_rows_close(got, ref, dtype):
    """Kernel against plain: the LayerNorm's row sums are taken in another
    order, which can flip an int8 code by one and move that row (through
    the MLP's requantization, a few more codes). So at most 2% of the rows
    (at least one) may leave the base tolerance (1e-5 in f32, one bf16
    step in bf16), and every row keeps a cosine of 1 - 1e-4 to the plain
    row."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    assert g.shape == r.shape and torch.isfinite(g).all()
    if dtype == torch.float32:
        base = 1e-5 + 1e-5 * r.abs()
    else:
        mag = torch.maximum(torch.maximum(g.abs(), r.abs()), torch.tensor(1e-3, device=g.device))
        base = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    off = ((g - r).abs() > base).any(dim=-1)
    assert int(off.sum()) <= max(1, int(0.02 * off.numel())), int(off.sum())
    cos = (g * r).sum(-1) / (g.norm(dim=-1) * r.norm(dim=-1)).clamp_min(1e-30)
    assert float(cos.min()) >= 1 - 1e-4


@pytest.mark.parametrize("rows,k_in,k_out", [(2 * 61, 64, 272), (3 * 17, 256, 192),
                                             (2 * 576, 1152, 1152), (7, 96, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_int8_linear_fused_kernel_matches_plain(dev, rows, k_in, k_out, dtype, with_residual):
    rng = np.random.default_rng(3)
    p = _qlinear(rng, k_in, k_out, dtype, dev)
    x = torch.from_numpy(rng.standard_normal((rows, k_in)).astype(np.float32)).to(dev, dtype)
    r = (torch.from_numpy(rng.standard_normal((rows, k_out)).astype(np.float32)).to(dev, dtype)
         if with_residual else None)
    before = int8_mlp.int8_linear_fused.launches
    got = int8_mlp.int8_linear_fused(p, x, residual=r)
    torch.cuda.synchronize()
    assert int8_mlp.int8_linear_fused.launches == before + 1
    assert_rows_close(got, int8_mlp.int8_linear_fused_plain(p, x, residual=r), dtype)


@pytest.mark.parametrize("rows,width", [(2 * 61, 256), (3 * 17, 64), (100, 192),
                                        (2 * 576, 1152)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_qkv_int8_kernel_matches_plain(dev, rows, width, dtype):
    rng = np.random.default_rng(4)
    params = {n: _qlinear(rng, width, width, dtype, dev) for n in "qkv"}
    _, pre_ln, x = _qkv_inputs(rows, width, dtype, dev, seed=5)
    before = qkv.ln_qkv_int8.launches
    got = qkv.ln_qkv_int8(params, pre_ln, x, eps=1e-6)
    torch.cuda.synchronize()
    assert qkv.ln_qkv_int8.launches == before + 1
    for g, r in zip(got, qkv.ln_qkv_int8_plain(params, pre_ln, x, eps=1e-6)):
        assert_rows_close(g, r, dtype)


@pytest.mark.parametrize("rows,width", [
    pytest.param(32 * 576, 1152, id="multi_wave"),   # 1944 tiles of 256 x 128 over 132 SMs
    pytest.param(3 * 61, 272, id="ragged_columns"),  # each weight ends in a 16-column tile
    pytest.param(37, 128, id="rows_under_64"),
    pytest.param(130, 64, id="k64"),                 # the 128-byte K box runs past K
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_qkv_int8_wgmma_three_weight_walk(dev, rows, width, dtype):
    """The three weights' column tiles in one walk over the shared codes:
    every (weight, column, row) tile once, the right weight's scales, bias
    and output for each, at the edges TMA zero-fills."""
    rng = np.random.default_rng(50 + width)
    params = {n: _qlinear(rng, width, width, dtype, dev) for n in "qkv"}
    _, pre_ln, x = _qkv_inputs(rows, width, dtype, dev, seed=51)
    got = qkv.ln_qkv_int8(params, pre_ln, x, eps=1e-6)
    torch.cuda.synchronize()
    for g, r in zip(got, qkv.ln_qkv_int8_plain(params, pre_ln, x, eps=1e-6)):
        assert_rows_close(g, r, dtype)


@pytest.mark.parametrize("rows,k_in,k_out", [
    pytest.param(32 * 576, 1152, 1152, id="multi_wave"),
    pytest.param(3 * 61, 272, 272, id="ragged_columns"),
    pytest.param(37, 128, 384, id="rows_under_64"),
    pytest.param(130, 64, 128, id="k64"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_int8_linear_fused_wgmma_edges(dev, rows, k_in, k_out, dtype, with_residual):
    """One weight on the s8 wgmma product with the kOut epilogue: bf16
    staged through shared memory (the residual read and the output written
    in 16-byte chunks), f32 from the registers."""
    rng = np.random.default_rng(60 + k_in)
    p = _qlinear(rng, k_in, k_out, dtype, dev)
    x = torch.from_numpy(_arr(rng, rows, k_in)).to(dev, dtype)
    r = torch.from_numpy(_arr(rng, rows, k_out)).to(dev, dtype) if with_residual else None
    got = int8_mlp.int8_linear_fused(p, x, residual=r)
    torch.cuda.synchronize()
    assert_rows_close(got, int8_mlp.int8_linear_fused_plain(p, x, residual=r), dtype)


@pytest.mark.parametrize("rows,k_in,k_out", [
    pytest.param(3 * 61, 1024, 2730, id="eva02_fc1"),  # N no multiple of 16: an 8-column tail
    pytest.param(3 * 61, 2730, 1024, id="eva02_fc2"),  # K no multiple of 16: padded rows
    pytest.param(130, 100, 77, id="odd_n"),            # an odd N: a pair with one column
    pytest.param(37, 17, 24, id="k_under_a_box"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_residual", [False, True])
def test_int8_linear_fused_any_width(dev, rows, k_in, k_out, dtype, with_residual):
    """Widths that are no multiple of 16 (EVA02's SwiGLU): the weight in
    rows padded to 16 bytes on the card, the codes likewise (the ragged row
    pass), an output whose width is no multiple of 8 written into padded
    rows and handed back as a view."""
    rng = np.random.default_rng(70 + k_in)
    p = _qlinear(rng, k_in, k_out, dtype, dev)
    assert p["w_q"].stride() == (1, k_in + (-k_in) % 16)
    x = torch.from_numpy(_arr(rng, rows, k_in)).to(dev, dtype)
    r = torch.from_numpy(_arr(rng, rows, k_out)).to(dev, dtype) if with_residual else None
    before = int8_mlp.int8_linear_fused.launches
    got = int8_mlp.int8_linear_fused(p, x, residual=r)
    torch.cuda.synchronize()
    assert int8_mlp.int8_linear_fused.launches == before + 1
    assert got.shape == (rows, k_out)
    assert_rows_close(got, int8_mlp.int8_linear_fused_plain(p, x, residual=r), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_qkv_and_linear_all_zero_row(dev, dtype):
    """A row of zeros (for ln_qkv_int8 under a LayerNorm without bias, so
    that it normalizes to zeros): amax 0, scale 1, codes 0, and the row's
    output is the bias [+ residual] exactly."""
    rng = np.random.default_rng(70)
    width = 256
    params = {n: _qlinear(rng, width, width, dtype, dev) for n in "qkv"}
    _, pre_ln, x = _qkv_inputs(70, width, dtype, dev, seed=71)
    pre_ln = {**pre_ln, "bias": torch.zeros_like(pre_ln["bias"])}
    x[5] = 0.0
    got = qkv.ln_qkv_int8(params, pre_ln, x, eps=1e-6)
    torch.cuda.synchronize()
    for g, r, n in zip(got, qkv.ln_qkv_int8_plain(params, pre_ln, x, eps=1e-6), "qkv"):
        torch.testing.assert_close(g[5], params[n]["b"], atol=0, rtol=0)
        assert_rows_close(g, r, dtype)
    res = torch.from_numpy(_arr(rng, 70, width)).to(dev, dtype)
    got = int8_mlp.int8_linear_fused(params["q"], x, residual=res)
    torch.cuda.synchronize()
    want = (params["q"]["b"].float() + res[5].float()).to(dtype)
    torch.testing.assert_close(got[5], want, atol=0, rtol=0)
    assert_rows_close(got, int8_mlp.int8_linear_fused_plain(params["q"], x, residual=res),
                      dtype)


@pytest.mark.parametrize("width", [1536, 1552])  # the held row's last width, and one past it
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_row_pass_register_limit(dev, width, dtype):
    """The row pass holds rows up to 1536 values in a warp's registers and
    walks wider ones in device memory; both sides of the limit, with the
    LayerNorm (ln_qkv_int8) and without (int8_linear_fused)."""
    rng = np.random.default_rng(80 + width)
    params = {n: _qlinear(rng, width, width, dtype, dev) for n in "qkv"}
    _, pre_ln, x = _qkv_inputs(67, width, dtype, dev, seed=81)
    got = qkv.ln_qkv_int8(params, pre_ln, x, eps=1e-6)
    torch.cuda.synchronize()
    for g, r in zip(got, qkv.ln_qkv_int8_plain(params, pre_ln, x, eps=1e-6)):
        assert_rows_close(g, r, dtype)
    got = int8_mlp.int8_linear_fused(params["k"], x, residual=x)
    torch.cuda.synchronize()
    assert_rows_close(got, int8_mlp.int8_linear_fused_plain(params["k"], x, residual=x), dtype)


@pytest.mark.parametrize("rows,k_in,hidden", [(2 * 61, 64, 272), (3 * 17, 256, 1040),
                                              (2 * 576, 1152, 4304)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu", "quick_gelu", "relu"])
@pytest.mark.parametrize("variant", ["plain", "pre_ln", "pre_ln_residual"])
def test_int8_mlp_kernel_matches_plain(dev, rows, k_in, hidden, dtype, act, variant):
    rng = np.random.default_rng(6)
    params = {"fc": _qlinear(rng, k_in, hidden, dtype, dev),
              "proj": _qlinear(rng, hidden, k_in, dtype, dev)}
    _, pre_ln, x = _qkv_inputs(rows, k_in, dtype, dev, seed=7)
    kw = {"activation": act, "pre_ln": pre_ln if variant != "plain" else None,
          "add_residual": variant == "pre_ln_residual"}
    before = int8_mlp.int8_mlp.launches
    got = int8_mlp.int8_mlp(params, x, **kw)
    torch.cuda.synchronize()
    assert int8_mlp.int8_mlp.launches == before + 1
    assert_rows_close(got, int8_mlp.int8_mlp_plain(params, x, **kw), dtype)


@pytest.mark.parametrize("rows,k_in,hidden,chunk", [(2 * 61, 128, 576, 256),
                                                    (3 * 17, 64, 272, 128),
                                                    (2 * 1025, 1536, 8960, 1792)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("variant", ["plain", "pre_ln_residual"])
def test_int8_mlp_streamed_kernel_matches_plain(dev, rows, k_in, hidden, chunk, dtype, act,
                                                variant):
    """Per-slab requantization; 576 / 256 and 272 / 128 leave a ragged last
    slab."""
    rng = np.random.default_rng(9)
    params = {"fc": _qlinear(rng, k_in, hidden, dtype, dev),
              "proj": _qlinear(rng, hidden, k_in, dtype, dev)}
    _, pre_ln, x = _qkv_inputs(rows, k_in, dtype, dev, seed=10)
    kw = {"activation": act, "pre_ln": pre_ln if variant != "plain" else None,
          "add_residual": variant == "pre_ln_residual", "chunk": chunk}
    before = int8_mlp.int8_mlp_streamed.launches
    got = int8_mlp.int8_mlp_streamed(params, x, **kw)
    torch.cuda.synchronize()
    assert int8_mlp.int8_mlp_streamed.launches == before + 1
    assert_rows_close(got, int8_mlp.int8_mlp_streamed_plain(params, x, **kw), dtype)


def test_int8_kernels_refuse_what_they_do_not_take(dev):
    rng = np.random.default_rng(8)
    # 24: not a multiple of 16, which the MLP kernels need (the fused linear takes it)
    x = torch.zeros(4, 64, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_mlp.int8_mlp({"fc": _qlinear(rng, 64, 24, torch.float32, dev),
                           "proj": _qlinear(rng, 24, 64, torch.float32, dev)}, x)
    p = _qlinear(rng, 64, 32, torch.float32, dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        int8_mlp.int8_linear_fused(p, x.half())
    with pytest.raises(ValueError, match="contiguous"):
        int8_mlp.int8_linear_fused(p, torch.zeros(64, 4, device=dev).t())
    with pytest.raises(ValueError, match="residual"):
        int8_mlp.int8_linear_fused(p, x, residual=torch.zeros(4, 16, device=dev))
    mlp = {"fc": _qlinear(rng, 64, 256, torch.float32, dev),
           "proj": _qlinear(rng, 256, 64, torch.float32, dev)}
    with pytest.raises(ValueError, match="multiple of 128"):
        int8_mlp.int8_mlp_streamed(mlp, x, chunk=100)
    # a weight stored N-contiguous ([in, out] row-major), not K-major: every
    # int8 wrapper refuses it rather than copy or transpose it per call
    n_contig = {**p, "w_q": p["w_q"].contiguous()}
    assert not n_contig["w_q"].t().is_contiguous()
    with pytest.raises(ValueError, match="K-major"):
        int8_mlp.int8_linear_fused(n_contig, x)
    for name in ("fc", "proj"):
        bad = {**mlp, name: {**mlp[name], "w_q": mlp[name]["w_q"].contiguous()}}
        with pytest.raises(ValueError, match="K-major"):
            int8_mlp.int8_mlp(bad, x)
        with pytest.raises(ValueError, match="K-major"):
            int8_mlp.int8_mlp_streamed(bad, x, chunk=128)
    qkvp = {n: _qlinear(rng, 64, 64, torch.float32, dev) for n in "qkv"}
    qkvp["k"] = {**qkvp["k"], "w_q": qkvp["k"]["w_q"].contiguous()}
    ln = {"scale": torch.ones(64, device=dev), "bias": torch.zeros(64, device=dev)}
    with pytest.raises(ValueError, match="K-major"):
        qkv.ln_qkv_int8(qkvp, ln, x)


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _mlp_params(rng, k_in, hidden, dtype, dev, k_out=None, zero_fc_bias=False):
    params = {"fc": _qlinear(rng, k_in, hidden, dtype, dev),
              "proj": _qlinear(rng, hidden, k_out or k_in, dtype, dev)}
    if zero_fc_bias:
        params["fc"]["b"] = torch.zeros_like(params["fc"]["b"])
    return params


@pytest.mark.parametrize("rows,k_in,hidden,chunk", [
    pytest.param(64, 128, 128, None, id="kAct_kOut"),  # one tile of fc1 (kAct), of fc2 (kOut)
    pytest.param(256, 128, 128, None, id="kAct_kOut_256rows"),  # both warpgroups' m64 tiles
    pytest.param(64, 128, 128, 128, id="kSlab_one"),   # one slab of one box
    pytest.param(128, 128, 256, 128, id="kSlab_two"),  # two slabs: a fold in between
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_wgmma_one_tile_epilogues(dev, rows, k_in, hidden, chunk, dtype):
    """The s8 TMA + wgmma product at one output tile per product, per
    epilogue: A and W through the 128-byte-swizzled K-major descriptors (a
    wrong one gives wrong numbers, not an error). Distinct random codes in
    every row and column, so a misread core matrix moves the output."""
    rng = np.random.default_rng(20 + rows + hidden)
    params = _mlp_params(rng, k_in, hidden, dtype, dev)
    x = torch.from_numpy(_arr(rng, rows, k_in)).to(dev, dtype)
    if chunk is None:
        got = int8_mlp.int8_mlp(params, x, activation="relu")
        ref = int8_mlp.int8_mlp_plain(params, x, activation="relu")
    else:
        got = int8_mlp.int8_mlp_streamed(params, x, activation="relu", chunk=chunk)
        ref = int8_mlp.int8_mlp_streamed_plain(params, x, activation="relu", chunk=chunk)
    torch.cuda.synchronize()
    assert_rows_close(got, ref, dtype)


@pytest.mark.parametrize("rows,k_in,hidden,k_out", [
    (1, 48, 144, 48),       # K of 48 in a 128-byte box; N 144 and 48 ragged in 128
    (7, 16, 272, 32),       # the least K; a 16-column last tile
    (257, 96, 400, 112),    # a ragged 256-row tile
    (300, 208, 1040, 208),  # both ragged, several column tiles
])
@pytest.mark.parametrize("streamed", [False, True])
def test_int8_wgmma_ragged_rows_k_and_n(dev, rows, k_in, hidden, k_out, streamed):
    """TMA zero-fills rows, K and N past the ends; the epilogue masks N."""
    rng = np.random.default_rng(rows + k_in)
    dtype = torch.bfloat16
    params = _mlp_params(rng, k_in, hidden, dtype, dev, k_out=k_out)
    x = torch.from_numpy(_arr(rng, rows, k_in)).to(dev, dtype)
    kw = {"activation": "gelu_tanh"}
    if streamed:
        got = int8_mlp.int8_mlp_streamed(params, x, chunk=128, **kw)
        ref = int8_mlp.int8_mlp_streamed_plain(params, x, chunk=128, **kw)
    else:
        got = int8_mlp.int8_mlp(params, x, **kw)
        ref = int8_mlp.int8_mlp_plain(params, x, **kw)
    torch.cuda.synchronize()
    assert got.shape == (rows, k_out)
    assert_rows_close(got, ref, dtype)


@pytest.mark.parametrize("chunk,hidden", [(128, 400), (256, 656), (1792, 3856)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_wgmma_slab_boundaries(dev, chunk, hidden, dtype):
    """kSlab's fold at every slab's end, the last slab ragged (16, 144 and
    272 columns); fc1's amax lands in the (row, slab) its tile lies in."""
    rng = np.random.default_rng(chunk)
    params = _mlp_params(rng, 128, hidden, dtype, dev)
    _, pre_ln, x = _qkv_inputs(3 * 61, 128, dtype, dev, seed=chunk)
    kw = {"activation": "gelu", "pre_ln": pre_ln, "add_residual": True, "chunk": chunk}
    got = int8_mlp.int8_mlp_streamed(params, x, **kw)
    torch.cuda.synchronize()
    assert_rows_close(got, int8_mlp.int8_mlp_streamed_plain(params, x, **kw), dtype)


@pytest.mark.parametrize("streamed", [False, True])
def test_int8_wgmma_all_zero_row(dev, streamed):
    """A row of zeros (no LayerNorm, fc1 without bias, relu): both row
    passes see amax = 0 and take scale 1, and the row's output is fc2's
    bias exactly."""
    rng = np.random.default_rng(30)
    params = _mlp_params(rng, 128, 384, torch.float32, dev, zero_fc_bias=True)
    x = torch.from_numpy(_arr(rng, 70, 128)).to(dev)
    x[3] = 0.0
    kw = {"activation": "relu", **({"chunk": 128} if streamed else {})}
    fn = int8_mlp.int8_mlp_streamed if streamed else int8_mlp.int8_mlp
    plain = int8_mlp.int8_mlp_streamed_plain if streamed else int8_mlp.int8_mlp_plain
    got = fn(params, x, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[3], params["proj"]["b"].float(), atol=0, rtol=0)
    assert_rows_close(got, plain(params, x, **kw), torch.float32)


@pytest.mark.parametrize("streamed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_wgmma_quick_gelu_saturates(dev, streamed, dtype):
    """quick_gelu far below zero: an fc1 bias of -60 puts h near -60, where
    1 + exp(-1.702 h) overflows to inf and the activation is -0, as in the
    plain version. Every seventh column is saturated, and for the streamed
    MLP also a whole slab (its amax is 0, so it takes scale 1). A NaN there
    would win the row's or slab's amax and poison the whole output row."""
    rng = np.random.default_rng(40)
    params = _mlp_params(rng, 128, 384, dtype, dev)
    bias = params["fc"]["b"].float()
    bias[::7] = -60.0
    if streamed:
        bias[128:256] = -60.0
    params["fc"]["b"] = bias.to(dtype)
    x = torch.from_numpy(_arr(rng, 70, 128)).to(dev, dtype)
    kw = {"activation": "quick_gelu", **({"chunk": 128} if streamed else {})}
    fn = int8_mlp.int8_mlp_streamed if streamed else int8_mlp.int8_mlp
    plain = int8_mlp.int8_mlp_streamed_plain if streamed else int8_mlp.int8_mlp_plain
    got = fn(params, x, **kw)
    torch.cuda.synchronize()
    assert_rows_close(got, plain(params, x, **kw), dtype)


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_golden_siglip_quantized_through_kernels(dev, mode):
    """f32 on the card (the fused kernels) against the CPU (the unfused
    path, as the JAX package takes there), at cosine 1 - 1e-4: the kernels'
    LayerNorm sums its rows in another order, and one int8 code that flips
    for it moves this 64-wide model's text embedding by 6.3e-5."""
    from clip_embedder_tpu_torch import Clip

    fixture = FIXTURES / "golden_siglip"
    img = np.load(fixture / "golden_image.npy")
    texts = ["a photo of a cat", "the dog!"]
    n0 = (int8_mlp.int8_mlp.launches, qkv.ln_qkv_int8.launches)
    card = Clip.from_local_dir(fixture, device="cuda", quantize=mode)
    got = card.vision.embed_image(img), card.text.embed_texts(texts)
    assert int8_mlp.int8_mlp.launches > n0[0]
    assert (qkv.ln_qkv_int8.launches > n0[1]) == (mode == "int8_all")
    cpu = Clip.from_local_dir(fixture, device="cpu", quantize=mode)
    ref = cpu.vision.embed_image(img), cpu.text.embed_texts(texts)
    for g, r in zip(got, ref):
        cos = (g * r).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(r, axis=-1))
        assert float(np.min(cos)) >= 1 - 1e-4


def test_every_wrapper_launches_on_its_tensors_device(dev):
    """Each wrapper on the last visible card, while the runtime's current
    device is card 0: the launch enters the tensors' device (``ops.cuda
    .launch``), so the kernel runs there, on that device's stream, and
    matches its plain version. Skipped below two cards, where it proves
    nothing."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices (a mesh shard on a card that is not current)")
    last = torch.device("cuda", n - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(12)
    dt = torch.bfloat16
    wrappers = (qkv.ln_qkv, flash.flash_attention_packed, flash.flash_attention,
                qkv.ln_qkv_int8, int8_mlp.int8_linear_fused, int8_mlp.int8_mlp,
                int8_mlp.int8_mlp_streamed, rows.norm_rows, rows.act_rows)
    before = [fn.launches for fn in wrappers]
    params, pre_ln, x = _qkv_inputs(2 * 61, 256, dt, last)
    got = qkv.ln_qkv(params, pre_ln, x)
    for g, r in zip(got, qkv.ln_qkv_plain(params, pre_ln, x)):
        torch.testing.assert_close(g.float(), r.float(), atol=1e-2, rtol=2 ** -7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 61, 4 * 64)).astype(np.float32))
               .to(last, dt) for _ in range(3))
    torch.testing.assert_close(
        flash.flash_attention_packed(q, k, v, num_heads=4).float(),
        flash.flash_attention_packed_plain(q, k, v, num_heads=4).float(), atol=2e-2, rtol=2e-2)
    qh, kh, vh = (t.reshape(2, 61, 4, 64).transpose(1, 2).contiguous() for t in (q, k, v))
    torch.testing.assert_close(flash.flash_attention(qh, kh, vh).float(),
                               flash.flash_attention_plain(qh, kh, vh).float(),
                               atol=2e-2, rtol=2e-2)
    qparams = {name: _qlinear(rng, 256, 256, dt, last) for name in "qkv"}
    for g, r in zip(qkv.ln_qkv_int8(qparams, pre_ln, x),
                    qkv.ln_qkv_int8_plain(qparams, pre_ln, x)):
        assert_rows_close(g, r, dt)
    assert_rows_close(int8_mlp.int8_linear_fused(qparams["q"], x, residual=x),
                      int8_mlp.int8_linear_fused_plain(qparams["q"], x, residual=x), dt)
    mlp = {"fc": _qlinear(rng, 256, 512, dt, last), "proj": _qlinear(rng, 512, 256, dt, last)}
    for fn, plain, kw in ((int8_mlp.int8_mlp, int8_mlp.int8_mlp_plain, {}),
                          (int8_mlp.int8_mlp_streamed, int8_mlp.int8_mlp_streamed_plain,
                           {"chunk": 256})):
        assert_rows_close(fn(mlp, x, pre_ln=pre_ln, add_residual=True, **kw),
                          plain(mlp, x, pre_ln=pre_ln, add_residual=True, **kw), dt)
    assert_row_kernel_close(rows.norm_rows(pre_ln, x), layers.layer_norm(pre_ln, x), dt)
    assert_row_kernel_close(rows.act_rows(x, "gelu"), layers.gelu(x), dt)
    torch.cuda.synchronize(last)
    assert [fn.launches - b for fn, b in zip(wrappers, before)] == [1] * len(wrappers)
    assert torch.cuda.current_device() == 0


def _guard_call(name, dev):
    """(wrapper, a call of it on small bf16 operands, the operand to mark
    requires_grad, the plain version's result)."""
    rng = np.random.default_rng(13)
    dt = torch.bfloat16
    params, pre_ln, x = _qkv_inputs(2 * 61, 256, dt, dev)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 61, 4 * 64)).astype(np.float32))
               .to(dev, dt) for _ in range(3))
    qh, kh, vh = (t.reshape(2, 61, 4, 64).transpose(1, 2).contiguous() for t in (q, k, v))
    qparams = {n: _qlinear(rng, 256, 256, dt, dev) for n in "qkv"}
    mlp = {"fc": _qlinear(rng, 256, 512, dt, dev), "proj": _qlinear(rng, 512, 256, dt, dev)}
    calls = {
        "ln_qkv": (qkv.ln_qkv, lambda: qkv.ln_qkv(params, pre_ln, x), x,
                   lambda: qkv.ln_qkv_plain(params, pre_ln, x)),
        "flash_attention_packed": (
            flash.flash_attention_packed, lambda: flash.flash_attention_packed(q, k, v,
                                                                               num_heads=4),
            q, lambda: flash.flash_attention_packed_plain(q, k, v, num_heads=4)),
        "flash_attention_packed[quant]": (
            flash.flash_attention_packed,
            lambda: flash.flash_attention_packed(q, k, v, num_heads=4, quant_qk=True,
                                                 quant_pv=True),
            k, lambda: flash.flash_attention_packed_plain(q, k, v, num_heads=4, quant_qk=True,
                                                          quant_pv=True)),
        "flash_attention": (flash.flash_attention, lambda: flash.flash_attention(qh, kh, vh), kh,
                            lambda: flash.flash_attention_plain(qh, kh, vh)),
        "ln_qkv_int8": (qkv.ln_qkv_int8, lambda: qkv.ln_qkv_int8(qparams, pre_ln, x),
                        pre_ln["scale"], lambda: qkv.ln_qkv_int8_plain(qparams, pre_ln, x)),
        "int8_linear_fused": (
            int8_mlp.int8_linear_fused, lambda: int8_mlp.int8_linear_fused(qparams["q"], x,
                                                                          residual=x),
            x, lambda: int8_mlp.int8_linear_fused_plain(qparams["q"], x, residual=x)),
        "int8_mlp": (int8_mlp.int8_mlp, lambda: int8_mlp.int8_mlp(mlp, x, pre_ln=pre_ln), x,
                     lambda: int8_mlp.int8_mlp_plain(mlp, x, pre_ln=pre_ln)),
        "int8_mlp_streamed": (
            int8_mlp.int8_mlp_streamed,
            lambda: int8_mlp.int8_mlp_streamed(mlp, x, pre_ln=pre_ln, chunk=256), x,
            lambda: int8_mlp.int8_mlp_streamed_plain(mlp, x, pre_ln=pre_ln, chunk=256)),
        "norm_rows": (rows.norm_rows, lambda: rows.norm_rows(pre_ln, x), pre_ln["bias"],
                      lambda: layers.layer_norm(pre_ln, x)),
        "act_rows": (rows.act_rows, lambda: rows.act_rows(x, "gelu_tanh"), x,
                     lambda: layers.gelu_tanh(x)),
    }
    return calls[name]


@pytest.mark.parametrize("name", ["ln_qkv", "flash_attention_packed",
                                  "flash_attention_packed[quant]", "flash_attention",
                                  "ln_qkv_int8", "int8_linear_fused", "int8_mlp",
                                  "int8_mlp_streamed", "norm_rows", "act_rows"])
def test_wrapper_refuses_an_operand_that_requires_grad(dev, name):
    """With autograd on, a wrapper raises before it launches when an operand
    requires grad (its kernel has no backward: the fresh output would end
    the gradient silently); under ``torch.no_grad()`` the same call
    launches and matches the plain version."""
    fn, call, operand, plain = _guard_call(name, dev)
    operand.requires_grad_(True)
    before = fn.launches
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
    assert fn.launches == before
    with torch.no_grad():
        got, ref = call(), plain()
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for g, r in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        if "int8" in name:
            assert_rows_close(g, r, torch.bfloat16)
        else:
            torch.testing.assert_close(g.float(), r.float(), atol=2e-2, rtol=2e-2)


# -- a block's LayerNorm and MLP activation (ops.rows, csrc/block_rows.cu) ---

def assert_row_kernel_close(got, ref, dtype, f32_tol=1e-5):
    """The row kernels against ``ops.layers``' plain functions on the card:
    in bf16 within one rounding step (2^-7 of the value; the f32 results
    before the one rounding differ by the sums' order and libm's last bit);
    in f32 within ``f32_tol``."""
    tol = (1e-5, 2 ** -7) if dtype == torch.bfloat16 else (f32_tol, f32_tol)
    torch.testing.assert_close(got.float(), ref.float(), atol=tol[0], rtol=tol[1])


def _row_inputs(dev, shape, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2.5 + 0.3).to(dtype)
    w = shape[-1]
    ln = {"scale": (1 + 0.2 * torch.randn(w, generator=g, device=dev)).to(dtype),
          "bias": (0.2 * torch.randn(w, generator=g, device=dev)).to(dtype)}
    return ln, x


# SO400M's and PE-Core-bigG's batch-32 rows, a ragged row count, the small
# widths of the fixtures and of a 1280-wide text tower
@pytest.mark.parametrize("shape", [(18432, 1152), (32800, 1536), (1003, 1152), (5, 64),
                                   (7, 1280), (3, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_rows_kernel_matches_plain(dev, shape, dtype):
    ln, x = _row_inputs(dev, shape, dtype, seed=shape[0])
    before = rows.norm_rows.launches
    got = rows.norm_rows(ln, x, eps=1e-6)
    torch.cuda.synchronize()
    assert rows.norm_rows.launches == before + 1
    assert_row_kernel_close(got, layers.layer_norm(ln, x, eps=1e-6), dtype)


# the MLP hiddens of SO400M and PE-Core-bigG at batch 32, a ragged row
# count, and a size of no whole 16-byte pieces (the tail past them)
@pytest.mark.parametrize("shape", [(18432, 4304), (32800, 8960), (1003, 4304), (7, 13)])
@pytest.mark.parametrize("act", sorted(rows.ACT_CODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_act_rows_kernel_matches_plain(dev, shape, act, dtype):
    _, x = _row_inputs(dev, shape, dtype, seed=shape[1])
    before = rows.act_rows.launches
    got = rows.act_rows(x, act)
    torch.cuda.synchronize()
    assert rows.act_rows.launches == before + 1
    assert_row_kernel_close(got, layers.ACTIVATIONS[act](x), dtype, f32_tol=1e-6)


def test_row_kernels_refuse_what_they_do_not_take(dev):
    ln, x = _row_inputs(dev, (4, 12), torch.bfloat16, seed=3)
    with pytest.raises(ValueError, match="width 12"):
        rows.norm_rows(ln, x)
    _, x = _row_inputs(dev, (4, 64), torch.float16, seed=4)
    with pytest.raises(ValueError, match="f32 or bf16"):
        rows.act_rows(x, "gelu")
    _, x = _row_inputs(dev, (4, 128), torch.bfloat16, seed=5)
    with pytest.raises(ValueError, match="contiguous"):
        rows.act_rows(x[:, ::2], "gelu")


def test_row_kernels_replay_in_a_captured_graph_set(dev):
    """Both kernels captured in a ``GraphSet``: the capture records one
    launch of each, and a replay on new inputs gives bitwise the eager
    calls' rows and adds those launches to the counts."""
    from clip_embedder_tpu_torch.utils import captured

    ln, x = _row_inputs(dev, (2 * 576, 1152), torch.bfloat16, seed=21)
    _, h = _row_inputs(dev, (2 * 576, 4304), torch.bfloat16, seed=22)

    def fn():
        return rows.norm_rows(ln, x, eps=1e-6), rows.act_rows(h, "gelu_tanh")

    graph = captured.GraphSet().capture(fn, dev, (x, h), what="the block rows")
    assert graph.launches == {(rows.norm_rows, "launches", None): 1,
                              (rows.act_rows, "launches", None): 1}
    x.copy_(_row_inputs(dev, x.shape, torch.bfloat16, seed=23)[1])
    h.copy_(_row_inputs(dev, h.shape, torch.bfloat16, seed=24)[1])
    before = (rows.norm_rows.launches, rows.act_rows.launches)
    graph.replay()
    torch.cuda.synchronize()
    assert (rows.norm_rows.launches, rows.act_rows.launches) == (before[0] + 1, before[1] + 1)
    for g, e in zip(graph.output, fn()):
        assert torch.equal(g, e)


def test_kernel_impl_block_launches_each_row_kernel_once(dev):
    """A kernel-impl block at SO400M's shapes (width 1152, 16 x 72 heads,
    MLP 4304, gelu_tanh, bf16): one launch each of ln_qkv and the packed
    attention for its attention half, and of norm_rows and act_rows for its
    MLP half; its rows agree with the eager block's."""
    from clip_embedder_tpu_torch.models import vit

    g = torch.Generator(device=dev).manual_seed(31)

    def t(*shape, scale):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    d, hidden = 1152, 4304
    p = {"ln1": {"scale": 1 + t(d, scale=0.1), "bias": t(d, scale=0.1)},
         "ln2": {"scale": 1 + t(d, scale=0.1), "bias": t(d, scale=0.1)},
         "attn": {n: {"w": t(d, d, scale=d ** -0.5), "b": t(d, scale=0.1)}
                  for n in ("q", "k", "v", "out")},
         "mlp": {"fc": {"w": t(d, hidden, scale=d ** -0.5), "b": t(hidden, scale=0.1)},
                 "proj": {"w": t(hidden, d, scale=hidden ** -0.5), "b": t(d, scale=0.1)}}}
    x = t(2, 576, d, scale=1.0)
    wrappers = (qkv.ln_qkv, flash.flash_attention_packed, rows.norm_rows, rows.act_rows)
    before = [fn.launches for fn in wrappers]
    with torch.inference_mode():
        got = vit.block_forward(p, x, heads=16, act=layers.gelu_tanh, ln_eps=1e-6,
                                impl="kernel")
        torch.cuda.synchronize()
        assert [fn.launches - b for fn, b in zip(wrappers, before)] == [1, 1, 1, 1]
        ref = vit.block_forward(p, x, heads=16, act=layers.gelu_tanh, ln_eps=1e-6,
                                impl="eager")
    assert [fn.launches - b for fn, b in zip(wrappers, before)] == [1, 1, 1, 1]
    assert _cos(got.reshape(-1, d), ref.reshape(-1, d)) >= 1 - 1e-4


# -- the captured forwards (utils.captured) ----------------------------------

def _images(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (40 + 7 * i, 60 - 3 * i, 3), dtype=np.uint8) for i in range(n)]


def _eager_rows(emb, images):
    """The rows of ``embed_images_device`` with the preprocess's plain route
    and the tower called directly."""
    with torch.inference_mode():
        pixels = emb.preprocessor.eager(images)
        return emb.tower(pixels, attn_impl=emb.attn_impl, channels_first=True)[: len(images)]


def _captured_clip(mode=None):
    from clip_embedder_tpu_torch import Clip

    return Clip.from_local_dir(FIXTURES / "golden_siglip", device="cuda", quantize=mode)


def _cos(a, b):
    return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min())


@pytest.mark.parametrize("mode", [None, "int8_all"])
def test_captured_rows_equal_eager_across_buckets_and_threads(dev, mode):
    import threading

    from clip_embedder_tpu_torch.utils import captured

    clip = _captured_clip(mode)
    emb = clip.vision
    batches = [_images(3), _images(1, seed=6)]
    refs = [_eager_rows(emb, b) for b in batches]
    for _ in range(2):  # two buckets in turn
        for b, ref in zip(batches, refs):
            rows, n = emb.embed_images_device(b)
            assert _cos(rows[:n], ref) >= 1 - 1e-6
    assert len(captured.graphs_of(emb.tower).graphs) == 2
    bad = []

    def worker(i):
        for _ in range(20):
            rows, n = emb.embed_images_device(batches[i])
            if _cos(rows[:n], refs[i]) < 1 - 1e-6:
                bad.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and bad == []
    from clip_embedder_tpu_torch.text import pad_batch

    texts = ["a cat", "two dogs on a mat", "the sea"]
    ids, mask = clip.text.tokenize(texts)
    ids, _ = pad_batch(ids, mask, 4, clip.text.pad_id)  # the bucket
    with torch.inference_mode():
        tref = clip.text.tower(torch.from_numpy(ids).to(dev), attn_impl=clip.text.attn_impl)
    assert _cos(torch.from_numpy(clip.text.embed_texts(texts)), tref[:3].cpu()) >= 1 - 1e-6


def test_embed_images_device_rows_survive_the_next_call(dev):
    from clip_embedder_tpu_torch.utils import captured

    emb = _captured_clip().vision
    first, _ = emb.embed_images_device(_images(2))
    kept = first.clone()
    dup = emb.duplicate()  # shares the tower, and so its graphs
    second, _ = dup.embed_images_device(_images(2, seed=9))
    torch.cuda.synchronize()
    assert torch.equal(first, kept) and not torch.equal(first, second)
    assert captured.graphs_of(dup.tower) is captured.graphs_of(emb.tower)
    assert len(captured.graphs_of(emb.tower).graphs) == 1


def test_the_recorder_changes_no_captured_row(dev, monkeypatch):
    """A capture and a replay with the span recorder on, inside a profiler
    session (so the spans around them enter its ranges too), give bitwise
    the rows of a capture and a replay with it off; no span opens inside a
    capture."""
    from torch.profiler import ProfilerActivity, profile

    from clip_embedder_tpu_torch.utils import logging as tracing

    batch = _images(3)
    monkeypatch.setattr(tracing, "RECORDING", False)
    emb = _captured_clip().vision
    off = [emb.embed_images_device(batch)[0].clone() for _ in range(2)]  # capture, replay
    monkeypatch.setattr(tracing, "RECORDING", True)
    tracing.record("test.mark", 0, 0)
    mark = tracing.spans()[-1].seq
    emb = _captured_clip().vision  # a new tower and preprocessor: their graphs anew
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = [emb.embed_images_device(batch)[0].clone() for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    spans = [s for s in tracing.spans() if s.seq > mark]
    captures = [s for s in spans if s.name == "graphs.capture"]
    assert len(captures) == 2 and "the preprocess resize" in {s.attrs["what"] for s in captures}
    assert all(s.profiled for s in spans)
    assert not any(s.parent in {c.id for c in captures} for s in spans)
    assert sum(s.name == "preprocess.call" for s in spans) == 2


def test_launch_counts_stay_exact_after_replay(dev):
    import importlib.util

    from clip_embedder_tpu_torch.utils import captured

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    emb = _captured_clip().vision
    images = _images(3)
    before = flash.flash_attention.launches
    _eager_rows(emb, images)
    one = flash.flash_attention.launches - before
    assert one > 0  # the fixture's 4 x 16 heads take kernel 3
    before = flash.flash_attention.launches
    emb.embed_images_device(images)  # the warm-up forward, the capture, a replay
    assert flash.flash_attention.launches - before == 2 * one
    before = flash.flash_attention.launches
    for _ in range(2):  # replays
        emb.embed_images_device(images)
    assert flash.flash_attention.launches - before == 2 * one
    # what a replay launches: the graph's kernel nodes of csrc/flash_bhsd.cu
    (graph,) = captured.graphs_of(emb.tower).graphs.values()
    nodes = smoke.port_launches(smoke.graph_kernel_names(graph.graph))
    assert nodes["flash_attention"] == one


def test_a_capture_beside_another_threads_cuda_work(dev):
    """A bucket's first call captures while another thread runs the
    preprocess and the tower's eager forward (the port's kernels launched
    from that thread) in a loop, as the server's preprocess and handler
    threads do: both threads' rows equal their eager twins."""
    import threading

    from clip_embedder_tpu_torch.utils import captured

    emb = _captured_clip().vision
    busy_images, new = _images(1, seed=7), _images(5, seed=8)
    busy_ref, ref = _eager_rows(emb, busy_images), _eager_rows(emb, new)
    started, stop, bad, rounds = threading.Event(), threading.Event(), [], [0]

    def busy():
        try:
            while not stop.is_set():
                if _cos(_eager_rows(emb, busy_images), busy_ref) < 1 - 1e-6:
                    bad.append(rounds[0])
                rounds[0] += 1
                started.set()
        except Exception as e:  # noqa: BLE001 - asserted below
            bad.append(repr(e))
            started.set()

    thread = threading.Thread(target=busy)
    thread.start()
    started.wait(timeout=120)
    try:
        rows, n = emb.embed_images_device(new)  # bucket 8: captured now
    finally:
        stop.set()
        thread.join(timeout=120)
    assert not thread.is_alive() and bad == [] and rounds[0] > 1
    assert len(captured.graphs_of(emb.tower).graphs) == 1
    assert _cos(rows[:n], ref) >= 1 - 1e-6


def test_a_forward_that_reads_the_host_raises_at_capture(dev):
    from clip_embedder_tpu_torch.utils import captured

    class ReadsHost(torch.nn.Module):
        def forward(self, x):
            return x * float(x.sum())

    tower = ReadsHost()
    with pytest.raises(captured.CaptureError, match="aten.item"):
        captured.forward(tower, torch.ones(2, 3, device=dev))
    assert captured.graphs_of(tower).graphs == {}


def test_dp_mesh_of_two_cuda0_entries_returns_the_unsharded_rows(dev):
    from clip_embedder_tpu_torch.parallel import ShardedVisionEmbedder, get_mesh

    emb = _captured_clip().vision
    images = _images(4)
    sharded = ShardedVisionEmbedder(emb, get_mesh(devices=["cuda:0", "cuda:0"]))
    got = sharded.embed_images(images)
    # the shards replay one graph in turn: shard 0's rows must not be shard 1's
    assert not np.allclose(got[:2], got[2:])
    for half in (slice(0, 2), slice(2, 4)):
        ref = _eager_rows(emb, images[half]).float().cpu().numpy()
        assert _cos(torch.from_numpy(got[half]), torch.from_numpy(ref)) >= 1 - 1e-5


# -- the compiled inference paths: the preprocess, the ONNX executor, the search

def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_captured_preprocess_is_bitwise_the_eager_one_across_shapes(dev):
    from clip_embedder_tpu_torch.utils import captured

    pp = _captured_clip().vision.preprocessor
    small = _images(3)  # 128 x 128
    large = [np.full((300, 200, 3), 7, np.uint8)] + _images(4, seed=8)  # 384 x 256
    for batch in (small, large, small, large):  # each shape's buffers reused as they are
        with torch.inference_mode():
            got, ref = pp(batch), pp.eager(batch)
        assert torch.equal(got, ref)  # every row of the bucket, the padded ones too
    graphs = captured.graphs_of(pp)
    assert sorted(k[1:4] for k in graphs.graphs) == [(4, 128, 128), (8, 384, 256)]
    assert all(e.host.is_pinned() and e.images.is_cuda for e in pp._staging.values())
    cached = dict(pp._device_weights_cache)
    pp(small)  # no matrix uploaded again
    assert pp._device_weights_cache.keys() == cached.keys()
    assert all(pp._device_weights_cache[k][0] is cached[k][0] for k in cached)


def test_captured_preprocess_padded_rows_equal_the_plain_route(dev):
    """The padded rows of a bucket on the card: a shape's first call (its
    page-locked buffer as ``torch.empty`` left it), a call of fewer images
    after a full one at the same shape, and a mesh shard with no image, each
    ``torch.equal`` to the plain zero-filled route, all rows."""
    pp = _captured_clip().vision.preprocessor
    full = [np.full((300, 200, 3), 7, np.uint8)] + _images(3, seed=14)  # bucket 4, 384 x 256
    padded = pp.padded_size(full)
    with torch.inference_mode():
        pad = pp.eager(full[:3])[3:]  # a padded row of the plain route
        first = pp.run(full[:3], batch_bucket=4, padded=padded)
        assert torch.equal(first, pp.eager(full[:3]))
        pp.run(full, batch_bucket=4, padded=padded)
        fewer = pp.run(full[:2], batch_bucket=4, padded=padded)
        assert torch.equal(fewer, torch.cat([pp.eager(full[:2]), pad, pad]))
        empty = pp.run([], batch_bucket=4, padded=padded)
        assert torch.equal(empty, pad.expand(4, -1, -1, -1))


def test_captured_preprocess_keeps_full_f32_whatever_the_tf32_flag(dev):
    pp = _captured_clip().vision.preprocessor
    batch = _images(2, seed=4) + [np.full((520, 130, 3), 200, np.uint8)]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = pp(batch)  # this shape's capture: the resize's products in full f32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        assert torch.equal(got[:3], pp.eager(batch)[:3])


def test_two_threads_preprocess_at_once_on_the_card(dev):
    import threading

    pp = _captured_clip().vision.preprocessor
    batches = [_images(3, seed=11), [np.full((260, 400, 3), 90, np.uint8)] + _images(1)]
    with torch.inference_mode():
        refs = [pp.eager(b) for b in batches]
    bad = []

    def worker(i):
        for _ in range(20):
            if not torch.equal(pp(batches[i]), refs[i]):
                bad.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and bad == []


def test_the_onnx_executor_is_captured_per_bucket(dev, tmp_path):
    import importlib.util

    from clip_embedder_tpu_torch.onnx_exec import OnnxTower
    from clip_embedder_tpu_torch.utils import captured
    from clip_embedder_tpu_torch.vision import OnnxVisual

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    class Tiny(torch.nn.Module):  # patches, attention (shape-derived reshapes), a head
        def __init__(self):
            super().__init__()
            self.patch = torch.nn.Conv2d(3, 32, 4, stride=4)
            self.attn = torch.nn.MultiheadAttention(32, 4, batch_first=True)
            self.head = torch.nn.Linear(32, 8)

        def forward(self, x):
            y = self.patch(x).flatten(2).transpose(1, 2)
            a, _ = self.attn(y, y, y, need_weights=False)
            return torch.nn.functional.normalize(self.head((y + a).mean(dim=1) * 0.5), dim=-1)

    torch.manual_seed(12)
    path = tmp_path / "visual.onnx"
    smoke.onnx_export(Tiny().eval(), torch.randn(2, 3, 16, 16), path, "pixel_values",
                      "image_embeds")
    tower = OnnxVisual(OnnxTower(path, device=dev))
    xs = {b: torch.randn(b, 3, 16, 16, device=dev) for b in (2, 4)}
    for b in (2, 4, 2, 4):
        got = captured.forward(tower, xs[b], attn_impl="eager", channels_first=True)
        with torch.inference_mode():
            assert torch.equal(got, tower(xs[b]))
    assert len(captured.graphs_of(tower).graphs) == 2


def test_captured_search_equals_eager_and_follows_add(dev):
    from clip_embedder_tpu_torch.parallel import CorpusIndex, get_mesh, search
    from clip_embedder_tpu_torch.utils import captured

    rng = np.random.default_rng(13)
    corpus = _unit_rows(rng, 3000, 64)
    index = CorpusIndex.build(corpus, get_mesh(devices=["cuda:0"] * 2))
    q = _unit_rows(rng, 5, 64)
    for _ in range(2):
        vals, ids = index.search(q, 7)
    qb = np.concatenate([q, np.zeros((3, 64), np.float32)])
    # the eager reference in full f32, as the index's default precision
    # captures: the process's TF32 flag is off
    assert not torch.backends.cuda.matmul.allow_tf32
    ev, ei = search._sharded_topk(qb, index._shards, index._counts, k=8)
    np.testing.assert_array_equal(ids, ei.cpu().numpy()[:5, :7])
    np.testing.assert_allclose(vals, ev.cpu().numpy()[:5, :7], atol=1e-6, rtol=0)
    graphs = captured.graphs_of(index)
    assert len(graphs.graphs) == 1
    new = _unit_rows(rng, 10, 64)
    index.add(new)  # the shards keep their shape; the graph over the old ones goes
    assert graphs.graphs == {}
    vals, ids = index.search(new, 1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(3000, 3010))
    assert len(graphs.graphs) == 1


# -- the tensor-parallel forward and the train step, captured -----------------

def _tp_embedder():
    from clip_embedder_tpu_torch.parallel import ShardedVisionEmbedder, get_mesh

    mesh = get_mesh(devices=["cuda:0"] * 2, model_parallel=2)
    return ShardedVisionEmbedder(_captured_clip().vision, mesh, tensor_parallel=True)


def test_captured_tp_forward_is_bitwise_the_eager_one(dev):
    """A TP mesh row of two ``cuda:0`` ranks replays its ``TPViT``'s graph, one
    a shard shape; its rows equal the ``TPViT`` called eagerly on the same
    pixels, bit for bit, across two buckets in turn."""
    from clip_embedder_tpu_torch.utils import captured

    tp = _tp_embedder()
    assert not captured.several_devices(tp.mesh.devices[0])
    pp, tower = tp.inner.preprocessor, tp.towers[0]
    for images in (_images(3), _images(1, seed=15), _images(3), _images(1, seed=15)):
        rows, n = tp.embed_images_device(images)
        with torch.inference_mode():
            pixels = pp.run(images, batch_bucket=rows.shape[0], padded=pp.padded_size(images))
            ref = tower(pixels, attn_impl="eager", channels_first=True)
        assert torch.equal(rows, ref)
    assert len(captured.graphs_of(tower).graphs) == 2


def _train_cfg(**kw):
    from clip_embedder_tpu_torch import train as tt
    from clip_embedder_tpu_torch.config import OpenClipConfig
    from clip_embedder_tpu_torch.models.build import resolve_text, resolve_vision

    occ = OpenClipConfig.from_dict(json.loads(
        (FIXTURES / "golden_siglip" / "open_clip_config.json").read_text()))
    return tt.TrainConfig(vision_cfg=resolve_vision(occ.model_cfg).cfg,
                          text_cfg=resolve_text(occ.model_cfg).cfg, loss="siglip",
                          learning_rate=1e-3, remat=True, **kw)


def _train_batch(cfg, seed=16, b=4):
    rng = np.random.default_rng(seed)
    v, t = cfg.vision_cfg, cfg.text_cfg
    return {"pixels": rng.uniform(-1, 1, (b, v.image_size, v.image_size, 3)).astype(np.float32),
            "input_ids": rng.integers(1, t.vocab_size, (b, t.context_length)).astype(np.int32)}


TRAIN_LAYOUTS = {"unsharded": (None, {}), "dp": (1, {}), "ring": (1, {"ring_loss": True}),
                 "fsdp": (1, {"fsdp": True}), "tp": (2, {"tensor_parallel": True})}


@pytest.mark.parametrize("layout", list(TRAIN_LAYOUTS))
def test_captured_train_step_equals_the_eager_card_step(dev, layout):
    """3 steps of ``train_step`` (one CUDA graph: the forward, the backward
    with remat, the capturable AdamW) against 3 of ``eager_train_step`` with
    the same optimizer from the same state: the losses and every stepped
    tensor bit for bit; one graph for the batch shape, the step count 3."""
    from clip_embedder_tpu_torch import train as tt
    from clip_embedder_tpu_torch.parallel import get_mesh
    from clip_embedder_tpu_torch.utils import captured
    from clip_embedder_tpu_torch.weights import tree_map

    model_parallel, kw = TRAIN_LAYOUTS[layout]
    cfg = _train_cfg(**kw)
    init, _ = tt.init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg)
    mesh = None if model_parallel is None else get_mesh(devices=["cuda:0"] * 2,
                                                        model_parallel=model_parallel)
    batch = _train_batch(cfg)
    runs = {}
    for route in ("captured", "eager"):
        start = tree_map(lambda t: t.detach().clone().requires_grad_(True), init)
        if mesh is None:
            params, opt = start, tt.init_opt_state(cfg, start)
        else:
            _, params, opt = tt.make_sharded_train_step(cfg, mesh, start)
        assert all(g["capturable"] for g in opt.param_groups)
        losses = []
        for _ in range(3):
            if route == "captured":
                _, _, loss = tt.train_step(params, opt, batch, cfg=cfg,
                                           tx=tt.make_optimizer(cfg), mesh=mesh)
            else:
                _, _, loss = tt.eager_train_step(params, opt, batch, cfg=cfg, mesh=mesh)
            losses.append(loss)
        runs[route] = (torch.stack(losses), tt._stepped(params), opt)
    (cl, cp, copt), (el, ep, eopt) = runs["captured"], runs["eager"]
    assert torch.equal(cl, el) and bool(cl[-1] < cl[0])
    assert all(torch.equal(a, b) for a, b in zip(cp, ep)) and len(cp) == len(ep)
    assert all(t.grad is None for t in cp)
    assert len(captured.graphs_of(copt).graphs) == 1 and captured.graphs_of(eopt) is None
    assert all(float(s["step"]) == 3 for s in copt.state.values())


def test_captured_train_step_follows_the_optimizer_state_and_refuses_another_tree(dev):
    """A state loaded into the optimizer (new tensors) is read by the next
    step, captured anew: step 2 run again from step 1's params and loaded
    state gives step 2's params; a second batch shape takes a graph of its
    own; a tree the optimizer does not step is refused."""
    import copy

    from clip_embedder_tpu_torch import train as tt
    from clip_embedder_tpu_torch.utils import captured

    cfg = _train_cfg()
    params, _ = tt.init_train_state(torch.Generator(device="cuda").manual_seed(1), cfg)
    opt, tx = tt.init_opt_state(cfg, params), tt.make_optimizer(cfg)
    batch = _train_batch(cfg)
    tt.train_step(params, opt, batch, cfg=cfg, tx=tx)
    saved = [t.detach().clone() for t in tt._stepped(params)]
    state = copy.deepcopy(opt.state_dict())
    tt.train_step(params, opt, batch, cfg=cfg, tx=tx)
    after = [t.detach().clone() for t in tt._stepped(params)]
    with torch.no_grad():
        for t, v in zip(tt._stepped(params), saved):
            t.copy_(v)
    opt.load_state_dict(state)
    tt.train_step(params, opt, batch, cfg=cfg, tx=tx)
    assert all(torch.equal(a, b) for a, b in zip(after, tt._stepped(params)))
    assert all(float(s["step"]) == 2 for s in opt.state.values())
    tt.train_step(params, opt, _train_batch(cfg, b=2), cfg=cfg, tx=tx)
    assert len(captured.graphs_of(opt).graphs) == 2
    other, _ = tt.init_train_state(torch.Generator(device="cuda").manual_seed(2), cfg)
    with pytest.raises(ValueError, match="not the tree its optimizer steps"):
        tt.train_step(other, opt, batch, cfg=cfg, tx=tx)


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("layout", list(TRAIN_LAYOUTS))
def test_captured_train_step_holds_to_the_lazy_adamw(dev, layout):
    """3 captured steps (the capturable AdamW, its state made up front),
    each held against a step of the lazy ``torch.optim.AdamW`` on the same
    card from the same state (``chip_smoke.hold_lazy_steps``, whose comment
    derives the gate): losses, moments and step counts bitwise equal, each
    parameter within 2e-5 of its update; the lazy run's first step makes
    its own state, its later ones resume the captured run's."""
    from clip_embedder_tpu_torch import train as tt
    from clip_embedder_tpu_torch.parallel import get_mesh
    from clip_embedder_tpu_torch.weights import tree_map

    model_parallel, kw = TRAIN_LAYOUTS[layout]
    cfg = _train_cfg(**kw)
    init, _ = tt.init_train_state(torch.Generator(device="cuda").manual_seed(0), cfg)
    mesh = None if model_parallel is None else get_mesh(devices=["cuda:0"] * 2,
                                                        model_parallel=model_parallel)
    batch = _train_batch(cfg)
    trees = []
    for capturable in (True, False):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True), init)
        if mesh is not None:
            _, params, _ = tt.make_sharded_train_step(cfg, mesh, params)
        trees.append((params, tt.make_optimizer(cfg, capturable=capturable)(params)))
    (cp, copt), (lp, lopt) = trees
    held = _smoke().hold_lazy_steps(
        layout, lambda: float(tt.train_step(cp, copt, batch, cfg=cfg, tx=None, mesh=mesh)[2]),
        cp, copt, lambda: float(tt.eager_train_step(lp, lopt, batch, cfg=cfg, mesh=mesh)[2]),
        lp, lopt, 3, card=True)
    assert held["equal"] and held["gate_share"] <= 1
    assert all(s["step"].is_cuda and float(s["step"]) == 3 for s in copt.state.values())
    assert not any(g["capturable"] for g in lopt.param_groups)


def test_a_graph_freed_during_a_capture_leaves_the_capture_whole(dev):
    """A graph whose owner dies in a reference cycle is freed when Python's
    collector finds the cycle; on the capturing thread that is a
    ``cudaGraphExecDestroy`` no capture allows. Here a graph is dropped into
    a fresh cycle inside a capture, with the collector set to run at
    almost every allocation: the capture holds (the collector is paused)."""
    import gc

    from clip_embedder_tpu_torch.utils import captured

    class Owner:
        pass

    x = torch.arange(8.0, device=dev)
    graphs = captured.graphs_of(Owner(), create=True)
    doomed = [graphs.capture(lambda: x * 2, dev, [x], what="x * 2")]

    def fn():
        if torch.cuda.is_current_stream_capturing():
            cycle = [doomed.pop()]
            cycle.append(cycle)  # the graph's last reference, in a cycle
            del cycle
            [[i] for i in range(2000)]  # allocations: the collector's cue
        return x * 3

    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        g = captured.graphs_of(Owner(), create=True).capture(fn, dev, [x], what="x * 3")
    finally:
        gc.set_threshold(*thresholds)
    g.replay()
    assert torch.equal(g.output, x * 3) and gc.isenabled()


def test_a_checkpoint_resumes_across_the_cpu_and_the_card(dev, tmp_path):
    """A state saved by the card's capturable optimizer resumes on the CPU,
    and one saved on the CPU resumes in the card's captured step, through
    ``save_checkpoint`` / ``load_checkpoint``: the loaded groups take the
    resuming optimizer's ``capturable``, the step counts lie where it reads
    them, and the resumed step's loss (from the same params) is the saving
    device's within 1e-5."""
    from clip_embedder_tpu_torch import train as tt
    from clip_embedder_tpu_torch.utils import captured

    cfg = _train_cfg()
    batch, tx = _train_batch(cfg), tt.make_optimizer(cfg)
    params, _ = tt.init_train_state(torch.Generator(device="cuda").manual_seed(3), cfg)
    opt = tt.init_opt_state(cfg, params)
    tt.train_step(params, opt, batch, cfg=cfg, tx=tx)
    tt.save_checkpoint(tmp_path / "card", params, opt, step=1)
    _, _, card_loss = tt.train_step(params, opt, batch, cfg=cfg, tx=tx)

    on_cpu = tt.load_checkpoint(tmp_path / "card", step=1, device="cpu")
    cpu_opt = tt.init_opt_state(cfg, on_cpu["params"])
    cpu_opt.load_state_dict(on_cpu["opt_state"])
    assert not any(g["capturable"] for g in cpu_opt.param_groups)
    _, _, cpu_loss = tt.train_step(on_cpu["params"], cpu_opt, batch, cfg=cfg, tx=tx)
    assert all(s["step"].device.type == "cpu" and float(s["step"]) == 2
               for s in cpu_opt.state.values())
    torch.testing.assert_close(cpu_loss, card_loss.cpu(), rtol=1e-5, atol=0)

    tt.save_checkpoint(tmp_path / "cpu", on_cpu["params"], cpu_opt, step=2)
    back = tt.load_checkpoint(tmp_path / "cpu", step=2, device="cuda")
    card_opt = tt.init_opt_state(cfg, back["params"])
    card_opt.load_state_dict(back["opt_state"])
    assert all(g["capturable"] for g in card_opt.param_groups)
    _, _, resumed = tt.train_step(back["params"], card_opt, batch, cfg=cfg, tx=tx)
    _, _, cpu_next = tt.train_step(on_cpu["params"], cpu_opt, batch, cfg=cfg, tx=tx)
    torch.testing.assert_close(resumed.cpu(), cpu_next, rtol=1e-5, atol=0)
    assert all(s["step"].is_cuda and float(s["step"]) == 3 for s in card_opt.state.values())
    assert len(captured.graphs_of(card_opt).graphs) == 1


def test_device_breakdown_times_with_events_where_the_profiler_sees_nothing(dev):
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x = torch.randn(1024, 1024, device=dev)
    traced = smoke.device_breakdown(lambda: x @ x)
    assert traced["source"] == "torch.profiler" and traced["busy_ms"] > 0
    timed = smoke.device_breakdown(lambda: x @ x, sessions=0)  # no session: the events
    assert timed["source"] == "cuda events"
    assert timed["groups_ms"] == {smoke.EVENTS_GROUP: timed["busy_ms"]}
    assert 0 < timed["busy_ms"] <= timed["wall_ms"] and 0 <= timed["idle_share"] < 1

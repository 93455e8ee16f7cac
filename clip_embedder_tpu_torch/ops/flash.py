"""Fused attention kernels (``csrc/flash_packed.cu``, ``csrc/flash_bhsd.cu``,
device code shared in ``csrc/flash.cuh``).

Counterparts of the JAX package's two Pallas kernels:

* ``flash_attention_packed`` (``clip_embedder_tpu.ops.flash``, kernel 2): per
  head, softmax(q·scale·kᵀ + mask)·v on q/k/v in the [B, S, H·D] projection
  layout, output in the same layout;
* ``flash_attention`` (kernel 3): the same on [B, H, S, D] tensors, for head
  layouts with no 128-lane head group (``head_group`` is None).

Both compute

* the scale folded into q and rounded to the input dtype;
* f32 logits, row max and denominator;
* ``fast_softmax``: exp(clamp(logits, ±60)) in place of the max pass;
* the denominator summing p as rounded to v's dtype when D is not a
  multiple of 128 (the TPU kernels' spare-lane matmul), and p itself
  otherwise.

The packed kernel also takes ``exp_bf16`` (the exp's argument and result
rounded to bf16) and ``rope=(sin, cos)``: [S, H·D] f32 tables (``ops.rope``)
that rotate q and k in f32, rounded to the input dtype before q is scaled
(on the card a pre-pass of the same launch rotates them once into scratch
copies). And the JAX kernel's other options, with its defaults and its rules
for when each acts:

* ``quant_qk``: q·kᵀ in int8 into int32. q (scaled and rounded) per row,
  amax/127 (1 where the amax is 0), k with one such scale per (batch, head);
  codes round half to even, clipped to ±127. Without a mask and without
  ``fast_softmax`` the row max is taken on the int32 products and p =
  exp(f32(acc − max)·qsc·ksc); otherwise the logits are f32(acc)·qsc·ksc.
* ``quant_pv``: p·v in int8. p per row (rowmax(p)/127, codes in [0, 127];
  under ``exp_bf16`` p, its scale and p/scale are bf16), v per column over
  the head's S rows; the denominator is the f32 sum of p itself.
* ``mxu_denom`` (default True): False makes the denominator sum p unrounded
  where D is not a multiple of 128.
* ``group_mult`` and ``pair_exp`` change only the TPU's schedule, never the
  output (the JAX kernel applies them where its head group allows, and
  ignores them elsewhere). They are accepted and ignored here: the card has
  no counterpart of either schedule. The TPU runs each [S, S] exp pass as
  one vector pass, which pairing two heads amortizes; the card runs the exp
  per element on its special-function units, with no pass to amortize. Nor
  does a block walking several heads in turn over its query tile pay on the
  TMA kernel: it read slower (PERF.md, kernel table).
Masks (additive, f32 in the kernel) on the packed kernel, the JAX kernel's
forms in its order (``packed_mask``): a key row per batch element
[B, 1, 1, S] (B > 1; the BERT text towers' padding mask), one mask shared by
every batch row and head ([S, S], [1, 1, S, S] or [1, 1, 1, S]), a full
[S, S] block per batch element [B, 1, S, S] (CoCa's causal + cls mask);
anything else (a per-head mask) raises, and so does rope with a mask, as in
the JAX package. The kernel reads every form through a batch stride and a
row stride. ``flash_attention`` takes the shared forms; it hands per-batch
masks, and cross-attention, to ``attention_core``, as the JAX kernel does.

The wrappers launch the CUDA kernels for tensors on the card and run the
``*_plain`` versions for tensors on the CPU. On the card the head dim and
dtype pick the kernel (``kernel_route``): bf16 with D a multiple of 8 the
TMA + wgmma kernel, other bf16 head dims the mma.sync one, f32 the FMA one;
a quantized call (``quant_qk`` or ``quant_pv``) in bf16 with D a multiple of
8 the int8 TMA kernel of ``csrc/flash_int8_tma.cu``, any other the int8
kernel of ``csrc/flash_int8.cu``; and ``mxu_denom=False`` where D is not a
multiple of 128 the mma.sync one (the TMA kernel's denominator is its ones
column of v).
"""

from __future__ import annotations

import torch

from . import cuda
from .rope import apply_rope

MAX_HEAD_DIM = 128


def head_group(num_heads: int, d: int) -> int | None:
    """Smallest divisor g of num_heads with g·d a lane multiple (128): the
    JAX package takes the packed kernel only where one exists."""
    for g in range(1, num_heads + 1):
        if num_heads % g == 0 and (g * d) % 128 == 0:
            return g
    return None


def kernel_route(d: int, dtype: torch.dtype, *, quant: bool = False,
                 mxu_denom: bool = True) -> str | None:
    """Which kernel runs head dim ``d`` in ``dtype`` (the sources' ``launch``
    gates, by shape): for a quantized call (``quant``: ``quant_qk`` or
    ``quant_pv``) ``"int8_tma"`` in bf16 where d is a multiple of 8
    (``csrc/flash_int8_tma.cu``), else ``"int8_wgmma"``
    (``csrc/flash_int8.cu``); otherwise, in ``csrc/flash.cuh``,
    ``"fma_f32"`` for f32, and for bf16 ``"tma_wgmma"`` where d is a
    multiple of 8 (TMA moves 16-byte rows) and the denominator is the one
    its ones column gives (``mxu_denom``, or d a multiple of 128), else
    ``"mma_sync"``; None for what no kernel takes (d outside 1..128, or
    another dtype)."""
    if not 1 <= d <= MAX_HEAD_DIM or dtype not in cuda.DTYPE_CODES:
        return None
    tma = dtype == torch.bfloat16 and d % 8 == 0
    if quant:
        return "int8_tma" if tma else "int8_wgmma"
    if dtype == torch.float32:
        return "fma_f32"
    return "tma_wgmma" if tma and (mxu_denom or d % 128 == 0) else "mma_sync"


def frag_pos(key: torch.Tensor) -> torch.Tensor:
    """Where the int8 TMA kernel keeps key ``key`` in v's transposed codes
    (``csrc/flash_int8_tma.cu`` ``frag_pos``): the keys of each 32 in the
    order a thread's q·kᵀ accumulator holds them (thread t of a quad: keys
    8m + 2t and 8m + 2t + 1 of n8 tile m), which is s8 wgmma's A fragment
    order (4 codes a register, at 4t and 16 + 4t) of the same p."""
    return (key & ~15) + 4 * ((key & 7) >> 1) + 2 * ((key >> 3) & 1) + (key & 1)


def _tma_operands(route: str | None, *ts):
    """The operands as the TMA kernels read them: 16-byte aligned (a view
    that starts mid-allocation is copied)."""
    if route not in ("tma_wgmma", "int8_tma"):
        return ts
    return tuple(t if t is None or t.data_ptr() % 16 == 0 else t.clone() for t in ts)


def fits_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_heads: int) -> bool:
    """The packed kernel takes these operands: self-attention shapes, f32 or
    bf16, head dim at most 128."""
    if not (q.shape == k.shape == v.shape) or q.dim() != 3:
        return False
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in cuda.DTYPE_CODES:
        return False
    hd = q.shape[-1]
    return hd % num_heads == 0 and hd // num_heads <= MAX_HEAD_DIM


def packed_mask(mask: torch.Tensor | None, batch: int,
                seq: int) -> tuple[torch.Tensor | None, int, int]:
    """The mask as the packed kernel reads it: (the additive mask as a
    contiguous f32 tensor, its batch stride, its row stride), in elements.
    The forms, tested in the JAX kernel's order: [B, 1, 1, S] with B > 1, a
    key row per batch element ([B, S]: strides S, 0); [S, S] and
    [1, 1, S, S], shared ([S, S]: 0, S); [1, 1, 1, S], one shared key row
    ([S]: 0, 0); [B, 1, S, S], a full block per batch element ([B, S, S]:
    S², S). Any other shape (e.g. a per-head [B, H, S, S]) raises
    ``ValueError`` naming it. No mask: (None, 0, 0)."""
    if mask is None:
        return None, 0, 0
    shape = tuple(mask.shape)
    if batch > 1 and shape == (batch, 1, 1, seq):
        return mask[:, 0, 0].to(torch.float32).contiguous(), seq, 0
    if shape in ((seq, seq), (1, 1, seq, seq)):
        return mask.reshape(seq, seq).to(torch.float32).contiguous(), 0, seq
    if shape == (1, 1, 1, seq):
        return mask.reshape(seq).to(torch.float32).contiguous(), 0, 0
    if shape == (batch, 1, seq, seq):
        return mask[:, 0].to(torch.float32).contiguous(), seq * seq, seq
    raise ValueError(f"unsupported mask shape {shape}")


def mask_form(batch_stride: int, row_stride: int) -> str:
    """The form ``packed_mask``'s strides describe: "shared" for a mask every
    batch row shares, else "key" (a key row per batch element) or "full"."""
    if batch_stride == 0:
        return "shared"
    return "full" if row_stride else "key"


def _plain_mask(m: torch.Tensor | None, batch_stride: int, row_stride: int,
                seq: int) -> torch.Tensor | None:
    """``packed_mask``'s tensor as a [B or 1, 1, S or 1, S] view that
    broadcasts over the [B, H, S, S] logits."""
    if m is None:
        return None
    return m.reshape(-1 if batch_stride else 1, 1, seq if row_stride else 1, seq)


def rope_tables(rope, mask, seq: int, width: int):
    """The (sin, cos) [S, H·D] f32 tables of ``rope``, checked as the JAX
    kernel checks them; None without rope."""
    if rope is None:
        return None
    if mask is not None:
        raise ValueError("rope with a mask is not a supported packed-kernel combination")
    sin, cos = (t.to(torch.float32).contiguous() for t in rope)
    if tuple(sin.shape) != (seq, width) or tuple(cos.shape) != (seq, width):
        raise ValueError(f"rope tables must be [S, H·D] = {(seq, width)}, got "
                         f"{tuple(sin.shape)}/{tuple(cos.shape)}")
    return sin, cos


def _check(q, k, v, num_heads):
    if not fits_packed(q, k, v, num_heads):
        raise ValueError(
            f"packed attention takes q/k/v of one [B, S, H·D] shape and dtype "
            f"(f32/bf16, D ≤ {MAX_HEAD_DIM}); got {tuple(q.shape)}/"
            f"{tuple(k.shape)}/{tuple(v.shape)} {q.dtype}, {num_heads} heads")


def _code(x: torch.Tensor, sc: torch.Tensor, lo: float) -> torch.Tensor:
    """round(x / sc) (half to even), clipped to [lo, 127]: an int8 code kept
    in x's dtype."""
    return torch.clamp(torch.round(x / sc), lo, 127.0)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127, or 1 where amax is 0 (the JAX kernel's int8 scale). The
    divisor is a tensor: PyTorch's CUDA kernels turn a division by a Python
    number into a product with its reciprocal, one rounding off IEEE's
    quotient, which the JAX kernel and the CUDA kernel take."""
    return torch.where(amax == 0, 1.0, amax / torch.full_like(amax, 127.0))


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b of int8 codes held in floats, exact: in f32 while every sum
    stays below 2^24 (127² · depth), else in f64."""
    exact = 127 * 127 * a.shape[-1] < 2 ** 24
    dt = torch.float32 if exact else torch.float64
    return torch.matmul(a.to(dt), b.to(dt)).float()


def _scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q·(1/√D) rounded to q's dtype: the scale folded into q."""
    return (q.float() * (1.0 / q.shape[-1] ** 0.5)).to(q.dtype)


def _qk_codes(qs: torch.Tensor, k: torch.Tensor):
    """quant_qk's codes of [..., S, D] heads (in f32): the scaled q's per
    row, k's per head; with their scales ([..., S, 1] and [..., 1, 1])."""
    q32, k32 = qs.float(), k.float()
    qsc = _scale(q32.abs().amax(dim=-1, keepdim=True))
    ksc = _scale(k32.abs().amax(dim=(-2, -1), keepdim=True))
    return _code(q32, qsc, -127.0), qsc, _code(k32, ksc, -127.0), ksc


def _v_codes(v: torch.Tensor):
    """quant_pv's codes of v's [..., S, D] heads (in f32), per column over
    the S rows, with their scales [..., 1, D]."""
    v32 = v.float()
    vs = _scale(v32.abs().amax(dim=-2, keepdim=True))
    return _code(v32, vs, -127.0), vs


def _attend(q, k, v, mask, fast_softmax: bool, exp_bf16: bool, *, quant_qk: bool = False,
            quant_pv: bool = False, mxu_denom: bool = True) -> torch.Tensor:
    """Both kernels' function on [..., S, D] heads: scale folded into q and
    rounded, f32 logits and softmax, the rounded p in p·v (the packed
    kernel's int8 options as the module docstring gives them)."""
    d = q.shape[-1]
    qs = _scaled_q(q)
    int_max = False
    if quant_qk:
        qq, qsc, kq, ksc = _qk_codes(qs, k)
        acc = _int_product(qq, kq.transpose(-1, -2))
        rowsc = qsc * ksc
        int_max = mask is None and not fast_softmax
        logits = acc if int_max else acc * rowsc
    else:
        logits = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    if fast_softmax:
        arg = logits.clamp(-60.0, 60.0)
    elif int_max:  # the row max on the int32 products, then the dequant
        arg = (logits - logits.amax(dim=-1, keepdim=True)) * rowsc
    else:
        arg = logits - logits.amax(dim=-1, keepdim=True).clamp_min(-1e30)
    p = torch.exp(arg.to(torch.bfloat16)) if exp_bf16 else torch.exp(arg)
    if quant_pv:
        denom = p.float().sum(dim=-1, keepdim=True)
        ps = _scale(p.amax(dim=-1, keepdim=True))  # in p's dtype (bf16 under exp_bf16)
        vq, vs = _v_codes(v)
        out = _int_product(_code(p, ps, 0.0), vq) * (ps.float() * vs)
        return (out * (1.0 / denom)).to(q.dtype)
    pv = p.to(v.dtype)
    denom = (pv if mxu_denom and d % 128 else p).float().sum(dim=-1, keepdim=True)
    return (torch.matmul(pv.float(), v.float()) * (1.0 / denom)).to(q.dtype)


def flash_attention_packed_plain(q, k, v, *, num_heads: int, mask=None, rope=None,
                                 fast_softmax: bool = False, exp_bf16: bool = False,
                                 quant_qk: bool = False, quant_pv: bool = False,
                                 mxu_denom: bool = True, pair_exp: bool = False,
                                 group_mult: int = 1) -> torch.Tensor:
    """The packed kernel's function in plain PyTorch (its CPU path and the
    reference it is held to on the card). ``pair_exp`` and ``group_mult``
    change no value, and are ignored."""
    _check(q, k, v, num_heads)
    b, s, hd = q.shape
    d = hd // num_heads
    m, sb, sr = packed_mask(mask, b, s)
    tables = rope_tables(rope, mask, s, hd)
    if tables is not None:
        q, k = (apply_rope(t, *tables) for t in (q, k))

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2)

    out = _attend(heads(q), heads(k), heads(v), _plain_mask(m, sb, sr, s), fast_softmax,
                  exp_bf16, quant_qk=quant_qk, quant_pv=quant_pv, mxu_denom=mxu_denom)
    return out.transpose(1, 2).reshape(b, s, hd)


def _launch_int8(q, k, v, num_heads: int, mask, rope, out, *, fast_softmax: bool = False,
                 exp_bf16: bool = False, denom_rounded: int = 0, quant_qk: bool = True,
                 quant_pv: bool = True) -> tuple:
    """Launch ``csrc/flash_int8.cu`` on checked operands (``out`` None: its
    pre-pass alone). Returns its scratch: q and k codes [B·H, S64, D32] with
    q's row scales and k's |max| per (batch, head), v's codes transposed
    [B·H, D32, S64] with its column |max| (S64, D32: S and D rounded up to
    64 and 32; a max as f32 bits in an int32; None for an operand that is
    not quantized)."""
    b, s, hd = q.shape
    d = hd // num_heads
    bh, sp, dp = b * num_heads, -(-s // 64) * 64, -(-d // 32) * 32
    m, sb, sr = mask

    def buf(on, make, dtype, *shape):
        return make(shape, dtype=dtype, device=q.device) if on else None

    scratch = (buf(quant_qk, torch.empty, torch.int8, bh, sp, dp),
               buf(quant_qk, torch.empty, torch.float32, bh, sp),
               buf(quant_qk, torch.empty, torch.int8, bh, sp, dp),
               buf(quant_qk, torch.zeros, torch.int32, bh),
               buf(quant_pv, torch.empty, torch.int8, bh, dp, sp),
               buf(quant_pv, torch.zeros, torch.int32, bh, dp))
    sin, cos = rope if rope is not None else (None, None)
    # rope: the kernel's pre-pass writes the rotated q and k here
    qr, kr = (torch.empty_like(q), torch.empty_like(k)) if rope is not None else (None, None)
    fn = cuda.kernel("flash_int8", "flash_int8_launch",
                     (cuda.VOID_P,) * 4 + (cuda.LONG,) * 2 + (cuda.VOID_P,) * 11
                     + (cuda.INT,) * 4 + (cuda.FLOAT,) + (cuda.INT,) * 6 + (cuda.VOID_P,))
    cuda.launch(fn, "flash_attention_packed", q, cuda.ptr(q), cuda.ptr(k), cuda.ptr(v),
                cuda.ptr(m), sb, sr, cuda.ptr(sin), cuda.ptr(cos), cuda.ptr(qr), cuda.ptr(kr),
                *(cuda.ptr(t) for t in scratch), cuda.ptr(out), b, s, num_heads, d,
                float(1.0 / d ** 0.5), int(fast_softmax), int(exp_bf16), denom_rounded,
                int(quant_qk), int(quant_pv), cuda.DTYPE_CODES[q.dtype])
    return scratch


def _launch_int8_tma(q, k, v, num_heads: int, mask, rope, out, *, fast_softmax: bool = False,
                     exp_bf16: bool = False, denom_rounded: int = 0, quant_qk: bool = True,
                     quant_pv: bool = True, dump: bool = False) -> tuple:
    """Launch ``csrc/flash_int8_tma.cu`` on checked, aligned bf16 operands:
    its prep pass, then the attention into ``out``. Returns its scratch (S64,
    D32: S and D rounded up to 64 and 32; None for what is not made): k's
    codes [B·H, S64/64, D32/16, 64, 16], each 64-key tile as q·kᵀ reads it,
    with their scale per (batch, head); v's codes transposed, [B·H, S64/64,
    4, D32, 16] (each tile's keys in 16-key chunks, each 32 in ``frag_pos``
    order), with their column scales [B·H, D32]; with ``dump`` (quant_qk)
    q's codes [B·H, S64, D32] and row scales [B·H, S64] as the attention
    kernel made them."""
    b, s, hd = q.shape
    d = hd // num_heads
    bh, sp, dp = b * num_heads, -(-s // 64) * 64, -(-d // 32) * 32
    m, sb, sr = mask

    def buf(on, dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=q.device) if on else None

    scratch = (buf(quant_qk, torch.int8, bh, sp // 64, dp // 16, 64, 16),
               buf(quant_qk, torch.float32, bh),
               buf(quant_pv, torch.int8, bh, sp // 64, 4, dp, 16),
               buf(quant_pv, torch.float32, bh, dp),
               buf(dump, torch.int8, bh, sp, dp), buf(dump, torch.float32, bh, sp))
    sin, cos = rope if rope is not None else (None, None)
    # rope: the kernel's pre-pass writes the rotated q and k here
    qr, kr = (torch.empty_like(q), torch.empty_like(k)) if rope is not None else (None, None)
    fn = cuda.kernel("flash_int8_tma", "flash_int8_tma_launch",
                     (cuda.VOID_P,) * 4 + (cuda.LONG,) * 2 + (cuda.VOID_P,) * 11
                     + (cuda.INT,) * 4 + (cuda.FLOAT,) + (cuda.INT,) * 5 + (cuda.VOID_P,))
    cuda.launch(fn, "flash_attention_packed", q, cuda.ptr(q), cuda.ptr(k), cuda.ptr(v),
                cuda.ptr(m), sb, sr, cuda.ptr(sin), cuda.ptr(cos), cuda.ptr(qr), cuda.ptr(kr),
                *(cuda.ptr(t) for t in scratch), cuda.ptr(out), b, s, num_heads, d,
                float(1.0 / d ** 0.5), int(fast_softmax), int(exp_bf16), denom_rounded,
                int(quant_qk), int(quant_pv))
    return scratch


def _card_operands(what: str, q, k, v, num_heads: int, mask, rope):
    """The checks of a launch on the card: (the packed mask and its strides,
    the rope tables as the pre-pass reads them)."""
    cuda.no_grad_operands(what, q, k, v, mask, rope)
    _check(q, k, v, num_heads)
    b, s, hd = q.shape
    m, sb, sr = packed_mask(mask, b, s)
    tables = rope_tables(rope, mask, s, hd)
    if tables is not None and (hd // num_heads) % 2:
        raise ValueError(f"{what}: rope needs an even head dim, got {hd // num_heads}")
    if tables is not None:  # the pre-pass reads the tables in 8-byte pairs
        tables = tuple(t if t.data_ptr() % 8 == 0 else t.clone() for t in tables)
    for t in (q, k, v, m, *(tables or ())):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{what}: operands must be contiguous on {q.device}")
    return (m, sb, sr), tables


def quant_codes_plain(q, k, v, *, num_heads: int, rope=None) -> dict:
    """The int8 codes and scales of both quantized halves, as the plain
    version makes them, by (batch·head): q [B·H, S, D] with its row scales
    [B·H, S], k with one scale [B·H], v with its column scales [B·H, D]
    (codes as int8)."""
    _check(q, k, v, num_heads)
    b, s, hd = q.shape
    d = hd // num_heads
    tables = rope_tables(rope, None, s, hd)
    if tables is not None:
        q, k = (apply_rope(t, *tables) for t in (q, k))

    def heads(t):
        return t.reshape(b, s, num_heads, d).transpose(1, 2).reshape(b * num_heads, s, d)

    qq, qsc, kq, ksc = _qk_codes(_scaled_q(heads(q)), heads(k))
    vq, vs = _v_codes(heads(v))
    return {"q": qq.to(torch.int8), "q_scale": qsc[..., 0], "k": kq.to(torch.int8),
            "k_scale": ksc[:, 0, 0], "v": vq.to(torch.int8), "v_scale": vs[:, 0]}


def quant_codes(q, k, v, *, num_heads: int, rope=None) -> dict:
    """``quant_codes_plain``'s codes and scales as the int8 route of these
    operands (``kernel_route``) makes them on the card, cut to S and D, v's
    codes turned back to [B·H, S, D]: ``"int8_wgmma"``'s pre-pass scratch;
    ``"int8_tma"``'s prep pass (k, v) and attention kernel (q, written back
    from the same arithmetic by a launch with both halves quantized). For
    showing that both divide and round as the plain version does. CPU
    tensors run ``quant_codes_plain``."""
    if q.device.type == "cpu":
        return quant_codes_plain(q, k, v, num_heads=num_heads, rope=rope)
    mask, tables = _card_operands("quant_codes", q, k, v, num_heads, None, rope)
    _, s, hd = q.shape
    d = hd // num_heads
    if kernel_route(d, q.dtype, quant=True) == "int8_tma":
        q, k, v = _tma_operands("int8_tma", q, k, v)
        kc, ksc, vt, vsc, qc, qsc = _launch_int8_tma(q, k, v, num_heads, mask, tables,
                                                     torch.empty_like(q), dump=True)
        bh, sp, dp = qc.shape
        kc = kc.permute(0, 1, 3, 2, 4).reshape(bh, sp, dp)  # [B·H, S64, D32]
        vt = vt.permute(0, 3, 1, 2, 4).reshape(bh, dp, sp)  # [B·H, D32, S64], frag_pos order
        keys = frag_pos(torch.arange(s, device=q.device))
        return {"q": qc[:, :s, :d], "q_scale": qsc[:, :s], "k": kc[:, :s, :d], "k_scale": ksc,
                "v": vt[:, :d].index_select(2, keys).transpose(1, 2), "v_scale": vsc[:, :d]}
    qc, qsc, kc, kmax, vt, vmax = _launch_int8(q, k, v, num_heads, mask, tables, None)
    return {"q": qc[:, :s, :d], "q_scale": qsc[:, :s], "k": kc[:, :s, :d],
            "k_scale": _scale(kmax.view(torch.float32)), "v": vt[:, :d, :s].transpose(1, 2),
            "v_scale": _scale(vmax[:, :d].view(torch.float32))}


def flash_attention_packed(q, k, v, *, num_heads: int, mask=None, rope=None,
                           fast_softmax: bool = False, exp_bf16: bool = False,
                           quant_qk: bool = False, quant_pv: bool = False,
                           mxu_denom: bool = True, pair_exp: bool = False,
                           group_mult: int = 1) -> torch.Tensor:
    """Fused attention on the [B, S, H·D] projection layout. CUDA tensors
    launch the kernel (raising on anything it does not take): the int8 one
    for ``quant_qk`` / ``quant_pv``, else flash.cuh's (``pair_exp`` and
    ``group_mult`` change no value and are ignored); CPU tensors run
    ``flash_attention_packed_plain``."""
    opts = {"fast_softmax": fast_softmax, "exp_bf16": exp_bf16, "quant_qk": quant_qk,
            "quant_pv": quant_pv, "mxu_denom": mxu_denom, "pair_exp": pair_exp,
            "group_mult": group_mult}
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, num_heads=num_heads, mask=mask, rope=rope,
                                            **opts)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_packed: unsupported device {q.device}")
    mask, tables = _card_operands("flash_attention_packed", q, k, v, num_heads, mask, rope)
    b, s, hd = q.shape
    d = hd // num_heads
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    denom_rounded = int(mxu_denom and not quant_pv and d % 128 != 0)
    if quant_qk or quant_pv:
        route = kernel_route(d, q.dtype, quant=True)
        launch = _launch_int8
        if route == "int8_tma":
            q, k, v = _tma_operands(route, q, k, v)
            launch = _launch_int8_tma
        launch(q, k, v, num_heads, mask, tables, out, fast_softmax=fast_softmax,
               exp_bf16=exp_bf16, denom_rounded=denom_rounded, quant_qk=quant_qk,
               quant_pv=quant_pv)
        form = "both" if quant_qk and quant_pv else "qk" if quant_qk else "pv"
        cuda.count(flash_attention_packed, "quant_launches", form)
        cuda.count(flash_attention_packed, "route_launches", f"{route} {form}")
    else:
        q, k, v = _tma_operands(kernel_route(d, q.dtype, mxu_denom=mxu_denom), q, k, v)
        m, sb, sr = mask
        sin, cos = tables if tables is not None else (None, None)
        # rope: the kernel's pre-pass writes the rotated q and k here
        qr, kr = (torch.empty_like(q), torch.empty_like(k)) if tables is not None else (None, None)
        fn = cuda.kernel("flash_packed", "flash_packed_launch",
                         (cuda.VOID_P,) * 4 + (cuda.LONG,) * 2 + (cuda.VOID_P,) * 5
                         + (cuda.INT,) * 4 + (cuda.FLOAT,) + (cuda.INT,) * 4 + (cuda.VOID_P,))
        cuda.launch(fn, "flash_attention_packed", q, cuda.ptr(q), cuda.ptr(k), cuda.ptr(v),
                    cuda.ptr(m), sb, sr, cuda.ptr(sin), cuda.ptr(cos), cuda.ptr(qr),
                    cuda.ptr(kr), cuda.ptr(out), b, s, num_heads, d, float(1.0 / d ** 0.5),
                    int(fast_softmax), int(exp_bf16), denom_rounded,
                    cuda.DTYPE_CODES[q.dtype])
    cuda.count(flash_attention_packed)
    if mask[0] is not None:
        cuda.count(flash_attention_packed, "mask_launches", mask_form(*mask[1:]))
    return out


# kernel launches, for showing a run went through it; the launches with a
# mask also by its form, the quantized ones by what they quantize, and by
# the int8 route that ran them too ("int8_tma qk", ...)
flash_attention_packed.launches = 0
flash_attention_packed.mask_launches = {"shared": 0, "key": 0, "full": 0}
flash_attention_packed.quant_launches = {"qk": 0, "pv": 0, "both": 0}
flash_attention_packed.route_launches = {
    f"{route} {form}": 0 for route in ("int8_tma", "int8_wgmma") for form in ("qk", "pv", "both")}


# -- kernel 3: the [B, H, S, D] layout ---------------------------------------

def takes_bhsd(q, k, v, mask) -> bool:
    """``flash_attention`` runs its kernel for self-attention with no mask or
    one mask shared by every batch row and head; cross-attention (Sq ≠ Sk,
    or v unlike k) and per-batch masks go to ``attention_core``."""
    if k.shape[2] != q.shape[2] or v.shape != k.shape:
        return False
    return mask is None or mask.dim() != 4 or (mask.shape[0] == 1 and mask.shape[1] == 1)


def _bhsd_mask(mask, seq: int) -> torch.Tensor | None:
    if mask is None:
        return None
    return torch.broadcast_to(mask.to(torch.float32), (1, 1, seq, seq))[0, 0].contiguous()


def flash_attention_plain(q, k, v, *, mask=None, fast_softmax: bool = False) -> torch.Tensor:
    """Kernel 3's function in plain PyTorch, for the calls its kernel takes
    (``takes_bhsd``)."""
    return _attend(q, k, v, _bhsd_mask(mask, q.shape[2]), fast_softmax, False)


def flash_attention(q, k, v, *, mask=None, fast_softmax: bool = False) -> torch.Tensor:
    """Fused attention on [B, H, S, D] tensors. Calls the kernel does not
    take go to ``attention_core``; otherwise CUDA tensors launch the kernel
    (raising on anything it does not take) and CPU tensors run
    ``flash_attention_plain``."""
    if not takes_bhsd(q, k, v, mask):
        from .attention import attention_core

        return attention_core(q, k, v, mask=mask)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask=mask, fast_softmax=fast_softmax)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    cuda.no_grad_operands("flash_attention", q, k, v, mask)
    b, h, s, d = q.shape
    if (not (q.shape == k.shape == v.shape) or not (q.dtype == k.dtype == v.dtype)
            or q.dtype not in cuda.DTYPE_CODES or d > MAX_HEAD_DIM):
        raise ValueError(
            f"flash_attention takes q/k/v of one [B, H, S, D] shape and dtype (f32/bf16, "
            f"D ≤ {MAX_HEAD_DIM}); got {tuple(q.shape)}/{tuple(k.shape)}/{tuple(v.shape)} "
            f"{q.dtype}")
    m2 = _bhsd_mask(mask, s)
    for t in (k, v, m2):
        if t is not None and t.device != q.device:
            raise ValueError(f"flash_attention: operands must be on {q.device}")
    # the heads split off the [B, S, H·D] projections arrive as strided views
    q, k, v = _tma_operands(kernel_route(d, q.dtype),
                            *(t.contiguous() for t in (q, k, v)))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = cuda.kernel("flash_bhsd", "flash_bhsd_launch", (cuda.VOID_P,) * 5 + (cuda.INT,) * 4
                     + (cuda.FLOAT,) + (cuda.INT,) * 3 + (cuda.VOID_P,))
    cuda.launch(fn, "flash_attention", q,
                cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(m2), cuda.ptr(out), b, h, s, d,
                float(1.0 / d ** 0.5), int(fast_softmax), int(d % 128 != 0),
                cuda.DTYPE_CODES[q.dtype])
    cuda.count(flash_attention)
    return out


flash_attention.launches = 0  # kernel launches, for showing a run went through it

#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (``clip_embedder_tpu_torch``) on one NVIDIA
card, in phases, and fail loudly if any phase fails.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --int8   # phases 1-2 for the int8 sources, phase 3's int8 kernels
    python3 chip_smoke.py --masks  # phases 1-2 for flash_packed, its time by mask form

1. environment — the card's name and power limit, torch/CUDA versions, the
   compute capability (must be 9.0);
2. build — every ``csrc/*.cu`` kernel compiled with nvcc for sm_90a; for
   the four int8 sources, ptxas's wgmma-serialization warnings and the int8
   wgmma (IGMMA) and mma.sync (IMMA) instructions in their SASS (a warning,
   no IGMMA or any IMMA fails);
3. kernels — each kernel against its plain PyTorch version at the main
   paths' shapes (max error beside the tolerance), and its time (CUDA
   events, median of 20) beside the plain version's, one PyTorch library
   call's or, for the int8 kernels, a composition of PyTorch ops around
   ``torch._int_mm`` (a yardstick the port never calls) and the bound, and
   for the int8 kernels their device time by launch (row passes against
   products): the packed attention kernel also with PE-Core's rope, the
   [B, H, S, D] attention kernel at the fixtures' and at SO400M's head
   layout, ``ln_qkv_int8`` and ``int8_linear_fused`` also at PE-Core-bigG's
   vision width, the streamed int8 MLP at PE-Core-bigG's;
4. fixtures — ``tests/fixtures/golden_siglip`` and ``golden_model`` through
   ``Clip.from_local_dir(..., device="cuda")`` in f32 against their golden
   embeddings and classify results (4 heads x 16: no 128-lane head group, so
   their attention takes ``flash_attention``, kernel 3); ``golden_siglip``
   under ``quantize="int8"`` and ``"int8_all"`` against the same on the CPU;
5. main path — ViT-SO400M-16-SigLIP2-384 (vision + SigLIP text tower) at
   full width and depth with seeded random bf16 weights through ``Clip``:
   ``embed_images`` on a mixed-size batch of the JPEGs under ``assets/img``
   and ``classify``; unit norms, launch counts (27 per tower forward per
   kernel), kernel-vs-plain cosine, images/s at batch 32 and the p50 latency
   of one image;
6. int8 paths — the same ``Clip`` with phase 5's weights quantized on the
   card, under ``quantize="int8"`` and ``"int8_all"``: unit norms, the int8
   kernels' launch counts, the kernel path against the same ``Clip`` with
   the int8 wrappers swapped for their plain versions, the cosine to the
   bf16 path (printed only: random weights), images/s and p50;
7. PE-Core-bigG-14-448 — vision 50 x 1536 with 2-D rope over 1025 tokens,
   the 24 x 1280 causal text tower, seeded random bf16 weights, through
   ``Clip`` in bf16, ``"int8"`` and ``"int8_all"`` (its vision MLPs take the
   streamed int8 MLP, kernel 7): unit norms, launch counts, kernel path
   against plain path, images/s and p50, and device time by kernel group
   in each mode;
8. masked towers — BiomedCLIP-PubMedBERT_256-vit_base_patch16_224 (BERT-base
   text: kernel 2's per-batch key mask) in bf16 and ``"int8_all"``, and
   coca_ViT-L-14 (attentional pool; text with the causal + cls mask: kernel
   2's per-batch full form) in bf16, at full width and depth with seeded
   random weights, through ``Clip``: ``embed_images``, ``embed_texts`` on
   captions of distinct lengths and ``classify``, launch counts per call
   (the masked launches by form), both towers against the plain path,
   images/s, texts/s and device time by kernel group. Phase 3 holds and
   times kernel 2 with those masks at their shapes;
9. the deployment path — ViT-SO400M-16-SigLIP2-384 at full width and depth
   as open_clip names it (``tests/torch_ref.py``'s timm trunk and SigLIP
   text tower, seeded random f32 weights) saved with ``torch.save``, read
   and converted by the port's ``pull_weights`` into a model dir, loaded
   with ``Clip.from_local_dir(dtype=bfloat16)`` and held against its source
   model in f32 on the card, then ``warmup`` and ``ClipServer``: one client
   sends every endpoint (rows held against the direct call, launch counts
   exact), then 64 concurrent clients one JPEG each, threads of a process
   of their own (all served, in far
   fewer micro-batches, images/s and p50/p95; in turns with the JAX
   server's design, the JPEGs decoded in the micro-batcher's thread), and
   one micro-batch under torch.profiler.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repo beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FIXTURES = REPO / "tests" / "fixtures"
IMAGES = REPO / "assets" / "img"

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, f32
# (non-tensor) FLOP/s, device-memory bytes/s. Rates assume the full power
# limit (700 W SXM, 350 W PCIe).
PEAKS = {
    "sxm": {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "bytes": 3.35e12},
    "pcie": {"bf16": 756e12, "int8": 1513e12, "f32": 51e12, "bytes": 2.0e12},
}
QUANT_MODES = ("int8", "int8_all")

# open_clip model_configs/ViT-SO400M-16-SigLIP2-384.json, written out here.
SO400M_SIGLIP2_384 = {
    "embed_dim": 1152,
    "init_logit_bias": -10,
    "custom_text": True,
    "vision_cfg": {
        "image_size": 384,
        "timm_model_name": "vit_so400m_patch16_siglip_384",
        "timm_model_pretrained": False,
        "timm_pool": "map",
        "timm_proj": "none",
    },
    "text_cfg": {
        "context_length": 64,
        "vocab_size": 256000,
        "hf_tokenizer_name": "timm/ViT-SO400M-16-SigLIP2-384",
        "tokenizer_kwargs": {"clean": "canonicalize"},
        "width": 1152,
        "heads": 16,
        "layers": 27,
        "mlp_ratio": 3.7362,
        "no_causal_mask": True,
        "proj_bias": True,
        "pool_type": "last",
        "norm_kwargs": {"eps": 1e-6},
        "act_kwargs": {"approximate": "tanh"},
    },
}
SIGLIP_PREPROCESS = {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5],
                     "interpolation": "bicubic", "resize_mode": "squash"}
# timm/PE-Core-bigG-14-448 as the repo records it (tests/test_reference_model_list.py,
# benches/bench_suite.py "pe_core_bigg_448"): vision 50 x 1536, 16 x 96 heads, patch
# 14 at 448, MLP 8960, 2-D rope, map pool; text 24 x 1280, 20 heads, context 72.
PE_CORE_BIGG_448 = {
    "embed_dim": 1280,
    "vision_cfg": {"image_size": 448, "timm_model_name": "vit_pe_core_bigG_patch14_448",
                   "timm_proj": "linear"},
    "text_cfg": {"context_length": 72, "vocab_size": 49408, "width": 1280, "heads": 20,
                 "layers": 24},
}
# PE-Core's own preprocess is not recorded in the repo; the phase takes the
# SigLIP one (mean and std 0.5), which only sets the pixel values.
PE_PREPROCESS = SIGLIP_PREPROCESS
LABELS = ["a photo of a city at night", "a desert", "a forest", "the ocean",
          "a red balloon"]


def say(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks_for(name: str) -> dict:
    return PEAKS["pcie" if "pcie" in name.lower() else "sxm"]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median over ``iters`` back-to-back calls of the time between the CUDA
    events recorded around each call. No synchronize separates the calls, so
    while the device is the slower side a call's time is the device's, not
    the host's Python and launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
    events[0].record()
    for i in range(iters):
        fn()
        events[i + 1].record()
    events[-1].synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(iters))


def max_err(got, ref) -> float:
    return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))


def hold(name, got, ref, atol, rtol) -> float:
    """Fail unless |got - ref| <= atol + rtol·|ref| everywhere."""
    err = max_err(got, ref)
    ok = all(bool(((g.float() - r.float()).abs()
                   <= atol + rtol * r.float().abs()).all()) for g, r in zip(got, ref))
    say(f"  {name}: max_abs_err={err:.3e} (tol atol={atol:g} rtol={rtol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels
# ---------------------------------------------------------------------------

def qkv_inputs(rows, width, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    params = {n: {"w": t(width, width, scale=width ** -0.5), "b": t(width, scale=0.1)}
              for n in "qkv"}
    pre_ln = {"scale": 1 + t(width, scale=0.1), "bias": t(width, scale=0.1)}
    return params, pre_ln, t(rows, width)


def attn_inputs(b, h, s, d, dtype, dev, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, h * d), generator=g, device=dev).to(dtype) for _ in range(3)]


def ln_qkv_library(params, pre_ln, x, eps):
    import torch.nn.functional as F

    y = F.layer_norm(x, (x.shape[-1],), pre_ln["scale"], pre_ln["bias"], eps)
    return tuple(torch.addmm(params[n]["b"], y, params[n]["w"]) for n in "qkv")


def phase_kernels(dev, peaks) -> dict:
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops import flash, qkv
    from clip_embedder_tpu_torch.ops.attention import causal_mask

    width, seq, heads, hdim = 1152, 576, 16, 72
    say("[3] kernels against their plain versions")
    for dtype, atol, rtol in ((torch.bfloat16, 1e-2, 2 ** -7), (torch.float32, 1e-4, 1e-4)):
        params, pre_ln, x = qkv_inputs(8 * seq, width, dtype, dev)
        got = qkv.ln_qkv(params, pre_ln, x, eps=1e-6)
        torch.cuda.synchronize()
        hold(f"ln_qkv rows=8x576 W=1152 {dtype}", got,
             qkv.ln_qkv_plain(params, pre_ln, x, eps=1e-6), atol, rtol)
    cases = [("exact", torch.bfloat16, {}, 2e-2),
             ("fast_softmax", torch.bfloat16, {"fast_softmax": True}, 2e-2),
             ("fast_softmax+exp_bf16", torch.bfloat16,
              {"fast_softmax": True, "exp_bf16": True}, 2e-2),
             ("exact", torch.float32, {}, 2e-5)]
    for label, dtype, kw, tol in cases:
        q, k, v = attn_inputs(8, heads, seq, hdim, dtype, dev)
        got = flash.flash_attention_packed(q, k, v, num_heads=heads, **kw)
        torch.cuda.synchronize()
        hold(f"flash_attention_packed B=8 H=16 S=576 D=72 {label} {dtype}", [got],
             [flash.flash_attention_packed_plain(q, k, v, num_heads=heads, **kw)], tol, tol)
    q, k, v = attn_inputs(8, heads, 64, hdim, torch.bfloat16, dev)
    mask = causal_mask(64, device=dev)
    got = flash.flash_attention_packed(q, k, v, num_heads=heads, mask=mask)
    torch.cuda.synchronize()
    hold("flash_attention_packed B=8 H=16 S=64 D=72 causal mask bf16", [got],
         [flash.flash_attention_packed_plain(q, k, v, num_heads=heads, mask=mask)],
         2e-2, 2e-2)
    # the text towers' own shapes: SigLIP (16 x 72 over 64 tokens, no mask),
    # PE-Core (20 x 64 over 72, causal); and the ragged 577
    for b, h, s, d, causal in ((5, 16, 64, 72, False), (5, 20, 72, 64, True),
                               (8, 16, 577, 72, False)):
        q, k, v = attn_inputs(b, h, s, d, torch.bfloat16, dev)
        mask = causal_mask(s, device=dev) if causal else None
        got = flash.flash_attention_packed(q, k, v, num_heads=h, mask=mask)
        torch.cuda.synchronize()
        hold(f"flash_attention_packed B={b} H={h} S={s} D={d} causal={causal} bf16", [got],
             [flash.flash_attention_packed_plain(q, k, v, num_heads=h, mask=mask)], 2e-2, 2e-2)
    # ln_qkv at PE-Core's widths: vision 1536 over 1025 tokens, text 1280 over 72
    for rows, w in ((8 * 1025, 1536), (5 * 72, 1280)):
        params, pre_ln, x = qkv_inputs(rows, w, torch.bfloat16, dev)
        got = qkv.ln_qkv(params, pre_ln, x, eps=1e-6)
        torch.cuda.synchronize()
        hold(f"ln_qkv rows={rows} W={w} bf16", got,
             qkv.ln_qkv_plain(params, pre_ln, x, eps=1e-6), 1e-2, 2 ** -7)

    # timing at the main path's batch-32 shapes, bf16
    say("[3] kernel times at batch 32, bf16 (CUDA events, median of 20 back-to-back calls)")
    b, es = 32, 2
    rows = b * seq
    params, pre_ln, x = qkv_inputs(rows, width, torch.bfloat16, dev)
    err_qkv = hold("ln_qkv rows=32x576 W=1152 bf16", qkv.ln_qkv(params, pre_ln, x),
                   qkv.ln_qkv_plain(params, pre_ln, x), 1e-2, 2 ** -7)
    t_qkv = cuda_ms(lambda: qkv.ln_qkv(params, pre_ln, x))
    t_qkv_plain = cuda_ms(lambda: qkv.ln_qkv_plain(params, pre_ln, x))
    t_qkv_lib = cuda_ms(lambda: ln_qkv_library(params, pre_ln, x, 1e-6))
    qkv_bytes = (4 * rows * width + 3 * width * width) * es + 5 * width * 4
    qkv_ops = 6 * rows * width * width
    b_qkv = max(qkv_bytes / peaks["bytes"], qkv_ops / peaks["bf16"]) * 1e3

    q, k, v = attn_inputs(b, heads, seq, hdim, torch.bfloat16, dev)
    err_fl = hold("flash_attention_packed B=32 exact bf16",
                  [flash.flash_attention_packed(q, k, v, num_heads=heads)],
                  [flash.flash_attention_packed_plain(q, k, v, num_heads=heads)], 2e-2, 2e-2)
    t_fl = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads))
    t_fl_fast = cuda_ms(lambda: flash.flash_attention_packed(
        q, k, v, num_heads=heads, fast_softmax=True, exp_bf16=True))
    t_fl_plain = cuda_ms(lambda: flash.flash_attention_packed_plain(q, k, v, num_heads=heads))
    qh, kh, vh = (t.view(b, seq, heads, hdim).transpose(1, 2) for t in (q, k, v))
    t_fl_lib = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    b_fl, by_fl, fl_ops, fl_bytes = attn_bound(b, heads, seq, hdim, peaks)
    fl_exps = b * heads * seq * seq
    say(f"  ln_qkv: {t_qkv:.4f} ms; plain {t_qkv_plain:.4f} ms; F.layer_norm+3 addmm "
        f"{t_qkv_lib:.4f} ms; bound {b_qkv:.4f} ms ({qkv_ops:.3e} FLOP, {qkv_bytes:.3e} B)")
    say(f"  flash_attention_packed: exact {t_fl:.4f} ms, fast+exp_bf16 {t_fl_fast:.4f} ms; "
        f"plain {t_fl_plain:.4f} ms; F.scaled_dot_product_attention {t_fl_lib:.4f} ms; "
        f"bound {b_fl:.4f} ms ({fl_ops:.3e} FLOP, {fl_bytes:.3e} B; {fl_exps:.3e} exp on the "
        f"special-function units, {exp_ms(fl_exps):.4f} ms at 16 a clock per SM)")
    return {
        "ln_qkv": {"name": "ln_qkv", "route": "cuda",
                   "source": "clip_embedder_tpu_torch/csrc/ln_qkv.cu",
                   "replaces": "clip_embedder_tpu/ops/qkv.py:216", "max_abs_err": err_qkv,
                   "ms": t_qkv, "plain_ms": t_qkv_plain, "bound_ms": b_qkv,
                   "bound_by": "operations" if qkv_ops / peaks["bf16"]
                   > qkv_bytes / peaks["bytes"] else "bytes",
                   "library_ms": t_qkv_lib},
        "flash_attention_packed": {
            "name": "flash_attention_packed", "route": "cuda",
            "source": "clip_embedder_tpu_torch/csrc/flash_packed.cu",
            "replaces": "clip_embedder_tpu/ops/flash.py:308", "max_abs_err": err_fl,
            "ms": t_fl, "plain_ms": t_fl_plain, "bound_ms": b_fl, "bound_by": by_fl,
            "library_ms": t_fl_lib},
    }


def key_mask(b, s, dev):
    """BERT's [B, 1, 1, S] key mask: a different key length in every batch
    row (row 2 none at all: every key masked, as bucket padding makes),
    -1e30 on the masked keys."""
    lengths = torch.tensor([s if i == 0 else 0 if i == 2 else 1 + (i * 37) % s
                            for i in range(b)])
    valid = torch.arange(s)[None, :] < lengths[:, None]
    return torch.where(valid, 0.0, -1e30)[:, None, None, :].to(dev)


def full_mask(b, s, dev):
    """CoCa text's [B, 1, S, S] mask: causal plus open_clip's cls mask of
    S - 1 ids whose pad counts differ in every batch row (only the cls row,
    query S - 1, differs between rows)."""
    from clip_embedder_tpu_torch.models.text_transformer import cls_mask
    from clip_embedder_tpu_torch.ops.attention import causal_mask

    ids = torch.full((b, s - 1), 7)
    for i in range(b):
        n = (i * 5) % (s - 1)
        if n:
            ids[i, -n:] = 0
    return (causal_mask(s) + cls_mask(ids, 0)).to(dev)


def phase_mask_kernels(dev, peaks) -> dict:
    """Kernel 2's per-batch masks at the shapes phase 8 gives them: BERT-base's
    key mask (q/k/v [32, 256, 768], 12 heads) and CoCa text's full mask
    ([32, 77, 768], 12 heads), exact and fast + bf16 exp against the plain
    version (the all-masked batch row and the cls query each held on their
    own as well), then timed beside the plain version, SDPA with the same
    float mask, and the bound (q, k, v, out and the mask moved once)."""
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops import flash

    say("[3] flash_attention_packed with per-batch masks (BERT-base key rows, CoCa text's "
        "causal + cls blocks)")
    b, heads, hdim = 32, 12, 64
    out = {}
    for form, s, make in (("key", 256, key_mask), ("full", 77, full_mask)):
        mask = make(b, s, dev)
        q, k, v = attn_inputs(b, heads, s, hdim, torch.bfloat16, dev, seed=9)
        own_row = (slice(2, 3), slice(None)) if form == "key" else (slice(None), slice(-1, None))
        for label, kw in (("exact", {}), ("fast_softmax+exp_bf16",
                                          {"fast_softmax": True, "exp_bf16": True})):
            got = flash.flash_attention_packed(q, k, v, num_heads=heads, mask=mask, **kw)
            torch.cuda.synchronize()
            ref = flash.flash_attention_packed_plain(q, k, v, num_heads=heads, mask=mask, **kw)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{form} mask {label}: non-finite output")
            err = hold(f"flash_attention_packed {form} mask B=32 H=12 S={s} D=64 {label} bf16",
                       [got], [ref], 2e-2, 2e-2)
            hold(f"  the {'all-masked batch row' if form == 'key' else 'cls query (row 76)'} "
                 "on its own", [got[own_row]], [ref[own_row]], 2e-2, 2e-2)
            if label == "exact":
                err_exact = err
        t_k = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads, mask=mask))
        t_fast = cuda_ms(lambda: flash.flash_attention_packed(
            q, k, v, num_heads=heads, mask=mask, fast_softmax=True, exp_bf16=True))
        t_none = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads))
        t_p = cuda_ms(lambda: flash.flash_attention_packed_plain(q, k, v, num_heads=heads,
                                                                 mask=mask))
        qh, kh, vh = (t.view(b, s, heads, hdim).transpose(1, 2) for t in (q, k, v))
        lib_mask = mask.to(q.dtype)
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=lib_mask))
        bound, by, ops, nbytes = attn_bound(b, heads, s, hdim, peaks,
                                            extra_bytes=mask.numel() * 4)
        say(f"  flash_attention_packed {form} mask [32, {s}, 768] 12x64: exact {t_k:.4f} ms, "
            f"fast+exp_bf16 {t_fast:.4f} ms (the same q, k, v without a mask: exact "
            f"{t_none:.4f} ms); plain {t_p:.4f} ms; F.scaled_dot_product_attention "
            f"with the same float mask {t_l:.4f} ms; bound {bound:.4f} ms ({ops:.3e} FLOP, "
            f"{nbytes:.3e} B, {by})")
        out[f"flash_attention_packed[{form}_mask]"] = {
            "name": f"flash_attention_packed[{form}_mask]", "route": "cuda",
            "source": "clip_embedder_tpu_torch/csrc/flash_packed.cu",
            "replaces": "clip_embedder_tpu/ops/flash.py:308", "max_abs_err": err_exact,
            "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by, "library_ms": t_l}
    return out


def mask_path_table(dev) -> None:
    """The packed kernel's time (bf16, 12 x 64 heads, batch 32, CUDA events,
    median of 20) by mask, exact and fast + bf16 exp: none, a shared [S, S]
    zero mask, zero key rows, BERT's key rows (``key_mask``) and, at S = 77,
    CoCa's blocks (``full_mask``), at S = 256, 77 and 576 (``--masks``: what
    the masked path costs beside the plain one)."""
    from clip_embedder_tpu_torch.ops import flash

    say("[3] flash_attention_packed by mask form, B=32 H=12 D=64 bf16 (ms, CUDA events, "
        "median of 20; /fast: fast_softmax + exp_bf16)")
    b, h, d = 32, 12, 64
    for s in (256, 77, 576):
        q, k, v = attn_inputs(b, h, s, d, torch.bfloat16, dev, seed=9)
        masks = {"none": None, "shared0": torch.zeros(s, s, device=dev),
                 "key0": torch.zeros(b, 1, 1, s, device=dev), "key": key_mask(b, s, dev)}
        if s == 77:
            masks["full"] = full_mask(b, s, dev)
        row = {}
        for name, m in masks.items():
            for fast in (False, True):
                row[f"{name}{'/fast' if fast else ''}"] = cuda_ms(
                    lambda: flash.flash_attention_packed(q, k, v, num_heads=h, mask=m,
                                                         fast_softmax=fast, exp_bf16=fast))
        say(f"  S={s}: " + "; ".join(f"{name} {t:.4f}" for name, t in row.items()))


def rope_library(q, k, v, heads, sin, cos):
    """PE-Core attention as PyTorch calls: the rope rotation in torch ops,
    then F.scaled_dot_product_attention."""
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops.rope import apply_rope

    b, s, hd = q.shape
    q, k = (apply_rope(t, sin, cos) for t in (q, k))
    qh, kh, vh = (t.view(b, s, heads, hd // heads).transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(qh, kh, vh)


def exp_ms(n: int) -> float:
    """Time of ``n`` exp at the H100's special-function rate: 16 a clock on
    each of 132 SMs at the 1.755 GHz boost clock (printed beside the bound,
    not part of it)."""
    return n / (16 * 132 * 1.755e9) * 1e3


def attn_bound(b, h, s, d, peaks, extra_bytes=0, dtype=torch.bfloat16):
    """(bound ms, bound_by, FLOP, bytes): q, k, v read once and out written
    once in ``dtype`` (plus ``extra_bytes``), against 4·S²·D FLOP per head
    at the bf16 tensor-core rate, or for f32 the FMA rate (the f32 kernels
    run on FMA)."""
    nbytes = 4 * b * s * h * d * dtype.itemsize + extra_bytes
    ops = 4 * b * h * s * s * d
    rate = peaks["f32" if dtype == torch.float32 else "bf16"]
    t_ops, t_bytes = ops / rate, nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes", ops, nbytes


def phase_pe_attention_kernels(dev, peaks) -> dict:
    """Kernel 2 with PE-Core-bigG's rope (1025 tokens, 16 x 96 heads) and
    kernel 3 at the golden fixtures' four f32 layouts (its main path; the
    kernels' record takes golden_model's causal text tower) and, as a
    yardstick no path sends to it, at SO400M's head layout in bf16."""
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops import flash
    from clip_embedder_tpu_torch.ops.attention import causal_mask
    from clip_embedder_tpu_torch.ops.rope import axial_rope_table, head_tiled_tables

    say("[3] flash_attention_packed with rope and flash_attention against their plain versions")
    heads, hdim, grid = 16, 96, 32
    seq = grid * grid + 1
    sin, cos = (t.to(dev) for t in head_tiled_tables(
        axial_rope_table(grid, hdim, order="xy", prefix=1), heads))
    rope = (sin, cos)
    for b, dtype, tol in ((2, torch.float32, 2e-5), (8, torch.bfloat16, 2e-2)):
        for fast in (False, True):
            q, k, v = attn_inputs(b, heads, seq, hdim, dtype, dev, seed=4)
            got = flash.flash_attention_packed(q, k, v, num_heads=heads, rope=rope,
                                               fast_softmax=fast)
            torch.cuda.synchronize()
            hold(f"flash_attention_packed+rope B={b} S=1025 16x96 fast={fast} {dtype}", [got],
                 [flash.flash_attention_packed_plain(q, k, v, num_heads=heads, rope=rope,
                                                     fast_softmax=fast)], tol, tol)
    g = torch.Generator(device=dev).manual_seed(5)

    def bhsd(b, h, s, d, dtype):
        return [torch.randn((b, h, s, d), generator=g, device=dev).to(dtype) for _ in range(3)]

    # the fixtures' layouts, f32: golden_siglip's vision (16 tokens) and text
    # (12, no mask), golden_model's vision (16 patches + cls) and causal text;
    # each text tower takes the two texts (and classify's two labels) at once
    causal = causal_mask(12, device=dev)
    fixture_shapes = (("golden_siglip vision", (1, 4, 16, 16), None),
                      ("golden_siglip text", (2, 4, 12, 16), None),
                      ("golden_model vision", (1, 4, 17, 16), None),
                      ("golden_model text", (2, 4, 12, 16), causal))
    for _, (b, h, s, d), mask in fixture_shapes:
        for fast in (False, True):
            q, k, v = bhsd(b, h, s, d, torch.float32)
            got = flash.flash_attention(q, k, v, mask=mask, fast_softmax=fast)
            torch.cuda.synchronize()
            hold(f"flash_attention B={b} H={h} S={s} D={d} mask={mask is not None} "
                 f"fast={fast} f32", [got],
                 [flash.flash_attention_plain(q, k, v, mask=mask, fast_softmax=fast)],
                 2e-5, 2e-5)

    say("[3] flash_attention times at the fixtures' shapes, f32 (CUDA events, median of 20 "
        "back-to-back calls)")
    fixture_rows = {}
    for label, (b, h, s, d), mask in fixture_shapes:
        q, k, v = bhsd(b, h, s, d, torch.float32)
        err = hold(f"flash_attention {label} {[b, h, s, d]} f32", [flash.flash_attention(
            q, k, v, mask=mask)], [flash.flash_attention_plain(q, k, v, mask=mask)], 2e-5, 2e-5)
        t_k = cuda_ms(lambda: flash.flash_attention(q, k, v, mask=mask))
        t_p = cuda_ms(lambda: flash.flash_attention_plain(q, k, v, mask=mask))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
        bound, by, ops, nbytes = attn_bound(b, h, s, d, peaks, dtype=torch.float32,
                                            extra_bytes=0 if mask is None else s * s * 4)
        say(f"  flash_attention {label} {[b, h, s, d]} mask={mask is not None}: {t_k:.4f} ms; "
            f"plain {t_p:.4f} ms; F.scaled_dot_product_attention {t_l:.4f} ms; bound "
            f"{bound:.3e} ms ({ops:.3e} FLOP, {nbytes:.3e} B, {by})")
        fixture_rows[label] = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                               "bound_ms": bound, "bound_by": by, "library_ms": t_l}

    say("[3] attention kernel times at batch 32, bf16 (CUDA events, median of 20 back-to-back "
        "calls)")
    b = 32
    q, k, v = attn_inputs(b, heads, seq, hdim, torch.bfloat16, dev, seed=6)
    err_rope = hold("flash_attention_packed+rope B=32 S=1025 16x96 exact bf16",
                    [flash.flash_attention_packed(q, k, v, num_heads=heads, rope=rope)],
                    [flash.flash_attention_packed_plain(q, k, v, num_heads=heads, rope=rope)],
                    2e-2, 2e-2)
    t_rope = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads, rope=rope))
    t_rope_plain = cuda_ms(lambda: flash.flash_attention_packed_plain(
        q, k, v, num_heads=heads, rope=rope))
    t_rope_lib = cuda_ms(lambda: rope_library(q, k, v, heads, sin, cos))
    qh, kh, vh = (t.view(b, seq, heads, hdim).transpose(1, 2) for t in (q, k, v))
    t_sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    b_rope, by_rope, ops, nbytes = attn_bound(b, heads, seq, hdim, peaks,
                                              extra_bytes=2 * seq * heads * hdim * 4)
    exps = b * heads * seq * seq
    say(f"  flash_attention_packed+rope (PE-Core-bigG, S=1025, 16x96): {t_rope:.4f} ms; plain "
        f"{t_rope_plain:.4f} ms; apply_rope + F.scaled_dot_product_attention "
        f"{t_rope_lib:.4f} ms, of it F.scaled_dot_product_attention alone on the same q, k, v "
        f"[32, 16, 1025, 96] {t_sdpa:.4f} ms; bound {b_rope:.4f} ms ({ops:.3e} FLOP, "
        f"{nbytes:.3e} B, {by_rope}; {exps:.3e} exp, {exp_ms(exps):.4f} ms)")

    h, s, d = 16, 576, 72
    q, k, v = bhsd(b, h, s, d, torch.bfloat16)
    err3 = hold("flash_attention B=32 H=16 S=576 D=72 exact bf16",
                [flash.flash_attention(q, k, v)], [flash.flash_attention_plain(q, k, v)],
                2e-2, 2e-2)
    t3 = cuda_ms(lambda: flash.flash_attention(q, k, v))
    t3_plain = cuda_ms(lambda: flash.flash_attention_plain(q, k, v))
    t3_lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    b3, by3, ops, nbytes = attn_bound(b, h, s, d, peaks)
    say(f"  flash_attention [B, H, S, D] = [32, 16, 576, 72] (on no path: a yardstick beside "
        f"the packed kernel; max_abs_err {err3:.3e}): {t3:.4f} ms; plain {t3_plain:.4f} ms; "
        f"F.scaled_dot_product_attention {t3_lib:.4f} ms; bound {b3:.4f} ms ({ops:.3e} FLOP, "
        f"{nbytes:.3e} B, {by3})")
    return {"flash_attention": {
        "name": "flash_attention", "route": "cuda",
        "source": "clip_embedder_tpu_torch/csrc/flash_bhsd.cu",
        "replaces": "clip_embedder_tpu/ops/flash.py:520",
        **fixture_rows["golden_model text"]},
        "rope": {"max_abs_err": err_rope, "ms": t_rope, "plain_ms": t_rope_plain,
                 "bound_ms": b_rope, "library_ms": t_rope_lib, "sdpa_ms": t_sdpa}}


def hold_int8(name, got, ref, dtype) -> float:
    """Kernel against plain for the int8 kernels. The LayerNorm's row sums
    are taken in another order, which can flip an int8 code by one and move
    that row (through the MLP's requantization, a few more codes). So fail
    unless at most 2% of the rows leave atol + rtol·|ref| (f32: 1e-5 and
    1e-5; bf16: 0 and one bf16 step, 2^-7 of the larger magnitude) and
    every row keeps a cosine of at least 1 - 1e-4 to its plain row."""
    n_rows = off_total = 0
    cos_min = 1.0
    for g, r in zip(got, ref):
        g = g.float().reshape(-1, g.shape[-1])
        r = r.float().reshape(-1, r.shape[-1])
        if dtype == torch.float32:
            base = 1e-5 + 1e-5 * r.abs()
        else:
            base = 2.0 ** -7 * torch.maximum(g.abs(), r.abs())
        off_total += int(((g - r).abs() > base).any(dim=-1).sum())
        n_rows += g.shape[0]
        cos = (g * r).sum(-1) / (g.norm(dim=-1) * r.norm(dim=-1)).clamp_min(1e-30)
        cos_min = min(cos_min, float(cos.min()))
    err = max_err(got, ref)
    off_rows = off_total / n_rows
    ok = off_rows <= 0.02 and cos_min >= 1 - 1e-4
    say(f"  {name}: max_abs_err={err:.3e}, rows off the base tolerance {off_rows:.4%} "
        f"(need <= 2%), min row cosine {cos_min:.8f} (need >= 1-1e-4) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def int8_inputs(rows, k_in, k_out, dtype, dev, *, hidden=None, seed=2):
    """A quantized linear [k_in, k_out] (or an MLP k_in → hidden → k_in),
    quantized on the card from weights in ``dtype``, a LayerNorm and x."""
    from clip_embedder_tpu_torch.ops.quant import quantize_weight

    g = torch.Generator(device=dev).manual_seed(seed)

    def t(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def qlinear(k, n):
        return {**quantize_weight(t(k, n, scale=k ** -0.5)), "b": t(n, scale=0.1)}

    params = ({"fc": qlinear(k_in, hidden), "proj": qlinear(hidden, k_in)}
              if hidden else qlinear(k_in, k_out))
    pre_ln = {"scale": 1 + t(k_in, scale=0.1), "bias": t(k_in, scale=0.1)}
    return params, pre_ln, t(rows, k_in)


def _lib_row_quant(x32):
    amax = x32.abs().amax(dim=-1, keepdim=True)
    xs = torch.where(amax == 0, 1.0, amax / 127.0)
    return torch.round(x32 / xs).clamp_(-127, 127).to(torch.int8), xs


def int8_linear_library(p, w_cm, x, residual):
    """Row quant, torch._int_mm (cuBLASLt) and the epilogue as PyTorch ops.
    The weights go in as stored: K-major, which cuBLASLt reads as a
    column-major [K, N] operand."""
    xq, xs = _lib_row_quant(x.float())
    y = torch._int_mm(xq, w_cm).float() * (xs * p["w_scale"]) + p["b"].float()
    return (y + residual.float()).to(x.dtype)


def ln_qkv_int8_library(s_cat, b_cat, w_cm, pre_ln, x, eps):
    import torch.nn.functional as F

    w = x.shape[-1]
    y = F.layer_norm(x.float(), (w,), pre_ln["scale"].float(), pre_ln["bias"].float(), eps)
    yq, xs = _lib_row_quant(y)
    o = torch._int_mm(yq, w_cm).float() * (xs * s_cat) + b_cat
    return o.to(x.dtype).split(w, dim=-1)


def int8_mlp_library(p, w1_cm, w2_cm, pre_ln, x, eps):
    import torch.nn.functional as F

    w = x.shape[-1]
    y = F.layer_norm(x.float(), (w,), pre_ln["scale"].float(), pre_ln["bias"].float(), eps)
    xq, xs = _lib_row_quant(y)
    h = torch._int_mm(xq, w1_cm).float() * (xs * p["fc"]["w_scale"]) + p["fc"]["b"].float()
    hq, hs = _lib_row_quant(F.gelu(h, approximate="tanh"))
    out = torch._int_mm(hq, w2_cm).float() * (hs * p["proj"]["w_scale"]) \
        + p["proj"]["b"].float() + x.float()
    return out.to(x.dtype)


def phase_int8_kernels(dev, peaks) -> dict:
    from clip_embedder_tpu_torch.ops import int8_mlp, qkv

    width, hidden, seq, eps = 1152, 4304, 576, 1e-6
    say("[3] int8 kernels against their plain versions (main-path shapes)")
    for b in (8, 32):
        for dtype in (torch.bfloat16, torch.float32):
            rows = b * seq
            p, ln, x = int8_inputs(rows, width, width, dtype, dev, hidden=hidden)
            kw = {"activation": "gelu_tanh", "pre_ln": ln, "add_residual": True}
            got = int8_mlp.int8_mlp(p, x, **kw)
            torch.cuda.synchronize()
            hold_int8(f"int8_mlp rows={b}x576 1152->4304->1152 gelu_tanh+LN+res {dtype}",
                      [got], [int8_mlp.int8_mlp_plain(p, x, **kw)], dtype)
            qp = {n: int8_inputs(1, width, width, dtype, dev, seed=3 + i)[0]
                  for i, n in enumerate("qkv")}
            got = qkv.ln_qkv_int8(qp, ln, x, eps=eps)
            torch.cuda.synchronize()
            hold_int8(f"ln_qkv_int8 rows={b}x576 W=1152 {dtype}", got,
                      qkv.ln_qkv_int8_plain(qp, ln, x, eps=eps), dtype)
            r = x.flip(0).contiguous()
            got = int8_mlp.int8_linear_fused(qp["q"], x, residual=r)
            torch.cuda.synchronize()
            hold_int8(f"int8_linear_fused rows={b}x576 1152x1152 +residual {dtype}", [got],
                      [int8_mlp.int8_linear_fused_plain(qp["q"], x, residual=r)], dtype)

    say("[3] ln_qkv_int8 and int8_linear_fused at PE-Core-bigG's vision width")
    pe_rows, pe_width = 8 * 1025, 1536
    for dtype in (torch.bfloat16, torch.float32):
        _, ln, x = int8_inputs(pe_rows, pe_width, pe_width, dtype, dev, seed=11)
        qp = {n: int8_inputs(1, pe_width, pe_width, dtype, dev, seed=12 + i)[0]
              for i, n in enumerate("qkv")}
        got = qkv.ln_qkv_int8(qp, ln, x, eps=eps)
        torch.cuda.synchronize()
        hold_int8(f"ln_qkv_int8 rows=8x1025 W=1536 {dtype}", got,
                  qkv.ln_qkv_int8_plain(qp, ln, x, eps=eps), dtype)
        r = x.flip(0).contiguous()
        got = int8_mlp.int8_linear_fused(qp["q"], x, residual=r)
        torch.cuda.synchronize()
        hold_int8(f"int8_linear_fused rows=8x1025 1536x1536 +residual {dtype}", [got],
                  [int8_mlp.int8_linear_fused_plain(qp["q"], x, residual=r)], dtype)

    say("[3] int8 kernel times at batch 32, bf16 (CUDA events, median of 20 back-to-back "
        "calls); library = PyTorch ops around torch._int_mm")
    dtype = torch.bfloat16
    rows = 32 * seq
    p, ln, x = int8_inputs(rows, width, width, dtype, dev, hidden=hidden)
    kw = {"activation": "gelu_tanh", "pre_ln": ln, "add_residual": True}
    err = hold_int8("int8_mlp rows=32x576 bf16", [int8_mlp.int8_mlp(p, x, **kw)],
                    [int8_mlp.int8_mlp_plain(p, x, **kw)], dtype)
    w1_cm, w2_cm = p["fc"]["w_q"], p["proj"]["w_q"]
    out = {"int8_mlp": {
        "name": "int8_mlp", "route": "cuda", "source": "clip_embedder_tpu_torch/csrc/int8_mlp.cu",
        "replaces": "clip_embedder_tpu/ops/int8_mlp.py:181", "max_abs_err": err,
        **time_int8("int8_mlp", peaks, lambda: int8_mlp.int8_mlp(p, x, **kw),
                    lambda: int8_mlp.int8_mlp_plain(p, x, **kw),
                    lambda: int8_mlp_library(p, w1_cm, w2_cm, ln, x, eps),
                    4 * rows * width * hidden,
                    2 * rows * width * 2 + 2 * width * hidden + 4 * 2 * (hidden + width)
                    + 4 * 2 * width)}}
    # kernels 5 and 6 at SO400M's shape (the record's) and at PE-Core-bigG's vision
    for label, rows, w in (("SO400M rows=32x576 W=1152", 32 * seq, width),
                           ("PE-Core-bigG rows=32x1025 W=1536", 32 * 1025, 1536)):
        recs = time_qkv_linear(label, rows, w, dev, peaks, eps)
        if w == width:
            out.update(recs)
    return out


def time_int8(label, peaks, kern, plain, lib, ops, nbytes, plain_iters=20) -> dict:
    """Times one int8 kernel (CUDA events) beside its plain version, its
    library composition and its bound (``ops`` int8 operations, ``nbytes``:
    each input read once, each output written once), and its device time by
    launch; returns the record's timing keys."""
    t_k, t_p, t_l = cuda_ms(kern), cuda_ms(plain, iters=plain_iters), cuda_ms(lib)
    t_ops, t_bytes = ops / peaks["int8"], nbytes / peaks["bytes"]
    bound = max(t_ops, t_bytes) * 1e3
    say(f"  {label}: {t_k:.4f} ms; plain {t_p:.4f} ms (median of {plain_iters}); library "
        f"{t_l:.4f} ms; bound {bound:.4f} ms ({ops:.3e} int8 op, {nbytes:.3e} B); "
        f"{ops / t_k * 1e-9:.1f} TOP/s")
    launch_breakdown(label, kern)
    return {"ms": t_k, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": t_l}


def time_qkv_linear(label, rows, width, dev, peaks, eps) -> dict:
    """Kernels 5 (ln_qkv_int8) and 6 (int8_linear_fused with the residual)
    at [rows, width] in bf16: held against their plain versions, then timed
    (``time_int8``). Returns their records."""
    from clip_embedder_tpu_torch.ops import int8_mlp, qkv

    dtype, es, vec = torch.bfloat16, 2, 4 * 2  # vec: an f32 scale and bias per column
    _, ln, x = int8_inputs(rows, width, width, dtype, dev)
    qp = {n: int8_inputs(1, width, width, dtype, dev, seed=3 + i)[0]
          for i, n in enumerate("qkv")}
    r = x.flip(0).contiguous()
    # the three stored [out, in] weights stacked into one [3W, W], seen as [W, 3W]
    wqkv_cm = torch.cat([qp[n]["w_q"].t() for n in "qkv"]).t()
    s_cat = torch.cat([qp[n]["w_scale"] for n in "qkv"])
    b_cat = torch.cat([qp[n]["b"].float() for n in "qkv"])
    plain_iters = 20 if width <= 1152 else 5
    out = {}
    err = hold_int8(f"ln_qkv_int8 {label} bf16", qkv.ln_qkv_int8(qp, ln, x, eps=eps),
                    qkv.ln_qkv_int8_plain(qp, ln, x, eps=eps), dtype)
    out["ln_qkv_int8"] = {
        "name": "ln_qkv_int8", "route": "cuda",
        "source": "clip_embedder_tpu_torch/csrc/ln_qkv_int8.cu",
        "replaces": "clip_embedder_tpu/ops/qkv.py:142", "max_abs_err": err,
        **time_int8(f"ln_qkv_int8 {label}", peaks, lambda: qkv.ln_qkv_int8(qp, ln, x, eps=eps),
                    lambda: qkv.ln_qkv_int8_plain(qp, ln, x, eps=eps),
                    lambda: ln_qkv_int8_library(s_cat, b_cat, wqkv_cm, ln, x, eps),
                    6 * rows * width * width,
                    4 * rows * width * es + 3 * width * width + 3 * vec * width
                    + 4 * 2 * width, plain_iters)}
    err = hold_int8(f"int8_linear_fused {label} +residual bf16",
                    [int8_mlp.int8_linear_fused(qp["q"], x, residual=r)],
                    [int8_mlp.int8_linear_fused_plain(qp["q"], x, residual=r)], dtype)
    out["int8_linear_fused"] = {
        "name": "int8_linear_fused", "route": "cuda",
        "source": "clip_embedder_tpu_torch/csrc/int8_linear.cu",
        "replaces": "clip_embedder_tpu/ops/int8_mlp.py:511", "max_abs_err": err,
        **time_int8(f"int8_linear_fused {label}", peaks,
                    lambda: int8_mlp.int8_linear_fused(qp["q"], x, residual=r),
                    lambda: int8_mlp.int8_linear_fused_plain(qp["q"], x, residual=r),
                    lambda: int8_linear_library(qp["q"], qp["q"]["w_q"], x, r),
                    2 * rows * width * width,
                    3 * rows * width * es + width * width + vec * width, plain_iters)}
    return out


def launch_breakdown(label, fn, calls: int = 5) -> dict:
    """Device ms of each kernel that one call of ``fn`` launches (the mean
    over ``calls`` calls under torch.profiler), by kernel name: where a
    wrapper's time goes among its row passes and products."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us > 0:
            out[e.key] = us / 1e3 / calls
    parts = "; ".join(f"{k[:72]} {v:.4f}" for k, v in sorted(out.items(), key=lambda kv: -kv[1]))
    say(f"  {label} by launch (device ms a call, torch.profiler, mean of {calls}): {parts}")
    return out


def int8_mlp_streamed_library(p, w1_cm, w2_slabs, pre_ln, x, eps, chunk):
    """The streamed MLP as PyTorch ops around torch._int_mm: LayerNorm, row
    quant, fc1, exact gelu, then per slab a row requant and an int8 product
    added into the f32 sum."""
    import torch.nn.functional as F

    w = x.shape[-1]
    y = F.layer_norm(x.float(), (w,), pre_ln["scale"].float(), pre_ln["bias"].float(), eps)
    xq, xs = _lib_row_quant(y)
    h = F.gelu(torch._int_mm(xq, w1_cm).float() * (xs * p["fc"]["w_scale"])
               + p["fc"]["b"].float())
    acc = x.float() + p["proj"]["b"].float()
    s2 = p["proj"]["w_scale"]
    for j, w2 in enumerate(w2_slabs):
        aq, as_ = _lib_row_quant(h[:, j * chunk:(j + 1) * chunk])
        acc += torch._int_mm(aq, w2).float() * (as_ * s2)
    return acc.to(x.dtype)


def phase_streamed_mlp_kernel(dev, peaks) -> dict:
    """Kernel 7 at PE-Core-bigG's vision MLP: 1536 -> 8960 -> 1536, exact
    gelu, LayerNorm and residual fused, slabs of 1792."""
    from clip_embedder_tpu_torch.ops import int8_mlp

    width, hidden, seq, eps, chunk = 1536, 8960, 1025, 1e-6, int8_mlp.STREAM_CHUNK
    kw = {"activation": "gelu", "add_residual": True, "chunk": chunk}
    say("[3] int8_mlp_streamed against its plain version (PE-Core-bigG's MLP)")
    for b, dtype in ((8, torch.bfloat16), (2, torch.float32)):
        p, ln, x = int8_inputs(b * seq, width, width, dtype, dev, hidden=hidden, seed=7)
        got = int8_mlp.int8_mlp_streamed(p, x, pre_ln=ln, **kw)
        torch.cuda.synchronize()
        hold_int8(f"int8_mlp_streamed rows={b}x1025 1536->8960->1536 gelu+LN+res {dtype}",
                  [got], [int8_mlp.int8_mlp_streamed_plain(p, x, pre_ln=ln, **kw)], dtype)
    rows, es = 32 * seq, 2
    p, ln, x = int8_inputs(rows, width, width, torch.bfloat16, dev, hidden=hidden, seed=8)
    err = hold_int8("int8_mlp_streamed rows=32x1025 bf16",
                    [int8_mlp.int8_mlp_streamed(p, x, pre_ln=ln, **kw)],
                    [int8_mlp.int8_mlp_streamed_plain(p, x, pre_ln=ln, **kw)], torch.bfloat16)
    w1_cm = p["fc"]["w_q"]
    w2_slabs = [p["proj"]["w_q"][j:j + chunk] for j in range(0, hidden, chunk)]
    t_k = cuda_ms(lambda: int8_mlp.int8_mlp_streamed(p, x, pre_ln=ln, **kw))
    t_p = cuda_ms(lambda: int8_mlp.int8_mlp_streamed_plain(p, x, pre_ln=ln, **kw), iters=5)
    t_l = cuda_ms(lambda: int8_mlp_streamed_library(p, w1_cm, w2_slabs, ln, x, eps, chunk))
    ops = 4 * rows * width * hidden
    nbytes = 2 * rows * width * es + 2 * width * hidden + 4 * 2 * (hidden + width) + 4 * 2 * width
    t_ops, t_bytes = ops / peaks["int8"], nbytes / peaks["bytes"]
    bound = max(t_ops, t_bytes) * 1e3
    say(f"  int8_mlp_streamed: {t_k:.4f} ms; plain {t_p:.4f} ms (median of 5); library "
        f"{t_l:.4f} ms; bound {bound:.4f} ms ({ops:.3e} int8 op, {nbytes:.3e} B)")
    launch_breakdown("int8_mlp_streamed",
                     lambda: int8_mlp.int8_mlp_streamed(p, x, pre_ln=ln, **kw))
    return {"int8_mlp_streamed": {
        "name": "int8_mlp_streamed", "route": "cuda",
        "source": "clip_embedder_tpu_torch/csrc/int8_mlp_streamed.cu",
        "replaces": "clip_embedder_tpu/ops/int8_mlp.py:347", "max_abs_err": err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": bound,
        "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": t_l}}


# ---------------------------------------------------------------------------
# phase 4: fixtures
# ---------------------------------------------------------------------------

def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def phase_fixtures(device) -> dict:
    """Returns the launch counts of the two fixtures' run (counts set to 0
    just before it): kernel 3's main path."""
    from clip_embedder_tpu_torch import Clip
    from clip_embedder_tpu_torch.ops import flash, qkv

    say("[4] golden fixtures, f32")
    reset_launch_counts()
    for name in ("golden_siglip", "golden_model"):
        fixture = FIXTURES / name
        clip = Clip.from_local_dir(fixture, device=device)
        img = np.load(fixture / "golden_image.npy")
        golden = np.load(fixture / "golden_outputs.npz")
        n0 = (qkv.ln_qkv.launches, flash.flash_attention.launches)
        img_emb = clip.vision.embed_image(img)
        txt_emb = clip.text.embed_texts(["a photo of a cat", "the dog!"])
        expect = json.loads((fixture / "golden_classify.json").read_text())
        results = clip.classify(img, [label for label, _ in expect])
        n1 = (qkv.ln_qkv.launches, flash.flash_attention.launches)
        cos = min(cosines(img_emb, golden["image_embedding"]).min(),
                  cosines(txt_emb, golden["text_embeddings"]).min())
        err = max(np.abs(img_emb - golden["image_embedding"]).max(),
                  np.abs(txt_emb - golden["text_embeddings"]).max())
        perr = max(abs(r[1] - e[1]) for r, e in zip(results, expect))
        order = [r[0] for r in results] == [e[0] for e in expect]
        say(f"  {name}: attn_impl={clip.vision.attn_impl} min cos={cos:.9f} "
            f"max abs err={err:.3e} classify order={'same' if order else 'DIFFERENT'} "
            f"prob err={perr:.3e} launches ln_qkv+{n1[0] - n0[0]} "
            f"flash_attention+{n1[1] - n0[1]}")
        if not (cos > 1 - 1e-6 and err <= 5e-4 and order and perr <= 1e-4):
            raise AssertionError(f"{name} does not reproduce its golden outputs")
        if device == "cuda" and not (n1[0] > n0[0] and n1[1] > n0[1]):
            raise AssertionError(f"{name} did not go through ln_qkv and flash_attention")
    counts = launch_counts()
    if counts["flash_attention_packed"]:
        raise AssertionError("the fixtures' 4 x 16 heads went through the packed kernel")
    phase_fixtures_quantized(device)
    return counts


def phase_fixtures_quantized(device) -> None:
    """golden_siglip under both int8 modes, f32: the device's path (the
    fused kernels on the card) against the CPU's (the unfused path), at
    cosine >= 1 - 1e-4. The kernels sum a LayerNorm's row in another order
    than PyTorch does, which can flip one int8 code; in this 64-wide model
    one flipped code in the text tower's first block moves a text embedding
    by 6.3e-5 in cosine (measured on the H100), so 1 - 1e-5 would test the
    luck of the rounding, not the kernels."""
    from clip_embedder_tpu_torch import Clip
    from clip_embedder_tpu_torch.ops import int8_mlp, qkv

    fixture = FIXTURES / "golden_siglip"
    img = np.load(fixture / "golden_image.npy")
    texts = ["a photo of a cat", "the dog!"]
    for mode in QUANT_MODES:
        n0 = (int8_mlp.int8_mlp.launches, qkv.ln_qkv_int8.launches)
        clip = Clip.from_local_dir(fixture, device=device, quantize=mode)
        got = (clip.vision.embed_image(img), clip.text.embed_texts(texts))
        n1 = (int8_mlp.int8_mlp.launches, qkv.ln_qkv_int8.launches)
        cpu = Clip.from_local_dir(fixture, device="cpu", quantize=mode)
        ref = (cpu.vision.embed_image(img), cpu.text.embed_texts(texts))
        cos = min(float(np.min(cosines(g, r))) for g, r in zip(got, ref))
        say(f"  golden_siglip quantize={mode}: {device} against the CPU, min cos={cos:.9f} "
            f"(need >= 1-1e-4); launches int8_mlp+{n1[0] - n0[0]} "
            f"ln_qkv_int8+{n1[1] - n0[1]}")
        if cos < 1 - 1e-4:
            raise AssertionError(f"golden_siglip quantize={mode} disagrees with the CPU")
        if device == "cuda" and not (n1[0] > n0[0] and (n1[1] > n0[1]) == (mode == "int8_all")):
            raise AssertionError(f"golden_siglip quantize={mode} missed its int8 kernels")


# ---------------------------------------------------------------------------
# phase 5: the full-width main path
# ---------------------------------------------------------------------------

def build_clip(device, dtype, *, layers=None, vocab_size=None, seed=0, quantize=None,
               model=SO400M_SIGLIP2_384, preprocess=SIGLIP_PREPROCESS, tokenizer="golden_siglip"):
    """A ``Clip`` of ``model`` (ViT-SO400M-16-SigLIP2-384 unless given) with
    seeded random weights, resolved through the port's config → build
    (``layers``/``vocab_size`` cut it for a CPU rehearsal), with the
    tokenizer and scoring config of the fixture ``tokenizer`` (its ids are
    under 512); ``quantize`` converts those same weights on the device, as
    ``from_local_dir(..., quantize=...)`` converts loaded ones."""
    import copy

    from clip_embedder_tpu_torch import Clip, TextEmbedder, VisionEmbedder
    from clip_embedder_tpu_torch.config import ModelConfig, OpenClipConfig
    from clip_embedder_tpu_torch.models import vit
    from clip_embedder_tpu_torch.models.build import resolve_text, resolve_vision
    from clip_embedder_tpu_torch.text import (configure_tokenizer, text_tower,
                                              with_tokenizer_pad_id)
    from clip_embedder_tpu_torch.tokenizer import Tokenizer
    from clip_embedder_tpu_torch.vision import quantize_params
    from clip_embedder_tpu_torch.weights import _family_init

    model_cfg = copy.deepcopy(model)
    vcfg, tcfg = model_cfg["vision_cfg"], model_cfg["text_cfg"]
    hf_cfg = tcfg.get("hf_config")
    if layers is not None:
        name = vcfg.get("timm_model_name", "")
        if name:
            vcfg["pe_cfg" if "_pe_core_" in name else "vit_cfg"] = {"layers": layers}
        else:
            vcfg["layers"] = layers
        if hf_cfg:
            hf_cfg["num_hidden_layers"] = layers
        else:
            tcfg["layers"] = layers
    if vocab_size is not None:
        (hf_cfg or tcfg)["vocab_size"] = vocab_size
    config = OpenClipConfig.from_dict({"model_cfg": model_cfg, "preprocess_cfg": preprocess})
    fixture = FIXTURES / tokenizer
    model_config = ModelConfig.from_file(fixture / "model_config.json")
    tok = Tokenizer.from_file(fixture / "tokenizer.json")
    pad_id = configure_tokenizer(tok, model_config, config.model_cfg.text_cfg.context_length)
    vspec = resolve_vision(config.model_cfg)
    tspec = with_tokenizer_pad_id(resolve_text(config.model_cfg), pad_id)
    gen = torch.Generator(device=device).manual_seed(seed)
    vparams = vit.init(vspec.cfg, generator=gen, device=device, dtype=dtype)
    tparams = _family_init(tspec.family)(tspec.cfg, generator=gen, device=device, dtype=dtype)
    vtower = vit.ViT(vspec.cfg, quantize_params(vparams, vspec, quantize, device, dtype))
    ttower = text_tower(tspec, quantize_params(tparams, tspec, quantize, device, dtype))
    common = {"config": config, "model_config": model_config, "model_dir": fixture,
              "device": device, "dtype": dtype, "quantize": quantize}
    vision = VisionEmbedder(tower=vtower, spec=vspec, **common)
    text = TextEmbedder(tower=ttower, spec=tspec, tokenizer=tok, **common)
    return Clip(vision=vision, text=text, model_dir=fixture), vspec, tspec


def mixed_batch(n: int) -> list:
    """The JPEGs under assets/img as files, then resized copies of them at
    assorted sizes, ``n`` images in all."""
    from PIL import Image

    paths = sorted(IMAGES.glob("*.jpg"))
    if not paths:
        raise FileNotFoundError(f"no JPEGs under {IMAGES}")
    sizes = [(384, 384), (512, 384), (640, 480), (300, 500), (1024, 768), (200, 200)]
    batch: list = [str(p) for p in paths]
    i = 0
    while len(batch) < n:
        with Image.open(paths[i % len(paths)]) as im:
            batch.append(np.asarray(im.convert("RGB").resize(sizes[i % len(sizes)])))
        i += 1
    return batch[:n]


def kernel_group(name: str) -> str:
    n = name.lower()
    if "i8::row_quant_kernel" in n:
        return "int8 row passes (LayerNorm + quantization)"
    if "i8::gemm_kernel" in n or "i8w::gemm_kernel" in n:
        return "int8 products (with their epilogues)"
    if "qkv_gemm_kernel" in n or "qkv_kernel" in n or "ln_kernel<" in n:
        return "ln_qkv"
    if "flash" in n:
        return "attention kernels (flash_attention_packed, flash_attention)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    return "other"


def device_breakdown(fn) -> dict:
    """One call of ``fn`` under torch.profiler (CUDA activity): device time
    by kernel group and the share of the wall time the device sat idle."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    groups: dict[str, float] = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        groups[kernel_group(e.key)] = groups.get(kernel_group(e.key), 0.0) + us / 1e3
    busy = sum(groups.values())
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"groups_ms": groups, "busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1 - busy / wall_ms)}


def phase_main_path(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None,
                    batch=32, timed=True) -> dict:
    from clip_embedder_tpu_torch import VisionEmbedder
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    say(f"[5] main path: ViT-SO400M-16-SigLIP2-384, {dtype}, random weights (seed 0)")
    t0 = time.perf_counter()
    clip, vspec, tspec = build_clip(device, dtype, layers=layers, vocab_size=vocab_size)
    say(f"  built vision {vspec.cfg.layers}x{vspec.cfg.width} ({vspec.cfg.seq_len} tokens, "
        f"{vspec.cfg.heads}x{vspec.cfg.head_dim} heads), text {tspec.cfg.layers}x"
        f"{tspec.cfg.width} (vocab {tspec.cfg.vocab_size}, ctx {tspec.cfg.context_length}) "
        f"in {time.perf_counter() - t0:.1f} s; attn_impl={clip.vision.attn_impl}")
    images = mixed_batch(batch)
    depth_v, depth_t = vspec.cfg.layers, tspec.cfg.layers

    reset_launch_counts()
    embs = clip.vision.embed_images(images)
    n = launch_counts()
    after_embed = (n["ln_qkv"], n["flash_attention_packed"])
    results = clip.classify(images[0], LABELS)
    n = launch_counts()
    launches = (n["ln_qkv"], n["flash_attention_packed"])

    norms = np.linalg.norm(embs, axis=-1)
    say(f"  embed_images: {embs.shape}, finite={bool(np.isfinite(embs).all())}, "
        f"norms in [{norms.min():.6f}, {norms.max():.6f}]")
    say(f"  classify: {[(lbl, round(p, 6)) for lbl, p in results]}")
    say(f"  launches: after embed_images ln_qkv={after_embed[0]} "
        f"flash={after_embed[1]}; after classify ln_qkv={launches[0]} flash={launches[1]}")
    if embs.shape != (batch, vspec.cfg.embed_dim) or not np.isfinite(embs).all():
        raise AssertionError("embed_images returned bad embeddings")
    if np.abs(norms - 1).max() > 1e-2:
        raise AssertionError("embeddings are not unit-norm")
    probs = [p for _, p in results]
    if not (np.isfinite(probs).all() and probs == sorted(probs, reverse=True)):
        raise AssertionError("classify returned bad probabilities")
    if device == "cuda":
        want = (depth_v, depth_v)
        if after_embed != want or launches != (2 * depth_v + depth_t, 2 * depth_v + depth_t):
            raise AssertionError(f"kernel launches {after_embed}/{launches} are not one "
                                 "per layer per tower forward")

    plain = VisionEmbedder(tower=clip.vision.tower, spec=vspec, config=clip.vision.config,
                           model_config=clip.vision.model_config,
                           model_dir=clip.vision.model_dir, device=device, dtype=dtype,
                           attn_impl="eager")
    cos = cosines(embs, plain.embed_images(images))
    say(f"  kernel vs eager (bf16, same weights): min cosine {cos.min():.6f} (need >= 0.999)")
    if cos.min() < 0.999:
        raise AssertionError("the kernel path disagrees with the eager path")

    out = {"launches": {"ln_qkv": launches[0], "flash_attention_packed": launches[1]},
           "embeddings": embs}
    if not timed:
        return out
    arrays = [to_rgb_array(im) for im in images]
    for impl in ("kernel", "kernel_fast", "eager"):
        emb = VisionEmbedder(tower=clip.vision.tower, spec=vspec, config=clip.vision.config,
                             model_config=clip.vision.model_config,
                             model_dir=clip.vision.model_dir, device=device, dtype=dtype,
                             attn_impl=impl)
        out[impl] = time_embedder(emb, arrays, impl)
        if impl == "kernel":
            out["breakdown"] = profile_embedder(emb, arrays, impl)
    return out


def time_embedder(emb, arrays, label) -> dict:
    """images/s at the batch of ``arrays`` (median of 5 calls) and the p50
    latency of one image (median of 20), host clock."""
    emb.embed_images(arrays)  # warm-up
    times = []
    for _ in range(5):
        t = time.perf_counter()
        emb.embed_images(arrays)
        times.append(time.perf_counter() - t)
    ips = len(arrays) / statistics.median(times)
    lat = []
    for _ in range(20):
        t = time.perf_counter()
        emb.embed_image(arrays[0])
        lat.append(time.perf_counter() - t)
    p50 = statistics.median(lat) * 1e3
    say(f"  {label}: {ips:.2f} images/s at batch {len(arrays)} (median of 5, host clock, "
        f"decoded arrays in, preprocess included); single image p50 {p50:.2f} ms")
    return {"images_per_s": ips, "p50_ms": p50}


def profile_embedder(emb, arrays, label) -> dict:
    bd = device_breakdown(lambda: emb.embed_images(arrays))
    groups = ", ".join(f"{k} {v:.3f}" for k, v in sorted(
        bd["groups_ms"].items(), key=lambda kv: -kv[1]))
    say(f"  {label} batch {len(arrays)} under torch.profiler: device ms by kernel group: "
        f"{groups}; busy {bd['busy_ms']:.3f} of {bd['wall_ms']:.3f} ms wall, "
        f"idle share {bd['idle_share']:.3f}")
    return bd


# ---------------------------------------------------------------------------
# phase 6: the int8 paths
# ---------------------------------------------------------------------------

INT8_WRAPPERS = ("int8_mlp", "ln_qkv_int8", "int8_linear_fused")


def _wrappers() -> dict:
    from clip_embedder_tpu_torch.ops import flash, int8_mlp, qkv

    return {"ln_qkv": qkv.ln_qkv, "flash_attention_packed": flash.flash_attention_packed,
            "flash_attention": flash.flash_attention, "int8_mlp": int8_mlp.int8_mlp,
            "int8_mlp_streamed": int8_mlp.int8_mlp_streamed, "ln_qkv_int8": qkv.ln_qkv_int8,
            "int8_linear_fused": int8_mlp.int8_linear_fused}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def mask_launch_counts() -> dict:
    """The packed kernel's launches with a mask, by form (shared, key, full)."""
    from clip_embedder_tpu_torch.ops import flash

    return dict(flash.flash_attention_packed.mask_launches)


def reset_launch_counts() -> None:
    from clip_embedder_tpu_torch.ops import flash

    for fn in _wrappers().values():
        fn.launches = 0
    flash.flash_attention_packed.mask_launches = dict.fromkeys(
        flash.flash_attention_packed.mask_launches, 0)


def expected_int8_launches(mode, depth_v, depth_t, *, streamed=False) -> dict:
    """One embed_images (vision) plus one classify (vision + text), from the
    gates: every block's MLP and the map-pool head's MLP take int8_mlp, or,
    with ``streamed`` (over 20 MB of int8 weights and at least 512 rows: the
    PE-Core-bigG vision MLP), the vision blocks' MLPs take
    int8_mlp_streamed; under int8_all every block's q/k/v takes ln_qkv_int8
    and every out-projection (with its residual) and the map-pool k/v (all
    the tokens' rows) int8_linear_fused, while the map-pool q and out (B
    rows, under 128) take the unfused int8_linear. Self-attention takes the
    packed kernel (the heads form 128-lane groups)."""
    forwards = 2 * depth_v + depth_t
    mlps = {"int8_mlp": (depth_t if streamed else forwards) + 2,
            "int8_mlp_streamed": 2 * depth_v if streamed else 0}
    if mode is None:
        return {"ln_qkv": forwards, "flash_attention_packed": forwards, "flash_attention": 0,
                "int8_mlp": 0, "int8_mlp_streamed": 0, "ln_qkv_int8": 0,
                "int8_linear_fused": 0}
    if mode == "int8":
        return {"ln_qkv": forwards, "flash_attention_packed": forwards, "flash_attention": 0,
                **mlps, "ln_qkv_int8": 0, "int8_linear_fused": 0}
    return {"ln_qkv": 0, "flash_attention_packed": forwards, "flash_attention": 0, **mlps,
            "ln_qkv_int8": forwards, "int8_linear_fused": forwards + 4}


def plain_int8_wrappers():
    """The int8 wrappers swapped for their plain versions where the layers
    call them, so that the same Clip runs the plain path."""
    from contextlib import ExitStack
    from unittest import mock

    from clip_embedder_tpu_torch.ops import attention, int8_mlp, layers, qkv

    stack = ExitStack()
    for module in (layers, attention):
        stack.enter_context(mock.patch.object(module, "int8_linear_fused",
                                              int8_mlp.int8_linear_fused_plain))
    stack.enter_context(mock.patch.object(layers, "int8_mlp", int8_mlp.int8_mlp_plain))
    stack.enter_context(mock.patch.object(layers, "int8_mlp_streamed",
                                          int8_mlp.int8_mlp_streamed_plain))
    stack.enter_context(mock.patch.object(attention, "ln_qkv_int8", qkv.ln_qkv_int8_plain))
    return stack


def phase_int8_paths(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None,
                     batch=32, timed=True, bf16_embeddings=None) -> dict:
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    out = {}
    for mode in QUANT_MODES:
        say(f"[6] int8 path: ViT-SO400M-16-SigLIP2-384, quantize={mode}, {dtype}, phase 5's "
            "weights quantized on the device")
        t0 = time.perf_counter()
        clip, vspec, tspec = build_clip(device, dtype, layers=layers, vocab_size=vocab_size,
                                        quantize=mode)
        say(f"  built and quantized in {time.perf_counter() - t0:.1f} s")
        images = mixed_batch(batch)
        reset_launch_counts()
        embs = clip.vision.embed_images(images)
        results = clip.classify(images[0], LABELS)
        counts = launch_counts()
        norms = np.linalg.norm(embs, axis=-1)
        say(f"  embed_images: {embs.shape}, norms in [{norms.min():.6f}, {norms.max():.6f}]; "
            f"classify: {[(lbl, round(p, 6)) for lbl, p in results]}")
        say(f"  launches (one embed_images + one classify): {counts}")
        if embs.shape != (batch, vspec.cfg.embed_dim) or not np.isfinite(embs).all():
            raise AssertionError(f"quantize={mode}: embed_images returned bad embeddings")
        if np.abs(norms - 1).max() > 1e-2:
            raise AssertionError(f"quantize={mode}: embeddings are not unit-norm")
        probs = [p for _, p in results]
        if not (np.isfinite(probs).all() and probs == sorted(probs, reverse=True)):
            raise AssertionError(f"quantize={mode}: classify returned bad probabilities")
        if device == "cuda":
            want = expected_int8_launches(mode, vspec.cfg.layers, tspec.cfg.layers)
            if counts != want:
                raise AssertionError(f"quantize={mode}: launches {counts}, expected {want}")

        with plain_int8_wrappers():
            cos = cosines(embs, clip.vision.embed_images(images))
        say(f"  kernel path vs plain path (quantize={mode}, same weights): min cosine "
            f"{cos.min():.6f} (need >= 0.999)")
        if cos.min() < 0.999:
            raise AssertionError(f"quantize={mode}: the kernel path disagrees with the plain path")
        if bf16_embeddings is not None:
            say(f"  against the bf16 path (not gated: random weights): min cosine "
                f"{cosines(embs, bf16_embeddings).min():.6f}, mean "
                f"{cosines(embs, bf16_embeddings).mean():.6f}")
        out[mode] = {"launches": counts}
        if timed:
            arrays = [to_rgb_array(im) for im in images]
            out[mode].update(time_embedder(clip.vision, arrays, f"quantize={mode}"))
            if mode == "int8_all":
                out[mode]["breakdown"] = profile_embedder(clip.vision, arrays,
                                                          f"quantize={mode}")
    return out


# ---------------------------------------------------------------------------
# phase 7: PE-Core-bigG-14-448
# ---------------------------------------------------------------------------

def per_block_cosines(tower, run_kernel, run_plain) -> list[float]:
    """Each block's output under two runs (on a small batch: every block's
    output is kept), as the least cosine over its tokens."""
    outs: tuple[list, list] = ([], [])
    slot = [0]
    hooks = [blk.register_forward_hook(
        lambda _m, _a, o: outs[slot[0]].append(o.float().flatten(0, -2)))
        for blk in tower.blocks]
    try:
        run_kernel()
        slot[0] = 1
        run_plain()
    finally:
        for h in hooks:
            h.remove()
    return [float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
            for a, b in zip(*outs)]


def free_device_memory() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def hold_towers(clip, vspec, tspec, embs, images, mode, label, texts=LABELS) -> None:
    """Both towers' kernel path against the plain path (eager for bf16, the
    plain int8 wrappers for the int8 modes) at min cosine 0.999: the vision
    tower on ``images`` (``embs`` is its kernel run), the text tower on
    ``texts`` (PE-Core's: the labels, whose kernels run at the text tower's
    own shapes: 20 x 64 heads, the causal mask, W = 1280, MLP 5120)."""
    from clip_embedder_tpu_torch import TextEmbedder, VisionEmbedder

    kernel = {"vision": clip.vision.embed_images, "text": clip.text.embed_texts}
    if mode is None:
        common = {"config": clip.vision.config, "model_config": clip.vision.model_config,
                  "model_dir": clip.vision.model_dir, "device": clip.vision.device,
                  "dtype": clip.vision.dtype, "attn_impl": "eager"}
        plain = {"vision": VisionEmbedder(tower=clip.vision.tower, spec=vspec,
                                          **common).embed_images,
                 "text": TextEmbedder(tower=clip.text.tower, spec=tspec,
                                      tokenizer=clip.text.tokenizer, **common).embed_texts}
        what = "eager"
    else:
        def plain_of(fn):
            def run(xs):
                with plain_int8_wrappers():
                    return fn(xs)
            return run
        plain = {name: plain_of(fn) for name, fn in kernel.items()}
        what = "the plain int8 wrappers"
    runs = {"vision": (clip.vision.tower, embs, images),
            "text": (clip.text.tower, kernel["text"](texts), texts)}
    for name, (tower, got, inputs) in runs.items():
        cos = cosines(got, plain[name](inputs))
        say(f"  {name}: kernel path vs {what} (same weights): min cosine {cos.min():.6f}, "
            f"mean {cos.mean():.6f} (need >= 0.999)")
        if cos.min() < 0.999:
            per = per_block_cosines(tower, lambda: kernel[name](inputs[:2]),
                                    lambda: plain[name](inputs[:2]))
            say("  per-block least token cosine, kernel vs plain: "
                + ", ".join(f"{c:.6f}" for c in per))
            raise AssertionError(f"{label}: the {name} tower's kernel path disagrees with "
                                 f"{what}")


def phase_pe_core(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None, batch=32,
                  timed=True) -> dict:
    """PE-Core-bigG-14-448 with seeded random weights through ``Clip`` in
    ``dtype`` and under both int8 modes, each mode's model built anew from
    the same seed (``layers``/``vocab_size`` cut it for a CPU rehearsal)."""
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    free_device_memory()  # the earlier phases' models
    images = mixed_batch(batch)
    arrays = [to_rgb_array(im) for im in images]
    out = {}
    for mode in (None,) + QUANT_MODES:
        label = mode or str(dtype).removeprefix("torch.")
        say(f"[7] PE-Core-bigG-14-448, {label}, {dtype}, random weights (seed 0)")
        t0 = time.perf_counter()
        clip, vspec, tspec = build_clip(device, dtype, layers=layers, vocab_size=vocab_size,
                                        quantize=mode, model=PE_CORE_BIGG_448,
                                        preprocess=PE_PREPROCESS)
        v, t = vspec.cfg, tspec.cfg
        say(f"  built vision {v.layers}x{v.width} ({v.seq_len} tokens, {v.heads}x{v.head_dim} "
            f"heads, rope_2d={v.rope_2d}, MLP {v.mlp_hidden}, pool {v.pool}), text {t.layers}x"
            f"{t.width} ({t.heads} heads, ctx {t.context_length}) in "
            f"{time.perf_counter() - t0:.1f} s; attn_impl={clip.vision.attn_impl}")
        reset_launch_counts()
        embs = clip.vision.embed_images(images)
        results = clip.classify(images[0], LABELS)
        counts = launch_counts()
        norms = np.linalg.norm(embs, axis=-1)
        say(f"  embed_images: {embs.shape}, norms in [{norms.min():.6f}, {norms.max():.6f}]; "
            f"classify: {[(lbl, round(p, 6)) for lbl, p in results]}")
        say(f"  launches (one embed_images + one classify): {counts}")
        if embs.shape != (batch, v.embed_dim) or not np.isfinite(embs).all():
            raise AssertionError(f"PE-Core {label}: embed_images returned bad embeddings")
        if np.abs(norms - 1).max() > 1e-2:
            raise AssertionError(f"PE-Core {label}: embeddings are not unit-norm")
        probs = [p for _, p in results]
        if not (np.isfinite(probs).all() and probs == sorted(probs, reverse=True)):
            raise AssertionError(f"PE-Core {label}: classify returned bad probabilities")
        if device == "cuda":
            want = expected_int8_launches(mode, v.layers, t.layers, streamed=True)
            if counts != want:
                raise AssertionError(f"PE-Core {label}: launches {counts}, expected {want}")

        hold_towers(clip, vspec, tspec, embs, images, mode, f"PE-Core {label}")
        out[label] = {"launches": counts, "vision_layers": v.layers}
        if timed:
            out[label].update(time_embedder(clip.vision, arrays, f"PE-Core {label}"))
            out[label]["breakdown"] = profile_embedder(clip.vision, arrays, f"PE-Core {label}")
        del clip
        free_device_memory()
    return out


# ---------------------------------------------------------------------------
# phase 8: the towers that send kernel 2 its per-batch masks
# ---------------------------------------------------------------------------

# microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224 as the repo records
# it (tests/test_reference_model_list.py, reference README.md:143): timm
# vit_base_patch16_224 (12 x 768, 197 tokens), BERT-base text (12 x 768,
# context 256, vocab 30522), cls pooler, mlp projection to 512.
BIOMEDCLIP = {
    "embed_dim": 512,
    "vision_cfg": {"image_size": 224, "timm_model_name": "vit_base_patch16_224"},
    "text_cfg": {
        "context_length": 256,
        "hf_model_name": "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract",
        "hf_tokenizer_name": "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract",
        "proj": "mlp",
        "pooler_type": "cls_last_hidden_state_pooler",
        "hf_config": {"model_type": "bert", "vocab_size": 30522, "hidden_size": 768,
                      "num_hidden_layers": 12, "num_attention_heads": 12,
                      "intermediate_size": 3072, "max_position_embeddings": 512,
                      "type_vocab_size": 2, "pad_token_id": 0, "layer_norm_eps": 1e-12,
                      "hidden_act": "gelu"},
    },
}
# open_clip model_configs/coca_ViT-L-14.json (benches/bench_suite.py
# "coca_vit_l14_224"): vision 24 x 1024, patch 14 at 224 (257 tokens), the
# boolean attentional pooler (256 queries, 8 heads, in the 768-wide embed
# space); text 12 x 768, context 76 plus the appended cls, causal. Its
# multimodal decoder makes captions, not embeddings, and is not built.
COCA_VIT_L_14 = {
    "embed_dim": 768,
    "vision_cfg": {"image_size": 224, "layers": 24, "width": 1024, "patch_size": 14,
                   "attentional_pool": True, "attn_pooler_heads": 8, "output_tokens": True},
    "text_cfg": {"context_length": 76, "vocab_size": 49408, "layers": 12, "heads": 12,
                 "width": 768, "embed_cls": True, "output_tokens": True},
}
# open_clip's OpenAI mean and std (both configs' preprocess)
OPENAI_PREPROCESS = {"mean": [0.48145466, 0.4578275, 0.40821073],
                     "std": [0.26862954, 0.26130258, 0.27577711],
                     "interpolation": "bicubic", "resize_mode": "shortest"}
# label, config, tokenizer fixture, the text tower's mask form, the longest
# caption in words (every word one token), the modes run
MASKED_MODELS = (
    ("BiomedCLIP", BIOMEDCLIP, "golden_hf_bert", "key", 250, (None, "int8_all")),
    ("coca_ViT-L-14", COCA_VIT_L_14, "golden_siglip", "full", 70, (None,)),
)


def captions(n: int, max_words: int) -> list[str]:
    """``n`` captions of distinct lengths from 1 to ``max_words`` words, each
    word one token of the fixtures' tokenizers: every row of a batch pads
    (and so masks) a different number of keys."""
    words = ("a", "photo", "of", "the", "cat", "dog")
    counts = np.linspace(1, max_words, n).round().astype(int)
    return [" ".join(words[j % len(words)] for j in range(c)) for c in counts]


def tower_launches(family: str, mode, depth: int) -> dict:
    """The kernel launches of one forward of a phase-8 tower, by wrapper,
    from the gates: every block's self-attention takes the packed kernel
    (12 x 64 and 16 x 64 heads form 128-lane groups); pre-LN blocks fuse
    their LayerNorm with q/k/v (ln_qkv, or ln_qkv_int8 under int8_all, with
    the out-projection and its residual on int8_linear_fused); BERT is
    post-LN, so under int8_all its q, k, v and out-projection take the
    linear gate (int8_linear_fused without a residual, at 128 rows or more);
    quantized MLPs take int8_mlp. The poolers' cross-attention and the
    output projections launch nothing."""
    n = dict.fromkeys(_wrappers(), 0)
    n["flash_attention_packed"] = depth
    if family == "hf_bert":
        n["int8_linear_fused"] = 4 * depth if mode == "int8_all" else 0
    elif mode == "int8_all":
        n["ln_qkv_int8"] = n["int8_linear_fused"] = depth
    else:
        n["ln_qkv"] = depth
    n["int8_mlp"] = depth if mode else 0
    return n


def time_texts(text, texts, label) -> dict:
    """texts/s at the batch of ``texts`` (median of 5 calls, host clock)."""
    text.embed_texts(texts)  # warm-up
    times = []
    for _ in range(5):
        t = time.perf_counter()
        text.embed_texts(texts)
        times.append(time.perf_counter() - t)
    tps = len(texts) / statistics.median(times)
    say(f"  {label}: {tps:.2f} texts/s at batch {len(texts)} (median of 5, host clock, "
        "tokenization included)")
    return {"texts_per_s": tps}


def phase_masked_towers(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None,
                        batch=32, timed=True) -> dict:
    """BiomedCLIP (BERT text: kernel 2's key mask) and coca_ViT-L-14 (text:
    its full mask) at full width and depth, seeded random weights, through
    ``Clip``: ``embed_images`` on ``mixed_batch``, ``embed_texts`` on
    captions of distinct lengths, one ``classify``, in ``dtype`` and, for
    BiomedCLIP, under ``int8_all`` (quantized on the device). Launch counts
    asserted per call (the masked launches by form), both towers held
    against the plain path, img/s and texts/s, device time by kernel group.
    Each model is freed before the next (``layers``/``vocab_size`` cut them
    for a CPU rehearsal)."""
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    free_device_memory()  # the earlier phases' models
    images = mixed_batch(batch)
    arrays = [to_rgb_array(im) for im in images]
    out = {}
    for name, model, tokenizer, form, max_words, modes in MASKED_MODELS:
        texts = captions(batch, max_words)
        for mode in modes:
            label = f"{name} {mode or str(dtype).removeprefix('torch.')}"
            say(f"[8] {label}, random weights (seed 0)")
            t0 = time.perf_counter()
            clip, vspec, tspec = build_clip(device, dtype, layers=layers, vocab_size=vocab_size,
                                            quantize=mode, model=model,
                                            preprocess=OPENAI_PREPROCESS, tokenizer=tokenizer)
            v, t = vspec.cfg, tspec.cfg
            say(f"  built vision {v.layers}x{v.width} ({v.seq_len} tokens, {v.heads}x"
                f"{v.head_dim} heads, pool {v.pool}), text {tspec.family} {t.layers}x{t.width} "
                f"({t.heads} heads, ctx {t.context_length}, pad id {t.pad_id}) in "
                f"{time.perf_counter() - t0:.1f} s; attn_impl={clip.vision.attn_impl}")
            reset_launch_counts()
            calls = {}
            embs = clip.vision.embed_images(images)
            calls["embed_images"] = (launch_counts(), mask_launch_counts())
            reset_launch_counts()
            temb = clip.text.embed_texts(texts)
            calls["embed_texts"] = (launch_counts(), mask_launch_counts())
            results = clip.classify(images[0], LABELS)
            n_cls, m_cls = launch_counts(), mask_launch_counts()
            calls["classify"] = ({k: n_cls[k] - calls["embed_texts"][0][k] for k in n_cls},
                                 {k: m_cls[k] - calls["embed_texts"][1][k] for k in m_cls})
            for what, e, dim in (("embed_images", embs, v.embed_dim),
                                 ("embed_texts", temb, t.embed_dim)):
                norms = np.linalg.norm(e, axis=-1)
                say(f"  {what}: {e.shape}, norms in [{norms.min():.6f}, {norms.max():.6f}]")
                if e.shape != (batch, dim) or not np.isfinite(e).all() \
                        or np.abs(norms - 1).max() > 1e-2:
                    raise AssertionError(f"{label}: {what} returned bad embeddings")
            probs = [p for _, p in results]
            say(f"  classify: {[(lbl, round(p, 6)) for lbl, p in results]}")
            if not (np.isfinite(probs).all() and probs == sorted(probs, reverse=True)):
                raise AssertionError(f"{label}: classify returned bad probabilities")
            for what, (n, m) in calls.items():
                say(f"  launches, {what}: {n}; with a mask, by form: {m}")
            if device == "cuda":
                vis = tower_launches("vit", mode, v.layers)
                txt = tower_launches(tspec.family, mode, t.layers)
                want = {"embed_images": (vis, {}), "embed_texts": (txt, {form: t.layers}),
                        "classify": ({k: vis[k] + txt[k] for k in vis}, {form: t.layers})}
                for what, (n, m) in calls.items():
                    wn, wm = want[what]
                    wm = {f: wm.get(f, 0) for f in m}
                    if n != wn or m != wm:
                        raise AssertionError(f"{label}: {what} launched {n} (masked {m}), "
                                             f"expected {wn} (masked {wm})")
            hold_towers(clip, vspec, tspec, embs, images, mode, label, texts=texts)
            out[label] = {"launches": n_cls, "mask_launches": m_cls, "form": form}
            if timed:
                out[label].update(time_embedder(clip.vision, arrays, label))
                out[label].update(time_texts(clip.text, texts, label))
                out[label]["breakdown"] = profile_embedder(clip.vision, arrays, label)
                bd = device_breakdown(lambda: clip.text.embed_texts(texts))
                groups = ", ".join(f"{k} {ms:.3f}" for k, ms in sorted(
                    bd["groups_ms"].items(), key=lambda kv: -kv[1]))
                say(f"  {label} embed_texts batch {batch} under torch.profiler: device ms by "
                    f"kernel group: {groups}; busy {bd['busy_ms']:.3f} of {bd['wall_ms']:.3f} ms "
                    f"wall, idle share {bd['idle_share']:.3f}")
                out[label]["text_breakdown"] = bd
            del clip
            free_device_memory()
    return out


# ---------------------------------------------------------------------------
# phase 9: the deployment path: convert a checkpoint, load it, serve it
# ---------------------------------------------------------------------------

SO400M_REPO = "timm/ViT-SO400M-16-SigLIP2-384"
SERVED_COSINE = 1 - 1e-6  # served rows against the direct call


def so400m_source(device, *, layers=None, vocab_size=None, seed=0):
    """ViT-SO400M-16-SigLIP2-384 as open_clip builds it, from the torch-only
    reference modules of ``tests/torch_ref.py`` (timm naming for the vision
    trunk, open_clip's for the SigLIP text tower), seeded random f32 weights
    on ``device``, in eval mode: (vision, text). ``torch_ref``'s text tower
    defaults to erf gelu and LayerNorm eps 1e-5; the config's tanh gelu and
    eps 1e-6 are set on it here. ``layers``/``vocab_size`` cut it."""
    sys.path.insert(0, str(REPO / "tests"))
    from torch import nn
    from torch_ref import TextTransformer, TimmSiglipViT

    depth = layers or 27
    vocab = vocab_size or SO400M_SIGLIP2_384["text_cfg"]["vocab_size"]
    torch.manual_seed(seed)
    with torch.device(device):
        vision = TimmSiglipViT(384, 16, 1152, depth, 16, 4304)
        text = TextTransformer(64, vocab, 1152, 16, depth, 4304, 1152, causal=False,
                               pool="last", proj_bias=True)
    for block in text.transformer.resblocks:
        block.mlp.gelu = nn.GELU(approximate="tanh")
    for m in text.modules():
        if isinstance(m, nn.LayerNorm):
            m.eps = 1e-6
    return vision.eval(), text.eval()


def jpeg_bytes(images) -> list[bytes]:
    """``mixed_batch``'s images as JPEG files' bytes (the files as they are,
    the resized copies encoded at quality 95), as clients send them."""
    import io

    from PIL import Image

    out = []
    for im in images:
        if isinstance(im, str):
            out.append(Path(im).read_bytes())
        else:
            buf = io.BytesIO()
            Image.fromarray(im).save(buf, format="JPEG", quality=95)
            out.append(buf.getvalue())
    return out


def http(server, path, payload=None, ctype="application/json"):
    """One request to ``server`` (a GET without ``payload``); the decoded
    JSON reply."""
    import urllib.request

    host, port = server.address
    data = json.dumps(payload).encode() if isinstance(payload, dict) else payload
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def hold_rows(what, got, ref, bound) -> float:
    """Served rows against the direct call's, at min cosine ``bound``."""
    got = np.asarray(got, np.float32)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: served {got.shape}, direct {ref.shape}")
    cos = float(cosines(got, ref).min())
    if cos < bound:
        raise AssertionError(f"{what}: served rows at cosine {cos:.7f} of the direct call "
                             f"(need >= {bound})")
    return cos


def hold_order(what, got, ref) -> None:
    """Served classify/rank results against the direct call's: the same
    order, probabilities within 1e-4."""
    if [r[0] for r in got] != [r[0] for r in ref]:
        raise AssertionError(f"{what}: served order {got} against direct {ref}")
    err = max(abs(g[1] - r[1]) for g, r in zip(got, ref))
    if err > 1e-4:
        raise AssertionError(f"{what}: probabilities {err:.2e} from the direct call")


def convert_so400m(device, model_dir, *, layers=None, vocab_size=None) -> tuple:
    """Steps 1-2: the source model's checkpoint written as a published one
    (``torch.save`` of an f32 open_clip state dict, as
    ``open_clip_pytorch_model.bin``), then read and converted into
    ``model_dir`` by the port's ``pull_weights``. Returns the source
    modules and the seconds of each step."""
    from clip_embedder_tpu_torch import pull_weights

    model_cfg = json.loads(json.dumps(SO400M_SIGLIP2_384))
    if layers is not None:
        model_cfg["vision_cfg"]["vit_cfg"] = {"layers": layers}
        model_cfg["text_cfg"]["layers"] = layers
    if vocab_size is not None:
        model_cfg["text_cfg"]["vocab_size"] = vocab_size
    occ = {"model_cfg": model_cfg, "preprocess_cfg": SIGLIP_PREPROCESS}
    (model_dir / "open_clip_config.json").write_text(json.dumps(occ, indent=2))
    (model_dir / "tokenizer.json").write_bytes(
        (FIXTURES / "golden_siglip" / "tokenizer.json").read_bytes())
    secs = {}
    t = time.perf_counter()
    vision, text = so400m_source(device, layers=layers, vocab_size=vocab_size)
    secs["build"] = time.perf_counter() - t
    t = time.perf_counter()
    ckpt = model_dir / "open_clip_pytorch_model.bin"
    sd = {f"visual.trunk.{k}": v.detach().cpu() for k, v in vision.state_dict().items()}
    sd.update({f"text.{k}": v.detach().cpu() for k, v in text.state_dict().items()})
    sd["logit_scale"] = torch.tensor(np.log(10.0), dtype=torch.float32)
    sd["logit_bias"] = torch.tensor(-10.0)
    n_params = sum(v.numel() for v in sd.values())
    torch.save(sd, ckpt)
    del sd
    secs["save"] = time.perf_counter() - t
    t = time.perf_counter()
    sd = pull_weights.load_checkpoint(ckpt)
    secs["load_checkpoint"] = time.perf_counter() - t
    t = time.perf_counter()
    (model_dir / "model_config.json").write_text(json.dumps(
        pull_weights.derive_model_config(SO400M_REPO, occ, sd), indent=2))
    secs["derive_model_config"] = time.perf_counter() - t
    t = time.perf_counter()
    pull_weights.convert_checkpoint(model_dir, sd)
    secs["convert_checkpoint"] = time.perf_counter() - t
    del sd
    ckpt.unlink()
    say(f"  checkpoint: {n_params / 1e9:.3f} B f32 parameters; seconds: "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return vision, text, secs


def phase_serving(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None, batch=32,
                  clients=64, hold=8, warm=(1, 8, 32), timed=True) -> dict:
    """Phase 9: ViT-SO400M-16-SigLIP2-384's checkpoint converted, loaded,
    held against its source and served over HTTP (``layers``/``vocab_size``
    and the counts cut it for a CPU rehearsal). Launch counts are exact in
    the single-client part and only asserted to grow under concurrency
    (the counters are plain ``+= 1``). Served rows are held against the
    direct call at cosine 1 - 1e-6: the kernels compute each row on its
    own, and an H100 80GB HBM3 gave 1.0000000 at every row."""
    import base64
    import shutil
    import tempfile

    from clip_embedder_tpu_torch import Clip
    from clip_embedder_tpu_torch.serving import ClipServer, warmup

    free_device_memory()  # the earlier phases' models
    say(f"[9] deployment path: {SO400M_REPO} checkpoint → convert → Clip.from_local_dir "
        f"({dtype}) → warmup → ClipServer")
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="clip_smoke_") as tmp:
        model_dir = Path(tmp)
        disk = shutil.disk_usage(tmp)
        mem = dict(line.split(":", 1) for line in Path("/proc/meminfo").read_text().splitlines())
        say(f"  temp dir {tmp}: {disk.free / 2**30:.1f} GiB free of {disk.total / 2**30:.1f}; "
            f"host memory available {mem['MemAvailable'].strip()} of {mem['MemTotal'].strip()}")
        vision_ref, text_ref, out["convert_s"] = convert_so400m(
            device, model_dir, layers=layers, vocab_size=vocab_size)
        t = time.perf_counter()
        clip = Clip.from_local_dir(model_dir, device=device, dtype=dtype)
        out["load_s"] = time.perf_counter() - t
    v, tc = clip.vision.spec.cfg, clip.text.spec.cfg
    say(f"  loaded vision {v.layers}x{v.width} ({v.seq_len} tokens, {v.heads}x{v.head_dim} "
        f"heads), text {tc.layers}x{tc.width} (vocab {tc.vocab_size}) in {out['load_s']:.2f} s; "
        f"attn_impl={clip.vision.attn_impl}")

    # step 3: the converted model against its source, on the same inputs
    images = mixed_batch(hold)
    texts = (LABELS + captions(hold, 12))[:hold]
    pixels = torch.from_numpy(clip.vision.preprocess_batch(images)).to(device)
    ids = torch.from_numpy(clip.text.tokenize(texts)[0]).long().to(device)
    with torch.inference_mode():
        ref_v = vision_ref(pixels).float().cpu().numpy()
        ref_t = text_ref(ids).float().cpu().numpy()
    del vision_ref, text_ref, pixels, ids
    free_device_memory()
    cos_v = float(cosines(clip.vision.embed_images(images), ref_v).min())
    cos_t = float(cosines(clip.text.embed_texts(texts), ref_t).min())
    say(f"  converted {dtype} Clip against the source model in f32 (tests/torch_ref.py, same "
        f"pixels and ids): min cosine images {cos_v:.6f}, texts {cos_t:.6f} (need >= 0.999)")
    if min(cos_v, cos_t) < 0.999:
        raise AssertionError("the converted model does not compute its source model")
    out["source_cosine"] = {"images": cos_v, "texts": cos_t}

    # step 4: warm up, serve, one client at a time
    t = time.perf_counter()
    warmup(clip, batch_sizes=warm)
    out["warmup_s"] = time.perf_counter() - t
    say(f"  warmup(batch_sizes={warm}) in {out['warmup_s']:.2f} s")
    jpgs = jpeg_bytes(mixed_batch(max(batch, clients)))
    b64 = [base64.b64encode(j).decode() for j in jpgs]
    many = captions(batch, 12)
    server = ClipServer(clip, max_batch=32)
    try:
        say(f"  serving on {server.address}")
        reset_launch_counts()
        served = {
            "image": http(server, "/v1/embed/image", jpgs[0], "image/jpeg"),
            "images": http(server, "/v1/embed/image", {"images_b64": b64[:batch]}),
            "text": http(server, "/v1/embed/text", {"texts": [LABELS[0]]}),
            "texts": http(server, "/v1/embed/text", {"texts": many}),
            "classify": http(server, "/v1/classify", {"image_b64": b64[1], "labels": LABELS}),
            "rank": http(server, "/v1/rank", {"images_b64": b64[:hold], "text": LABELS[1]}),
        }
        counts = launch_counts()
        health = http(server, "/healthz")
        metrics = http(server, "/v1/metrics")
        # 4 vision forwards (image, images, classify's image, rank's images),
        # 4 text (text, texts, classify's labels, rank's text)
        forwards = 4 * v.layers + 4 * tc.layers
        want = dict.fromkeys(_wrappers(), 0)
        if device == "cuda":
            want.update(ln_qkv=forwards, flash_attention_packed=forwards)
        say(f"  single client: launches {counts} (want ln_qkv and flash_attention_packed "
            f"{want['ln_qkv']}: 4 vision and 4 text forwards); healthz {health}")
        if counts != want:
            raise AssertionError(f"served launches {counts}, expected {want}")
        cos = {
            "image": hold_rows("image", served["image"]["embeddings"],
                               clip.vision.embed_images([jpgs[0]]), SERVED_COSINE),
            "images": hold_rows("images", served["images"]["embeddings"],
                                clip.vision.embed_images(jpgs[:batch]), SERVED_COSINE),
            "text": hold_rows("text", served["text"]["embeddings"],
                              clip.text.embed_texts([LABELS[0]]), SERVED_COSINE),
            "texts": hold_rows("texts", served["texts"]["embeddings"],
                               clip.text.embed_texts(many), SERVED_COSINE),
        }
        hold_order("classify", served["classify"]["results"], clip.classify(jpgs[1], LABELS))
        hold_order("rank", served["rank"]["results"], clip.rank_images(jpgs[:hold], LABELS[1]))
        say("  served rows against the direct call, min cosine: "
            + ", ".join(f"{k} {c:.7f}" for k, c in cos.items())
            + f" (need >= {SERVED_COSINE}); classify and rank: same order, probabilities "
            "within 1e-4")
        if metrics["requests"].get("/v1/embed/image") != 2 or metrics["errors"]:
            raise AssertionError(f"metrics after the single client: {metrics}")
        out["single_client"] = {"launches": counts, "cosines": cos}

        # step 5: concurrent clients, one image each: the port's server (each
        # JPEG decoded in its handler thread) and, in turns, the JAX
        # server's design (the raw bytes submitted, decoded in the collector)
        direct = np.concatenate([clip.vision.embed_images(jpgs[i:i + 32])
                                 for i in range(0, clients, 32)])
        runs = []
        with tempfile.TemporaryDirectory(prefix="clip_smoke_jpegs_") as jdir:
            paths = [Path(jdir) / f"{i}.jpg" for i in range(clients)]
            for path, data in zip(paths, jpgs):
                path.write_bytes(data)
            for variant in ("handlers", "collector", "collector", "handlers"):
                with decode_in_collector() if variant == "collector" \
                        else contextlib.nullcontext():
                    runs.append(serve_concurrently(server, paths, direct[:clients],
                                                   f"decode in the {variant}", device))
        out["concurrent"] = runs[0]
        out["concurrent_runs"] = runs
        if timed:
            from clip_embedder_tpu_torch.utils.images import to_rgb_array

            decoded = [to_rgb_array(j) for j in jpgs[:32]]

            def one_window():
                futs = [server._vision_batcher.submit(a) for a in decoded]
                for f in futs:
                    f.result()

            bd = device_breakdown(one_window)
            groups = ", ".join(f"{k} {g_ms:.3f}" for k, g_ms in sorted(
                bd["groups_ms"].items(), key=lambda kv: -kv[1]))
            say(f"  one micro-batch of 32 decoded JPEGs through the vision batcher (staging, "
                f"preprocess, tower) under torch.profiler: device ms by kernel group: "
                f"{groups}; busy {bd['busy_ms']:.3f} of {bd['wall_ms']:.3f} ms wall, idle "
                f"share {bd['idle_share']:.3f}")
            out["breakdown"] = bd
            # the host's share of a window, alone: the JPEG decode (in the
            # handlers) and the staging of the padded u8 batch and its resize
            # matrices (in the collector)
            from clip_embedder_tpu_torch import native

            t = time.perf_counter()
            arrays = [to_rgb_array(j) for j in jpgs[:32]]
            decode_ms = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            staged = clip.vision.preprocessor.stage_host_batch_unique(arrays)
            stage_ms = (time.perf_counter() - t) * 1e3
            say(f"  host work of that micro-batch alone (host clock): decode of the 32 JPEGs "
                f"{decode_ms:.2f} ms ({'libclippre' if native.available() else 'Pillow'}), "
                f"staging {stage_ms:.2f} ms (u8 batch {list(staged[0].shape)}, "
                f"{staged[0].nbytes / 2**20:.1f} MiB)")
            out["host_ms"] = {"decode": decode_ms, "stage": stage_ms}
    finally:
        server.close()
    return out


def decode_in_collector():
    """The JAX server's design on the port's server: single images reach the
    micro-batcher as the request's raw bytes, so its collector thread
    decodes them (inside ``embed_images``), one by one."""
    from unittest import mock

    from clip_embedder_tpu_torch import serving

    return mock.patch.object(serving, "to_rgb_array", lambda image: image)


# The concurrent clients, in a process of their own (as a deployment's
# clients are): one thread a request, released together; prints one JSON
# object with each row, each latency, the wall time and the failures. The
# threads use http.client: 64 threads calling urllib's urlopen at once each
# build an opener, each loading the CA store for its HTTPS handler, 2-3 s
# of client time in all.
CLIENTS = r"""
import http.client, json, sys, threading, time
host, port, paths = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
bodies = [open(p, "rb").read() for p in paths]
gate = threading.Barrier(len(bodies) + 1)
rows, lat, errors = [None] * len(bodies), [0.0] * len(bodies), []
def client(i):
    try:
        gate.wait()
        t0 = time.perf_counter()
        conn = http.client.HTTPConnection(host, port, timeout=300)
        try:
            conn.request("POST", "/v1/embed/image", body=bodies[i],
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        if resp.status != 200:
            raise RuntimeError(f"HTTP {resp.status}: {body[:200]!r}")
        rows[i] = json.loads(body)["embeddings"][0]
        lat[i] = time.perf_counter() - t0
    except Exception as e:
        errors.append(f"client {i}: {e!r}")
threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
for t in threads:
    t.start()
gate.wait()
t0 = time.perf_counter()
for t in threads:
    t.join(timeout=600)
wall = time.perf_counter() - t0
print(json.dumps({"rows": rows, "lat": lat, "wall": wall, "errors": errors,
                  "alive": sum(t.is_alive() for t in threads)}))
"""


def serve_concurrently(server, paths, direct, label, device) -> dict:
    """One single-JPEG request for each file of ``paths``, each from its own
    thread of a client process (``CLIENTS``), released together: all must
    succeed, in few micro-batches, with the direct call's rows; images/s
    served (the clients' clock, release to last reply), the server's
    p50/p95 from ``/v1/metrics`` (its counters set anew for this run) and
    the clients' own. Launch counts are only asserted to grow (plain
    ``+= 1`` from several threads)."""
    from clip_embedder_tpu_torch.serving import ServerMetrics

    clients = len(paths)
    server.metrics = ServerMetrics()  # /v1/metrics over this run alone
    before = server._vision_batcher.batches
    counts0 = launch_counts()
    host, port = server.address
    proc = subprocess.run([sys.executable, "-c", CLIENTS, host, str(port), *map(str, paths)],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"{label}: the client process failed: {proc.stderr[-2000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    if res["errors"] or res["alive"]:
        raise AssertionError(f"{label}: concurrent clients failed: {res['errors'][:4]}")
    wall = res["wall"]
    windows = server._vision_batcher.batches - before
    counts1 = launch_counts()
    grew = {k: counts1[k] - counts0[k] for k in ("ln_qkv", "flash_attention_packed")}
    cos = hold_rows(label, res["rows"], direct, SERVED_COSINE)
    ep = http(server, "/v1/metrics")["latency"]["/v1/embed/image"]
    ms = sorted(x * 1e3 for x in res["lat"])
    run = {"label": label, "clients": clients, "wall_s": wall, "images_per_s": clients / wall,
           "windows": windows, "p50_ms": ep["p50_ms"], "p95_ms": ep["p95_ms"],
           "client_p50_ms": ms[len(ms) // 2], "client_p95_ms": ms[int(len(ms) * 0.95)],
           "cosine": cos}
    say(f"  {clients} concurrent clients, one JPEG each, {label}: all served in {wall:.3f} s "
        f"({run['images_per_s']:.2f} images/s served) in {windows} micro-batches; rows "
        f"against the direct call min cosine {cos:.7f}; /v1/metrics p50 {ep['p50_ms']} ms, "
        f"p95 {ep['p95_ms']} ms over {ep['window']} requests; client p50 "
        f"{run['client_p50_ms']:.2f} ms, p95 {run['client_p95_ms']:.2f} ms; launches grew "
        f"{grew}")
    if windows > max(clients // 4, 2):
        raise AssertionError(f"{label}: {clients} concurrent requests took {windows} "
                             "micro-batches")
    if device == "cuda" and min(grew.values()) <= 0:
        raise AssertionError(f"{label}: no kernel launched under concurrent traffic: {grew}")
    return run


# the int8 sources: each runs its products on the s8 TMA + wgmma kernel
INT8_SOURCES = ("int8_mlp", "int8_mlp_streamed", "ln_qkv_int8", "int8_linear")


def int8_sass_report(libs) -> None:
    """Per int8 source: the ptxas warnings that say it serialized wgmma
    (C7512-C7514 in the build log) and the counts of IGMMA (int8 wgmma) and
    IMMA (an mma.sync int8 product) instructions in the built library's SASS
    (``cuobjdump -sass``). Fails if a source has no IGMMA or any IMMA, if
    ptxas serialized a wgmma, and if the build log or
    ``cuobjdump`` (beside nvcc, on PATH or in $CUDA_HOME/bin) is missing, so
    that the check never passes without looking."""
    import os
    import re
    import shutil

    from clip_embedder_tpu_torch.ops import cuda as kernels

    cands = (Path(kernels.find_nvcc()).with_name("cuobjdump"), shutil.which("cuobjdump"),
             Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    cuobjdump = next((Path(c) for c in cands if c and Path(c).is_file()), None)
    if cuobjdump is None:
        raise FileNotFoundError("cuobjdump not found (beside nvcc, PATH, $CUDA_HOME/bin): "
                                "the int8 SASS check cannot run")
    for stem in INT8_SOURCES:
        path = libs[stem]
        log = path.with_suffix(".log")
        if not log.is_file():
            raise FileNotFoundError(f"{stem}: no build log {log}")
        serial = sorted(set(re.findall(r"C751[234]", log.read_text())))
        sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        igmma = sum("IGMMA" in line for line in sass.splitlines())
        imma = len(re.findall(r"\bIMMA\.", sass))
        say(f"  {stem}: ptxas wgmma serialization warnings {serial or 'none'}; IGMMA "
            f"instructions in SASS: {igmma}; IMMA (mma.sync s8): {imma}")
        if igmma == 0 or imma or serial:
            raise AssertionError(f"{stem}: want int8 wgmma (IGMMA) in the built library, no "
                                 f"mma.sync s8 product (IMMA) and no serialized wgmma")


def main(argv) -> int:
    int8_only, masks_only = "--int8" in argv, "--masks" in argv
    say("[1] environment")
    if not torch.cuda.is_available():
        say("  torch.cuda.is_available() is false: this script needs an NVIDIA card")
        return 2
    card = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    say(f"  {card}")
    say(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, capability {cap[0]}.{cap[1]}, "
        f"count {torch.cuda.device_count()}")
    if cap != (9, 0):
        say("  the kernels are built for sm_90a: need compute capability 9.0")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    peaks = peaks_for(card)

    from clip_embedder_tpu_torch.ops import cuda as kernels

    say("[2] build")
    t = time.perf_counter()
    libs = kernels.build_all(INT8_SOURCES if int8_only else ("flash_packed",) if masks_only
                             else None)
    say(f"  built {sorted(libs)} in {time.perf_counter() - t:.1f} s (nvcc, sm_90a, "
        f"one process per source)")
    for stem, path in sorted(libs.items()):
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.is_file() else []):
            if "registers" in line or "spill" in line:
                say(f"  {stem}: {line.strip()}")
    if masks_only:  # the packed kernel's masked path alone: no result line
        mask_path_table(dev)
        say(card)
        return 0
    int8_sass_report(libs)
    if int8_only:  # a quick look at the int8 kernels alone: no result line
        phase_int8_kernels(dev, peaks)
        phase_streamed_mlp_kernel(dev, peaks)
        say(card)
        return 0

    record = phase_kernels(dev, peaks)
    record.update(phase_mask_kernels(dev, peaks))
    pe_attn = phase_pe_attention_kernels(dev, peaks)
    record["flash_attention"] = pe_attn["flash_attention"]
    record.update(phase_int8_kernels(dev, peaks))
    record.update(phase_streamed_mlp_kernel(dev, peaks))
    fixtures = phase_fixtures("cuda")
    main_path = phase_main_path("cuda")
    int8_paths = phase_int8_paths("cuda", bf16_embeddings=main_path["embeddings"])
    pe_core = phase_pe_core("cuda")
    masked = phase_masked_towers("cuda")
    serving = phase_serving("cuda")
    # launches: each kernel's count from its own path's run: the fixtures
    # for flash_attention, SO400M bf16 for ln_qkv and the packed kernel,
    # SO400M int8_all for kernels 4-6, PE-Core int8_all for the streamed MLP,
    # the packed kernel's masked forms from phase 8's text towers (one
    # embed_texts plus one classify: BiomedCLIP's key rows, CoCa's blocks)
    record["flash_attention"]["launches"] = fixtures["flash_attention"]
    for name, n in main_path["launches"].items():
        record[name]["launches"] = n
    for name in INT8_WRAPPERS:
        record[name]["launches"] = int8_paths["int8_all"]["launches"][name]
    record["int8_mlp_streamed"]["launches"] = pe_core["int8_all"]["launches"][
        "int8_mlp_streamed"]
    for run in ("BiomedCLIP bfloat16", "coca_ViT-L-14 bfloat16"):
        form = masked[run]["form"]
        record[f"flash_attention_packed[{form}_mask]"]["launches"] = \
            masked[run]["mask_launches"][form]
    rope = pe_attn["rope"]
    say(f"flash_attention_packed with rope (PE-Core-bigG): {rope['ms']:.4f} ms, plain "
        f"{rope['plain_ms']:.4f} ms, library {rope['library_ms']:.4f} ms, bound "
        f"{rope['bound_ms']:.4f} ms (SDPA alone {rope['sdpa_ms']:.4f} ms), max_abs_err "
        f"{rope['max_abs_err']:.3e}; launches "
        f"{pe_core['bfloat16']['launches']['flash_attention_packed']} on PE-Core bf16 (of them "
        f"{2 * pe_core['bfloat16']['vision_layers']} in the vision blocks, with rope: derived "
        f"from the depth, not counted)")
    conc = serving["concurrent"]
    say(f"phase 9: checkpoint → model dir in {sum(serving['convert_s'].values()):.2f} s "
        f"({', '.join(f'{k} {v:.2f}' for k, v in serving['convert_s'].items())}), loaded in "
        f"{serving['load_s']:.2f} s, warmed up in {serving['warmup_s']:.2f} s; "
        f"{conc['clients']} concurrent single-image requests: {conc['images_per_s']:.2f} "
        f"images/s served, p50 {conc['p50_ms']} ms, p95 {conc['p95_ms']} ms (/v1/metrics), "
        f"{conc['windows']} micro-batches; images/s by run ("
        + ", ".join(f"{r['label']} {r['images_per_s']:.2f}" for r in serving["concurrent_runs"])
        + f"); one micro-batch idle share {serving['breakdown']['idle_share']:.3f}; {card}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    say(card)
    say(json.dumps({"kernels": [{k: rec[k] for k in keys} for rec in record.values()]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

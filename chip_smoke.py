#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (``clip_embedder_tpu_torch``) on one NVIDIA
card, in phases, and fail loudly if any phase fails.

    python3 chip_smoke.py          # every phase
    python3 chip_smoke.py --int8   # phases 1-2 for the int8 sources, phase 3's int8 kernels
    python3 chip_smoke.py --masks  # phases 1-2 for flash_packed, its time by mask form
    python3 chip_smoke.py --options  # phases 1-2 for kernel 2's sources, phase 3's options
    python3 chip_smoke.py --rows   # phases 1-2 for block_rows, phase 3's row kernels

1. environment — the card's name and power limit, torch/CUDA versions, the
   compute capability (must be 9.0);
2. build — every ``csrc/*.cu`` kernel compiled with nvcc for sm_90a; for
   the four int8 sources, ``flash_int8.cu`` and ``flash_int8_tma.cu``,
   ptxas's wgmma-serialization
   warnings and the int8 wgmma (IGMMA) and mma.sync (IMMA) instructions in
   their SASS (a warning, no IGMMA or any IMMA fails);
3. kernels — each kernel against its plain PyTorch version at the main
   paths' shapes (max error beside the tolerance), and its time (CUDA
   events, median of 20) beside the plain version's, one PyTorch library
   call's or, for the int8 kernels, a composition of PyTorch ops around
   ``torch._int_mm`` (a yardstick the port never calls) and the bound, and
   for the int8 kernels their device time by launch (row passes against
   products): the packed attention kernel also with PE-Core's rope, the
   [B, H, S, D] attention kernel at the fixtures' and at SO400M's head
   layout, ``ln_qkv_int8`` and ``int8_linear_fused`` also at PE-Core-bigG's
   vision width, the streamed int8 MLP at PE-Core-bigG's; kernel 2's
   options (``quant_qk``, ``quant_pv``: in bf16 with D a multiple of 8 on
   ``csrc/flash_int8_tma.cu``, in f32 and at other D on
   ``csrc/flash_int8.cu``; ``mxu_denom``, ``pair_exp``, ``group_mult``),
   which no path sets: every flag set against the plain version at
   SO400M's shape in bf16 and f32, the int8 ones with PE-Core-bigG's rope,
   at the three mask forms' shapes and, on the TMA route, each with and
   without ``fast_softmax`` / ``exp_bf16`` at D = 64, 72, 96, 128 over
   ragged S, the schedule ones (which the card ignores) bitwise against
   the default launch, both routes' int8 codes against the plain version's
   (all equal), and the int8 ones' batch-32 times at SO400M's and
   PE-Core's shapes (the first route's in f32) with their device time by
   launch and the route that ran; the port's own row kernels
   (``norm_rows``, ``act_rows``: a block's LayerNorm and MLP activation in
   one pass each) against ``ops.layers``' plain functions at SO400M's and
   PE-Core-bigG's batch-32 shapes, with their times beside the bytes bound;
4. fixtures — ``tests/fixtures/golden_siglip`` and ``golden_model`` through
   ``Clip.from_local_dir(..., device="cuda")`` in f32 against their golden
   embeddings and classify results (4 heads x 16: no 128-lane head group, so
   their attention takes ``flash_attention``, kernel 3); ``golden_siglip``
   under ``quantize="int8"`` and ``"int8_all"`` against the same on the CPU;
5. main path — ViT-SO400M-16-SigLIP2-384 (vision + SigLIP text tower) at
   full width and depth with seeded random bf16 weights through ``Clip``
   (the vision config from ``models/zoo.py``, held equal to the one the
   open_clip config resolves to):
   ``embed_images`` on a mixed-size batch of the JPEGs under ``assets/img``
   and ``classify``, cold (each bucket's first call: the graph's warm-up
   forward and a replay) and then warm; unit norms, launch counts (27 per
   tower forward run, per kernel: 54 a vision call cold, 27 warm), one
   replay under the profiler,
   kernel-vs-plain cosine, images/s at batch 32 and the p50 latency of one
   image;
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
   one micro-batch under torch.profiler;
10. the other vision families — MobileCLIP2-S4 (FastViT MCi4) in bf16 and
   ``"int8"``, EVA02-L-14-336 in bf16 and ``"int8_all"``,
   convnext_large_d_320 (the ``mlp`` head) in bf16 and ``"int8"``, and RN50
   (ModifiedResNet) in bf16, at full width and depth with seeded random
   weights through ``Clip``: ``embed_images``, ``embed_texts`` and
   ``classify``, launch counts per call, both towers held against the plain
   path, images/s, the p50 of one image, texts/s, and device time by kernel
   group (cuDNN's convolutions as their own group).
11. the ONNX path — CLIP-ViT-B-32 (as open_clip names it) and the
   MobileCLIP-S0 scale (FastViT fastvit_mci0 at 256, the MCT hybrid text
   tower) at full width and depth, exported from the torch mirrors of
   ``tests/`` to reference-format ONNX dirs (f32, seeded random weights)
   and converted on the card by ``Clip.from_local_dir``: the route each
   tower took (vit + text_transformer, fastvit + mct; no executor fallback,
   no unverified conversion), both towers against the mirrors in f32
   (cosine 0.999, classify's order), launch counts per call, kernel path
   against plain, ViT-B-32 under ``int8_all`` and the MCT tower under
   ``int8``, the graph executor (``onnx_exec``) on each graph against the
   mirror (1 - 1e-5, f32), images/s, p50 and texts/s of the converted
   towers and of the executor (its towers captured per batch bucket, their
   rows held to the eager executor's), the converted ViT-B-32's device time
   by kernel group. Phase 3 holds and times kernels 1, 2 and 4-6 at its
   shapes.
12. the sharded path — ViT-SO400M-16-SigLIP2-384 at full width and depth
   (phase 5's seeded bf16 weights) through ``clip_embedder_tpu_torch.parallel``
   on meshes of two entries of one card: ``get_mesh()`` over the visible
   cards; ``ShardedVisionEmbedder`` DP in bf16 and ``int8_all`` (exact launch
   counts over two shards, rows against the unsharded embedder at cosine
   1 - 1e-3, images/s and p50 beside the unsharded ones); TP over the model
   axis (the eager core: no kernel launched, the override warned; refused
   for ``int8_all``; its one row on one card replays the ``TPViT``'s CUDA
   graph, whose rows are held to the ``TPViT`` called eagerly, and timed
   against it: images/s, p50, idle share, capture seconds, the graph's
   pool); ``ShardedTextEmbedder``; ``EmbedPipeline`` over 256
   JPEGs against a loop; ``CorpusIndex`` over 2^20 x 1152 f32 unit rows
   against a dense ``torch.matmul`` + ``topk``, its captured search against
   the eager one (ids equal, scores within 1e-6); ``ClipServer(mesh=)``: one
   client through every endpoint, then 64 concurrent clients.
13. training — ViT-SO400M-16-SigLIP2-384 at full width and depth through
   ``clip_embedder_tpu_torch.train`` (f32, SigLIP loss, remat, lr 1e-5,
   seeded random init, a fixed seeded batch of 16), the step captured (one
   CUDA graph of the forward, the backward and the capturable AdamW) and
   each run held against the eager step (``train.eager_train_step``) from
   the same initial state, losses and every stepped tensor: five unsharded
   steps (the loss descends; s/step, samples/s, peak memory, one step under
   torch.profiler and the graph's pool, captured against eager), the
   captured step held a step at a time against torch's lazy AdamW
   (``capturable=False``, the optimizer code the CPU holds to optax) from
   the same state, three steps: losses and moments bitwise equal, each
   parameter within 2e-5 of its update; three in bf16 (the loss
   descends); two steps each of DP, the ring loss, FSDP and TP on meshes of
   two entries of one card from the same initial state, captured against
   eager, each within rtol 1e-4 of the unsharded loss; no kernel launched
   on the way; the trained tree exported into a model dir and served
   through ``Clip`` in bf16 (27 launches each of kernels 1 and 2 a tower call),
   held against the eager impl at cosine 0.999 and printed against the
   trained tree's own f32 forward; a q that requires grad refused by kernel
   2's wrapper.
14. captured forwards (``utils.captured``) — phase 5's SO400M (bf16 and
   ``int8_all``, both towers), PE-Core-bigG (bf16 and ``int8``), BiomedCLIP's
   BERT text tower, phase 10's four vision towers and phase 11's
   CLIP-ViT-B-32 graphs run by the ONNX executor (both towers), at full
   width and depth: each tower's rows (the card replays one CUDA graph a batch
   bucket) against its eager forward, the tower module called directly,
   at cosine 1 - 1e-6 (bitwise equality printed), the launch counts of the
   first call twice one eager forward's (the warm-up and the replay), of
   the next call one eager forward's; two batches in turn, and
   the first call's rows unchanged after the later replays; two threads of
   50 calls each; a new bucket captured while another thread runs eager
   forwards; the graphs and their capture seconds per bucket; images/s
   at batch 32, the p50 of one image, texts/s and the idle share, captured
   against eager, and for the vision towers also the captured tower after
   the plain preprocess; for SO400M and PE-Core the reserved memory with and
   without the layer. Each vision tower's captured preprocess
   (``Preprocessor.run``: reused staging, the resize replayed) is held
   to the plain route (``Preprocessor.eager``) with ``torch.equal``, every
   row of the bucket, on two batches of different padded sizes (768 x
   1024, 512 x 640) in turn and back, then on fewer images in the same
   bucket, and timed: alone against the plain route, and split into host
   staging (also with the padded rows zeroed), the copy and the replay,
   beside its graphs and their pool.

From phase 4 on, every ``embed_images`` / ``embed_texts`` / ``classify``,
and phase 12's DP shards and TP row, run through the captured layer on the
card, the preprocess included, as does phase 13's train step (a
graph's replay adds the launches its capture recorded; a bucket's first
call also counts its warm-up forward's); each plain path (eager attention,
the plain int8 wrappers) calls the tower modules directly after the plain
preprocess (``eager_rows``), as a graph captured with the kernels would
replay them. Before any launch
count is read, every graph captured so far is held to the kernels it
holds (``hold_graphs``: its kernel nodes, from CUDA's driver API, by the
source each kernel's name carries), so that what a replay adds to the
counts is what it launches; phase 5 also profiles one replay of a
graph. Phases 6-13 warm a call's buckets first (``warm``, as
``serving.warmup`` does), so that their counted calls run one forward
each.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of the
repo beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
import weakref
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

# Phase 10's models. timm/MobileCLIP2-S4-OpenCLIP as the repo records it
# (tests/test_reference_model_list.py; reference README.md:137): FastViT MCi4
# at 256, text 16 x 768. MCi4 is the fastvit_mci4 table row of the JAX
# package (4 stages, 44 blocks, 128-1024 channels, attention in the last
# stage), whose dims no timm source or real checkpoint has confirmed: the
# label names the config, not a published S4 shown to match.
MOBILECLIP2_S4 = {
    "embed_dim": 768,
    "vision_cfg": {"image_size": 256, "timm_model_name": "fastvit_mci4", "timm_proj": "none"},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 768, "heads": 12,
                 "layers": 16},
}
# open_clip model_configs/EVA02-L-14-336.json: 24 x 1024, 16 x 64 heads, SwiGLU
# 2730, patch 14 at 336 (577 tokens); the trunk's own head projects to 768.
EVA02_L_14_336 = {
    "embed_dim": 768,
    "vision_cfg": {"image_size": 336, "timm_model_name": "eva02_large_patch14_clip_336",
                   "timm_pool": "token", "timm_proj": None},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 768, "heads": 12,
                 "layers": 12},
}
# open_clip model_configs/convnext_large_d_320.json: convnext_large at 320, the
# mlp head (1536 -> 1536 -> 768), text 16 x 768.
CONVNEXT_LARGE_D_320 = {
    "embed_dim": 768,
    "vision_cfg": {"image_size": 320, "timm_model_name": "convnext_large", "timm_pool": "",
                   "timm_proj": "mlp"},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 768, "heads": 12,
                 "layers": 16},
}
# open_clip model_configs/RN50.json: ModifiedResNet [3, 4, 6, 3] at width 64
# and 224 (attention pool: 32 heads over 50 tokens), text 12 x 512.
RN50 = {
    "embed_dim": 1024,
    "vision_cfg": {"image_size": 224, "layers": [3, 4, 6, 3], "width": 64},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 512, "heads": 8,
                 "layers": 12},
}
# label, config, the modes run
FAMILY_MODELS = (
    ("MobileCLIP2-S4", MOBILECLIP2_S4, (None, "int8")),
    ("EVA02-L-14-336", EVA02_L_14_336, (None, "int8_all")),
    ("convnext_large_d_320", CONVNEXT_LARGE_D_320, (None, "int8")),
    ("RN50", RN50, (None,)),
)


def say(*parts) -> None:
    print(*parts, flush=True)


def fmt_ms(ms, digits: int) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


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


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device ms of one call of ``fn``: ``calls`` calls captured in one CUDA
    graph, as the towers run them (no host work between the launches; a
    wrapper's Python can outlast a short kernel), CUDA events around each
    of ``replays`` replays, the median over ``calls``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # loads the kernel's module outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def max_err(got, ref) -> float:
    return max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))


def hold(name, got, ref, atol, rtol, cos_min=None) -> float:
    """Fail unless |got - ref| <= atol + rtol·|ref| everywhere (and, with
    ``cos_min``, every row along the last axis keeps that cosine to its
    reference row)."""
    err = max_err(got, ref)
    ok = all(bool(((g.float() - r.float()).abs()
                   <= atol + rtol * r.float().abs()).all()) for g, r in zip(got, ref))
    note = ""
    if cos_min is not None:
        cos = min(float(torch.nn.functional.cosine_similarity(
            g.float().reshape(-1, g.shape[-1]), r.float().reshape(-1, r.shape[-1]), dim=-1).min())
            for g, r in zip(got, ref))
        ok = ok and cos >= cos_min
        note = f", min row cosine {cos:.8f} (need >= {cos_min:g})"
    say(f"  {name}: max_abs_err={err:.3e} (tol atol={atol:g} rtol={rtol:g}){note} "
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


def row_inputs(shape, dtype, dev, seed=0):
    """x of ``shape`` and a LayerNorm over its last axis, in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2.5 + 0.3).to(dtype)
    w = shape[-1]
    ln = {"scale": (1 + 0.2 * torch.randn(w, generator=g, device=dev)).to(dtype),
          "bias": (0.2 * torch.randn(w, generator=g, device=dev)).to(dtype)}
    return ln, x


# label, rows at batch 32, width, MLP hidden, activation
ROW_MODELS = (("SO400M", 32 * 576, 1152, 4304, "gelu_tanh"),
              ("PE-Core-bigG", 32 * 1025, 1536, 8960, "gelu"))


def phase_row_kernels(dev, peaks) -> dict:
    """``norm_rows`` and ``act_rows`` (``csrc/block_rows.cu``, the port's own
    kernels) against ``ops.layers``' plain functions at SO400M's and
    PE-Core-bigG's batch-32 shapes, bf16 within one rounding step (2^-7 of
    the value) and f32, every activation; then their bf16 device times
    (``graph_ms``) beside the plain function's, one PyTorch call's
    (``F.layer_norm``; ``F.gelu`` on the bf16 tensor, which the port does
    not call) and the bound: every element read once and written once (and
    the LayerNorm's f32 scale and shift read once) over the card's bytes/s."""
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops import layers, rows

    say("[3] norm_rows and act_rows against ops.layers' plain functions (bf16: atol 1e-5, "
        "rtol 2^-7, one rounding step; f32: 1e-5 LayerNorm, 1e-6 activations)")
    for label, r, w, hidden, _ in ROW_MODELS:
        for dtype in (torch.bfloat16, torch.float32):
            bf = dtype == torch.bfloat16
            ln, x = row_inputs((r, w), dtype, dev)
            got = rows.norm_rows(ln, x, eps=1e-6)
            torch.cuda.synchronize()
            hold(f"norm_rows {label} [{r}, {w}] {dtype}", [got],
                 [layers.layer_norm(ln, x, eps=1e-6)], 1e-5, 2 ** -7 if bf else 1e-5)
            _, h = row_inputs((r, hidden), dtype, dev, seed=1)
            for name in rows.ACT_CODES:
                got = rows.act_rows(h, name)
                torch.cuda.synchronize()
                hold(f"act_rows {name} {label} [{r}, {hidden}] {dtype}", [got],
                     [layers.ACTIVATIONS[name](h)], 1e-5 if bf else 1e-6,
                     2 ** -7 if bf else 1e-6)
    say("[3] norm_rows and act_rows times at batch 32, bf16 (device time: 20 calls captured "
        "in a CUDA graph, median of 10 replays; bound: bytes once over the card's bytes/s)")
    out = {}
    for label, r, w, hidden, act in ROW_MODELS:
        ln, x = row_inputs((r, w), torch.bfloat16, dev)
        _, h = row_inputs((r, hidden), torch.bfloat16, dev, seed=1)
        approximate = "tanh" if act == "gelu_tanh" else "none"
        runs = (("norm_rows", lambda: rows.norm_rows(ln, x, eps=1e-6),
                 lambda: layers.layer_norm(ln, x, eps=1e-6),
                 lambda: F.layer_norm(x, (w,), ln["scale"], ln["bias"], 1e-6), "F.layer_norm",
                 4 * r * w + 8 * w, f"[{r}, {w}]"),
                ("act_rows", lambda: rows.act_rows(h, act), lambda: layers.ACTIVATIONS[act](h),
                 lambda: F.gelu(h, approximate=approximate), f"F.gelu({approximate})",
                 4 * r * hidden, f"[{r}, {hidden}] {act}"))
        for name, kern, plain, lib, lib_name, nbytes, shape in runs:
            err = max_err([kern()], [plain()])
            ms, plain_ms, lib_ms = graph_ms(kern), graph_ms(plain), graph_ms(lib)
            bound = nbytes / peaks["bytes"] * 1e3
            say(f"  {name} {label} {shape}: {ms:.4f} ms; plain {plain_ms:.4f} ms; {lib_name} "
                f"{lib_ms:.4f} ms; bound {bound:.4f} ms ({nbytes:.3e} B), "
                f"{100 * bound / ms:.1f}% of it")
            key = name if label == "SO400M" else f"{name}[pe_core]"
            out[key] = {"name": name, "route": "cuda",
                        "source": "clip_embedder_tpu_torch/csrc/block_rows.cu",
                        "replaces": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms}
    return out


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


# kernel 2's options: tools/profile_attn_variants.py's flag sets, and each
# option alone (none of them is set on any path of either package)
FLASH_OPTIONS = {
    "exp_bf16": {"exp_bf16": True}, "quant_qk": {"quant_qk": True},
    "quant_qk+exp_bf16": {"quant_qk": True, "exp_bf16": True}, "fast": {"fast_softmax": True},
    "fast+exp_bf16": {"fast_softmax": True, "exp_bf16": True},
    "fast+pair_exp": {"fast_softmax": True, "pair_exp": True}, "pair_exp": {"pair_exp": True},
    "fast+group_mult2": {"fast_softmax": True, "group_mult": 2},
    "fast+pair+gm2": {"fast_softmax": True, "pair_exp": True, "group_mult": 2},
    "quant_pv": {"quant_pv": True}, "quant_qk+quant_pv": {"quant_qk": True, "quant_pv": True},
    "quant_pv+fast+exp_bf16": {"quant_pv": True, "fast_softmax": True, "exp_bf16": True},
    "mxu_denom=False": {"mxu_denom": False}, "group_mult2": {"group_mult": 2},
}
# the int8 variants the kernels' record times (SO400M, batch 32: bf16 on the
# TMA route, f32 on the first one)
FLASH_TIMED = {"quant_qk": "qk", "quant_pv": "pv", "quant_qk+quant_pv": "both"}
INT8_ROUTE_SOURCES = {"int8_tma": "clip_embedder_tpu_torch/csrc/flash_int8_tma.cu",
                      "int8_wgmma": "clip_embedder_tpu_torch/csrc/flash_int8.cu"}


def option_route(d, dtype, opts) -> str:
    """The kernel that kernel 2's wrapper picks for ``opts``."""
    from clip_embedder_tpu_torch.ops import flash

    quant = bool(opts.get("quant_qk") or opts.get("quant_pv"))
    return flash.kernel_route(d, dtype, quant=quant, mxu_denom=opts.get("mxu_denom", True))


def int8_attn_bound(b, h, s, d, peaks, opts, *, es=2, route="int8_tma") -> tuple:
    """(bound ms, bound_by, s8 op, bf16 FLOP, bytes, the design's bytes) of
    an int8 attention call on operands of ``es`` bytes an element. The
    function's floor: the quantized products' operations at the int8 peak
    plus the others' at the bf16 peak (f32 operands: the f32 peak), against
    q, k and v read and out written once, and for ``quant_pv`` one more read
    of v (its per-column scales span every row before the first product).
    q's codes are per row and k's scale can be taken while pass 1 reads k,
    so codes need not pass through memory. The design's bytes, printed
    beside the bound and not in it, add what its code pass writes and the
    attention reads back (codes with S and D padded to 64 and 32, their
    scales): on ``route`` "int8_tma" the prep pass reads each quantized one
    of k and v once more and writes its codes, which the attention streams
    in place of it (q's codes are made in the attention kernel); on
    "int8_wgmma" the pre-pass writes q's and k's codes too."""
    bh, sp, dp = b * h, -(-s // 64) * 64, -(-d // 32) * 32
    product = 2 * bh * s * s * d
    n8 = product * (bool(opts.get("quant_qk")) + bool(opts.get("quant_pv")))
    n16 = 2 * product - n8
    operand = b * s * h * d * es
    nbytes = 4 * operand + (operand if opts.get("quant_pv") else 0)
    design = 4 * operand
    if route == "int8_tma":
        for on, scales in ((opts.get("quant_qk"), bh), (opts.get("quant_pv"), bh * dp)):
            if on:  # the prep pass's read, its codes written and read back, its scales
                design += operand + 2 * bh * sp * dp + 4 * scales
    else:
        if opts.get("quant_qk"):
            design += 2 * (2 * bh * sp * dp + bh * sp * 4 + bh * 4)
        if opts.get("quant_pv"):
            design += 2 * (bh * dp * sp + bh * dp * 4)
    peak16 = peaks["bf16"] if es == 2 else peaks["f32"]
    t_ops = n8 / peaks["int8"] + n16 / peak16
    t_bytes = nbytes / peaks["bytes"]
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes", n8, n16,
            nbytes, design)


def route_delta(before: dict) -> str:
    """The int8 launches since ``before`` (``route_launches``), by route and
    form: which int8 kernel ran."""
    from clip_embedder_tpu_torch.ops import flash

    now = flash.flash_attention_packed.route_launches
    moved = {k: now[k] - before[k] for k in now if now[k] != before[k]}
    return ", ".join(f"{k} +{v}" for k, v in moved.items()) or "no int8 launch"


def phase_flash_options(dev, peaks) -> dict:
    """Kernel 2's options (``quant_qk``, ``quant_pv``, ``mxu_denom``,
    ``pair_exp``, ``group_mult``), none of which any path sets: each flag
    set against the plain version at SO400M's shape [8, 576, 16x72] in bf16
    and f32, quant_qk / quant_pv (and both) with PE-Core-bigG's rope [8,
    1025, 16x96] and at the three mask forms' shapes, on the int8 TMA route
    each variant with and without fast_softmax / exp_bf16 at D = 64, 72,
    96, 128 over ragged S (577, 1025) and on the first int8 route at D = 36,
    group_mult / pair_exp (ignored on the card) bitwise against the default
    launch, both int8 routes' codes against the plain version's, then the
    int8 variants' times at batch 32 (SO400M and PE-Core-bigG with rope in
    bf16 on the TMA route, SO400M in f32 on the first route) beside the
    plain version and the bound (no PyTorch call computes int8 attention:
    library null), their device time by launch and the route that ran."""
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops import flash
    from clip_embedder_tpu_torch.ops.attention import causal_mask
    from clip_embedder_tpu_torch.ops.rope import axial_rope_table, head_tiled_tables

    counts = flash.flash_attention_packed.route_launches

    def held(label, q, k, v, h, tol=2e-2, **kw):
        before = dict(counts)
        got = flash.flash_attention_packed(q, k, v, num_heads=h, **kw)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: non-finite output")
        return hold(f"{label} [{route_delta(before)}]", [got],
                    [flash.flash_attention_packed_plain(q, k, v, num_heads=h, **kw)], tol, tol)

    say("[3] flash_attention_packed's options against the plain version (bf16 2e-2, f32 2e-5)")
    heads, seq, hdim = 16, 576, 72
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        q, k, v = attn_inputs(8, heads, seq, hdim, dtype, dev, seed=12)
        for name, kw in FLASH_OPTIONS.items():
            held(f"flash_attention_packed B=8 S=576 16x72 {name} {dtype} "
                 f"({option_route(hdim, dtype, kw)})", q, k, v, heads, tol, **kw)
    quants = ("quant_qk", "quant_pv", "quant_qk+quant_pv")
    modes = {"": {}, "+fast": {"fast_softmax": True}, "+exp_bf16": {"exp_bf16": True},
             "+fast+exp_bf16": {"fast_softmax": True, "exp_bf16": True}}
    say("[3] the int8 routes' variants: each softmax mode, ragged S, the TMA route's head dims "
        "and one the first route takes (bf16 2e-2)")
    for b, s, h, d in ((4, 577, 16, 64), (4, 577, 16, 72), (2, 1025, 16, 96), (2, 1025, 8, 128),
                       (4, 577, 16, 36)):
        q, k, v = attn_inputs(b, h, s, d, torch.bfloat16, dev, seed=16)
        for name in quants:
            for mode, mkw in modes.items():
                held(f"flash_attention_packed [{b}, {s}, {h}x{d}] {name}{mode} bf16", q, k, v, h,
                     **FLASH_OPTIONS[name], **mkw)
    grid, pe_heads, pe_dim = 32, 16, 96
    pe_seq = grid * grid + 1
    rope = tuple(t.to(dev) for t in head_tiled_tables(
        axial_rope_table(grid, pe_dim, order="xy", prefix=1), pe_heads))
    q, k, v = attn_inputs(8, pe_heads, pe_seq, pe_dim, torch.bfloat16, dev, seed=13)
    for name in quants:
        for mode in ("", "+fast+exp_bf16"):
            held(f"flash_attention_packed+rope B=8 S=1025 16x96 {name}{mode} bf16", q, k, v,
                 pe_heads, rope=rope, **FLASH_OPTIONS[name], **modes[mode])
    codes = {"SO400M [8, 576, 16x72] bf16": attn_inputs(8, heads, seq, hdim, torch.bfloat16, dev,
                                                        seed=12) + [None],
             "PE-Core-bigG with rope [8, 1025, 16x96] bf16": [q, k, v, rope],
             "SO400M [8, 576, 16x72] f32": attn_inputs(8, heads, seq, hdim, torch.float32, dev,
                                                       seed=12) + [None]}
    for label, (cq, ck, cv, crope) in codes.items():
        h = heads if crope is None else pe_heads
        got = flash.quant_codes(cq, ck, cv, num_heads=h, rope=crope)
        ref = flash.quant_codes_plain(cq, ck, cv, num_heads=h, rope=crope)
        agree = {n: float((got[n] == ref[n]).float().mean()) for n in ("q", "k", "v")}
        scales = all(torch.equal(got[n], ref[n]) for n in ("q_scale", "k_scale", "v_scale"))
        route = flash.kernel_route(cq.shape[-1] // h, cq.dtype, quant=True)
        say(f"  int8 codes, {route} against the plain version, {label}: share equal q "
            f"{agree['q']:.8f}, k {agree['k']:.8f}, v {agree['v']:.8f} (of "
            f"{got['q'].numel()} each); scales equal: {scales}")
        if min(agree.values()) < 1.0 or not scales:
            raise AssertionError(f"{route}'s int8 codes differ from the plain version's")
    for form, (b, s, h, d) in (("shared causal", (5, 72, 20, 64)), ("key", (32, 256, 12, 64)),
                               ("full", (32, 77, 12, 64))):
        mask = (causal_mask(s, device=dev) if form == "shared causal" else
                key_mask(b, s, dev) if form == "key" else full_mask(b, s, dev))
        mq, mk, mv = attn_inputs(b, h, s, d, torch.bfloat16, dev, seed=14)
        for name in quants:
            for mode in ("", "+fast"):
                held(f"flash_attention_packed {form} mask [{b}, {s}, {h}x{d}] {name}{mode} bf16",
                     mq, mk, mv, h, mask=mask, **FLASH_OPTIONS[name], **modes[mode])
    for label, (bq, bk, bv, brope, h) in (
            ("SO400M bf16", (*attn_inputs(8, heads, seq, hdim, torch.bfloat16, dev, seed=15),
                             None, heads)),
            ("SO400M f32", (*attn_inputs(8, heads, seq, hdim, torch.float32, dev, seed=15),
                            None, heads)),
            ("PE-Core-bigG rope bf16", (q, k, v, rope, pe_heads))):
        for fast in (False, True):
            base = flash.flash_attention_packed(bq, bk, bv, num_heads=h, rope=brope,
                                                fast_softmax=fast)
            for kw in ({"pair_exp": True}, {"group_mult": 2}, {"group_mult": 2, "pair_exp": True},
                       {"group_mult": 4}):
                got = flash.flash_attention_packed(bq, bk, bv, num_heads=h, rope=brope,
                                                   fast_softmax=fast, **kw)
                torch.cuda.synchronize()
                same = torch.equal(got, base)
                say(f"  {label} fast={fast} {kw}: bitwise the default launch: {same}")
                if not same:
                    raise AssertionError(f"{label} {kw} differs from the default launch")

    say("[3] flash_attention_packed's int8 options at batch 32 (CUDA events, median of 20)")
    b = 32
    q, k, v = attn_inputs(b, heads, seq, hdim, torch.bfloat16, dev, seed=6)
    t_exact = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads))
    t_mma = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads,
                                                         mxu_denom=False))
    qh, kh, vh = (t.unflatten(-1, (heads, hdim)).transpose(1, 2) for t in (q, k, v))
    t_sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    say(f"  SO400M [32, 576, 16x72] bf16: exact (TMA + wgmma, warp-specialized) {t_exact:.4f} "
        f"ms; mxu_denom=False (the mma.sync kernel) {t_mma:.4f} ms; "
        f"F.scaled_dot_product_attention {t_sdpa:.4f} ms")
    pq, pk, pv = attn_inputs(b, pe_heads, pe_seq, pe_dim, torch.bfloat16, dev, seed=6)
    prope = tuple(t.to(dev) for t in head_tiled_tables(
        axial_rope_table(grid, pe_dim, order="xy", prefix=1), pe_heads))
    t_pe = cuda_ms(lambda: flash.flash_attention_packed(pq, pk, pv, num_heads=pe_heads,
                                                        rope=prope))
    say(f"  PE-Core-bigG [32, 1025, 16x96] with rope bf16: exact {t_pe:.4f} ms")
    fq, fk, fv = attn_inputs(b, heads, seq, hdim, torch.float32, dev, seed=6)
    cases = {"int8_tma": ("SO400M [32, 576, 16x72] bf16", q, k, v, heads, None, 2, t_exact),
             "int8_tma PE": ("PE-Core-bigG [32, 1025, 16x96] rope bf16", pq, pk, pv, pe_heads,
                             prope, 2, t_pe),
             "int8_wgmma": ("SO400M [32, 576, 16x72] f32", fq, fk, fv, heads, None, 4, None)}
    out = {}
    for key, (label, cq, ck, cv, h, crope, es, t_ref) in cases.items():
        d = cq.shape[-1] // h
        for name in FLASH_TIMED:
            kw = FLASH_OPTIONS[name]
            route = option_route(d, cq.dtype, kw)

            def kernel():
                return flash.flash_attention_packed(cq, ck, cv, num_heads=h, rope=crope, **kw)

            err = held(f"flash_attention_packed {label} {name}", cq, ck, cv, h,
                       2e-2 if es == 2 else 2e-5, rope=crope, **kw)
            t_k = cuda_ms(kernel)
            t_p = cuda_ms(lambda: flash.flash_attention_packed_plain(
                cq, ck, cv, num_heads=h, rope=crope, **kw), iters=5)
            bound, by, n8, n16, nbytes, design = int8_attn_bound(
                b, h, cq.shape[1], d, peaks, kw, es=es, route=route)
            ratio = f"{t_k / t_ref:.3f}x exact; " if t_ref else ""
            say(f"  {label} {name}: {t_k:.4f} ms ({ratio}{route}); plain {t_p:.4f} ms (median "
                f"of 5); library none (no PyTorch call computes int8 attention); bound "
                f"{bound:.4f} ms ({n8:.3e} int8 op, {n16:.3e} {'bf16' if es == 2 else 'f32'} "
                f"FLOP, {nbytes:.3e} B, {by}); this design moves {design:.3e} B with its codes "
                f"({design / peaks['bytes'] * 1e3:.4f} ms)")
            launch_breakdown(f"  {label} {name}", kernel)
            row = f"flash_attention_packed[{name}]" if key == "int8_tma" else \
                f"flash_attention_packed[{name}, {'PE-Core rope' if 'PE' in key else route}]"
            out[row] = {
                "name": row, "route": "cuda", "source": INT8_ROUTE_SOURCES[route],
                "replaces": "clip_embedder_tpu/ops/flash.py:308", "max_abs_err": err, "ms": t_k,
                "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                "library_ms": None,  # no PyTorch call computes int8 attention
                "route_form": f"{route} {FLASH_TIMED[name]}"}
    return out


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
    return (y if residual is None else y + residual.float()).to(x.dtype)


def ln_qkv_int8_library(s_cat, b_cat, w_cm, pre_ln, x, eps):
    import torch.nn.functional as F

    w = x.shape[-1]
    y = F.layer_norm(x.float(), (w,), pre_ln["scale"].float(), pre_ln["bias"].float(), eps)
    yq, xs = _lib_row_quant(y)
    o = torch._int_mm(yq, w_cm).float() * (xs * s_cat) + b_cat
    return o.to(x.dtype).split(w, dim=-1)


def int8_mlp_library(p, w1_cm, w2_cm, pre_ln, x, eps, approximate="tanh"):
    import torch.nn.functional as F

    w = x.shape[-1]
    y = F.layer_norm(x.float(), (w,), pre_ln["scale"].float(), pre_ln["bias"].float(), eps)
    xq, xs = _lib_row_quant(y)
    h = torch._int_mm(xq, w1_cm).float() * (xs * p["fc"]["w_scale"]) + p["fc"]["b"].float()
    hq, hs = _lib_row_quant(F.gelu(h, approximate=approximate))
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
    t_k, t_p = cuda_ms(kern), cuda_ms(plain, iters=plain_iters)
    t_l = None if lib is None else cuda_ms(lib)
    t_ops, t_bytes = ops / peaks["int8"], nbytes / peaks["bytes"]
    bound = max(t_ops, t_bytes) * 1e3
    say(f"  {label}: {t_k:.4f} ms; plain {t_p:.4f} ms (median of {plain_iters}); library "
        f"{'none' if t_l is None else f'{t_l:.4f} ms'}; bound {bound:.4f} ms ({ops:.3e} "
        f"int8 op, {nbytes:.3e} B); "
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


def phase_family_kernels(dev, peaks) -> dict:
    """Phase 10's new kernel shapes: kernel 2 with EVA02-L-14-336's rope
    (q/k/v [32, 577, 16 x 64], the class token's identity row) and kernel 6
    at the largest FastViT ConvFFN shape (MobileCLIP2-S4's first stage at
    batch 32: 131072 rows, 128 -> 384) and the largest ConvNeXt fc1 shape
    (convnext_large_d_320's first stage: 204800 rows, 192 -> 768), each held
    against its plain version and timed beside it, its library yardstick and
    its bound."""
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.models.eva02 import rope_embed
    from clip_embedder_tpu_torch.ops import flash, int8_mlp
    from clip_embedder_tpu_torch.ops.rope import head_tiled_tables

    say("[3] phase 10's shapes: flash_attention_packed with EVA02-L's rope, "
        "int8_linear_fused at FastViT's and ConvNeXt's widest rows (CUDA events, median of "
        "20 back-to-back calls)")
    b, heads, hdim, grid = 32, 16, 64, 24
    seq = grid * grid + 1
    sin, cos = (t.to(dev) for t in head_tiled_tables(
        rope_embed(grid, hdim, ref_grid=16, prefix=1), heads))
    rope = (sin, cos)
    q, k, v = attn_inputs(b, heads, seq, hdim, torch.bfloat16, dev, seed=13)
    # outputs of about 0.07 at S=577: 5e-3 is 2.5x the bf16 step seen (1.95e-3),
    # and the row cosine catches a table shifted by a position
    err = hold("flash_attention_packed+rope B=32 S=577 16x64 (EVA02-L) exact bf16",
               [flash.flash_attention_packed(q, k, v, num_heads=heads, rope=rope)],
               [flash.flash_attention_packed_plain(q, k, v, num_heads=heads, rope=rope)],
               5e-3, 5e-3, cos_min=0.9999)
    hold("flash_attention_packed+rope B=32 S=577 16x64 (EVA02-L) fast_softmax bf16",
         [flash.flash_attention_packed(q, k, v, num_heads=heads, rope=rope, fast_softmax=True)],
         [flash.flash_attention_packed_plain(q, k, v, num_heads=heads, rope=rope,
                                             fast_softmax=True)], 5e-3, 5e-3, cos_min=0.9999)
    t_k = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads, rope=rope))
    t_p = cuda_ms(lambda: flash.flash_attention_packed_plain(q, k, v, num_heads=heads,
                                                             rope=rope))
    t_l = cuda_ms(lambda: rope_library(q, k, v, heads, sin, cos))
    qh, kh, vh = (t.view(b, seq, heads, hdim).transpose(1, 2) for t in (q, k, v))
    t_sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    bound, by, ops, nbytes = attn_bound(b, heads, seq, hdim, peaks,
                                        extra_bytes=2 * seq * heads * hdim * 4)
    say(f"  flash_attention_packed+rope (EVA02-L, S=577, 16x64): {t_k:.4f} ms; plain "
        f"{t_p:.4f} ms; apply_rope + F.scaled_dot_product_attention {t_l:.4f} ms (SDPA alone "
        f"{t_sdpa:.4f} ms); bound {bound:.4f} ms ({ops:.3e} FLOP, {nbytes:.3e} B, {by})")
    out = {"flash_attention_packed[rope]": {
        "name": "flash_attention_packed[rope]", "route": "cuda",
        "source": "clip_embedder_tpu_torch/csrc/flash_packed.cu",
        "replaces": "clip_embedder_tpu/ops/flash.py:308", "max_abs_err": err, "ms": t_k,
        "plain_ms": t_p, "bound_ms": bound, "bound_by": by, "library_ms": t_l}}

    es, vec = 2, 4 * 2  # bf16 activations; an f32 scale and bias per column
    # EVA02-L's SwiGLU (1024 -> 2730 -> 1024 over 32 x 577 rows): widths that
    # are no multiple of 16, which torch._int_mm does not take (no library time)
    for label, rows, k_in, k_out in (("fastvit_fc1", 32 * 64 * 64, 128, 384),
                                     ("convnext_fc1", 32 * 80 * 80, 192, 768),
                                     ("eva02_fc1", 32 * 577, 1024, 2730),
                                     ("eva02_fc2", 32 * 577, 2730, 1024)):
        p, _, x = int8_inputs(rows, k_in, k_out, torch.bfloat16, dev, seed=14)
        ragged = k_in % 16 or k_out % 16
        err = hold_int8(f"int8_linear_fused {label} rows={rows} {k_in}->{k_out} bf16",
                        [int8_mlp.int8_linear_fused(p, x)],
                        [int8_mlp.int8_linear_fused_plain(p, x)], torch.bfloat16)
        out[f"int8_linear_fused[{label}]"] = {
            "name": f"int8_linear_fused[{label}]", "route": "cuda",
            "source": "clip_embedder_tpu_torch/csrc/int8_linear.cu",
            "replaces": "clip_embedder_tpu/ops/int8_mlp.py:511", "max_abs_err": err,
            **time_int8(f"int8_linear_fused {label} rows={rows} {k_in}->{k_out}", peaks,
                        lambda: int8_mlp.int8_linear_fused(p, x),
                        lambda: int8_mlp.int8_linear_fused_plain(p, x),
                        None if ragged else lambda: int8_linear_library(p, p["w_q"], x, None),
                        2 * rows * k_in * k_out,
                        rows * (k_in + k_out) * es + k_in * k_out + vec * k_out, 5)}
    return out


# ---------------------------------------------------------------------------
# phase 4: fixtures
# ---------------------------------------------------------------------------

def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


# the fixtures with a vision tower of their own, one per family and pool
GOLDEN_FIXTURES = ("golden_siglip", "golden_model", "golden_eva02", "golden_fastvit",
                   "golden_convnext", "golden_resnet")


def phase_fixtures(device) -> dict:
    """Returns the launch counts of the fixtures' run (counts set to 0 just
    before it): kernel 3's main path. Every fixture's text tower (and
    golden_eva02's vision tower) takes ln_qkv and flash_attention."""
    from clip_embedder_tpu_torch import Clip
    from clip_embedder_tpu_torch.ops import flash, qkv

    say("[4] golden fixtures, f32")
    reset_launch_counts()
    for name in GOLDEN_FIXTURES:
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
    say(f"  launches of the fixtures' run (each bucket's first call runs its forward twice: "
        f"the warm-up and the replay): {counts}")
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

def cut_vision_depth(vcfg: dict, layers: int) -> None:
    """``layers`` blocks a stage (a transformer: in all) in the vision config
    ``vcfg``, through the family's override (a CPU rehearsal's cut)."""
    name = vcfg.get("timm_model_name") or ""
    if "_pe_core_" in name:
        vcfg["pe_cfg"] = {"layers": layers}
    elif name.startswith("eva02_"):
        vcfg["eva02_cfg"] = {"layers": layers}
    elif name.startswith(("fastvit", "convnext")):
        vcfg["fastvit_cfg" if name.startswith("fastvit") else "convnext_cfg"] = {
            "depths": [layers] * 4}
    elif name:
        vcfg["vit_cfg"] = {"layers": layers}
    elif isinstance(vcfg["layers"], list):  # ModifiedResNet
        vcfg["layers"] = [layers] * 4
    else:
        vcfg["layers"] = layers


def set_layer_scale(params, value: float) -> None:
    """Every layer-scale leaf (FastViT's ``ls``, ConvNeXt's ``gamma``) of a
    vision tree set to ``value`` in place: at ``init``'s 1e-5 and 1e-6 the
    blocks add almost nothing to their residual, and the kernels they run
    would be held at a scale that hides their errors."""
    if isinstance(params, dict):
        for k, v in params.items():
            if k in ("ls", "gamma") and isinstance(v, torch.Tensor):
                v.fill_(value)
            else:
                set_layer_scale(v, value)
    elif isinstance(params, list):
        for v in params:
            set_layer_scale(v, value)


def build_clip(device, dtype, *, layers=None, vocab_size=None, seed=0, quantize=None,
               model=SO400M_SIGLIP2_384, preprocess=SIGLIP_PREPROCESS, tokenizer="golden_siglip",
               layer_scale=None, vision=None):
    """A ``Clip`` of ``model`` (ViT-SO400M-16-SigLIP2-384 unless given) with
    seeded random weights, resolved through the port's config → build
    (``layers``/``vocab_size`` cut it for a CPU rehearsal), with the
    tokenizer and scoring config of the fixture ``tokenizer`` (its ids are
    under 512); ``quantize`` converts those same weights on the device, as
    ``from_local_dir(..., quantize=...)`` converts loaded ones;
    ``layer_scale`` sets the vision tower's layer scales (``set_layer_scale``)
    first; ``vision``, a ``TowerSpec``, replaces the vision tower's config
    that ``model`` resolves to."""
    import copy

    from clip_embedder_tpu_torch import Clip, TextEmbedder, VisionEmbedder
    from clip_embedder_tpu_torch.config import ModelConfig, OpenClipConfig
    from clip_embedder_tpu_torch.models.build import resolve_text, resolve_vision
    from clip_embedder_tpu_torch.text import (configure_tokenizer, text_tower,
                                              with_tokenizer_pad_id)
    from clip_embedder_tpu_torch.tokenizer import Tokenizer
    from clip_embedder_tpu_torch.vision import build_tower, quantize_params
    from clip_embedder_tpu_torch.weights import _family_init

    model_cfg = copy.deepcopy(model)
    vcfg, tcfg = model_cfg["vision_cfg"], model_cfg["text_cfg"]
    hf_cfg = tcfg.get("hf_config")
    if layers is not None:
        cut_vision_depth(vcfg, layers)
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
    vspec = vision or resolve_vision(config.model_cfg)
    tspec = with_tokenizer_pad_id(resolve_text(config.model_cfg), pad_id)
    gen = torch.Generator(device=device).manual_seed(seed)
    vparams = _family_init(vspec.family)(vspec.cfg, generator=gen, device=device, dtype=dtype)
    tparams = _family_init(tspec.family)(tspec.cfg, generator=gen, device=device, dtype=dtype)
    if layer_scale is not None:
        set_layer_scale(vparams, layer_scale)
    vtower = build_tower(vspec, quantize_params(vparams, vspec, quantize, device, dtype))
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


def eager_rows(emb, images, attn_impl=None) -> torch.Tensor:
    """``emb.embed_images_device(images)``'s rows ([n, D] on the device)
    with the preprocess's plain route (``Preprocessor.eager``) and the tower
    module called directly, eager, as ``embed_images_device`` ran them
    before the captured layer (``utils.captured``): the reference that
    layer is held to, and the plain path's runner (under
    ``plain_int8_wrappers``, which a graph captured with the kernels would
    not follow)."""
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    arrays = [to_rgb_array(im) for im in images]
    with torch.inference_mode():
        pixels = emb.preprocessor.eager(arrays)
        rows = emb.tower(pixels, attn_impl=attn_impl or emb.attn_impl, channels_first=True)
    return rows[: len(arrays)]


def eager_text_rows(emb, texts, attn_impl=None) -> torch.Tensor:
    """``eager_rows`` for a text embedder: ``embed_texts``' rows, the tower
    called directly."""
    from clip_embedder_tpu_torch.ops.preprocess import bucket_batch
    from clip_embedder_tpu_torch.text import pad_batch, tower_kwargs

    ids, mask = emb.tokenize(texts)
    ids, mask = pad_batch(ids, mask, bucket_batch(len(texts)), emb.pad_id)
    with torch.inference_mode():
        rows = emb.tower(torch.from_numpy(ids).to(emb.device),
                         attn_impl=attn_impl or emb.attn_impl,
                         **tower_kwargs(emb.spec, mask, emb.device))
    return rows[: len(texts)]


def plain_preprocess_images(emb, images) -> np.ndarray:
    """``emb.embed_images(images)`` with the preprocess's plain route
    (``Preprocessor.eager``) before the tower's captured forward: the route
    before the preprocess was captured."""
    from clip_embedder_tpu_torch.utils import captured
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    arrays = [to_rgb_array(im) for im in images]
    with torch.inference_mode():
        pixels = emb.preprocessor.eager(arrays)
        rows = captured.forward(emb.tower, pixels, attn_impl=emb.attn_impl,
                                channels_first=True)
    return rows[: len(arrays)].float().cpu().numpy()


def eager_images(emb, images, attn_impl=None) -> np.ndarray:
    return eager_rows(emb, images, attn_impl).float().cpu().numpy()


def eager_texts(emb, texts, attn_impl=None) -> np.ndarray:
    return eager_text_rows(emb, texts, attn_impl).float().cpu().numpy()


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
    if any(s in n for s in ("conv", "fprop", "cudnn", "winograd", "nhwc", "nchw")):
        return "conv (cuDNN and PyTorch's convolution kernels, layout transforms)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    return "other"


EVENTS_GROUP = "all (CUDA events' span: the profiler saw no device time)"


def device_breakdown(fn, sessions: int = 3) -> dict:
    """One call of ``fn`` under torch.profiler (CUDA activity): device time
    by kernel group and the share of the wall time the device sat idle.

    The profiler does not always report the kernels of a CUDA graph's
    replay: one run of this script on the H100 saw none in a replay that
    other runs traced in full. So a call whose session shows no device time
    is profiled again, up to ``sessions`` times, and after that is timed
    with CUDA events recorded around it: ``source`` says which, and then
    ``busy_ms`` is the span from the call's first work on the stream to its
    last, an upper bound on busy time (and ``idle_share`` a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
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
        if busy > 0:
            return {"groups_ms": groups, "busy_ms": busy, "wall_ms": wall_ms,
                    "idle_share": max(0.0, 1 - busy / wall_ms), "source": "torch.profiler"}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    span = start.elapsed_time(end)
    say(f"  the profiler saw no device time in {sessions} sessions; timed with CUDA events")
    return {"groups_ms": {EVENTS_GROUP: span}, "busy_ms": span, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1 - span / wall_ms), "source": "cuda events"}


def phase_main_path(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None,
                    batch=32, timed=True) -> dict:
    import dataclasses

    from clip_embedder_tpu_torch import VisionEmbedder
    from clip_embedder_tpu_torch.models import zoo
    from clip_embedder_tpu_torch.models.build import TowerSpec, resolve_vision
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    say(f"[5] main path: ViT-SO400M-16-SigLIP2-384, {dtype}, random weights (seed 0), the "
        "vision tower's config from models/zoo.py")
    t0 = time.perf_counter()
    vcfg = zoo.so400m_siglip2_384()
    if layers is not None:
        vcfg = dataclasses.replace(vcfg, layers=layers)
    clip, vspec, tspec = build_clip(device, dtype, layers=layers, vocab_size=vocab_size,
                                    vision=TowerSpec("vit", vcfg))
    resolved = resolve_vision(clip.vision.config.model_cfg).cfg
    diff = {f.name: (getattr(vcfg, f.name), getattr(resolved, f.name))
            for f in dataclasses.fields(vcfg) if getattr(vcfg, f.name) != getattr(resolved, f.name)}
    say(f"  models/zoo.py against the open_clip config's resolution: fields that differ "
        f"(zoo, resolved) {diff} (proj_bias is read only with use_proj)")
    if set(diff) - ({"proj_bias"} if not vcfg.use_proj else set()):
        raise AssertionError("models/zoo.py's SO400M config is not the open_clip config's")
    say(f"  built vision {vspec.cfg.layers}x{vspec.cfg.width} ({vspec.cfg.seq_len} tokens, "
        f"{vspec.cfg.heads}x{vspec.cfg.head_dim} heads), text {tspec.cfg.layers}x"
        f"{tspec.cfg.width} (vocab {tspec.cfg.vocab_size}, ctx {tspec.cfg.context_length}) "
        f"in {time.perf_counter() - t0:.1f} s; attn_impl={clip.vision.attn_impl}")
    images = mixed_batch(batch)
    depth_v, depth_t = vspec.cfg.layers, tspec.cfg.layers

    # the main path driven cold (each bucket's first call captures its graph:
    # the warm-up forward, the capture and a replay, two forwards on the
    # device) and then warm (replays: one forward a call)
    runs, row_runs = {}, {}
    for run in ("cold", "warm"):
        reset_launch_counts()
        embs = clip.vision.embed_images(images)
        n = launch_counts()
        after_embed = (n["ln_qkv"], n["flash_attention_packed"])
        row_embed = tuple(row_launch_counts().values())
        results = clip.classify(images[0], LABELS)
        n = launch_counts()
        runs[run] = (after_embed, (n["ln_qkv"], n["flash_attention_packed"]),
                     {k: v for k, v in quant_launch_counts().items() if v})
        row_runs[run] = (row_embed, tuple(row_launch_counts().values()))
    launches = runs["cold"][1]
    quant = {**runs["cold"][2], **runs["warm"][2]}

    norms = np.linalg.norm(embs, axis=-1)
    say(f"  embed_images: {embs.shape}, finite={bool(np.isfinite(embs).all())}, "
        f"norms in [{norms.min():.6f}, {norms.max():.6f}]")
    say(f"  classify: {[(lbl, round(p, 6)) for lbl, p in results]}")
    for run, (a, n, _) in runs.items():
        ra, rn = row_runs[run]
        say(f"  launches, {run}: after embed_images ln_qkv={a[0]} flash={a[1]} "
            f"norm_rows={ra[0]} act_rows={ra[1]}; after classify ln_qkv={n[0]} flash={n[1]} "
            f"norm_rows={rn[0]} act_rows={rn[1]}")
    if embs.shape != (batch, vspec.cfg.embed_dim) or not np.isfinite(embs).all():
        raise AssertionError("embed_images returned bad embeddings")
    if np.abs(norms - 1).max() > 1e-2:
        raise AssertionError("embeddings are not unit-norm")
    probs = [p for _, p in results]
    if not (np.isfinite(probs).all() and probs == sorted(probs, reverse=True)):
        raise AssertionError("classify returned bad probabilities")
    if device == "cuda":
        for run, times in (("cold", 2), ("warm", 1)):
            a, n, _ = runs[run]
            if a != (times * depth_v,) * 2 or n != (times * (2 * depth_v + depth_t),) * 2:
                raise AssertionError(f"{run} run: kernel launches {a}/{n} are not {times} per "
                                     "layer per tower forward")
            # each block's MLP half takes norm_rows and act_rows once; a vision
            # forward's ln_post and map pool (its LayerNorm and MLP) add 2 and 1
            vision = (depth_v + 2, depth_v + 1)
            want = (tuple(times * v for v in vision),
                    tuple(times * (2 * v + depth_t) for v in vision))
            if row_runs[run] != want:
                raise AssertionError(f"{run} run: norm_rows / act_rows launches "
                                     f"{row_runs[run]}, expected {want}")
    say(f"  int8 attention launches (no path sets quant_qk / quant_pv): {quant}")
    if any(quant.values()):
        raise AssertionError("the main path launched an int8 attention kernel")
    if device == "cuda":
        hold_replay("embed_images", clip.vision.tower, batch)

    cos = cosines(embs, eager_images(clip.vision, images, "eager"))
    say(f"  kernel vs eager (bf16, same weights): min cosine {cos.min():.6f} (need >= 0.999)")
    if cos.min() < 0.999:
        raise AssertionError("the kernel path disagrees with the eager path")

    out = {"launches": {"ln_qkv": launches[0], "flash_attention_packed": launches[1]},
           "row_launches": dict(zip(_row_wrappers(), row_runs["cold"][1])),
           "quant_launches": quant, "embeddings": embs}
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


def time_embedder(emb, arrays, label, run=None) -> dict:
    """images/s at the batch of ``arrays`` (median of 5 calls) and the p50
    latency of one image (median of 20), host clock, of ``emb.embed_images``
    (or of ``run``, which returns the rows on the host as it does)."""
    run = run or emb.embed_images
    run(arrays)  # warm-up
    run(arrays[:1])
    times = []
    for _ in range(5):
        t = time.perf_counter()
        run(arrays)
        times.append(time.perf_counter() - t)
    ips = len(arrays) / statistics.median(times)
    lat = []
    for _ in range(20):
        t = time.perf_counter()
        run(arrays[:1])
        lat.append(time.perf_counter() - t)
    p50 = statistics.median(lat) * 1e3
    say(f"  {label}: {ips:.2f} images/s at batch {len(arrays)} (median of 5, host clock, "
        f"decoded arrays in, preprocess included); single image p50 {p50:.2f} ms")
    return {"images_per_s": ips, "p50_ms": p50}


def profile_embedder(emb, arrays, label, run=None) -> dict:
    run = run or emb.embed_images
    bd = device_breakdown(lambda: run(arrays))
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


def _row_wrappers() -> dict:
    """The port's own row kernels (``ops.rows``), which replace no TPU
    kernel: counted apart from ``_wrappers``' seven."""
    from clip_embedder_tpu_torch.ops import rows

    return {"norm_rows": rows.norm_rows, "act_rows": rows.act_rows}


def row_launch_counts() -> dict:
    """``launch_counts`` for the row kernels."""
    if torch.cuda.is_available():
        hold_graphs()
    return {name: fn.launches for name, fn in _row_wrappers().items()}


def launch_counts() -> dict:
    """Each wrapper's launch count. On the card every graph captured so far
    is first held to the kernels it holds (``hold_graphs``): a replay adds
    its capture's launches to the counts, and those are its kernel nodes."""
    if torch.cuda.is_available():
        hold_graphs()
    return {name: fn.launches for name, fn in _wrappers().items()}


def mask_launch_counts() -> dict:
    """The packed kernel's launches with a mask, by form (shared, key, full)."""
    from clip_embedder_tpu_torch.ops import flash

    return dict(flash.flash_attention_packed.mask_launches)


def quant_launch_counts() -> dict:
    """The packed kernel's int8 launches, by what they quantize (qk, pv,
    both) and by route and form ("int8_tma qk", ...)."""
    from clip_embedder_tpu_torch.ops import flash

    return {**flash.flash_attention_packed.quant_launches,
            **flash.flash_attention_packed.route_launches}


def reset_launch_counts() -> None:
    from clip_embedder_tpu_torch.ops import flash

    for fn in (*_wrappers().values(), *_row_wrappers().values()):
        fn.launches = 0
    for counts in ("mask_launches", "quant_launches", "route_launches"):
        setattr(flash.flash_attention_packed, counts,
                dict.fromkeys(getattr(flash.flash_attention_packed, counts), 0))


# The port's kernels as the profiler names them: the build puts every kernel
# of csrc/<stem>.cu in a namespace src_<stem> (ops.cuda.nvcc_flags). A
# wrapper call runs its source's main kernel once, beside its helpers (the
# LayerNorm pass of ln_qkv's mma.sync route, the rope pass, kernel 2's int8
# preparation, the int8 row passes); int8_mlp's is its fc1 product (mode 1,
# kAct, in csrc/int8_wgmma.cuh). A name may come mangled (a graph's kernel
# node) or demangled (the profiler).
KACT = r"gemm_kernel(?:<[^,<>]+, ?1,|I[^L]*Li1E)"  # mode 1, demangled or mangled
MAIN_KERNELS = {
    "flash_packed": ("flash_attention_packed", r"flash_(bf16|tma|f32)_kernel"),
    "flash_int8": ("flash_attention_packed", r"attn_kernel"),
    "flash_int8_tma": ("flash_attention_packed", r"attn_kernel"),
    "flash_bhsd": ("flash_attention", r"flash_(bf16|tma|f32)_kernel"),
    "ln_qkv": ("ln_qkv", r"qkv_(gemm_)?kernel"),
    "ln_qkv_int8": ("ln_qkv_int8", r"gemm_kernel"),
    "int8_linear": ("int8_linear_fused", r"gemm_kernel"),
    "int8_mlp": ("int8_mlp", KACT),
    "int8_mlp_streamed": ("int8_mlp_streamed", KACT),
}
# csrc/block_rows.cu holds two wrappers' kernels: each launches one
ROW_KERNELS = {"norm_kernel": "norm_rows", "act_kernel": "act_rows"}


def device_launches(prof) -> dict:
    """The port's launches the device ran under the profile ``prof``, by
    wrapper (``port_launches``), and the marker kernels it recorded
    ("markers": ``torch.cuda._sleep``'s)."""
    events = prof.key_averages()
    n = port_launches([e.key for e in events for _ in range(e.count)])
    n["markers"] = sum(e.count for e in events if "spin_kernel" in e.key)
    return n


def replay_under_profiler(graph, attempts: int = 4) -> dict | None:
    """One replay of a captured graph under torch.profiler: the port's
    launches the device ran (``device_launches``). Each session opens and
    closes with a marker kernel 50 ms from its ends: on an H100 with torch
    2.11 the profiler recorded no kernel of a session's first moments in 4
    of 240 short sessions, and lost a marker in every session of a 0.4 s
    PE-Core block, four in a row, and in every session late in
    ``chip_smoke.py`` (phase 14); an attempt waits a second more than the
    last. None if each of ``attempts`` sessions lost a marker."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        time.sleep(attempt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            graph.replay()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.05)
        ran = device_launches(prof)
        if ran.pop("markers") == 2:
            return ran
    return None


def hold_replay(what, tower, bucket: int) -> dict:
    """The batch-``bucket`` graph of ``tower``: the port's launches among
    its kernel nodes against those one replay ran under the profiler
    (``replay_under_profiler``; "not measured" when it lost the sessions)."""
    from clip_embedder_tpu_torch.utils import captured

    g = next(g for key, g in captured.graphs_of(tower).graphs.items()
             if bucket_of(key) == bucket)
    nodes = port_launches(graph_kernel_names(g.graph))
    ran = replay_under_profiler(g.graph)
    shown = {k: v for k, v in nodes.items() if v}
    say(f"  {what}: the batch-{bucket} graph holds the launches {shown}; one replay under "
        f"torch.profiler ran " + ("the same" if ran == nodes else
                                  "not measured (the profiler lost a marker in each of 4 "
                                  "sessions)" if ran is None else
                                  str({k: v for k, v in ran.items() if v})))
    if ran is not None and ran != nodes:
        raise AssertionError(f"{what}: a replay ran {ran}, its graph holds {nodes}")
    return {"graph": nodes, "replay": ran}


def graph_kernel_names(graph) -> list[str]:
    """The names of the kernel nodes of a captured ``torch.cuda.CUDAGraph``
    (``utils.captured`` keeps its ``cudaGraph_t``): every kernel a replay
    launches, from CUDA's driver API."""
    import ctypes

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p), *((f, ctypes.c_uint) for f in (
            "gx", "gy", "gz", "bx", "by", "bz", "smem")), ("params", ctypes.c_void_p),
            ("extra", ctypes.c_void_p), ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    cu = ctypes.CDLL("libcuda.so.1")

    def check(code, what):
        if code != 0:
            raise RuntimeError(f"{what} returned CUresult {code}")

    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    names = []
    for node in nodes:
        kind = ctypes.c_int()
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(p)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if p.kern:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)),
                  "cuKernelGetName")
        else:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)),
                  "cuFuncGetName")
        names.append(name.value.decode())
    return names


def kernel_source(name: str) -> str | None:
    """The csrc stem in a kernel's name, demangled (``src_<stem>::``) or
    mangled (``<length>src_<stem>``); None for a kernel not the port's."""
    import re

    m = re.search(r"\bsrc_(\w+?)::", name)
    if m:
        return m.group(1)
    m = re.search(r"(\d+)src_", name)
    return name[m.end(1) + 4: m.end(1) + int(m.group(1))] if m else None


def port_launches(names) -> dict:
    """The launches a list of kernel names holds, by wrapper: its sources'
    main kernels (``MAIN_KERNELS``), with the packed kernel's rope passes
    ("rope") and the row kernels (``ROW_KERNELS``)."""
    import re

    n = dict.fromkeys([*_wrappers(), *_row_wrappers()], 0)
    n["rope"] = 0
    for name in names:
        src = kernel_source(name)
        if src == "block_rows":
            for kern, wrapper in ROW_KERNELS.items():
                n[wrapper] += kern in name
            continue
        if src not in MAIN_KERNELS:
            continue
        wrapper, main = MAIN_KERNELS[src]
        if re.search(main, name):
            n[wrapper] += 1
        elif src == "flash_packed" and "rope_kernel" in name:
            n["rope"] += 1
    return n


_held_graphs = weakref.WeakSet()


def hold_graphs() -> None:
    """Every captured graph not yet held (``utils.captured.graph_sets``)
    against the kernels it holds: for each wrapper, its main kernels among
    the graph's kernel nodes must be the launches its capture recorded,
    which each replay adds to the wrapper's count."""
    from clip_embedder_tpu_torch.utils import captured

    names = {id(fn): name for name, fn in {**_wrappers(), **_row_wrappers()}.items()}
    for graphs in captured.graph_sets():
        for key, g in list(graphs.graphs.items()):
            if g in _held_graphs:
                continue
            nodes = port_launches(graph_kernel_names(g.graph))
            del nodes["rope"]
            tally = dict.fromkeys(nodes, 0)
            for (wrapper, counter, _form), k in g.launches.items():
                if counter == "launches":
                    tally[names[id(wrapper)]] += k
            if nodes != tally:
                raise AssertionError(f"the graph of {key} holds the kernels {nodes}; its "
                                     f"capture recorded {tally}")
            _held_graphs.add(g)


def warm(*calls) -> None:
    """Each call once, before a counted block: a bucket's first call on the
    card captures its graph (``utils.captured``: a warm-up forward, the
    capture, a replay), as ``serving.warmup`` does before a server takes
    requests, so that the counted calls each run the forward once."""
    for call in calls:
        call()


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
        warm(lambda: clip.vision.embed_images(images), lambda: clip.classify(images[0], LABELS))
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
            cos = cosines(embs, eager_images(clip.vision, images))
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
        for blk in getattr(tower, "blocks", ())]
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
    kernel = {"vision": clip.vision.embed_images, "text": clip.text.embed_texts}
    # the plain path calls the towers directly (a captured graph would replay
    # the kernels); so does the per-block look, whose hooks a replay skips
    eager = {"vision": lambda xs, impl=None: eager_images(clip.vision, xs, impl),
             "text": lambda xs, impl=None: eager_texts(clip.text, xs, impl)}
    if mode is None:
        plain = {name: functools.partial(run, impl="eager") for name, run in eager.items()}
        what = "eager"
    else:
        def plain_of(fn):
            def run(xs):
                with plain_int8_wrappers():
                    return fn(xs)
            return run
        plain = {name: plain_of(fn) for name, fn in eager.items()}
        what = "the plain int8 wrappers"
    runs = {"vision": (clip.vision.tower, embs, images),
            "text": (clip.text.tower, kernel["text"](texts), texts)}
    for name, (tower, got, inputs) in runs.items():
        cos = cosines(got, plain[name](inputs))
        say(f"  {name}: kernel path vs {what} (same weights): min cosine {cos.min():.6f}, "
            f"mean {cos.mean():.6f} (need >= 0.999)")
        if cos.min() < 0.999:
            per = per_block_cosines(tower, lambda: eager[name](inputs[:2]),
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
        warm(lambda: clip.vision.embed_images(images), lambda: clip.classify(images[0], LABELS))
        reset_launch_counts()
        embs = clip.vision.embed_images(images)
        results = clip.classify(images[0], LABELS)
        counts, row_counts = launch_counts(), row_launch_counts()
        norms = np.linalg.norm(embs, axis=-1)
        say(f"  embed_images: {embs.shape}, norms in [{norms.min():.6f}, {norms.max():.6f}]; "
            f"classify: {[(lbl, round(p, 6)) for lbl, p in results]}")
        say(f"  launches (one embed_images + one classify): {counts}; row kernels {row_counts}")
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
        out[label] = {"launches": counts, "row_launches": row_counts, "vision_layers": v.layers}
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


def time_texts(text, texts, label, run=None) -> dict:
    """texts/s at the batch of ``texts`` (median of 5 calls, host clock) of
    ``text.embed_texts`` (or of ``run``)."""
    run = run or text.embed_texts
    run(texts)  # warm-up
    times = []
    for _ in range(5):
        t = time.perf_counter()
        run(texts)
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
            warm(lambda: clip.vision.embed_images(images), lambda: clip.text.embed_texts(texts),
                 lambda: clip.classify(images[0], LABELS))
            calls = {}
            reset_launch_counts()
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
            # the launches of embed_texts: every one carries the mask
            # (its masked count, checked above, is the text tower's depth)
            out[label] = {"launches": n_cls, "mask_launches": m_cls, "form": form,
                          "text_launches": calls["embed_texts"][0]}
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
        # the buckets warmed above
        reset_launch_counts()
        served = {
            "image": http(server, "/v1/embed/image", jpgs[0], "image/jpeg"),
            "images": http(server, "/v1/embed/image", {"images_b64": b64[:batch]}),
            "text": http(server, "/v1/embed/text", {"texts": [LABELS[0]]}),
            "texts": http(server, "/v1/embed/text", {"texts": many}),
            "classify": http(server, "/v1/classify", {"image_b64": b64[1],
                                                      "labels": LABELS}),
            "rank": http(server, "/v1/rank", {"images_b64": b64[:hold],
                                              "text": LABELS[1]}),
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
            pp = clip.vision.preprocessor
            stage_ms = staging_ms(pp, arrays)
            say(f"  host work of that micro-batch alone (host clock): decode of the 32 JPEGs "
                f"{decode_ms:.2f} ms ({'libclippre' if native.available() else 'Pillow'}), "
                f"staging {stage_ms:.2f} ms (into the reused u8 buffer "
                f"{[len(arrays), *pp.padded_size(arrays), 3]}, median of 5)")
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


def serve_concurrently(server, paths, direct, label, device, bound=SERVED_COSINE) -> dict:
    """One single-JPEG request for each file of ``paths``, each from its own
    thread of a client process (``CLIENTS``), released together: all must
    succeed, in few micro-batches, with the direct call's rows (min cosine
    ``bound``); images/s
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
    cos = hold_rows(label, res["rows"], direct, bound)
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


# ---------------------------------------------------------------------------
# phase 10: the other vision families
# ---------------------------------------------------------------------------

def vision_launches(spec, mode, batch: int) -> dict:
    """The kernel launches of one vision forward of a phase-10 tower over
    ``batch`` images, by wrapper, from the gates. EVA02's heads form
    128-lane groups: kernel 2 with rope once a block; its SwiGLU's three
    linears (1024 -> 2730 -> 1024) take kernel 6 under both int8 modes, and
    its q, k, v and out under int8_all. Under int8, FastViT's ConvFFN and
    ConvNeXt's fc1 and fc2 take kernel 6 in every stage with at least 128
    rows (batch x the stage's positions; the stem divides the side by 4,
    each stage after the first by 2 more), and so do FastViT's attention
    q, k, v and out under int8_all. FastViT's attention, the convolutions
    and ResNet's attention pool launch no kernel."""
    n = dict.fromkeys(_wrappers(), 0)
    cfg = spec.cfg
    if spec.family == "eva02":
        n["flash_attention_packed"] = cfg.layers
        n["int8_linear_fused"] = {None: 0, "int8": 3, "int8_all": 7}[mode] * cfg.layers
    elif spec.family in ("fastvit", "convnext") and mode:
        side = cfg.image_size // 4
        for i, depth in enumerate(cfg.depths):
            if batch * (side >> i) ** 2 >= 128:
                attn = (spec.family == "fastvit" and mode == "int8_all"
                        and cfg.mixers[i] == "attention")
                n["int8_linear_fused"] += (6 if attn else 2) * depth
    return n


def phase_families(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None, batch=32,
                   timed=True) -> dict:
    """MobileCLIP2-S4, EVA02-L-14-336, convnext_large_d_320 and RN50 at full
    width and depth (``layers``/``vocab_size`` cut them for a CPU
    rehearsal), seeded random weights with the layer scales at 0.1
    (``set_layer_scale``), through ``Clip`` in ``dtype`` and the modes of
    ``FAMILY_MODELS``: ``embed_images``, ``embed_texts`` on captions of
    distinct lengths and one ``classify``, launch counts asserted per call,
    both towers held against the plain path, images/s, p50, texts/s and
    device time by kernel group. Each model is freed before the next."""
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    free_device_memory()  # the earlier phases' models
    images = mixed_batch(batch)
    arrays = [to_rgb_array(im) for im in images]
    texts = captions(batch, 70)
    out = {}
    for name, model, modes in FAMILY_MODELS:
        for mode in modes:
            label = f"{name} {mode or str(dtype).removeprefix('torch.')}"
            say(f"[10] {label}, random weights (seed 0, layer scales 0.1)")
            t0 = time.perf_counter()
            clip, vspec, tspec = build_clip(device, dtype, layers=layers, vocab_size=vocab_size,
                                            quantize=mode, model=model,
                                            preprocess=OPENAI_PREPROCESS,
                                            tokenizer="golden_model", layer_scale=0.1)
            t = tspec.cfg
            say(f"  built vision {vspec.family} {vspec.cfg}, text {t.layers}x{t.width} "
                f"({t.heads} heads, ctx {t.context_length}) in "
                f"{time.perf_counter() - t0:.1f} s; attn_impl vision="
                f"{clip.vision.attn_impl} text={clip.text.attn_impl}")
            warm(lambda: clip.vision.embed_images(images), lambda: clip.text.embed_texts(texts),
                 lambda: clip.classify(images[0], LABELS))
            calls = {}
            reset_launch_counts()
            embs = clip.vision.embed_images(images)
            calls["embed_images"] = launch_counts()
            masked = mask_launch_counts()
            reset_launch_counts()
            temb = clip.text.embed_texts(texts)
            calls["embed_texts"] = launch_counts()
            results = clip.classify(images[0], LABELS)
            n_cls = launch_counts()
            calls["classify"] = {k: n_cls[k] - calls["embed_texts"][k] for k in n_cls}
            masked = {f: masked[f] + n for f, n in mask_launch_counts().items()}
            for what, e, dim in (("embed_images", embs, vspec.cfg.embed_dim),
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
            for what, n in calls.items():
                say(f"  launches, {what}: {n}")
            if device == "cuda":
                txt = tower_launches(tspec.family, mode, t.layers)
                one = vision_launches(vspec, mode, 1)
                want = {"embed_images": vision_launches(vspec, mode, batch), "embed_texts": txt,
                        "classify": {k: one[k] + txt[k] for k in one}}
                for what, n in calls.items():
                    if n != want[what]:
                        raise AssertionError(f"{label}: {what} launched {n}, expected "
                                             f"{want[what]}")
            hold_towers(clip, vspec, tspec, embs, images, mode, label, texts=texts)
            # the three calls' launches; the packed kernel's without a mask are
            # EVA02's, with rope (every text tower's attention is masked)
            out[label] = {"launches": {k: calls["embed_images"][k] + n_cls[k] for k in n_cls},
                          "mask_launches": masked, "family": vspec.family}
            if timed:
                out[label].update(time_embedder(clip.vision, arrays, label))
                out[label].update(time_texts(clip.text, texts, label))
                out[label]["breakdown"] = profile_embedder(clip.vision, arrays, label)
            del clip
            free_device_memory()
    return out


# ---------------------------------------------------------------------------
# phase 11: the ONNX path
# ---------------------------------------------------------------------------

# laion/CLIP-ViT-B-32-laion2B-s34B-b79K as open_clip names it (the reference's
# tested list, README.md:142; tests/test_reference_model_list.py:98-106):
# vision 12 x 768, 12 x 64 heads, patch 32 at 224 (50 tokens), MLP 3072; text
# 12 x 512, 8 x 64 heads, context 77, vocab 49408, causal; embed 512.
VIT_B32 = {
    "embed_dim": 512,
    "vision_cfg": {"image_size": 224, "layers": 12, "width": 768, "patch_size": 32},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 512, "heads": 8,
                 "layers": 12},
}
# MobileCLIP-S0's scale as the repo gives it (benches/bench_onnx_fallback.py:62-71):
# the MCT hybrid text tower at context 77, vocab 49408, width 512, 8 heads, 4
# transformer layers (MLP 2048), embed 512, after two conv blocks (kernel 11)
# with a ConvFFN (hidden 2048); the vision tower fastvit_mci0's depths
# (2, 6, 10, 2) and dims 64-512 (clip_embedder_tpu/models/fastvit.py:91-94) at
# 256. The scale of S0, not a replica of Apple's S0: what the port converts to
# is whatever the graph holds. Its config names a generic text tower: the
# hybrid structure is in the graph alone.
S0_SCALE = {
    "embed_dim": 512,
    "vision_cfg": {"image_size": 256, "timm_model_name": "fastvit_mci0", "timm_proj": "none"},
    "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 512, "heads": 8,
                 "layers": 4},
}
S0_TEXT = {"width": 512, "heads": 8, "layers": 4, "mlp": 2048,
           "conv_blocks": ((11, 2048), (11, 2048))}
S0_VISION = {"depths": (2, 6, 10, 2), "dims": (64, 128, 256, 512), "mlp_ratios": (3, 3, 3, 3),
             "mixers": ("repmixer",) * 3 + ("attention",), "pos_embs": (False,) * 3 + (True,)}
# MobileCLIP's own preprocess: pixels in [0, 1], no mean or std
S0_PREPROCESS = {"mean": [0.0, 0.0, 0.0], "std": [1.0, 1.0, 1.0]}
# warnings that say a load did not take the native route it was meant to
FALLBACK_WARNINGS = ("vision_fallback:", "text_fallback:", "probe_verify:", "mct_pads:")


def has_torchscript_exporter() -> bool:
    import importlib.util

    return importlib.util.find_spec("torch.onnx._internal.torchscript_exporter") is not None


def onnx_export(model, dummy, path, input_name, output_name) -> None:
    """torch's TorchScript exporter at opset 18 with constant folding, as the
    reference's exporter runs it (reference: pull_onnx.py:159-181). The
    exporter re-serializes the proto through the ``onnx`` package, which is
    not installed, for onnxscript functions these models do not have: that
    step is skipped (the bytes are the same)."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    onnx_proto_utils._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    torch.onnx.export(model, dummy, str(path), input_names=[input_name],
                      output_names=[output_name],
                      dynamic_axes={input_name: {0: "batch"}, output_name: {0: "batch"}},
                      opset_version=18, do_constant_folding=True, dynamo=False)


def value_distinct(model, *, layer_scale=None) -> None:
    """torch.onnx merges identical initializers (fresh LayerNorm weights are
    all ones, attention biases all zeros), which no trained checkpoint has:
    every constant parameter gets a little noise, and BatchNorm statistics
    their own values (tests/test_onnx_dir_e2e.py:70-80). ``layer_scale``
    draws FastViT's layer scales at that scale."""
    from torch import nn

    with torch.no_grad():
        for name, p in model.named_parameters():
            if layer_scale is not None and name.endswith("layer_scale.gamma"):
                p.normal_(0, layer_scale)
            elif (p == p.flatten()[0]).all():
                p.add_(0.02 * torch.randn_like(p))
        for m in model.modules():
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)


class _NormalizedVisual(torch.nn.Module):
    """The reference exporter's wrappers (pull_onnx.py:53-68): the tower under
    open_clip's attribute name, its L2 normalize in the graph."""

    def __init__(self, tower):
        super().__init__()
        self.visual = tower

    def forward(self, x):
        return torch.nn.functional.normalize(self.visual(x), dim=-1)


class _NormalizedText(torch.nn.Module):
    def __init__(self, tower):
        super().__init__()
        self.text = tower

    def forward(self, x):
        return torch.nn.functional.normalize(self.text(x), dim=-1)


def onnx_mirrors(name, *, layers=None, vocab_size=None, seed=0):
    """The torch mirrors of a phase-11 model, seeded random f32 weights on
    the CPU, in eval mode: (config, vision, text). ``layers``/``vocab_size``
    cut them for a CPU rehearsal."""
    import copy

    sys.path.insert(0, str(REPO / "tests"))
    from torch_ref import TextTransformer, VisionTransformer
    from torch_ref_fastvit import TorchFastViT
    from torch_ref_mct import TorchMctText

    cfg = copy.deepcopy(VIT_B32 if name == "CLIP-ViT-B-32" else S0_SCALE)
    t = cfg["text_cfg"]
    if vocab_size is not None:
        t["vocab_size"] = vocab_size
    torch.manual_seed(seed)
    if name == "CLIP-ViT-B-32":
        v = cfg["vision_cfg"]
        if layers is not None:
            v["layers"] = t["layers"] = layers
        vision = VisionTransformer(224, 32, 768, v["layers"], 12, 3072, 512)
        text = TextTransformer(77, t["vocab_size"], 512, 8, t["layers"], 2048, 512)
        value_distinct(vision)
    else:
        depths = S0_VISION["depths"] if layers is None else (layers,) * 4
        vision = TorchFastViT(depths, S0_VISION["dims"], S0_VISION["mlp_ratios"],
                              S0_VISION["mixers"], S0_VISION["pos_embs"], embed_dim=512)
        text = TorchMctText(77, t["vocab_size"], 512, 8, layers or S0_TEXT["layers"], 2048, 512,
                            conv_blocks=S0_TEXT["conv_blocks"])
        value_distinct(vision, layer_scale=0.1)
    value_distinct(text)
    return cfg, vision.eval(), text.eval()


def write_onnx_dir(d: Path, cfg, vision, text, preprocess) -> dict:
    """A reference-format model dir: visual.onnx and text.onnx (the mirrors
    with the normalize baked in), open_clip_config.json, and
    golden_model's tokenizer and scoring config. Returns the seconds each
    export took and the graphs' sizes."""
    d.mkdir(parents=True)
    size = cfg["vision_cfg"]["image_size"]
    out = {}
    for tower, model, dummy, names in (
            ("visual", vision, torch.randn(2, 3, size, size), ("pixel_values", "image_embeds")),
            ("text", text, torch.randint(4, 500, (2, 77)), ("input_ids", "text_embeds"))):
        t = time.perf_counter()
        wrapped = (_NormalizedVisual if tower == "visual" else _NormalizedText)(model).eval()
        onnx_export(wrapped, dummy, d / f"{tower}.onnx", *names)
        out[f"{tower}_export_s"] = time.perf_counter() - t
        out[f"{tower}_mb"] = (d / f"{tower}.onnx").stat().st_size / 2 ** 20
    (d / "open_clip_config.json").write_text(json.dumps(
        {"model_cfg": cfg, "preprocess_cfg": preprocess}))
    for f in ("model_config.json", "tokenizer.json"):
        (d / f).write_bytes((FIXTURES / "golden_model" / f).read_bytes())
    return out


def onnx_launches(spec, mode, rows: int) -> dict:
    """The kernel launches of one forward of a phase-11 tower over ``rows``
    rows (batch x tokens), by wrapper, from the gates: the transformer
    blocks' self-attention takes the packed kernel (12 x 64 and 8 x 64 heads
    form 128-lane groups; the text towers' causal mask in its shared form),
    their LayerNorm + q/k/v ln_qkv, or ln_qkv_int8 under int8_all with the
    out-projection and its residual on int8_linear_fused at 128 rows or
    more; the quantized MLPs (and MCT's ConvFFNs, under both modes) take
    int8_mlp. FastViT's attention, the convolutions and the output
    projections launch nothing."""
    n = dict.fromkeys(_wrappers(), 0)
    if spec.family == "fastvit":
        return n
    depth = spec.cfg.layers
    n["flash_attention_packed"] = depth
    if mode == "int8_all":
        n["ln_qkv_int8"] = depth
        n["int8_linear_fused"] = depth if rows >= 128 else 0
    else:
        n["ln_qkv"] = depth
    if mode:
        ffns = sum(1 for _, h in getattr(spec.cfg, "conv_blocks", ()) if h)
        n["int8_mlp"] = depth + ffns
    return n


def fallback_keys() -> set:
    from clip_embedder_tpu_torch.utils.logging import _warned_once

    return {k for k in _warned_once if k.startswith(FALLBACK_WARNINGS)}


def mirror_embeddings(vision, text, pixels, ids, device) -> tuple:
    """The mirrors in f32 on ``device`` (their masks made there too)."""
    vision.to(device)
    text.to(device)
    with torch.inference_mode(), torch.device(device):
        out = (vision(torch.from_numpy(pixels).to(device).float()).cpu().numpy(),
               text(torch.from_numpy(ids).long().to(device)).cpu().numpy())
    vision.cpu()
    text.cpu()
    return out


def hold_label_order(what, got, ref_logits, labels, gap) -> None:
    """``got`` (classify's (label, prob) list) in the order of the reference
    logits, swaps allowed only between labels whose reference logits lie
    within ``gap``."""
    order = [label for label, _ in got]
    ref = dict(zip(labels, ref_logits))
    bad = [(a, b) for a, b in zip(order, order[1:]) if ref[a] < ref[b] - gap]
    say(f"  {what}: classify order {order}; the mirror's logits "
        f"{[round(float(ref[l]), 4) for l in order]}")
    if bad:
        raise AssertionError(f"{what}: classify order differs from the mirror's: {bad}")


def executor_embedders(clip, d: Path, device, dtype):
    """A vision and a text embedder over ``d``'s graphs run by the executor
    (``onnx_exec``), with ``clip``'s configs: the path a dir takes when no
    native family fits."""
    from clip_embedder_tpu_torch import TextEmbedder, VisionEmbedder
    from clip_embedder_tpu_torch.models.build import TowerSpec
    from clip_embedder_tpu_torch.onnx_exec import fallback_cfg, load_tower
    from clip_embedder_tpu_torch.text import OnnxText
    from clip_embedder_tpu_torch.vision import OnnxVisual

    common = {"config": clip.vision.config, "model_config": clip.vision.model_config,
              "model_dir": d, "device": device, "dtype": dtype}
    vcfg, tcfg = (fallback_cfg(d / f"{t}.onnx", dtype=dtype) for t in ("visual", "text"))
    vision = VisionEmbedder(tower=OnnxVisual(load_tower(vcfg, device)),
                            spec=TowerSpec("onnx", vcfg), **common)
    text = TextEmbedder(tower=OnnxText(load_tower(tcfg, device)), spec=TowerSpec("onnx", tcfg),
                        tokenizer=clip.text.tokenizer, **common)
    return vision, text


def phase_onnx_kernels(dev, peaks) -> dict:
    """Phase 11's kernel shapes at batch 32 in bf16, each held against its
    plain version and timed beside it, its library yardstick and its bound:
    kernel 1 over ViT-B-32's vision rows (32 x 50, W = 768) and the 512-wide
    text rows (32 x 77: ViT-B-32's text, MCT's blocks); kernel 2 over
    [32, 50, 12 x 64] without a mask and [32, 77, 8 x 64] with the shared
    causal mask; kernel 4 over ViT-B-32's MLP (768 -> 3072, exact gelu) and
    the 512-wide one (512 -> 2048: ViT-B-32's text, MCT's ConvFFN and MLP);
    kernels 5 and 6 at both widths."""
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops import flash, int8_mlp, qkv
    from clip_embedder_tpu_torch.ops.attention import causal_mask

    say("[3] phase 11's shapes: CLIP-ViT-B-32 and the 512-wide text towers (CUDA events, "
        "median of 20 back-to-back calls)")
    out, es, eps = {}, 2, 1e-5
    for tag, rows, width in (("vit_b32", 32 * 50, 768), ("text512", 32 * 77, 512)):
        params, pre_ln, x = qkv_inputs(rows, width, torch.bfloat16, dev)
        err = hold(f"ln_qkv {tag} rows={rows} W={width} bf16", qkv.ln_qkv(params, pre_ln, x,
                                                                          eps=eps),
                   qkv.ln_qkv_plain(params, pre_ln, x, eps=eps), 1e-2, 2 ** -7)
        t_k = cuda_ms(lambda: qkv.ln_qkv(params, pre_ln, x, eps=eps))
        t_p = cuda_ms(lambda: qkv.ln_qkv_plain(params, pre_ln, x, eps=eps))
        t_l = cuda_ms(lambda: ln_qkv_library(params, pre_ln, x, eps))
        nbytes = (4 * rows * width + 3 * width * width) * es + 5 * width * 4
        ops = 6 * rows * width * width
        t_ops, t_bytes = ops / peaks["bf16"], nbytes / peaks["bytes"]
        say(f"  ln_qkv {tag}: {t_k:.4f} ms; plain {t_p:.4f} ms; F.layer_norm+3 addmm "
            f"{t_l:.4f} ms; bound {max(t_ops, t_bytes) * 1e3:.4f} ms")
        out[f"ln_qkv[{tag}]"] = {
            "name": f"ln_qkv[{tag}]", "route": "cuda",
            "source": "clip_embedder_tpu_torch/csrc/ln_qkv.cu",
            "replaces": "clip_embedder_tpu/ops/qkv.py:216", "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes", "library_ms": t_l}
    for tag, heads, s, causal in (("vit_b32", 12, 50, False), ("text512_causal", 8, 77, True)):
        b, hdim = 32, 64
        q, k, v = attn_inputs(b, heads, s, hdim, torch.bfloat16, dev, seed=15)
        mask = causal_mask(s, device=dev) if causal else None
        err = hold(f"flash_attention_packed {tag} B=32 S={s} {heads}x64 exact bf16",
                   [flash.flash_attention_packed(q, k, v, num_heads=heads, mask=mask)],
                   [flash.flash_attention_packed_plain(q, k, v, num_heads=heads, mask=mask)],
                   2e-2, 2e-2)
        t_k = cuda_ms(lambda: flash.flash_attention_packed(q, k, v, num_heads=heads, mask=mask))
        t_p = cuda_ms(lambda: flash.flash_attention_packed_plain(q, k, v, num_heads=heads,
                                                                 mask=mask))
        qh, kh, vh = (t.view(b, s, heads, hdim).transpose(1, 2) for t in (q, k, v))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal))
        bound, by, ops, nbytes = attn_bound(b, heads, s, hdim, peaks,
                                            extra_bytes=s * s * 4 if causal else 0)
        say(f"  flash_attention_packed {tag}: {t_k:.4f} ms; plain {t_p:.4f} ms; "
            f"F.scaled_dot_product_attention {t_l:.4f} ms; bound {bound:.4f} ms ({by})")
        out[f"flash_attention_packed[{tag}]"] = {
            "name": f"flash_attention_packed[{tag}]", "route": "cuda",
            "source": "clip_embedder_tpu_torch/csrc/flash_packed.cu",
            "replaces": "clip_embedder_tpu/ops/flash.py:308", "max_abs_err": err, "ms": t_k,
            "plain_ms": t_p, "bound_ms": bound, "bound_by": by, "library_ms": t_l}
    for tag, rows, width, hidden in (("vit_b32", 32 * 50, 768, 3072),
                                     ("text512", 32 * 77, 512, 2048)):
        p, ln, x = int8_inputs(rows, width, width, torch.bfloat16, dev, hidden=hidden, seed=16)
        kw = {"activation": "gelu", "pre_ln": ln, "ln_eps": eps, "add_residual": True}
        err = hold_int8(f"int8_mlp {tag} rows={rows} {width}->{hidden}->{width} gelu+LN+res bf16",
                        [int8_mlp.int8_mlp(p, x, **kw)], [int8_mlp.int8_mlp_plain(p, x, **kw)],
                        torch.bfloat16)
        w1_cm, w2_cm = p["fc"]["w_q"], p["proj"]["w_q"]
        out[f"int8_mlp[{tag}]"] = {
            "name": f"int8_mlp[{tag}]", "route": "cuda",
            "source": "clip_embedder_tpu_torch/csrc/int8_mlp.cu",
            "replaces": "clip_embedder_tpu/ops/int8_mlp.py:181", "max_abs_err": err,
            **time_int8(f"int8_mlp {tag}", peaks, lambda: int8_mlp.int8_mlp(p, x, **kw),
                        lambda: int8_mlp.int8_mlp_plain(p, x, **kw),
                        lambda: int8_mlp_library(p, w1_cm, w2_cm, ln, x, eps, "none"),
                        4 * rows * width * hidden,
                        2 * rows * width * es + 2 * width * hidden
                        + 4 * 2 * (hidden + width) + 4 * 2 * width)}
        for name, rec in time_qkv_linear(f"{tag} rows={rows} W={width}", rows, width, dev,
                                         peaks, eps).items():
            out[f"{name}[{tag}]"] = {**rec, "name": f"{name}[{tag}]"}
    return out


def phase_onnx(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None, batch=32,
               timed=True) -> dict:
    """CLIP-ViT-B-32 and the MobileCLIP-S0 scale as reference-format ONNX
    dirs exported from the torch mirrors (full width and depth unless
    ``layers``/``vocab_size`` cut them for a CPU rehearsal), converted by
    ``Clip.from_local_dir`` on ``device`` (the route each tower took
    asserted, no executor fallback or unverified conversion), held against
    the mirrors in f32 (min cosine 0.999; classify's order), launch counts
    per call, the kernel path against the plain path; ViT-B-32 under
    int8_all and the MCT tower under int8; each graph through the executor
    on ``device`` against its mirror in f32 (1 - 1e-5); images/s, p50 and
    texts/s of the converted towers and of the executor, and the converted
    ViT-B-32's device time by kernel group."""
    import shutil
    import tempfile

    from clip_embedder_tpu_torch import Clip, TextEmbedder
    from clip_embedder_tpu_torch.onnx_exec import OnnxTower
    from clip_embedder_tpu_torch.ops.normalize import l2_normalize
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    free_device_memory()
    images = mixed_batch(batch)
    arrays = [to_rgb_array(im) for im in images]
    texts = captions(batch, 70)
    out = {}
    routes = {"CLIP-ViT-B-32": ("vit", "text_transformer", OPENAI_PREPROCESS, "int8_all"),
              "MobileCLIP-S0 scale": ("fastvit", "mct", S0_PREPROCESS, "int8")}
    with tempfile.TemporaryDirectory(prefix="onnx_dirs_") as tmp:
        for name, (want_v, want_t, preprocess, qmode) in routes.items():
            rec = out[name] = {}
            cfg, vision_ref, text_ref = onnx_mirrors(name, layers=layers, vocab_size=vocab_size)
            src = Path(tmp) / name.replace(" ", "_")
            rec.update(write_onnx_dir(src, cfg, vision_ref, text_ref, preprocess))
            d = Path(tmp) / f"{src.name}_converted"
            shutil.copytree(src, d)
            say(f"[11] {name}: exported visual.onnx {rec['visual_mb']:.1f} MiB in "
                f"{rec['visual_export_s']:.1f} s, text.onnx {rec['text_mb']:.1f} MiB in "
                f"{rec['text_export_s']:.1f} s (f32, opset 18, TorchScript exporter)")

            warned = fallback_keys()
            t = time.perf_counter()
            clip = Clip.from_local_dir(d, device=device, dtype=dtype)
            rec["convert_s"] = time.perf_counter() - t
            fired = fallback_keys() - warned
            vspec, tspec = clip.vision.spec, clip.text.spec
            say(f"  converted in place on {device} in {rec['convert_s']:.2f} s: vision "
                f"{vspec.family}, text {tspec.family} ({tspec.cfg})")
            if (vspec.family, tspec.family) != (want_v, want_t) or fired:
                raise AssertionError(f"{name}: converted to ({vspec.family}, {tspec.family}), "
                                     f"want ({want_v}, {want_t}); fallback warnings {fired}")
            t = time.perf_counter()
            clip = Clip.from_local_dir(d, device=device, dtype=dtype)
            rec["reload_s"] = time.perf_counter() - t
            say(f"  second load (from the npz) in {rec['reload_s']:.2f} s")

            # against the mirrors in f32, on the same pixels and ids
            warm(lambda: clip.vision.embed_images(images), lambda: clip.text.embed_texts(texts),
                 lambda: clip.classify(images[0], LABELS))
            reset_launch_counts()
            embs = clip.vision.embed_images(images)
            n_img = launch_counts()
            reset_launch_counts()
            temb = clip.text.embed_texts(texts)
            n_txt = launch_counts()
            pixels = clip.vision.preprocess_batch(images)
            ids = clip.text.tokenize(texts)[0]
            ref_v, ref_t = mirror_embeddings(vision_ref, text_ref, pixels, ids, device)
            cos_v, cos_t = cosines(embs, ref_v).min(), cosines(temb, ref_t).min()
            say(f"  against the mirrors in f32 (same pixels and ids): min cosine images "
                f"{cos_v:.6f}, texts {cos_t:.6f} (need >= 0.999)")
            if min(cos_v, cos_t) < 0.999:
                raise AssertionError(f"{name}: the converted towers disagree with the mirrors")
            reset_launch_counts()
            results = clip.classify(images[0], LABELS)
            n_cls = launch_counts()
            scale, bias = clip._scale_bias()
            lpix = clip.vision.preprocess_batch(images[:1])
            lids = clip.text.tokenize(LABELS)[0]
            lv, lt = mirror_embeddings(vision_ref, text_ref, lpix, lids, device)
            hold_label_order(f"{name} classify", results, lt @ lv[0] * scale + bias, LABELS,
                       gap=2 * 2e-3 * scale)
            # launches per call, from the gates
            rows_v = (vspec.cfg.seq_len if vspec.family == "vit" else 0)
            want = {"embed_images": onnx_launches(vspec, None, batch * rows_v),
                    "embed_texts": onnx_launches(tspec, None, batch * 77)}
            one_v = onnx_launches(vspec, None, rows_v)
            lab_t = onnx_launches(tspec, None, len(LABELS) * 77)
            want["classify"] = {k: one_v[k] + lab_t[k] for k in one_v}
            got = {"embed_images": n_img, "embed_texts": n_txt, "classify": n_cls}
            for what, n in got.items():
                say(f"  launches, {what}: {n}")
            if device == "cuda" and got != want:
                raise AssertionError(f"{name}: launched {got}, expected {want}")
            rec["launches"] = got
            hold_towers(clip, vspec, tspec, embs, images, None, name, texts=texts)

            # the quantized mode: ViT-B-32's whole Clip, S0's MCT text tower
            if name == "CLIP-ViT-B-32":
                qclip = Clip.from_local_dir(d, device=device, dtype=dtype, quantize=qmode)
                qtext = qclip.text
            else:
                qclip, qtext = None, TextEmbedder.from_local_dir(d, device=device, dtype=dtype,
                                                                 quantize=qmode)
            qn = {}
            if qclip is not None:
                warm(lambda: qclip.vision.embed_images(images))
                reset_launch_counts()
                qe = qclip.vision.embed_images(images)
                qn["embed_images"] = launch_counts()
                say(f"  {qmode}: images against bf16 min cosine {cosines(qe, embs).min():.6f}")
            warm(lambda: qtext.embed_texts(texts))
            reset_launch_counts()
            qt = qtext.embed_texts(texts)
            qn["embed_texts"] = launch_counts()
            say(f"  {qmode}: texts against bf16 min cosine {cosines(qt, temb).min():.6f}; "
                f"launches {qn}")
            qwant = {"embed_images": onnx_launches(vspec, qmode, batch * rows_v),
                     "embed_texts": onnx_launches(tspec, qmode, batch * 77)}
            if device == "cuda" and any(qn[k] != qwant[k] for k in qn):
                raise AssertionError(f"{name} {qmode}: launched {qn}, expected {qwant}")
            rec["int8_launches"] = qn
            if qclip is not None:
                hold_towers(qclip, vspec, tspec, qe, images, qmode, f"{name} {qmode}",
                            texts=texts)
            else:
                with plain_int8_wrappers():
                    qp = eager_texts(qtext, texts)
                c = cosines(qt, qp).min()
                say(f"  text: kernel path vs the plain int8 wrappers (same weights): min "
                    f"cosine {c:.6f} (need >= 0.999)")
                if c < 0.999:
                    raise AssertionError(f"{name} {qmode}: the text tower's kernel path "
                                         "disagrees with the plain int8 wrappers")
            if timed:
                rec["int8"] = {**time_embedder(qclip.vision, arrays, f"{name} {qmode}")} \
                    if qclip is not None else {}
                rec["int8"].update(time_texts(qtext, texts, f"{name} {qmode}"))
            del qclip, qtext
            free_device_memory()

            # the executor on the same graphs, f32, against the mirrors
            for tower, ref, feed in (("visual", ref_v, ("pixel_values", pixels)),
                                     ("text", ref_t, ("input_ids", ids))):
                graph = OnnxTower(d / f"{tower}.onnx", device=device)
                x = torch.from_numpy(feed[1]).to(device)
                with torch.inference_mode():
                    e = l2_normalize(graph({feed[0]: x.float() if tower == "visual" else x})
                                     ).float().cpu().numpy()
                c = cosines(e, ref).min()
                say(f"  executor (onnx_exec) on {tower}.onnx, f32 on {device}: min cosine to "
                    f"the mirror {c:.8f} (need >= {1 - 1e-5})")
                if c < 1 - 1e-5:
                    raise AssertionError(f"{name}: the executor disagrees with the mirror")
                del graph
            ev = et = None
            if device == "cuda":
                # the executor's towers behind the embedders, captured (a graph
                # a batch bucket), against their eager forwards
                ev, et = executor_embedders(clip, d, device, dtype)
                rows, n = ev.embed_images_device(images)
                rec["executor_captured"] = {
                    "vision": hold_captured(f"{name} executor vision", rows[:n],
                                            eager_rows(ev, images)),
                    "text": hold_captured(f"{name} executor text",
                                          torch.from_numpy(et.embed_texts(texts)),
                                          eager_text_rows(et, texts))}
            if timed:
                rec.update(time_embedder(clip.vision, arrays, f"{name} converted"))
                rec.update(time_texts(clip.text, texts, f"{name} converted"))
                rec["executor"] = {**time_embedder(ev, arrays, f"{name} executor"),
                                   **time_texts(et, texts, f"{name} executor")}
                if name == "CLIP-ViT-B-32":
                    rec["breakdown"] = profile_embedder(clip.vision, arrays,
                                                        f"{name} converted vision")
                    rec["text_breakdown"] = device_breakdown(lambda: clip.text.embed_texts(texts))
                    say("  text device ms by kernel group: " + ", ".join(
                        f"{k} {v:.3f}" for k, v in rec["text_breakdown"]["groups_ms"].items()))
            del clip, ev, et, vision_ref, text_ref
            free_device_memory()
    return out


# ---------------------------------------------------------------------------
# phase 12: the sharded path (parallel/)
# ---------------------------------------------------------------------------

SHARDED_COSINE = 1 - 1e-3  # sharded rows against unsharded: the port's bf16 budget


def hold_tie_swaps(ids, ref_ids, ref_scores, tie: float) -> int:
    """``ids`` against the dense top-k's ``ref_ids``: equal, except where the
    dense scores at the two positions lie within ``tie`` (two products in
    other orders may swap a near-tie). Returns the number of such swaps."""
    swaps = 0
    for row, (got, want, scores) in enumerate(zip(ids, ref_ids, ref_scores)):
        for j in np.flatnonzero(got != want):
            if not any(abs(scores[j] - scores[i]) <= tie for i in np.flatnonzero(want == got[j])):
                raise AssertionError(f"search ids {got} against the dense top-k {want} (query "
                                     f"{row})")
            swaps += 1
    return swaps


def eager_tp_images(sharded, images) -> np.ndarray:
    """``sharded.embed_images(images)`` with each mesh row's ``TPViT`` called
    directly, eagerly (the shards' pixels from the same staged preprocess):
    the route the captured TP forward is held to."""
    from clip_embedder_tpu_torch.parallel.embed import _batch_bucket, _gather
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    arrays = [to_rgb_array(im) for im in images]
    pp = sharded.inner.preprocessor
    padded = pp.padded_size(arrays)
    per = _batch_bucket(len(arrays), sharded.mesh.shape["data"]) // sharded.mesh.shape["data"]
    with torch.inference_mode():
        outs = [tower(pp.run(arrays[i * per:(i + 1) * per], device=dev, batch_bucket=per,
                             padded=padded), attn_impl=sharded.attn_impl, channels_first=True)
                for i, (dev, tower) in enumerate(zip(sharded.devices, sharded.towers))]
        return _gather(outs)[:len(arrays)].float().cpu().numpy()


def phase_sharded(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None, batch=32,
                  stream=256, corpus_rows=1 << 20, clients=64, timed=True) -> dict:
    """Phase 12: ViT-SO400M-16-SigLIP2-384 at full width through the
    port's scale-out layer (``parallel``) on meshes of two entries of one
    device (``layers``, ``vocab_size`` and the counts cut it for a CPU
    rehearsal): DP in bf16 and ``int8_all``, TP (no kernel), the sharded
    text embedder, ``EmbedPipeline``, ``CorpusIndex`` and ``ClipServer``
    with ``mesh=``. Rows are held against the unsharded embedders at
    cosine 1 - 1e-3: a shard of 16 may take other cuBLAS algorithms than
    one batch of 32."""
    import base64
    import tempfile

    from clip_embedder_tpu_torch.errors import ConfigError
    from clip_embedder_tpu_torch.parallel import (CorpusIndex, EmbedPipeline,
                                                  ShardedTextEmbedder, ShardedVisionEmbedder,
                                                  get_mesh)
    from clip_embedder_tpu_torch.serving import ClipServer, warmup
    from clip_embedder_tpu_torch.utils.images import to_rgb_array
    from clip_embedder_tpu_torch.utils.logging import _warned_once

    free_device_memory()
    say(f"[12] sharded path: ViT-SO400M-16-SigLIP2-384, {dtype}, phase 5's weights, through "
        "clip_embedder_tpu_torch.parallel")
    clip, vspec, tspec = build_clip(device, dtype, layers=layers, vocab_size=vocab_size)
    depth_v, depth_t = vspec.cfg.layers, tspec.cfg.layers
    card = device == "cuda"
    entry = "cuda:0" if card else "cpu"
    out: dict = {}

    # 1. the default mesh: every visible card once
    if card:
        full = get_mesh()
        want = {"data": torch.cuda.device_count(), "model": 1}
        say(f"  get_mesh(): {full}")
        if dict(full.shape) != want:
            raise AssertionError(f"get_mesh() is {dict(full.shape)}, expected {want}")

    # 2. DP over two entries of one device, bf16 then int8_all
    dp = get_mesh(devices=[entry] * 2)
    images = mixed_batch(batch)
    sharded = ShardedVisionEmbedder(clip.vision, dp)
    warm(lambda: sharded.embed_images(images))
    reset_launch_counts()
    embs = sharded.embed_images(images)
    counts = launch_counts()
    cos = cosines(embs, clip.vision.embed_images(images))
    want = dict.fromkeys(_wrappers(), 0)
    if card:
        want.update(ln_qkv=2 * depth_v, flash_attention_packed=2 * depth_v)
    say(f"  DP {dp}: embed_images {embs.shape}, against unsharded min cosine {cos.min():.7f} "
        f"(need >= {SHARDED_COSINE}); launches {counts}")
    if embs.shape != (batch, vspec.cfg.embed_dim) or not np.isfinite(embs).all():
        raise AssertionError("DP embed_images returned bad embeddings")
    if cos.min() < SHARDED_COSINE or counts != want:
        raise AssertionError(f"DP: cosine {cos.min()}, launches {counts} (want {want})")
    out["dp"] = {"launches": counts, "cosine": float(cos.min())}
    if timed:
        arrays = [to_rgb_array(im) for im in images]
        out["dp"]["unsharded"] = time_embedder(clip.vision, arrays, "unsharded bf16")
        out["dp"].update(time_embedder(sharded, arrays, "DP bf16, 2 shards of one card"))

    clip_q, _, _ = build_clip(device, dtype, layers=layers, vocab_size=vocab_size,
                              quantize="int8_all")
    sharded_q = ShardedVisionEmbedder(clip_q.vision, dp)
    warm(lambda: sharded_q.embed_images(images))
    reset_launch_counts()
    embs_q = sharded_q.embed_images(images)
    counts_q = launch_counts()
    cos_q = cosines(embs_q, clip_q.vision.embed_images(images))
    # two shard forwards of the vision tower: expected_int8_launches' count
    # for two vision forwards and no text forward
    want_q = (expected_int8_launches("int8_all", depth_v, 0) if card
              else dict.fromkeys(_wrappers(), 0))
    say(f"  DP int8_all: against unsharded int8_all min cosine {cos_q.min():.7f}; launches "
        f"{counts_q}")
    if cos_q.min() < SHARDED_COSINE or counts_q != want_q:
        raise AssertionError(f"DP int8_all: cosine {cos_q.min()}, launches {counts_q} "
                             f"(want {want_q})")
    out["dp_int8_all"] = {"launches": counts_q, "cosine": float(cos_q.min())}
    if timed:
        out["dp_int8_all"].update(time_embedder(sharded_q, arrays, "DP int8_all, 2 shards"))

    # 3. TP over the model axis: the eager core, no kernel; its one row on
    # one device replays the TPViT's captured graph
    from clip_embedder_tpu_torch.utils import captured

    tp_mesh = get_mesh(devices=[entry] * 2, model_parallel=2)
    _warned_once.discard("tp-kernel-override")
    tp = ShardedVisionEmbedder(clip.vision, tp_mesh, tensor_parallel=True)
    warned = "tp-kernel-override" in _warned_once
    if card:
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved()
    t = time.perf_counter()
    tp.embed_images(images)  # on the card: the warm-up, the capture and a replay
    first_s = time.perf_counter() - t
    reset_launch_counts()
    embs_tp = tp.embed_images(images)
    counts_tp = launch_counts()
    cos_tp = cosines(embs_tp, clip.vision.embed_images(images))
    say(f"  TP {tp_mesh}: attn_impl {clip.vision.attn_impl!r} -> {tp.attn_impl!r} (override "
        f"warned: {warned}); against the replicated embedder min cosine {cos_tp.min():.7f}; "
        f"launches {counts_tp}")
    if tp.attn_impl != "eager" or (card and not warned) or any(counts_tp.values()) \
            or cos_tp.min() < SHARDED_COSINE:
        raise AssertionError(f"TP: impl {tp.attn_impl}, warned {warned}, launches "
                             f"{counts_tp}, cosine {cos_tp.min()}")
    graphs = captured.graphs_of(tp.towers[0])
    n_graphs = 0 if graphs is None else len(graphs.graphs)
    eq = hold_captured(f"TP {tp_mesh.shape}: {n_graphs} graph(s) of the TPViT; rows",
                       torch.from_numpy(embs_tp), torch.from_numpy(eager_tp_images(tp, images)))
    if captured.several_devices(tp_mesh.devices[0]) or n_graphs != int(card):
        raise AssertionError(f"TP: row {tp_mesh.devices[0]}, {n_graphs} graphs")
    try:
        ShardedVisionEmbedder(clip_q.vision, tp_mesh, tensor_parallel=True)
    except ConfigError as e:
        say(f"  TP on the int8_all embedder refused: {e}")
    else:
        raise AssertionError("TP on a quantized embedder was not refused")
    out["tp"] = {"cosine": float(cos_tp.min()), "captured": eq, "first_call_s": first_s}
    if card:
        pool = pool_mib(graphs)
        out["tp"].update(capture_s=sum(graphs.capture_seconds.values()), pool_mib=pool,
                         reserved_mib=mib(torch.cuda.memory_reserved() - reserved))
        say(f"  TP's first call (the warm-up, the capture, a replay) {first_s:.2f} s, the "
            f"capture {out['tp']['capture_s']:.2f} s of it; its graph's pool reserves "
            f"{'not measured' if pool is None else f'{pool:.1f} MiB'}; reserved memory "
            f"{out['tp']['reserved_mib']:+.1f} MiB over the call")
    if timed:
        out["tp"].update(time_embedder(tp, arrays, "TP bf16, 2 ranks of one card (captured)"))
        out["tp"]["eager"] = time_embedder(tp, arrays, "TP bf16, 2 ranks of one card (eager)",
                                           run=lambda xs: eager_tp_images(tp, xs))
        if card:
            out["tp"]["breakdown"] = profile_embedder(tp, arrays, "TP captured")
            out["tp"]["eager"]["breakdown"] = profile_embedder(
                tp, arrays, "TP eager", run=lambda xs: eager_tp_images(tp, xs))
    del tp, sharded_q, clip_q
    free_device_memory()

    # 4. the sharded text embedder
    texts = captions(batch, 12)
    sharded_t = ShardedTextEmbedder(clip.text, dp)
    warm(lambda: sharded_t.embed_texts(texts))
    reset_launch_counts()
    tembs = sharded_t.embed_texts(texts)
    counts_t = launch_counts()
    cos_t = cosines(tembs, clip.text.embed_texts(texts))
    want_t = dict.fromkeys(_wrappers(), 0)
    if card:
        want_t.update(ln_qkv=2 * depth_t, flash_attention_packed=2 * depth_t)
    say(f"  ShardedTextEmbedder: {tembs.shape}, against unsharded min cosine "
        f"{cos_t.min():.7f}; launches {counts_t}")
    if cos_t.min() < SHARDED_COSINE or counts_t != want_t:
        raise AssertionError(f"sharded text: cosine {cos_t.min()}, launches {counts_t}")
    out["text"] = {"cosine": float(cos_t.min())}

    # 5. EmbedPipeline over a stream of the JPEGs (decoded in its pool)
    paths = [str(p) for p in sorted(IMAGES.glob("*.jpg"))]
    files = (paths * (stream // len(paths) + 1))[:stream]
    pipe = EmbedPipeline(sharded, batch_size=batch, prefetch=2)
    t = time.perf_counter()
    blocks = list(pipe.embed_iter(files))
    pipe_s = time.perf_counter() - t
    t = time.perf_counter()
    direct = [sharded.embed_images(files[i:i + batch]) for i in range(0, stream, batch)]
    loop_s = time.perf_counter() - t
    cos_p = cosines(np.concatenate(blocks), np.concatenate(direct))
    say(f"  EmbedPipeline over {stream} JPEGs (batch {batch}, prefetch 2): {len(blocks)} "
        f"blocks in order, against direct calls min cosine {cos_p.min():.7f}; "
        f"{stream / pipe_s:.2f} images/s against a plain loop of embed_images "
        f"{stream / loop_s:.2f} (host clock, decode included)")
    if [b.shape[0] for b in blocks] != [d.shape[0] for d in direct] \
            or cos_p.min() < 1 - 1e-6:
        raise AssertionError("EmbedPipeline's blocks differ from the direct calls")
    out["pipeline"] = {"images_per_s": stream / pipe_s, "loop_images_per_s": stream / loop_s}
    del blocks, direct
    free_device_memory()

    # 6. CorpusIndex: unit rows at SO400M's embedding width, over the DP
    # mesh's data axis; the queries are the DP image embeddings
    width = vspec.cfg.embed_dim
    gen = torch.Generator(device=device).manual_seed(12)
    rows = torch.randn(corpus_rows, width, generator=gen, device=device)
    rows /= rows.norm(dim=-1, keepdim=True)
    host = rows.cpu().numpy()
    t = time.perf_counter()
    index = CorpusIndex.build(host, dp)
    if card:
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    k = 10
    from clip_embedder_tpu_torch.ops.preprocess import bucket_batch
    from clip_embedder_tpu_torch.parallel.search import _sharded_topk
    from clip_embedder_tpu_torch.utils import captured

    if card:
        torch.cuda.reset_peak_memory_stats()
        reserved = torch.cuda.memory_reserved()
    vals, ids = index.search(embs, k)
    if card:  # what the index's graphs keep for as long as it lives
        pool = pool_mib(captured.graphs_of(index))
        out["search_memory"] = {
            "pool_mib": pool, "reserved_before_mib": mib(reserved),
            "reserved_after_mib": mib(torch.cuda.memory_reserved()),
            "max_reserved_mib": mib(torch.cuda.max_memory_reserved())}
        say(f"  CorpusIndex.search's first call (the capture): its graphs' pool reserves "
            f"{'not measured' if pool is None else f'{pool:.1f} MiB'}; reserved "
            f"{mib(reserved):.1f} MiB before, {mib(torch.cuda.memory_reserved()):.1f} after, "
            f"peak {mib(torch.cuda.max_memory_reserved()):.1f}")
    # the captured search (one graph over both shards of the one device,
    # merged after it) against the same search run eagerly

    qb, kb = bucket_batch(embs.shape[0]), bucket_batch(k)
    q = np.concatenate([embs, np.zeros((qb - embs.shape[0], width), np.float32)])
    # the eager reference in full f32, as the index's default precision
    # captures: the embedders turned the process's TF32 flag off
    assert index.precision == "highest" and not torch.backends.cuda.matmul.allow_tf32
    evals, eids = _sharded_topk(q, index._shards, index._counts, k=kb)
    eids = eids.cpu().numpy()[:embs.shape[0], :k]
    evals = evals.float().cpu().numpy()[:embs.shape[0], :k]
    n_graphs = len(getattr(captured.graphs_of(index), "graphs", {}))
    same = bool(np.array_equal(ids, eids))
    score_diff = float(np.abs(vals - evals).max())
    say(f"  CorpusIndex.search: {n_graphs} captured graphs; ids equal to the eager "
        f"search's {same}, scores bitwise equal {score_diff == 0} (max diff {score_diff:.3e}, "
        f"need <= 1e-6) {'ok' if same and score_diff <= 1e-6 else 'FAIL'}")
    if not same or score_diff > 1e-6 or n_graphs != int(card):
        raise AssertionError("the captured search differs from the eager one")
    with torch.inference_mode():
        dense = torch.matmul(torch.from_numpy(embs).to(device), rows.T)
        dvals, dids = torch.topk(dense, k, dim=1)
    dvals, dids = dvals.cpu().numpy(), dids.cpu().numpy()
    swaps = hold_tie_swaps(ids, dids, dvals, 1e-6)
    err = float(np.abs(vals - dvals).max())
    times = []
    for _ in range(10):
        t = time.perf_counter()
        index.search(embs, k)
        times.append(time.perf_counter() - t)
    search_ms = statistics.median(times) * 1e3
    mem = (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, peak "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f}" if card else "not measured")
    say(f"  CorpusIndex of {corpus_rows} x {width} f32 rows ({host.nbytes / 1e9:.2f} GB) over "
        f"{len(index.devices)} shards: build {build_s:.2f} s; search of {embs.shape[0]} "
        f"queries, k={k}: ids equal to the dense matmul + topk ({swaps} near-tie swaps), "
        f"scores within {err:.2e} (need <= 1e-5); {search_ms:.3f} ms a search (median of 10, "
        f"host clock, queries in and results out); device memory {mem}")
    if err > 1e-5:
        raise AssertionError(f"CorpusIndex scores {err} from the dense top-k")
    out["search"] = {"build_s": build_s, "search_ms": search_ms, "swaps": swaps,
                     "max_abs_err": err, "eager_score_diff": score_diff}
    del index, rows, host, dense
    free_device_memory()

    # 7. ClipServer over the DP mesh: one client, then concurrent clients
    t = time.perf_counter()
    warmup(ShardedVisionEmbedder(clip.vision, dp), batch_sizes=(1, 8, batch), texts=False)
    warmup(ShardedTextEmbedder(clip.text, dp), batch_sizes=(1, 8, batch))
    say(f"  warmup of the sharded embedders in {time.perf_counter() - t:.2f} s")
    jpgs = jpeg_bytes(mixed_batch(max(batch, clients)))
    b64 = [base64.b64encode(j).decode() for j in jpgs]
    server = ClipServer(clip, max_batch=32, mesh=dp)
    try:
        if server.mesh is not dp:
            raise AssertionError("server.mesh is not the mesh it was given")
        reset_launch_counts()  # the buckets warmed above
        served = {
            "image": http(server, "/v1/embed/image", jpgs[0], "image/jpeg"),
            "images": http(server, "/v1/embed/image", {"images_b64": b64[:batch]}),
            "text": http(server, "/v1/embed/text", {"texts": [LABELS[0]]}),
            "texts": http(server, "/v1/embed/text", {"texts": texts}),
            "classify": http(server, "/v1/classify", {"image_b64": b64[1],
                                                      "labels": LABELS}),
            "rank": http(server, "/v1/rank", {"images_b64": b64[:8], "text": LABELS[1]}),
        }
        counts_s = launch_counts()
        # 4 vision and 4 text requests, each two shard forwards
        want_s = dict.fromkeys(_wrappers(), 0)
        if card:
            want_s.update(ln_qkv=8 * (depth_v + depth_t),
                          flash_attention_packed=8 * (depth_v + depth_t))
        cos_s = {
            "image": hold_rows("image", served["image"]["embeddings"],
                               clip.vision.embed_images([jpgs[0]]), SHARDED_COSINE),
            "images": hold_rows("images", served["images"]["embeddings"],
                                clip.vision.embed_images(jpgs[:batch]), SHARDED_COSINE),
            "text": hold_rows("text", served["text"]["embeddings"],
                              clip.text.embed_texts([LABELS[0]]), SHARDED_COSINE),
            "texts": hold_rows("texts", served["texts"]["embeddings"],
                               clip.text.embed_texts(texts), SHARDED_COSINE),
        }
        dp_max = {name: max(abs(g[1] - r[1]) for g, r in zip(
            sorted(served[name]["results"]), sorted(ref)))
            for name, ref in (("classify", clip.classify(jpgs[1], LABELS)),
                              ("rank", clip.rank_images(jpgs[:8], LABELS[1])))}
        say(f"  mesh server, one client through every endpoint: rows against the unsharded "
            f"direct call min cosine {', '.join(f'{n} {c:.7f}' for n, c in cos_s.items())}; "
            f"classify and rank probabilities within {dp_max} of the unsharded Clip's "
            f"(printed, not gated); launches {counts_s}")
        if counts_s != want_s:
            raise AssertionError(f"mesh server launches {counts_s}, expected {want_s}")
        direct = np.concatenate([clip.vision.embed_images(jpgs[i:i + 32])
                                 for i in range(0, clients, 32)])
        with tempfile.TemporaryDirectory(prefix="clip_smoke_jpegs_") as jdir:
            files = [Path(jdir) / f"{i}.jpg" for i in range(clients)]
            for path, data in zip(files, jpgs):
                path.write_bytes(data)
            out["server"] = serve_concurrently(server, files, direct[:clients], "mesh server",
                                               device, bound=SHARDED_COSINE)
        out["server"]["single_client"] = cos_s
    finally:
        server.close()
    return out


# a variant's first loss and its second (after one update) against the
# unsharded run's
TRAIN_RTOL = 1e-4
# A fine-tuning rate. At TrainConfig's default 1e-4, AdamW's first steps
# (≈ lr·sign(g) on all 1.136 B parameters) threw the random full-depth
# towers about on one batch: losses 9.54, 7.28, 18.63, 8.66, 10.18.
# tools/train_witness.py runs both rates in both packages at a cut depth.
TRAIN_LR = 1e-5


def so400m_train_config(*, layers=None, vocab_size=None, **kw):
    """ViT-SO400M-16-SigLIP2-384 resolved through the port's config → build
    as a ``train.TrainConfig`` (SigLIP loss, remat, ``TRAIN_LR``; ``kw``
    sets the rest),
    and its open_clip config for a model dir."""
    import copy
    import dataclasses

    from clip_embedder_tpu_torch.config import OpenClipConfig
    from clip_embedder_tpu_torch.models.build import resolve_text, resolve_vision
    from clip_embedder_tpu_torch.train import TrainConfig

    model_cfg = copy.deepcopy(SO400M_SIGLIP2_384)
    if layers is not None:
        cut_vision_depth(model_cfg["vision_cfg"], layers)
        model_cfg["text_cfg"]["layers"] = layers
    if vocab_size is not None:
        model_cfg["text_cfg"]["vocab_size"] = vocab_size
    occ = {"model_cfg": model_cfg, "preprocess_cfg": SIGLIP_PREPROCESS}
    config = OpenClipConfig.from_dict(occ)
    vspec, tspec = resolve_vision(config.model_cfg), resolve_text(config.model_cfg)
    if (vspec.family, tspec.family) != ("vit", "text_transformer"):
        raise AssertionError(f"SO400M resolved to {vspec.family} + {tspec.family}")
    cfg = TrainConfig(vision_cfg=vspec.cfg, text_cfg=tspec.cfg, loss="siglip", remat=True,
                      learning_rate=TRAIN_LR)
    return dataclasses.replace(cfg, **kw), occ


def train_step_flops(cfg, batch: int) -> float:
    """The products' FLOPs of one remat training step, from the shapes: 4
    forwards (the forward, the blocks' recompute, and the backward's two
    products for each one of the forward). A forward counts the linears
    (2·tokens·in·out), attention's two products (4·S²·width a block) and
    the map pool's probe."""
    v, t = cfg.vision_cfg, cfg.text_cfg
    s, w, m = v.seq_len, v.width, v.mlp_hidden
    vision = 2 * s * v.patch_size ** 2 * 3 * w
    vision += v.layers * (2 * s * (4 * w * w + 2 * w * m) + 4 * s * s * w)
    if v.pool == "map":
        pm = v.pool_mlp_hidden or m
        vision += 2 * s * 2 * w * w + 2 * 2 * w * w + 4 * s * w + 2 * 2 * w * pm
    if v.use_proj:
        vision += 2 * w * v.embed_dim
    n, tw, tm = t.context_length, t.width, t.mlp_hidden
    text = t.layers * (2 * n * (4 * tw * tw + 2 * tw * tm) + 4 * n * n * tw)
    text += 2 * tw * t.embed_dim
    return 4.0 * batch * (vision + text)


def timed_step(step, params, opt, batch, card):
    """One train step; (params, opt, loss as a float, host seconds to its end)."""
    t = time.perf_counter()
    params, opt, loss = step(params, opt, batch)
    loss = float(loss)
    if card:
        torch.cuda.synchronize()
    return params, opt, loss, time.perf_counter() - t


def train_run(step, params, opt, batch, steps: int, card) -> tuple[list, list]:
    """``steps`` train steps: their losses and host seconds. On the card
    the graph a captured step made is then held to its kernel nodes
    (``hold_graphs``) while its optimizer, which owns it, lives."""
    losses, secs = [], []
    for _ in range(steps):
        params, opt, loss, s = timed_step(step, params, opt, batch, card)
        losses.append(loss)
        secs.append(s)
    if card:
        hold_graphs()
    return losses, secs


def eager_step(cfg, mesh=None):
    """``train.eager_train_step`` as a step function (the route the
    captured step is held to)."""
    from clip_embedder_tpu_torch import train as tt

    return lambda p, o, b: tt.eager_train_step(p, o, b, cfg=cfg, mesh=mesh)


# The captured step against the eager one from the same state, on the CPU
# rehearsal: there both routes are the same eager code, yet the ring and TP
# layouts' leaves differed by up to 9.3e-10 after two steps (one tensor in
# 60 and 90), as the CPU's reductions may vectorize by the buffers'
# alignment. On the card the graph replays the eager step's kernels: bitwise.
CPU_TRAIN_ATOL = 1e-6


def hold_train(what, cap, eag, cap_params, eag_params, card) -> dict:
    """A captured run against the eager run from the same initial state:
    their losses, and every stepped tensor after the last step. Gate: on
    the card both bitwise equal; on the CPU each loss within
    ``TRAIN_RTOL`` and each tensor within ``CPU_TRAIN_ATOL``."""
    from clip_embedder_tpu_torch.train import _stepped

    pa, pb = _stepped(cap_params), _stepped(eag_params)
    same = [bool(torch.equal(a, b)) for a, b in zip(pa, pb)]
    diff = max(float((a.detach().float() - b.detach().float()).abs().max())
               for a, b in zip(pa, pb))
    rel = max(abs(c - e) / abs(e) for c, e in zip(cap, eag))
    r = {"losses": cap, "eager_losses": eag, "losses_equal": cap == eag,
         "leaves_equal": all(same), "leaves_max_diff": diff, "loss_rel": rel}
    if card:
        ok, need = r["losses_equal"] and r["leaves_equal"], "need both bitwise equal"
    else:
        ok = rel <= TRAIN_RTOL and diff <= CPU_TRAIN_ATOL
        need = f"need <= {TRAIN_RTOL} and <= {CPU_TRAIN_ATOL} on the CPU"
    ok = ok and len(pa) == len(pb)
    say(f"  {what}: captured losses {[round(x, 6) for x in cap]} against eager "
        f"{[round(x, 6) for x in eag]}: losses bitwise equal {r['losses_equal']} (largest "
        f"relative difference {rel:.3e}); after {len(cap)} steps the {len(pa)} stepped tensors "
        f"bitwise equal {r['leaves_equal']} ({sum(same)} of {len(pa)}; largest difference "
        f"{diff:.3e}); {need} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the captured train step differs from the eager one")
    return r


# The captured step against torch's lazy AdamW (``capturable=False``: its
# state made at its first step, its step count on the host; the code the
# CPU's optimizer runs, which tests/test_torch_train.py holds to optax) on
# the same device, a step at a time from the same state: before each step
# the lazy run takes the captured run's params and, after its own first
# step, its optimizer state (``load_state_dict``, the resume path, which
# gives the lazy optimizer its own flavour back). Run free, the two drift
# apart: Adam moves a coordinate by about lr whatever its gradient's size,
# so one whose gradient is rounding noise moves by lr on the noise's sign
# (the updates' L2 norms 0.3% apart after 3 golden steps and 8.8% after 6
# SO400M steps; the losses 5.0e-6 and 2.2e-6 apart). From one state the
# forward and backward are the same kernels, so the loss and both moments
# come out bitwise equal and the step counts equal; the update differs by
# how the two take the bias corrections: the capturable one in f32 on the
# card, where 1 - β2 loses 1.3e-5 of itself (β2 = 0.999 is 0.99900001 in
# f32), moving √(1 - β2^t) and so the update by up to 6.4e-6; the lazy one
# in Python doubles. Gate: each parameter within LAZY_UPDATE_RTOL of its
# step's update, plus one rounding of the parameter (eps·|p|). A step
# count off by one or a bias correction left out moves the first update by
# 26% or 216%. On the CPU rehearsal both runs are the lazy AdamW, and the
# CPU's gradients may differ in their last bits between two runs from one
# state (``CPU_TRAIN_ATOL``'s comment): there the losses are held within
# ``TRAIN_RTOL`` and the moments within ``CPU_TRAIN_ATOL``.
LAZY_UPDATE_RTOL = 2e-5


def hold_lazy_steps(what, cap_step, cap_params, cap_opt, lazy_step, lazy_params, lazy_opt,
                    steps: int, card: bool) -> dict:
    """``steps`` steps of a captured run (``cap_step()``, its loss), each
    held against a step of the lazy AdamW's eager run (``lazy_step()``) from
    the same state, as above: the step counts equal; on the card the
    losses and both moments bitwise equal (on the CPU within the bounds
    above); each parameter within the gate, whose largest share used is
    returned as ``gate_share`` (1 the gate)."""
    import copy

    from clip_embedder_tpu_torch.train import _stepped

    cp, lp = _stepped(cap_params), _stepped(lazy_params)
    r = {"losses": [], "lazy_losses": [], "equal": True, "gate_share": 0.0}
    for k in range(steps):
        if k:  # the lazy optimizer made its state at its first step
            lazy_opt.load_state_dict(copy.deepcopy(cap_opt.state_dict()))
        with torch.no_grad():
            for a, b in zip(lp, cp):
                a.copy_(b)
        before = [t.detach().clone() for t in cp]
        lc, ll = cap_step(), lazy_step()
        r["losses"].append(lc)
        r["lazy_losses"].append(ll)
        r["equal"] &= lc == ll if card else abs(lc - ll) <= TRAIN_RTOL * abs(ll)
        for p0, a, b in zip(before, cp, lp):
            sa, sb = cap_opt.state[a], lazy_opt.state[b]
            moments = [(sa[m], sb[m]) for m in ("exp_avg", "exp_avg_sq")]
            r["equal"] &= (float(sa["step"]) == float(sb["step"]) and not sb["step"].is_cuda
                           and all(torch.equal(x, y) if card else
                                   float((x - y).abs().max()) <= CPU_TRAIN_ATOL
                                   for x, y in moments))
            a, b = a.detach(), b.detach()
            slack = (a - b).abs() - torch.finfo(a.dtype).eps * torch.maximum(a.abs(), b.abs())
            share = torch.where(slack <= 0, 0.0, slack / (LAZY_UPDATE_RTOL * (b - p0).abs()))
            r["gate_share"] = max(r["gate_share"], float(share.max()))
            del p0, slack, share
        del before
    ok = r["equal"] and r["gate_share"] <= 1
    say(f"  {what}, each step held against torch's lazy AdamW (capturable=False) from the "
        f"same state: losses {[round(x, 6) for x in r['losses']]}, lazy "
        f"{[round(x, 6) for x in r['lazy_losses']]}; losses, moments and step counts "
        f"{'bitwise equal' if card else 'equal within the CPU bounds'} {r['equal']}; "
        f"parameters at {r['gate_share']:.3f} of the gate ({LAZY_UPDATE_RTOL} of the update "
        f"+ eps·|p|) at most; {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the captured train step is not the lazy AdamW's")
    return r


def step_memory(card, before: int) -> float | None:
    """GiB allocated at the peak since ``reset_peak_memory_stats``, above
    ``before`` bytes (what other runs hold)."""
    return (torch.cuda.max_memory_allocated() - before) / 2**30 if card else None


def phase_training(device, dtype=torch.float32, *, layers=None, vocab_size=None, batch=16,
                   steps=5, timed=True) -> dict:
    """Phase 13: ViT-SO400M-16-SigLIP2-384 trained through
    ``clip_embedder_tpu_torch.train`` at full width and depth (``layers``,
    ``vocab_size``, ``batch`` and ``steps`` cut it for a CPU rehearsal), a
    fixed seeded batch: (a) unsharded steps, captured (on the card the step
    replays a CUDA graph of the forward, the backward and AdamW), held
    against as many eager steps (``train.eager_train_step``) from the same
    initial state, losses and every stepped tensor (the loss descends;
    s/step, samples/s, idle share, peak memory and the graph's pool,
    captured against eager); the same for 3 steps in bf16; (b) two steps
    each of DP, the ring loss, FSDP and TP on a mesh of two entries of one
    device from the same initial state, captured and held against two
    eager steps, both losses held against the unsharded run's first two:
    the second comes after the layout's backward pass and AdamW update, (c) the
    handoff: the trained tree exported into a model dir and served through
    ``Clip`` (bf16 on the card, through kernels 1 and 2) against the eager
    impl and against the trained tree's own f32 forward, (d) the kernel
    guard. The training path runs no kernel; every graph it captured is
    held to that (``launch_counts`` → ``hold_graphs``)."""
    import dataclasses
    import tempfile

    from clip_embedder_tpu_torch import Clip
    from clip_embedder_tpu_torch import train as tt
    from clip_embedder_tpu_torch.models.text_transformer import TextTransformer
    from clip_embedder_tpu_torch.models.vit import ViT
    from clip_embedder_tpu_torch.ops.flash import flash_attention_packed
    from clip_embedder_tpu_torch.parallel import get_mesh
    from clip_embedder_tpu_torch.utils import captured
    from clip_embedder_tpu_torch.weights import _flatten, tree_map

    free_device_memory()
    t_phase = time.perf_counter()
    card = device == "cuda"
    label = nvidia_smi() if card else "cpu"
    cfg, occ = so400m_train_config(layers=layers, vocab_size=vocab_size)
    vcfg, tcfg = cfg.vision_cfg, cfg.text_cfg
    say(f"[13] training: ViT-SO400M-16-SigLIP2-384 through clip_embedder_tpu_torch.train, "
        f"{dtype}, SigLIP loss, remat, vision {vcfg.layers}x{vcfg.width} ({vcfg.seq_len} "
        f"tokens, {vcfg.pool} pool), text {tcfg.layers}x{tcfg.width} (vocab "
        f"{tcfg.vocab_size}, ctx {tcfg.context_length}), batch {batch} (seed 0); the step "
        f"{'captured (a CUDA graph a batch shape)' if card else 'eager (the CPU)'}")
    rng = np.random.default_rng(0)
    data = {"pixels": rng.uniform(-1, 1, (batch, vcfg.image_size, vcfg.image_size, 3))
            .astype(np.float32),
            "input_ids": rng.integers(1, tcfg.vocab_size, (batch, tcfg.context_length))
            .astype(np.int32)}
    out: dict = {}

    def leaves_on(tree, dt=None):
        """Trainable leaves on the device, copied from a CPU tree."""
        return tree_map(lambda p: p.to(device, dt or p.dtype, copy=True).requires_grad_(True),
                        tree)

    # (a) unsharded, captured, then eager from the same initial state
    before = torch.cuda.memory_allocated() if card else 0
    t = time.perf_counter()
    params, _ = tt.init_train_state(torch.Generator(device=device).manual_seed(0), cfg,
                                    device=device, dtype=dtype)
    init = tree_map(lambda p: p.detach().cpu().clone(), params)
    n_params = sum(v.numel() for v in _flatten(init).values())
    say(f"  initialized {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t:.1f} s")
    tx = tt.make_optimizer(cfg)
    runs = {}
    reset_launch_counts()
    for route in ("captured", "eager"):
        if route == "eager":
            before = torch.cuda.memory_allocated() if card else 0
            params = leaves_on(init)
        opt = tt.init_opt_state(cfg, params)
        if card:
            torch.cuda.reset_peak_memory_stats()

        def step(p, o, b):
            return tt.train_step(p, o, b, cfg=cfg, tx=tx)

        losses, secs = train_run(step if route == "captured" else eager_step(cfg), params,
                                 opt, data, steps, card)
        graphs = captured.graphs_of(opt)
        s_step = statistics.median(secs[1:])
        runs[route] = {"losses": losses, "step_s": secs, "s_per_step": s_step,
                       "samples_per_s": batch / s_step, "peak_gib": step_memory(card, before),
                       "params": params, "opt": opt, "step": step if route == "captured"
                       else eager_step(cfg)}
        if route == "captured" and card:
            runs[route].update(capture_s=sum(graphs.capture_seconds.values()),
                               pool_mib=pool_mib(graphs))
    cap, eag = runs["captured"], runs["eager"]
    out["captured_vs_eager"] = hold_train(f"unsharded {dtype}, {steps} steps", cap["losses"],
                                          eag["losses"], cap["params"], eag["params"], card)
    losses, s_step = cap["losses"], cap["s_per_step"]
    flops = train_step_flops(cfg, batch)
    bound = flops / peaks_for(label)["f32"] if card else None
    out.update(losses=losses, step_s=cap["step_s"], s_per_step=s_step,
               samples_per_s=batch / s_step, peak_gib=cap["peak_gib"], step_flops=flops,
               bound_s=bound, capture_s=cap.get("capture_s"), pool_mib=cap.get("pool_mib"),
               eager={k: eag[k] for k in ("losses", "step_s", "s_per_step", "samples_per_s",
                                          "peak_gib")})
    for route, r in runs.items():
        first = (f"first {r['step_s'][0]:.4f} s, the capture {r['capture_s']:.2f} s of it; "
                 if route == "captured" and card else f"first {r['step_s'][0]:.4f} s; ")
        pool = ""
        if route == "captured" and card:
            mb = r["pool_mib"]
            pool = "; the graph's pool reserves " + (
                "not measured" if mb is None else f"{mb:.1f} MiB")
        say(f"  {steps} unsharded steps, {route}: losses {[round(x, 6) for x in r['losses']]}; "
            f"{r['s_per_step']:.4f} s/step (median of steps 2-{steps}, host clock to a "
            f"synchronize; {first}{batch / r['s_per_step']:.3f} samples/s, peak "
            + (f"{r['peak_gib']:.3f} GiB allocated above the other run's" if card
               else "not measured") + pool
            + f"; {flops / 1e12:.3f} TFLOP a step (products, from the shapes), bound at the "
            + (f"f32 peak {bound:.4f} s ({bound / r['s_per_step']:.3f} of the step)" if card
               else "f32 peak not measured") + f"; {label}")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"the training loss did not descend: {losses}")
    if timed and card:
        for route, r in runs.items():
            bd = device_breakdown(lambda: r["step"](r["params"], r["opt"], data))
            (out if route == "captured" else out["eager"])["breakdown"] = bd
            say(f"  one {route} step under torch.profiler: device busy {bd['busy_ms']:.3f} of "
                f"{bd['wall_ms']:.3f} ms (idle share {bd['idle_share']:.3f}); by group: "
                + ", ".join(f"{k} {v:.3f}" for k, v in sorted(bd["groups_ms"].items(),
                                                          key=lambda kv: -kv[1])))
    trained = tree_map(lambda p: p.detach().cpu(), cap["params"])
    cap_losses = cap["losses"]
    del params, opt, runs, cap, eag
    free_device_memory()

    # (a, held) the captured step held a step at a time against torch's lazy
    # AdamW, from the initial state: a new captured run (its own graph)
    held = min(3, steps)
    hold_params, lazy_params = leaves_on(init), leaves_on(init)
    hold_opt = tt.init_opt_state(cfg, hold_params)
    lazy_opt = tt.make_optimizer(cfg, capturable=False)(lazy_params)
    out["lazy_adamw"] = hold_lazy_steps(
        f"unsharded {dtype}, {held} steps",
        lambda: float(tt.train_step(hold_params, hold_opt, data, cfg=cfg, tx=tx)[2]),
        hold_params, hold_opt,
        lambda: float(tt.eager_train_step(lazy_params, lazy_opt, data, cfg=cfg)[2]),
        lazy_params, lazy_opt, held, card)
    if card and out["lazy_adamw"]["losses"] != cap_losses[:held]:
        raise AssertionError(f"a second captured run from the initial state: "
                             f"{out['lazy_adamw']['losses']}, not {cap_losses[:held]}")
    del hold_params, hold_opt, lazy_params, lazy_opt
    free_device_memory()

    # (a') bf16, never run on the card before this: 3 steps (fewer in a short
    # rehearsal) captured against eager
    low = {}
    for route in ("captured", "eager"):
        bparams = leaves_on(init, torch.bfloat16)
        for k in ("logit_scale", "logit_bias"):  # f32 whatever the towers' dtype
            bparams[k] = leaves_on(init[k])
        bopt = tt.init_opt_state(cfg, bparams)
        low[route] = train_run(
            (lambda p, o, b: tt.train_step(p, o, b, cfg=cfg, tx=tx)) if route == "captured"
            else eager_step(cfg), bparams, bopt, data, min(3, steps), card) + (bparams,)
    out["bf16"] = hold_train(f"unsharded bf16, {min(3, steps)} steps", low["captured"][0],
                             low["eager"][0], low["captured"][2], low["eager"][2], card)
    out["bf16"]["step_s"] = low["captured"][1]
    out["bf16"]["eager_step_s"] = low["eager"][1]
    bl = low["captured"][0]
    say(f"  bf16: losses {[round(x, 6) for x in bl]}, steps "
        f"{[round(x, 4) for x in low['captured'][1]]} s captured, "
        f"{[round(x, 4) for x in low['eager'][1]]} s eager (host clock); {label}")
    if not np.isfinite(bl).all() or not bl[-1] < bl[0]:
        raise AssertionError(f"the bf16 training loss did not descend: {bl}")
    del low
    free_device_memory()

    # (b) two steps of each layout from the same initial state, two entries of one
    # device, captured and eager
    mesh = get_mesh(devices=["cuda:0" if card else "cpu"] * 2)
    tp_mesh = get_mesh(devices=["cuda:0" if card else "cpu"] * 2, model_parallel=2)
    variants = {
        "dp": (cfg, mesh),
        "ring": (dataclasses.replace(cfg, ring_loss=True), mesh),
        "fsdp": (dataclasses.replace(cfg, fsdp=True), mesh),
        "tp": (dataclasses.replace(cfg, tensor_parallel=True), tp_mesh),
    }
    out["variants"] = {}
    ref = losses[:2]
    for name, (var_cfg, vmesh) in variants.items():
        got = {}
        for route in ("captured", "eager"):
            start = tree_map(lambda p: p.to(device), init)
            vstep, placed, vopt = tt.make_sharded_train_step(var_cfg, vmesh, start)
            del start
            run = vstep if route == "captured" else eager_step(var_cfg, vmesh)
            got[route] = train_run(run, placed, vopt, data, 2, card) + (placed,)
            del vstep, vopt
        (loss, loss2), (s, s2), placed = got["captured"]
        rel = [abs(g - w) / abs(w) for g, w in zip((loss, loss2), ref)]
        held = hold_train(f"{name} over {vmesh.shape}", [loss, loss2], got["eager"][0], placed,
                          got["eager"][2], card)
        out["variants"][name] = {"losses": [loss, loss2], "s": s, "s2": s2, "rel": rel,
                                 "eager_s": got["eager"][1], "captured_vs_eager": held}
        say(f"  {name} over {vmesh.shape}: losses {loss:.6f}, {loss2:.6f}, relative "
            f"{rel[0]:.2e} and {rel[1]:.2e} of the unsharded run's first two (the second after "
            f"one update; need <= {TRAIN_RTOL}); captured steps {s:.4f} s (the capture "
            f"included), {s2:.4f} s; eager {got['eager'][1][0]:.4f} s, {got['eager'][1][1]:.4f} "
            f"s; {label}")
        if not max(rel) <= TRAIN_RTOL:
            raise AssertionError(f"the {name} steps' losses {[loss, loss2]} are not the "
                                 f"unsharded {ref}")
        del got, placed
        free_device_memory()
    out["launches"] = launch_counts()
    if set(out["launches"].values()) != {0}:
        raise AssertionError(f"the training path launched kernels: {out['launches']}")

    # (c) the handoff: export, serve through Clip, hold against eager and the trained tree
    serve_dtype = torch.bfloat16 if card else dtype
    images = mixed_batch(8)
    with tempfile.TemporaryDirectory(prefix="clip_smoke_train_") as tmp:
        d = Path(tmp)
        (d / "open_clip_config.json").write_text(json.dumps(occ, indent=2))
        for name in ("tokenizer.json", "model_config.json"):
            (d / name).write_bytes((FIXTURES / "golden_siglip" / name).read_bytes())
        t = time.perf_counter()
        tt.export_trained_model(d, trained)
        export_s = time.perf_counter() - t
        clip = Clip.from_local_dir(d, device=device, dtype=serve_dtype)
        eager = Clip.from_local_dir(d, device=device, dtype=serve_dtype, attn_impl="eager")
    warm(lambda: clip.vision.embed_images(images), lambda: clip.text.embed_texts(LABELS))
    reset_launch_counts()
    embs = {"images": clip.vision.embed_images(images)}
    n_img = launch_counts()
    reset_launch_counts()
    embs["texts"] = clip.text.embed_texts(LABELS)
    n_txt = launch_counts()
    ref = {"images": eager.vision.embed_images(images), "texts": eager.text.embed_texts(LABELS)}
    pixels = torch.from_numpy(clip.vision.preprocess_batch(images)).to(device)
    ids = torch.from_numpy(clip.text.tokenize(LABELS)[0]).to(device)
    with torch.no_grad():
        on_dev = tree_map(lambda p: p.to(device), trained)
        own = {"images": ViT(vcfg, on_dev["visual"], trainable=True)(
                   pixels, channels_first=True).cpu().numpy(),
               "texts": TextTransformer(tcfg, on_dev["text"], trainable=True)(ids).cpu().numpy()}
    del on_dev
    eager_cos = {k: float(cosines(embs[k], ref[k]).min()) for k in embs}
    trained_cos = {k: float(cosines(embs[k], own[k]).min()) for k in embs}
    out["handoff"] = {"export_s": export_s, "eager_cosine": eager_cos,
                      "trained_cosine": trained_cos, "launches": {"embed_images": n_img,
                                                                 "embed_texts": n_txt}}
    say(f"  handoff: exported in {export_s:.2f} s, served in {serve_dtype}: min cosine against "
        f"the eager impl {eager_cos} (need >= 0.999), against the trained tree's f32 forward "
        f"{trained_cos} (printed); launches embed_images ln_qkv={n_img['ln_qkv']} "
        f"flash={n_img['flash_attention_packed']}, embed_texts ln_qkv={n_txt['ln_qkv']} "
        f"flash={n_txt['flash_attention_packed']}; {label}")
    if min(eager_cos.values()) < 0.999:
        raise AssertionError("the served handoff disagrees with the eager impl")
    if card:
        for call, n, depth in (("embed_images", n_img, vcfg.layers),
                               ("embed_texts", n_txt, tcfg.layers)):
            if (n["ln_qkv"], n["flash_attention_packed"]) != (depth, depth):
                raise AssertionError(f"{call}: kernel launches {n}, expected {depth} each of "
                                     "ln_qkv and flash_attention_packed")
    del clip, eager
    free_device_memory()

    # (d) the kernel guard: an operand that requires grad is refused on the card
    if card:
        q = torch.randn(2, 16, 256, device=device, dtype=torch.bfloat16, requires_grad=True)
        try:
            flash_attention_packed(q, q.detach(), q.detach(), num_heads=2)
        except RuntimeError as e:
            if "requires grad" not in str(e):
                raise
            say(f"  kernel guard: flash_attention_packed refused a q that requires grad ({e})")
        else:
            raise AssertionError("flash_attention_packed took a q that requires grad")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# the int8 sources: each runs its products on the s8 TMA + wgmma kernel
# ---------------------------------------------------------------------------
# phase 14: the captured forwards
# ---------------------------------------------------------------------------

# label, config, the modes run, build_clip's other arguments, the towers
# held (BiomedCLIP's text tower: BERT, with the tokenizer's mask in a static
# buffer; phase 10's families: their vision towers, layer scales 0.1; phase
# 11's CLIP-ViT-B-32 graphs run by the ONNX executor: ``executor_clip``)
CAPTURED_MODELS = (
    ("ViT-SO400M-16-SigLIP2-384", SO400M_SIGLIP2_384, (None, "int8_all"), {},
     ("vision", "text")),
    ("PE-Core-bigG-14-448", PE_CORE_BIGG_448, (None, "int8"), {"preprocess": PE_PREPROCESS},
     ("vision",)),
    ("BiomedCLIP", BIOMEDCLIP, (None,),
     {"preprocess": OPENAI_PREPROCESS, "tokenizer": "golden_hf_bert"}, ("text",)),
    *((name, model, (None,), {"preprocess": OPENAI_PREPROCESS, "tokenizer": "golden_model",
                              "layer_scale": 0.1}, ("vision",))
      for name, model, _ in FAMILY_MODELS),
    ("CLIP-ViT-B-32 executor", "CLIP-ViT-B-32", (None,), {"executor": True},
     ("vision", "text")),
)
# the models whose reserved memory is read with and without the layer
MEMORY_MODELS = ("ViT-SO400M-16-SigLIP2-384", "PE-Core-bigG-14-448")
CAPTURED_COSINE = 1 - 1e-6
THREAD_CALLS = 50


def row_cosine(got, ref) -> float:
    return float(torch.nn.functional.cosine_similarity(
        got.float().cpu(), ref.float().cpu(), dim=-1).min())


def hold_captured(what, got, ref) -> dict:
    """Captured rows against the eager tower's at cosine 1 - 1e-6; says
    whether they are bitwise equal."""
    cos = row_cosine(got, ref)
    bitwise = bool(torch.equal(got.float().cpu(), ref.float().cpu()))
    ok = cos >= CAPTURED_COSINE
    say(f"  {what}: captured vs eager min row cosine {cos:.9f} (need >= {CAPTURED_COSINE!r}), "
        f"bitwise equal {bitwise} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: the captured forward disagrees with the eager one")
    return {"cosine": cos, "bitwise": bitwise}


def captured_runners(emb, kind):
    """(captured, eager) of one embedder: each takes a batch and returns its
    rows, the captured ones as the embedder hands them out (the vision
    rows on the device, from ``embed_images_device``)."""
    if kind == "vision":
        def captured_run(xs):
            rows, n = emb.embed_images_device(xs)
            return rows[:n]
        return captured_run, lambda xs: eager_rows(emb, xs)
    return (lambda xs: torch.from_numpy(emb.embed_texts(xs)),
            lambda xs: eager_text_rows(emb, xs))


def hold_threads(what, run, batches, refs) -> int:
    """Two threads, ``THREAD_CALLS`` calls each on one embedder (thread i on
    ``batches[i]``, another bucket): every row against its eager twin.
    Returns the calls made."""
    import threading

    bad, done = [], []

    def worker(i):
        for _ in range(THREAD_CALLS):
            got = run(batches[i])
            if row_cosine(got, refs[i]) < CAPTURED_COSINE:
                bad.append(i)
            done.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    alive = any(t.is_alive() for t in threads)
    say(f"  {what}: {len(threads)} threads x {THREAD_CALLS} calls (batches "
        f"{[len(b) for b in batches]}): {len(done)} done, {len(bad)} rows off their eager "
        f"twins {'ok' if not (bad or alive) else 'FAIL'}")
    if bad or alive or len(done) != len(batches) * THREAD_CALLS:
        raise AssertionError(f"{what}: concurrent calls returned wrong rows or hung")
    return len(done)


def hold_capture_beside(what, emb, cap, eag, new, busy_xs, busy_ref) -> int:
    """A bucket's first call, ``cap(new)``, which captures its graph, while
    another thread runs eager CUDA work in a loop: ``eag(busy_xs)``, the
    embedder's preprocess (a vision tower's) and the tower's eager forward,
    whose kernels that thread launches, as ``ClipServer``'s preprocess and
    handler threads run beside its micro-batcher. Both threads' rows
    against their eager twins; the capture must add its graph. Returns the
    eager rounds the other thread ran while the capture ran."""
    import threading

    from clip_embedder_tpu_torch.utils import captured

    def graphs() -> int:
        s = captured.graphs_of(emb.tower)
        return 0 if s is None else len(s.graphs)

    ref, before = eag(new), graphs()
    started, stop, bad, rounds = threading.Event(), threading.Event(), [], [0]

    def busy():
        try:
            while not stop.is_set():
                if row_cosine(eag(busy_xs), busy_ref) < CAPTURED_COSINE:
                    bad.append(rounds[0])
                rounds[0] += 1
                started.set()
        except Exception as e:  # noqa: BLE001 - reported below
            bad.append(repr(e))
            started.set()

    thread = threading.Thread(target=busy)
    thread.start()
    started.wait(timeout=600)
    n0 = rounds[0]
    try:
        got = cap(new)
    finally:
        during = rounds[0] - n0
        stop.set()
        thread.join(timeout=600)
    added = graphs() - before
    cos = row_cosine(got, ref)
    on_card = torch.cuda.is_available()
    ok = not (bad or thread.is_alive()) and cos >= CAPTURED_COSINE and added == int(on_card)
    say(f"  {what}: the batch-{len(new)} bucket captured while another thread ran eager "
        f"forwards of batch {len(busy_xs)} ({during} rounds during the call, {len(bad)} off "
        f"their eager rows): {added} graph added, captured rows against eager min cosine "
        f"{cos:.9f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: a capture beside another thread's CUDA work failed: "
                             f"{bad[:3]}, {added} graphs added, cosine {cos}")
    return during


def mib(n: int) -> float:
    return n / 2 ** 20


def bucket_of(key) -> int:
    """The batch bucket of a ``utils.captured`` graph key: the first
    argument's leading dimension."""
    _device, args, _kwargs = key
    return args[0][0][0]


def preprocess_ms(emb, arrays, run=None) -> float:
    """The vision embedder's preprocess of ``arrays`` alone (host staging,
    the copy to the card, the resize), host clock to a synchronize, median
    of 5: ``run`` (default: the embedder's, the captured route)."""
    run = run or emb.preprocessor
    times = []
    for _ in range(6):
        t = time.perf_counter()
        with torch.inference_mode():
            run(arrays)
        if emb.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times[1:]) * 1e3


def staging_ms(pp, arrays, calls: int = 5, after=None) -> float:
    """The preprocess's host half alone (``Preprocessor._stage``, under the
    lock ``run`` holds: the rows past the batch zeroed where an earlier call
    filled them, each image written once into its shape's reused staging
    buffer, the matrices looked up), host clock, median of ``calls`` after
    one; with ``after`` (a batch of the same bucket and padded size) each
    timed call follows an untimed one of it."""
    from clip_embedder_tpu_torch.ops.preprocess import bucket_batch

    bb, (ph, pw) = bucket_batch(len(arrays)), pp.padded_size(arrays)
    times = []
    dev = next(k[0] for k in pp._staging if k[1:] == (bb, ph, pw))  # the route's key
    with torch.inference_mode(), pp._lock:
        for _ in range(calls + 1):
            if after is not None:
                pp._stage(after, dev, bb, ph, pw)
            t = time.perf_counter()
            pp._stage(arrays, dev, bb, ph, pw)
            times.append(time.perf_counter() - t)
    return statistics.median(times[1:]) * 1e3


def pool_mib(graphs) -> float | None:
    """The device memory that the segments of ``graphs``' pool reserve, from
    the caching allocator's snapshot; None where the snapshot names no
    segment of it."""
    if graphs is None or graphs._pool is None:
        return None
    pool = tuple(graphs._pool)
    own = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
           if tuple(seg.get("segment_pool_id", ())) == pool]
    return mib(sum(own)) if own else None


def hold_preprocess(what, emb, batches) -> dict:
    """The captured preprocess (``Preprocessor.run``: reused staging, the
    resize replayed) against its plain route (``Preprocessor.eager``:
    zero-filled, eager), ``torch.equal`` on every row of the bucket, the
    padded ones too, on ``batches`` (two of different (Hp, Wp)) in turn and
    back, then the first with fewer images (its bucket's stale rows); then
    on the card the
    split of the first batch's preprocess (host staging, the copy, the
    replay), the route against the plain one, the graphs and their
    pool's reserved MiB."""
    from clip_embedder_tpu_torch.ops.preprocess import bucket_batch
    from clip_embedder_tpu_torch.utils import captured

    pp = emb.preprocessor
    fewer = batches[0][:bucket_batch(len(batches[0])) // 2 + 1]  # the same bucket, fewer rows
    if pp.padded_size(fewer) != pp.padded_size(batches[0]):
        fewer = [max(batches[0], key=lambda a: a.shape[0] * a.shape[1])] + fewer[1:]
    for xs in (*batches, *batches, fewer):
        with torch.inference_mode():
            got, ref = pp(xs), pp.eager(xs)
        equal = bool(torch.equal(got.cpu(), ref.cpu()))
        say(f"  {what} preprocess, batch {len(xs)} (bucket {got.shape[0]}) padded to "
            f"{pp.padded_size(xs)}: captured against the plain route, every row, equal "
            f"(torch.equal) {equal} {'ok' if equal else 'FAIL'}")
        if not equal:
            raise AssertionError(f"{what}: the captured preprocess differs from the plain one")
    if emb.device.type != "cuda":
        return {}
    arrays = batches[0]
    graphs = captured.graphs_of(pp)
    bb, padded = bucket_batch(len(arrays)), pp.padded_size(arrays)
    entry = next(e for k, e in pp._staging.items() if k[1:] == (bb, *padded))
    g = next(g for k, g in graphs.graphs.items() if k[1:4] == (bb, *padded))

    def copy():
        with torch.inference_mode():
            entry.images.copy_(entry.host, non_blocking=True)
            entry.idx.copy_(entry.host_idx, non_blocking=True)

    r = {"staging_ms": staging_ms(pp, arrays),
         "fewer_staging_ms": staging_ms(pp, fewer, after=arrays),
         "copy_ms": cuda_ms(copy, iters=10, warmup=1),
         "replay_ms": cuda_ms(g.graph.replay, iters=10, warmup=1),
         "ms": preprocess_ms(emb, arrays), "plain_ms": preprocess_ms(emb, arrays, pp.eager),
         "graphs": len(graphs.graphs), "pool_mib": pool_mib(graphs)}
    pool = "not measured" if r["pool_mib"] is None else f"{r['pool_mib']:.1f} MiB"
    say(f"  {what} preprocess at batch {len(arrays)} ({[bb, *padded, 3]} u8): "
        f"{r['ms']:.3f} ms captured against {r['plain_ms']:.3f} ms plain (host clock to a "
        f"synchronize, median of 5); host staging {r['staging_ms']:.3f} ms (host clock; "
        f"{r['fewer_staging_ms']:.3f} ms for {len(fewer)} images after {len(arrays)}, which "
        f"zeroes the {bb - len(fewer)} rows past them), "
        f"the copy {r['copy_ms']:.3f} ms, the replay {r['replay_ms']:.3f} ms (CUDA events, "
        f"median of 10); {r['graphs']} preprocess graphs, their pool reserves {pool}")
    return r


# the key stream of ``hold_preprocess_keys``: a server's micro-batch buckets
# over two padded sizes, more (bucket, Hp, Wp) keys than the default
# staging bound and fewer than the bound ``KEY_STREAM_MAX`` sets
KEY_STREAM_BUCKETS = (1, 2, 4, 8, 16, 32)
KEY_STREAM_MAX = 8


def hold_preprocess_keys(what, emb, arrays, cropped) -> dict:
    """The captured preprocess on traffic of many shapes: a stream that
    cycles over the (batch bucket, Hp, Wp) keys of ``KEY_STREAM_BUCKETS``
    at ``arrays``' and ``cropped``'s padded sizes, twice, against the plain
    route (``Preprocessor.eager``) on the same batches; once under the
    preprocessor's own staging bound, where the second cycle finds every
    key kept, and once under a bound of ``KEY_STREAM_MAX`` shapes, fewer
    than the stream's keys, where a cycle finds none (least recently used
    first out) and every call pays the pinned allocation, the warm-up and
    the capture. Each call is timed on the host clock to a synchronize;
    the second cycle's mean is reported, with the capture seconds of the
    keys captured there."""
    from clip_embedder_tpu_torch.utils import captured

    pp = emb.preprocessor
    batches = []
    for src in (arrays, cropped):
        big = max(src, key=lambda a: a.shape[0] * a.shape[1])
        batches += [[big] + src[:b - 1] for b in KEY_STREAM_BUCKETS]
    keys = {(len(xs), *pp.padded_size(xs)) for xs in batches}
    if len(keys) != len(batches) or len(keys) <= KEY_STREAM_MAX:
        raise AssertionError(f"the key stream has {len(keys)} keys")

    def cycle(run, new=None):
        """The mean ms a call over ``batches``; the capture seconds of each
        graph made during the cycle go to ``new``."""
        graphs = captured.graphs_of(pp, create=True).graphs
        times = []
        for xs in batches:
            # the graphs themselves, not their ids: a graph the call drops
            # (its shape evicted) frees an id that its new capture may take
            had = list(graphs.values())
            t = time.perf_counter()
            with torch.inference_mode():
                run(xs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if new is not None:
                new += [g.seconds for g in graphs.values()
                        if not any(g is h for h in had)]
            del had
        return statistics.fmean(times) * 1e3

    r = {"keys": len(keys)}
    cycle(pp.eager)
    r["plain_ms"] = cycle(pp.eager)
    for name, bound in (("kept", pp._STAGING_MAX), ("evicted", KEY_STREAM_MAX)):
        pp._staging.clear()
        captured.graphs_of(pp, create=True).graphs.clear()
        free_device_memory()
        pp._STAGING_MAX = bound
        new: list[float] = []
        try:
            cycle(pp)
            ms = cycle(pp, new)
        finally:
            del pp._STAGING_MAX  # the class's bound again
        r[name] = {"bound": bound, "ms": ms, "captures": len(new),
                   "capture_s": statistics.median(new) if new else None}
        cap = ("no capture" if not new else f"{len(new)} captures, "
               f"{r[name]['capture_s']:.3f} s each (median; the warm-up and pinned "
               "allocation included)")
        say(f"  {what} preprocess over {len(keys)} (bucket, Hp, Wp) keys (buckets "
            f"{list(KEY_STREAM_BUCKETS)} x 2 padded sizes), cycled twice, staging bound {bound}: "
            f"{ms:.3f} ms a call captured against {r['plain_ms']:.3f} ms plain (the second "
            f"cycle's mean, host clock to a synchronize); {cap} in that cycle")
    if r["kept"]["captures"] or r["evicted"]["captures"] != len(keys):
        raise AssertionError(f"{what}: {r['kept']['captures']} captures within the staging "
                             f"bound, {r['evicted']['captures']} past it ({len(keys)} keys)")
    return r


def executor_clip(device, dtype, name, tmp: Path, *, layers=None, vocab_size=None):
    """Phase 11's ``name`` exported from its torch mirrors into a model dir
    under ``tmp`` (f32 graphs, seeded random weights), its towers run by the
    ONNX executor in ``dtype`` (``executor_embedders``; the dir converted
    once for its configs and tokenizer): an object with ``vision`` and
    ``text``."""
    import types

    from clip_embedder_tpu_torch import Clip

    cfg, vision, text = onnx_mirrors(name, layers=layers, vocab_size=vocab_size)
    d = tmp / name
    write_onnx_dir(d, cfg, vision, text, OPENAI_PREPROCESS)
    clip = Clip.from_local_dir(d, device=device, dtype=dtype)
    ev, et = executor_embedders(clip, d, device, dtype)
    return types.SimpleNamespace(vision=ev, text=et)


def phase_captured(device, dtype=torch.bfloat16, *, layers=None, vocab_size=None, batch=32,
                   timed=True) -> dict:
    """The captured-forward layer (``utils.captured``) on ``CAPTURED_MODELS``
    at full width and depth (``layers``/``vocab_size`` cut them for a CPU
    rehearsal, where the layer runs eager): each tower's rows against its
    eager forward (the tower called directly) at cosine 1 - 1e-6, two
    batches in turn (and the first call's rows unchanged after the second),
    two threads, the graphs and their capture seconds per bucket, images/s,
    the p50 of one image, texts/s and the idle share, captured against
    eager, and for ``MEMORY_MODELS`` the reserved memory with and without
    the layer."""
    import tempfile

    from clip_embedder_tpu_torch.utils import captured
    from clip_embedder_tpu_torch.utils.images import to_rgb_array

    free_device_memory()  # the earlier phases' models
    on_card = device == "cuda"
    images = mixed_batch(batch)
    arrays = [to_rgb_array(im) for im in images]
    # the preprocess's second padded shape: the same images cropped (512 x 640
    # against 768 x 1024 at full size)
    cropped = [a[:500, :600] for a in arrays]
    texts = captions(batch, 70)
    inputs = {"vision": arrays, "text": texts}
    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="captured_onnx_")
    for name, model, modes, kw, towers in CAPTURED_MODELS:
        for mode in modes:
            label = f"{name} {mode or str(dtype).removeprefix('torch.')}"
            say(f"[14] {label}: captured forwards ({', '.join(towers)}), random weights (seed 0)")
            t0 = time.perf_counter()
            if kw.get("executor"):
                clip = executor_clip(device, dtype, model, Path(tmp.name), layers=layers,
                                     vocab_size=vocab_size)
            else:
                clip = build_clip(device, dtype, layers=layers, vocab_size=vocab_size,
                                  quantize=mode, model=model, **kw)[0]
            say(f"  built in {time.perf_counter() - t0:.1f} s; families vision "
                f"{clip.vision.spec.family}, text {clip.text.spec.family}; attn_impl vision="
                f"{clip.vision.attn_impl} text={clip.text.attn_impl}")
            rec = out[label] = {}
            for kind in towers:
                emb = clip.vision if kind == "vision" else clip.text
                what = f"{label} {kind}"
                cap, eag = captured_runners(emb, kind)
                xs = inputs[kind]
                small = xs[:5]  # another bucket (8)
                r = rec[kind] = {}
                if on_card:
                    free_device_memory()
                    torch.cuda.reset_peak_memory_stats()
                    weights = torch.cuda.memory_allocated()
                ref, ref_small = eag(xs), eag(small)
                eag(xs[:1])
                if on_card:  # the process's own numbers, the other models freed
                    r["weights_mib"] = mib(weights)
                    r["eager_reserved_mib"] = mib(torch.cuda.max_memory_reserved())
                    r["eager_allocated_mib"] = mib(torch.cuda.max_memory_allocated() - weights)
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    before = torch.cuda.memory_reserved()
                # the first call runs the warm-up forward and a replay, a
                # later call the replay alone, each the eager forward's
                # launches (every graph held to its kernel nodes)
                reset_launch_counts()
                got = cap(xs)
                first_counts = launch_counts()
                kept = got.clone()
                reset_launch_counts()
                replayed = cap(xs)
                replay_counts = launch_counts()
                reset_launch_counts()
                eag(xs)
                eager_counts = launch_counts()
                say(f"  {what}: launches of the first captured call {first_counts}, of "
                    f"the next (a replay) {replay_counts}, of one eager forward "
                    f"{eager_counts}")
                twice = {k: 2 * v for k, v in eager_counts.items()} if on_card else eager_counts
                if first_counts != twice or replay_counts != eager_counts:
                    raise AssertionError(f"{what}: the captured calls ran other launches than "
                                         "the eager forward's")
                r["launches"] = replay_counts
                r["equal"] = hold_captured(f"{what} batch {len(xs)}", got, ref)
                hold_captured(f"{what} batch {len(xs)}, the first replay", replayed, ref)
                got_small = cap(small)
                hold_captured(f"{what} batch {len(small)} (after batch {len(xs)})", got_small,
                              ref_small)
                hold_captured(f"{what} batch {len(xs)} again", cap(xs), ref)
                if not torch.equal(got, kept):
                    raise AssertionError(f"{what}: the first call's rows changed when the "
                                         "graph replayed")
                say(f"  {what}: the first call's rows unchanged after two more replays ok")
                if on_card:
                    cap(xs[:1])
                    r["captured_reserved_mib"] = mib(torch.cuda.max_memory_reserved())
                    r["captured_allocated_mib"] = mib(torch.cuda.max_memory_allocated()
                                                      - weights)
                    torch.cuda.empty_cache()
                    r["held_mib"] = mib(torch.cuda.memory_reserved() - before)
                    if name in MEMORY_MODELS:
                        say(f"  {what}: max_memory_reserved eager {r['eager_reserved_mib']:.1f} "
                            f"MiB, captured {r['captured_reserved_mib']:.1f} MiB (the weights: "
                            f"{r['weights_mib']:.1f} MiB allocated); the graphs' pool holds "
                            f"{r['held_mib']:.1f} MiB reserved between calls; peak allocated "
                            f"above the weights eager {r['eager_allocated_mib']:.1f}, captured "
                            f"{r['captured_allocated_mib']:.1f} MiB (batches {len(xs)}, "
                            f"{len(small)}, 1)")
                ref_one = eag(xs[:1])
                hold_threads(what, cap, [xs[:1], small], [ref_one, ref_small])
                graphs = captured.graphs_of(emb.tower)
                seconds = {} if graphs is None else {
                    bucket_of(key): s for key, s in graphs.capture_seconds.items()}
                r["graphs"], r["capture_s"] = len(seconds), seconds
                say(f"  {what}: {len(seconds)} graphs; capture seconds by bucket (the "
                    "warm-up included; the first also builds the kernels' libraries): "
                    + ", ".join(f"{b} {s:.3f}" for b, s in seconds.items()))
                if on_card and len(seconds) != 3:
                    raise AssertionError(f"{what}: {len(seconds)} graphs for 3 buckets")
                r["beside"] = hold_capture_beside(what, emb, cap, eag, xs[:9], xs[:1], ref_one)
                if kind == "vision":
                    r["preprocess"] = hold_preprocess(what, emb, [xs, cropped])
                    if on_card and timed and not any(
                            "preprocess_keys" in v for rc in out.values() for v in rc.values()):
                        r["preprocess_keys"] = hold_preprocess_keys(what, emb, xs, cropped)
                if not timed:
                    continue
                if kind == "vision":
                    r["captured"] = time_embedder(emb, arrays, f"{what} captured")
                    r["plain_preprocess"] = time_embedder(
                        emb, arrays, f"{what} captured tower after the plain preprocess",
                        run=lambda xs: plain_preprocess_images(emb, xs))
                    r["eager"] = time_embedder(
                        emb, arrays, f"{what} eager",
                        run=lambda xs: eager_images(emb, xs))
                    r["captured"]["breakdown"] = profile_embedder(
                        emb, arrays, f"{what} captured")
                    r["eager"]["breakdown"] = profile_embedder(
                        emb, arrays, f"{what} eager", run=lambda xs: eager_images(emb, xs))
                else:
                    r["captured"] = time_texts(emb, texts, f"{what} captured")
                    r["eager"] = time_texts(emb, texts, f"{what} eager",
                                            run=lambda xs: eager_texts(emb, xs))
                    r["captured"]["breakdown"] = profile_embedder(
                        emb, texts, f"{what} captured", run=emb.embed_texts)
                    r["eager"]["breakdown"] = profile_embedder(
                        emb, texts, f"{what} eager", run=lambda xs: eager_texts(emb, xs))
                if on_card:  # does the profiler see the kernels inside a graph launch?
                    g = next(g for key, g in graphs.graphs.items()
                             if bucket_of(key) == len(xs))
                    r["replay_ms"] = cuda_ms(g.graph.replay, iters=10, warmup=1)
                    bd = device_breakdown(g.graph.replay)
                    r["replay_busy_ms"] = (bd["busy_ms"] if bd["source"] == "torch.profiler"
                                           else None)
                    say(f"  {what}: the batch-{len(xs)} graph's replay alone: CUDA events "
                        f"{r['replay_ms']:.3f} ms (back to back, median of 10), the "
                        f"profiler's busy {fmt_ms(r['replay_busy_ms'], 3)}")
            del clip
            free_device_memory()
    tmp.cleanup()
    return out


def captured_summary(out) -> str:
    """Phase 14's numbers, one clause a tower."""
    rows = []
    for label, rec in out.items():
        for kind, r in rec.items():
            c, e = r["captured"], r["eager"]
            rate = ("images_per_s", "images/s") if kind == "vision" else ("texts_per_s",
                                                                           "texts/s")
            one = (f" (the captured tower after the plain preprocess "
                   f"{r['plain_preprocess']['images_per_s']:.2f}), p50 {c['p50_ms']:.2f} "
                   f"against {e['p50_ms']:.2f} ms (after the plain preprocess "
                   f"{r['plain_preprocess']['p50_ms']:.2f})" if kind == "vision" else "")
            mem = (f", max reserved eager {r['eager_reserved_mib']:.0f} MiB, captured "
                   f"{r['captured_reserved_mib']:.0f}, held by the graphs {r['held_mib']:.0f}"
                   if label.rsplit(" ", 1)[0] in MEMORY_MODELS else "")
            p = r.get("preprocess")
            pre = (f", preprocess {p['ms']:.2f} ms against {p['plain_ms']:.2f} plain (staging "
                   f"{p['staging_ms']:.2f}, {p['fewer_staging_ms']:.2f} with rows zeroed, copy "
                   f"{p['copy_ms']:.2f}, replay "
                   f"{p['replay_ms']:.2f})" if p else "")
            ks = r.get("preprocess_keys")
            if ks:
                pre += (f", over {ks['keys']} cycled keys {ks['kept']['ms']:.2f} ms a call "
                        f"kept, {ks['evicted']['ms']:.2f} evicted (capture "
                        f"{ks['evicted']['capture_s']:.3f} s) against {ks['plain_ms']:.2f} plain")
            rows.append(
                f"{label} {kind}: {c[rate[0]]:.2f} against {e[rate[0]]:.2f} {rate[1]}{one}, idle "
                f"share {c['breakdown']['idle_share']:.3f} against "
                f"{e['breakdown']['idle_share']:.3f}{pre}, replay {r['replay_ms']:.2f} ms "
                f"(profiler busy {fmt_ms(r['replay_busy_ms'], 2)}), {r['graphs']} graphs "
                f"captured in "
                f"{sum(r['capture_s'].values()):.2f} s{mem}")
    return "; ".join(rows)


INT8_SOURCES = ("int8_mlp", "int8_mlp_streamed", "ln_qkv_int8", "int8_linear")
# the sources whose SASS must hold int8 wgmma: those and kernel 2's int8 route
SASS_CHECKED = INT8_SOURCES + ("flash_int8", "flash_int8_tma")


def int8_sass_report(libs) -> None:
    """Per int8 source built (``SASS_CHECKED``): the ptxas warnings that say it serialized wgmma
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
    for stem in (s for s in SASS_CHECKED if s in libs):
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
    int8_only, masks_only, options_only = "--int8" in argv, "--masks" in argv, \
        "--options" in argv
    rows_only = "--rows" in argv
    say("[1] environment")
    if not torch.cuda.is_available():
        say("  torch.cuda.is_available() is false: this script needs an NVIDIA card")
        return 2
    card = nvidia_smi()
    cap = torch.cuda.get_device_capability(0)
    say(f"  {card}")
    say(f"  torch's TorchScript ONNX exporter (phase 11): "
        f"{'present' if has_torchscript_exporter() else 'MISSING'}")
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
                             else ("flash_packed", "flash_int8", "flash_int8_tma") if options_only
                             else ("block_rows",) if rows_only else None)
    say(f"  built {sorted(libs)} in {time.perf_counter() - t:.1f} s (nvcc, sm_90a, "
        f"one process per source)")
    for stem, path in sorted(libs.items()):
        log = path.with_suffix(".log")
        for line in (log.read_text().splitlines() if log.is_file() else []):
            if "registers" in line or "spill" in line:
                say(f"  {stem}: {line.strip()}")
    if rows_only:  # the row kernels alone: no result line
        phase_row_kernels(dev, peaks)
        say(card)
        return 0
    if masks_only:  # the packed kernel's masked path alone: no result line
        mask_path_table(dev)
        say(card)
        return 0
    int8_sass_report(libs)
    if options_only:  # kernel 2's options alone: no result line
        phase_flash_options(dev, peaks)
        say(card)
        return 0
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
    record.update(phase_family_kernels(dev, peaks))
    record.update(phase_onnx_kernels(dev, peaks))
    record.update(phase_flash_options(dev, peaks))
    record.update(phase_row_kernels(dev, peaks))
    fixtures = phase_fixtures("cuda")
    main_path = phase_main_path("cuda")
    int8_paths = phase_int8_paths("cuda", bf16_embeddings=main_path["embeddings"])
    pe_core = phase_pe_core("cuda")
    masked = phase_masked_towers("cuda")
    serving = phase_serving("cuda")
    families = phase_families("cuda")
    onnx = phase_onnx("cuda")
    sharded = phase_sharded("cuda")
    training = phase_training("cuda")
    captured_fw = phase_captured("cuda")
    # launches: each kernel's count from its own path's run: the fixtures
    # for flash_attention, SO400M bf16 for ln_qkv and the packed kernel,
    # SO400M int8_all for kernels 4-6, PE-Core int8_all for the streamed MLP,
    # the packed kernel's masked forms from phase 8's text towers (one
    # embed_texts: BiomedCLIP's key rows, CoCa's blocks). A replay's share of
    # every count here is its graph's kernel nodes (hold_graphs)
    record["flash_attention"]["launches"] = fixtures["flash_attention"]
    for name, n in main_path["launches"].items():
        record[name]["launches"] = n
    # kernel 2's int8 options from the same run: its int8 launches by route
    # and what they quantize (0: no path sets quant_qk or quant_pv)
    for rec in record.values():
        if "route_form" in rec:
            rec["launches"] = main_path["quant_launches"].get(rec.pop("route_form"), 0)
    for name in INT8_WRAPPERS:
        record[name]["launches"] = int8_paths["int8_all"]["launches"][name]
    record["int8_mlp_streamed"]["launches"] = pe_core["int8_all"]["launches"][
        "int8_mlp_streamed"]
    # the row kernels: SO400M's from the main path, PE-Core's from its bf16 run
    for name in _row_wrappers():
        record[name]["launches"] = main_path["row_launches"][name]
        record[f"{name}[pe_core]"]["launches"] = pe_core["bfloat16"]["row_launches"][name]
    for run in ("BiomedCLIP bfloat16", "coca_ViT-L-14 bfloat16"):
        form = masked[run]["form"]
        record[f"flash_attention_packed[{form}_mask]"]["launches"] = \
            masked[run]["text_launches"]["flash_attention_packed"]
    # phase 10's shapes from its own runs: EVA02-L's unmasked (rope) launches
    # in bf16, kernel 6 in the MobileCLIP2-S4 and convnext_large_d_320 int8
    # runs (every launch there a ConvFFN or block fc1/fc2) and, for EVA02-L's
    # SwiGLU rows, the EVA02-L int8_all run's (its SwiGLU and attention
    # linears: 7 a block)
    eva = families["EVA02-L-14-336 bfloat16"]
    record["flash_attention_packed[rope]"]["launches"] = \
        eva["launches"]["flash_attention_packed"] - sum(eva["mask_launches"].values())
    for row, run in (("fastvit_fc1", "MobileCLIP2-S4 int8"),
                     ("convnext_fc1", "convnext_large_d_320 int8"),
                     ("eva02_fc1", "EVA02-L-14-336 int8_all"),
                     ("eva02_fc2", "EVA02-L-14-336 int8_all")):
        record[f"int8_linear_fused[{row}]"]["launches"] = \
            families[run]["launches"]["int8_linear_fused"]
    # phase 11's shapes from its own runs, per call: ViT-B-32's embed_images
    # for the vision rows, the embed_texts of ViT-B-32 and of the MCT tower
    # for the 512-wide rows (int8: ViT-B-32 under int8_all, MCT under int8)
    vit, s0 = onnx["CLIP-ViT-B-32"], onnx["MobileCLIP-S0 scale"]
    for row, runs in (("ln_qkv[vit_b32]", [(vit["launches"], "embed_images", "ln_qkv")]),
                      ("ln_qkv[text512]", [(r["launches"], "embed_texts", "ln_qkv")
                                           for r in (vit, s0)]),
                      ("flash_attention_packed[vit_b32]",
                       [(vit["launches"], "embed_images", "flash_attention_packed")]),
                      ("flash_attention_packed[text512_causal]",
                       [(r["launches"], "embed_texts", "flash_attention_packed")
                        for r in (vit, s0)]),
                      ("int8_mlp[vit_b32]", [(vit["int8_launches"], "embed_images", "int8_mlp")]),
                      ("int8_mlp[text512]", [(r["int8_launches"], "embed_texts", "int8_mlp")
                                             for r in (vit, s0)]),
                      ("ln_qkv_int8[vit_b32]",
                       [(vit["int8_launches"], "embed_images", "ln_qkv_int8")]),
                      ("ln_qkv_int8[text512]",
                       [(vit["int8_launches"], "embed_texts", "ln_qkv_int8")]),
                      ("int8_linear_fused[vit_b32]",
                       [(vit["int8_launches"], "embed_images", "int8_linear_fused")]),
                      ("int8_linear_fused[text512]",
                       [(vit["int8_launches"], "embed_texts", "int8_linear_fused")])):
        record[row]["launches"] = sum(counts[call][name] for counts, call, name in runs)
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
    say("phase 10: " + "; ".join(
        f"{label} {r['images_per_s']:.2f} images/s, p50 {r['p50_ms']:.2f} ms, "
        f"{r['texts_per_s']:.2f} texts/s, idle share {r['breakdown']['idle_share']:.3f}"
        for label, r in families.items()) + f"; {card}")
    say("phase 11: " + "; ".join(
        f"{label}: converted in {r['convert_s']:.2f} s (second load {r['reload_s']:.2f} s), "
        f"{r['images_per_s']:.2f} images/s, p50 {r['p50_ms']:.2f} ms, {r['texts_per_s']:.2f} "
        f"texts/s; executor {r['executor']['images_per_s']:.2f} images/s, p50 "
        f"{r['executor']['p50_ms']:.2f} ms, {r['executor']['texts_per_s']:.2f} texts/s"
        for label, r in onnx.items()) + f"; {card}")
    dp, srv = sharded["dp"], sharded["server"]
    say(f"phase 12 (two shards of one card): DP bf16 {dp['images_per_s']:.2f} images/s, p50 "
        f"{dp['p50_ms']:.2f} ms against unsharded {dp['unsharded']['images_per_s']:.2f}, p50 "
        f"{dp['unsharded']['p50_ms']:.2f} ms; DP int8_all "
        f"{sharded['dp_int8_all']['images_per_s']:.2f}; TP captured "
        f"{sharded['tp']['images_per_s']:.2f} against eager "
        f"{sharded['tp']['eager']['images_per_s']:.2f} images/s, p50 "
        f"{sharded['tp']['p50_ms']:.2f} against {sharded['tp']['eager']['p50_ms']:.2f} ms, idle "
        f"share {sharded['tp']['breakdown']['idle_share']:.3f} against "
        f"{sharded['tp']['eager']['breakdown']['idle_share']:.3f}, capture "
        f"{sharded['tp']['capture_s']:.2f} s; EmbedPipeline "
        f"{sharded['pipeline']['images_per_s']:.2f} against a loop "
        f"{sharded['pipeline']['loop_images_per_s']:.2f} images/s; CorpusIndex build "
        f"{sharded['search']['build_s']:.2f} s, search {sharded['search']['search_ms']:.3f} ms; "
        f"mesh server {srv['clients']} clients {srv['images_per_s']:.2f} images/s in "
        f"{srv['windows']} micro-batches, p50 {srv['p50_ms']} ms; {card}")
    var, te = training["variants"], training["eager"]
    pool = training["pool_mib"]
    pool = "not measured" if pool is None else f"{pool:.1f} MiB"
    say(f"phase 13 (ViT-SO400M-16-SigLIP2-384 training, f32, batch 16, remat; captured against "
        f"eager): {training['s_per_step']:.4f} against {te['s_per_step']:.4f} s/step, "
        f"{training['samples_per_s']:.3f} against {te['samples_per_s']:.3f} samples/s, idle "
        f"share {training['breakdown']['idle_share']:.3f} against "
        f"{te['breakdown']['idle_share']:.3f}, peak {training['peak_gib']:.3f} against "
        f"{te['peak_gib']:.3f} GiB allocated, the graph's pool {pool}, capture "
        f"{training['capture_s']:.2f} s; bitwise equal: losses "
        f"{training['captured_vs_eager']['losses_equal']}, leaves "
        f"{training['captured_vs_eager']['leaves_equal']}; second step of DP "
        f"{var['dp']['s2']:.4f} s (eager {var['dp']['eager_s'][1]:.4f}), ring "
        f"{var['ring']['s2']:.4f} s ({var['ring']['eager_s'][1]:.4f}), FSDP "
        f"{var['fsdp']['s2']:.4f} s ({var['fsdp']['eager_s'][1]:.4f}), TP "
        f"{var['tp']['s2']:.4f} s ({var['tp']['eager_s'][1]:.4f}); bf16 losses "
        f"{[round(x, 4) for x in training['bf16']['losses']]}; export "
        f"{training['handoff']['export_s']:.2f} s; the phase took {training['phase_s']:.1f} s; "
        f"{card}")
    say(f"phase 14 (captured against eager, batch 32, host clock): "
        f"{captured_summary(captured_fw)}; {card}")
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

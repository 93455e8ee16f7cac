"""Time the port's attention kernels (kernel 2, ``flash_attention_packed``,
and kernel 3, ``flash_attention``) in several source trees on one card, one
process a tree, so that two versions of ``csrc/flash.cuh`` are compared
within one run:

    python tools/attn_ab.py [--out FILE] TREE [TREE ...]

Each TREE is a directory that holds a ``clip_embedder_tpu_torch`` package
(a checkout, or the package alone unpacked by ``git archive``). The trees
are timed in the order given, so ``A B B A`` shows the card's drift beside
the difference. First every tree's attention sources are built, all nvcc
processes at once, each into its own tree's ``_build``. Then each tree's
process imports that tree's package and times, with CUDA events (the
median of 20 back-to-back calls, ``chip_smoke.cuda_ms``), at batch 32 in
bf16:

* kernel 2 at ViT-SO400M-16-SigLIP2-384's [32, 576, 16x72]: exact,
  ``fast_softmax`` + ``exp_bf16``, and ``pair_exp`` where the tree's wrapper
  takes it;
* kernel 2 with PE-Core-bigG-14-448's 2-D rope [32, 1025, 16x96];
* kernel 2 with BERT-base's per-batch key mask [32, 256, 12x64] and CoCa
  text's per-batch full mask [32, 77, 12x64];
* kernel 3 at SO400M's head layout [32, 16, 576, 72] (the yardstick);
* ``F.scaled_dot_product_attention`` at SO400M's shape, a control that no
  tree changes;
* kernel 2's int8 options, ``quant_qk``, ``quant_pv`` and both, at SO400M's
  shape and at PE-Core-bigG's with its rope, where the tree's wrapper takes
  them (on whichever int8 route the tree's ``kernel_route`` picks).

Each kernel's output is held against the tree's plain version (2e-2). The
table goes to stdout with the card's name and power limit, and with
``--out`` the rows to FILE as JSON.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SOURCES = ("flash_packed", "flash_bhsd", "flash_int8", "flash_int8_tma")  # those a tree has


def helpers():
    """This repo's ``chip_smoke.py`` (its input makers and timer), loaded
    from its file so that a tree's own copy is not picked up instead."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(tree: str) -> dict:
    """The times (ms) and errors of one tree's kernels, in this process."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import torch.nn.functional as F

    from clip_embedder_tpu_torch.ops import flash
    from clip_embedder_tpu_torch.ops.rope import axial_rope_table, head_tiled_tables

    cs = helpers()
    dev = torch.device("cuda")
    assert Path(flash.__file__).resolve().is_relative_to(Path(tree).resolve()), flash.__file__
    rows = {}

    def case(name, kernel, plain):
        err = float((kernel().float() - plain().float()).abs().max())
        if not err <= 2e-2:
            raise AssertionError(f"{tree} {name}: max_abs_err {err:.3e} over 2e-2")
        rows[name] = {"ms": cs.cuda_ms(kernel), "max_abs_err": err}

    def packed(q, k, v, h, **kw):
        case(kw.pop("name"), lambda: flash.flash_attention_packed(q, k, v, num_heads=h, **kw),
             lambda: flash.flash_attention_packed_plain(q, k, v, num_heads=h, **kw))

    q, k, v = cs.attn_inputs(32, 16, 576, 72, torch.bfloat16, dev, seed=6)
    packed(q, k, v, 16, name="k2 SO400M exact")
    packed(q, k, v, 16, name="k2 SO400M fast+exp_bf16", fast_softmax=True, exp_bf16=True)
    if "pair_exp" in inspect.signature(flash.flash_attention_packed).parameters:
        packed(q, k, v, 16, name="k2 SO400M pair_exp", pair_exp=True)
    qh, kh, vh = (t.unflatten(-1, (16, 72)).transpose(1, 2) for t in (q, k, v))
    rows["SDPA SO400M (control)"] = {
        "ms": cs.cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)), "max_abs_err": None}

    rope = tuple(t.to(dev) for t in head_tiled_tables(
        axial_rope_table(32, 96, order="xy", prefix=1), 16))
    q, k, v = cs.attn_inputs(32, 16, 1025, 96, torch.bfloat16, dev, seed=6)
    packed(q, k, v, 16, name="k2 PE-Core rope", rope=rope)
    q, k, v = cs.attn_inputs(32, 12, 256, 64, torch.bfloat16, dev, seed=9)
    packed(q, k, v, 12, name="k2 key mask", mask=cs.key_mask(32, 256, dev))
    q, k, v = cs.attn_inputs(32, 12, 77, 64, torch.bfloat16, dev, seed=9)
    packed(q, k, v, 12, name="k2 full mask", mask=cs.full_mask(32, 77, dev))

    if "quant_qk" in inspect.signature(flash.flash_attention_packed).parameters:
        for label, (b, h, seq, d), tables in (("SO400M", (32, 16, 576, 72), None),
                                             ("PE-Core rope", (32, 16, 1025, 96), rope)):
            q, k, v = cs.attn_inputs(b, h, seq, d, torch.bfloat16, dev, seed=6)
            for name, kw in (("quant_qk", {"quant_qk": True}), ("quant_pv", {"quant_pv": True}),
                             ("both", {"quant_qk": True, "quant_pv": True})):
                packed(q, k, v, h, name=f"k2 {label} {name}", rope=tables, **kw)
                rows[f"k2 {label} {name}"]["route"] = flash.kernel_route(d, torch.bfloat16,
                                                                        quant=True)

    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((32, 16, 576, 72), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    case("k3 yardstick", lambda: flash.flash_attention(q, k, v),
         lambda: flash.flash_attention_plain(q, k, v))
    return rows


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print("ROWS " + json.dumps(time_tree(argv[1])), flush=True)
        return 0
    out = None
    if len(argv) >= 2 and argv[0] == "--out":
        out, argv = Path(argv[1]), argv[2:]
    if not argv:
        print(__doc__)
        return 2
    trees = list(dict.fromkeys(argv))
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "from clip_embedder_tpu_torch.ops import cuda; cuda.build_all(sys.argv[2:])",
         str(Path(t).resolve()), *SOURCES]) for t in trees]
    if any(p.wait() != 0 for p in builds):
        print("build failed", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    runs = []
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        line = next(l for l in proc.stdout.splitlines() if l.startswith("ROWS "))
        runs.append({"tree": tree, "rows": json.loads(line[5:])})
    print(card)
    names = list(dict.fromkeys(n for r in runs for n in r["rows"]))
    print("ms, median of 20 | " + " | ".join(r["tree"] for r in runs))
    for n in names:
        cells = [r["rows"].get(n) for r in runs]
        routes = sorted({c["route"] for c in cells if c is not None and "route" in c})
        print(f"{n}{' (' + ', '.join(routes) + ')' if routes else ''} | "
              + " | ".join("-" if c is None else f"{c['ms']:.4f}" for c in cells))
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

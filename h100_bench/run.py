"""Run one cell of the H100 benchmark once and print its result.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` and the package
``clip_embedder_tpu_torch``. The run builds the cell from its data files,
makes its weights and images on the card from ``--seed``, warms the shapes
its traffic uses, measures for ``--seconds``, judges what the timed path
returned against the plain reference, and prints the numbers it compared,
each beside its limit, as the last lines on standard error, and one JSON
object as the last line of standard output: the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``.

It exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), and if JAX, flax or the JAX package has been
loaded into the process. ``--quantize int8|int8_all`` runs the program's
int8 path instead of the configuration's bf16: the control, which has to
come out not correct.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

FORBIDDEN = ("jax", "jaxlib", "flax", "clip_embedder_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--quantize", choices=("int8", "int8_all"), default=None)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    import clip_embedder_tpu_torch  # noqa: F401  (the system under test: fail early without it)

    from hbench.cell import cell_files, load_benchmark, run_cell, say

    bench = load_benchmark()
    chips = cell_files(bench, args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from hbench.roofline import nvidia_smi

    say(f"card: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.get_num_threads()} CPU threads of {os.cpu_count()} cores")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda:0", t_start=T_START, quantize=args.quantize, bench=bench)
    found = forbidden_modules()
    if found:
        say(f"the run loaded {found}: the benchmark may load none of {FORBIDDEN}")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Tiny cuts of the benchmark's cells for the CPU tests: the same code
paths, drivers and checks at widths a CPU run holds (``shrink``)."""

from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_SIZES = [[64, 64], [80, 64], [96, 72], [48, 80], [128, 96], [40, 40]]


def shrink(config: dict, traffic: dict, *, layers: int = 2, width: int = 128,
           heads: int = 2, mlp: int = 256) -> tuple[dict, dict]:
    """The configuration at ``width``/``layers``/``heads``/``mlp``, cut by
    its layout's ``shrink`` (the program's own override hook), and the
    traffic mix at a CPU's scale."""
    from hbench import layouts

    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    layouts.of(config).shrink(config, width=width, layers=layers, heads=heads, mlp=mlp)
    traffic.update(sizes=TINY_SIZES, pool_images=24, check_rows=8)
    if traffic["shape"] == "pipeline_closed":
        traffic.update(batch_size=8, warm_batches=2,
                       trace={"first_batch": 1, "batches": 2, "gap_batches": 1, "sessions": 2})
    else:
        traffic.update(rate_per_s=40.0, max_batch=8,
                       trace={"sessions": 1, "seconds": 0.2, "from": 0.6})
    return config, traffic


def run(workload: str, seed: int = 7, seconds: float = 1.0, trace: bool = False, **kw) -> dict:
    from hbench.cell import run_cell

    shrink_kw = {k: kw.pop(k) for k in ("layers", "width", "heads", "mlp") if k in kw}
    return run_cell(workload, seed, seconds, trace, device="cpu", t_start=time.monotonic(),
                    shrink=lambda c, t: shrink(c, t, **shrink_kw), **kw)

# the control test's size (test_h100_bench_rehearsal): there the program's
# rows read 0.0081 / 0.0060 (widest / median gap) and its int8 path's
# 0.019 / 0.018 (CPU, SO400M's mix), either side of the limits 0.012 / 0.010
CONTROL = {"layers": 4, "width": 256, "heads": 4, "mlp": 1024}

"""Sweep the offered rate of an open-loop cell on the card, to find its knee.

    python3 h100_bench/sweep.py --workload so400m.online --seed <n> --seconds 10 \\
        --rates 200,300,400

One process, one embedder: set-up as the cell's, then for each rate one
window of ``--seconds`` on that rate's schedule, and one line of JSON: the
requests due in the window, the share of them answered by its close, the
backlog then (due minus answered), p50 and p95 of all of them (a request
still open is timed to when it resolved), the mean micro-batch and how late
the sender ran. The knee is the highest rate whose window ends with its
answers keeping up with its arrivals; the cell's rate is fixed at 0.8 of it
in its traffic file. Nothing here is part of a cell's run.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    import numpy as np
    import torch

    from hbench.cell import Ctx, cell_files, load_benchmark, say
    from hbench.drivers import microbatch_open as mo
    from hbench.hooks import Hooks
    from hbench.images import make_pool
    from hbench.program import build
    from hbench.weights import make_tree

    wl, config, traffic = cell_files(load_benchmark(), args.workload)
    device = torch.device("cuda:0")
    ctx = Ctx(workload=wl, config=config, traffic=traffic, seed=args.seed,
              seconds=args.seconds, device=device, t_start=T_START)
    ctx.pool = make_pool(traffic, args.seed, device)
    ctx.embedder = build(config, make_tree(config, args.seed, device), device)
    ctx.hooks = Hooks(False)
    ctx.hooks.install(ctx.embedder)
    mo.warm_up(ctx)
    say(f"set-up {time.monotonic() - T_START:.1f} s")
    for rate in (float(r) for r in args.rates.split(",")):
        due = mo.schedule(rate, args.seconds, args.seed, f"sweep {rate}")
        starts: dict = {}
        batcher = mo.make_batcher(ctx, starts)
        ctx.hooks.open_window()
        try:
            res = mo.open_loop(ctx, batcher, due)
        finally:
            batcher.close()
            ctx.hooks.close_window()
        close = res["t0"] + args.seconds
        lat = mo.latencies_ms(res)
        answered = int(np.sum(res["done"] <= close))
        due_n = int(np.sum(res["due"] <= close))
        print(json.dumps({
            "rate_per_s": rate, "due": due_n, "answered_by_close": answered,
            "answered_share": answered / due_n, "backlog_at_close": due_n - answered,
            "p50_ms": mo.percentile(lat, 50), "p95_ms": mo.percentile(lat, 95),
            "mean_batch": batcher.items / max(1, batcher.batches),
            "captures": ctx.hooks.captures,
            "sender_late_p95_ms": mo.percentile((res["sent"] - res["due"]) * 1e3, 95),
            "missing": len(due) - len(res["rows"])}), flush=True)
    ctx.hooks.uninstall()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: build it from its data files, warm it, measure its
window, read its metrics, then judge its answers against the reference.

Everything a cell is made of is found by name: the workload in
``BENCHMARK.json``, its configuration's file, its traffic mix
(``traffic/<name>.json``), the mix's shape (a module of ``hbench.drivers``),
the configuration's layout and reference (``hbench.layouts``,
``hbench.reference``) and each per-layer metric's reader
(``metrics/<name>.py``)."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable

import torch

BENCH_DIR = Path(__file__).resolve().parent.parent  # h100_bench/
ROOT = BENCH_DIR.parent  # the checkout


@dataclass
class Outcome:
    """What a traffic shape's ``run`` measured."""

    setup_s: float
    window_s: float
    e2e: dict
    answers: dict              # id -> the row the program returned
    image_of: Callable         # id -> index of the pool image it embeds
    attempted: int
    missing: int
    counters: dict = field(default_factory=dict)


@dataclass
class Ctx:
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: torch.device
    t_start: float             # time.monotonic() at process start
    embedder: Any = None
    pool: list = None
    hooks: Any = None
    tracer: Any = None


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named '{name}' in BENCHMARK.json")


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell, by name."""
    wl = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], wl["config"], "configuration")
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{wl['traffic']}.json").read_text())
    return wl, config, traffic


def reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """Whether a cell reports a metric: the cells its ``workloads`` list, or
    without one every cell that reports the metric it ``moves`` (an
    end-to-end metric without one: every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def reader(name: str):
    """The per-layer metric's reader, ``metrics/<name>.py``'s ``read``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": device.type, "kind": device.type, "count": 1, "memory_peak_bytes": 0}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device,
             t_start: float, quantize: str | None = None, bench: dict | None = None,
             shrink: Callable | None = None) -> dict:
    """One run of ``workload``: the result object the run prints (with its
    ``checks`` last). ``quantize`` runs the program's int8 path in place of
    the configuration's dtype (the control); ``shrink(config, traffic)``
    cuts a cell to a size a CPU test can hold."""
    from .check import judge
    from .hooks import Hooks
    from .images import make_pool
    from .program import build
    from .trace import Tracer
    from .weights import make_tree

    bench = bench or load_benchmark()
    wl, config, traffic = cell_files(bench, workload)
    if shrink is not None:
        config, traffic = shrink(config, traffic)
    device = torch.device(device)
    ctx = Ctx(workload=wl, config=config, traffic=traffic, seed=seed, seconds=seconds,
              device=device, t_start=t_start)
    ctx.pool = make_pool(traffic, seed, device)
    ctx.embedder = build(config, make_tree(config, seed, device), device, quantize=quantize)
    ctx.hooks = Hooks(trace)
    ctx.hooks.install(ctx.embedder)
    ctx.tracer = Tracer() if trace else None
    if trace and device.type == "cuda":
        Tracer.warm()
    driver = importlib.import_module(f"{__package__}.drivers.{traffic['shape']}")
    try:
        out = driver.run(ctx)
    finally:
        ctx.hooks.uninstall()
    dev = device_info(device)
    say(f"window: {out.window_s:.3f} s, set-up {out.setup_s:.3f} s, attempted "
        f"{out.attempted}, missing {out.missing}, counters "
        f"{ {k: v for k, v in out.counters.items() if k != 'wait_ms'} }")

    e2e = [m for m in bench["end_to_end"] if reports(m, workload, set())]
    e2e_names = {m["name"] for m in e2e}
    values = {**out.e2e, "setup_s": out.setup_s}
    result: dict[str, Any] = {}
    if not trace:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    else:
        summary = ctx.tracer.summary()
        ctx.tracer = None
        say(f"trace: {'no session saw device time' if summary is None else summary['groups_ms']}")
        if summary is not None:
            top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:40]
            say("kernels (s, launches):", {k[:160]: v for k, v in top})
        inputs = SimpleNamespace(trace=summary, counters=out.counters, config=config,
                                 traffic=traffic, e2e=values, device_name=dev["kind"])
        metrics = {}
        for m in bench["per_layer"]:
            if reports(m, workload, e2e_names):
                value = reader(m["name"])(inputs)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    ctx.embedder = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, checks, info = judge(config, seed, ctx.pool, out.answers, out.image_of,
                                  out.missing, device, traffic["check_rows"])
    say(f"reference: {time.perf_counter() - t:.3f} s, {info}")
    return {"correct": correct, "attempted": out.attempted, "failed": out.missing,
            "metrics": metrics, "device": dev, **result, "checks": checks}

"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix, traffic shape, reference and per-layer metric
found by name in the files beside it."""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

import pytest

import tiny  # noqa: F401  (puts the benchmark and the repo on sys.path)
from hbench import layouts
from hbench.cell import BENCH_DIR, ROOT, cell_files, load_benchmark, reader, reports

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|width|expansion|_dim$|_rank$"
                    r"|experts_per_tok)")
LAYOUT_FUNCTIONS = ("leaves", "resolved", "flop_per_image", "shrink")

BENCH = load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("h100_bench/configs/")
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["reduced"] == entry["reduced"]
    assert not any(WIDTHS.search(k) for k in entry["reduced"])
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    assert set(config["check"]) == {"row_gap_max", "row_gap_median"}
    assert all(isinstance(v, float) and v > 0 for v in config["check"].values())
    assert importlib.import_module(f"hbench.reference.{config['reference']}").stages


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_found_by_name(name):
    wl, config, traffic = cell_files(BENCH, name)
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(wl["name"]) and NAME.match(wl["traffic"]) and wl["chips"] == 1
    assert len(wl["why"]) <= 200
    driver = importlib.import_module(f"hbench.drivers.{traffic['shape']}")
    assert callable(driver.run)
    layout = layouts.of(config)
    assert all(callable(getattr(layout, f, None)) for f in LAYOUT_FUNCTIONS), layout.__name__
    e2e = [m["name"] for m in BENCH["end_to_end"] if reports(m, name, set())]
    assert "setup_s" in e2e and len(e2e) >= 2
    moved = set(e2e)
    layers = [m["name"] for m in BENCH["per_layer"] if reports(m, name, moved)]
    assert layers


def test_pairs_unique_and_every_config_used():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric.get("workloads", WORKLOADS)) <= set(WORKLOADS)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    assert set(metric) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in SOURCES and metric["better"] in ("lower", "higher")
    assert 1 <= len(metric["layer"]) <= 200
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert set(metric["workloads"]) <= set(moved.get("workloads", WORKLOADS))
    assert callable(reader(metric["name"]))


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_files_under_paths_are_named_from_name_characters():
    for path in BENCH_DIR.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_rooflines_are_named_for_their_kernel():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


def test_metric_files_have_no_extra_readers():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {p.name[:-3] for p in (BENCH_DIR / "metrics").glob("*.py")}
    assert files == names


def test_traffic_files_load():
    for path in (BENCH_DIR / "traffic").glob("*.json"):
        traffic = json.loads(Path(path).read_text())
        assert traffic["pool_images"] % len(traffic["sizes"]) == 0

"""A tiny CPU rehearsal of each cell's whole run (the harness's look for a
card skipped), and the same runs with the timed path broken underneath,
where ``correct`` has to come out false: an answer altered where it is
produced, half of each batch left out, and the control, the program's
int8 path in place of bf16 (kept here at a size a test run holds; its
full-size readings are in PERF.md). One chip holds each cell, so no
exchange between chips can be left out, and no cell keeps a state that a
step could leave unchanged."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import tiny
from hbench.cell import cell_files, load_benchmark, reports

BENCH = load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def names(trace: bool, workload: str) -> set:
    e2e = {m["name"] for m in BENCH["end_to_end"] if reports(m, workload, set())}
    if not trace:
        return e2e
    return {m["name"] for m in BENCH["per_layer"] if reports(m, workload, e2e)}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_rehearsal_correct_with_every_end_to_end_metric(workload):
    r = tiny.run(workload, seed=2**31 + 11, seconds=0.6)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == names(False, workload)
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traced_rehearsal_reports_per_layer_metrics_it_can_read(workload):
    r = tiny.run(workload, seed=2**31 + 12, seconds=0.6, trace=True)
    assert r["correct"], r["checks"]
    # no device on the CPU: the device-trace readers find nothing and are left out
    device = {m["name"] for m in BENCH["per_layer"] if m["source"] == "device_trace"}
    assert set(r["metrics"]) == names(True, workload) - device
    assert list(r)[-1] == "checks"


def _break_rows(monkeypatch, how):
    from clip_embedder_tpu_torch.vision import VisionEmbedder

    real = VisionEmbedder.embed_images_device

    def broken(self, images):
        embs, n = real(self, images)
        embs = embs.clone()
        if how == "altered":  # each answer changed where it is produced
            embs[:, 0] += 0.2
        elif how == "swapped":  # answers handed to the wrong requests
            embs[:n] = embs[:n].roll(1, dims=0)
        elif how == "half":  # half the batch left out
            return embs, max(1, n // 2)
        return embs, n

    monkeypatch.setattr(VisionEmbedder, "embed_images_device", broken)
    monkeypatch.setattr(VisionEmbedder, "embed_images",
                        lambda self, imgs: (lambda e, n: e[:n].float().cpu().numpy())(
                            *broken(self, imgs)))


@pytest.mark.parametrize("how", ["altered", "swapped", "half"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(workload, how, monkeypatch):
    _break_rows(monkeypatch, how)
    r = tiny.run(workload, seed=2**31 + 13, seconds=0.6)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_int8_is_not_correct(workload):
    r = tiny.run(workload, seed=2**31 + 14, seconds=0.4, quantize="int8", **tiny.CONTROL)
    assert r["correct"] is False, r["checks"]
    assert r["checks"]["rows_missing"]["value"] == 0  # failed on its rows, not on a crash


@pytest.mark.parametrize("workload", WORKLOADS)
def test_limits_separate_program_from_control_at_the_control_size(workload):
    """At the control test's size the program itself passes: what fails
    there is the int8 path, not the size."""
    r = tiny.run(workload, seed=2**31 + 14, seconds=0.4, **tiny.CONTROL)
    assert r["correct"], r["checks"]


def test_weights_from_the_seed():
    from hbench.weights import make_tree

    _, config, traffic = cell_files(BENCH, "so400m.bulk")
    config, _ = tiny.shrink(config, traffic)
    a, b = make_tree(config, 5, "cpu"), make_tree(config, 5, "cpu")
    c = make_tree(config, 6, "cpu")
    wa, wb, wc = (t["blocks"]["attn"]["q"]["w"] for t in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == torch.bfloat16
    std = wa.float().std().item()
    assert std == pytest.approx(config["vision"]["width"] ** -0.5, rel=0.1)
    scale = a["blocks"]["ln1"]["scale"].float()
    assert abs(scale.mean().item() - 1) < 0.02 and np.isclose(scale.std().item(), 0.05, rtol=0.3)

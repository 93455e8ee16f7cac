"""The reduction from a profiler trace to the per-layer metrics, on a
synthetic Chrome trace whose answers are known."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401
from hbench.cell import BENCH_DIR, reader
from hbench.hooks import Hooks
from hbench.readers import kernel_function, per_call_ms
from hbench.roofline import PEAKS, attention_work, bound_s, ln_qkv_work
from hbench.trace import OTHER, SHORT_GAP, Tracer, read_trace

QKV = "src_ln_qkv::(anonymous namespace)::tma::qkv_kernel(CUtensorMap_st, float const*)"
LN = "void src_ln_qkv::(anonymous namespace)::ln_kernel<__nv_bfloat16>(float const*, int)"
FLASH = "void clipk::src_flash_packed::flash::flash_tma_kernel<12>(CUtensorMap_st, float const*)"
ROPE = "void clipk::src_flash_packed::flash::rope_kernel<__nv_bfloat16>(float const*)"
GELU = "void at::native::vectorized_elementwise_kernel<4, GeluCUDAKernelImpl>(int)"


def kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_groups_and_idle_gaps_by_host_activity():
    events = [
        kernel(LN, 0, 10), kernel(QKV, 12, 100),              # 2 us gap: between kernels
        kernel(GELU, 200, 50),                                 # 88 us gap under preprocess
        kernel("Memcpy HtoD (Pinned -> Device)", 240, 30, "gpu_memcpy"),  # overlaps
        kernel(FLASH, 400, 100),                               # 130 us gap under read-back
        {"ph": "X", "cat": "user_annotation", "name": "bench.preprocess", "ts": 105, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.read_back", "ts": 260, "dur": 150},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 330, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]
    r = read_trace(events)
    assert r["busy_s"] == pytest.approx((10 + 100 + 70 + 100) / 1e6)
    assert r["groups_ms"] == pytest.approx({"ln_qkv": 0.11, OTHER: 0.05,
                                            "attention kernels (flash_attention_packed, "
                                            "flash_attention)": 0.1})
    assert r["kernels"][QKV] == (pytest.approx(100e-6), 1)
    gaps = dict(r["idle_gaps"])
    assert gaps["bench.preprocess (1 gaps)"] == pytest.approx(88e-6)
    assert gaps["bench.read_back (1 gaps)"] == pytest.approx(130e-6)
    assert gaps[f"{SHORT_GAP} (1 gaps)"] == pytest.approx(2e-6)
    assert r["device_ops"][0][0] in (QKV, FLASH)


def test_kernel_function_names():
    assert kernel_function(QKV, "ln_qkv") == "qkv_kernel"
    assert kernel_function(LN, "ln_qkv") == "ln_kernel"
    assert kernel_function(ROPE, "flash_packed") == "rope_kernel"
    assert kernel_function(FLASH, "ln_qkv") is None


def summary(**kernels):
    return {"kernels": kernels, "busy_s": 0.9, "window_s": 1.2, "batches": 12,
            "batch_size": 32, "groups_ms": {OTHER: 450.0}}


def inputs(config_name, trace):
    config = json.loads((BENCH_DIR / "configs" / f"{config_name}.json").read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / "bulk.json").read_text())
    return SimpleNamespace(trace=trace, counters={}, config=config, traffic=traffic, e2e={},
                           device_name="NVIDIA H100 80GB HBM3")


def test_rooflines_per_call_with_the_pre_passes_in_the_time():
    trace = summary(**{QKV: (0.3223, 400), LN: (0.0303, 400), FLASH: (0.3026, 400),
                       ROPE: (0.0739, 400)})
    assert per_call_ms(trace, "flash_packed", lambda f: "flash" in f) == pytest.approx(0.941, 1e-3)
    pe = inputs("pe-core-bigg-14-448", trace)
    want = bound_s(*attention_work(32, 16, 1025, 96, rope=True), PEAKS["sxm"]) * 1e3 / 0.94125
    assert reader("flash_attention_packed_roofline")(pe) == pytest.approx(100 * want)
    want = bound_s(*ln_qkv_work(32 * 1025, 1536), PEAKS["sxm"]) * 1e3 / 0.8815
    assert reader("ln_qkv_roofline")(pe) == pytest.approx(100 * want)
    assert 0 < reader("ln_qkv_roofline")(pe) < 100


def test_readers_find_nothing_without_a_trace_or_their_kernels():
    for name in ("ln_qkv_roofline", "flash_attention_packed_roofline", "mfu.bulk",
                 "tower.eager_ms", "idle_share.bulk"):
        assert reader(name)(inputs("vit-so400m-16-siglip2-384", None)) is None
    empty = inputs("vit-so400m-16-siglip2-384", summary(**{GELU: (0.45, 3000)}))
    assert reader("ln_qkv_roofline")(empty) is None
    assert reader("flash_attention_packed_roofline")(empty) is None


def test_session_metrics():
    so = inputs("vit-so400m-16-siglip2-384", summary())
    assert reader("tower.eager_ms")(so) == pytest.approx(450.0 / 12)
    assert reader("idle_share.bulk")(so) == pytest.approx(25.0)
    rate = 12 * 32 / 1.2
    flop = reader("mfu.bulk")(so) / 100 * 989e12 / rate
    assert flop == pytest.approx(0.519e12, rel=0.01)


def test_counter_metrics():
    c = {"items": 240, "batches": 10, "preprocess_ms": [4.0, 6.0, 5.0, 5.0],
         "captures": 2, "wait_ms": list(range(1, 101))}
    ns = SimpleNamespace(counters=c, trace=None)
    assert reader("serving.batch_items")(ns) == 24
    assert reader("preprocess.host_ms.online")(ns) == pytest.approx(5.0)
    assert reader("captures.online")(ns) == 2
    assert reader("serving.wait_p95_ms")(ns) == 95
    assert reader("serving.batch_items")(SimpleNamespace(counters={"batches": 0})) is None


def test_host_metrics_skip_the_profiler_sessions():
    tracer = Tracer()
    tracer.spans = [(10.0, 12.5), (20.0, 21.0)]
    assert tracer.outside(1.0, 9.9) and tracer.outside(12.6, 19.9)
    assert not tracer.outside(9.0, 10.1) and not tracer.outside(12.0, 13.0)
    assert not tracer.outside(20.5, 20.6)
    hooks = Hooks(trace=True)
    hooks.preprocess = [(1.0, 1.004), (11.0, 11.9), (12.4, 12.6), (15.0, 15.006)]
    assert hooks.counters(tracer.outside)["preprocess_ms"] == pytest.approx([4.0, 6.0])
    assert hooks.counters(None)["preprocess_ms"] == pytest.approx([4.0, 900.0, 200.0, 6.0])

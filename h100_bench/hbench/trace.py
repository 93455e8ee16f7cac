# kernel_group, and the retry over profiler sessions in Tracer.summary, are frozen
# copies of chip_smoke.py's kernel_group and device_breakdown at commit
# 4365e722da82de69a44f96d71d1126ef91d02509 (device_breakdown's fallback to CUDA
# events is left out: a traced run that sees no device time reports no device metric).
"""Device figures of a traced run, from torch.profiler.

A traced run profiles a few stretches of its window (``Tracer.start`` /
``stop``), each a session with CPU and CUDA activity. After the window has
closed, ``summary`` exports each session's Chrome trace to a temporary file
under ``TMPDIR``, reads it and deletes it, and returns the first session in
which the device ran anything: the profiler has been seen to miss a whole
CUDA graph replay once, so a session without device time is not taken as
an idle device.

From the trace: device busy seconds (the union of kernel, copy and memset
intervals), the session's length on the host clock, device time by kernel
group and by kernel, and each idle gap between device intervals labelled by
what the host was doing at its midpoint: the innermost of the benchmark's
named ranges (``bench.*``), else the innermost host op or runtime call,
else nothing recorded."""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver"}
OTHER = "other"
# idle gaps shorter than this (µs), the spaces between one graph's kernels,
# are summed under one label instead of being matched to host activity
SHORT_GAP_US = 5.0
SHORT_GAP = f"between kernels, under {SHORT_GAP_US:g} us"


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
    return OTHER


class Tracer:
    def __init__(self):
        self.sessions: list[dict] = []
        self.spans: list[tuple[float, float]] = []  # each session, start call to stop's return
        self._prof = None

    def outside(self, t0: float, t1: float) -> bool:
        """Whether the host interval [t0, t1] (perf_counter s) misses every
        session: starting, recording and stopping the profiler hold up the
        host, so the host-clock per-layer metrics are read outside them."""
        return all(t1 < a or t0 > b for a, b in self.spans)

    @property
    def active(self) -> bool:
        return self._prof is not None

    @staticmethod
    def _profile():
        """A session over the CUDA activity and the host ops of every thread
        (a server's collector thread too), where this torch can say so."""
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        try:
            from torch._C._profiler import _ExperimentalConfig
            kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):
            pass
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw)

    @classmethod
    def warm(cls) -> None:
        """One empty session at set-up: the first start of the profiler in a
        process is its slowest, and a session's start delays its first
        traced work."""
        prof = cls._profile()
        prof.start()
        prof.stop()

    def start(self, **info) -> None:
        self._info = dict(info, t0=time.perf_counter())  # the session's start
        self._prof = self._profile()
        self._prof.start()

    def stop(self, **info) -> None:
        t1 = time.perf_counter()  # the session's end: stopping takes long
        self._prof.stop()
        info = {**self._info, **info}
        t0 = info.pop("t0")
        info["window_s"] = t1 - t0
        self.spans.append((t0, time.perf_counter()))
        self.sessions.append({"prof": self._prof, **info})
        self._prof = None

    def summary(self) -> dict | None:
        """The first session with device time, read (``read_trace``), with
        the session's own info (``window_s`` and what the driver gave)."""
        for s in self.sessions:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                s["prof"].export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f).get("traceEvents", [])
            finally:
                os.unlink(path)
            read = read_trace(events)
            if read["busy_s"] > 0:
                info = {k: v for k, v in s.items() if k != "prof"}
                return {**read, **info, "sessions_tried": self.sessions.index(s) + 1}
        return None


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(spans: list[tuple[float, float, str]], starts: list[float], t: float,
               look_back: int = 256) -> str | None:
    """The latest-starting of the ``look_back`` spans last started before
    ``t`` that covers it (spans sorted by start, ``starts`` their starts)."""
    i = bisect.bisect_right(starts, t)
    for a, b, name in reversed(spans[max(0, i - look_back):i]):
        if b >= t:
            return name
    return None


def read_trace(events: list[dict]) -> dict:
    """Busy seconds, device time by group and by kernel (seconds, launches),
    and idle gaps by host activity, from Chrome trace events (µs)."""
    device, ours, host = [], [], []
    for e in events:
        cat, dur = str(e.get("cat", "")).lower(), e.get("dur")
        if e.get("ph") != "X" or dur is None:
            continue
        ts = float(e["ts"])
        if cat in DEVICE_CATS:
            device.append((ts, ts + float(dur), e.get("name", "?"), cat))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
            ours.append((ts, ts + float(dur), e["name"]))
        elif cat in HOST_CATS:
            host.append((ts, ts + float(dur), e.get("name", "?")))
    kernels: dict[str, list] = defaultdict(lambda: [0.0, 0])
    groups: dict[str, float] = defaultdict(float)
    for a, b, name, cat in device:
        kernels[name][0] += (b - a) / 1e6
        kernels[name][1] += 1
        if cat == "kernel":
            groups[kernel_group(name)] += (b - a) / 1e3
    busy = _merge([(a, b) for a, b, _, _ in device])
    ours.sort()
    host.sort()
    ours_at, host_at = [a for a, _, _ in ours], [a for a, _, _ in host]
    gaps: dict[str, list] = defaultdict(lambda: [0.0, 0])
    for (_, end), (start, _) in zip(busy, busy[1:]):
        mid = (end + start) / 2
        if start - end < SHORT_GAP_US:
            label = SHORT_GAP
        else:
            label = (_innermost(ours, ours_at, mid) or _innermost(host, host_at, mid)
                     or "no host activity recorded")
        gaps[label][0] += (start - end) / 1e6
        gaps[label][1] += 1
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "groups_ms": dict(groups),
        "kernels": {k: tuple(v) for k, v in kernels.items()},
        "device_ops": [[name, s] for name, (s, _) in top_ops],
        "idle_gaps": [[f"{name} ({n} gaps)", s] for name, (s, n) in top_gaps],
    }

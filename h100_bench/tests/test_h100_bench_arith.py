"""The yardstick's FLOP and byte counts on known shapes, held to the
bounds that chip_smoke.py printed for the same shapes (PERF.md's kernel
table: kernel 1 0.1484 ms, kernel 2 0.0507 ms, with PE-Core's rope
0.2089 ms), and the model FLOP of each configuration counted by hand."""

from __future__ import annotations

import json

import pytest

import tiny  # noqa: F401
from hbench.cell import BENCH_DIR
from hbench.layouts.vit import flop_per_image as vision_flop_per_image
from hbench.roofline import PEAKS, attention_work, bound_s, ln_qkv_work, peaks_for

SXM = PEAKS["sxm"]


def config(name):
    return json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_ln_qkv_so400m_bound():
    flop, nbytes = ln_qkv_work(32 * 576, 1152)
    assert flop == 2 * 18432 * 1152 * 3456
    assert nbytes == 2 * (18432 * 1152 * 4 + 2 * 1152 + 3 * 1152 * 1152 + 3 * 1152)
    assert bound_s(flop, nbytes, SXM) * 1e3 == pytest.approx(0.1484, abs=5e-5)
    assert flop / SXM["bf16"] > nbytes / SXM["bytes"]  # bound by operations


def test_attention_so400m_bound_is_bytes():
    flop, nbytes = attention_work(32, 16, 576, 72)
    assert nbytes == 4 * 2 * 32 * 576 * 16 * 72
    assert flop == 4 * 32 * 16 * 576 * 576 * 72
    assert bound_s(flop, nbytes, SXM) * 1e3 == pytest.approx(0.0507, abs=5e-5)


def test_attention_pe_core_rope_bound_is_operations():
    plain = attention_work(32, 16, 1025, 96)
    flop, nbytes = attention_work(32, 16, 1025, 96, rope=True)
    assert flop - plain[0] == 6 * 32 * 1025 * 16 * 96
    assert nbytes - plain[1] == 8 * 1025 * 1536
    assert bound_s(flop, nbytes, SXM) * 1e3 == pytest.approx(0.2089, abs=5e-4)


def test_so400m_flop_per_image():
    w, m, s, L = 1152, 4304, 576, 27
    block = 2 * s * w * 3 * w + 2 * s * w * w + 4 * s * w * m + 4 * s * s * w
    pool = 2 * w * w + 4 * s * w * w + 4 * s * w + 2 * w * w + 4 * w * m
    want = 2 * 576 * 768 * w + L * block + pool
    got = vision_flop_per_image(config("vit-so400m-16-siglip2-384")["vision"])
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.51e12 < got < 0.53e12


def test_pe_core_flop_per_image():
    w, m, s, L, e = 1536, 8960, 1025, 50, 1280
    block = 2 * s * w * 3 * w + 2 * s * w * w + 4 * s * w * m + 4 * s * s * w
    pool = 2 * w * w + 4 * s * w * w + 4 * s * w + 2 * w * w + 4 * w * 6144
    want = 2 * 1024 * 588 * w + L * block + pool + 2 * w * e
    got = vision_flop_per_image(config("pe-core-bigg-14-448")["vision"])
    assert got == pytest.approx(want, rel=1e-12)
    assert 4.0e12 < got < 4.2e12


def test_peaks_by_card_name():
    assert peaks_for("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert peaks_for("NVIDIA H100 PCIe")["bytes"] == 2.0e12

"""chip_smoke.py's phase 9 (the deployment path: an open_clip checkpoint
converted by the port, loaded, held against its source model and served
over HTTP) and phase 12 (the sharded path) rehearsed on the CPU at a cut
size."""

import importlib.util
from pathlib import Path

import torch


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_deployment_path_rehearses_on_cpu():
    """chip_smoke.py's phase 9 at SO400M's full width, cut to one layer a
    tower, a small vocabulary and a few requests, on the CPU in f32: the
    checkpoint converts, the converted Clip computes its source model,
    every endpoint answers as the direct call does, concurrent clients
    coalesce, and no kernel is launched."""
    out = _chip_smoke().phase_serving("cpu", torch.float32, layers=1, vocab_size=512, batch=3,
                              clients=6, hold=2, warm=(1,), timed=False)
    assert min(out["source_cosine"].values()) > 1 - 1e-5
    assert set(out["single_client"]["launches"].values()) == {0}
    assert min(out["single_client"]["cosines"].values()) > 1 - 1e-6
    assert out["concurrent"]["clients"] == 6 and out["concurrent"]["windows"] <= 2
    assert set(out["convert_s"]) == {"build", "save", "load_checkpoint",
                                     "derive_model_config", "convert_checkpoint"}


def test_chip_smoke_sharded_path_rehearses_on_cpu():
    """chip_smoke.py's phase 12 at SO400M's full width, cut to one layer a
    tower, on meshes of two CPU entries in f32: DP (plain and int8_all),
    TP, the sharded text embedder, the pipeline, a small corpus and the
    mesh server all hold the unsharded path, and no kernel is launched."""
    out = _chip_smoke().phase_sharded("cpu", torch.float32, layers=1, vocab_size=512, batch=4,
                                      stream=12, corpus_rows=1000, clients=6, timed=False)
    for part in ("dp", "dp_int8_all"):
        assert set(out[part]["launches"].values()) == {0}
        assert out[part]["cosine"] > 1 - 1e-5
    assert out["tp"]["cosine"] > 1 - 1e-5 and out["text"]["cosine"] > 1 - 1e-5
    assert out["search"]["swaps"] == 0 and out["search"]["max_abs_err"] < 1e-5
    assert out["server"]["clients"] == 6 and out["server"]["windows"] <= 2
    assert min(out["server"]["single_client"].values()) > 1 - 1e-5

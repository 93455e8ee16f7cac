"""chip_smoke.py's phase 9 (the deployment path: an open_clip checkpoint
converted by the port, loaded, held against its source model and served
over HTTP) rehearsed on the CPU at a cut size."""

from pathlib import Path

import torch


def test_chip_smoke_deployment_path_rehearses_on_cpu():
    """chip_smoke.py's phase 9 at SO400M's full width, cut to one layer a
    tower, a small vocabulary and a few requests, on the CPU in f32: the
    checkpoint converts, the converted Clip computes its source model,
    every endpoint answers as the direct call does, concurrent clients
    coalesce, and no kernel is launched."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_serving("cpu", torch.float32, layers=1, vocab_size=512, batch=3,
                              clients=6, hold=2, warm=(1,), timed=False)
    assert min(out["source_cosine"].values()) > 1 - 1e-5
    assert set(out["single_client"]["launches"].values()) == {0}
    assert min(out["single_client"]["cosines"].values()) > 1 - 1e-6
    assert out["concurrent"]["clients"] == 6 and out["concurrent"]["windows"] <= 2
    assert set(out["convert_s"]) == {"build", "save", "load_checkpoint",
                                     "derive_model_config", "convert_checkpoint"}

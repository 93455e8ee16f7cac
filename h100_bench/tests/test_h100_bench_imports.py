"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level module names; the reference loads nothing of the program; a run
without a card, or without the program beside it, prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

import tiny
from hbench.cell import BENCH_DIR, ROOT

sys.path.insert(0, str(BENCH_DIR))
import run  # noqa: E402


def test_forbidden_names_compared_whole():
    loaded = ["clip_embedder_tpu_torch", "clip_embedder_tpu_torch.ops.flash", "jaxtyping",
              "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "clip_embedder_tpu",
              "clip_embedder_tpu.vision", "numpy"]
    assert run.forbidden_modules(loaded) == [
        "clip_embedder_tpu", "clip_embedder_tpu.vision", "flax.linen", "jax", "jax.numpy",
        "jaxlib.xla_client"]


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=600)


@pytest.mark.parametrize("workload", ["so400m.bulk", "pecore.bulk", "so400m.online"])
def test_a_cells_run_loads_no_jax(workload):
    code = (f"import sys, json; sys.path[:0] = [{str(tiny.__file__.rsplit('/', 1)[0])!r}]\n"
            "import tiny, run\n"
            f"r = tiny.run({workload!r}, seconds=0.3, trace=True)\n"
            "print(json.dumps({'correct': r['correct'], 'found': run.forbidden_modules(),"
            " 'port': 'clip_embedder_tpu_torch' in sys.modules}))")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "found": [], "port": True}


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path[:0] = [{str(BENCH_DIR)!r}]\n"
            "import numpy as np, torch\n"
            "from hbench.cell import cell_files, load_benchmark\n"
            "from hbench.check import judge\n"
            "sys.path.insert(0, 'h100_bench/tests'); import tiny\n"
            "_, c, t = cell_files(load_benchmark(), 'pecore.bulk')\n"
            "c, t = tiny.shrink(c, t)\n"
            "from hbench.images import make_pool\n"
            "pool = make_pool(t, 3, 'cpu')\n"
            "answers = {i: np.zeros(c['vision']['embed_dim'], np.float32) for i in range(4)}\n"
            "ok, checks, info = judge(c, 3, pool, answers, lambda i: i, 0, 'cpu', 4)\n"
            "print(json.dumps({'ok': ok, 'loaded': sorted(m for m in sys.modules"
            " if m.split('.')[0].startswith('clip_embedder'))}))")
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"ok": False, "loaded": []}


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure, not refuse")
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "so400m.bulk",
                           "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "so400m.bulk",
                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "clip_embedder_tpu_torch" in proc.stderr

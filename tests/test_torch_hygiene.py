"""Boundaries of the torch port: it imports neither JAX nor the JAX
package, passes the repo's linter, and never drops to the CPU on its own."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "clip_embedder_tpu_torch"
FIXTURE = REPO / "tests" / "fixtures" / "golden_siglip"


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import clip_embedder_tpu_torch\n"
        "from clip_embedder_tpu_torch import Clip, TextEmbedder, VisionEmbedder\n"
        "from clip_embedder_tpu_torch.ops import cuda, flash, int8_mlp, qkv, preprocess, quant\n"
        "from clip_embedder_tpu_torch.ops import rope\n"
        "from clip_embedder_tpu_torch import native, pull_weights, serving\n"
        "from clip_embedder_tpu_torch.utils import logging\n"
        "from clip_embedder_tpu_torch.models import build, text_transformer, vit\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'clip_embedder_tpu' or m.startswith('clip_embedder_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_file_imports_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import\s+jax\b|from\s+jax\b|import\s+clip_embedder_tpu\b(?!_torch)"
        r"|from\s+clip_embedder_tpu\b(?!_torch))", re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(REPO)) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_lint_clean():
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "lint.py"), "clip_embedder_tpu_torch",
         "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout


def test_kernel_sources_are_present_and_noted():
    """Each kernel source says which TPU kernel it replaces, what bounds it
    on the H100, and what its design does about that."""
    sources = sorted((PORT / "csrc").glob("*.cu"))
    assert [s.name for s in sources] == ["flash_bhsd.cu", "flash_packed.cu", "int8_linear.cu",
                                         "int8_mlp.cu", "int8_mlp_streamed.cu", "ln_qkv.cu",
                                         "ln_qkv_int8.cu"]
    for src in sources:
        head = src.read_text()[:3000]
        assert "Replaces the TPU kernel clip_embedder_tpu/ops/" in head
        assert "What bounds it on the H100" in head
        assert "What the design does about that" in head
        assert 'extern "C" int' in src.read_text()


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from clip_embedder_tpu_torch import Clip, TextEmbedder, VisionEmbedder
    from clip_embedder_tpu_torch.errors import DeviceError

    for entry in (Clip, VisionEmbedder, TextEmbedder):
        with pytest.raises(DeviceError, match="CUDA is not available"):
            entry.from_local_dir(FIXTURE)
        with pytest.raises(DeviceError, match="CUDA is not available"):
            entry.from_local_dir(FIXTURE, device="cuda")


def test_resolve_device_and_attn_impl(no_cuda):
    from clip_embedder_tpu_torch.errors import ConfigError, DeviceError
    from clip_embedder_tpu_torch.vision import resolve_attn_impl, resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(DeviceError, match="Unsupported device"):
        resolve_device("meta")
    assert resolve_attn_impl("auto", torch.device("cpu")) == "eager"
    assert resolve_attn_impl("auto", torch.device("cuda")) == "kernel"
    assert resolve_attn_impl("kernel_fast", torch.device("cpu")) == "kernel_fast"
    with pytest.raises(ConfigError, match="Unknown attn_impl"):
        resolve_attn_impl("xla", torch.device("cpu"))


def test_kernel_wrappers_take_the_plain_path_only_on_cpu():
    """A CPU tensor runs the plain version (no launch counted); a tensor on
    another device is refused rather than quietly moved."""
    from clip_embedder_tpu_torch.ops import flash, int8_mlp, qkv
    from clip_embedder_tpu_torch.ops.quant import quantize_weight

    wrappers = (qkv.ln_qkv, flash.flash_attention_packed, flash.flash_attention,
                qkv.ln_qkv_int8, int8_mlp.int8_mlp, int8_mlp.int8_mlp_streamed,
                int8_mlp.int8_linear_fused)
    before = [fn.launches for fn in wrappers]
    x = torch.randn(1, 4, 64)
    params = {n: {"w": torch.randn(64, 64) * 0.1} for n in "qkv"}
    qparams = {n: quantize_weight(torch.randn(64, 64) * 0.1) for n in "qkv"}
    mlp = {"fc": quantize_weight(torch.randn(64, 128) * 0.1),
           "proj": quantize_weight(torch.randn(128, 64) * 0.1)}
    ln = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    q, k, v = qkv.ln_qkv(params, ln, x)
    flash.flash_attention_packed(q, k, v, num_heads=4)
    flash.flash_attention(*(t.reshape(1, 4, 4, 16).transpose(1, 2) for t in (q, k, v)))
    qkv.ln_qkv_int8(qparams, ln, x)
    int8_mlp.int8_mlp(mlp, x, pre_ln=ln, add_residual=True)
    int8_mlp.int8_mlp_streamed(mlp, x, pre_ln=ln, add_residual=True)
    int8_mlp.int8_linear_fused(qparams["q"], x, residual=x)
    assert [fn.launches for fn in wrappers] == before
    meta = x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        qkv.ln_qkv(params, ln, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_attention_packed(meta, meta, meta, num_heads=4)
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_attention(*(meta.reshape(1, 4, 4, 16),) * 3)
    with pytest.raises(ValueError, match="unsupported device"):
        qkv.ln_qkv_int8(qparams, ln, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_mlp.int8_mlp_streamed(mlp, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_mlp.int8_mlp(mlp, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        int8_mlp.int8_linear_fused(qparams["q"], meta)


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                               "HOME": str(REPO)})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

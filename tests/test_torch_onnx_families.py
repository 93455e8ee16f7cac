"""Reference-format ONNX dirs of the other vision families through the port's
``VisionEmbedder`` against the JAX package's, on the CPU: FastViT
(MobileCLIP2), ConvNeXt and ModifiedResNet (tests/test_onnx_dir_e2e.py),
EVA02 (tests/test_convert_verify.py) and PE-Core
(tests/test_pe_core.py, without ``pe_cfg``). Each dir is copied once per
package; each package derives the dims the config lacks or gets wrong
from the graph, converts, self-checks and persists. The embeddings agree
at cosine > 1 - 1e-6 and atol 5e-4 (tests/test_golden.py:40-45), and the
``visual.npz`` and config each package writes are equal.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).parent))

from test_convert_verify import _TmpFactory, eva02_onnx_dir  # noqa: E402
from test_onnx_dir_e2e import convnext_onnx_dir, fastvit_onnx_dir, resnet_onnx_dir  # noqa: E402

from clip_embedder_tpu import VisionEmbedder as JVisionEmbedder  # noqa: E402
from clip_embedder_tpu_torch import VisionEmbedder  # noqa: E402

# dir → (its fixture, the family it must convert to, the derived config key)
DIRS = {
    "fastvit": (fastvit_onnx_dir, "fastvit", None),
    "convnext": (convnext_onnx_dir, "convnext", "convnext_cfg"),
    "resnet": (resnet_onnx_dir, "resnet", "resnet_cfg"),
    "eva02": (eva02_onnx_dir, "eva02", "eva02_cfg"),
    "pe": (None, "vit", "pe_cfg"),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name → (port embedder, JAX embedder, port dir, JAX dir), each
    loaded in f32 from its own copy."""
    from test_pe_core import _build_pe_onnx_dir

    base = tmp_path_factory.mktemp("families")
    out = {}
    for name, (fixture, _, _) in DIRS.items():
        if fixture is None:
            (base / name).mkdir()
            src = _build_pe_onnx_dir(base / name, with_pe_cfg=False)[0]
        else:
            got = fixture.__wrapped__(_TmpFactory(base / name))
            src = got[0] if isinstance(got, tuple) else got
        pd, jd = base / f"{name}_port", base / f"{name}_jax"
        shutil.copytree(src, pd)
        shutil.copytree(src, jd)
        out[name] = (VisionEmbedder.from_local_dir(pd, device="cpu"),
                     JVisionEmbedder.from_local_dir(jd), pd, jd)
    return out


def _images():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 255, shape, np.uint8) for shape in ((64, 64, 3), (50, 70, 3))]


@pytest.mark.parametrize("name", list(DIRS))
def test_family_dir_converts_like_jax(pairs, name):
    port, jemb, pd, jd = pairs[name]
    family, key = DIRS[name][1], DIRS[name][2]
    assert port.spec.family == jemb.spec.family == family
    occ = json.loads((pd / "open_clip_config.json").read_text())
    assert occ == json.loads((jd / "open_clip_config.json").read_text())
    if key:
        assert occ["model_cfg"]["vision_cfg"][key]  # derived from the graph, persisted
    a, b = np.load(pd / "visual.npz"), np.load(jd / "visual.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", list(DIRS))
def test_family_dir_embeddings_match_jax(pairs, name):
    port, jemb, _, _ = pairs[name]
    got, ref = port.embed_images(_images()), jemb.embed_images(_images())
    assert got.shape == ref.shape
    assert ((got * ref).sum(-1) > 1 - 1e-6).all()
    np.testing.assert_allclose(got, ref, atol=5e-4)


# -- chip_smoke.py phase 11 (the ONNX path) on the CPU ----------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke_dirs(tmp_path_factory):
    """Phase 11's two reference-format dirs at full width, one block a
    stage and a vocabulary of 1000, as the phase writes them."""
    smoke = _chip_smoke()
    base = tmp_path_factory.mktemp("phase11")
    out = {}
    for name, pre in (("CLIP-ViT-B-32", smoke.OPENAI_PREPROCESS),
                      ("MobileCLIP-S0 scale", smoke.S0_PREPROCESS)):
        cfg, vision, text = smoke.onnx_mirrors(name, layers=1, vocab_size=1000)
        smoke.write_onnx_dir(base / name.replace(" ", "_"), cfg, vision, text, pre)
        out[name] = base / name.replace(" ", "_")
    return smoke, out


@pytest.mark.parametrize("name,mode", [("CLIP-ViT-B-32", None), ("CLIP-ViT-B-32", "int8_all"),
                                       ("MobileCLIP-S0 scale", None),
                                       ("MobileCLIP-S0 scale", "int8")])
def test_phase11_launches_follow_the_gates(smoke_dirs, name, mode, tmp_path, monkeypatch):
    """One forward of each phase-11 tower, with the gates as on the card
    (each wrapper then runs its plain version), calls the wrappers as often
    as ``chip_smoke.onnx_launches`` says phase 11 will count there: over
    a batch's rows and over one image's 50 rows (under 128: no fused
    out-projection)."""
    import torch

    from clip_embedder_tpu_torch import TextEmbedder
    from clip_embedder_tpu_torch.ops import attention, int8_mlp, layers, qkv

    smoke, dirs = smoke_dirs
    d = tmp_path / "dir"
    shutil.copytree(dirs[name], d)
    monkeypatch.setattr(int8_mlp, "on_card", lambda x: True)
    monkeypatch.setattr(qkv, "on_card", lambda x: True)
    calls = dict.fromkeys(smoke._wrappers(), 0)

    def spy(module, fn_name):
        real = getattr(module, fn_name)

        def run(*a, **kw):
            calls[fn_name] += 1
            return real(*a, **kw)
        monkeypatch.setattr(module, fn_name, run)

    for fn_name in ("ln_qkv", "ln_qkv_int8", "flash_attention_packed", "flash_attention",
                    "int8_linear_fused"):
        spy(attention, fn_name)
    for fn_name in ("int8_mlp", "int8_linear_fused", "int8_mlp_streamed"):
        spy(layers, fn_name)
    vit = name == "CLIP-ViT-B-32"
    vmode = mode if vit else None  # the phase quantizes S0's text tower alone
    vision = VisionEmbedder.from_local_dir(d, device="cpu", quantize=vmode,
                                           attn_impl="kernel" if vit else "eager")
    text = TextEmbedder.from_local_dir(d, device="cpu", quantize=mode, attn_impl="kernel")
    for n_img in (2, 1):
        calls.update(dict.fromkeys(calls, 0))
        vision.embed_images(_images()[:1] * n_img)
        rows = n_img * vision.spec.cfg.seq_len if vit else 0
        assert calls == smoke.onnx_launches(vision.spec, vmode, rows)
    calls.update(dict.fromkeys(calls, 0))
    text.embed_texts(["a cat", "a photo of the dog"])
    assert calls == smoke.onnx_launches(text.spec, mode, 2 * 77)
    assert calls["flash_attention_packed"] == text.spec.cfg.layers > 0


def test_chip_smoke_onnx_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 11 at full width, one block a stage and a
    vocabulary of 1000, on the CPU: both dirs export, convert to the routes
    the phase asserts (vit + text_transformer, fastvit + mct) with no
    executor fallback, agree with their mirrors, the executor with the
    mirrors, and the quantized modes run."""
    import torch

    smoke = _chip_smoke()
    out = smoke.phase_onnx("cpu", torch.float32, layers=1, vocab_size=1000, batch=2,
                           timed=False)
    assert sorted(out) == ["CLIP-ViT-B-32", "MobileCLIP-S0 scale"]
    assert set(out["CLIP-ViT-B-32"]["int8_launches"]) == {"embed_images", "embed_texts"}
    assert set(out["MobileCLIP-S0 scale"]["int8_launches"]) == {"embed_texts"}

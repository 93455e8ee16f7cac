"""The torch port end to end on the committed golden fixtures, on the CPU:
``Clip.from_local_dir(fixture, device="cpu")`` reproduces the pinned
embeddings and classify results (tests/test_golden.py's tolerances) and
agrees with the JAX ``Clip`` on the same inputs; and a CoCa dir the test
writes (both CoCa towers, golden_siglip's tokenizer) agrees with the JAX
``Clip`` on it."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu import Clip as JaxClip
from clip_embedder_tpu.tokenizer import Tokenizer as JaxTokenizer
from clip_embedder_tpu_torch import Clip
from clip_embedder_tpu_torch.errors import (ConfigError, InferenceError,
                                            ModelFolderNotFoundError, WeightError)
from clip_embedder_tpu_torch.tokenizer import Tokenizer

FIXTURES = Path(__file__).parent / "fixtures"
PORTED = ["golden_siglip", "golden_model", "golden_hf_bert", "golden_eva02", "golden_fastvit",
          "golden_convnext", "golden_resnet"]
# vision families with no attention kernel (the JAX package's check_attn_impl)
EAGER_ONLY = {"golden_fastvit", "golden_convnext", "golden_resnet"}
TEXTS = ["a photo of a cat", "the dog!"]
# a small CoCa (open_clip coca_* layout): width 128 with 4 heads x 32 (a
# 128-lane head group: the packed kernel's full-mask form in the text
# tower), embed 96 != width, 8 pooler queries
COCA_CFG = {
    "embed_dim": 96,
    "vision_cfg": {"image_size": 32, "layers": 2, "width": 128, "patch_size": 8,
                   "head_width": 32, "attentional_pool": True, "attn_pooler_queries": 8,
                   "attn_pooler_heads": 8, "output_tokens": True},
    "text_cfg": {"context_length": 12, "vocab_size": 64, "width": 128, "heads": 4,
                 "layers": 2, "embed_cls": True, "output_tokens": True},
}


@pytest.fixture(scope="module")
def coca_dir(tmp_path_factory):
    """A CoCa model dir: the config above, golden_siglip's tokenizer and
    scoring config (its pad id 1, so the cls mask must take the tokenizer's
    pad id, not text_cfg's 0) and preprocess, seeded JAX-initialized weights
    written with the JAX package's save_pytree."""
    import jax

    from clip_embedder_tpu import weights as jweights
    from clip_embedder_tpu.config import ModelCfg as JModelCfg
    from clip_embedder_tpu.models import build as jbuild
    from clip_embedder_tpu.models import text_transformer as jtext
    from clip_embedder_tpu.models import vit as jvit

    d = tmp_path_factory.mktemp("coca")
    src = FIXTURES / "golden_siglip"
    pre = json.loads((src / "open_clip_config.json").read_text())["preprocess_cfg"]
    (d / "open_clip_config.json").write_text(json.dumps(
        {"model_cfg": COCA_CFG, "preprocess_cfg": pre}))
    for f in ("model_config.json", "tokenizer.json", "golden_image.npy"):
        (d / f).write_bytes((src / f).read_bytes())
    mc = JModelCfg.from_dict(COCA_CFG)
    vspec, tspec = jbuild.resolve_vision(mc), jbuild.resolve_text(mc)
    assert vspec.cfg.pool == "attn" and tspec.cfg.embed_cls
    jweights.save_pytree(d / "visual.npz", jvit.init(jax.random.key(0), vspec.cfg))
    jweights.save_pytree(d / "text.npz", jtext.init(jax.random.key(1), tspec.cfg))
    return d


def model_dir(name, request):
    return request.getfixturevalue("coca_dir") if name == "coca" else FIXTURES / name


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.fixture(scope="module")
def clips():
    return {name: Clip.from_local_dir(FIXTURES / name, device="cpu") for name in PORTED}


@pytest.mark.parametrize("name", PORTED)
def test_golden_embeddings(clips, name):
    fixture = FIXTURES / name
    clip = clips[name]
    img = np.load(fixture / "golden_image.npy")
    golden = np.load(fixture / "golden_outputs.npz")
    img_emb = clip.vision.embed_image(img)
    assert cosines(img_emb, golden["image_embedding"]).min() > 1 - 1e-6
    np.testing.assert_allclose(img_emb, golden["image_embedding"], atol=5e-4)
    txt_emb = clip.text.embed_texts(TEXTS)
    assert cosines(txt_emb, golden["text_embeddings"]).min() > 1 - 1e-6
    np.testing.assert_allclose(txt_emb, golden["text_embeddings"], atol=5e-4)


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("impl", ["eager", "kernel", "kernel_fast"])
def test_golden_classify(name, impl):
    """Every attn impl (the kernel impls run the kernels' plain versions on
    the CPU) keeps the golden label order and probabilities. The
    convolutional families refuse a kernel impl, as the JAX package does;
    there the text tower takes it beside the eager vision tower."""
    fixture = FIXTURES / name
    if name in EAGER_ONLY and impl != "eager":
        from clip_embedder_tpu_torch import TextEmbedder, VisionEmbedder

        with pytest.raises(ConfigError, match="not supported for the"):
            Clip.from_local_dir(fixture, device="cpu", attn_impl=impl)
        clip = Clip(vision=VisionEmbedder.from_local_dir(fixture, device="cpu"),
                    text=TextEmbedder.from_local_dir(fixture, device="cpu", attn_impl=impl),
                    model_dir=fixture)
        assert clip.text.attn_impl == impl
    else:
        clip = Clip.from_local_dir(fixture, device="cpu", attn_impl=impl)
    img = np.load(fixture / "golden_image.npy")
    golden = json.loads((fixture / "golden_classify.json").read_text())
    results = clip.classify(img, [label for label, _ in golden])
    assert [r[0] for r in results] == [g[0] for g in golden]
    # the fixtures' 4 x 16 heads take flash_attention, whose exp is f32 on
    # every impl (the bf16 exp is the packed kernel's alone)
    np.testing.assert_allclose([r[1] for r in results], [g[1] for g in golden], atol=1e-4)


@pytest.mark.parametrize("name", PORTED)
def test_agrees_with_jax_clip(clips, name):
    fixture = FIXTURES / name
    jclip = JaxClip.from_local_dir(fixture)
    clip = clips[name]
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in ((40, 48), (97, 61))]
    texts = TEXTS + ["", "an unusually long caption " * 8]
    np.testing.assert_allclose(clip.vision.embed_images(images),
                               jclip.vision.embed_images(images), atol=1e-5)
    np.testing.assert_allclose(clip.vision.preprocess_batch(images),
                               jclip.vision.preprocess_batch(images), atol=1e-5)
    np.testing.assert_allclose(clip.text.embed_texts(texts),
                               jclip.text.embed_texts(texts), atol=1e-5)
    for a, b in zip(clip.text.tokenize(texts), jclip.text.tokenize(texts)):
        np.testing.assert_array_equal(a, b)
    assert abs(clip.compare(images[0], TEXTS[0]) - jclip.compare(images[0], TEXTS[0])) < 1e-4
    got = clip.rank_images(images, TEXTS[1])
    ref = jclip.rank_images(images, TEXTS[1])
    assert [i for i, _ in got] == [i for i, _ in ref]


def test_coca_dir_agrees_with_jax_clip(coca_dir):
    """Both CoCa towers through Clip.from_local_dir, f32, on every attn impl
    (the kernel impls run the kernels' plain versions), against the JAX
    Clip; the text embeddings include a row of pad ids alone. kernel_fast
    takes the packed kernel's bf16 exp here (4 heads x 32, d < 96), which
    rounds every softmax weight to 8 bits: it is held at cosine 1 - 1e-5
    and atol 1e-3, the others at atol 1e-5."""
    jclip = JaxClip.from_local_dir(coca_dir)
    rng = np.random.default_rng(2)
    images = [np.load(coca_dir / "golden_image.npy"),
              rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)]
    texts = TEXTS + ["", "an unusually long caption " * 8]
    ref_img, ref_txt = jclip.vision.embed_images(images), jclip.text.embed_texts(texts)
    labels = TEXTS + ["a red balloon"]
    ref = jclip.classify(images[0], labels)
    for impl in ("eager", "kernel", "kernel_fast"):
        clip = Clip.from_local_dir(coca_dir, device="cpu", attn_impl=impl)
        assert clip.text.tower.cfg.pad_id == clip.text.pad_id == 1
        atol = 1e-3 if impl == "kernel_fast" else 1e-5
        for got, want in ((clip.vision.embed_images(images), ref_img),
                          (clip.text.embed_texts(texts), ref_txt)):
            assert cosines(got, want).min() > 1 - 1e-5
            np.testing.assert_allclose(got, want, atol=atol)
        got = clip.classify(images[0], labels)
        assert [r[0] for r in got] == [r[0] for r in ref]
        np.testing.assert_allclose([r[1] for r in got], [r[1] for r in ref], atol=atol)
        assert abs(clip.compare(images[1], TEXTS[1]) - jclip.compare(images[1], TEXTS[1])) \
            < 100 * atol  # a raw logit: the similarity times logit_scale 100


@pytest.mark.parametrize("name", PORTED + ["coca"])
@pytest.mark.parametrize("quantize", [None, "int8", "int8_all"])
def test_agrees_with_jax_clip_in_bf16(name, quantize, request):
    """bf16 weights and activations in both packages, under each quantize
    mode: image and text embeddings at cosine >= 1 - 1e-3, the budget the
    JAX package grants its int8 modes against bf16
    (clip_embedder_tpu/ops/quant.py). The two frameworks round bf16 at other
    places, so this holds the algorithm, not the bits; a bias rounded twice
    or an activation taken in bf16 moves a 64-wide model past it. ResNet has
    nothing to quantize: both packages refuse the int8 modes."""
    fixture = model_dir(name, request)
    if name == "golden_resnet" and quantize:
        with pytest.raises(ConfigError, match="no quantizable"):
            Clip.from_local_dir(fixture, device="cpu", quantize=quantize)
        with pytest.raises(Exception, match="no quantizable"):
            JaxClip.from_local_dir(fixture, quantize=quantize)
        return
    clip = Clip.from_local_dir(fixture, device="cpu", dtype=torch.bfloat16, quantize=quantize)
    jclip = JaxClip.from_local_dir(fixture, dtype=jnp.bfloat16, quantize=quantize)
    rng = np.random.default_rng(1)
    images = [np.load(fixture / "golden_image.npy"),
              rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)]
    texts = TEXTS + ["an unusually long caption " * 8]
    assert cosines(clip.vision.embed_images(images),
                   jclip.vision.embed_images(images)).min() >= 1 - 1e-3
    assert cosines(clip.text.embed_texts(texts), jclip.text.embed_texts(texts)).min() \
        >= 1 - 1e-3


@pytest.mark.parametrize("name", [p.name for p in sorted(FIXTURES.iterdir())
                                  if (p / "tokenizer.json").is_file()])
def test_tokenizer_copy_matches_jax(name):
    path = FIXTURES / name / "tokenizer.json"
    texts = ["A photo of a CAT.", "the dog!", "", "naïve café, 2 beignets", "x" * 300]
    ours, ref = Tokenizer.from_file(path), JaxTokenizer.from_file(path)
    for tok in (ours, ref):
        tok.with_padding(length=16, pad_id=0)
        tok.with_truncation(max_length=16)
    for a, b in zip(ours.encode_batch(texts), ref.encode_batch(texts)):
        np.testing.assert_array_equal(a, b)


def test_duplicate_shares_weights(clips):
    clip = clips["golden_model"]
    dup = clip.duplicate()
    assert dup.vision.tower is clip.vision.tower and dup.text.tower is clip.text.tower
    img = np.load(FIXTURES / "golden_model" / "golden_image.npy")
    np.testing.assert_array_equal(dup.vision.embed_image(img), clip.vision.embed_image(img))
    np.testing.assert_array_equal(dup.text.embed_text("a cat"), clip.text.embed_text("a cat"))


def test_error_surface(clips, tmp_path):
    clip = clips["golden_siglip"]
    with pytest.raises(InferenceError, match="Empty batch"):
        clip.vision.embed_images([])
    with pytest.raises(InferenceError, match="Empty batch"):
        clip.text.embed_texts([])
    with pytest.raises(ModelFolderNotFoundError):
        Clip.from_local_dir(tmp_path / "nope", device="cpu")
    with pytest.raises(ConfigError, match="attn_impl"):
        Clip.from_local_dir(FIXTURES / "golden_siglip", device="cpu", attn_impl="pallas")


def test_onnx_only_dir_loads_and_equals_jax(tmp_path):
    """A dir with ONNX graphs and no native npz (the reference's format:
    tests/test_onnx_dir_e2e.py's mini CLIP) loads, converting in place, and
    equals the JAX ``Clip`` on a copy of it (tests/test_golden.py's
    tolerances); both write the same npz files."""
    import shutil
    import sys

    sys.path.insert(0, str(Path(__file__).parent))
    from test_convert_verify import _TmpFactory
    from test_onnx_dir_e2e import onnx_model_dir

    src, _, _, jpg = onnx_model_dir.__wrapped__(_TmpFactory(tmp_path / "src"))
    pd, jd = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(src, pd)
    shutil.copytree(src, jd)
    clip, jclip = Clip.from_local_dir(pd, device="cpu"), JaxClip.from_local_dir(jd)
    got, ref = clip.text.embed_texts(TEXTS), jclip.text.embed_texts(TEXTS)
    assert ((got * ref).sum(-1) > 1 - 1e-6).all()
    np.testing.assert_allclose(got, ref, atol=5e-4)
    got, ref = clip.classify(jpg, TEXTS), jclip.classify(jpg, TEXTS)
    assert [l for l, _ in got] == [l for l, _ in ref]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref], atol=1e-4)
    for name in ("visual.npz", "text.npz"):
        a, b = np.load(pd / name), np.load(jd / name)
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_empty_visual_onnx_raises_weight_error(tmp_path):
    """An ONNX-only vision tower whose graph is empty: the conversion
    fails, the executor cannot parse it either, and the typed WeightError
    surfaces, as in the JAX package."""
    src = FIXTURES / "golden_model"
    for d in (tmp_path / "port", tmp_path / "jax"):
        d.mkdir()
        for f in ("open_clip_config.json", "model_config.json", "tokenizer.json", "text.npz"):
            (d / f).write_bytes((src / f).read_bytes())
        (d / "visual.onnx").write_bytes(b"")
    with pytest.raises(WeightError, match="No graph"):
        Clip.from_local_dir(tmp_path / "port", device="cpu")
    with pytest.raises(Exception, match="No graph"):
        JaxClip.from_local_dir(tmp_path / "jax")


def test_auto_impl_is_eager_on_cpu(clips):
    assert clips["golden_siglip"].vision.attn_impl == "eager"
    assert clips["golden_siglip"].text.attn_impl == "eager"
    assert clips["golden_siglip"].vision.tower.patch_embed.w.device == torch.device("cpu")


def test_chip_smoke_main_path_rehearses_on_cpu():
    """chip_smoke.py's main-path phase (ViT-SO400M-16-SigLIP2-384 through the
    port's config → build → Clip) at full width, cut to one layer and a
    small vocabulary, on the CPU: unit-norm embeddings, sorted probabilities,
    and the plain path agreeing with itself."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_main_path("cpu", torch.float32, layers=1, vocab_size=512, batch=3,
                                timed=False)
    assert out["launches"] == {"ln_qkv": 0, "flash_attention_packed": 0}
    _, vspec, tspec = smoke.build_clip("cpu", torch.float32, layers=1, vocab_size=512)
    assert (vspec.cfg.width, vspec.cfg.heads, vspec.cfg.head_dim, vspec.cfg.seq_len,
            vspec.cfg.mlp_hidden, vspec.cfg.pool) == (1152, 16, 72, 576, 4304, "map")
    assert (tspec.cfg.width, tspec.cfg.mlp_hidden, tspec.cfg.context_length,
            tspec.cfg.pool, tspec.cfg.causal) == (1152, 4304, 64, "last", False)

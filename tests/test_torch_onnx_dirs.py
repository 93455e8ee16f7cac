"""Reference-format ONNX model dirs through the port's ``Clip`` against the
JAX ``Clip``, on the CPU. Each dir (tests/test_onnx_dir_e2e.py's mini CLIP,
tests/test_bert_onnx_dir.py's BiomedCLIP-class dir, and
tests/test_onnx_exec.py's dir that no native family fits) is copied once per
package; each package converts its copy in place:

* embeddings at cosine > 1 - 1e-6 and atol 5e-4, classify order equal and
  probabilities within 1e-4 (tests/test_golden.py:40-57), in f32; bf16,
  ``int8`` and ``int8_all`` at 1 - 1e-3 (clip_embedder_tpu/ops/quant.py:5-6);
* the npz files and the configs both packages write, equal;
* the executor fallback where no native family fits, and the typed error
  of a broken npz beside a graph;
* the two reference defects the port does not copy here: the name-mapped
  route unchecked (JAX ``onnx_reader.py:401-404``) and the root
  ``pull_weights.convert_onnx_dir`` without the load path's derivations.
"""

import json
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
sys.path.insert(0, str(Path(__file__).parents[1]))

from test_bert_onnx_dir import bert_onnx_dir  # noqa: E402, F401
from test_convert_verify import _TmpFactory  # noqa: E402
from test_onnx_dir_e2e import _NormalizedVisual, convnext_onnx_dir, onnx_model_dir  # noqa: E402
from test_onnx_exec import MctLikeTextTower, TinyConvTower, _write_model_dir, export  # noqa: E402
from torch_ref import VisionTransformer  # noqa: E402

import clip_embedder_tpu.weights as jweights  # noqa: E402
from clip_embedder_tpu import Clip as JClip  # noqa: E402
from clip_embedder_tpu import onnx_reader as jreader  # noqa: E402
from clip_embedder_tpu.text import TextEmbedder as JTextEmbedder  # noqa: E402
from clip_embedder_tpu_torch import Clip  # noqa: E402
from clip_embedder_tpu_torch import onnx_reader  # noqa: E402
from clip_embedder_tpu_torch import weights as tweights  # noqa: E402
from clip_embedder_tpu_torch.errors import WeightError  # noqa: E402
from clip_embedder_tpu_torch.text import TextEmbedder  # noqa: E402
from clip_embedder_tpu_torch.utils.logging import _warned_once  # noqa: E402

LABELS = ["a photo of a cat", "a photo of a dog", "the beignet!"]
TEXTS = ["a cat", "the beignet, of 2 dogs!", "cats"]


def _images():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 255, shape, np.uint8) for shape in ((32, 32, 3), (40, 28, 3))]


def copy_pair(src: Path, base: Path) -> tuple[Path, Path]:
    pd, jd = base / "port", base / "jax"
    shutil.copytree(src, pd)
    shutil.copytree(src, jd)
    return pd, jd


def assert_same_files(pd: Path, jd: Path, names=("visual.npz", "text.npz")):
    assert json.loads((pd / "open_clip_config.json").read_text()) == \
        json.loads((jd / "open_clip_config.json").read_text())
    for name in names:
        a, b = np.load(pd / name), np.load(jd / name)
        assert sorted(a.files) == sorted(b.files), name
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name}:{k}")


def assert_rows_close(got, ref, cos=1 - 1e-6, atol=5e-4):
    assert got.shape == ref.shape
    assert ((got * ref).sum(-1) > cos).all(), (got * ref).sum(-1)
    if atol is not None:
        np.testing.assert_allclose(got, ref, atol=atol)


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """tests/test_onnx_dir_e2e.py's mini CLIP dir, a copy per package, each
    loaded in f32 (which converts it in place)."""
    base = tmp_path_factory.mktemp("clip_pair")
    src, vt, tt, jpg = onnx_model_dir.__wrapped__(_TmpFactory(base / "src"))
    pd, jd = copy_pair(src, base)
    return Clip.from_local_dir(pd, device="cpu"), JClip.from_local_dir(jd), pd, jd, (vt, tt, jpg)


def test_onnx_dir_converts_in_place_like_jax(clip_pair):
    port, jclip, pd, jd, _ = clip_pair
    assert (port.vision.spec.family, port.text.spec.family) == ("vit", "text_transformer")
    assert (jclip.vision.spec.family, jclip.text.spec.family) == ("vit", "text_transformer")
    assert_same_files(pd, jd)


def test_onnx_dir_embeddings_match_jax(clip_pair):
    port, jclip, *_ = clip_pair
    assert_rows_close(port.vision.embed_images(_images()), jclip.vision.embed_images(_images()))
    assert_rows_close(port.text.embed_texts(TEXTS), jclip.text.embed_texts(TEXTS))


def test_onnx_dir_classify_matches_jax_and_torch(clip_pair):
    port, jclip, _, _, (vt, tt, jpg) = clip_pair
    got, ref = port.classify(jpg, LABELS), jclip.classify(jpg, LABELS)
    assert [l for l, _ in got] == [l for l, _ in ref]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref], atol=1e-4)
    # and the torch pipeline on the same file (the JAX test's own check)
    from test_onnx_dir_e2e import _torch_pipeline

    ids, _ = port.text.tokenize(LABELS)
    want = dict(zip(LABELS, _torch_pipeline(vt, tt, jpg, np.asarray(ids)).tolist()))
    assert [l for l, _ in got] == sorted(LABELS, key=lambda l: -want[l])


def test_onnx_dir_second_load_reads_the_npz(clip_pair, monkeypatch):
    port, _, pd, _, _ = clip_pair
    monkeypatch.setattr(onnx_reader, "read_onnx", lambda *a: pytest.fail("graph read again"))
    again = Clip.from_local_dir(pd, device="cpu")
    np.testing.assert_array_equal(again.text.embed_texts(TEXTS), port.text.embed_texts(TEXTS))


@pytest.mark.parametrize("mode", ["bfloat16", "int8", "int8_all"])
def test_onnx_dir_modes_match_jax(clip_pair, mode):
    """The converted dir in bf16 and under the int8 modes, against the JAX
    ``Clip`` in the same mode."""
    _, _, pd, jd, _ = clip_pair
    if mode == "bfloat16":
        port = Clip.from_local_dir(pd, device="cpu", dtype=torch.bfloat16)
        jclip = JClip.from_local_dir(jd, dtype=jnp.bfloat16)
    else:
        port = Clip.from_local_dir(pd, device="cpu", quantize=mode)
        jclip = JClip.from_local_dir(jd, quantize=mode)
    assert_rows_close(port.vision.embed_images(_images()), jclip.vision.embed_images(_images()),
                      cos=1 - 1e-3, atol=None)
    assert_rows_close(port.text.embed_texts(TEXTS), jclip.text.embed_texts(TEXTS),
                      cos=1 - 1e-3, atol=None)


# -- the executor fallback ----------------------------------------------------------

@pytest.fixture(scope="module")
def executor_pair(tmp_path_factory):
    """tests/test_onnx_exec.py's dir whose towers no native family fits (an
    MCT-like hybrid text graph the derivation does not lift: its mixer is
    followed by a pointwise conv and a BatchNorm; a conv net the config
    calls a ViT), a copy per package."""
    base = tmp_path_factory.mktemp("executor_pair")
    src = _write_model_dir(base)
    torch.manual_seed(9)
    export(MctLikeTextTower(vocab=64, ctx=12, dim=64).eval(), torch.randint(0, 64, (2, 12)),
           src / "text.onnx", input_name="input_ids", output_name="text_embeddings")
    export(TinyConvTower(embed_dim=16).eval(), torch.randn(2, 3, 16, 16), src / "visual.onnx",
           input_name="pixel_values", output_name="image_embeddings")
    return copy_pair(src, base)


def test_unfitting_graphs_fall_back_to_the_executor(executor_pair, caplog):
    import logging

    pd, jd = executor_pair
    _warned_once.clear()
    with caplog.at_level(logging.WARNING):
        port = Clip.from_local_dir(pd, device="cpu")
    jclip = JClip.from_local_dir(jd)
    assert port.vision.spec.family == port.text.spec.family == "onnx"
    assert jclip.vision.spec.family == jclip.text.spec.family == "onnx"
    msgs = " ".join(r.getMessage() for r in caplog.records)
    assert "no native vision tower" in msgs and "no native text tower" in msgs
    assert not (pd / "visual.npz").exists() and not (pd / "text.npz").exists()
    assert_rows_close(port.vision.embed_images(_images()), jclip.vision.embed_images(_images()))
    assert_rows_close(port.text.embed_texts(TEXTS), jclip.text.embed_texts(TEXTS))
    got, ref = port.classify(_images()[0], LABELS), jclip.classify(_images()[0], LABELS)
    assert [l for l, _ in got] == [l for l, _ in ref]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref], atol=1e-4)
    dup = port.duplicate()
    np.testing.assert_array_equal(dup.text.embed_texts(TEXTS), port.text.embed_texts(TEXTS))


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_executor_modes_match_jax(executor_pair, mode):
    """The executor's bf16 products and W8A8 MatMuls behind ``Clip``'s
    ``dtype`` / ``quantize``, against the JAX executor's."""
    pd, jd = executor_pair
    kw = {"dtype": torch.bfloat16} if mode == "bfloat16" else {"quantize": mode}
    jkw = {"dtype": jnp.bfloat16} if mode == "bfloat16" else {"quantize": mode}
    port = TextEmbedder.from_local_dir(pd, device="cpu", **kw)
    ref = JTextEmbedder.from_local_dir(jd, **jkw)
    assert port.spec.family == "onnx"
    assert_rows_close(port.embed_texts(TEXTS), ref.embed_texts(TEXTS), cos=1 - 1e-3, atol=None)


def test_executor_attn_impl_is_refused(executor_pair):
    """The executor family runs no attention kernel: a kernel impl is
    refused, as the JAX package refuses pallas for it."""
    from clip_embedder_tpu_torch.errors import ConfigError

    pd, _ = executor_pair
    with pytest.raises(ConfigError, match="not supported for the 'onnx' family"):
        TextEmbedder.from_local_dir(pd, device="cpu", attn_impl="kernel")


def test_broken_npz_beside_a_graph_is_raised_not_rerouted(clip_pair, tmp_path):
    """A present native npz that fails to load is corruption: it raises,
    it is not routed to the executor although a graph is there."""
    _, _, pd, _, _ = clip_pair
    d = tmp_path / "broken"
    shutil.copytree(pd, d)
    (d / "text.npz").write_bytes(b"not an npz archive")
    with pytest.raises(WeightError, match="text.npz"):
        Clip.from_local_dir(d, device="cpu")


# -- BiomedCLIP-class dirs: hf_config from text.onnx -----------------------------------

@pytest.fixture(scope="module")
def bert_pair(bert_onnx_dir, tmp_path_factory):  # noqa: F811
    d, wrapper = bert_onnx_dir
    pd, jd = copy_pair(d, tmp_path_factory.mktemp("bert_pair"))
    return (TextEmbedder.from_local_dir(pd, device="cpu"),
            JTextEmbedder.from_local_dir(jd), pd, jd, wrapper)


def test_hf_config_is_derived_from_text_onnx(bert_pair):
    """A BERT dir without ``text_cfg.hf_config``: the architecture comes
    from the graph (``derive_bert_hf_config``, equal to the JAX package's),
    is persisted, and the native BERT tower is converted and loaded."""
    port, jemb, pd, jd, _ = bert_pair
    assert port.spec.family == jemb.spec.family == "hf_bert"
    hf = json.loads((pd / "open_clip_config.json").read_text())["model_cfg"]["text_cfg"][
        "hf_config"]
    assert hf == jreader.derive_bert_hf_config(jd / "text.onnx")
    assert_same_files(pd, jd, names=("text.npz",))


def test_bert_dir_embeddings_match_jax_and_torch(bert_pair):
    port, jemb, _, _, wrapper = bert_pair
    got = port.embed_texts(TEXTS)
    assert_rows_close(got, jemb.embed_texts(TEXTS))
    ids, _ = port.tokenize(TEXTS)
    with torch.no_grad():
        want = wrapper(torch.from_numpy(np.asarray(ids, np.int64))).numpy()
    np.testing.assert_allclose((got * want).sum(-1), 1.0, atol=1e-5)


# -- defects of the reference not copied ------------------------------------------------

@pytest.fixture(scope="module")
def named_graph(tmp_path_factory):
    """A ViT export without constant folding: every initializer keeps its
    torch name, so both packages take the name-mapped route."""
    base = tmp_path_factory.mktemp("named")
    torch.manual_seed(4)
    vt = VisionTransformer(32, 8, 64, 2, 4, 256, 32, quick_gelu=True).eval()
    with torch.no_grad():
        for _, p in vt.named_parameters():
            if (p == p.flatten()[0]).all():
                p.add_(0.02 * torch.randn_like(p))
    path = base / "visual.onnx"
    torch.onnx.export(_NormalizedVisual(vt), torch.randn(2, 3, 32, 32), str(path),
                      input_names=["pixel_values"], output_names=["image_embeds"],
                      dynamic_axes={"pixel_values": {0: "batch"}}, opset_version=18,
                      do_constant_folding=False, dynamo=False)
    vision = {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8, "head_width": 16}
    cfg = {"embed_dim": 32, "quick_gelu": True, "vision_cfg": vision, "text_cfg": {}}
    from clip_embedder_tpu.config import ModelCfg as JModelCfg
    from clip_embedder_tpu.models import build as jbuild
    from clip_embedder_tpu_torch.config import ModelCfg
    from clip_embedder_tpu_torch.models import build

    assert onnx_reader.has_named_weights(onnx_reader.read_onnx(path))
    return (path, build.resolve_vision(ModelCfg.from_dict(cfg)),
            jbuild.resolve_vision(JModelCfg.from_dict(cfg)))


def _misreading(mapper, misread):
    def mapped(sd, **kw):
        tree = mapper(sd, **kw)
        misread(tree)
        return tree
    return mapped


def _reverse_proj(tree):
    tree["proj"]["w"] = np.ascontiguousarray(np.asarray(tree["proj"]["w"])[::-1])


def test_name_mapped_route_is_self_checked(named_graph, monkeypatch):
    """A name mapping that misreads one weight (the projection's rows
    reversed: every shape still valid). The JAX package returns the
    name-mapped tree before its self-check and accepts it; the port checks
    it against the graph executor and refuses it."""
    path, spec, jspec = named_graph
    clean = jreader.extract_tower_params(path, jspec, tower="visual")
    monkeypatch.setattr(jweights, "map_state_dict", _misreading(jweights.map_state_dict,
                                                                _reverse_proj))
    monkeypatch.setattr(tweights, "map_state_dict", _misreading(tweights.map_state_dict,
                                                                _reverse_proj))
    accepted = jreader.extract_tower_params(path, jspec, tower="visual")
    np.testing.assert_array_equal(accepted["proj"]["w"], clean["proj"]["w"][::-1])
    with pytest.raises(WeightError, match="self-check failed"):
        onnx_reader.extract_tower_params(path, spec, tower="visual")


def test_name_mapped_route_is_layout_checked(named_graph, monkeypatch):
    """A name mapping that drops a subtree: the JAX package returns the
    incomplete tree (its validator never runs on this route); the port's
    layout check refuses it before anything is accepted."""
    path, spec, jspec = named_graph

    def drop(tree):
        del tree["ln_post"]

    monkeypatch.setattr(jweights, "map_state_dict", _misreading(jweights.map_state_dict, drop))
    monkeypatch.setattr(tweights, "map_state_dict", _misreading(tweights.map_state_dict, drop))
    monkeypatch.setattr(onnx_reader, "_structural_extract",
                        lambda *a, **k: pytest.fail("structural route not expected"))
    monkeypatch.setattr(jreader, "_structural_extract",
                        lambda *a, **k: pytest.fail("structural route not expected"))
    assert "ln_post" not in jreader.extract_tower_params(path, jspec, tower="visual")
    with pytest.raises(WeightError, match="missing: ln_post"):
        tweights.validate_tower_pytree(
            tweights.map_state_dict(onnx_reader.read_onnx(path).initializers, tower="visual",
                                    family="vit"), spec, source=path)


def test_name_mapped_route_equals_jax_when_right(named_graph):
    path, spec, jspec = named_graph
    got = tweights._flatten(onnx_reader.extract_tower_params(path, spec, tower="visual"))
    ref = tweights._flatten(jreader.extract_tower_params(path, jspec, tower="visual"))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_convert_onnx_dir_takes_the_load_paths_derivations(tmp_path):
    """The root ``pull_weights.convert_onnx_dir`` skips the derivations
    ``from_local_dir`` takes, so a ConvNeXt dir whose config names a size
    the graph contradicts fails there while it loads through ``Clip``; the
    port's ``convert_onnx_dir`` (run here as ``python -m
    clip_embedder_tpu_torch.pull_weights --dir``) takes them and writes the
    files the JAX ``Clip`` writes."""
    import pull_weights as jpull
    from clip_embedder_tpu_torch.pull_weights import main

    src = convnext_onnx_dir.__wrapped__(_TmpFactory(tmp_path / "src"))[0]
    root, pd, jd = tmp_path / "root", tmp_path / "port", tmp_path / "jax"
    for d in (root, pd, jd):
        shutil.copytree(src, d)
    with pytest.raises(Exception, match="stem conv"):
        jpull.convert_onnx_dir(root)
    main(["--dir", str(pd), "--device", "cpu"])
    from clip_embedder_tpu import VisionEmbedder as JVisionEmbedder

    JVisionEmbedder.from_local_dir(jd)
    JTextEmbedder.from_local_dir(jd)
    assert_same_files(pd, jd)

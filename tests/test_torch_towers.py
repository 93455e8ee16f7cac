"""The torch port's towers on the JAX package's own parameters, on the CPU.

JAX ``vit.init`` / ``text_transformer.init`` make the weights; the port
takes them through ``weights.params_from_numpy`` (the same function that
serves ``.npz`` loading) and must give the JAX ``attn_impl="xla"`` outputs
at cosine > 1 - 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu import weights as jweights
from clip_embedder_tpu.models import build as jbuild
from clip_embedder_tpu.models import text_transformer as jtext
from clip_embedder_tpu.models import vit as jvit
from clip_embedder_tpu.models import zoo as jzoo
from clip_embedder_tpu_torch import weights as tweights
from clip_embedder_tpu_torch.config import ModelCfg
from clip_embedder_tpu_torch.errors import ConfigError, WeightError
from clip_embedder_tpu_torch.models import build as tbuild
from clip_embedder_tpu_torch.models import text_transformer as ttext
from clip_embedder_tpu_torch.models import vit as tvit
from clip_embedder_tpu_torch.models import zoo as tzoo

SIGLIP_VIT = jvit.ViTCfg(
    image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_hidden=128,
    embed_dim=64, activation="gelu_tanh", use_class_token=False, use_ln_pre=False,
    pool="map", use_proj=False, ln_eps=1e-6, pos_embed_cls=False)
CLIP_VIT = jvit.ViTCfg(
    image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_hidden=256,
    embed_dim=32, activation="quick_gelu")
TIMM_GAP_REG_LS = jvit.ViTCfg(
    image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_hidden=128,
    embed_dim=48, activation="gelu", use_class_token=False, use_ln_pre=False,
    pool="gap", proj_bias=True, use_layer_scale=True, ln_eps=1e-6,
    pos_embed_cls=False, norm_after_pool=True, reg_tokens=2)
SIGLIP_TEXT = jtext.TextCfgResolved(
    context_length=12, vocab_size=300, width=64, heads=4, layers=2, mlp_hidden=128,
    embed_dim=64, activation="gelu_tanh", causal=False, pool="last", proj_bias=True,
    ln_eps=1e-6)
CLIP_TEXT = jtext.TextCfgResolved(
    context_length=12, vocab_size=300, width=64, heads=4, layers=2, mlp_hidden=256,
    embed_dim=32, activation="quick_gelu", causal=True, pool="argmax")


def cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _port_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _jax_params(init, cfg, seed):
    return jax.tree.map(np.asarray, init(jax.random.key(seed), cfg))


@pytest.mark.parametrize("jcfg", [SIGLIP_VIT, CLIP_VIT, TIMM_GAP_REG_LS],
                         ids=["siglip", "clip", "gap_reg_layerscale"])
def test_vit_matches_jax(jcfg):
    params = _jax_params(jvit.init, jcfg, 0)
    pixels = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvit.apply(params, pixels, jcfg, attn_impl="xla"))
    tower = tvit.ViT(_port_cfg(tvit.ViTCfg, jcfg),
                     tweights.params_from_numpy(params, device="cpu", dtype=torch.float32))
    for impl in ("eager", "kernel"):  # kernel: the kernels' plain versions
        with torch.inference_mode():
            got = tower(torch.from_numpy(pixels), attn_impl=impl).numpy()
        assert got.shape == ref.shape
        assert cos_min(got, ref) > 1 - 1e-6, impl
        np.testing.assert_allclose(got, ref, atol=1e-5)


def test_zoo_so400m_is_the_jax_config():
    """``models/zoo.py``'s SO400M config, field by field."""
    got, want = tzoo.so400m_siglip2_384(), jzoo.so400m_siglip2_384()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.seq_len, got.head_dim) == (want.seq_len, want.head_dim) == (576, 72)


def test_vit_channels_first_patchify():
    params = _jax_params(jvit.init, CLIP_VIT, 2)
    pixels = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    ref = np.asarray(jvit.apply(params, pixels, CLIP_VIT, channels_first=True))
    tower = tvit.ViT(_port_cfg(tvit.ViTCfg, CLIP_VIT),
                     tweights.params_from_numpy(params, device="cpu", dtype=torch.float32))
    with torch.inference_mode():
        got = tower(torch.from_numpy(pixels), channels_first=True).numpy()
    assert cos_min(got, ref) > 1 - 1e-6


@pytest.mark.parametrize("jcfg", [SIGLIP_TEXT, CLIP_TEXT], ids=["siglip", "clip"])
def test_text_matches_jax(jcfg):
    params = _jax_params(jtext.init, jcfg, 4)
    ids = np.random.default_rng(5).integers(1, 300, (3, 12)).astype(np.int32)
    ref = np.asarray(jtext.apply(params, ids, jcfg, attn_impl="xla"))
    tower = ttext.TextTransformer(
        _port_cfg(ttext.TextCfgResolved, jcfg),
        tweights.params_from_numpy(params, device="cpu", dtype=torch.float32))
    for impl in ("eager", "kernel"):
        with torch.inference_mode():
            got = tower(torch.from_numpy(ids), attn_impl=impl).numpy()
        assert cos_min(got, ref) > 1 - 1e-6, impl
        np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("family,jinit,tinit,jcfg", [
    ("vit", jvit.init, tvit.init, SIGLIP_VIT),
    ("vit", jvit.init, tvit.init, TIMM_GAP_REG_LS),
    ("text_transformer", jtext.init, ttext.init, CLIP_TEXT)])
def test_init_layout_is_the_jax_layout(family, jinit, tinit, jcfg):
    """The port's init (on the meta device) has the JAX init's tree and
    shapes, so one npz serves both packages."""
    jshapes = {k: v.shape for k, v in jweights._flatten(
        _jax_params(jinit, jcfg, 0)).items()}
    pcfg = _port_cfg(tvit.ViTCfg if family == "vit" else ttext.TextCfgResolved, jcfg)
    tshapes = {k: tuple(v.shape) for k, v in tweights._flatten(
        tinit(pcfg, device="meta")).items()}
    assert tshapes == jshapes


def test_npz_roundtrip_and_jax_written_npz(tmp_path):
    params = _jax_params(jvit.init, SIGLIP_VIT, 6)
    jweights.save_pytree(tmp_path / "j.npz", params)
    loaded = tweights.load_pytree(tmp_path / "j.npz", device="cpu", dtype=torch.bfloat16)
    spec = tbuild.TowerSpec("vit", _port_cfg(tvit.ViTCfg, SIGLIP_VIT))
    tweights.validate_tower_pytree(loaded, spec, source="j.npz")
    assert loaded["blocks"]["attn"]["q"]["w"].dtype == torch.bfloat16
    tweights.save_pytree(tmp_path / "t.npz", loaded)
    again = tweights.load_pytree(tmp_path / "t.npz", device="cpu", dtype=torch.bfloat16)
    for k, v in tweights._flatten(loaded).items():
        assert torch.equal(v, tweights._flatten(again)[k]), k


def test_w_scale_stays_f32():
    tree = {"fc": {"w_q": np.ones((4, 4), np.int8), "w_scale": np.ones(4, np.float32),
                   "b": np.zeros(4, np.float32)}}
    out = tweights.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert out["fc"]["w_q"].dtype == torch.int8
    assert out["fc"]["w_scale"].dtype == torch.float32
    assert out["fc"]["b"].dtype == torch.bfloat16


def test_validate_tower_pytree_rejects_bad_trees():
    cfg = _port_cfg(tvit.ViTCfg, CLIP_VIT)
    spec = tbuild.TowerSpec("vit", cfg)
    good = tvit.init(cfg, device="meta")
    del good["patch_embed"]["b"]  # a missing bias beside its weight is fine
    tweights.validate_tower_pytree(good, spec, source="mem")
    bad = tvit.init(cfg, device="meta")
    del bad["ln_post"]
    bad["proj"]["w"] = torch.empty(64, 31, device="meta")
    bad["extra"] = torch.empty(3, device="meta")
    with pytest.raises(WeightError, match="missing: ln_post") as err:
        tweights.validate_tower_pytree(bad, spec, source="mem")
    assert "unexpected: extra" in str(err.value)
    assert "proj/w (64, 31) != (64, 32)" in str(err.value)


def test_load_pytree_typed_error_on_garbage(tmp_path):
    bad = tmp_path / "visual.npz"
    bad.write_bytes(b"not a zip")
    with pytest.raises(WeightError, match="Failed to read"):
        tweights.load_pytree(bad, device="cpu", dtype=torch.float32)


def _model_cfg(vision=None, text=None):
    return ModelCfg.from_dict({"embed_dim": 32, "vision_cfg": vision or {},
                               "text_cfg": text or {}})


@pytest.mark.parametrize("vision", [
    {"timm_model_name": "vit_so400m_patch16_siglip_384", "timm_proj": "none"},
    {"timm_model_name": "vit_base_patch16_siglip_gap_256"},
    {"timm_model_name": "vit_so150m_patch16_reg4_map_256"},
    {"timm_model_name": "vit_large_patch14_clip_224", "timm_pool": "avg"},
    {"layers": 12, "width": 768, "patch_size": 16, "head_width": 64},
    {"timm_model_name": "vit_pe_core_large_patch14_336", "image_size": 336},
    {"timm_model_name": "vit_pe_core_bigG_patch14_448", "image_size": 448,
     "timm_proj": "linear"},
    # BiomedCLIP's vision tower (timm vit_base_patch16_224)
    {"timm_model_name": "vit_base_patch16_224", "image_size": 224},
    # coca_ViT-B-32 and coca_ViT-L-14 (open_clip model_configs): the legacy
    # boolean attentional pooler
    {"image_size": 224, "layers": 12, "width": 768, "patch_size": 32,
     "attentional_pool": True, "attn_pooler_heads": 8, "output_tokens": True},
    {"image_size": 224, "layers": 24, "width": 1024, "patch_size": 14,
     "attentional_pool": True, "attn_pooler_heads": 8, "output_tokens": True},
])
def test_resolve_vision_matches_jax(vision):
    got = tbuild.resolve_vision(_model_cfg(vision=vision))
    from clip_embedder_tpu.config import ModelCfg as JModelCfg

    ref = jbuild.resolve_vision(JModelCfg.from_dict(
        {"embed_dim": 32, "vision_cfg": vision, "text_cfg": {}}))
    assert got.family == ref.family
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)


@pytest.mark.parametrize("text", [
    {"width": 1152, "heads": 16, "layers": 27, "vocab_size": 256000, "context_length": 64,
     "mlp_ratio": 3.7362, "no_causal_mask": True, "proj_bias": True, "pool_type": "last",
     "norm_kwargs": {"eps": 1e-6}, "act_kwargs": {"approximate": "tanh"}},
    {"width": 512, "heads": 8, "layers": 12},
    # coca_ViT-B-32's text tower (open_clip model_configs): embed_cls
    {"context_length": 76, "vocab_size": 49408, "width": 512, "heads": 8, "layers": 12,
     "embed_cls": True, "output_tokens": True},
    # BiomedCLIP's BERT text tower, its hf_config as conversion writes it
    {"context_length": 256, "hf_model_name": "microsoft/BiomedNLP-BiomedBERT-base-uncased-abstract",
     "proj": "mlp", "pooler_type": "cls_last_hidden_state_pooler",
     "hf_config": {"model_type": "bert", "vocab_size": 30522, "hidden_size": 768,
                   "num_hidden_layers": 12, "num_attention_heads": 12,
                   "intermediate_size": 3072, "max_position_embeddings": 512,
                   "type_vocab_size": 2, "pad_token_id": 0, "layer_norm_eps": 1e-12}},
    # an XLM-RoBERTa tower: pad-id positions, the mean pooler, the default proj
    {"context_length": 32, "hf_model_name": "xlm-roberta-base", "hf_pooler_type": "mean_pooler",
     "hf_config": {"model_type": "xlm-roberta", "vocab_size": 250002, "hidden_size": 768,
                   "num_hidden_layers": 12, "num_attention_heads": 12,
                   "intermediate_size": 3072, "max_position_embeddings": 514}},
])
def test_resolve_text_matches_jax(text):
    from clip_embedder_tpu.config import ModelCfg as JModelCfg

    got = tbuild.resolve_text(_model_cfg(text=text))
    ref = jbuild.resolve_text(JModelCfg.from_dict(
        {"embed_dim": 32, "vision_cfg": {}, "text_cfg": text}))
    assert got.family == ref.family
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)
    if "mlp_ratio" in text:
        assert got.cfg.mlp_hidden == 4304


@pytest.mark.parametrize("vision", [
    {"timm_model_name": "eva02_base_patch16_clip_224"},
    {"timm_model_name": "fastvit_mci2"},
    {"timm_model_name": "convnext_base"},
    {"timm_model_name": "vit_base_patch16_224", "timm_proj": "mlp"},
    {"layers": [3, 4, 6, 3], "width": 64},
])
def test_vision_families_resolve_as_jax(vision):
    """EVA02, FastViT, ConvNeXt, the timm_proj="mlp" ViT head and
    ModifiedResNet resolve to the JAX package's family and config."""
    from clip_embedder_tpu.config import ModelCfg as JModelCfg

    got = tbuild.resolve_vision(_model_cfg(vision=vision))
    ref = jbuild.resolve_vision(JModelCfg.from_dict(
        {"embed_dim": 32, "vision_cfg": vision, "text_cfg": {}}))
    assert got.family == ref.family
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)


@pytest.mark.parametrize("form", ["parallel", "cascade"])
def test_string_attentional_pool_forms_raise(form):
    """CoCa's string pooler forms (WIP upstream, no released checkpoints)
    are refused, as in the JAX package."""
    vision = {"layers": 12, "width": 768, "patch_size": 16, "attentional_pool": form}
    with pytest.raises(ConfigError, match=f"attentional_pool='{form}'"):
        tbuild.resolve_vision(_model_cfg(vision=vision))


def test_hf_text_without_hf_config_raises():
    """An hf_model_name config without text_cfg.hf_config: the same
    ConfigError as the JAX package's (a dir with a text.onnx gets the
    config derived from the graph first: tests/test_torch_onnx_dirs.py)."""
    from clip_embedder_tpu.config import ModelCfg as JModelCfg

    text = {"hf_model_name": "microsoft/BiomedNLP"}
    with pytest.raises(ConfigError, match="hf_config") as got:
        tbuild.resolve_text(_model_cfg(text=text))
    with pytest.raises(Exception) as ref:
        jbuild.resolve_text(JModelCfg.from_dict({"embed_dim": 32, "vision_cfg": {},
                                                 "text_cfg": text}))
    assert str(got.value) == str(ref.value)


def test_unported_tower_options_raise():
    """rope_2d, pool="attn" and embed_cls (ported) build their trees, and the
    timm_proj="mlp" head (ported) computes what the JAX ViT computes."""
    rope = dataclasses.replace(_port_cfg(tvit.ViTCfg, CLIP_VIT), rope_2d=True)
    assert tvit.init(rope, device="meta")["blocks"]["attn"]["q"]["w"].shape == (2, 64, 64)
    attn = dataclasses.replace(_port_cfg(tvit.ViTCfg, CLIP_VIT), pool="attn",
                               attn_pool_queries=8, attn_pool_dim=32, pool_heads=4)
    assert tvit.init(attn, device="meta")["attn_pool"]["attn"]["k"]["w"].shape == (64, 32)
    cls_text = dataclasses.replace(_port_cfg(ttext.TextCfgResolved, CLIP_TEXT),
                                   embed_cls=True)
    tree = ttext.init(cls_text, device="meta")
    assert tree["cls_emb"].shape == (1, 1, 64) and tree["pos_embed"].shape == (13, 64)
    params = _jax_params(jvit.init, CLIP_VIT, 3)
    rng = np.random.default_rng(3)
    params["proj"] = {"fc": {"w": rng.standard_normal((64, 80)).astype(np.float32) * 0.1,
                             "b": rng.standard_normal(80).astype(np.float32)},
                      "out": {"w": rng.standard_normal((80, 32)).astype(np.float32) * 0.1,
                              "b": rng.standard_normal(32).astype(np.float32)}}
    pixels = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvit.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(pixels),
                                CLIP_VIT))
    tree = tweights.params_from_numpy(params, device="cpu", dtype=torch.float32)
    tower = tvit.ViT(_port_cfg(tvit.ViTCfg, CLIP_VIT), tree)
    with torch.inference_mode():
        got = tower(torch.from_numpy(pixels)).numpy()
    assert cos_min(got, ref) > 1 - 1e-6
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the port's validator takes the mlp head; the JAX one refuses it
    tweights.validate_tower_pytree(
        tree, tbuild.TowerSpec("vit", _port_cfg(tvit.ViTCfg, CLIP_VIT)), source="mem")
    with pytest.raises(Exception, match="unexpected: proj/fc/b"):
        jweights.validate_tower_pytree(params, jbuild.TowerSpec("vit", CLIP_VIT), source="mem")

"""Checkpoint conversion in the torch port (``weights.map_state_dict`` and
its mappers, ``pull_weights``' offline half, ``vision.derive_vision_dims_from_sd``)
against the JAX package's, on the CPU.

State dicts come from ``tests/torch_ref.py`` (open_clip / timm / Meta PE
naming) and a BertModel-named dict at small sizes. The port's mapped trees
must equal the JAX mappers' array for array; a whole checkpoint converted
by both converters must give equal ``.npz`` files, and the two packages'
``Clip`` over them must agree at tests/test_golden.py's tolerances.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_embedder_tpu import Clip as JaxClip
from clip_embedder_tpu import weights as jweights
from clip_embedder_tpu_torch import Clip, pull_weights
from clip_embedder_tpu_torch import weights as tweights
from clip_embedder_tpu_torch.errors import WeightError

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import pull_weights as jpull  # noqa: E402
from torch_ref import (CoCaTextTower, CoCaVisionTower, PECoreViT,  # noqa: E402
                       TextTransformer, TimmSiglipViT, VisionTransformer)

FIXTURES = Path(__file__).parent / "fixtures"


def numpy_sd(module, prefix=""):
    return {f"{prefix}{k}": v.detach().numpy() for k, v in module.state_dict().items()}


def assert_same_tree(got, ref):
    got, ref = tweights._flatten(got), jweights._flatten(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def _bert_sd():
    """An open_clip HFTextEncoder dict: a BertModel's state dict (with its
    pooler) under ``text.transformer.``, and an mlp ``text.proj``. The keys
    are transformers' BertModel's, written out (importing transformers
    alone takes longer than this whole file)."""
    rng = np.random.default_rng(7)
    width, hidden, vocab, positions = 64, 128, 120, 32

    def lin(name, n_out, n_in):
        return {f"{name}.weight": rng.standard_normal((n_out, n_in)),
                f"{name}.bias": rng.standard_normal(n_out)}

    def ln(name):
        return {f"{name}.weight": rng.standard_normal(width),
                f"{name}.bias": rng.standard_normal(width)}

    sd = {"embeddings.word_embeddings.weight": rng.standard_normal((vocab, width)),
          "embeddings.position_embeddings.weight": rng.standard_normal((positions, width)),
          "embeddings.token_type_embeddings.weight": rng.standard_normal((2, width)),
          **ln("embeddings.LayerNorm"), **lin("pooler.dense", width, width)}
    for i in range(2):
        p = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            sd.update(lin(f"{p}.attention.self.{name}", width, width))
        sd.update({**lin(f"{p}.attention.output.dense", width, width),
                   **ln(f"{p}.attention.output.LayerNorm"),
                   **lin(f"{p}.intermediate.dense", hidden, width),
                   **lin(f"{p}.output.dense", width, hidden), **ln(f"{p}.output.LayerNorm")})
    sd = {f"text.transformer.{k}": v for k, v in sd.items()}
    sd.update({**lin("text.proj.0", 48, width), "text.proj.2.weight": rng.standard_normal(
        (32, 48))})
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def _fastvit(embed_dim=48):
    """timm-named reparameterized FastViT (tests/torch_ref_fastvit.py), its
    BatchNorms' running statistics drawn so that the folds count."""
    from torch_ref_fastvit import TorchFastViT

    tm = TorchFastViT((1, 2, 1, 1), (16, 32, 64, 128), (3, 3, 3, 3),
                      ("repmixer",) * 3 + ("attention",), (False, False, False, True),
                      embed_dim=embed_dim)
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    return tm


def _resnet():
    from test_resnet import ModifiedResNet

    tm = ModifiedResNet(layers=(1, 2, 1, 1), output_dim=24, heads=8, image_size=64, width=16)
    for m in tm.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(0.5, 2.0)
    return tm


def _convnext():
    from test_convnext import TorchConvNeXt

    return TorchConvNeXt((1, 1, 2, 1), (16, 32, 64, 128), embed_dim=48)


def _mlp_head(sd, width, embed_dim, seed):
    """open_clip TimmModel's ``timm_proj="mlp"`` head as it names it:
    ``visual.head.mlp.fc1``/``fc2``, a timm Mlp of hidden 2·embed_dim."""
    rng = np.random.default_rng(seed)
    for name, shape in (("fc1", (2 * embed_dim, width)), ("fc2", (embed_dim, 2 * embed_dim))):
        sd[f"visual.head.mlp.{name}.weight"] = rng.standard_normal(shape).astype(np.float32)
        sd[f"visual.head.mlp.{name}.bias"] = rng.standard_normal(shape[0]).astype(np.float32)
    return sd


def jax_head_names(sd):
    """The mlp head's keys as the JAX package's mappers read them
    (``head.fc1``/``head.fc2``; open_clip writes ``head.mlp.fc1``/``fc2``)."""
    return {k.replace("head.mlp.", "head."): v for k, v in sd.items()}


def _convnext_head_norm_first_mlp():
    """A head_norm_first ConvNeXt (``norm_pre``), no layer scale, and
    open_clip's mlp head."""
    sd = numpy_sd(_convnext(), "visual.trunk.")
    for k in [k for k in sd if k.endswith(".gamma")]:
        del sd[k]
    for leaf in ("weight", "bias"):
        sd[f"visual.trunk.norm_pre.{leaf}"] = sd.pop(f"visual.trunk.head.norm.{leaf}")
    del sd["visual.trunk.head.proj.weight"], sd["visual.trunk.head.proj.bias"]
    return _mlp_head(sd, 128, 48, seed=3)


def _eva02(dim=64, heads=4):
    from test_eva02 import TorchEva02

    return TorchEva02(32, 8, dim, 2, heads, 96, 48)


def _eva02_sd(module):
    return {k: v for k, v in numpy_sd(module, "visual.trunk.").items()
            if not k.endswith((".sin", ".cos"))}


# (tower, family, state dict) by case; every module is built from seed 0
STATE_DICTS = {
    "fastvit": ("visual", "fastvit", lambda: numpy_sd(_fastvit(), "visual.trunk.")),
    "resnet": ("visual", "resnet", lambda: numpy_sd(_resnet(), "visual.")),
    "convnext": ("visual", "convnext", lambda: numpy_sd(_convnext(), "visual.trunk.")),
    "convnext_head_norm_first_mlp": ("visual", "convnext", _convnext_head_norm_first_mlp),
    "eva02": ("visual", "eva02", lambda: _eva02_sd(_eva02())),
    "timm_siglip_map": ("visual", "vit", lambda: numpy_sd(
        TimmSiglipViT(32, 8, 64, 2, 4, 128), "visual.trunk.")),
    "timm_siglip_mlp_head": ("visual", "vit", lambda: _mlp_head(numpy_sd(
        TimmSiglipViT(32, 8, 64, 2, 4, 128), "visual.trunk."), 64, 48, seed=4)),
    "clip_visual": ("visual", "vit", lambda: numpy_sd(
        VisionTransformer(32, 8, 64, 2, 4, 256, 48), "visual.")),
    "pe_core": ("visual", "vit", lambda: numpy_sd(PECoreViT(32, 8, 64, 2, 4, 128, 48))),
    "pe_core_layer_scale": ("visual", "vit", lambda: numpy_sd(
        PECoreViT(32, 8, 64, 2, 4, 128, 48, layer_scale=True), "visual.")),
    "coca_visual": ("visual", "vit", lambda: numpy_sd(
        CoCaVisionTower(32, 8, 64, 2, 4, 256, 48), "visual.")),
    "clip_text": ("text", "text_transformer", lambda: numpy_sd(
        TextTransformer(12, 512, 64, 4, 2, 256, 32))),
    "siglip_text": ("text", "text_transformer", lambda: numpy_sd(
        TextTransformer(12, 512, 64, 4, 2, 256, 64, causal=False, pool="last",
                        proj_bias=True), "text.")),
    "coca_text": ("text", "text_transformer", lambda: numpy_sd(
        CoCaTextTower(12, 64, 64, 4, 2, 256, 48))),
    "hf_bert": ("text", "hf_bert", _bert_sd),
}


@pytest.mark.parametrize("case", sorted(STATE_DICTS))
def test_map_state_dict_matches_jax(case):
    """The port's mapper against the JAX one, leaf for leaf. An mlp head is
    handed to the JAX mapper under the names it reads (``jax_head_names``):
    the port reads open_clip's own."""
    tower, family, make = STATE_DICTS[case]
    torch.manual_seed(0)
    sd = make()
    ref = jweights.map_state_dict(jax_head_names(sd), tower=tower, family=family)
    assert_same_tree(tweights.map_state_dict(sd, tower=tower, family=family), ref)
    # torch tensors in (a state dict straight from a module) map the same
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert_same_tree(tweights.map_state_dict(tensors, tower=tower, family=family), ref)


@pytest.mark.parametrize("case,family,proj", [
    ("convnext_head_norm_first_mlp", "convnext", ("fc1", "fc2")),
    ("timm_siglip_mlp_head", "vit", ("fc", "out"))])
def test_mlp_head_maps_open_clip_names(case, family, proj):
    """open_clip's ``head.mlp.fc1``/``fc2`` reach the port's tree, hidden
    2·embed_dim; the JAX mappers read ``head.fc1`` only and drop them."""
    torch.manual_seed(0)
    sd = STATE_DICTS[case][2]()
    got = tweights.map_state_dict(sd, tower="visual", family=family)["proj"]
    np.testing.assert_array_equal(got[proj[0]]["w"], sd["visual.head.mlp.fc1.weight"].T)
    np.testing.assert_array_equal(got[proj[1]]["b"], sd["visual.head.mlp.fc2.bias"])
    assert got[proj[0]]["w"].shape[1] == 2 * 48
    assert "proj" not in jweights.map_state_dict(sd, tower="visual", family=family)


def test_fastvit_attention_norm_without_running_stats_is_refused():
    """A FastViT attention block's norm is a BatchNorm: one without running
    statistics is refused, where the JAX mapper takes it as a plain affine."""
    torch.manual_seed(0)
    sd = numpy_sd(_fastvit(), "visual.trunk.")
    key = next(k for k in sd if k.endswith(".norm.running_mean"))
    del sd[key], sd[key.replace("running_mean", "running_var")]
    jweights.map_state_dict(sd, tower="visual", family="fastvit")
    with pytest.raises(WeightError, match="running statistics"):
        tweights.map_state_dict(sd, tower="visual", family="fastvit")


@pytest.mark.parametrize("prefix", ["", "visual."])
@pytest.mark.parametrize("layer_scale", [False, True])
def test_derive_pe_cfg_from_sd_matches_jax(prefix, layer_scale):
    torch.manual_seed(0)
    sd = numpy_sd(PECoreViT(32, 8, 64, 3, 4, 160, 48, pool_mlp_hidden=96,
                            layer_scale=layer_scale), prefix)
    got = tweights.derive_pe_cfg_from_sd(sd)
    assert got == jweights.derive_pe_cfg_from_sd(sd)
    assert got["layers"] == 3 and got["mlp_hidden"] == 160 and got["pool_mlp_hidden"] == 96
    torch.manual_seed(0)
    with pytest.raises(WeightError, match="patch conv"):
        tweights.derive_pe_cfg_from_sd(numpy_sd(TimmSiglipViT(32, 8, 64, 2, 4, 128),
                                                "visual.trunk."))


def test_fold_bn_affine_matches_jax():
    rng = np.random.default_rng(0)
    g, b, m = (rng.standard_normal(16) for _ in range(3))
    v = rng.uniform(0.1, 2.0, 16)
    for got, ref in zip(tweights.fold_bn_affine(g, b, m, v, eps=1e-3),
                        jweights.fold_bn_affine(g, b, m, v, eps=1e-3)):
        np.testing.assert_array_equal(got, ref)


def test_unknown_families_raise_weight_error():
    with pytest.raises(WeightError, match="Unknown visual family"):
        tweights.map_state_dict({}, tower="visual", family="nope")
    with pytest.raises(WeightError, match="Unknown text family"):
        tweights.map_state_dict({}, tower="text", family="eva02")


def test_eva02_trunk_head_is_the_projection():
    """open_clip builds an EVA02 trunk with ``num_classes=embed_dim`` where
    its config leaves ``timm_proj`` unset, as its EVA02 configs do: the
    projection is the trunk's ``head``. The port maps it to ``proj`` and the
    tree validates; the JAX mapper reads ``head.proj`` alone, so its tree
    lacks ``proj`` and its validator refuses it (a defect not copied)."""
    from clip_embedder_tpu.models import eva02 as jeva02
    from clip_embedder_tpu.models.build import TowerSpec as JTowerSpec

    from clip_embedder_tpu_torch.models import eva02
    from clip_embedder_tpu_torch.models.build import TowerSpec

    torch.manual_seed(0)
    sd = _eva02_sd(_eva02())
    for leaf in ("weight", "bias"):
        sd[f"visual.trunk.head.{leaf}"] = sd.pop(f"visual.trunk.head.proj.{leaf}")
    got = tweights.map_state_dict(sd, tower="visual", family="eva02")
    np.testing.assert_array_equal(got["proj"]["w"], sd["visual.trunk.head.weight"].T)
    np.testing.assert_array_equal(got["proj"]["b"], sd["visual.trunk.head.bias"])
    cfg = jeva02.Eva02Cfg(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                          mlp_hidden=96, embed_dim=48)
    tweights.validate_tower_pytree(got, TowerSpec("eva02", eva02.Eva02Cfg(
        **cfg.__dict__)), source="mem")
    ref = jweights.map_state_dict(sd, tower="visual", family="eva02")
    assert "proj" not in ref
    with pytest.raises(Exception, match="missing: proj/b, proj/w"):
        jweights.validate_tower_pytree(ref, JTowerSpec("eva02", cfg), source="mem")


@pytest.mark.parametrize("repo_id", ["laion/CLIP-ViT-B-32-laion2B-s34B-b79K",
                                     "timm/ViT-SO400M-14-SigLIP",
                                     "timm/ViT-SO400M-16-SigLIP2-384"])
@pytest.mark.parametrize("init_logit_bias", [False, True])
def test_derive_model_config_matches_jax(repo_id, init_logit_bias):
    torch.manual_seed(0)
    sd = numpy_sd(TextTransformer(12, 512, 64, 4, 2, 256, 32))
    sd["logit_scale"] = np.asarray(np.log(100.0), np.float32)
    if "SigLIP" in repo_id:
        sd["logit_bias"] = np.asarray(-12.9, np.float32)
    occ = {"model_cfg": {"text_cfg": {"vocab_size": 7}}}
    if init_logit_bias:
        occ["model_cfg"]["init_logit_bias"] = -10
    got = pull_weights.derive_model_config(repo_id, occ, sd)
    assert got == jpull.derive_model_config(repo_id, occ, sd)
    assert got["vocab_size"] == 512
    del sd["token_embedding.weight"]
    assert pull_weights.derive_model_config(repo_id, occ, sd)["vocab_size"] == 7
    assert pull_weights.CONFIG_FILES == jpull.CONFIG_FILES
    assert pull_weights.CHECKPOINT_CANDIDATES == jpull.CHECKPOINT_CANDIDATES


# -- the slice as a whole: checkpoint → convert → model dir → Clip ----------

SIGLIP_OCC = json.loads((FIXTURES / "golden_siglip" / "open_clip_config.json").read_text())
CLIP_OCC = {
    "model_cfg": {"embed_dim": 32, "quick_gelu": True,
                  "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8,
                                 "head_width": 16},
                  "text_cfg": {"context_length": 12, "vocab_size": 512, "width": 64,
                               "heads": 4, "layers": 2}},
    "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.3, 0.3, 0.3]},
}
# PE-Core with no pe_cfg: the conversion derives the dims from the
# checkpoint ("large" gives only the 16 heads, which no shape fixes)
PE_OCC = {
    "model_cfg": {"embed_dim": 48,
                  "vision_cfg": {"image_size": 32,
                                 "timm_model_name": "vit_pe_core_large_patch14_32",
                                 "timm_proj": "linear"},
                  "text_cfg": {"context_length": 12, "vocab_size": 512, "width": 64,
                               "heads": 4, "layers": 2}},
    "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.3, 0.3, 0.3]},
}


# MobileCLIP2-S4's and EVA02-B's names with no dims in the config: the
# conversion derives them from the checkpoint (EVA02-B's 12 heads, which no
# shape fixes, from the size table: 96 = 12 x 8)
FASTVIT_OCC = {
    "model_cfg": {"embed_dim": 48,
                  "vision_cfg": {"image_size": 64, "timm_model_name": "fastvit_mci4",
                                 "timm_proj": "none"},
                  "text_cfg": {"context_length": 12, "vocab_size": 512, "width": 64,
                               "heads": 4, "layers": 2}},
    "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.3, 0.3, 0.3]},
}
EVA02_OCC = {
    "model_cfg": {"embed_dim": 48,
                  "vision_cfg": {"image_size": 32,
                                 "timm_model_name": "eva02_base_patch8_clip_32",
                                 "timm_proj": "linear"},
                  "text_cfg": {"context_length": 12, "vocab_size": 512, "width": 64,
                               "heads": 4, "layers": 2}},
    "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.3, 0.3, 0.3]},
}


def _checkpoint(kind):
    """(repo id, open_clip config, whole-model state dict) of a small model."""
    torch.manual_seed(0)
    if kind in ("fastvit", "eva02"):
        vision = (numpy_sd(_fastvit(), "visual.trunk.") if kind == "fastvit"
                  else _eva02_sd(_eva02(dim=96, heads=12)))
        sd = {**vision, **numpy_sd(TextTransformer(12, 512, 64, 4, 2, 256, 48))}
        sd["logit_scale"] = np.asarray(np.log(10.0), np.float32)
        if kind == "fastvit":
            return "timm/MobileCLIP2-S4-OpenCLIP", FASTVIT_OCC, sd
        return "timm/eva02_base_patch8_clip_32", EVA02_OCC, sd
    if kind == "siglip2":
        sd = numpy_sd(TimmSiglipViT(64, 16, 64, 2, 4, 128), "visual.trunk.")
        sd.update(numpy_sd(TextTransformer(12, 512, 64, 4, 2, 256, 64, causal=False,
                                           pool="last", proj_bias=True), "text."))
        sd["logit_bias"] = np.asarray(-10.0, np.float32)
        repo, occ = "timm/ViT-B-16-SigLIP2", SIGLIP_OCC
    elif kind == "clip":
        sd = numpy_sd(VisionTransformer(32, 8, 64, 2, 4, 256, 32, quick_gelu=True), "visual.")
        sd.update(numpy_sd(TextTransformer(12, 512, 64, 4, 2, 256, 32, quick_gelu=True)))
        repo, occ = "some/CLIP-model", CLIP_OCC
    else:
        sd = numpy_sd(PECoreViT(32, 8, 128, 2, 16, 256, 48), "visual.")
        sd.update(numpy_sd(TextTransformer(12, 512, 64, 4, 2, 256, 48)))
        repo, occ = "timm/PE-Core-L-14-336", PE_OCC
    sd["logit_scale"] = np.asarray(np.log(10.0), np.float32)
    return repo, occ, sd


def _model_dir(path, occ):
    path.mkdir()
    (path / "open_clip_config.json").write_text(json.dumps(occ))
    (path / "tokenizer.json").write_bytes(
        (FIXTURES / "golden_siglip" / "tokenizer.json").read_bytes())
    return path


def cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("kind", ["siglip2", "clip", "pe_core", "fastvit", "eva02"])
def test_converted_dir_matches_jax(tmp_path, kind):
    """The same checkpoint through the JAX converter into dir A and the
    port's into dir B (``torch.save`` → ``load_checkpoint``, as from a
    downloaded ``.bin``): equal configs and npz files; the JAX ``Clip`` on A
    and the port's on B agree on images, texts and classify."""
    repo, occ, sd = _checkpoint(kind)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "ckpt.bin")
    loaded = pull_weights.load_checkpoint(tmp_path / "ckpt.bin")
    assert sorted(loaded) == sorted(sd)
    dirs = {}
    for name, conv, state in (("A", jpull, sd), ("B", pull_weights, loaded)):
        d = dirs[name] = _model_dir(tmp_path / name, occ)
        (d / "model_config.json").write_text(json.dumps(
            conv.derive_model_config(repo, occ, state), indent=2))
        conv.convert_checkpoint(d, state)
    a, b = dirs["A"], dirs["B"]
    for f in ("open_clip_config.json", "model_config.json"):
        assert json.loads((a / f).read_text()) == json.loads((b / f).read_text()), f
    vcfg = json.loads((b / "open_clip_config.json").read_text())["model_cfg"]["vision_cfg"]
    if kind == "pe_core":
        assert vcfg["pe_cfg"]["width"] == 128
    if kind == "fastvit":  # the checkpoint's dims, not MCi4's table row
        assert vcfg["fastvit_cfg"]["dims"] == [16, 32, 64, 128]
        assert vcfg["fastvit_cfg"]["depths"] == [1, 2, 1, 1]
    if kind == "eva02":
        assert vcfg["eva02_cfg"] == {"width": 96, "layers": 2, "mlp_hidden": 96}
    for f in ("visual.npz", "text.npz"):
        with np.load(a / f) as za, np.load(b / f) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(zb[k], za[k], err_msg=f"{f}:{k}")

    jclip = JaxClip.from_local_dir(a)
    clip = Clip.from_local_dir(b, device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (40, 50, 3), dtype=np.uint8),
              rng.integers(0, 255, (64, 33, 3), dtype=np.uint8)]
    texts = ["a photo of a cat", "the dog!", ""]
    for got, ref in ((clip.vision.embed_images(images), jclip.vision.embed_images(images)),
                     (clip.text.embed_texts(texts), jclip.text.embed_texts(texts))):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert cosines(got, ref).min() > 1 - 1e-6
        np.testing.assert_allclose(got, ref, atol=5e-4)
    labels = ["a cat", "a dog", "a beignet"]
    got, ref = clip.classify(images[0], labels), jclip.classify(images[0], labels)
    assert [lbl for lbl, _ in got] == [lbl for lbl, _ in ref]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref], atol=1e-4)


def test_converted_vision_tower_computes_the_source_model(tmp_path):
    """The port's tower on converted weights against the torch module the
    checkpoint came from (timm SigLIP, map pool, gelu tanh on both sides)."""
    from clip_embedder_tpu_torch.config import OpenClipConfig
    from clip_embedder_tpu_torch.models.build import resolve_vision
    from clip_embedder_tpu_torch.models.vit import ViT

    torch.manual_seed(0)
    ref_model = TimmSiglipViT(64, 16, 64, 2, 4, 128).eval()
    d = _model_dir(tmp_path / "m", SIGLIP_OCC)
    sd = numpy_sd(ref_model, "visual.trunk.")
    sd.update(numpy_sd(TextTransformer(12, 512, 64, 4, 2, 256, 64, causal=False,
                                       pool="last", proj_bias=True)))
    pull_weights.convert_checkpoint(d, sd)
    spec = resolve_vision(OpenClipConfig.from_file(d / "open_clip_config.json").model_cfg)
    tower = ViT(spec.cfg, tweights.load_pytree(d / "visual.npz", device="cpu",
                                               dtype=torch.float32))
    x = torch.randn(3, 3, 64, 64)
    with torch.inference_mode():
        got = tower(x, attn_impl="kernel", channels_first=True).numpy()
        ref = ref_model(x).numpy()
    assert cosines(got, ref).min() > 1 - 1e-6
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_checkpoint_with_the_wrong_config_fails_at_conversion(tmp_path):
    """A three-layer checkpoint against a two-layer config: WeightError
    naming the paths, and no npz written."""
    torch.manual_seed(0)
    sd = numpy_sd(TimmSiglipViT(64, 16, 64, 3, 4, 128), "visual.trunk.")
    sd.update(numpy_sd(TextTransformer(12, 512, 64, 4, 2, 256, 64, causal=False,
                                       pool="last", proj_bias=True), "text."))
    d = _model_dir(tmp_path / "m", SIGLIP_OCC)
    with pytest.raises(WeightError, match="does not match the 'vit' tower layout"):
        pull_weights.convert_checkpoint(d, sd)
    assert not (d / "visual.npz").exists() and not (d / "text.npz").exists()


def test_write_model_readme(tmp_path):
    """The usage header names the port; an upstream card keeps its
    frontmatter (minus library_name) and body; a rerun adds nothing."""
    import ast
    import re

    pull_weights.write_model_readme(tmp_path, "someorg/Some-Model")
    text = (tmp_path / "README.md").read_text()
    assert "Some-Model" in text and "from clip_embedder_tpu_torch import Clip" in text
    ast.parse(re.search(r"```python\n(.*?)```", text, flags=re.S).group(1))

    (tmp_path / "README.md").write_text(
        "---\nlicense: apache-2.0\nlibrary_name: open_clip\ntags:\n- clip\n"
        "---\n\n# Upstream card\n\nOriginal model description.\n")
    pull_weights.write_model_readme(tmp_path, "someorg/Some-Model")
    once = (tmp_path / "README.md").read_text()
    assert once.startswith("---\nlicense: apache-2.0\ntags:\n- clip\n---\n")
    assert "Original model description." in once and "library_name" not in once
    assert once.index("clip_embedder_tpu model dir") < once.index("# Upstream card")
    pull_weights.write_model_readme(tmp_path, "someorg/Some-Model")
    assert (tmp_path / "README.md").read_text() == once

    (tmp_path / "README.md").write_text("# Plain card\n\nBody text.\n")
    pull_weights.write_model_readme(tmp_path, "someorg/Other")
    text = (tmp_path / "README.md").read_text()
    assert text.index("clip_embedder_tpu model dir") < text.index("Body text.")

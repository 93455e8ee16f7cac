"""The torch port's other vision families (EVA02, FastViT, ConvNeXt,
ModifiedResNet) against the JAX package, on the CPU.

* each tower on the JAX package's own parameters (its ``init``, with every
  1-D leaf — biases, LayerNorm and BatchNorm affines, layer scales — drawn
  anew so that every block counts), port ``eager`` against JAX ``xla`` in
  f32 at cosine > 1 - 1e-6 and atol 1e-5 (tests/test_torch_towers.py's
  tolerances for the ViT);
* EVA02 under ``kernel`` / ``kernel_fast`` against JAX ``pallas`` /
  ``pallas_fast`` with its kernels interpreted, on the packed route (rope
  in kernel 2) and the [B, H, S, D] route (kernel 3), at tests/test_flash.py's
  f32 tolerance (atol 2e-5, rtol 1e-5);
* each family's ``init`` layout and ``derive_*_cfg_from_sd``; the layouts
  the port's validator takes and the JAX one refuses (ConvNeXt's
  head_norm_first and gamma-free trees); ResNet's "no quantizable" error in
  both packages;
* the kernel launches ``chip_smoke.py`` phase 10 asserts, from the card's
  gates walked with the plain versions, and phase 10 itself at one block a
  stage.

Mapper equality and whole-checkpoint conversion are in
tests/test_torch_convert.py, the golden fixtures through ``Clip`` in
tests/test_torch_e2e.py.
"""

import dataclasses
import functools
import importlib.util
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu import weights as jweights
from clip_embedder_tpu.models import convnext as jconvnext
from clip_embedder_tpu.models import eva02 as jeva02
from clip_embedder_tpu.models import fastvit as jfastvit
from clip_embedder_tpu.models import resnet as jresnet
from clip_embedder_tpu.models.build import TowerSpec as JTowerSpec
from clip_embedder_tpu.ops import flash as jflash
from clip_embedder_tpu.ops.quant import quantize_tree_checked as jquantize_tree_checked
from clip_embedder_tpu_torch import weights as tweights
from clip_embedder_tpu_torch.config import VisionCfg
from clip_embedder_tpu_torch.errors import ConfigError, WeightError
from clip_embedder_tpu_torch.models import convnext, eva02, fastvit, resnet
from clip_embedder_tpu_torch.models.build import TowerSpec
from clip_embedder_tpu_torch.ops import int8_mlp, layers, qkv
from clip_embedder_tpu_torch.ops.quant import quantize_tree_checked
from clip_embedder_tpu_torch.utils.logging import _warned_once
from clip_embedder_tpu_torch.vision import build_tower

# the golden fixtures' dims (tests/fixtures/golden_*/open_clip_config.json),
# FastViT with two attention blocks, ConvNeXt with the mlp head
FASTVIT = jfastvit.FastViTCfg(
    image_size=64, embed_dim=32, depths=(1, 1, 1, 2), dims=(16, 32, 64, 128),
    mlp_ratios=(3, 3, 3, 3), mixers=("repmixer",) * 3 + ("attention",),
    pos_embs=(False, False, False, True), lkc_act=True)
EVA02 = jeva02.Eva02Cfg(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                        mlp_hidden=96, embed_dim=32)
# heads 2 x 64: a 128-lane head group, so the kernel impls take the packed route
EVA02_PACKED = jeva02.Eva02Cfg(image_size=32, patch_size=8, width=128, layers=2, heads=2,
                               mlp_hidden=192, embed_dim=48)
CONVNEXT = jconvnext.ConvNeXtCfg(image_size=64, embed_dim=32, depths=(1, 1, 2, 1),
                                 dims=(16, 32, 64, 128), proj="mlp")
RESNET = jresnet.ResNetCfg(image_size=64, embed_dim=32, layers=(1, 2, 1, 1), width=16,
                           heads=8)
FAMILIES = {
    "fastvit": (jfastvit, fastvit, fastvit.FastViTCfg, FASTVIT),
    "eva02": (jeva02, eva02, eva02.Eva02Cfg, EVA02),
    "convnext": (jconvnext, convnext, convnext.ConvNeXtCfg, CONVNEXT),
    "resnet": (jresnet, resnet, resnet.ResNetCfg, RESNET),
}
JAX_IMPL = {"eager": "xla", "kernel": "pallas", "kernel_fast": "pallas_fast"}


def cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


@functools.lru_cache(maxsize=None)
def _jax_init(jmodule, cfg, seed):
    init = jax.jit(functools.partial(jmodule.init, cfg=cfg))  # one compile, not one per op
    return jax.tree.map(np.asarray, init(jax.random.key(seed)))


def jax_params(jmodule, cfg, seed=0):
    """The JAX ``init`` tree as numpy (a new tree each call), its biases,
    affines and layer scales (``b``, ``scale``, ``bias``, ``ls``, ``gamma``)
    drawn anew around their init values."""
    rng = np.random.default_rng(seed)
    tree = _jax_init(jmodule, cfg, seed)

    def redraw(path, a):
        if getattr(path[-1], "key", None) not in ("b", "scale", "bias", "ls", "gamma"):
            return a
        return (a + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(redraw, tree)


def port_tower(family, params, cfg=None):
    jmod, _, pcls, jcfg = FAMILIES[family]
    pcfg = pcls(**dataclasses.asdict(cfg or jcfg))
    tree = tweights.params_from_numpy(params, device="cpu", dtype=torch.float32)
    return build_tower(TowerSpec(family, pcfg), tree), pcfg


def pixels(n=2, size=64, seed=1):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tower_matches_jax(family):
    jmod, _, _, jcfg = FAMILIES[family]
    params = jax_params(jmod, jcfg)
    x = pixels(size=jcfg.image_size)
    apply = jax.jit(functools.partial(jmod.apply, cfg=jcfg))
    ref = np.asarray(apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    tower, _ = port_tower(family, params)
    with torch.inference_mode():
        got = tower(torch.from_numpy(x)).numpy()
        # the embedders hand every tower channels-first pixels
        first = tower(torch.from_numpy(x).permute(0, 3, 1, 2), channels_first=True).numpy()
    assert got.shape == ref.shape == (2, jcfg.embed_dim)
    assert cos_min(got, ref) > 1 - 1e-6
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_array_equal(first, got)


@pytest.fixture()
def jax_kernels_interpreted(monkeypatch):
    """The JAX package's attention kernels in interpret mode, where its
    layers look them up, so that its ``pallas`` impls run on the CPU."""
    for name in ("flash_attention", "flash_attention_packed"):
        monkeypatch.setattr(jflash, name, functools.partial(getattr(jflash, name),
                                                            interpret=True))


@pytest.mark.parametrize("cfg", [EVA02_PACKED, EVA02], ids=["packed", "bhsd"])
@pytest.mark.parametrize("impl", ["kernel", "kernel_fast"])
def test_eva02_kernel_impls_match_jax_pallas(cfg, impl, jax_kernels_interpreted, monkeypatch):
    """Port ``kernel``/``kernel_fast`` (the kernels' plain versions on the
    CPU) against JAX ``pallas``/``pallas_fast`` (interpreted): the packed
    route hands kernel 2 the q/k/v projections and the rope tables with the
    class token's identity row, and ``kernel_fast`` is the clamped softmax
    without the bf16 exp; the other route rotates outside and takes kernel
    3."""
    calls = []
    real = eva02.flash_attention_packed
    monkeypatch.setattr(eva02, "flash_attention_packed",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    params = jax_params(jeva02, cfg, seed=2)
    x = pixels(size=32, seed=3)
    ref = np.asarray(jeva02.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg,
                                  attn_impl=JAX_IMPL[impl]))
    tower, _ = port_tower("eva02", params, cfg)
    with torch.inference_mode():
        got = tower(torch.from_numpy(x), attn_impl=impl).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    if cfg is EVA02_PACKED:
        assert len(calls) == cfg.layers
        sin, cos = calls[0]["rope"]
        assert sin.shape == (cfg.grid ** 2 + 1, cfg.width)
        assert float(sin[0].abs().max()) == 0 and bool((cos[0] == 1).all())
        assert calls[0]["fast_softmax"] == (impl == "kernel_fast")
        assert "exp_bf16" not in calls[0]
    else:
        assert calls == []


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_layout_is_the_jax_layout(family):
    """The port's init (on the meta device) has the JAX init's tree and
    shapes, and the port's validator takes the JAX tree: one npz serves
    both packages."""
    jmod, tmod, pcls, jcfg = FAMILIES[family]
    jtree = jax_params(jmod, jcfg)
    jshapes = {k: v.shape for k, v in jweights._flatten(jtree).items()}
    pcfg = pcls(**dataclasses.asdict(jcfg))
    tshapes = {k: tuple(v.shape) for k, v in tweights._flatten(
        tmod.init(pcfg, device="meta")).items()}
    if family == "convnext":  # open_clip's mlp head is 2·embed_dim wide, JAX's init dims[-1]
        hid, last = 2 * pcfg.embed_dim, pcfg.dims[-1]
        assert (tshapes.pop("proj/fc1/w"), tshapes.pop("proj/fc1/b"), tshapes.pop("proj/fc2/w"),
                jshapes.pop("proj/fc1/w"), jshapes.pop("proj/fc1/b"), jshapes.pop("proj/fc2/w")) \
            == ((last, hid), (hid,), (hid, pcfg.embed_dim),
                (last, last), (last,), (last, pcfg.embed_dim))
    assert tshapes == jshapes
    tree = tweights.params_from_numpy(jtree, device="cpu", dtype=torch.float32)
    tweights.validate_tower_pytree(tree, TowerSpec(family, pcfg), source="mem")
    wrong = dict(tree)
    wrong.pop(sorted(k for k in wrong if k != "stages")[0])
    with pytest.raises(WeightError, match=f"'{family}' tower layout"):
        tweights.validate_tower_pytree(wrong, TowerSpec(family, pcfg), source="mem")


def _fastvit_sd():
    from torch_ref_fastvit import TorchFastViT

    torch.manual_seed(0)
    tm = TorchFastViT((1, 2, 1, 1), (16, 32, 64, 128), (3, 3, 4, 3),
                      ("repmixer",) * 3 + ("attention",), (False, False, True, True),
                      embed_dim=48)
    return {f"visual.trunk.{k}": v.numpy() for k, v in tm.state_dict().items()}


def _eva02_sd():
    from test_eva02 import TorchEva02

    torch.manual_seed(0)
    tm = TorchEva02(32, 8, 96, 3, 12, 160, 48)
    return {f"visual.trunk.{k}": v.numpy() for k, v in tm.state_dict().items()
            if k not in ("sin", "cos")}


@pytest.mark.parametrize("family", ["fastvit", "eva02"])
def test_derive_cfg_from_sd_matches_jax(family):
    """The dims a conversion derives from a checkpoint equal the JAX
    package's; a dict of another family raises WeightError in both."""
    jmod, tmod, sd = ((jfastvit, fastvit, _fastvit_sd()) if family == "fastvit"
                      else (jeva02, eva02, _eva02_sd()))
    name = f"derive_{family}_cfg_from_sd"
    got = getattr(tmod, name)(sd)
    assert got == getattr(jmod, name)(sd)
    if family == "fastvit":
        assert got["depths"] == (1, 2, 1, 1) and got["mlp_ratios"] == (3.0, 3.0, 4.0, 3.0)
        assert got["pos_embs"] == (False, False, True, True) and got["use_head_proj"]
    else:
        assert got == {"width": 96, "layers": 3, "mlp_hidden": 160}
    other = _eva02_sd() if family == "fastvit" else _fastvit_sd()
    for fn in (getattr(tmod, name), getattr(jmod, name)):
        with pytest.raises(Exception, match="state dict has no") as err:
            fn(other)
        assert type(err.value).__name__ == "WeightError"


def test_unanchored_fastvit_variants_warn_once(caplog):
    """MCi3/MCi4 dims come from the published scaling alone: a load without
    derived dims says so, once per variant, as in the JAX package."""
    _warned_once.clear()
    vcfg = VisionCfg(image_size=256)
    with caplog.at_level(logging.WARNING, logger="clip_embedder_tpu_torch"):
        for name in ("mobileclip2_s3", "fastvit_mci3", "mobileclip2_s4", "fastvit_mci2"):
            fastvit.resolve_fastvit(name, vcfg, 512, None)
        derived = VisionCfg(image_size=256, extra={"fastvit_cfg": {"dims": [8, 16, 32, 64]}})
        _warned_once.clear()
        assert fastvit.resolve_fastvit("fastvit_mci4", derived, 512, None).dims == (8, 16, 32, 64)
    warnings = [r.getMessage() for r in caplog.records if "no independent anchor" in r.getMessage()]
    assert len(warnings) == 2
    assert "fastvit_mci3" in warnings[0] and "fastvit_mci4" in warnings[1]


@pytest.mark.parametrize("variant", ["pre_norm", "no_gamma"])
def test_convnext_trees_the_jax_validator_refuses(variant):
    """A head_norm_first tree (``pre_norm``, the LayerNorm before the pool,
    in place of ``head_norm``) and one without layer scale ``gamma`` are what
    ``map_convnext_visual`` gives for such checkpoints. The JAX validator
    refuses both (a defect the port does not copy); the port loads them and
    computes what JAX ``convnext.apply`` computes on them."""
    params = jax_params(jconvnext, CONVNEXT, seed=4)
    if variant == "pre_norm":
        params["pre_norm"] = params.pop("head_norm")
    else:
        for stage in params["stages"]:
            del stage["blocks"]["gamma"]
    with pytest.raises(Exception, match="does not match the 'convnext' tower layout"):
        jweights.validate_tower_pytree(params, JTowerSpec("convnext", CONVNEXT), source="mem")
    tree = tweights.params_from_numpy(params, device="cpu", dtype=torch.float32)
    spec = TowerSpec("convnext", convnext.ConvNeXtCfg(**dataclasses.asdict(CONVNEXT)))
    tweights.validate_tower_pytree(tree, spec, source="mem")
    x = pixels(seed=5)
    apply = jax.jit(functools.partial(jconvnext.apply, cfg=CONVNEXT))
    ref = np.asarray(apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    with torch.inference_mode():
        got = build_tower(spec, tree)(torch.from_numpy(x)).numpy()
    assert cos_min(got, ref) > 1 - 1e-6
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # what is not one of the accepted layouts still fails
    del tree["stem_norm"]
    with pytest.raises(WeightError, match="missing: stem_norm"):
        tweights.validate_tower_pytree(tree, spec, source="mem")


def test_resnet_has_nothing_to_quantize():
    """No ResNet subtree is an MLP block or an ``attn`` subtree: both int8
    modes raise the same ConfigError in both packages."""
    params = jax_params(jresnet, RESNET)
    tree = tweights.params_from_numpy(params, device="cpu", dtype=torch.float32)
    for mode in ("int8", "int8_all"):
        with pytest.raises(ConfigError, match="no quantizable"):
            quantize_tree_checked(tree, "resnet", mode=mode)
        with pytest.raises(Exception, match="no quantizable") as err:
            jquantize_tree_checked(params, "resnet", mode=mode)
        assert type(err.value).__name__ == "ConfigError"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture()
def card_gates(monkeypatch):
    """The int8 gates as on the card for CPU tensors, and a count of the
    calls to each wrapper where the layers call it (each then runs its plain
    version): the routing the card would take."""
    monkeypatch.setattr(int8_mlp, "on_card", lambda x: True)
    monkeypatch.setattr(qkv, "on_card", lambda x: True)
    calls = {"int8_linear_fused": 0, "flash_attention_packed": 0}

    def spy(module, name, plain):
        def run(*a, **kw):
            calls[name] += 1
            return plain(*a, **kw)
        monkeypatch.setattr(module, name, run)

    spy(layers, "int8_linear_fused", int8_mlp.int8_linear_fused_plain)
    spy(eva02, "flash_attention_packed", eva02.flash_attention_packed)
    return calls


@pytest.mark.parametrize("name,mode,batch", [
    ("MobileCLIP2-S4", "int8", 1), ("MobileCLIP2-S4", "int8", 2),
    ("MobileCLIP2-S4", "int8_all", 2), ("convnext_large_d_320", "int8", 1),
    ("EVA02-L-14-336", "int8_all", 1)])
def test_phase10_vision_launches_follow_the_gates(name, mode, batch, card_gates):
    """One vision forward of a phase-10 model (one block a stage, 256 to 336
    pixels: the stages' rows cross the fused linear's 128-row gate as at
    full depth) calls the wrappers as often as ``chip_smoke.vision_launches``
    says phase 10 will count on the card."""
    smoke = _chip_smoke()
    model = {m[0]: m[1] for m in smoke.FAMILY_MODELS}[name]
    clip, vspec, _ = smoke.build_clip("cpu", torch.float32, layers=1, vocab_size=512,
                                      quantize=mode, model=model,
                                      preprocess=smoke.OPENAI_PREPROCESS,
                                      tokenizer="golden_model", layer_scale=0.1)
    size = vspec.cfg.image_size
    x = torch.from_numpy(pixels(batch, size, seed=6)).permute(0, 3, 1, 2)
    impl = "kernel" if vspec.family == "eva02" else "eager"
    with torch.inference_mode():
        clip.vision.tower(x, attn_impl=impl, channels_first=True)
    want = smoke.vision_launches(vspec, mode, batch)
    assert card_gates == {k: want[k] for k in card_gates}
    assert want["int8_linear_fused"] > 0


def test_fused_int8_linear_gets_contiguous_rows(card_gates, monkeypatch):
    """``layers.linear`` hands the fused int8 linear (whose kernel takes
    contiguous rows only) a contiguous operand, whatever view it was given:
    an NHWC view of a conv's output need not be one."""
    seen = []
    monkeypatch.setattr(layers, "int8_linear_fused",
                        lambda p, x: seen.append(x.is_contiguous())
                        or int8_mlp.int8_linear_fused_plain(p, x))
    rng = np.random.default_rng(7)
    q = quantize_tree_checked(
        {"fc1": {"w": torch.from_numpy(rng.standard_normal((32, 48)).astype(np.float32))}},
        "convnext")["fc1"]
    x = torch.from_numpy(rng.standard_normal((2, 32, 8, 16)).astype(np.float32))
    nhwc_view = x.permute(0, 2, 3, 1)
    assert not nhwc_view.is_contiguous()
    got = layers.linear(q, nhwc_view)
    assert seen == [True]
    torch.testing.assert_close(got, int8_mlp.int8_linear_fused_plain(q, nhwc_view.contiguous()))


def test_chip_smoke_families_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 10 (MobileCLIP2-S4, EVA02-L-14-336,
    convnext_large_d_320 and RN50 at full width, one block a stage and a
    small vocabulary) on the CPU: every model and mode builds, embeds and
    classifies, the plain paths agree, no kernel is launched; the configs
    resolve to the published widths."""
    smoke = _chip_smoke()
    out = smoke.phase_families("cpu", torch.float32, layers=1, vocab_size=512, batch=2,
                               timed=False)
    assert sorted(out) == sorted(f"{name} {mode or 'float32'}"
                                 for name, _, modes in smoke.FAMILY_MODELS for mode in modes)
    for run in out.values():
        assert set(run["launches"].values()) == {0}
    from clip_embedder_tpu_torch.config import ModelCfg
    from clip_embedder_tpu_torch.models.build import resolve_text, resolve_vision

    families = {}
    for name, model, _ in smoke.FAMILY_MODELS:
        cfg = ModelCfg.from_dict(model)
        vspec = resolve_vision(cfg)
        families[name] = (vspec.family, vspec.cfg, resolve_text(cfg).cfg)
    fam, v, t = families["MobileCLIP2-S4"]
    assert (fam, v.dims, v.depths, v.embed_dim, t.layers, t.width) == \
        ("fastvit", (128, 256, 512, 1024), (4, 12, 24, 4), 768, 16, 768)
    fam, v, t = families["EVA02-L-14-336"]
    assert (fam, v.width, v.layers, v.heads, v.mlp_hidden, v.grid ** 2 + 1, v.use_proj) == \
        ("eva02", 1024, 24, 16, 2730, 577, True)
    fam, v, t = families["convnext_large_d_320"]
    assert (fam, v.dims, v.depths, v.proj, t.layers) == \
        ("convnext", (192, 384, 768, 1536), (3, 3, 27, 3), "mlp", 16)
    fam, v, t = families["RN50"]
    assert (fam, v.layers, v.width, v.heads, v.pool_tokens, t.width, t.heads) == \
        ("resnet", (3, 4, 6, 3), 64, 32, 50, 512, 8)

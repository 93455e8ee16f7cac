"""The torch port's BERT text tower (BiomedCLIP's family) and both CoCa
towers against the JAX package, on the CPU.

The JAX ``init`` makes the weights and the port takes them through
``weights.params_from_numpy``; the towers must give the JAX
``attn_impl="xla"`` outputs at cosine > 1 - 1e-6 and atol 1e-5 in f32, on
the eager impl and on the kernel impl (the kernels' plain versions: at 128
wide, 2 heads x 64 and 4 x 32 form a 128-lane head group and send their
per-batch masks, BERT's key rows and CoCa's causal + cls blocks, to the
packed kernel's plain version; golden_hf_bert's 4 x 16 form none and take
``attention_core``).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu import weights as jweights
from clip_embedder_tpu.models import hf_text as jhf
from clip_embedder_tpu.models import text_transformer as jtext
from clip_embedder_tpu.models import vit as jvit
from clip_embedder_tpu_torch import weights as tweights
from clip_embedder_tpu_torch.errors import WeightError
from clip_embedder_tpu_torch.models import hf_text as thf
from clip_embedder_tpu_torch.models import text_transformer as ttext
from clip_embedder_tpu_torch.models import vit as tvit
from clip_embedder_tpu_torch.models.build import TowerSpec
from clip_embedder_tpu_torch.ops import attention as tattn
from clip_embedder_tpu_torch.ops import flash

FIXTURES = Path(__file__).parent / "fixtures"
IMPLS = ("eager", "kernel")


def cos_min(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                     * np.linalg.norm(b, axis=-1))).min())


def _jax_params(init, cfg, seed):
    return jax.tree.map(np.asarray, init(jax.random.key(seed), cfg))


def _port_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _torch(params):
    return tweights.params_from_numpy(params, device="cpu", dtype=torch.float32)


def _agree(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert cos_min(got, ref) > 1 - 1e-6
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.fixture
def packed_calls(monkeypatch):
    """The mask shapes the packed kernel's wrapper is called with."""
    seen = []
    real = flash.flash_attention_packed

    def spy(*a, **kw):
        seen.append(None if kw.get("mask") is None else tuple(kw["mask"].shape))
        return real(*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention_packed", spy)
    return seen


# -- BERT ---------------------------------------------------------------------

BERT = jhf.BertCfg(context_length=16, vocab_size=120, width=128, heads=2, layers=2,
                   mlp_hidden=256, embed_dim=96, pad_id=0)


def _bert_ids(cfg, lengths, seed=0):
    """Rows of the given lengths (CLS id 2 first), the rest the pad id; a
    length of 0 is a row of pad ids alone, as bucket padding makes."""
    ids = np.random.default_rng(seed).integers(3, cfg.vocab_size, (len(lengths),
                                                                   cfg.context_length))
    ids[:, 0] = 2
    for i, n in enumerate(lengths):
        ids[i, n:] = cfg.pad_id
    return ids.astype(np.int32)


def _run_bert(jcfg, ids, seed=0, mask=None):
    params = _jax_params(jhf.init, jcfg, seed)
    ref = np.asarray(jhf.apply(params, jnp.asarray(ids), jcfg, attn_impl="xla",
                               attention_mask=None if mask is None else jnp.asarray(mask)))
    tower = thf.HFText(_port_cfg(thf.BertCfg, jcfg), _torch(params))
    kw = {} if mask is None else {"attention_mask": torch.from_numpy(mask)}
    outs = {}
    for impl in IMPLS:
        with torch.inference_mode():
            outs[impl] = tower(torch.from_numpy(ids), attn_impl=impl, **kw).numpy()
    return outs, ref


@pytest.mark.parametrize("style", ["bert", "roberta"])
@pytest.mark.parametrize("heads", [2, 4], ids=["2x64", "4x32"])
def test_bert_matches_jax(heads, style, packed_calls):
    """Rows of different lengths, one of pad ids alone (every key masked),
    both position styles, through the packed kernel's key-mask form."""
    jcfg = dataclasses.replace(BERT, heads=heads)
    if style == "roberta":  # pads at padding_idx 1, positions from 2
        jcfg = dataclasses.replace(jcfg, pad_id=1, position_style="roberta",
                                   max_pos=jcfg.context_length + 2, ln_eps=1e-5)
    ids = _bert_ids(jcfg, [16, 9, 4, 0], seed=1)
    outs, ref = _run_bert(jcfg, ids, seed=2)
    for impl, got in outs.items():
        _agree(got, ref)
    assert packed_calls == [(4, 1, 1, 16)] * jcfg.layers


@pytest.mark.parametrize("pooler", ["cls", "cls_pooler", "mean", "max"])
@pytest.mark.parametrize("proj", ["linear", "mlp", "none"])
def test_bert_poolers_and_projections_match_jax(pooler, proj):
    jcfg = dataclasses.replace(BERT, pooler=pooler, proj=proj)
    outs, ref = _run_bert(jcfg, _bert_ids(jcfg, [16, 9, 4, 1], seed=3), seed=4)
    assert ref.shape[-1] == (jcfg.width if proj == "none" else jcfg.embed_dim)
    for got in outs.values():
        _agree(got, ref)


def test_bert_tokenizer_mask_overrides_the_pad_id():
    """The tokenizer's attention mask is authoritative: with ids padded by
    an id other than the HF pad id, the mask decides what is attended, as
    in the JAX package."""
    ids = _bert_ids(BERT, [16, 9, 4, 3], seed=5)
    mask = (ids != BERT.pad_id).astype(np.int32)
    ids[ids == BERT.pad_id] = 1
    outs, ref = _run_bert(BERT, ids, seed=6, mask=mask)
    for got in outs.values():
        _agree(got, ref)
    derived, _ = _run_bert(BERT, ids, seed=6)
    assert np.abs(derived["eager"] - outs["eager"]).max() > 1e-6


def test_bert_golden_text_npz_matches_jax():
    """golden_hf_bert's own weights and its tokenizer's masks (4 x 16 heads:
    no head group, so the masks go to attention_core on every impl)."""
    from clip_embedder_tpu.config import OpenClipConfig as JConfig
    from clip_embedder_tpu.models.build import resolve_text as jresolve
    from clip_embedder_tpu_torch.config import OpenClipConfig
    from clip_embedder_tpu_torch.models.build import resolve_text
    from clip_embedder_tpu_torch.tokenizer import Tokenizer

    fixture = FIXTURES / "golden_hf_bert"
    jcfg = jresolve(JConfig.from_file(fixture / "open_clip_config.json").model_cfg).cfg
    spec = resolve_text(OpenClipConfig.from_file(fixture / "open_clip_config.json").model_cfg)
    assert spec.family == "hf_bert"
    assert dataclasses.asdict(spec.cfg) == dataclasses.asdict(jcfg)
    tok = Tokenizer.from_file(fixture / "tokenizer.json")
    tok.with_padding(length=jcfg.context_length, pad_id=0)
    tok.with_truncation(max_length=jcfg.context_length)
    ids, mask = tok.encode_batch(["a photo of a cat", "the dog!", "", "x" * 40])
    params = tweights.load_pytree(fixture / "text.npz", device="cpu", dtype=torch.float32)
    tweights.validate_tower_pytree(params, spec, source="text.npz")
    ref = np.asarray(jhf.apply(jweights.load_pytree(fixture / "text.npz"), jnp.asarray(ids),
                               jcfg, attention_mask=jnp.asarray(mask)))
    tower = thf.HFText(spec.cfg, params)
    for impl in IMPLS + ("kernel_fast",):
        with torch.inference_mode():
            got = tower(torch.from_numpy(ids), attn_impl=impl,
                        attention_mask=torch.from_numpy(mask)).numpy()
        _agree(got, ref)


def test_bert_cls_pooler_needs_its_weights():
    cfg = _port_cfg(thf.BertCfg, dataclasses.replace(BERT, pooler="cls_pooler"))
    params = thf.init(cfg)
    del params["pooler"]
    with pytest.raises(WeightError, match="pooler"):
        tweights.validate_tower_pytree(params, TowerSpec("hf_bert", cfg), source="mem")
    with pytest.raises(WeightError, match="pooler"), torch.inference_mode():
        thf.HFText(cfg, params)(torch.from_numpy(_bert_ids(BERT, [3, 2])))


@pytest.mark.parametrize("jcfg", [
    dataclasses.replace(BERT, pooler="cls_pooler", proj="mlp"),
    dataclasses.replace(BERT, proj="none", position_style="roberta", pad_id=1, max_pos=18),
], ids=["pooler_mlp", "roberta_none"])
def test_bert_init_layout_is_the_jax_layout(jcfg):
    jshapes = {k: v.shape for k, v in jweights._flatten(_jax_params(jhf.init, jcfg, 0)).items()}
    tshapes = {k: tuple(v.shape) for k, v in tweights._flatten(
        thf.init(_port_cfg(thf.BertCfg, jcfg), device="meta")).items()}
    assert tshapes == jshapes


@pytest.mark.parametrize("proj", ["linear", "mlp"])
def test_map_hf_text_matches_jax(proj):
    """An open_clip HFTextEncoder state dict (a transformers BertModel with
    its pooler under ``text.transformer.``, and ``text.proj``), mapped by
    both packages: the same tree, leaf for leaf."""
    transformers = pytest.importorskip("transformers")
    config = transformers.BertConfig(vocab_size=120, hidden_size=64, num_hidden_layers=3,
                                     num_attention_heads=4, intermediate_size=128,
                                     max_position_embeddings=32, pad_token_id=0)
    torch.manual_seed(0)
    model = transformers.BertModel(config, add_pooling_layer=True).eval()
    sd = {f"text.transformer.{k}": v.detach().numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(7)
    if proj == "linear":
        sd["text.proj.weight"] = rng.standard_normal((32, 64)).astype(np.float32)
    else:
        sd["text.proj.0.weight"] = rng.standard_normal((48, 64)).astype(np.float32)
        sd["text.proj.0.bias"] = rng.standard_normal(48).astype(np.float32)
        sd["text.proj.2.weight"] = rng.standard_normal((32, 48)).astype(np.float32)
    ref = jweights._flatten(jhf.map_hf_text(sd))
    got = tweights._flatten(thf.map_hf_text(sd))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    with pytest.raises(WeightError, match="No blocks"):
        thf.map_hf_text({"text.proj.weight": sd.get("text.proj.weight")})


# -- CoCa ---------------------------------------------------------------------

# width 128 with 4 heads x 32 and 2 x 64 (both through the packed kernel's
# full-mask form); embed 96 != width, so the pooler's k/v come in at another
# width
COCA_VIT = jvit.ViTCfg(image_size=32, patch_size=8, width=128, layers=2, heads=4,
                       mlp_hidden=512, embed_dim=96, pool="attn", attn_pool_queries=8,
                       attn_pool_dim=96, pool_heads=8)
COCA_TEXT = jtext.TextCfgResolved(context_length=12, vocab_size=64, width=128, heads=4,
                                  layers=2, mlp_hidden=512, embed_dim=96, pool="last",
                                  embed_cls=True, pad_id=0)


def _coca_ids(pads, seed=0, pad_id=0):
    """[B, 12] ids whose trailing pad counts are ``pads`` (every row's cls
    row of the mask differs)."""
    ids = np.random.default_rng(seed).integers(2, 64, (len(pads), 12))
    for i, n in enumerate(pads):
        if n:
            ids[i, -n:] = pad_id
    return ids.astype(np.int32)


def test_coca_vision_matches_jax():
    params = _jax_params(jvit.init, COCA_VIT, 0)
    pixels = np.random.default_rng(1).standard_normal((3, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvit.apply(params, pixels, COCA_VIT, attn_impl="xla"))
    tower = tvit.ViT(_port_cfg(tvit.ViTCfg, COCA_VIT), _torch(params))
    for impl in IMPLS:
        with torch.inference_mode():
            _agree(tower(torch.from_numpy(pixels), attn_impl=impl).numpy(), ref)


@pytest.mark.parametrize("heads", [4, 2], ids=["4x32", "2x64"])
@pytest.mark.parametrize("pad_id", [0, 5])
def test_coca_text_matches_jax(heads, pad_id, packed_calls):
    jcfg = dataclasses.replace(COCA_TEXT, heads=heads, pad_id=pad_id)
    params = _jax_params(jtext.init, jcfg, 2)
    ids = _coca_ids([0, 3, 7, 11], seed=3, pad_id=pad_id)
    ref = np.asarray(jtext.apply(params, ids, jcfg, attn_impl="xla"))
    tower = ttext.TextTransformer(_port_cfg(ttext.TextCfgResolved, jcfg), _torch(params))
    for impl in IMPLS:
        with torch.inference_mode():
            _agree(tower(torch.from_numpy(ids), attn_impl=impl).numpy(), ref)
    assert packed_calls == [(4, 1, 13, 13)] * jcfg.layers


def test_cls_mask_literal_semantics():
    """open_clip's one-column shift: column 0 open, token j's pad status on
    column j + 1, the text queries' rows untouched; equal to the JAX
    ``_cls_mask`` on random ids."""
    m = ttext.cls_mask(torch.tensor([[3, 5, 0, 0]]), 0)[0, 0].numpy()
    assert m.shape == (5, 5)
    np.testing.assert_array_equal(m[:4], 0.0)
    assert list(np.isneginf(m[4])) == [False, False, False, True, True]
    ids = _coca_ids([0, 2, 5], seed=8, pad_id=4)
    for pad_id in (0, 4):
        np.testing.assert_array_equal(
            ttext.cls_mask(torch.from_numpy(ids), pad_id).numpy(),
            np.asarray(jtext._cls_mask(jnp.asarray(ids), pad_id)))


def test_coca_text_depends_on_the_pad_id():
    """The cls query sees the padding only where the mask is built from the
    pad id the ids carry: building it from another id changes the pooled
    output (why the embedder passes the tokenizer's pad id)."""
    cfg = _port_cfg(ttext.TextCfgResolved, COCA_TEXT)
    params = _torch(_jax_params(jtext.init, COCA_TEXT, 9))
    ids = torch.from_numpy(_coca_ids([4, 4], seed=10, pad_id=7))
    with torch.inference_mode():
        masked = ttext.TextTransformer(dataclasses.replace(cfg, pad_id=7), params)(ids)
        unmasked = ttext.TextTransformer(cfg, params)(ids)
    assert (masked - unmasked).abs().max() > 1e-4


@pytest.mark.parametrize("family,jinit,tinit,jcfg", [
    ("vit", jvit.init, tvit.init, COCA_VIT),
    ("text_transformer", jtext.init, ttext.init, COCA_TEXT)], ids=["vision", "text"])
def test_coca_init_layout_is_the_jax_layout(family, jinit, tinit, jcfg):
    jshapes = {k: v.shape for k, v in jweights._flatten(_jax_params(jinit, jcfg, 0)).items()}
    pcfg = _port_cfg(tvit.ViTCfg if family == "vit" else ttext.TextCfgResolved, jcfg)
    tshapes = {k: tuple(v.shape) for k, v in tweights._flatten(
        tinit(pcfg, device="meta")).items()}
    assert tshapes == jshapes
    tweights.validate_tower_pytree(_torch(_jax_params(jinit, jcfg, 1)),
                                   TowerSpec(family, pcfg), source="jax")


# -- chip_smoke.py phase 8, rehearsed ------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_masked_towers_rehearse_on_cpu():
    """chip_smoke.py's phase 8 (BiomedCLIP and coca_ViT-L-14 at full width,
    cut to one layer a tower and a small vocabulary) on the CPU: each model
    and mode builds, embeds images and captions, classifies, and holds its
    towers against the plain path; no kernel is launched. The phase-3 masks
    differ in every batch row."""
    smoke = _chip_smoke()
    out = smoke.phase_masked_towers("cpu", torch.float32, layers=1, vocab_size=512, batch=3,
                                    timed=False)
    assert sorted(out) == ["BiomedCLIP float32", "BiomedCLIP int8_all",
                           "coca_ViT-L-14 float32"]
    for run in out.values():
        assert set(run["launches"].values()) == {0}
        assert set(run["mask_launches"].values()) == {0}
    _, vspec, tspec = smoke.build_clip("cpu", torch.float32, layers=1, vocab_size=512,
                                       model=smoke.BIOMEDCLIP, tokenizer="golden_hf_bert",
                                       preprocess=smoke.OPENAI_PREPROCESS)
    v, t = vspec.cfg, tspec.cfg
    assert (v.width, v.heads, v.seq_len, v.pool, v.embed_dim) == (768, 12, 197, "tok", 512)
    assert tspec.family == "hf_bert"
    assert (t.width, t.heads, t.mlp_hidden, t.context_length, t.pooler, t.proj, t.ln_eps) == \
        (768, 12, 3072, 256, "cls", "mlp", 1e-12)
    _, vspec, tspec = smoke.build_clip("cpu", torch.float32, layers=1, vocab_size=512,
                                       model=smoke.COCA_VIT_L_14, tokenizer="golden_siglip",
                                       preprocess=smoke.OPENAI_PREPROCESS)
    v, t = vspec.cfg, tspec.cfg
    assert (v.width, v.heads, v.seq_len, v.mlp_hidden, v.pool, v.attn_pool_queries,
            v.attn_pool_dim, v.pool_heads) == (1024, 16, 257, 4096, "attn", 256, 768, 8)
    assert (t.width, t.heads, t.context_length, t.embed_cls, t.causal, t.pad_id) == \
        (768, 12, 76, True, True, 1)
    for s, make in ((256, smoke.key_mask), (77, smoke.full_mask)):
        m = make(32, s, "cpu")
        rows = m[:, 0, -1] if s == 77 else m[:, 0, 0]
        assert len({tuple(r.tolist()) for r in rows}) == 32
    assert bool((smoke.key_mask(32, 256, "cpu")[2] == -1e30).all())
    assert len(set(map(len, smoke.captions(32, 70)))) == 32

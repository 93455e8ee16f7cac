"""The captured-forward layer (``clip_embedder_tpu_torch.utils.captured``) on
the CPU: no JAX here.

* A host-read audit of every native family's tower forward at small dims,
  by family × impl (``eager``, ``kernel``: the kernels' plain versions on
  the CPU, the card's int8 routing walked through its gates) × quantize
  mode where the family takes one, under ``captured.HostReadGuard``: no op
  that a CUDA graph cannot hold (``.item()``, ``bool(t)``, ``nonzero``,
  ``masked_select``, ``equal``, the ``unique`` ops, ``torch.tensor``).
* A CPU embedder builds no graph and returns its tower's own rows.
* The ONNX executor's static tensors, made once and reused, so that it is
  captured as every other family is.
* The launch counts' tally (``ops.cuda.count`` / ``tallied``), which keeps
  the counts exact when a graph replays.

On the card, ``tests/test_torch_cuda.py`` holds the captured rows against
the eager ones and ``chip_smoke.py`` phase 14 runs the layer at full size.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from clip_embedder_tpu_torch import Clip, onnx_exec
from clip_embedder_tpu_torch.models import convnext, eva02, fastvit, hf_text, mct, resnet
from clip_embedder_tpu_torch.models import text_transformer, vit
from clip_embedder_tpu_torch.models.build import TowerSpec
from clip_embedder_tpu_torch.ops import cuda, int8_mlp, qkv, rows
from clip_embedder_tpu_torch.text import text_tower
from clip_embedder_tpu_torch.utils import captured
from clip_embedder_tpu_torch.vision import build_tower, quantize_params
from clip_embedder_tpu_torch.weights import _family_init

FIXTURE = Path(__file__).parent / "fixtures" / "golden_siglip"
MODES = (None, "int8", "int8_all")

# small towers: heads of 32 or 64 lanes in 128-lane groups, so the kernel
# impls take the packed attention route as at the real widths
VISION = {
    "vit_siglip_map": ("vit", vit.ViTCfg(
        image_size=32, patch_size=8, width=128, layers=2, heads=4, mlp_hidden=256,
        embed_dim=128, activation="gelu_tanh", use_class_token=False, use_ln_pre=False,
        pool="map", use_proj=False, ln_eps=1e-6, pos_embed_cls=False)),
    "vit_pe_rope": ("vit", vit.ViTCfg(
        image_size=32, patch_size=8, width=128, layers=2, heads=2, mlp_hidden=256,
        embed_dim=64, rope_2d=True, pool="map", pool_heads=2, pool_mlp_hidden=256)),
    "vit_coca_attn_pool": ("vit", vit.ViTCfg(
        image_size=32, patch_size=8, width=128, layers=2, heads=4, mlp_hidden=256,
        embed_dim=96, pool="attn", attn_pool_queries=8, attn_pool_dim=96, pool_heads=8)),
    "eva02": ("eva02", eva02.Eva02Cfg(image_size=32, patch_size=8, width=128, layers=2,
                                      heads=2, mlp_hidden=192, embed_dim=48)),
    "fastvit": ("fastvit", fastvit.FastViTCfg(
        image_size=64, embed_dim=32, depths=(1, 1, 1, 2), dims=(16, 32, 64, 128),
        mlp_ratios=(3, 3, 3, 3), mixers=("repmixer",) * 3 + ("attention",),
        pos_embs=(False, False, False, True), lkc_act=True)),
    "convnext": ("convnext", convnext.ConvNeXtCfg(image_size=64, embed_dim=32,
                                                 depths=(1, 1, 2, 1), dims=(16, 32, 64, 128),
                                                 proj="mlp")),
    "resnet": ("resnet", resnet.ResNetCfg(image_size=64, embed_dim=32, layers=(1, 2, 1, 1),
                                          width=16, heads=8)),
}
TEXT = {
    "text_siglip": ("text_transformer", text_transformer.TextCfgResolved(
        context_length=12, vocab_size=64, width=128, heads=4, layers=2, mlp_hidden=256,
        embed_dim=128, activation="gelu_tanh", causal=False, pool="last", proj_bias=True,
        ln_eps=1e-6)),
    "text_clip_causal": ("text_transformer", text_transformer.TextCfgResolved(
        context_length=12, vocab_size=64, width=128, heads=4, layers=2, mlp_hidden=256,
        embed_dim=64, activation="quick_gelu", causal=True, pool="argmax")),
    "text_coca_cls": ("text_transformer", text_transformer.TextCfgResolved(
        context_length=12, vocab_size=64, width=128, heads=4, layers=2, mlp_hidden=256,
        embed_dim=96, pool="last", embed_cls=True, pad_id=0)),
    "hf_bert_mean": ("hf_bert", hf_text.BertCfg(
        context_length=16, vocab_size=120, width=128, heads=2, layers=2, mlp_hidden=256,
        embed_dim=96, pad_id=0, pooler="mean")),
    "hf_bert_max": ("hf_bert", hf_text.BertCfg(
        context_length=16, vocab_size=120, width=128, heads=2, layers=2, mlp_hidden=256,
        embed_dim=96, pad_id=0, pooler="max")),
    "mct": ("mct", mct.MctCfg(context_length=12, vocab_size=64, width=128, heads=4, layers=2,
                              mlp_hidden=256, embed_dim=48, conv_blocks=((5, 192), (3, 0)))),
}
VISION_FAMILIES = {"vit", "eva02", "fastvit", "convnext", "resnet"}
# the families whose forward takes attn_impl (vision.ATTN_IMPL_FAMILIES)
IMPL_FAMILIES = {"vit", "eva02", "text_transformer", "hf_bert", "mct"}
# ModifiedResNet has nothing to quantize (its convolutions stay bf16)
QUANTIZED = {"vit", "eva02", "fastvit", "convnext", "text_transformer", "hf_bert", "mct"}


def _cases(towers):
    for name, (family, _) in towers.items():
        for impl in ("eager", "kernel") if family in IMPL_FAMILIES else ("eager",):
            for mode in MODES if family in QUANTIZED else (None,):
                yield pytest.param(name, impl, mode, id=f"{name}-{impl}-{mode or 'float'}")


def _tower(family, cfg, mode):
    gen = torch.Generator().manual_seed(0)
    params = _family_init(family)(cfg, generator=gen, device="cpu", dtype=torch.float32)
    spec = TowerSpec(family, cfg)
    params = quantize_params(params, spec, mode, "cpu", torch.float32)
    return build_tower(spec, params) if family in VISION_FAMILIES else text_tower(spec, params)


@pytest.fixture(autouse=True)
def one_thread():
    """These towers are small: one intra-op thread. With the suite's other
    workers busy, a pool of threads waits on its slowest at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def card_gates(monkeypatch):
    """The int8 gates and the block rows' gate as on the card: the fused
    wrappers and ``ops.rows``' (their plain versions on the CPU) where the
    card launches the kernels."""
    monkeypatch.setattr(int8_mlp, "on_card", lambda x: True)
    monkeypatch.setattr(qkv, "on_card", lambda x: True)
    monkeypatch.setattr(rows, "on_card", lambda x: x.dtype in cuda.DTYPE_CODES)


@pytest.mark.parametrize("name,impl,mode", list(_cases(VISION)))
def test_vision_forward_reads_nothing_on_the_host(name, impl, mode, card_gates):
    family, cfg = VISION[name]
    tower = _tower(family, cfg, mode)
    pixels = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, cfg.image_size, cfg.image_size)).astype(np.float32))
    with torch.inference_mode():
        # the layer's warm-up: a tower's cached tables (the rope tables) are
        # made here, outside the graph
        first = tower(pixels, attn_impl=impl, channels_first=True)
        with captured.HostReadGuard():
            out = tower(pixels, attn_impl=impl, channels_first=True)
    assert out.shape == (2, cfg.embed_dim) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, first, atol=0, rtol=0)


@pytest.mark.parametrize("name,impl,mode", list(_cases(TEXT)))
def test_text_forward_reads_nothing_on_the_host(name, impl, mode, card_gates):
    family, cfg = TEXT[name]
    tower = _tower(family, cfg, mode)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, cfg.vocab_size, (3, cfg.context_length)).astype(np.int64)
    mask = np.ones_like(ids)
    for row, n in enumerate((cfg.context_length, 5, 2)):  # padded rows
        ids[row, n:], mask[row, n:] = 0, 0
    ids = torch.from_numpy(ids)
    kwargs = {"attention_mask": torch.from_numpy(mask)} if family == "hf_bert" else {}
    with torch.inference_mode():
        first = tower(ids, attn_impl=impl, **kwargs)
        with captured.HostReadGuard():
            out = tower(ids, attn_impl=impl, **kwargs)
    assert out.shape == (3, cfg.embed_dim) and bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, first, atol=0, rtol=0)


@pytest.mark.parametrize("read", [
    lambda x: x.sum().item(), lambda x: bool(x.sum() > 0), lambda x: x.nonzero(),
    lambda x: x.masked_select(x > 0), lambda x: torch.equal(x, x), lambda x: torch.unique(x),
    lambda x: torch.unique_consecutive(x), lambda x: torch.tensor(-1e30, dtype=x.dtype),
    lambda x: float(x[0])],
    ids=["item", "bool", "nonzero", "masked_select", "equal", "unique", "unique_consecutive",
         "tensor", "float"])
def test_host_read_guard_names_the_op(read):
    x = torch.randn(4)
    with pytest.raises(captured.CaptureError, match="reads tensor data on the host"):
        with captured.HostReadGuard():
            read(x)
    with captured.HostReadGuard():  # what a forward does stays allowed
        torch.where(x > 0, 0.0, -1e30) + torch.full((), -1e30) + x.cpu()


def test_cpu_embedders_build_no_graph_and_return_the_towers_rows():
    clip = Clip.from_local_dir(FIXTURE, device="cpu")
    image = np.random.default_rng(3).integers(0, 255, (40, 50, 3), dtype=np.uint8)
    rows, n = clip.vision.embed_images_device([image, image[:20]])
    with torch.inference_mode():
        pixels = clip.vision.preprocessor([image, image[:20]])
        ref = clip.vision.tower(pixels, attn_impl=clip.vision.attn_impl, channels_first=True)
    assert n == 2 and rows.device.type == "cpu"
    torch.testing.assert_close(rows, ref, atol=0, rtol=0)
    texts = ["a cat", "two dogs on a mat"]
    got = clip.text.embed_texts(texts)
    ids, _ = clip.text.tokenize(texts)
    with torch.inference_mode():
        tref = clip.text.tower(torch.from_numpy(ids), attn_impl=clip.text.attn_impl)
    np.testing.assert_array_equal(got, tref.numpy())
    for emb in (clip.vision, clip.text, clip.vision.duplicate()):
        assert captured.graphs_of(emb.tower) is None


def test_the_onnx_executor_reuses_its_static_tensors_and_captures_like_every_family():
    """The executor makes a device tensor of a host constant (a numpy array)
    when an op first takes one as an operand (``onnx_exec._Env.const``): a
    tensor from host data, which the guard refuses. From then on the same
    content is the same tensor, which passes the guard, so the family is
    captured as the others are: no family stays eager by name."""
    env = onnx_exec._Env(torch.device("cpu"))
    env["half"] = np.asarray(0.5, np.float32)
    env["also_half"] = np.asarray(0.5, np.float64)  # f64 becomes f32: the same content
    with torch.inference_mode():
        with pytest.raises(captured.CaptureError, match="lift_fresh"):
            with captured.HostReadGuard():
                env.t("half")
        first = env.t("half")
        with captured.HostReadGuard():
            again, also = env.t("half"), env.t("also_half")
            other = onnx_exec._Env(env.device, env.consts)  # an If branch's, a later call's
            other["x"] = np.float32(0.5)
            shared = other.t("x")
    assert again is first and also is first and shared is first
    assert not hasattr(captured, "EAGER_FAMILIES")


def test_tallied_counts_replace_the_wrappers_counts():
    fn = qkv.ln_qkv
    flash_fn = _flash()
    before = fn.launches, dict(flash_fn.mask_launches)
    with cuda.tallied() as tally:
        cuda.count(fn)
        cuda.count(fn)
        cuda.count(flash_fn, "mask_launches", "key")
        with cuda.tallied() as inner:  # a nested tally takes its own block's counts
            cuda.count(fn)
    assert (fn.launches, flash_fn.mask_launches) == before
    assert tally == {(fn, "launches", None): 2, (flash_fn, "mask_launches", "key"): 1}
    assert inner == {(fn, "launches", None): 1}
    for (wrapper, counter, form), n in tally.items():  # what a replay adds
        cuda.count(wrapper, counter, form, n)
    try:
        assert fn.launches == before[0] + 2
        assert flash_fn.mask_launches["key"] == before[1]["key"] + 1
    finally:
        fn.launches = before[0]
        flash_fn.mask_launches = before[1]


def _flash():
    from clip_embedder_tpu_torch.ops import flash

    return flash.flash_attention_packed

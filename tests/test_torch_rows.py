"""The routing of a block's LayerNorm and MLP activation to the single-pass
kernels of ``ops.rows`` (``csrc/block_rows.cu``), on the CPU: no JAX here.

* On a CPU tensor the kernel impls run the plain functions: ``mlp`` and
  ``block_forward`` give the eager path's MLP half bitwise.
* Under the card's gates (``rows.on_card`` true for a CPU tensor in f32 or
  bf16; the wrappers then run their plain versions) a kernel impl sends each
  block's MLP half, ``ln_pre``, ``ln_post`` and the map pool's LayerNorm
  and MLP to ``norm_rows`` and ``act_rows``, and keeps the plain functions
  for the eager impl, an operand that requires grad, a quantized MLP, a
  width or dtype the kernels do not take, relu and a strided view.
* The new source's kernel names stay out of every named kernel group of
  the benchmark's trace reader, so that their time shows as "other".

On the card, ``tests/test_torch_cuda.py`` holds the kernels against these
plain functions and ``chip_smoke.py`` times them at full size.
"""

import re
from pathlib import Path

import pytest
import torch

from clip_embedder_tpu_torch.models import text_transformer, vit
from clip_embedder_tpu_torch.ops import cuda, layers, rows
from clip_embedder_tpu_torch.ops.attention import multi_head_attention
from clip_embedder_tpu_torch.ops.quant import quantize_tree

SOURCE = Path(__file__).resolve().parents[1] / "clip_embedder_tpu_torch" / "csrc" / \
    "block_rows.cu"
ACTS = ("gelu", "gelu_tanh", "quick_gelu", "relu")


def _t(g, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g) * scale).to(dtype)


def _ln(g, d, dtype):
    return {"scale": 1 + _t(g, d, scale=0.1, dtype=dtype), "bias": _t(g, d, scale=0.1,
                                                                     dtype=dtype)}


def _mlp(g, d, hidden, dtype):
    return {"fc": {"w": _t(g, d, hidden, scale=d ** -0.5, dtype=dtype),
                   "b": _t(g, hidden, scale=0.1, dtype=dtype)},
            "proj": {"w": _t(g, hidden, d, scale=hidden ** -0.5, dtype=dtype),
                     "b": _t(g, d, scale=0.1, dtype=dtype)}}


def _block(g, d, hidden, dtype, layer_scale=False):
    p = {"ln1": _ln(g, d, dtype), "ln2": _ln(g, d, dtype), "mlp": _mlp(g, d, hidden, dtype),
         "attn": {n: {"w": _t(g, d, d, scale=d ** -0.5, dtype=dtype),
                      "b": _t(g, d, scale=0.1, dtype=dtype)} for n in ("q", "k", "v", "out")}}
    if layer_scale:
        p["ls1"], p["ls2"] = _t(g, d, scale=0.5, dtype=dtype), _t(g, d, scale=0.5, dtype=dtype)
    return p


@pytest.fixture()
def card_gates(monkeypatch):
    """The rows gate as on the card, for CPU tensors: ``norm_rows`` and
    ``act_rows`` (their plain versions on the CPU) where the card launches
    the kernels. Yields the calls they receive, by name."""
    monkeypatch.setattr(rows, "on_card", lambda x: x.dtype in cuda.DTYPE_CODES)
    calls = []
    for name in ("norm_rows", "act_rows"):
        fn = getattr(rows, name)
        monkeypatch.setattr(rows, name, lambda *a, _fn=fn, _n=name, **kw:
                            calls.append(_n) or _fn(*a, **kw))
    yield calls


@pytest.mark.parametrize("variant", ["plain", "pre_ln", "pre_ln_residual"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_impl_mlp_on_cpu_is_bitwise_eager(dtype, act, variant):
    g = torch.Generator().manual_seed(1)
    p, ln, x = _mlp(g, 64, 160, dtype), _ln(g, 64, dtype), _t(g, 2, 9, 64, dtype=dtype)
    kw = {"activation": layers.ACTIVATIONS[act], "ln_eps": 1e-6,
          "pre_ln": None if variant == "plain" else ln, "residual": variant.endswith("residual")}
    for impl in ("kernel", "kernel_fast"):
        assert torch.equal(layers.mlp(p, x, impl=impl, **kw), layers.mlp(p, x, **kw))


@pytest.mark.parametrize("layer_scale", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_impl_block_on_cpu_keeps_the_eager_mlp_half(dtype, layer_scale):
    """A kernel-impl block on CPU tensors: its attention half as before (the
    kernels' plain versions), then bitwise the eager MLP half."""
    g = torch.Generator().manual_seed(2)
    p, x = _block(g, 128, 256, dtype, layer_scale), _t(g, 2, 17, 128, dtype=dtype)
    act = layers.gelu_tanh
    got = vit.block_forward(p, x, heads=4, act=act, ln_eps=1e-6, impl="kernel")
    if layer_scale:
        h = multi_head_attention(p["attn"], x, num_heads=4, impl="kernel", pre_ln=p["ln1"],
                                 ln_eps=1e-6)
        x1 = x + h * p["ls1"]
        ref = x1 + layers.mlp(p["mlp"], x1, activation=act, pre_ln=p["ln2"],
                              ln_eps=1e-6) * p["ls2"]
    else:
        x1 = multi_head_attention(p["attn"], x, num_heads=4, impl="kernel", pre_ln=p["ln1"],
                                  ln_eps=1e-6, residual=x)
        ref = layers.mlp(p["mlp"], x1, activation=act, pre_ln=p["ln2"], ln_eps=1e-6,
                         residual=True)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "quick_gelu"])
@pytest.mark.parametrize("impl", ["kernel", "kernel_fast"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_gates_send_the_mlp_half_to_the_kernels(card_gates, dtype, impl, act):
    g = torch.Generator().manual_seed(3)
    p, ln, x = _mlp(g, 64, 160, dtype), _ln(g, 64, dtype), _t(g, 2, 9, 64, dtype=dtype)
    kw = {"activation": layers.ACTIVATIONS[act], "pre_ln": ln, "ln_eps": 1e-6,
          "residual": True}
    got = layers.mlp(p, x, impl=impl, **kw)
    assert card_gates == ["norm_rows", "act_rows"]
    assert torch.equal(got, layers.mlp(p, x, **kw))
    assert card_gates == ["norm_rows", "act_rows"]  # the eager impl: none


@pytest.mark.parametrize("case", ["eager", "x_requires_grad", "params_require_grad",
                                  "quantized", "width", "float16", "float64", "relu"])
def test_card_gates_keep_the_plain_route(card_gates, case):
    """What the kernels do not take keeps ``layer_norm`` and the plain
    activation: the eager impl, an operand that requires grad while autograd
    is on, a quantized MLP (its int8 routes as they were), a bf16 width of
    no whole 16-byte pieces (the activation, any shape, still takes its
    kernel), a dtype other than f32 and bf16, and relu."""
    g = torch.Generator().manual_seed(4)
    dtype = {"float16": torch.float16, "float64": torch.float64}.get(case, torch.bfloat16)
    d = 12 if case == "width" else 64
    p, ln, x = _mlp(g, d, 160, dtype), _ln(g, d, dtype), _t(g, 2, 9, d, dtype=dtype)
    act = layers.relu if case == "relu" else layers.gelu
    impl = "eager" if case == "eager" else "kernel"
    if case == "x_requires_grad":
        x.requires_grad_(True)
    if case == "params_require_grad":
        ln["scale"].requires_grad_(True)
    if case == "quantized":
        p = quantize_tree({"mlp": p})["mlp"]
        assert "w_q" in p["fc"]
    kw = {"activation": act, "pre_ln": ln, "ln_eps": 1e-6, "residual": True}
    got = layers.mlp(p, x, impl=impl, **kw)
    assert torch.equal(got, layers.mlp(p, x, **kw))
    want = {"width": ["act_rows"], "relu": ["norm_rows"]}.get(case, [])
    assert card_gates == want


def test_card_gates_keep_a_strided_view_plain(card_gates):
    g = torch.Generator().manual_seed(5)
    ln, x = _ln(g, 64, torch.bfloat16), _t(g, 3, 5, 64, dtype=torch.bfloat16)
    assert torch.equal(layers.norm(ln, x[:, 0], impl="kernel"), layers.layer_norm(ln, x[:, 0]))
    assert torch.equal(layers.activate(layers.gelu, x[:, 0], "kernel"), layers.gelu(x[:, 0]))
    assert card_gates == []
    layers.norm(ln, x[:, 0].contiguous(), impl="kernel")
    assert card_gates == ["norm_rows"]


VIT = dict(image_size=32, patch_size=8, width=128, layers=2, heads=4, mlp_hidden=256,
           embed_dim=64, activation="gelu_tanh", ln_eps=1e-6)
# pool → (norm_rows, act_rows) launches besides the blocks' one each: ln_pre,
# ln_post and the map pool's LayerNorm and MLP; a cls pool's ln_post reads a
# strided view (token 0 of every row) and stays plain
POOLS = {"map": (3, 1), "gap": (2, 0), "cls": (1, 0)}


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_gates_route_the_vision_tower(card_gates, pool, dtype):
    cls = pool == "cls"
    cfg = vit.ViTCfg(**VIT, pool=pool, use_ln_pre=True, use_class_token=cls, pos_embed_cls=cls)
    params = vit.init(cfg, generator=torch.Generator().manual_seed(6), dtype=dtype)
    tower = vit.ViT(cfg, params)
    pixels = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(7)).to(dtype)
    with torch.inference_mode():
        got = tower(pixels, attn_impl="kernel")
        norms, acts = card_gates.count("norm_rows"), card_gates.count("act_rows")
        eager_calls = len(card_gates)
        ref = tower(pixels, attn_impl="eager")
    assert (norms, acts) == (cfg.layers + POOLS[pool][0], cfg.layers + POOLS[pool][1])
    assert len(card_gates) == eager_calls  # the eager impl launches none
    # the kernel impl on the CPU: the kernels' plain versions throughout
    assert torch.allclose(got.float(), ref.float(), atol=2e-2 if dtype == torch.bfloat16
                          else 1e-5)


def test_card_gates_route_the_text_towers_blocks(card_gates):
    """The text tower shares ``Block``: its kernel-impl blocks take the
    kernels; its final LayerNorm stays plain."""
    cfg = text_transformer.TextCfgResolved(
        context_length=12, vocab_size=64, width=128, heads=4, layers=3, mlp_hidden=256,
        embed_dim=128, activation="gelu_tanh", causal=False, pool="last", ln_eps=1e-6)
    params = text_transformer.init(cfg, generator=torch.Generator().manual_seed(8),
                                   dtype=torch.bfloat16)
    tower = text_transformer.TextTransformer(cfg, params)
    ids = torch.randint(1, 64, (2, 12), generator=torch.Generator().manual_seed(9))
    with torch.inference_mode():
        got = tower(ids, attn_impl="kernel")
    assert card_gates == ["norm_rows", "act_rows"] * cfg.layers
    assert got.shape == (2, cfg.embed_dim) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_run_the_plain_functions_on_the_cpu(dtype):
    g = torch.Generator().manual_seed(10)
    ln, x = _ln(g, 64, dtype), _t(g, 3, 7, 64, scale=3.0, dtype=dtype)
    before = (rows.norm_rows.launches, rows.act_rows.launches)
    assert torch.equal(rows.norm_rows(ln, x, eps=1e-6), layers.layer_norm(ln, x, eps=1e-6))
    for name in rows.ACT_CODES:
        assert torch.equal(rows.act_rows(x, name), layers.ACTIVATIONS[name](x))
    assert (rows.norm_rows.launches, rows.act_rows.launches) == before
    with pytest.raises(ValueError, match="no kernel for activation"):
        rows.act_rows(x, "relu")


@pytest.mark.parametrize("dtype,width,fits", [
    (torch.bfloat16, 1152, True), (torch.bfloat16, 1536, True), (torch.float32, 1152, True),
    (torch.float32, 64, True), (torch.bfloat16, 8, True), (torch.bfloat16, 4096, True),
    (torch.float32, 2048, True), (torch.bfloat16, 4104, False), (torch.float32, 2052, False),
    (torch.bfloat16, 12, False), (torch.float32, 6, False)])
def test_norm_rows_widths(dtype, width, fits):
    """Whole 16-byte pieces, at most 512 of them (16 a lane of the warp that
    holds the row in its registers)."""
    assert rows.fits_norm(torch.empty(3, width, dtype=dtype, device="meta")) is fits


# the substrings by which the benchmark's trace reader
# (h100_bench/hbench/trace.py ``kernel_group``) puts a kernel in a named group
GROUP_KEYS = ("ln_kernel<", "qkv", "flash", "gemm", "nvjet", "cutlass", "xmma", "conv",
              "fprop", "cudnn", "winograd", "nhwc", "nchw", "i8::")


def test_kernel_names_stay_out_of_the_named_groups():
    """Every kernel of ``csrc/block_rows.cu`` and its namespace
    (``src_block_rows``, from ``ops.cuda.nvcc_flags``) is free of the
    group keys: the kernels count as "other" (``tower.eager_ms``) and never
    in ``ln_qkv_roofline``'s group."""
    text = SOURCE.read_text()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                         text)
    assert sorted(kernels) == ["act_kernel", "norm_kernel"]
    names = [f"src_{SOURCE.stem}::(anonymous namespace)::{k}<" for k in kernels]
    assert "-DCLIPK_SOURCE=src_block_rows" in cuda.nvcc_flags(SOURCE.stem)
    assert not [(n, key) for n in names for key in GROUP_KEYS if key in n.lower()]

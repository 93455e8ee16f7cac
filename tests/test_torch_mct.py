"""The port's MCT hybrid text tower (MobileCLIP-S0's ``mct``) against the JAX
package, on the CPU:

* ``models.mct.Mct`` on the JAX package's own parameters against JAX
  ``mct.apply`` in f32 (cosine > 1 - 1e-6, atol 1e-5), under ``int8`` /
  ``int8_all`` (1 - 1e-3, clip_embedder_tpu/ops/quant.py:5-6) and with the
  kernel impls' plain versions;
* ``resolve_text`` with a persisted ``mct_cfg`` and the tree layout check;
* a reference-format dir whose ``text.onnx`` is an MCT export
  (tests/test_mct.py's): ``TextEmbedder.from_local_dir`` derives the cfg
  from the graph, converts, self-checks and persists it, as the JAX
  package's does, with the same embeddings, config and ``text.npz``; a
  sabotaged recovery falls back to the executor; graphs that are not MCT
  are refused by the derivation.
"""

import dataclasses
import functools
import json
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_mct import CONV_BLOCKS, mct_onnx_dir  # noqa: E402, F401

from clip_embedder_tpu.config import ModelCfg as JModelCfg  # noqa: E402
from clip_embedder_tpu.models import build as jbuild  # noqa: E402
from clip_embedder_tpu.models import mct as jmct  # noqa: E402
from clip_embedder_tpu.ops.quant import quantize_tree_checked as jquantize  # noqa: E402
from clip_embedder_tpu.text import TextEmbedder as JTextEmbedder  # noqa: E402
from clip_embedder_tpu_torch import onnx_reader  # noqa: E402
from clip_embedder_tpu_torch import weights as tweights  # noqa: E402
from clip_embedder_tpu_torch.config import ModelCfg  # noqa: E402
from clip_embedder_tpu_torch.errors import WeightError  # noqa: E402
from clip_embedder_tpu_torch.models import build  # noqa: E402
from clip_embedder_tpu_torch.models.mct import Mct, MctCfg, dwconv1d, init  # noqa: E402
from clip_embedder_tpu_torch.ops.quant import quantize_tree_checked  # noqa: E402
from clip_embedder_tpu_torch.text import TextEmbedder  # noqa: E402

# width 128 with 4 heads x 32 (a 128-lane head group: the packed kernel's
# route under the kernel impls), two conv blocks, one with a ConvFFN
CFGS = {
    "causal_argmax": dict(context_length=12, vocab_size=64, width=128, heads=4, layers=2,
                          mlp_hidden=256, embed_dim=48, conv_blocks=((5, 192), (3, 0))),
    "bidirectional_last": dict(context_length=12, vocab_size=64, width=64, heads=4, layers=1,
                               mlp_hidden=128, embed_dim=32, conv_blocks=((7, 0), (3, 96)),
                               causal=False, pool="last", activation="gelu_tanh"),
    "proj_bias_k11": dict(context_length=16, vocab_size=50, width=64, heads=2, layers=2,
                          mlp_hidden=256, embed_dim=64, conv_blocks=((11, 256),),
                          proj_bias=True, ln_eps=1e-6),
}
TEXTS = ["a photo of a cat", "the dog", "cats and more cats on a mat"]


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    cfg = jmct.MctCfg(**CFGS[name])
    tree = jax.jit(functools.partial(jmct.init, cfg=cfg))(jax.random.key(0))
    return jax.tree.map(np.asarray, tree)


def jax_params(name):
    """The JAX ``init`` tree as numpy, its biases and LayerNorm affines
    drawn anew so that every one counts."""
    rng = np.random.default_rng(1)

    def redraw(path, a):
        if getattr(path[-1], "key", None) not in ("b", "scale", "bias"):
            return a
        return (a + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(redraw, _jax_init(name))


def ids_for(cfg, n=4, seed=2):
    ids = np.random.default_rng(seed).integers(1, cfg["vocab_size"] - 1,
                                               (n, cfg["context_length"]))
    ids[0, 5:] = 0  # a padded row
    ids[1, -1] = cfg["vocab_size"] - 1  # its EOT at the end
    return ids.astype(np.int32)


def run_port(name, params, ids, *, attn_impl="eager", dtype=torch.float32):
    tree = tweights.params_from_numpy(params, device="cpu", dtype=dtype)
    with torch.inference_mode():
        return Mct(MctCfg(**CFGS[name]), tree)(torch.from_numpy(ids),
                                               attn_impl=attn_impl).float().numpy()


def run_jax(name, params, ids, attn_impl="xla"):
    apply = jax.jit(functools.partial(jmct.apply, cfg=jmct.MctCfg(**CFGS[name]),
                                      attn_impl=attn_impl))
    return np.asarray(apply(jax.tree.map(jnp.asarray, params), jnp.asarray(ids)), np.float32)


@pytest.mark.parametrize("name", list(CFGS))
def test_mct_matches_jax_apply(name):
    params, ids = jax_params(name), ids_for(CFGS[name])
    got, ref = run_port(name, params, ids), run_jax(name, params, ids)
    assert got.shape == ref.shape == (4, CFGS[name]["embed_dim"])
    assert ((got * ref).sum(-1) > 1 - 1e-6).all()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
@pytest.mark.parametrize("name", ["causal_argmax", "proj_bias_k11"])
def test_mct_quantized_matches_jax(name, mode):
    """Each package quantizes the same f32 tree (the ConvFFN and the block
    MLPs; under int8_all the attention projections too)."""
    params, ids = jax_params(name), ids_for(CFGS[name])
    tree = tweights.params_from_numpy(params, device="cpu", dtype=torch.float32)
    q = quantize_tree_checked(tree, "mct", mode=mode)
    assert "w_q" in q["conv_blocks"][0]["ffn"]["fc"] and "w_q" in q["blocks"]["mlp"]["fc"]
    assert ("w_q" in q["blocks"]["attn"]["q"]) == (mode == "int8_all")
    with torch.inference_mode():
        got = Mct(MctCfg(**CFGS[name]), q)(torch.from_numpy(ids)).numpy()
    jq = jquantize(jax.tree.map(jnp.asarray, params), "mct", mode=mode)
    ref = np.asarray(jax.jit(functools.partial(jmct.apply, cfg=jmct.MctCfg(**CFGS[name])))(
        jq, jnp.asarray(ids)))
    assert ((got * ref).sum(-1) > 1 - 1e-3).all()


@pytest.mark.parametrize("impl", ["kernel", "kernel_fast"])
def test_mct_kernel_impls_match_jax_pallas(impl, monkeypatch):
    """The kernel impls (their plain versions on the CPU) against JAX's
    pallas impls with the kernels interpreted, at tests/test_flash.py's f32
    tolerance: the causal mask reaches the packed kernel as its shared
    [S, S] form. ``kernel_fast`` at head dim 32 (< 96) takes the bf16 exp,
    which rounds the softmax weights to bf16 in both packages: atol 1e-3,
    inside tests/test_torch_kernels.py's 2e-2 budget for it."""
    from clip_embedder_tpu.ops import flash as jflash

    for fn in ("flash_attention", "flash_attention_packed"):
        monkeypatch.setattr(jflash, fn, functools.partial(getattr(jflash, fn), interpret=True))
    name = "causal_argmax"
    params, ids = jax_params(name), ids_for(CFGS[name])
    got = run_port(name, params, ids, attn_impl=impl)
    ref = run_jax(name, params, ids, attn_impl={"kernel": "pallas",
                                                "kernel_fast": "pallas_fast"}[impl])
    if impl == "kernel":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-3)


def test_mct_bf16_matches_jax():
    name = "causal_argmax"
    params, ids = jax_params(name), ids_for(CFGS[name])
    got = run_port(name, params, ids, dtype=torch.bfloat16)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    ref = np.asarray(jax.jit(functools.partial(jmct.apply, cfg=jmct.MctCfg(**CFGS[name])))(
        bf, jnp.asarray(ids)), np.float32)
    assert ((got * ref).sum(-1) > 1 - 1e-3).all()


@pytest.mark.parametrize("k", [1, 3, 4, 11])
def test_dwconv1d_is_a_same_padded_depthwise_conv(k):
    """The k shifted multiplies are ``F.conv1d`` with groups = channels and
    padding (k-1)//2 on the left, k-1-(k-1)//2 on the right."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((2, 9, 6)).astype(np.float32))
    p = {"w": torch.from_numpy(rng.standard_normal((k, 6)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(6).astype(np.float32))}
    xp = torch.nn.functional.pad(x.transpose(1, 2), ((k - 1) // 2, k - 1 - (k - 1) // 2))
    ref = torch.nn.functional.conv1d(xp, p["w"].T[:, None, :], p["b"], groups=6).transpose(1, 2)
    torch.testing.assert_close(dwconv1d(p, x), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", list(CFGS))
def test_resolve_text_mct_cfg_matches_jax(name):
    """A persisted ``text_cfg.mct_cfg`` (JSON: the conv blocks as lists)
    resolves to the JAX package's spec."""
    raw = dict(CFGS[name], conv_blocks=[list(b) for b in CFGS[name]["conv_blocks"]])
    d = {"embed_dim": 32, "vision_cfg": {}, "text_cfg": {"mct_cfg": raw}}
    got = build.resolve_text(ModelCfg.from_dict(d))
    ref = jbuild.resolve_text(JModelCfg.from_dict(d))
    assert got.family == ref.family == "mct"
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(ref.cfg)
    assert got.cfg.conv_blocks == CFGS[name]["conv_blocks"]


def test_mct_tree_layout_is_checked():
    """The port's init has the JAX init's layout; the validator takes it
    and names what a broken tree lacks."""
    name = "causal_argmax"
    cfg = MctCfg(**CFGS[name])
    shapes = tweights._flat_shapes(init(cfg, device="meta"))
    assert shapes == tweights._flat_shapes(jax_params(name))
    spec = build.TowerSpec("mct", cfg)
    tree = jax_params(name)
    tweights.validate_tower_pytree(tree, spec, source="jax init")
    del tree["conv_blocks"][0]["ffn"]
    with pytest.raises(WeightError, match="missing: conv_blocks/0/ffn"):
        tweights.validate_tower_pytree(tree, spec, source="broken")


# -- the MCT dir through TextEmbedder --------------------------------------------

@pytest.fixture(scope="module")
def loaded(mct_onnx_dir, tmp_path_factory):  # noqa: F811
    """The MCT dir copied once per package and loaded by each in f32."""
    d, mirror = mct_onnx_dir
    base = tmp_path_factory.mktemp("mct_pair")
    pd, jd = base / "port", base / "jax"
    shutil.copytree(d, pd)
    shutil.copytree(d, jd)
    return (TextEmbedder.from_local_dir(pd, device="cpu"), JTextEmbedder.from_local_dir(jd),
            pd, jd, mirror)


def test_mct_dir_converts_like_jax(loaded):
    port, jax_emb, pd, jd, _ = loaded
    assert port.spec.family == jax_emb.spec.family == "mct"
    assert dataclasses.asdict(port.spec.cfg) == dataclasses.asdict(jax_emb.spec.cfg)
    assert port.spec.cfg.conv_blocks == CONV_BLOCKS
    # the derived cfg persisted, and the npz cache, array for array
    assert json.loads((pd / "open_clip_config.json").read_text()) == \
        json.loads((jd / "open_clip_config.json").read_text())
    a, b = np.load(pd / "text.npz"), np.load(jd / "text.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_mct_dir_embeddings_match_jax_and_the_mirror(loaded):
    port, jax_emb, _, _, mirror = loaded
    got, ref = port.embed_texts(TEXTS), jax_emb.embed_texts(TEXTS)
    assert ((got * ref).sum(-1) > 1 - 1e-6).all()
    np.testing.assert_allclose(got, ref, atol=5e-4)
    ids, _ = port.tokenize(TEXTS)
    with torch.no_grad():
        want = mirror(torch.from_numpy(np.asarray(ids).astype(np.int64))).numpy()
    np.testing.assert_allclose((got * want).sum(-1), 1.0, atol=1e-5)


def test_mct_dir_second_load_reads_the_npz(loaded, monkeypatch):
    """The next load resolves ``mct`` from the persisted cfg and reads
    ``text.npz`` without touching the graph."""
    port, _, pd, _, _ = loaded

    def no_graph(*a, **k):
        raise AssertionError("the graph was read again")

    monkeypatch.setattr(onnx_reader, "read_onnx", no_graph)
    again = TextEmbedder.from_local_dir(pd, device="cpu")
    assert again.spec.family == "mct"
    np.testing.assert_array_equal(again.embed_texts(TEXTS), port.embed_texts(TEXTS))


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_mct_dir_quantized_matches_jax(loaded, mode):
    _, _, pd, jd, _ = loaded
    got = TextEmbedder.from_local_dir(pd, device="cpu", quantize=mode).embed_texts(TEXTS)
    ref = JTextEmbedder.from_local_dir(jd, quantize=mode).embed_texts(TEXTS)
    assert ((got * ref).sum(-1) > 1 - 1e-3).all()


def test_sabotaged_mct_recovery_falls_back_to_the_executor(loaded, tmp_path, monkeypatch):
    """A recovery that misreads a weight fails the self-check: the load
    falls back to the executor (still the graph's embeddings), never the
    wrong tower."""
    _, jax_emb, pd, _, _ = loaded
    broken = tmp_path / "broken"
    shutil.copytree(pd, broken)
    (broken / "text.npz").unlink()
    occ = json.loads((broken / "open_clip_config.json").read_text())
    occ["model_cfg"]["text_cfg"].pop("mct_cfg")
    (broken / "open_clip_config.json").write_text(json.dumps(occ))
    orig = onnx_reader._structural_mct

    def corrupt(g, cfg):
        params = orig(g, cfg)
        params["proj"]["w"] = np.ascontiguousarray(params["proj"]["w"][::-1])
        return params

    monkeypatch.setattr(onnx_reader, "_structural_mct", corrupt)
    emb = TextEmbedder.from_local_dir(broken, device="cpu")
    assert emb.spec.family == "onnx"
    assert not (broken / "text.npz").exists()
    got, ref = emb.embed_texts(TEXTS), jax_emb.embed_texts(TEXTS)
    assert ((got * ref).sum(-1) > 1 - 1e-5).all()


def test_plain_transformer_graph_is_not_mct(loaded, tmp_path):
    """A plain text transformer must not lift to the hybrid family: the
    derivation refuses it with the JAX package's reason."""
    from test_mct import _NormText, _distinct
    from test_onnx_exec import export
    from torch_ref import TextTransformer

    torch.manual_seed(3)
    tt = _distinct(TextTransformer(12, 64, 64, 4, 2, 256, 32).eval())
    path = tmp_path / "text.onnx"
    export(_NormText(tt), torch.randint(4, 64, (2, 12)), path,
           input_name="input_ids", output_name="text_embeddings")
    with pytest.raises(WeightError, match="no depthwise 1-D conv"):
        onnx_reader.derive_mct_cfg(path)

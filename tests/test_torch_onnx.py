"""The port's ONNX reader and graph executor against the JAX package's, on
the CPU: ``read_onnx`` initializers array for array, every ``derive_*_cfg``
dict, the trees ``extract_tower_params`` recovers (with the port's
validation and self-check) and ``_structural_extract``'s, each case of
``tests/test_onnx_exec.py`` through ``onnx_exec`` (against torch and the JAX
executor, f32, bf16 and W8A8), the ``If`` scoping the port does not copy,
and the typed errors on malformed files. The graphs are the JAX tests' own
exports, built once for the module."""

import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

sys.path.insert(0, str(Path(__file__).parent))

from test_convert_verify import _TmpFactory, eva02_onnx_dir  # noqa: E402
from test_mct import mct_onnx_dir  # noqa: E402
from test_onnx_dir_e2e import (convnext_onnx_dir, fastvit_onnx_dir,  # noqa: E402
                               onnx_model_dir, resnet_onnx_dir)
from test_onnx_exec import (MctLikeTextTower, TinyConvTower, TinyTextTower,  # noqa: E402
                            export)
from test_onnx_exec import run_tower as jax_run_tower  # noqa: E402
from test_onnx_reader import _len_field, _varint_field, make_model, make_tensor  # noqa: E402

from clip_embedder_tpu import onnx_exec as jexec  # noqa: E402
from clip_embedder_tpu import onnx_reader as jreader  # noqa: E402
from clip_embedder_tpu.config import OpenClipConfig as JOpenClipConfig  # noqa: E402
from clip_embedder_tpu.models import build as jbuild  # noqa: E402
from clip_embedder_tpu.vision import _maybe_derive_vision_dims  # noqa: E402
from clip_embedder_tpu_torch import onnx_exec, onnx_reader  # noqa: E402
from clip_embedder_tpu_torch.config import OpenClipConfig  # noqa: E402
from clip_embedder_tpu_torch.errors import WeightError  # noqa: E402
from clip_embedder_tpu_torch.models import build  # noqa: E402
from clip_embedder_tpu_torch.vision import maybe_derive_vision_dims  # noqa: E402

# graph name → (fixture, tower file, tower, the derive function's name)
GRAPHS = {
    "vit": (onnx_model_dir, "visual", "visual", None),
    "text": (onnx_model_dir, "text", "text", None),
    "fastvit": (fastvit_onnx_dir, "visual", "visual", "derive_fastvit_cfg"),
    "convnext": (convnext_onnx_dir, "visual", "visual", "derive_convnext_cfg"),
    "resnet": (resnet_onnx_dir, "visual", "visual", "derive_resnet_cfg"),
    "eva02": (eva02_onnx_dir, "visual", "visual", "derive_eva02_cfg"),
    "mct": (mct_onnx_dir, "text", "text", "derive_mct_cfg"),
    "pe": (None, "visual", "visual", "derive_pe_cfg"),
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Each reference-format dir of the JAX tests, exported once: the
    graph name → its dir (configs untouched: no load has run on them)."""
    from test_pe_core import _build_pe_onnx_dir

    base = tmp_path_factory.mktemp("onnx_graphs")
    factory = _TmpFactory(base)
    built, out = {}, {}
    for name, (fixture, *_rest) in GRAPHS.items():
        if fixture is None:
            (base / "pe").mkdir()
            out[name] = _build_pe_onnx_dir(base / "pe", with_pe_cfg=False)[0]
            continue
        if fixture not in built:
            got = fixture.__wrapped__(factory)
            built[fixture] = got[0] if isinstance(got, tuple) else got
        out[name] = built[fixture]
    return out


def _graph(dirs, name) -> Path:
    return dirs[name] / f"{GRAPHS[name][1]}.onnx"


def _specs(dirs, name, tmp_path):
    """The port's and the JAX package's TowerSpec for a graph, each from its
    own copy of the dir after its own package's derivations."""
    src, tower = dirs[name], GRAPHS[name][2]
    pd, jd = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(src, pd)
    shutil.copytree(src, jd)
    pcfg = OpenClipConfig.from_file(pd / "open_clip_config.json")
    jcfg = JOpenClipConfig.from_file(jd / "open_clip_config.json")
    if tower == "visual":
        maybe_derive_vision_dims(pd, pcfg)
        _maybe_derive_vision_dims(jd, jcfg)
        return build.resolve_vision(pcfg.model_cfg), jbuild.resolve_vision(jcfg.model_cfg)
    if name == "mct":
        from clip_embedder_tpu.models.mct import MctCfg as JMctCfg
        from clip_embedder_tpu_torch.models.mct import MctCfg

        raw = onnx_reader.derive_mct_cfg(_graph(dirs, name))
        return build.TowerSpec("mct", MctCfg(**raw)), jbuild.TowerSpec("mct", JMctCfg(**raw))
    return build.resolve_text(pcfg.model_cfg), jbuild.resolve_text(jcfg.model_cfg)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def assert_trees_equal(got, ref):
    g, r = _flat(got), _flat(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k].shape == r[k].shape and g[k].dtype == r[k].dtype, k
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def _nodes(g):
    return [(op, list(i), list(o), sorted(a)) for op, i, o, a in g.nodes]


# -- reader ---------------------------------------------------------------------

@pytest.mark.parametrize("name", list(GRAPHS))
def test_read_onnx_equals_jax(dirs, name):
    path = _graph(dirs, name)
    got, ref = onnx_reader.read_onnx(path), jreader.read_onnx(path)
    assert list(got.initializers) == list(ref.initializers)
    for k, v in ref.initializers.items():
        assert got.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(got.initializers[k], v, err_msg=k)
    assert _nodes(got) == _nodes(ref)
    assert (got.inputs, got.outputs) == (ref.inputs, ref.outputs)


def test_read_onnx_raw_external_bf16_equals_jax(tmp_path):
    """The JAX reader test's hand-built tensors: raw, external-data and
    bfloat16 initializers."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    c = rng.standard_normal((2, 2)).astype(np.float32)
    (tmp_path / "m.onnx.data").write_bytes(b"\0" * 8 + b.tobytes())
    bf = (c.view(np.uint32) >> 16).astype(np.uint16)
    tensors = [make_tensor("a", a), make_tensor("b", b, external="m.onnx.data", offset=8),
               make_tensor("c", bf.view(np.float16), bfloat16=True),
               make_tensor("i", np.arange(6, dtype=np.int64).reshape(2, 3))]
    (tmp_path / "m.onnx").write_bytes(make_model(tensors))
    got = onnx_reader.read_onnx(tmp_path / "m.onnx").initializers
    ref = jreader.read_onnx(tmp_path / "m.onnx").initializers
    assert list(got) == list(ref) == ["a", "b", "c", "i"]
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("name", [n for n, g in GRAPHS.items() if g[3]])
def test_derive_cfg_equals_jax(dirs, name):
    fn = GRAPHS[name][3]
    path = _graph(dirs, name)
    assert getattr(onnx_reader, fn)(path) == getattr(jreader, fn)(path)


def test_derive_rejects_what_jax_rejects(dirs):
    """A plain text transformer does not lift to the MCT family, nor a ViT
    to ConvNeXt: the same WeightError as the JAX package."""
    for fn, name in (("derive_mct_cfg", "text"), ("derive_convnext_cfg", "vit")):
        path = _graph(dirs, name)
        with pytest.raises(WeightError) as got:
            getattr(onnx_reader, fn)(path)
        with pytest.raises(Exception) as ref:
            getattr(jreader, fn)(path)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_extract_tower_params_equals_jax(dirs, name, tmp_path, monkeypatch):
    """The tree each package converts the graph to (name-mapped or
    structural, whichever it takes) is the same array for array; the
    port's also passed its layout check and its self-check against the
    executor. (The JAX package's own self-check is left out here: it does
    not change the tree, and ``tests/test_torch_onnx_dirs.py`` runs it
    through the JAX ``Clip``.)"""
    monkeypatch.setattr(jreader, "probe_verify", lambda *a, **k: None)
    pspec, jspec = _specs(dirs, name, tmp_path)
    path, tower = _graph(dirs, name), GRAPHS[name][2]
    got = onnx_reader.extract_tower_params(path, pspec, tower=tower)
    ref = jreader.extract_tower_params(path, jspec, tower=tower)
    assert_trees_equal(got, ref)


@pytest.mark.parametrize("name", ["vit", "text", "fastvit", "convnext", "resnet", "eva02", "mct"])
def test_structural_extract_equals_jax(dirs, name, tmp_path):
    """Structural recovery alone (the route constant-folded exports take),
    also on graphs whose names would allow the name-mapped route."""
    pspec, jspec = _specs(dirs, name, tmp_path)
    path, tower = _graph(dirs, name), GRAPHS[name][2]
    got = onnx_reader._structural_extract(onnx_reader.read_onnx(path), pspec, tower=tower)
    ref = jreader._structural_extract(jreader.read_onnx(path), jspec, tower=tower)
    assert_trees_equal(got, ref)


def test_probe_verify_refuses_corrupt_tree(dirs, tmp_path):
    """probe_verify itself rejects a tree whose projection rows are
    reversed (every shape still valid) with the JAX package's message."""
    pspec, _ = _specs(dirs, "vit", tmp_path)
    path = _graph(dirs, "vit")
    params = onnx_reader.extract_tower_params(path, pspec, tower="visual")
    params["proj"]["w"] = np.ascontiguousarray(params["proj"]["w"][::-1])
    with pytest.raises(WeightError, match="self-check failed"):
        onnx_reader.probe_verify(path, pspec, tower="visual", params=params)


def test_probe_verify_accepts_unverified_when_the_executor_fails(dirs, tmp_path, monkeypatch,
                                                                 caplog):
    """An executor that cannot run the graph leaves nothing to check
    against: the conversion is accepted with a warning, as in the JAX
    package."""
    import logging

    from clip_embedder_tpu_torch.utils.logging import _warned_once

    pspec, _ = _specs(dirs, "vit", tmp_path)
    path = _graph(dirs, "vit")
    params = onnx_reader.extract_tower_params(path, pspec, tower="visual")

    def boom(*a, **k):
        raise RuntimeError("unsupported op")

    monkeypatch.setattr(onnx_exec, "OnnxTower", boom)
    _warned_once.clear()
    with caplog.at_level(logging.WARNING):
        onnx_reader.probe_verify(path, pspec, tower="visual", params=params)
    assert any("accepting unverified" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("data,match", [
    (b"", "No graph"),
    (b"\x12\x34\x56\x78" * 100, "wire type"),
    (bytes([0x3a, 0xff, 0xff, 0xff, 0x7f]) + b"abc", "Truncated"),
])
def test_malformed_onnx_raises_typed_error(tmp_path, data, match):
    p = tmp_path / "bad.onnx"
    p.write_bytes(data)
    with pytest.raises(WeightError, match=match):
        onnx_reader.read_onnx(p)
    with pytest.raises(Exception, match=match):
        jreader.read_onnx(p)


def test_truncated_export_raises_weight_error(dirs, tmp_path):
    """A real export cut short (a truncated download) raises the typed
    WeightError, in the reader and in the executor's constructor."""
    data = _graph(dirs, "vit").read_bytes()
    p = tmp_path / "visual.onnx"
    p.write_bytes(data[: len(data) // 2])
    with pytest.raises(WeightError):
        onnx_reader.read_onnx(p)
    with pytest.raises(WeightError):
        onnx_exec.OnnxTower(p)


# -- executor -------------------------------------------------------------------

def _rand_tower(seed):
    """tests/test_onnx_exec.py's fuzz tower for ``seed``."""
    rng = np.random.default_rng(seed)
    torch.manual_seed(seed)

    class RandTower(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(3, 8, 3, stride=2, padding=int(rng.integers(0, 2)))
            self.bn = nn.BatchNorm2d(8)
            self.act1 = [nn.GELU(), nn.SiLU(), nn.ReLU(), nn.Hardswish()][int(rng.integers(0, 4))]
            self.pool = [nn.MaxPool2d(2, ceil_mode=bool(rng.integers(0, 2))),
                         nn.AvgPool2d(2)][int(rng.integers(0, 2))]
            width = int(rng.integers(2, 5)) * 16
            self.proj_in = nn.Linear(8, width)
            self.ln = nn.LayerNorm(width)
            self.attn = nn.MultiheadAttention(width, 4, batch_first=True)
            self.mlp = nn.Sequential(nn.Linear(width, width * 2),
                                     [nn.GELU(), nn.Tanh()][int(rng.integers(0, 2))],
                                     nn.Linear(width * 2, width))
            self.head = nn.Linear(width, 12)
            self.res = bool(rng.integers(0, 2))

        def forward(self, x):
            y = self.pool(self.act1(self.bn(self.conv(x))))
            y = y.flatten(2).transpose(1, 2)
            y = self.ln(self.proj_in(y))
            a, _ = self.attn(y, y, y, need_weights=False)
            y = y + a if self.res else a
            y = y + self.mlp(self.ln(y)) if self.res else self.mlp(y)
            return F.normalize(self.head(y.mean(dim=1)), dim=-1)

    return RandTower().eval(), torch.randn(2, 3, 26, 26)


def _bn_model():
    torch.manual_seed(5)
    bn = nn.BatchNorm1d(8, eps=1e-3)
    bn.weight.data.uniform_(0.5, 1.5)
    bn.bias.data.uniform_(-1, 1)
    bn.running_mean.uniform_(-1, 1)
    bn.running_var.uniform_(0.5, 2.0)
    return nn.Sequential(nn.Linear(8, 8), bn).eval(), torch.randn(4, 8)


class _PadPool(nn.Module):
    def forward(self, x):
        y = F.pad(x, (1, 1, 1, 1), mode="reflect")
        return F.max_pool2d(y, 3, stride=2, ceil_mode=True).flatten(1)


def _seeded(seed, model, x):
    torch.manual_seed(seed)
    return model().eval(), x()


# case → (what makes the model and its input, input name, the JAX test's tolerance)
EXEC_CASES = {
    "mlp_layernorm_gelu": (lambda: _seeded(0, lambda: nn.Sequential(
        nn.Linear(32, 64), nn.GELU(), nn.LayerNorm(64), nn.Linear(64, 16),
        nn.Softmax(dim=-1)), lambda: torch.randn(3, 32)), "input", 2e-5),
    "text_argmax_pool": (lambda: _seeded(1, TinyTextTower,
                                         lambda: torch.randint(0, 64, (2, 12))), "input_ids", 5e-5),
    "mct_like_hybrid": (lambda: _seeded(2, MctLikeTextTower,
                                        lambda: torch.randint(0, 64, (2, 12))), "input_ids", 5e-5),
    "conv_tower": (lambda: _seeded(3, TinyConvTower, lambda: torch.randn(2, 3, 16, 16)),
                   "pixel_values", 5e-5),
    "batchnorm_epsilon": (_bn_model, "input", 5e-5),
    "pad_reflect_ceil_pool": (lambda: (_PadPool().eval(), torch.randn(2, 3, 11, 11)),
                              "input", 1e-6),
    "avgpool_ceil_include_pad": (lambda: (nn.AvgPool2d(3, stride=2, padding=1, ceil_mode=True,
                                                       count_include_pad=True).eval(),
                                          torch.randn(2, 3, 10, 10)), "input", 1e-6),
    "avgpool_ceil_exclude_pad": (lambda: (nn.AvgPool2d(3, stride=2, padding=1, ceil_mode=True,
                                                       count_include_pad=False).eval(),
                                          torch.randn(1, 2, 10, 10)), "input", 1e-6),
    **{f"fuzz_{s}": ((lambda s=s: _rand_tower(s)), "input", 5e-4) for s in range(6)},
}


@pytest.mark.parametrize("case", list(EXEC_CASES))
def test_executor_matches_torch_and_jax(case, tmp_path):
    """Each executor case of tests/test_onnx_exec.py: the port's executor
    against torch at atol 2e-5, and against the JAX executor at the JAX
    test's own tolerance against torch."""
    make, input_name, tol = EXEC_CASES[case]
    model, x = make()
    path = tmp_path / f"{case}.onnx"
    export(model, x, path, input_name=input_name)
    with torch.no_grad():
        ref = model(x).numpy()
    got = onnx_exec.OnnxTower(path)({input_name: x}).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    jgot = jax_run_tower(path, {input_name: jnp.asarray(x.numpy())})
    np.testing.assert_allclose(got, jgot, atol=tol)


def _graph_proto(nodes, *, inits=(), inputs=(), outputs=()) -> bytes:
    g = b"".join(_len_field(1, n) for n in nodes)
    g += b"".join(_len_field(5, t) for t in inits)
    g += b"".join(_len_field(11, _len_field(1, n.encode())) for n in inputs)
    g += b"".join(_len_field(12, _len_field(1, n.encode())) for n in outputs)
    return g


def _node(op, inputs, outputs, attrs=b"") -> bytes:
    body = b"".join(_len_field(1, i.encode()) for i in inputs)
    body += b"".join(_len_field(2, o.encode()) for o in outputs)
    return body + _len_field(4, op.encode()) + attrs


def _graph_attr(name: str, graph: bytes) -> bytes:
    return _len_field(5, _len_field(1, name.encode()) + _len_field(6, graph)
                      + _varint_field(20, 5))


def _true_constant(out: str) -> bytes:
    tensor = _varint_field(2, 9) + _len_field(9, b"\x01")  # a bool scalar, True
    return _node("Constant", [], [out],
                 _len_field(5, _len_field(1, b"value") + _len_field(5, tensor)
                            + _varint_field(20, 4)))


def test_if_branch_initializers_shadow_outer_values(tmp_path):
    """ONNX scoping: a name a branch defines itself (here an initializer
    ``w``) shadows the enclosing graph's value of that name. The JAX
    executor lets the outer value win (it runs the branch with the outer
    values as its feeds, which overwrite the branch's initializers); the
    port's executor takes the branch's own."""
    ones = np.ones(3, np.float32)
    then_g = _graph_proto([_node("Mul", ["x", "w"], ["y_then"])],
                          inits=[make_tensor("w", 2 * ones)], outputs=["y_then"])
    else_g = _graph_proto([_node("Mul", ["x", "w"], ["y_else"])], outputs=["y_else"])
    main = _graph_proto(
        [_true_constant("cond"),
         _node("If", ["cond"], ["y"], _graph_attr("then_branch", then_g)
               + _graph_attr("else_branch", else_g))],
        inits=[make_tensor("w", ones)], inputs=["x"], outputs=["y"])
    path = tmp_path / "scoped_if.onnx"
    path.write_bytes(_varint_field(1, 8) + _len_field(7, main))
    x = np.arange(3, dtype=np.float32) + 1

    got = onnx_exec.OnnxTower(path)({"x": torch.from_numpy(x)}).numpy()
    np.testing.assert_array_equal(got, 2 * x)  # the branch's w
    jt = jexec.OnnxTower(path)
    ref = np.asarray(jt(dict(jt.params), {"x": jnp.asarray(x)}))
    np.testing.assert_array_equal(ref, x)  # the JAX design: the outer w


def test_if_on_a_host_folded_condition(tmp_path):
    """``If`` over a condition folded on the host from the input's shape
    (Shape → Gather → Equal, the pattern torch exports guard shape-dependent
    paths with): the else branch here, which reads an outer value."""
    ones = np.ones(3, np.float32)
    then_g = _graph_proto([_node("Add", ["x", "w"], ["y_then"])], outputs=["y_then"])
    else_g = _graph_proto([_node("Mul", ["x", "w"], ["y_else"])], outputs=["y_else"])
    main = _graph_proto(
        [_node("Shape", ["x"], ["shape"]), _node("Gather", ["shape", "zero"], ["n"]),
         _node("Equal", ["n", "seven"], ["cond"]),
         _node("If", ["cond"], ["y"], _graph_attr("then_branch", then_g)
               + _graph_attr("else_branch", else_g))],
        inits=[make_tensor("w", 3 * ones), make_tensor("zero", np.array(0, np.int64)),
               make_tensor("seven", np.array(7, np.int64))],
        inputs=["x"], outputs=["y"])
    path = tmp_path / "shape_if.onnx"
    path.write_bytes(_varint_field(1, 8) + _len_field(7, main))
    x = np.arange(3, dtype=np.float32)
    got = onnx_exec.OnnxTower(path)({"x": torch.from_numpy(x)}).numpy()
    np.testing.assert_array_equal(got, 3 * x)
    jt = jexec.OnnxTower(path)
    np.testing.assert_array_equal(np.asarray(jt(dict(jt.params), {"x": jnp.asarray(x)})), 3 * x)


@pytest.fixture(scope="module")
def hybrid_graph(tmp_path_factory):
    """tests/test_onnx_exec.py's MCT-like hybrid at width 64: its MatMul
    weights reach the executor's quantization floor."""
    path = tmp_path_factory.mktemp("hybrid") / "text.onnx"
    torch.manual_seed(9)
    export(MctLikeTextTower(vocab=64, ctx=12, dim=64).eval(), torch.randint(0, 64, (2, 12)),
           path, input_name="input_ids", output_name="text_embeddings")
    ids = np.random.default_rng(4).integers(0, 64, (4, 12)).astype(np.int64)
    return path, ids


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_executor_modes_match_jax(hybrid_graph, mode):
    """The executor's compute-dtype and W8A8 modes against the JAX
    executor's, on the same graph and ids (1 - 1e-3, the int8 budget of
    clip_embedder_tpu/ops/quant.py:5-6); both quantize the same weights."""
    path, ids = hybrid_graph
    kw = ({"compute_dtype": torch.bfloat16} if mode == "bf16" else {"quantize": True})
    jkw = ({"compute_dtype": "bfloat16"} if mode == "bf16" else {"quantize": True})
    tower = onnx_exec.OnnxTower(path, **kw)
    got = F.normalize(tower({"input_ids": torch.from_numpy(ids)}).float(), dim=-1).numpy()
    jt = jexec.OnnxTower(path, **jkw)
    ref = np.asarray(jax.jit(jt)({k: jnp.asarray(v) for k, v in jt.params.items()},
                                 {"input_ids": jnp.asarray(ids)}), np.float32)
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    assert ((got * ref).sum(-1) > 1 - 1e-3).all()
    if mode == "int8":
        assert tower.quant_names == jt.quant_names and tower.quant_names
        for n in tower.quant_names:
            np.testing.assert_array_equal(tower.params[n + "#q"].numpy(), jt.params[n + "#q"])
            np.testing.assert_array_equal(tower.params[n + "#scale"].numpy(),
                                          jt.params[n + "#scale"])


def test_executor_int8_nothing_to_quantize_raises(tmp_path):
    """A quantized mode over a graph with no eligible MatMul weight raises
    (``load_tower``), as the JAX package's loaders do."""
    from clip_embedder_tpu_torch.errors import ConfigError

    path = tmp_path / "narrow.onnx"
    torch.manual_seed(10)
    export(MctLikeTextTower(vocab=64, ctx=12, dim=32).eval(), torch.randint(0, 64, (2, 12)),
           path, input_name="input_ids")
    with pytest.raises(ConfigError, match="quantiz"):
        onnx_exec.load_tower(onnx_exec.fallback_cfg(path, quantize="int8"), "cpu")


def test_unsupported_op_raises(tmp_path):
    """An op outside the executor's table raises WeightError naming it."""
    main = _graph_proto([_node("DFT", ["x"], ["y"])], inputs=["x"], outputs=["y"])
    path = tmp_path / "dft.onnx"
    path.write_bytes(_varint_field(1, 8) + _len_field(7, main))
    with pytest.raises(WeightError, match="unsupported op 'DFT'"):
        onnx_exec.OnnxTower(path)({"x": torch.ones(2, 8)})


@pytest.mark.parametrize("start,end,step,want", [
    (-1, -(2 ** 63) + 1, -1, [4, 3, 2, 1, 0]),  # torch Flip's reverse slice
    (0, -1000, 1, []),                          # an end far below 0: empty
    (0, -1, 1, [0, 1, 2, 3]),                   # end -1: before the last
    (3, 0, -2, [3, 1]),
])
def test_slice_semantics_on_host_and_device_values(start, end, step, want):
    """ONNX Slice on a host constant (numpy) and on a tensor (negative
    steps gather), as the JAX executor computes it."""
    args = {"st": np.array([start]), "en": np.array([end]), "ax": np.array([0]),
            "sp": np.array([step])}
    names = ["x", "st", "en", "ax", "sp"]
    env = onnx_exec._Env(torch.device("cpu"))
    env.update(args, x=np.arange(5))
    np.testing.assert_array_equal(onnx_exec._slice_op(env, names, {}), want)
    env["x"] = torch.arange(5)
    np.testing.assert_array_equal(onnx_exec._slice_op(env, names, {}).numpy(), want)
    np.testing.assert_array_equal(jexec._slice_op({"x": np.arange(5), **args}, names, {}), want)


@pytest.mark.parametrize("mode", [b"constant", b"reflect", b"edge", b"wrap"])
def test_pad_modes_match_jax(mode):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    pads = np.asarray([1, 2, 2, 1])
    env = onnx_exec._Env(torch.device("cpu"))
    env.update(x=torch.from_numpy(x), pads=pads)
    got = onnx_exec._pad_op(env, ["x", "pads"], {"mode": mode}).numpy()
    ref = np.asarray(jexec._pad_op({"x": jnp.asarray(x), "pads": pads}, ["x", "pads"],
                                   {"mode": mode}))
    np.testing.assert_array_equal(got, ref)


def test_pad_unsupported_mode_raises():
    env = onnx_exec._Env(torch.device("cpu"))
    env.update(x=torch.ones(1, 4), pads=np.asarray([0, 1, 0, 1]))
    with pytest.raises(WeightError, match="Pad mode"):
        onnx_exec._pad_op(env, ["x", "pads"], {"mode": b"hypercube"})


def test_div_min_max_pow_semantics():
    """Integer Div truncates toward zero; Min/Max are variadic; Pow
    computes in the promoted type and returns the base's dtype."""
    got = onnx_exec._div(torch.tensor([-7, 7, -1]), torch.tensor([2, -2, 3]))
    np.testing.assert_array_equal(got.numpy(), [-3, -3, 0])
    np.testing.assert_allclose(onnx_exec._div(torch.tensor([-7.0]), torch.tensor([2.0])), [-3.5])
    env = onnx_exec._Env(torch.device("cpu"))
    env.update(a=torch.tensor([3.0, -1.0]), b=torch.tensor([2.0, 5.0]), c=torch.tensor([1.0, 0.0]))
    np.testing.assert_array_equal(onnx_exec._OPS["Min"](env, ["a", "b", "c"], {}), [1.0, -1.0])
    np.testing.assert_array_equal(onnx_exec._OPS["Max"](env, ["a", "b", "c"], {}), [3.0, 5.0])
    got = onnx_exec._pow(torch.tensor([4, 9], dtype=torch.int32), torch.tensor(0.5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [2, 3])


def test_fallback_cfg_maps_the_embedder_knobs(dirs):
    path = _graph(dirs, "vit")
    assert onnx_exec.fallback_cfg(path).compute_dtype is None
    assert onnx_exec.fallback_cfg(path, dtype=torch.bfloat16).compute_dtype == "bfloat16"
    assert onnx_exec.fallback_cfg(path, dtype=torch.float32).compute_dtype is None
    for mode, on in ((None, False), ("int8", True), ("int8_all", True)):
        assert onnx_exec.fallback_cfg(path, quantize=mode).quantize is on
    a, b = onnx_exec.fallback_cfg(path), onnx_exec.fallback_cfg(path)
    assert a == b and hash(a) == hash(b)
    assert onnx_exec.get_tower(a) is onnx_exec.get_tower(b)  # parsed once

"""The torch port's scale-out layer (``clip_embedder_tpu_torch.parallel``)
against the JAX package's, on the CPU.

The JAX side runs on conftest's 8 virtual devices
(``clip_embedder_tpu.parallel.get_mesh(model_parallel=2)``); the port side
on a mesh of eight ``"cpu"`` entries, 4 x 2. Weights cross through the
port's ``params_from_numpy`` (towers) or a model dir both packages load
(embedders). The cases of tests/test_parallel.py but the train ones, at
its small dims, plus what the port adds: the row-parallel biases and the
residual applied once, PE-Core's rope over the model ranks, heads the ranks
do not divide (on a 1 x 8 mesh), and the ``ConfigError`` on widths the
ranks do not divide, which JAX refuses too.
"""

import dataclasses
import logging
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from clip_embedder_tpu import Clip as JClip
from clip_embedder_tpu.models import text_transformer as jtext
from clip_embedder_tpu.models import vit as jvit
from clip_embedder_tpu.parallel import ShardedTextEmbedder as JShardedText
from clip_embedder_tpu.parallel import ShardedVisionEmbedder as JShardedVision
from clip_embedder_tpu.parallel import get_mesh as jget_mesh
from clip_embedder_tpu.parallel.sharding import tp_param_specs as jtp_param_specs
from clip_embedder_tpu_torch import Clip
from clip_embedder_tpu_torch.errors import ClipError, ConfigError, DeviceError
from clip_embedder_tpu_torch.models import text_transformer as ttext
from clip_embedder_tpu_torch.models import vit as tvit
from clip_embedder_tpu_torch.parallel import (CorpusIndex, EmbedPipeline, ShardedTextEmbedder,
                                              ShardedVisionEmbedder, get_mesh, replicate,
                                              select_platform, shard_batch, tp_param_specs)
from clip_embedder_tpu_torch.parallel import mesh as tmesh
from clip_embedder_tpu_torch.parallel.sharding import Spec
from clip_embedder_tpu_torch.parallel import tensor_parallel as tp
from clip_embedder_tpu_torch.utils import logging as tlogging
from clip_embedder_tpu_torch.weights import params_from_numpy

from test_concurrency import make_model_dir

VCFG = jvit.ViTCfg(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                   mlp_hidden=128, embed_dim=32)
TCFG = jtext.TextCfgResolved(context_length=16, vocab_size=128, width=64, heads=4,
                             layers=2, mlp_hidden=128, embed_dim=32)
# the SigLIP layout (map pool, layer scale) and PE-Core's 2-D rope
SIGLIP_LS = jvit.ViTCfg(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                        mlp_hidden=128, embed_dim=64, activation="gelu_tanh",
                        use_class_token=False, use_ln_pre=False, pool="map",
                        use_proj=False, ln_eps=1e-6, pos_embed_cls=False,
                        use_layer_scale=True)
PE_ROPE = jvit.ViTCfg(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                      mlp_hidden=128, embed_dim=32, activation="gelu", pool="map",
                      rope_2d=True, pool_heads=4, ln_eps=1e-5)
COCA_V = jvit.ViTCfg(image_size=32, patch_size=8, width=64, layers=2, heads=4,
                     mlp_hidden=128, embed_dim=32, pool="attn", attn_pool_queries=8,
                     attn_pool_dim=32, pool_heads=4)
COCA_T = jtext.TextCfgResolved(context_length=16, vocab_size=128, width=64, heads=4,
                               layers=2, mlp_hidden=128, embed_dim=32, pool="last",
                               embed_cls=True)
ATOL = 2e-5  # the bound tests/test_parallel.py holds its own sharding to


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jget_mesh(model_parallel=2)


@pytest.fixture(scope="module")
def mesh():
    return get_mesh(devices=["cpu"] * 8, model_parallel=2)


@pytest.fixture(scope="module")
def clip_pair():
    d = make_model_dir()
    return JClip.from_local_dir(d), Clip.from_local_dir(d, device="cpu"), d


def _port_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _jax_params(init, cfg, seed):
    return jax.tree.map(np.asarray, init(jax.random.key(seed), cfg))


def _with_biases(params, seed):
    """Every bias of a tree set to random values (init leaves them 0, which
    would hide a bias added more than once)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                    if k == "b" else v) for k, v in tree.items()}
    return walk(params)


def _jax_tp(mesh, params, apply, x):
    """The JAX package's own TP forward (GSPMD over tp_param_specs)."""
    specs = jtp_param_specs(params, tower="vit" if "patch_embed" in params else "text")
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda s: isinstance(s, P))
    fn = jax.jit(apply, in_shardings=(shardings, NamedSharding(mesh, P("data"))),
                 out_shardings=NamedSharding(mesh, P("data")))
    return np.asarray(fn(jax.device_put(params, shardings),
                         jax.device_put(x, NamedSharding(mesh, P("data")))))


def _tp_row(mesh):
    return list(mesh.devices[0])


def cos(a, b):
    return np.sum(a * b, axis=-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


# -- mesh ----------------------------------------------------------------------

def test_mesh_shape(mesh, jmesh):
    assert dict(mesh.shape) == {"data": 4, "model": 2} == dict(jmesh.shape)
    assert mesh.devices.shape == (4, 2)
    assert mesh.distinct_devices() == [torch.device("cpu")]
    assert dict(get_mesh(devices=["cpu"] * 8).shape) == {"data": 8, "model": 1}


def test_mesh_helpers(mesh):
    with pytest.raises(DeviceError, match="does not divide"):
        get_mesh(devices=["cpu"] * 6, model_parallel=4)
    with pytest.raises(DeviceError, match="Unsupported device"):
        get_mesh(devices=["meta"] * 2)
    assert select_platform(["cpu"]) == "cpu"
    assert select_platform() in ("cuda", "cpu")
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        assert select_platform(["cuda"]) == "cpu"
        with pytest.raises(DeviceError, match="strict"):
            select_platform(["cuda"], strict=True)
    assert tmesh.pad_to_multiple(5, 4) == 8
    # one copy per distinct device: repeated entries share storage, and a
    # module is not moved in place
    tower = tvit.ViT(_port_cfg(tvit.ViTCfg, VCFG),
                     params_from_numpy(_jax_params(jvit.init, VCFG, 0), device="cpu",
                                       dtype=torch.float32))
    replicas = replicate(tower, mesh)
    assert list(replicas) == [torch.device("cpu")] and replicas[torch.device("cpu")] is tower
    tree = {"w": torch.ones(2, 2)}
    assert replicate(tree, mesh)[torch.device("cpu")]["w"] is tree["w"]
    shards = shard_batch(np.arange(8 * 3).reshape(8, 3), mesh)
    assert [s.shape for s in shards] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), np.arange(24).reshape(8, 3))
    with pytest.raises(DeviceError, match="does not split"):
        shard_batch(np.zeros((6, 2)), mesh)
    tmesh.init_distributed()  # no coordinator configured: logs and returns
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("jcfg,tower", [(COCA_V, "vit"), (SIGLIP_LS, "vit"), (TCFG, "text")],
                         ids=["coca_pool", "map_pool_layer_scale", "text"])
def test_tp_specs_match_jax(jcfg, tower):
    """The same tree of specs: a JAX ``P(..., "model", ...)`` is the port's
    ``Spec`` with that dimension, ``P()`` its ``REPL``."""
    init = jvit.init if tower == "vit" else jtext.init
    params = _jax_params(init, jcfg, 0)
    jspecs = jtp_param_specs(params, tower=tower)
    specs = tp_param_specs(params, tower=tower)
    jflat = jax.tree_util.tree_flatten_with_path(jspecs, is_leaf=lambda s: isinstance(s, P))[0]
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(s, Spec))[0]
    assert [p for p, _ in jflat] == [p for p, _ in flat]
    for (_, js), (_, s) in zip(jflat, flat):
        want = list(js).index("model") if "model" in tuple(js) else None
        assert s.dim == want, (js, s)
        assert (s.kind == "repl") == (want is None)


# -- towers: DP and TP ---------------------------------------------------------

def test_data_parallel_embed_matches_single(mesh, jmesh):
    params = _jax_params(jvit.init, VCFG, 0)
    x = np.array(jax.random.uniform(jax.random.key(1), (8, 32, 32, 3)))
    expect = np.asarray(jvit.apply(params, x, VCFG))
    tower = tvit.ViT(_port_cfg(tvit.ViTCfg, VCFG),
                     params_from_numpy(params, device="cpu", dtype=torch.float32))
    replicas = replicate(tower, mesh)
    with torch.inference_mode():
        single = tower(torch.from_numpy(x)).numpy()
        got = torch.cat([replicas[s.device](s) for s in shard_batch(x, mesh)]).numpy()
    np.testing.assert_allclose(got, single, atol=ATOL)
    np.testing.assert_allclose(got, expect, atol=ATOL)


@pytest.mark.parametrize("jcfg", [VCFG, COCA_V, SIGLIP_LS, PE_ROPE],
                         ids=["clip", "coca_pool", "map_pool_layer_scale", "pe_rope"])
def test_tensor_parallel_vit_matches_replicated(mesh, jmesh, jcfg):
    """The TP forward against the replicated one and against the JAX
    package's GSPMD TP forward; the biases random, so a bias or a residual
    added on every rank would show (see the next test)."""
    params = _with_biases(_jax_params(jvit.init, jcfg, 2), 3)
    x = np.array(jax.random.uniform(jax.random.key(3), (4, 32, 32, 3)))
    cfg = _port_cfg(tvit.ViTCfg, jcfg)
    tree = params_from_numpy(params, device="cpu", dtype=torch.float32)
    with torch.inference_mode():
        expect = tvit.ViT(cfg, tree)(torch.from_numpy(x)).numpy()
        got = tp.TPViT(cfg, tree, _tp_row(mesh))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, atol=ATOL)
    jgot = _jax_tp(jmesh, params, lambda p, xx: jvit.apply(p, xx, jcfg), x)
    np.testing.assert_allclose(got, jgot, atol=ATOL)


@pytest.mark.parametrize("jcfg", [TCFG, COCA_T], ids=["clip_text", "coca_text"])
def test_tensor_parallel_text_matches_replicated(mesh, jmesh, jcfg):
    params = _with_biases(_jax_params(jtext.init, jcfg, 4), 5)
    ids = np.array(jax.random.randint(jax.random.key(5), (4, 16), 1, 127))
    ids[1, 10:] = 0  # padding: CoCa's cls mask
    cfg = _port_cfg(ttext.TextCfgResolved, jcfg)
    tree = params_from_numpy(params, device="cpu", dtype=torch.float32)
    with torch.inference_mode():
        expect = ttext.TextTransformer(cfg, tree)(torch.from_numpy(ids)).numpy()
        got = tp.TPTextTransformer(cfg, tree, _tp_row(mesh))(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, expect, atol=ATOL)
    jgot = _jax_tp(jmesh, params, lambda p, i: jtext.apply(p, i, jcfg), ids)
    np.testing.assert_allclose(got, jgot, atol=ATOL)


def test_tensor_parallel_applies_row_bias_and_residual_once(mesh):
    """With every row-parallel linear carrying a bias, the TP forward
    matches the replicated one; the same forward with the biases left on
    each rank's local tree (so ``linear`` adds them once per rank) does not
    — the test sees a bias added twice. The block passes no residual into
    the ranks, so the residual is added once by construction; an unsharded
    out-projection with ``residual=x`` on each rank would add it twice,
    which the same comparison would see."""
    params = _with_biases(_jax_params(jvit.init, SIGLIP_LS, 6), 7)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 32, 32, 3))
                         .astype(np.float32))
    cfg = _port_cfg(tvit.ViTCfg, SIGLIP_LS)
    tree = params_from_numpy(params, device="cpu", dtype=torch.float32)
    row = _tp_row(mesh)
    with torch.inference_mode():
        expect = tvit.ViT(cfg, tree)(x, normalize=False)
        got = tp.TPViT(cfg, tree, row)(x, normalize=False)
        np.testing.assert_allclose(got.numpy(), expect.numpy(), atol=ATOL)
        with mock.patch.object(tp, "_strip_row_bias", lambda local, specs: local):
            twice = tp.TPViT(cfg, tree, row)(x, normalize=False)
        assert (twice - expect).abs().max() > 1e-2
        # one block alone: residual + attn + bias, each once
        blk_tree = {k: v for k, v in tp.tower_tree(tvit.ViT(cfg, tree))["blocks"].items()}
        specs = tp_param_specs({"blocks": blk_tree}, tower="vit")
        blocks = tp.tp_blocks({"blocks": blk_tree}, specs, row, layers=1, heads=cfg.heads,
                              activation=cfg.activation, ln_eps=cfg.ln_eps)
        h = torch.randn(2, 16, 64)
        ref = tvit.ViT(cfg, tree).blocks[0](h, impl="eager")
        np.testing.assert_allclose(blocks[0](h, impl="eager").numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("jcfg", [VCFG, SIGLIP_LS], ids=["clip", "map_pool_layer_scale"])
def test_tensor_parallel_takes_heads_the_ranks_do_not_divide(jcfg):
    """4 heads over 8 model ranks (ViT-B's 12 heads over 8, in small): the
    widths divide, the heads do not. GSPMD splits the H·D columns evenly;
    the port joins the ranks' q/k/v columns and runs the attention whole,
    in the blocks and in the MAP pooler, and matches the unsharded forward
    and the JAX package's TP forward on a 1 x 8 mesh."""
    params = _with_biases(_jax_params(jvit.init, jcfg, 2), 3)
    x = np.array(jax.random.uniform(jax.random.key(3), (4, 32, 32, 3)))
    cfg = _port_cfg(tvit.ViTCfg, jcfg)
    tree = params_from_numpy(params, device="cpu", dtype=torch.float32)
    row = _tp_row(get_mesh(devices=["cpu"] * 8, model_parallel=8))
    assert len(row) == 8 and cfg.heads % len(row)
    with torch.inference_mode():
        expect = tvit.ViT(cfg, tree)(torch.from_numpy(x)).numpy()
        got = tp.TPViT(cfg, tree, row)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, atol=ATOL)
    jgot = _jax_tp(jget_mesh(model_parallel=8), params, lambda p, xx: jvit.apply(p, xx, jcfg), x)
    np.testing.assert_allclose(got, jgot, atol=ATOL)


def test_tensor_parallel_refuses_indivisible_widths():
    """A width the model ranks do not divide (an MLP hidden of 130 over 4):
    the port raises ConfigError naming the leaf, and the JAX package's
    device_put of its tp_param_specs refuses the same sharding."""
    odd = dataclasses.replace(VCFG, mlp_hidden=130)
    jparams = _jax_params(jvit.init, odd, 0)
    params = params_from_numpy(jparams, device="cpu", dtype=torch.float32)
    with pytest.raises(ConfigError, match=r"blocks\.mlp\.fc\.[wb] has width 130"):
        tp.TPViT(_port_cfg(tvit.ViTCfg, odd), params, ["cpu"] * 4)
    jmesh4 = jget_mesh(model_parallel=4)
    shardings = jax.tree.map(lambda sp: NamedSharding(jmesh4, sp),
                             jtp_param_specs(jparams, tower="vit"),
                             is_leaf=lambda sp: isinstance(sp, P))
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(jparams, shardings)


# -- sharded embedders ---------------------------------------------------------

def test_sharded_bulk_embedders(mesh, jmesh, clip_pair):
    """ShardedVisionEmbedder / ShardedTextEmbedder agree with the
    single-device embedders and with the JAX sharded embedders; the
    [bucket, D] rows of ``embed_images_device`` stay a tensor, unread."""
    jclip, clip, _ = clip_pair
    rng = np.random.default_rng(1)
    images = [rng.integers(0, 255, size=(40 + i, 50, 3), dtype=np.uint8)
              for i in range(5)]  # 5 → padded to 8 on the data axis
    sharded_v = ShardedVisionEmbedder(clip.vision, mesh)
    got = sharded_v.embed_images(images)
    expect = clip.vision.embed_images(images)
    assert got.shape == expect.shape == (5, 32)
    assert (cos(got, expect) > 1 - 1e-5).all()
    assert (cos(got, JShardedVision(jclip.vision, jmesh).embed_images(images)) > 1 - 1e-5).all()
    embs, n = sharded_v.embed_images_device(images)
    assert isinstance(embs, torch.Tensor) and n == 5 and embs.shape == (8, 32)

    texts = ["a cat", "a dog", "the photo of a beignet"]
    got_t = ShardedTextEmbedder(clip.text, mesh).embed_texts(texts)
    assert (cos(got_t, clip.text.embed_texts(texts)) > 1 - 1e-5).all()
    assert (cos(got_t, JShardedText(jclip.text, jmesh).embed_texts(texts)) > 1 - 1e-5).all()


def test_sharded_tensor_parallel_embedder(mesh, jmesh, clip_pair):
    """TP through the embedder (vit family): the rows of the JAX TP
    embedder and of the single-device port embedder."""
    jclip, clip, _ = clip_pair
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 255, size=(36 + i, 44, 3), dtype=np.uint8) for i in range(6)]
    tp_v = ShardedVisionEmbedder(clip.vision, mesh, tensor_parallel=True)
    assert tp_v.tensor_parallel and isinstance(tp_v.towers[0], tp.TPViT)
    got = tp_v.embed_images(images)
    assert (cos(got, clip.vision.embed_images(images)) > 1 - 1e-5).all()
    jgot = JShardedVision(jclip.vision, jmesh, tensor_parallel=True).embed_images(images)
    assert (cos(got, jgot) > 1 - 1e-5).all()


def test_sharded_bulk_embed_quantized_dp(mesh, jmesh, clip_pair):
    """int8_all composes with DP: quantized weights replicate, each shard
    runs the int8 path, and the rows match the single-device quantized
    embedder and the JAX one; TP stays refused for quantized weights."""
    _, _, d = clip_pair
    clip_q = Clip.from_local_dir(d, device="cpu", quantize="int8_all")
    jclip_q = JClip.from_local_dir(d, quantize="int8_all")
    rng = np.random.default_rng(2)
    images = [rng.integers(0, 255, size=(40 + i, 50, 3), dtype=np.uint8) for i in range(6)]
    got = ShardedVisionEmbedder(clip_q.vision, mesh).embed_images(images)
    assert (cos(got, clip_q.vision.embed_images(images)) > 1 - 1e-5).all()
    assert (cos(got, JShardedVision(jclip_q.vision, jmesh).embed_images(images)) > 1 - 1e-5).all()
    with pytest.raises(ConfigError, match="tensor_parallel"):
        ShardedVisionEmbedder(clip_q.vision, mesh, tensor_parallel=True)


def test_tensor_parallel_overrides_kernel_attn(mesh, clip_pair, caplog):
    """TP with a kernel attn_impl runs the eager core, with a one-time
    warning (the JAX package overrides Pallas to XLA); DP keeps the inner
    embedder's choice."""
    _, _, d = clip_pair
    clip = Clip.from_local_dir(d, device="cpu", attn_impl="kernel")
    assert clip.vision.attn_impl == "kernel"
    tlogging._warned_once.discard("tp-kernel-override")
    logger = tlogging.get_logger()
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=logger.name):
            tp_v = ShardedVisionEmbedder(clip.vision, mesh, tensor_parallel=True)
    finally:
        logger.removeHandler(caplog.handler)
    assert tp_v.attn_impl == "eager"
    assert "overriding attn_impl='kernel' to 'eager'" in caplog.text
    assert ShardedVisionEmbedder(clip.vision, mesh).attn_impl == "kernel"


def test_sharded_text_embedder_passes_mask(mesh, jmesh, tmp_path):
    """Sharded ≡ single-device for an hf_bert tower whose tokenizer pad id
    differs from hf_config.pad_token_id: the tokenizer's mask must reach
    each shard."""
    import json

    from clip_embedder_tpu import TextEmbedder as JTextEmbedder
    from clip_embedder_tpu.config import OpenClipConfig
    from clip_embedder_tpu.models import hf_text
    from clip_embedder_tpu.models.build import resolve_text, resolve_vision
    from clip_embedder_tpu.weights import save_pytree
    from clip_embedder_tpu_torch import TextEmbedder
    from test_tokenizer import make_clip_style_spec

    spec_json = make_clip_style_spec()
    eot_id = next(t["id"] for t in spec_json["added_tokens"] if t["content"] == "<|endoftext|>")
    occ = {"model_cfg": {
        "embed_dim": 32,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8},
        "text_cfg": {"context_length": 16, "hf_model_name": "some/bert",
                     "hf_tokenizer_name": "some/bert", "pooler_type": "mean_pooler",
                     "proj_type": "linear",
                     "hf_config": {"vocab_size": 128, "hidden_size": 32,
                                   "num_attention_heads": 2, "num_hidden_layers": 2,
                                   "intermediate_size": 64, "pad_token_id": 0}}},
        "preprocess_cfg": {"mean": [0.5] * 3, "std": [0.5] * 3}}
    (tmp_path / "open_clip_config.json").write_text(json.dumps(occ))
    (tmp_path / "model_config.json").write_text(json.dumps(
        {"tokenizer_needs_lowercase": False, "activation_function": "softmax",
         "logit_scale": 10.0, "logit_bias": 0.0, "pad_id": eot_id}))
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec_json))
    cfg = OpenClipConfig.from_dict(occ)
    save_pytree(tmp_path / "text.npz", hf_text.init(jax.random.key(8), resolve_text(
        cfg.model_cfg).cfg))
    save_pytree(tmp_path / "visual.npz", jvit.init(jax.random.key(9), resolve_vision(
        cfg.model_cfg).cfg))

    emb = TextEmbedder.from_local_dir(tmp_path, device="cpu")
    assert emb.spec.family == "hf_bert" and emb.pad_id == eot_id
    texts = ["a cat", "a photo of a dog", "the beignet"]
    expect = emb.embed_texts(texts)
    got = ShardedTextEmbedder(emb, mesh).embed_texts(texts)
    np.testing.assert_allclose(got, expect, atol=ATOL)
    jgot = JShardedText(JTextEmbedder.from_local_dir(tmp_path), jmesh).embed_texts(texts)
    np.testing.assert_allclose(got, jgot, atol=ATOL)
    # mis-masking must change this tower's output, or the test proves nothing
    with mock.patch("clip_embedder_tpu_torch.parallel.embed.tower_kwargs",
                    lambda spec, mask, dev: {}):
        wrong = ShardedTextEmbedder(emb, mesh).embed_texts(texts)
    assert (np.abs(wrong - expect) > 1e-4).any()


def test_embed_images_device_reads_nothing_back(clip_pair):
    """``embed_images_device`` leaves its rows on the device: no ``.cpu()``,
    ``.numpy()`` or ``.item()`` during the call; ``embed_images`` is it plus
    one read-back."""
    _, clip, _ = clip_pair
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 255, (36, 44, 3), dtype=np.uint8) for _ in range(3)]

    def refuse(*a, **k):
        raise AssertionError("host sync")

    with mock.patch.object(torch.Tensor, "cpu", refuse), \
            mock.patch.object(torch.Tensor, "numpy", refuse), \
            mock.patch.object(torch.Tensor, "item", refuse):
        embs, n = clip.vision.embed_images_device(images)
    assert n == 3 and embs.shape == (4, 32) and embs.device == clip.vision.device
    np.testing.assert_array_equal(embs[:n].float().numpy(), clip.vision.embed_images(images))


# -- EmbedPipeline -------------------------------------------------------------

def test_embed_pipeline_order_and_values(clip_pair):
    jclip, clip, _ = clip_pair
    rng = np.random.default_rng(7)
    images = [rng.integers(0, 255, (36 + i % 3, 44, 3), dtype=np.uint8) for i in range(11)]
    got = EmbedPipeline(clip.vision, batch_size=4, prefetch=2).embed_all(images)
    assert got.shape[0] == 11
    assert (cos(got, clip.vision.embed_images(images)) > 1 - 1e-5).all()
    from clip_embedder_tpu.parallel.pipeline import EmbedPipeline as JEmbedPipeline
    jgot = JEmbedPipeline(jclip.vision, batch_size=4, prefetch=2).embed_all(images)
    assert (cos(got, jgot) > 1 - 1e-5).all()


def test_pipeline_over_sharded_embedder(mesh, clip_pair):
    _, clip, _ = clip_pair
    sharded = ShardedVisionEmbedder(clip.vision, mesh)
    rng = np.random.default_rng(11)
    images = [rng.integers(0, 255, (40, 40 + i % 5, 3), dtype=np.uint8) for i in range(10)]
    blocks = list(EmbedPipeline(sharded, batch_size=4, prefetch=2).embed_iter(images))
    assert [b.shape[0] for b in blocks] == [4, 4, 2]
    got = np.concatenate(blocks)
    assert (cos(got, clip.vision.embed_images(images)) > 1 - 1e-5).all()


def test_pipeline_duck_typed_embedder():
    class Ident:
        def embed_images(self, arrays):
            return np.stack([a.reshape(-1)[:2].astype(np.float32) for a in arrays])

    images = [np.full((2, 2, 3), i, np.uint8) for i in range(5)]
    got = EmbedPipeline(Ident(), batch_size=2).embed_all(images)
    np.testing.assert_array_equal(got[:, 0], np.arange(5))
    with pytest.raises(ClipError, match="Empty batch"):
        EmbedPipeline(Ident()).embed_all([])


def test_pipeline_propagates_decode_errors(clip_pair):
    _, clip, _ = clip_pair
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (32, 32, 3), dtype=np.uint8), object(),
              rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)]
    with pytest.raises(ClipError):
        EmbedPipeline(clip.vision, batch_size=2).embed_all(images)


def test_pipeline_yields_completed_batches_before_error(clip_pair):
    _, clip, _ = clip_pair
    rng = np.random.default_rng(1)
    good = [rng.integers(0, 255, (32, 32, 3), dtype=np.uint8) for _ in range(4)]
    got = []
    with pytest.raises(ClipError):
        for block in EmbedPipeline(clip.vision, batch_size=2).embed_iter(good + [object()]):
            got.append(block)
    assert sum(b.shape[0] for b in got) == 4
    assert (cos(np.concatenate(got), clip.vision.embed_images(good)) > 1 - 1e-5).all()


def test_corpus_index_on_the_tp_mesh_model_axis(mesh):
    """``axis="model"`` shards the rows over the model axis's entries."""
    rng = np.random.default_rng(5)
    corpus = rng.standard_normal((20, 8)).astype(np.float32)
    index = CorpusIndex.build(corpus, mesh, axis="model")
    assert len(index.devices) == 2 and index.rows_per_shard == 16
    vals, ids = index.search(corpus[:3], 2)
    np.testing.assert_array_equal(ids, np.argsort(-(corpus[:3] @ corpus.T), axis=1)[:, :2])
    assert vals.shape == (3, 2)


def test_exports_the_jax_parallel_names():
    import clip_embedder_tpu.parallel as jparallel
    import clip_embedder_tpu_torch.parallel as tparallel

    assert tparallel.__all__ == jparallel.__all__
    assert all(callable(getattr(tparallel, name)) for name in tparallel.__all__)

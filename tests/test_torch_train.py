"""The torch port's training path (``clip_embedder_tpu_torch.train``) against
the JAX package's ``clip_embedder_tpu.train`` on one CPU device.

Weights cross as numpy: the JAX ``init_train_state`` params go through
``train_params_from_numpy``. Inputs come from ``np.random.default_rng``
seeds. The cases: the losses, ``loss_fn``'s gradients leaf by leaf, the
decay mask, AdamW against optax on one gradient tree, ``train_step``,
remat, the ring-loss errors, checkpoints, the export handoff into both
packages' ``Clip``, the kernel guard, the CUDA default, and
``chip_smoke.py``'s phase 13 rehearsed on the CPU. The mesh layouts are in
tests/test_torch_train_parallel.py.
"""

import importlib.util
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from clip_embedder_tpu import Clip as JClip
from clip_embedder_tpu import train as jt
from clip_embedder_tpu.models.text_transformer import TextCfgResolved as JTextCfg
from clip_embedder_tpu.models.vit import ViTCfg as JViTCfg
from clip_embedder_tpu_torch import Clip
from clip_embedder_tpu_torch import train as tt
from clip_embedder_tpu_torch.errors import DeviceError, WeightError
from clip_embedder_tpu_torch.models import text_transformer as ttext
from clip_embedder_tpu_torch.models import vit as tvit
from clip_embedder_tpu_torch.ops import cuda
from clip_embedder_tpu_torch.weights import _flatten, tree_map

from test_clip_e2e import MODEL_CONFIG
from test_tokenizer import make_clip_style_spec

# the JAX train tests' small towers: CLIP's layout (class token, cls pool,
# quick_gelu, causal argmax text) and SigLIP's (map pool, layer scale,
# tanh gelu, bidirectional text pooled at the last token with a proj bias)
CLIP_V = dict(image_size=16, patch_size=8, width=32, layers=2, heads=2, mlp_hidden=64,
              embed_dim=16, activation="quick_gelu")
CLIP_T = dict(context_length=8, vocab_size=64, width=32, heads=2, layers=2, mlp_hidden=64,
              embed_dim=16, activation="quick_gelu")
SIGLIP_V = dict(image_size=16, patch_size=8, width=32, layers=2, heads=2, mlp_hidden=64,
                embed_dim=32, activation="gelu_tanh", use_class_token=False,
                use_ln_pre=False, pool="map", use_proj=False, ln_eps=1e-6,
                pos_embed_cls=False, use_layer_scale=True)
SIGLIP_T = dict(context_length=8, vocab_size=64, width=32, heads=2, layers=2, mlp_hidden=64,
                embed_dim=32, activation="gelu_tanh", causal=False, pool="last",
                proj_bias=True, ln_eps=1e-6)
LAYOUTS = {"clip": (CLIP_V, CLIP_T), "siglip": (SIGLIP_V, SIGLIP_T)}


def cfgs(loss: str, **kw):
    """The same TrainConfig in both packages: (jax, port)."""
    v, t = LAYOUTS[loss]
    return (jt.TrainConfig(vision_cfg=JViTCfg(**v), text_cfg=JTextCfg(**t), loss=loss, **kw),
            tt.TrainConfig(vision_cfg=tvit.ViTCfg(**v), text_cfg=ttext.TextCfgResolved(**t),
                           loss=loss, **kw))


def jax_params(cfg, seed=0):
    params, _ = jt.init_train_state(jax.random.key(seed), cfg)
    return jax.tree.map(np.asarray, params)


def make_batch(seed, b=4, image=16, ctx=8, vocab=64):
    rng = np.random.default_rng(seed)
    return {"pixels": rng.standard_normal((b, image, image, 3)).astype(np.float32),
            "input_ids": rng.integers(1, vocab - 1, (b, ctx)).astype(np.int32)}


def unit_embeddings(seed, b, d):
    rng = np.random.default_rng(seed)
    img, txt = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    return img / np.linalg.norm(img, axis=-1, keepdims=True), \
        txt / np.linalg.norm(txt, axis=-1, keepdims=True)


def flat_grads(params) -> dict:
    return _flatten(tree_map(lambda t: t.grad.numpy(), params))


def hold_grads(got: dict, want: dict) -> None:
    """Every leaf's gradient: max|Δ| ≤ 1e-4·max|g_jax| + 1e-7."""
    assert got.keys() == want.keys()
    bad = {k: float(np.abs(got[k] - want[k]).max()) for k in want
           if np.abs(got[k] - want[k]).max() > 1e-4 * np.abs(want[k]).max() + 1e-7}
    assert not bad, bad


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """One jit of the JAX ``loss_fn``'s value and gradient per config."""
    cache = {}

    def get(cfg):
        if cfg not in cache:
            cache[cfg] = jax.jit(jax.value_and_grad(partial(jt.loss_fn, cfg=cfg)))
        return cache[cfg]

    return get


@pytest.mark.parametrize("loss", ["clip", "siglip"])
def test_losses_match_jax(loss):
    img, txt = unit_embeddings(0, 16, 8)
    scale, bias = np.float32(10.0), np.float32(-10.0 if loss == "siglip" else 0.0)
    want = getattr(jt, f"{loss}_loss")(jnp.asarray(img), jnp.asarray(txt), scale, bias)
    got = getattr(tt, f"{loss}_loss")(torch.from_numpy(img), torch.from_numpy(txt),
                                      torch.tensor(scale), torch.tensor(bias))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("loss", ["clip", "siglip"])
def test_loss_fn_gradients_match_jax(loss, jax_value_and_grad):
    """``loss_fn``'s value and the gradient of every leaf, against
    ``jax.value_and_grad`` of the JAX ``loss_fn`` on the same numpy
    params and batch."""
    jcfg, pcfg = cfgs(loss)
    npp, batch = jax_params(jcfg), make_batch(1)
    jl, jg = jax_value_and_grad(jcfg)(jax.tree.map(jnp.asarray, npp),
                                     jax.tree.map(jnp.asarray, batch))
    params = tt.train_params_from_numpy(npp, device="cpu")
    pl = tt.loss_fn(params, batch, pcfg)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=1e-5)
    hold_grads(flat_grads(params), _flatten(jax.tree.map(np.asarray, jg)))


@pytest.mark.parametrize("loss", ["clip", "siglip"])
def test_decay_mask_matches_jax(loss):
    jcfg, _ = cfgs(loss)
    npp = jax_params(jcfg)
    want = _flatten(jax.tree.map(bool, jt._decay_mask(npp)))
    got = _flatten(tt._decay_mask(tt.train_params_from_numpy(npp, device="cpu")))
    assert got == want
    # the JAX mask decays the stacked block biases and LayerNorms (its
    # docstring says otherwise); the port copies what it does
    assert got["visual/blocks/ln1/scale"] and got["visual/blocks/attn/q/b"]
    assert not got["text/ln_final/scale"] and not got["logit_scale"]


def test_optimizer_matches_optax():
    """Fed one gradient tree for 3 steps, ``make_optimizer`` (torch AdamW in
    two groups) gives optax.adamw's params within 1e-6."""
    jcfg, pcfg = cfgs("siglip", learning_rate=1e-2, weight_decay=0.1)
    npp = jax_params(jcfg)
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), npp)
    tx = jt.make_optimizer(jcfg)
    update = jax.jit(tx.update)
    jp = jax.tree.map(jnp.asarray, npp)
    state = tx.init(jp)
    params = tt.train_params_from_numpy(npp, device="cpu")
    opt = tt.make_optimizer(pcfg)(params)
    for _ in range(3):
        updates, state = update(jax.tree.map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        flat = _flatten(grads)
        for k, t in _flatten(params).items():
            t.grad = torch.from_numpy(flat[k].copy())
        opt.step()
    want = _flatten(jax.tree.map(np.asarray, jp))
    got = _flatten(tt.train_params_to_numpy(params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("loss", ["clip", "siglip"])
def test_train_step_matches_jax(loss):
    """3 steps on one batch: the port's losses are the JAX ``train_step``'s
    at rtol 1e-4, and they descend."""
    jcfg, pcfg = cfgs(loss, learning_rate=1e-3)
    npp, batch = jax_params(jcfg), make_batch(3)
    tx = jt.make_optimizer(jcfg)
    step = jax.jit(partial(jt.train_step, cfg=jcfg, tx=tx))
    jp = jax.tree.map(jnp.asarray, npp)
    state = jt.init_opt_state(jcfg, jp)
    jbatch = jax.tree.map(jnp.asarray, batch)
    params = tt.train_params_from_numpy(npp, device="cpu")
    opt = tt.init_opt_state(pcfg, params)
    want, got = [], []
    for _ in range(3):
        jp, state, jl = step(jp, state, jbatch)
        params, opt, pl = tt.train_step(params, opt, batch, cfg=pcfg, tx=tt.make_optimizer(pcfg))
        want.append(float(jl))
        got.append(float(pl))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_train_step_starts_the_optimizer_from_none():
    _, pcfg = cfgs("clip")
    params, opt = tt.init_train_state(torch.Generator().manual_seed(0), pcfg, device="cpu")
    assert opt is None
    params, opt, loss = tt.train_step(params, None, make_batch(4), cfg=pcfg,
                                      tx=tt.make_optimizer(pcfg))
    assert isinstance(opt, torch.optim.AdamW) and np.isfinite(float(loss))
    assert all(t.grad is None for t in _flatten(params).values())


@pytest.mark.parametrize("loss", ["clip", "siglip"])
def test_init_train_state_layout_matches_jax(loss):
    """Same tree, shapes and dtypes as the JAX ``init_train_state``, the
    logit scale log(1/0.07) and bias −10 for SigLIP, every leaf trainable."""
    jcfg, pcfg = cfgs(loss)
    want = _flatten(jax_params(jcfg))
    params, _ = tt.init_train_state(torch.Generator().manual_seed(0), pcfg, device="cpu")
    got = _flatten(params)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 and v.is_leaf and v.requires_grad
               for v in got.values())
    for k in ("logit_scale", "logit_bias"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)


def test_remat_matches_no_remat():
    """Recomputing the blocks changes neither the loss nor any gradient
    (within 1e-5)."""
    out = {}
    for remat in (False, True):
        _, pcfg = cfgs("siglip", remat=remat)
        params = tt.train_params_from_numpy(jax_params(cfgs("siglip")[0]), device="cpu")
        loss = tt.loss_fn(params, make_batch(5), pcfg)
        loss.backward()
        out[remat] = (loss.item(), flat_grads(params))
    assert abs(out[False][0] - out[True][0]) < 1e-5
    for k, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][k], g, rtol=0, atol=1e-5, err_msg=k)


def test_trainable_towers_match_the_serving_towers():
    """The trainable forward (the tree's own leaves, blocks indexed inside
    the forward) computes what the frozen serving tower computes, and its
    gradients land on the stacked leaves."""
    _, pcfg = cfgs("siglip")
    params, _ = tt.init_train_state(torch.Generator().manual_seed(1), pcfg, device="cpu")
    batch = make_batch(6)
    pixels, ids = torch.from_numpy(batch["pixels"]), torch.from_numpy(batch["input_ids"])
    with torch.no_grad():
        for cls, tree, x, cfg in ((tvit.ViT, params["visual"], pixels, pcfg.vision_cfg),
                                  (ttext.TextTransformer, params["text"], ids, pcfg.text_cfg)):
            frozen = cls(cfg, tree_map(lambda t: t.detach().clone(), tree))
            assert torch.equal(cls(cfg, tree, trainable=True)(x), frozen(x))
            assert not any(p.requires_grad for p in frozen.parameters())
    tvit.ViT(pcfg.vision_cfg, params["visual"], trainable=True)(pixels).sum().backward()
    fc = params["visual"]["blocks"]["mlp"]["fc"]["w"]
    assert fc.grad is not None and fc.grad.shape == fc.shape and fc.grad.abs().sum() > 0


def test_ring_loss_requires_siglip_and_a_mesh():
    from clip_embedder_tpu_torch.parallel import get_mesh

    _, pcfg = cfgs("clip", ring_loss=True)
    params, _ = tt.init_train_state(torch.Generator().manual_seed(0), pcfg, device="cpu")
    mesh = get_mesh(devices=["cpu"] * 2)
    step, placed, opt = tt.make_sharded_train_step(pcfg, mesh, params)
    with pytest.raises(ValueError, match="ring_loss"):
        step(placed, opt, make_batch(7, b=2))
    _, pcfg = cfgs("siglip", ring_loss=True)
    with pytest.raises(ValueError, match="ring_loss"):
        tt.loss_fn(params, make_batch(7, b=2), pcfg)


def test_checkpoint_roundtrip_and_resume(tmp_path):
    """A round trip is exact with step == 3; a save/load after step 1 then
    step 2 equals 2 uninterrupted steps exactly."""
    _, pcfg = cfgs("siglip", learning_rate=1e-3)
    npp = jax_params(cfgs("siglip")[0])
    params = tt.train_params_from_numpy(npp, device="cpu")
    tt.save_checkpoint(tmp_path / "ckpt", params, step=3)
    restored = tt.load_checkpoint(tmp_path / "ckpt", step=3, device="cpu")
    assert restored["step"] == 3 and "opt_state" not in restored
    for k, v in _flatten(params).items():
        got = _flatten(restored["params"])[k]
        assert torch.equal(got, v) and got.is_leaf and got.requires_grad

    batch, tx = make_batch(8), tt.make_optimizer(pcfg)
    a = tt.train_params_from_numpy(npp, device="cpu")
    opt = tx(a)
    for _ in range(2):
        a, opt, _ = tt.train_step(a, opt, batch, cfg=pcfg, tx=tx)

    b = tt.train_params_from_numpy(npp, device="cpu")
    opt = tx(b)
    b, opt, _ = tt.train_step(b, opt, batch, cfg=pcfg, tx=tx)
    tt.save_checkpoint(tmp_path / "ckpt", b, opt, step=1)
    state = tt.load_checkpoint(tmp_path / "ckpt", step=1, device="cpu")
    assert state["step"] == 1
    b = state["params"]
    opt = tt.init_opt_state(pcfg, b)
    opt.load_state_dict(state["opt_state"])
    b, opt, _ = tt.train_step(b, opt, batch, cfg=pcfg, tx=tx)
    for k, v in _flatten(a).items():
        assert torch.equal(_flatten(b)[k], v), k


EXPORT_V = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4, mlp_hidden=128,
                embed_dim=32, activation="quick_gelu")
EXPORT_T = dict(context_length=12, vocab_size=512, width=64, heads=4, layers=2,
                mlp_hidden=256, embed_dim=32)
OPEN_CLIP_CONFIG = {
    "model_cfg": {
        "embed_dim": 32, "quick_gelu": True,
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8,
                       "head_width": 16, "mlp_ratio": 2.0},
        "text_cfg": {"context_length": 12, "vocab_size": 512, "width": 64, "heads": 4,
                     "layers": 2},
    },
    "preprocess_cfg": {"mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]},
}


def export_params():
    cfg = jt.TrainConfig(vision_cfg=JViTCfg(**EXPORT_V), text_cfg=JTextCfg(**EXPORT_T))
    return tt.train_params_from_numpy(jax_params(cfg, seed=1), device="cpu")


def test_export_trained_model_serves_in_both_packages(tmp_path):
    """The exported dir loads in the JAX ``Clip`` and the port's (f32, CPU),
    which agree at cosine > 1 - 1e-5 on images and texts, and the port's
    embeddings are the trained tree's own forward."""
    d = tmp_path / "model"
    d.mkdir()
    (d / "open_clip_config.json").write_text(json.dumps(OPEN_CLIP_CONFIG))
    (d / "model_config.json").write_text(json.dumps(MODEL_CONFIG))
    (d / "tokenizer.json").write_text(json.dumps(make_clip_style_spec()))
    params = export_params()
    tt.export_trained_model(d, params)

    rng = np.random.default_rng(9)
    images = [rng.integers(0, 255, (32, 32, 3), dtype=np.uint8) for _ in range(3)]
    texts = ["a cat", "a dog on the grass", "two birds"]
    port, ref = Clip.from_local_dir(d, device="cpu"), JClip.from_local_dir(d)
    for got, want in ((port.vision.embed_images(images), ref.vision.embed_images(images)),
                      (port.text.embed_texts(texts), ref.text.embed_texts(texts))):
        assert (np.sum(got * np.asarray(want), axis=-1) > 1 - 1e-5).all()
    pixels = torch.from_numpy(port.vision.preprocess_batch(images))
    with torch.no_grad():
        own = tvit.ViT(tvit.ViTCfg(**EXPORT_V), params["visual"], trainable=True)(
            pixels, channels_first=True).numpy()
    assert (np.sum(own * port.vision.embed_images(images), axis=-1) > 1 - 1e-5).all()


def test_export_rejects_config_weight_mismatch(tmp_path):
    """A dir whose open_clip_config resolves another architecture than the
    trained weights (here: the config omits the non-default mlp_ratio) is
    refused with a ``WeightError``, and nothing is written."""
    occ = json.loads(json.dumps(OPEN_CLIP_CONFIG))
    del occ["model_cfg"]["vision_cfg"]["mlp_ratio"]
    d = tmp_path / "model"
    d.mkdir()
    (d / "open_clip_config.json").write_text(json.dumps(occ))
    with pytest.raises(WeightError, match="mlp"):
        tt.export_trained_model(d, export_params())
    assert not (d / "visual.npz").exists()


def test_kernel_guard_refuses_operands_that_require_grad():
    """``ops.cuda.no_grad_operands`` raises for an operand (or a leaf of a
    tree) that requires grad while autograd is on, and passes under
    ``torch.no_grad()`` or for frozen operands."""
    w = torch.zeros(4, 4, requires_grad=True)
    x = torch.zeros(2, 4)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda.no_grad_operands("ln_qkv", {"q": {"w": w}}, None, x)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda.no_grad_operands("flash_attention_packed", x, x, x, None, (w, x))
    frozen = tvit.Block(tvit.unstack(tvit.init_blocks(None, layers=1, width=4, mlp_hidden=8), 0),
                        heads=1, activation="gelu", ln_eps=1e-6)
    cuda.no_grad_operands("ln_qkv", frozen["attn"], frozen["ln1"], x)
    with torch.no_grad():
        cuda.no_grad_operands("ln_qkv", {"q": {"w": w}}, None, x)


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    jcfg, pcfg = cfgs("clip")
    with pytest.raises(DeviceError):
        tt.init_train_state(None, pcfg)
    with pytest.raises(DeviceError):
        tt.train_params_from_numpy(jax_params(jcfg))
    params = tt.train_params_from_numpy(jax_params(jcfg), device="cpu")
    tt.save_checkpoint(tmp_path, params, step=0)
    with pytest.raises(DeviceError):
        tt.load_checkpoint(tmp_path, step=0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_training_rehearses_on_cpu():
    """chip_smoke.py's phase 13 at SO400M's full width, cut to one layer a
    tower, a vocabulary of 512 and a small batch, on the CPU in f32: the
    loss descends, two DP, ring, FSDP and TP steps give the unsharded run's
    first two losses (the second after an update), the exported dir serves what was trained, and no kernel is
    launched."""
    out = _chip_smoke().phase_training("cpu", torch.float32, layers=1, vocab_size=512, batch=2,
                                       steps=2)
    assert out["losses"][-1] < out["losses"][0]
    assert set(out["variants"]) == {"dp", "ring", "fsdp", "tp"}
    assert set(out["launches"].values()) == {0}
    assert min(out["handoff"]["eager_cosine"].values()) > 1 - 1e-5
    assert min(out["handoff"]["trained_cosine"].values()) > 1 - 1e-5

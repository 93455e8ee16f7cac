"""The torch port's plain ops against their JAX counterparts, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; f32 at
atol 1e-6 (1e-5 for the resize, whose pixel values reach ~2.6 after /std).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_embedder_tpu.ops import attention as jattn
from clip_embedder_tpu.ops import layers as jlayers
from clip_embedder_tpu.ops import normalize as jnorm
from clip_embedder_tpu.ops import preprocess as jpre
from clip_embedder_tpu_torch.ops import attention as tattn
from clip_embedder_tpu_torch.ops import layers as tlayers
from clip_embedder_tpu_torch.ops import normalize as tnorm
from clip_embedder_tpu_torch.ops import preprocess as tpre

ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(tree):
    """numpy tree → (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(tree)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _linear(rng, d_in, d_out, bias=True):
    p = {"w": _arr(rng, d_in, d_out, scale=d_in ** -0.5)}
    if bias:
        p["b"] = _arr(rng, d_out, scale=0.1)
    return p


def _ln(rng, d):
    return {"scale": 1 + _arr(rng, d, scale=0.1), "bias": _arr(rng, d, scale=0.1)}


def test_layer_norm():
    rng = _rng(1)
    (jp, tp), (jx, tx) = _both(_ln(rng, 48)), _both(_arr(rng, 3, 5, 48, scale=3.0))
    for eps in (1e-5, 1e-6):
        _close(tlayers.layer_norm(tp, tx, eps=eps), jlayers.layer_norm(jp, jx, eps=eps))


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    rng = _rng(2)
    (jp, tp), (jx, tx) = _both(_linear(rng, 40, 24, bias)), _both(_arr(rng, 2, 7, 40))
    _close(tlayers.linear(tp, tx), jlayers.linear(jp, jx))


@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "quick_gelu", "relu"])
def test_activations(name):
    jx, tx = _both(_arr(_rng(3), 4, 33, scale=4.0))
    _close(tlayers.ACTIVATIONS[name](tx), jlayers.ACTIVATIONS[name](jx))


@pytest.mark.parametrize("residual", [False, True])
def test_mlp(residual):
    rng = _rng(4)
    params = {"fc": _linear(rng, 32, 96), "proj": _linear(rng, 96, 32)}
    (jp, tp), (jl, tl), (jx, tx) = _both(params), _both(_ln(rng, 32)), _both(
        _arr(rng, 2, 9, 32))
    got = tlayers.mlp(tp, tx, activation=tlayers.gelu_tanh, pre_ln=tl, residual=residual)
    ref = jlayers.mlp(jp, jx, activation=jlayers.gelu_tanh, pre_ln=jl, residual=residual)
    _close(got, ref)


def test_mlp_residual_requires_pre_ln():
    with pytest.raises(ValueError, match="pre_ln"):
        tlayers.mlp({}, torch.zeros(1, 4), activation=tlayers.relu, residual=True)


def test_l2_normalize():
    jx, tx = _both(_arr(_rng(5), 6, 40))
    _close(tnorm.l2_normalize(tx), jnorm.l2_normalize(jx))


@pytest.mark.parametrize("masked", [False, True])
def test_attention_core(masked):
    rng = _rng(6)
    (jq, tq), (jk, tk), (jv, tv) = (_both(_arr(rng, 2, 4, 11, 16)) for _ in range(3))
    jm = jattn.causal_mask(11) if masked else None
    tm = tattn.causal_mask(11) if masked else None
    _close(tattn.attention_core(tq, tk, tv, mask=tm),
           jattn.attention_core(jq, jk, jv, mask=jm))


def test_causal_mask():
    np.testing.assert_array_equal(tattn.causal_mask(7).numpy(),
                                  np.asarray(jattn.causal_mask(7)))


def _attn_params(rng, d):
    return {n: _linear(rng, d, d) for n in ("q", "k", "v", "out")}


@pytest.mark.parametrize("pre_ln,residual,masked", [
    (False, False, False), (True, True, False), (True, True, True)])
def test_multi_head_attention_self(pre_ln, residual, masked):
    rng = _rng(7)
    (jp, tp), (jx, tx) = _both(_attn_params(rng, 64)), _both(_arr(rng, 2, 13, 64, scale=0.5))
    (jl, tl) = _both(_ln(rng, 64)) if pre_ln else (None, None)
    kw_j = dict(num_heads=4, pre_ln=jl, residual=jx if residual else None,
                mask=jattn.causal_mask(13) if masked else None)
    kw_t = dict(num_heads=4, pre_ln=tl, residual=tx if residual else None,
                mask=tattn.causal_mask(13) if masked else None)
    _close(tattn.multi_head_attention(tp, tx, **kw_t),
           jattn.multi_head_attention(jp, jx, **kw_j))


def test_multi_head_attention_cross():
    """The map-pool probe layout: one query token over a token sequence."""
    rng = _rng(8)
    (jp, tp) = _both(_attn_params(rng, 64))
    (jq, tq), (jkv, tkv) = _both(_arr(rng, 3, 1, 64)), _both(_arr(rng, 3, 17, 64))
    for impl in tattn.ATTN_IMPLS:  # cross-attention stays plain on every impl
        _close(tattn.multi_head_attention(tp, tq, kv=tkv, num_heads=4, impl=impl),
               jattn.multi_head_attention(jp, jq, kv=jkv, num_heads=4))


def test_multi_head_attention_rejects_unknown_impl_and_takes_rope():
    x = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="Unknown attention impl"):
        tattn.multi_head_attention({}, x, num_heads=2, impl="pallas")
    rng = _rng(10)
    (_, tp) = _both(_attn_params(rng, 64))
    x = torch.from_numpy(_arr(rng, 2, 5, 64))
    identity = (torch.zeros(5, 64), torch.ones(5, 64))  # angle 0: rope is the identity
    for impl in tattn.ATTN_IMPLS:
        torch.testing.assert_close(
            tattn.multi_head_attention(tp, x, num_heads=4, rope=identity, impl=impl),
            tattn.multi_head_attention(tp, x, num_heads=4, impl=impl), atol=0, rtol=0)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_resize_normalize(layout):
    rng = _rng(9)
    sizes = [(40, 56), (64, 33)]
    batch = np.zeros((2, 128, 128, 3), np.uint8)
    whs, wws = [], []
    for i, (h, w) in enumerate(sizes):
        batch[i, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        wh, ww = jpre.preprocess_weights_for(w, h, 32, padded_h=128, padded_w=128)
        whs.append(wh)
        wws.append(ww)
    wh, ww = np.stack(whs), np.stack(wws)
    mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
    std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
    ref = jpre.resize_normalize(*(jnp.asarray(a) for a in (batch, wh, ww, mean, std)),
                                layout=layout)
    got = tpre.resize_normalize(*(torch.from_numpy(a) for a in (batch, wh, ww, mean, std)),
                                layout=layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_preprocessor_matches_jax():
    """Mixed source sizes through both Preprocessors (bucketing, unique
    matrix staging, gather), channels-first as the ViT takes it."""
    rng = _rng(10)
    arrays = [rng.integers(0, 256, s + (3,), dtype=np.uint8)
              for s in ((48, 40), (130, 200), (48, 40))]
    kw = dict(image_size=32, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
              interpolation="bicubic", resize_mode="shortest", layout="nchw")
    ref = jpre.Preprocessor(**kw)(arrays)
    got = tpre.Preprocessor(**kw, device="cpu")(arrays)
    assert got.shape == ref.shape == (4, 3, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_bucketing_and_weight_builders_are_the_jax_ones():
    for n in (1, 2, 3, 5, 64, 129, 5000):
        assert tpre.bucket_size(n) == jpre.bucket_size(n)
        assert tpre.bucket_batch(n) == jpre.bucket_batch(n)
    for interp in ("bicubic", "bilinear", "nearest"):
        np.testing.assert_array_equal(
            tpre.resize_weights(24, 57, crop_start=3.5, crop_size=50.0,
                                interpolation=interp, padded_in_size=64),
            jpre.resize_weights(24, 57, crop_start=3.5, crop_size=50.0,
                                interpolation=interp, padded_in_size=64))

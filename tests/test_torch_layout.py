"""The K-major storage of the port's int8 weights, on the CPU.

``ops.quant`` stores every quantized weight ``w_q`` K-major: a contiguous
``[..., out, in]`` tensor seen as the JAX package's ``[..., in, out]``
through a transpose (``quant.kmajor``). The CUDA kernels' int8 products
read that storage as it is, and ``int8_mlp.check_weight_layout`` refuses
anything else. Here: the layout reaches every block of a quantized ``Clip``
without a copy, the values stay the JAX package's, and the check raises on
an N-contiguous weight.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from clip_embedder_tpu.ops import quant as jquant
from clip_embedder_tpu_torch import Clip
from clip_embedder_tpu_torch import weights as tweights
from clip_embedder_tpu_torch.ops import int8_mlp, quant

FIXTURES = Path(__file__).parent / "fixtures"


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _is_kmajor(w: torch.Tensor) -> bool:
    return w.transpose(-1, -2).is_contiguous()


@pytest.mark.parametrize("mode", ["int8", "int8_all"])
def test_clip_blocks_hold_kmajor_weights(mode):
    """Every w_q a layer reaches (the stacked blocks after ``unstack``, the
    pool head) has a contiguous ``.t()`` that is the stored tensor itself."""
    clip = Clip.from_local_dir(FIXTURES / "golden_siglip", device="cpu", quantize=mode)
    for tower in (clip.vision.tower, clip.text.tower):
        found = [(n, b) for n, b in tower.named_buffers() if n.endswith("w_q")]
        assert found
        for name, w in found:
            assert w.dtype == torch.int8 and w.dim() == 2, name
            assert w.t().is_contiguous(), name
            assert w.t().contiguous().data_ptr() == w.data_ptr(), name
            int8_mlp.check_weight_layout(w, name)
    names = {n for n, _ in clip.vision.tower.named_buffers() if n.endswith("w_q")}
    assert any(".attn.q." in n for n in names) == (mode == "int8_all")


@pytest.mark.parametrize("clip", ["mse", "max"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40)], ids=["2d", "stacked"])
def test_quantize_weight_stores_kmajor_with_jax_values(clip, shape):
    w = _arr(np.random.default_rng(5), *shape, scale=0.05)
    ref = jquant.quantize_weight(w, clip=clip)
    got = quant.quantize_weight(torch.from_numpy(w), clip=clip)["w_q"]
    assert tuple(got.shape) == shape and _is_kmajor(got)
    np.testing.assert_array_equal(got.numpy(), ref["w_q"])
    if len(shape) == 3:
        for i in range(shape[0]):
            layer = tweights.unstack({"w_q": got}, i)["w_q"]
            assert layer.t().is_contiguous()
            np.testing.assert_array_equal(layer.numpy(), ref["w_q"][i])


def test_quantize_tree_weights_are_kmajor_with_jax_values():
    rng = np.random.default_rng(6)
    tree = {"blocks": {"mlp": {"fc": {"w": _arr(rng, 2, 16, 64, scale=0.1)},
                               "proj": {"w": _arr(rng, 2, 64, 16, scale=0.1)}},
                       "attn": {"q": {"w": _arr(rng, 2, 16, 16, scale=0.1)}}},
            "head": {"mlp": {"fc": {"w": _arr(rng, 16, 32, scale=0.1)}}}}
    ref = jquant.quantize_tree(tree, paths=jquant.QUANT_PATHS_ALL)
    got = quant.quantize_tree(tweights.params_from_numpy(tree, device="cpu",
                                                         dtype=torch.float32),
                              paths=quant.QUANT_PATHS_ALL)
    for path in (("blocks", "mlp", "fc"), ("blocks", "mlp", "proj"), ("blocks", "attn", "q"),
                 ("head", "mlp", "fc")):
        g, r = got, ref
        for k in path:
            g, r = g[k], r[k]
        assert _is_kmajor(g["w_q"]), path
        np.testing.assert_array_equal(g["w_q"].numpy(), np.asarray(r["w_q"]), err_msg=str(path))


def test_device_tree_lays_out_weights_quantized_elsewhere():
    """A tree quantized by the JAX package (numpy, N-contiguous) gets the
    kernels' layout from ``params_from_numpy``, values unchanged."""
    q = jquant.quantize_weight(_arr(np.random.default_rng(7), 2, 32, 48, scale=0.1))
    tree = tweights.params_from_numpy({"mlp": {"fc": dict(q)}}, device="cpu",
                                      dtype=torch.float32)
    w = tree["mlp"]["fc"]["w_q"]
    assert w.dtype == torch.int8 and _is_kmajor(w)
    np.testing.assert_array_equal(w.numpy(), np.asarray(q["w_q"]))


def test_kmajor_keeps_a_kmajor_tensor_and_its_values():
    w = torch.arange(6 * 4, dtype=torch.int8).reshape(6, 4)
    k = quant.kmajor(w)
    assert _is_kmajor(k) and torch.equal(k, w) and k.data_ptr() != w.data_ptr()
    assert quant.kmajor(k) is k


@pytest.mark.parametrize("shape", [(2730, 48), (3, 100, 24), (64, 32)],
                         ids=["2d", "stacked", "no_pad_needed"])
def test_kmajor_pads_rows_to_16_bytes_for_the_card(shape):
    """``kmajor(pad=True)`` (the default for a CUDA tensor) stores an
    ``in`` that is no multiple of 16 in zero-padded rows a multiple of 16
    bytes apart, the stride TMA takes; the values stay, a second call keeps
    the tensor, and the fused linear's layout check takes it."""
    w = torch.from_numpy(np.random.default_rng(8).integers(-127, 128, shape).astype(np.int8))
    k = shape[-2]
    got = quant.kmajor(w, pad=True)
    assert torch.equal(got, w) and got.stride(-2) == 1
    assert got.stride(-1) == k + (-k) % 16
    assert quant.kmajor(got, pad=True) is got
    if k % 16:
        base = got.transpose(-1, -2)
        assert not base.is_contiguous()
        assert quant.kmajor(w) is not got and _is_kmajor(quant.kmajor(w))  # the CPU default
    layer = got if got.dim() == 2 else tweights.unstack({"w_q": got}, 1)["w_q"]
    int8_mlp.check_weight_layout(layer, "w")
    p = {"w_q": layer, "w_scale": torch.ones(shape[-1])}
    x = torch.zeros(3, k)
    assert int8_mlp.qlinear_operands(p, k, x, "w", any_width=True)[0] is layer
    if k % 16:
        with pytest.raises(ValueError, match="multiples of 16"):
            int8_mlp.qlinear_operands(p, k, x, "w")


def test_weight_layout_check_refuses_an_n_contiguous_weight():
    w = torch.zeros(64, 32, dtype=torch.int8)  # [in, out], N-contiguous
    with pytest.raises(ValueError, match="K-major"):
        int8_mlp.check_weight_layout(w, "fc")
    int8_mlp.check_weight_layout(quant.kmajor(w), "fc")
    p = {"w_q": w, "w_scale": torch.ones(32), "b": torch.zeros(32)}
    x = torch.zeros(4, 64)
    with pytest.raises(ValueError, match="K-major"):
        int8_mlp.qlinear_operands(p, 64, x, "fc")
    got, s, b = int8_mlp.qlinear_operands({**p, "w_q": quant.kmajor(w)}, 64, x, "fc")
    assert got.shape == (64, 32) and s.shape == b.shape == (32,)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the ``dev`` fixture, never at import). This file
imports neither JAX nor the JAX package, so it runs on a machine without
them; the repo's conftest imports JAX, hence::

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``chip_smoke.py`` is the full gate (main-path shapes, end to end); these
are the small shapes the CPU tests also use.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_embedder_tpu_torch.ops import flash, qkv
from clip_embedder_tpu_torch.ops.attention import causal_mask

FIXTURES = Path(__file__).parent / "fixtures"

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv_inputs(rows, width, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, dt=dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
            dev, dt)

    params = {n: {"w": t(width, width, scale=width ** -0.5), "b": t(width, scale=0.1)}
              for n in "qkv"}
    pre_ln = {"scale": 1 + t(width, scale=0.1), "bias": t(width, scale=0.1)}
    return params, pre_ln, t(rows, width)


@pytest.mark.parametrize("rows,width", [(2 * 61, 256), (3 * 17, 64), (100, 192),
                                        (2 * 576, 1152)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_qkv_kernel_matches_plain(dev, rows, width, dtype):
    params, pre_ln, x = _qkv_inputs(rows, width, dtype, dev)
    before = qkv.ln_qkv.launches
    got = qkv.ln_qkv(params, pre_ln, x, eps=1e-6)
    torch.cuda.synchronize()
    assert qkv.ln_qkv.launches == before + 1
    ref = qkv.ln_qkv_plain(params, pre_ln, x, eps=1e-6)
    for g, r in zip(got, ref):
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            # f32 sums in another order: ~1e-6 relative over W terms
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-4)
        else:
            # bf16 outputs may differ by one rounding step (2^-8 relative)
            torch.testing.assert_close(g, r, atol=1e-2, rtol=2 ** -7)


@pytest.mark.parametrize("b,h,s,d", [(2, 16, 61, 72), (2, 8, 64, 64), (1, 16, 33, 8),
                                     (1, 4, 130, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["exact", "fast", "fast_bf16exp"])
def test_flash_kernel_matches_plain(dev, b, h, s, d, dtype, mode):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    kw = {"fast_softmax": mode != "exact", "exp_bf16": mode == "fast_bf16exp"}
    before = flash.flash_attention_packed.launches
    got = flash.flash_attention_packed(q, k, v, num_heads=h, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention_packed.launches == before + 1
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, **kw)
    tol = 2e-5 if dtype == torch.float32 and mode != "fast_bf16exp" else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_causal_mask(dev, dtype):
    b, h, s, d = 2, 8, 77, 64
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h * d)).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    mask = causal_mask(s, device=dev)
    got = flash.flash_attention_packed(q, k, v, num_heads=h, mask=mask)
    ref = flash.flash_attention_packed_plain(q, k, v, num_heads=h, mask=mask)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_flash_kernel_refuses_per_batch_mask(dev):
    q = torch.zeros(2, 8, 4 * 16, device=dev)
    with pytest.raises(ValueError, match="per-batch"):
        flash.flash_attention_packed(q, q, q, num_heads=4,
                                     mask=torch.zeros(2, 1, 1, 8, device=dev))


@pytest.mark.parametrize("name", ["golden_siglip", "golden_model"])
def test_golden_fixture_through_kernels(dev, name):
    from clip_embedder_tpu_torch import Clip

    fixture = FIXTURES / name
    clip = Clip.from_local_dir(fixture, device="cuda")
    assert clip.vision.attn_impl == "kernel"
    img = np.load(fixture / "golden_image.npy")
    golden = np.load(fixture / "golden_outputs.npz")
    n_qkv, n_attn = qkv.ln_qkv.launches, flash.flash_attention_packed.launches
    np.testing.assert_allclose(clip.vision.embed_image(img), golden["image_embedding"],
                               atol=5e-4)
    np.testing.assert_allclose(clip.text.embed_texts(["a photo of a cat", "the dog!"]),
                               golden["text_embeddings"], atol=5e-4)
    assert qkv.ln_qkv.launches > n_qkv and flash.flash_attention_packed.launches > n_attn
    expect = json.loads((fixture / "golden_classify.json").read_text())
    results = clip.classify(img, [label for label, _ in expect])
    assert [r[0] for r in results] == [e[0] for e in expect]
    np.testing.assert_allclose([r[1] for r in results], [e[1] for e in expect], atol=1e-4)

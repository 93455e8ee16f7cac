"""The compiled inference paths' host side, on the CPU (the card replays the
same staging and keys through CUDA graphs; ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phases 11, 12 and 14 run them there):

* the preprocess's staged route (``Preprocessor.run``: reused staging
  buffers, zeroed only in the rows past a batch; the resize matrices from
  a device LRU) against the plain zero-filled route (``Preprocessor.eager``)
  and the JAX ``Preprocessor``, every row of the bucket, the padded ones
  too (a shape's first call, a call with fewer images than the last, a
  mesh shard with no image); the device LRU's bound; two threads at once;
  a mesh shard's rows; the dense ``stage_host_batch`` against the JAX
  method;
* the ONNX executor's static values made into device tensors once
  (``onnx_exec._Env.const``), so that a warm tower's next call reads
  nothing from the host (``captured.HostReadGuard``);
* ``CorpusIndex``: a search after ``add`` reads the new shards, never a
  runner (on the card: graphs) built over the old ones.
"""

import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_onnx_exec import MctLikeTextTower, TinyConvTower, export  # noqa: E402

from clip_embedder_tpu.ops import preprocess as jpre  # noqa: E402
from clip_embedder_tpu_torch import onnx_exec  # noqa: E402
from clip_embedder_tpu_torch.ops import preprocess as tpre  # noqa: E402
from clip_embedder_tpu_torch.parallel import CorpusIndex, get_mesh  # noqa: E402
from clip_embedder_tpu_torch.utils import captured  # noqa: E402

KW = dict(image_size=32, mean=(0.48145466, 0.4578275, 0.40821073),
          std=(0.26862954, 0.26130258, 0.27577711), interpolation="bicubic",
          resize_mode="shortest")


def _arrays(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s + (3,), dtype=np.uint8) for s in sizes]


# (batch bucket, Hp, Wp) shrinking call by call, then the first shape again
# with smaller images: its buffers hold the earlier call's pixels
BATCHES = [
    ((300, 260), (48, 40), (130, 200), (48, 40), (257, 129)),  # bucket 8, 384 x 384
    ((200, 150), (90, 250), (31, 17)),                         # 4, 256 x 256
    ((100, 90), (64, 128)),                                    # 2, 128 x 128
    ((260, 300),),                                             # 1, 384 x 384
    ((140, 100), (33, 60), (280, 270), (140, 100), (5, 7)),    # 8, 384 x 384 again
]


@pytest.fixture()
def filled_255(monkeypatch):
    """Every staging buffer, and every matrix buffer, made full of 255:
    what the staged route never clears must not reach a row."""
    make, matrices = tpre._Staging.__init__, tpre._Staging.matrices_for

    def init(self, *args, **kwargs):
        make(self, *args, **kwargs)
        self.host.fill_(255)

    def matrices_for(self, u):
        fresh = u not in self.matrices
        whs, wws = matrices(self, u)
        if fresh:
            whs.fill_(255.0)
            wws.fill_(255.0)
        return whs, wws

    monkeypatch.setattr(tpre._Staging, "__init__", init)
    monkeypatch.setattr(tpre._Staging, "matrices_for", matrices_for)


@pytest.mark.parametrize("layout,dtype", [("nchw", torch.float32), ("nhwc", torch.float32),
                                          ("nchw", torch.bfloat16)])
def test_staged_rows_equal_the_zero_filled_route_and_jax(layout, dtype, filled_255):
    pre = tpre.Preprocessor(**KW, layout=layout, out_dtype=dtype, device="cpu")
    jax_pre = jpre.Preprocessor(**KW, layout=layout)
    shapes = []
    for seed, sizes in enumerate(BATCHES):
        arrays = _arrays(seed, sizes)
        got = pre(arrays)
        ref = pre.eager(arrays)
        assert got.shape == ref.shape and got.dtype == dtype
        assert torch.equal(got, ref), f"batch {seed}"  # every row, the padded ones too
        if dtype == torch.float32:  # test_torch_ops.py::test_preprocessor_matches_jax's bound
            np.testing.assert_allclose(got.numpy(), np.asarray(jax_pre(arrays)),
                                       atol=1e-5, rtol=0)
        shapes.append(tuple(got.shape[:1]) + pre.padded_size(arrays))
    assert shapes == [(8, 384, 384), (4, 256, 256), (2, 128, 128), (1, 384, 384), (8, 384, 384)]
    # one staging entry a shape, the repeated shape's reused
    assert len(pre._staging) == 4


def _jax_bucket(jax_pre, arrays, bb):
    """The JAX ``Preprocessor``'s rows of ``arrays`` staged into a batch
    bucket of ``bb`` (its zero-filled staging, as its ``__call__``)."""
    staged = jax_pre.stage_host_batch_unique(arrays, batch_bucket=bb)
    return np.asarray(jpre.resize_normalize_indexed(
        *(jnp.asarray(a) for a in staged), jax_pre.mean, jax_pre.std,
        out_dtype=jax_pre.out_dtype, layout=jax_pre.layout))


# 4 images over (Hp, Wp) = (256, 256), bucket 4; the first is the largest,
# so that every prefix of them keeps the shape
PADDED_ROWS = ((250, 200), (48, 40), (130, 200), (31, 17))


@pytest.mark.parametrize("case", ["first_call", "fewer_after_full", "empty_shard"])
def test_padded_rows_are_the_normalised_zero_image(case, filled_255):
    """Every row of the bucket, not only the images', against the JAX
    ``Preprocessor`` (atol 1e-5) and the plain route (``torch.equal``): a
    shape's first call, whose buffer holds what ``torch.empty`` left (here
    255s); a call of 2 images after one of 4 at the same shape, whose rows
    2-3 hold the earlier call's pixels; a mesh shard past the last image
    (``run([], ...)``, as ``parallel.embed`` calls it) after a shard of 3
    images at the same shape."""
    pre = tpre.Preprocessor(**KW, layout="nchw", device="cpu")
    jax_pre = jpre.Preprocessor(**KW, layout="nchw")
    arrays = _arrays(70, PADDED_ROWS)
    padded = pre.padded_size(arrays)
    if case == "first_call":
        xs = arrays[:3]
        got = pre.run(xs, device="cpu", batch_bucket=4, padded=padded)
        want, ref = _jax_bucket(jax_pre, xs, 4), pre.eager(xs)
    elif case == "fewer_after_full":
        pre.run(arrays, device="cpu", batch_bucket=4, padded=padded)
        xs = arrays[:2]
        got = pre.run(xs, device="cpu", batch_bucket=4, padded=padded)
        want = _jax_bucket(jax_pre, xs, 4)
        ref = torch.cat([pre.eager(xs), pre.eager(arrays[:3])[3:].expand(2, -1, -1, -1)])
    else:
        pre.run(arrays[:3], device="cpu", batch_bucket=4, padded=padded)
        got = pre.run([], device="cpu", batch_bucket=4, padded=padded)
        # the second shard of the whole batch's bucket of 8: all padding
        want = _jax_bucket(jax_pre, arrays[:3], 8)[4:]
        ref = pre.eager(arrays[:3])[3:].expand(4, -1, -1, -1)
    assert got.shape == ref.shape == want.shape == (4, 3, 32, 32)
    assert torch.equal(got, ref)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    n = {"first_call": 3, "fewer_after_full": 2, "empty_shard": 0}[case]
    zero = (0.0 - np.asarray(KW["mean"])) / np.asarray(KW["std"])
    np.testing.assert_allclose(got[n:].numpy(),
                               np.broadcast_to(zero[:, None, None], got[n:].shape),
                               atol=1e-5, rtol=0)


def test_staging_keeps_a_bounded_number_of_shapes():
    pre = tpre.Preprocessor(**KW, layout="nchw", device="cpu")
    pre._STAGING_MAX = 2
    for seed, sizes in enumerate(BATCHES[:3]):
        pre(_arrays(seed, sizes))
    assert [k[1:] for k in pre._staging] == [(4, 256, 256), (2, 128, 128)]
    pre(_arrays(8, BATCHES[2]))  # a hit: nothing goes
    assert [k[1:] for k in pre._staging] == [(4, 256, 256), (2, 128, 128)]
    pre._STAGING_BYTES = 8 * 384 * 384 * 3  # room for the new shape alone
    pre(_arrays(9, BATCHES[0]))
    assert [k[1:] for k in pre._staging] == [(8, 384, 384)]


def test_device_weights_lru_evicts_at_its_bound_and_returns_the_host_matrices():
    pre = tpre.Preprocessor(**KW, device="cpu")
    k0, k1, k2 = (100, 100, 128, 128), (60, 90, 128, 128), (90, 60, 128, 256)
    one = 2 * 32 * 128 * 4  # a pair at Hp = Wp = 128; k2's is 1.5 of them
    pre._DEVICE_WEIGHTS_BYTES = int(2.5 * one)
    dev = torch.device("cpu")

    def cached():
        return [k[1:] for k in pre._device_weights_cache]

    for key in (k0, k1, k2):
        got = pre._device_weights(dev, *key)
        for t, m in zip(got, pre._weights(*key)):
            assert t.dtype == torch.float32 and np.array_equal(t.numpy(), m)
    assert cached() == [k1, k2] and pre._device_weights_bytes == int(2.5 * one)
    hit = pre._device_weights(dev, *k1)
    assert hit[0] is pre._device_weights(dev, *k1)[0]  # a hit: the same tensors, touched
    assert cached() == [k2, k1]
    pre._device_weights(dev, *k0)
    assert cached() == [k1, k0] and pre._device_weights_bytes == 2 * one


def test_two_threads_preprocessing_at_once_get_their_own_rows():
    pre = tpre.Preprocessor(**KW, layout="nchw", device="cpu")
    batches = [_arrays(20, BATCHES[0]), _arrays(21, BATCHES[0][:3]), _arrays(22, BATCHES[1])]
    refs = [pre.eager(b)[:len(b)] for b in batches]
    errors, calls = [], [0] * len(batches)
    stop = time.monotonic() + 2.0

    def hammer(i):
        try:
            while time.monotonic() < stop:
                got = pre(batches[i])[:len(batches[i])]
                if not torch.equal(got, refs[i]):
                    raise AssertionError(f"thread {i} got another batch's rows")
                calls[i] += 1
        except Exception as e:  # noqa: BLE001 (every failure is the finding)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(len(batches))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert errors == [] and min(calls) > 0


def test_a_mesh_shard_takes_the_whole_batchs_padding_and_may_hold_no_image():
    pre = tpre.Preprocessor(**KW, layout="nchw", device="cpu")
    arrays = _arrays(30, BATCHES[1])  # 3 images: bucket 4, two shards of 2
    ref = pre.eager(arrays)
    padded = pre.padded_size(arrays)
    halves = [pre.run(arrays[i * 2:(i + 1) * 2], device="cpu", batch_bucket=2, padded=padded)
              for i in range(2)]
    assert torch.equal(halves[0], ref[:2]) and torch.equal(halves[1][:1], ref[2:3])
    empty = pre.run([], batch_bucket=2, padded=padded)  # a shard past the last image
    assert empty.shape == (2, 3, 32, 32) and bool(torch.isfinite(empty).all())
    with pytest.raises(tpre.ImageError, match="Empty batch"):
        pre([])


def test_stage_host_batch_is_the_jax_method():
    arrays = _arrays(40, BATCHES[0])
    got = tpre.Preprocessor(**KW, device="cpu").stage_host_batch(arrays, batch_bucket=8)
    ref = jpre.Preprocessor(**KW).stage_host_batch(arrays, batch_bucket=8)
    assert [g.shape for g in got] == [(8, 384, 384, 3), (8, 32, 384), (8, 32, 384)]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


# -- the ONNX executor ---------------------------------------------------------

ONNX_TOWERS = {
    "mct_like_text": (lambda: MctLikeTextTower(vocab=64, ctx=12, dim=64),
                      lambda b: torch.randint(0, 64, (b, 12)), "input_ids"),
    "conv_vision": (lambda: TinyConvTower(embed_dim=16),
                    lambda b: torch.randn(b, 3, 16, 16), "pixel_values"),
}


@pytest.mark.parametrize("name", list(ONNX_TOWERS))
def test_a_warm_onnx_tower_reads_nothing_on_the_host(name, tmp_path):
    make, inputs, input_name = ONNX_TOWERS[name]
    torch.manual_seed(11)
    model = make().eval()
    path = tmp_path / f"{name}.onnx"
    export(model, inputs(2), path, input_name=input_name)
    tower = onnx_exec.OnnxTower(path)
    xs = {b: inputs(b) for b in (2, 4)}
    with torch.no_grad():
        refs = {b: model(x) for b, x in xs.items()}
    with torch.inference_mode():
        with pytest.raises(captured.CaptureError, match="lift_fresh"):
            with captured.HostReadGuard():  # a cold call copies its constants in
                tower({input_name: xs[2]})
        first = tower({input_name: xs[2]})  # the warm-up: every static value seen
        made = len(tower._consts)
        with captured.HostReadGuard():
            again = tower({input_name: xs[2]})
        for b in (4, 2, 4, 2):  # two buckets in turn, each warmed once
            got = tower({input_name: xs[b]})
            torch.testing.assert_close(got, refs[b], atol=2e-5, rtol=0)
        with captured.HostReadGuard():
            tower({input_name: xs[4]})
    assert made > 0
    assert torch.equal(first, again)
    torch.testing.assert_close(first, refs[2], atol=2e-5, rtol=0)


# -- CorpusIndex ---------------------------------------------------------------

def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_search_after_add_reads_the_new_rows(monkeypatch):
    rng = np.random.default_rng(50)
    index = CorpusIndex.build(_unit_rows(rng, 200, 16), get_mesh(devices=["cpu"] * 2))
    built = []
    runner = CorpusIndex._runner

    def counting(self, qb, kb):
        built.append((qb, kb))
        return runner(self, qb, kb)

    monkeypatch.setattr(CorpusIndex, "_runner", counting)
    new = _unit_rows(rng, 10, 16)
    vals, ids = index.search(new, 1)
    assert not (ids[:, 0] >= 200).any()
    index.search(new, 1)
    assert built == [(16, 1)]  # the second search reused the first's runner
    shapes = [s.shape for s in index._shards]
    index.add(new)  # 210 rows: the shards keep their shape, their rows change
    assert [s.shape for s in index._shards] == shapes and index._runs == {}
    vals, ids = index.search(new, 1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(200, 210))
    np.testing.assert_allclose(vals[:, 0], 1.0, atol=1e-5)
    assert built == [(16, 1), (16, 1)]
    index.add(np.zeros((0, 16), np.float32))  # no row added: the runners still go
    assert index._runs == {}
    assert index.search(new[:1], 1)[1][0] == 200


def test_the_captured_functions_read_nothing_on_the_host():
    """What the card captures, audited on the CPU under the guard that
    wraps every capture: the preprocess resize over the staging buffers,
    and one device's search over its shards, whose candidates merge to the
    eager search's top-k."""
    from clip_embedder_tpu_torch.parallel import search

    pre = tpre.Preprocessor(**KW, layout="nchw", device="cpu")
    arrays = _arrays(60, BATCHES[1])
    ref = pre(arrays)
    (entry,) = pre._staging.values()
    whs, wws = entry.matrices_for(4)
    mean, std = pre._norm(torch.device("cpu"))
    rng = np.random.default_rng(61)
    shards = [torch.from_numpy(_unit_rows(rng, 16, 8)) for _ in range(2)]
    q = torch.from_numpy(_unit_rows(rng, 4, 8))
    with torch.inference_mode(), captured.HostReadGuard():
        got = tpre.resize_normalize_indexed(entry.images, whs, wws, entry.idx, mean, std,
                                            layout="nchw")
        flat = search._device_search(q, shards, [16, 9], [0, 16], 4)()
    assert torch.equal(got[:3], ref[:3])
    want = search._sharded_topk(q.numpy(), shards, [16, 9], k=4)
    merged = search._merge([flat[:2], flat[2:]], 4, q.device)
    assert len(flat) == 4 and all(torch.equal(a, b) for a, b in zip(merged, want))

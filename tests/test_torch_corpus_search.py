"""The torch port's ``CorpusIndex`` against a dense numpy top-k and against
the JAX package's ``CorpusIndex``, on the CPU (the cases of
tests/test_corpus_search.py).

The port's mesh is eight ``"cpu"`` entries, the JAX one conftest's eight
virtual devices: the rows shard over the data axis the same way, so the
padded tail, k past a shard's size, the TP mesh and incremental adds take
the same paths in both.
"""

import numpy as np
import pytest

from clip_embedder_tpu.parallel import CorpusIndex as JCorpusIndex
from clip_embedder_tpu.parallel import get_mesh as jget_mesh
from clip_embedder_tpu_torch.errors import InferenceError
from clip_embedder_tpu_torch.parallel import CorpusIndex, get_mesh
from clip_embedder_tpu_torch.parallel import search as tsearch

RTOL, ATOL = 1e-5, 1e-6


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _dense_topk(corpus, queries, k):
    scores = queries @ corpus.T
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, idx, axis=1), idx


def _mesh(model_parallel=1):
    return get_mesh(devices=["cpu"] * 8, model_parallel=model_parallel)


@pytest.mark.parametrize("n,q,k", [(100, 5, 10), (16, 3, 16), (9, 2, 4)])
def test_search_matches_dense_and_jax(n, q, k):
    """n=100 exercises the padded tail (100 % 8 != 0); n=16 k > a shard's
    size (2 rows a shard, k=16); n=9 a near-empty shard."""
    rng = np.random.default_rng(0)
    corpus = _unit_rows(rng, n, 32)
    queries = _unit_rows(rng, q, 32)
    index = CorpusIndex.build(corpus, _mesh())
    assert len(index) == n
    vals, idx = index.search(queries, k)
    dvals, _ = _dense_topk(corpus, queries, k)
    np.testing.assert_allclose(vals, dvals, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.take_along_axis(queries @ corpus.T, idx, axis=1), dvals,
                               rtol=RTOL, atol=ATOL)
    jvals, jidx = JCorpusIndex.build(corpus, jget_mesh()).search(queries, k)
    np.testing.assert_allclose(vals, jvals, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx, jidx)


def test_search_single_vector_and_tp_mesh():
    rng = np.random.default_rng(1)
    corpus = _unit_rows(rng, 40, 16)
    qv = _unit_rows(rng, 1, 16)[0]
    index = CorpusIndex.build(corpus, _mesh(model_parallel=2))
    assert len(index.devices) == 4  # the data axis of the 4 x 2 mesh
    vals, idx = index.search(qv, 3)
    assert vals.shape == (3,) and idx.shape == (3,)
    dvals, didx = _dense_topk(corpus, qv[None, :], 3)
    np.testing.assert_allclose(vals, dvals[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx, didx[0])
    jvals, jidx = JCorpusIndex.build(corpus, jget_mesh(model_parallel=2)).search(qv, 3)
    np.testing.assert_allclose(vals, jvals, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx, jidx)


def test_incremental_add_keeps_insertion_ids():
    rng = np.random.default_rng(2)
    a = _unit_rows(rng, 10, 8)
    b = _unit_rows(rng, 7, 8)
    index = CorpusIndex(_mesh(), 8)
    index.add(a)
    index.add(b)
    assert len(index) == 17
    full = np.concatenate([a, b])
    q = _unit_rows(rng, 2, 8)
    vals, idx = index.search(q, 17)
    dvals, didx = _dense_topk(full, q, 17)
    np.testing.assert_allclose(vals, dvals, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(idx, didx)
    jindex = JCorpusIndex(jget_mesh(), 8)
    jindex.add(a)
    jindex.add(b)
    np.testing.assert_array_equal(idx, jindex.search(q, 17)[1])


def test_search_errors():
    index = CorpusIndex(_mesh(), 8)
    with pytest.raises(InferenceError, match="Empty corpus"):
        index.search(np.zeros(8, np.float32), 1)
    index.add(np.eye(8, dtype=np.float32)[:4])
    with pytest.raises(InferenceError, match="k="):
        index.search(np.zeros(8, np.float32), 5)
    with pytest.raises(InferenceError, match="query dim"):
        index.search(np.zeros(4, np.float32), 1)
    with pytest.raises(InferenceError, match="corpus rows"):
        index.add(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="precision"):
        CorpusIndex(_mesh(), 8, precision="high")


def test_search_texts_through_clip(tmp_path):
    """search_texts = embed the queries through Clip.text, then the corpus
    top-k — on a port Clip and a JAX Clip over one model dir."""
    from test_concurrency import make_model_dir

    from clip_embedder_tpu import Clip as JClip
    from clip_embedder_tpu_torch import Clip

    d = make_model_dir()
    clip = Clip.from_local_dir(d, device="cpu")
    rng = np.random.default_rng(3)
    corpus = _unit_rows(rng, 24, 32)
    vals, idx = CorpusIndex.build(corpus, _mesh()).search_texts(clip, ["a cat", "a dog"], 5)
    assert vals.shape == (2, 5) and idx.shape == (2, 5)
    embs = clip.text.embed_texts(["a cat", "a dog"])
    dvals, _ = _dense_topk(corpus, np.asarray(embs, np.float32), 5)
    np.testing.assert_allclose(vals, dvals, rtol=1e-4, atol=1e-5)
    jvals, jidx = JCorpusIndex.build(corpus, jget_mesh()).search_texts(
        JClip.from_local_dir(d), ["a cat", "a dog"], 5)
    np.testing.assert_allclose(vals, jvals, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(idx, jidx)


def test_search_shapes_bucket_to_bounded_shape_set(monkeypatch):
    """Varying Q and k reach the sharded product at power-of-two shapes
    (the JAX package's bounded set of compiled programs), and adds within
    one per-shard row bucket keep the shards' shape."""
    shapes = []
    real = tsearch._sharded_topk

    def spy(queries, shards, counts, *, k):
        shapes.append((queries.shape[0], k))
        return real(queries, shards, counts, k=k)

    monkeypatch.setattr(tsearch, "_sharded_topk", spy)
    rng = np.random.default_rng(3)
    corpus = _unit_rows(rng, 200, 32)
    index = CorpusIndex.build(corpus, _mesh())
    qs = _unit_rows(rng, 7, 32)
    vals, ids = index.search(qs, k=5)  # Q=7->8, k=5->8
    dv, di = _dense_topk(corpus, qs, 5)
    np.testing.assert_array_equal(ids, di)
    np.testing.assert_allclose(vals, dv, rtol=0, atol=1e-5)
    index.search(_unit_rows(rng, 5, 32), k=6)   # 5->8, 6->8
    index.search(_unit_rows(rng, 8, 32), k=8)   # exact bucket
    assert set(shapes) == {(8, 8)}
    rows = index.rows_per_shard
    index.add(_unit_rows(rng, 10, 32))  # 210 rows -> still 32 a shard
    assert index.rows_per_shard == rows == 32
    assert [s.shape for s in index._shards] == [(32, 32)] * 8

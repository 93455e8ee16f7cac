"""The torch port's serving layer on the CPU: ``MicroBatcher`` (the cases of
tests/test_serving.py), ``ClipServer`` (the cases of
tests/test_serving_http.py, a mesh-backed server's included) over a port
``Clip`` on the dir tests/test_concurrency.py writes, the same requests to
a JAX server and a port server over that dir, the divergences from the JAX
server (a capped request body, a socket timeout, images decoded in the
handler threads), ``warmup`` / ``timed`` / ``trace``, and the
thread-safety of the preprocess LRU that the server's threads share."""

import base64
import concurrent.futures as cf
import http.client
import io
import json
import socket
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from clip_embedder_tpu_torch import Clip, serving
from clip_embedder_tpu_torch.errors import InferenceError
from clip_embedder_tpu_torch.serving import ClipServer, MicroBatcher

from test_concurrency import make_model_dir


def ident_embed(items):
    """Row i encodes item i, so a row routed to the wrong caller shows."""
    return np.stack([np.full(4, float(v), np.float32) for v in items])


# -- MicroBatcher (tests/test_serving.py) ------------------------------------

def test_results_route_to_the_right_caller():
    with MicroBatcher(ident_embed, max_batch=8, max_delay_ms=20) as mb:
        futs = [mb.submit(i) for i in range(20)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=10), np.full(4, float(i), np.float32))
    assert mb.items == 20
    assert mb.batches >= 3  # max_batch=8 caps every window


def test_concurrent_callers_coalesce_into_few_batches():
    n = 32
    barrier = threading.Barrier(n)
    results = [None] * n
    with MicroBatcher(ident_embed, max_batch=n, max_delay_ms=150) as mb:
        def caller(i):
            barrier.wait()
            results[i] = mb.embed(i)

        threads = [threading.Thread(target=caller, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        batches = mb.batches
    for i, r in enumerate(results):
        np.testing.assert_array_equal(r, np.full(4, float(i), np.float32))
    assert batches <= 8, batches


def test_single_item_latency_bounded_by_window():
    with MicroBatcher(ident_embed, max_batch=64, max_delay_ms=30) as mb:
        t0 = time.monotonic()
        mb.embed(7)
        elapsed = time.monotonic() - t0
    assert elapsed < 5.0  # one 30 ms window and slack, not a wait for a full batch


def test_failed_window_propagates_only_to_its_callers():
    calls = []

    def flaky(items):
        calls.append(list(items))
        if len(calls) == 1:
            raise InferenceError("boom")
        return ident_embed(items)

    with MicroBatcher(flaky, max_batch=4, max_delay_ms=10) as mb:
        bad = mb.submit(1)
        with pytest.raises(InferenceError, match="boom"):
            bad.result(timeout=10)
        good = mb.embed(2)
    np.testing.assert_array_equal(good, np.full(4, 2.0, np.float32))


def test_row_count_mismatch_is_an_inference_error():
    with MicroBatcher(lambda items: np.zeros((len(items) + 1, 4)), max_batch=2,
                      max_delay_ms=5) as mb:
        fut = mb.submit(1)
        with pytest.raises(InferenceError, match="rows"):
            fut.result(timeout=10)


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_base_exception_fails_callers_instead_of_hanging():
    def interrupted(items):
        raise KeyboardInterrupt

    mb = MicroBatcher(interrupted, max_batch=4, max_delay_ms=5)
    fut = mb.submit(1)
    with pytest.raises(InferenceError, match="KeyboardInterrupt"):
        fut.result(timeout=10)
    mb._worker.join(timeout=10)
    assert not mb._worker.is_alive()
    with pytest.raises(InferenceError, match="closed"):
        mb.submit(2)


def test_close_drains_then_rejects():
    mb = MicroBatcher(ident_embed, max_batch=4, max_delay_ms=5)
    futs = [mb.submit(i) for i in range(10)]
    mb.close()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=10), np.full(4, float(i), np.float32))
    with pytest.raises(InferenceError, match="closed"):
        mb.submit(99)
    mb.close()  # idempotent


def test_submit_close_race_never_hangs_a_future():
    for _ in range(20):
        mb = MicroBatcher(ident_embed, max_batch=4, max_delay_ms=1)
        results = []

        def submitter():
            try:
                results.append(mb.submit(7))
            except InferenceError:
                results.append(None)

        threads = [threading.Thread(target=submitter) for _ in range(8)]
        for t in threads:
            t.start()
        mb.close()
        for t in threads:
            t.join(timeout=10)
        for fut in results:
            if fut is None:
                continue  # rejected cleanly
            try:
                np.testing.assert_array_equal(fut.result(timeout=5),
                                              np.full(4, 7.0, np.float32))
            except InferenceError:
                pass  # failed by the close-drain: resolved all the same


def test_max_batch_must_be_positive():
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(ident_embed, max_batch=0)


# -- a port Clip on the CPU ----------------------------------------------------

@pytest.fixture(scope="module")
def model_dir():
    return make_model_dir()


@pytest.fixture(scope="module")
def clip(model_dir):
    return Clip.from_local_dir(model_dir, device="cpu")


def test_end_to_end_with_real_embedder(clip):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (32, 32, 3), np.uint8) for _ in range(8)]
    direct = clip.vision.embed_images(imgs)
    with MicroBatcher(clip.vision.embed_images, max_batch=8, max_delay_ms=100) as mb:
        rows = [f.result(timeout=120) for f in [mb.submit(img) for img in imgs]]
        batches = mb.batches
    for got, want in zip(rows, direct):
        np.testing.assert_allclose(got, want, atol=2e-6)
    assert batches <= 4


def test_warmup_runs_every_bucket(clip, monkeypatch, caplog):
    from clip_embedder_tpu_torch.utils.logging import get_logger

    # the logger's first call sets its level from CLIP_TPU_LOG: made here, it
    # leaves caplog's level in force whichever test ran first
    get_logger()
    calls = []
    for emb, name in ((clip.vision, "embed_images"), (clip.text, "embed_texts")):
        real = getattr(emb, name)
        monkeypatch.setattr(emb, name, lambda xs, real=real, name=name:
                            calls.append((name, len(xs))) or real(xs))
    with caplog.at_level("INFO", logger="clip_embedder_tpu_torch"):
        serving.warmup(clip, batch_sizes=(1, 2), image_sizes=((20, 30),))
    assert calls == [("embed_images", 1), ("embed_texts", 1), ("embed_images", 2),
                     ("embed_texts", 2)]
    assert "warmup vision batch=2 src=20x30" in caplog.text
    calls.clear()
    serving.warmup(clip.vision, batch_sizes=(4,), image_sizes=((8, 8),))
    assert calls == [("embed_images", 4)]


def test_trace_writes_a_chrome_trace(clip, tmp_path):
    from clip_embedder_tpu_torch.utils.logging import span, trace

    def other():
        with span("test.other_thread"):
            time.sleep(0.01)

    with trace(tmp_path / "t") as log_dir:
        clip.text.embed_texts(["a cat"])
        worker = threading.Thread(target=other)  # as a micro-batcher's collector
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    events = json.loads((log_dir / "trace.json").read_text())["traceEvents"]
    assert events
    # every thread is profiled: the other thread's span is in the trace
    assert [e["tid"] for e in events if e.get("name") == "test.other_thread"] == [worker.native_id]


# -- ClipServer (tests/test_serving_http.py) ----------------------------------

@pytest.fixture(scope="module")
def served(clip):
    with ClipServer(clip, max_delay_ms=5.0) as server:
        yield clip, server


def _url(server, path):
    host, port = server.address
    return f"http://{host}:{port}{path}"


def _post(server, path, data, ctype="application/json"):
    if isinstance(data, dict):
        data = json.dumps(data).encode()
    req = urllib.request.Request(_url(server, path), data=data,
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _jpeg(seed: int) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (48, 64, 3), dtype=np.uint8)
                    ).save(buf, format="JPEG")
    return buf.getvalue()


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def test_healthz(served):
    _, server = served
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"


def test_embed_image_raw_bytes_matches_direct(served):
    clip, server = served
    jpg = _jpeg(0)
    got = _post(server, "/v1/embed/image", jpg, ctype="image/jpeg")
    np.testing.assert_allclose(np.asarray(got["embeddings"][0], np.float32),
                               clip.vision.embed_image(jpg), atol=1e-5)


def test_embed_image_json_batch(served):
    clip, server = served
    jpgs = [_jpeg(1), _jpeg(2)]
    got = _post(server, "/v1/embed/image", {"images_b64": [_b64(j) for j in jpgs]})
    np.testing.assert_allclose(np.asarray(got["embeddings"], np.float32),
                               clip.vision.embed_images(jpgs), atol=1e-5)


def test_embed_text_single_and_batch(served):
    clip, server = served
    got = _post(server, "/v1/embed/text", {"texts": "a photo of a cat"})
    np.testing.assert_allclose(np.asarray(got["embeddings"][0], np.float32),
                               clip.text.embed_text("a photo of a cat"), atol=1e-5)
    texts = ["a cat", "a dog", "a beignet"]
    got = _post(server, "/v1/embed/text", {"texts": texts})
    np.testing.assert_allclose(np.asarray(got["embeddings"], np.float32),
                               clip.text.embed_texts(texts), atol=1e-5)


def test_classify_and_rank_parity(served):
    clip, server = served
    jpg = _jpeg(3)
    labels = ["a photo of a cat", "a photo of a dog"]
    got = _post(server, "/v1/classify", {"image_b64": _b64(jpg), "labels": labels})
    expect = clip.classify(jpg, labels)
    assert [r[0] for r in got["results"]] == [e[0] for e in expect]
    np.testing.assert_allclose([r[1] for r in got["results"]], [e[1] for e in expect],
                               atol=1e-5)
    jpgs = [_jpeg(4), _jpeg(5)]
    got = _post(server, "/v1/rank", {"images_b64": [_b64(j) for j in jpgs], "text": "the cat"})
    expect = clip.rank_images(jpgs, "the cat")
    assert [r[0] for r in got["results"]] == [e[0] for e in expect]


def test_concurrent_singles_coalesce(served):
    clip, server = served
    jpg = _jpeg(6)
    expect = clip.vision.embed_image(jpg)
    before = server._vision_batcher.batches

    def one(_):
        return _post(server, "/v1/embed/image", jpg, ctype="image/jpeg")

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(one, range(16)))
    for got in results:
        np.testing.assert_allclose(np.asarray(got["embeddings"][0], np.float32), expect,
                                   atol=1e-5)
    assert server._vision_batcher.batches - before < 16


@pytest.mark.parametrize("path,payload,ctype,expect_error", [
    ("/v1/embed/image", b"not an image", "image/jpeg", "ImageError"),
    ("/v1/embed/image", {"images_b64": []}, "application/json", "InferenceError"),
    ("/v1/embed/text", b"{bad json", "application/json", "JSONDecodeError"),
    ("/v1/classify", {"labels": ["x"]}, "application/json", "KeyError"),
])
def test_client_errors_are_400(served, path, payload, ctype, expect_error):
    _, server = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, path, payload, ctype=ctype)
    assert ei.value.code == 400
    body = json.loads(ei.value.read())
    assert expect_error in body["error"], body


def test_unknown_routes_are_404(served):
    _, server = served
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(server, "/v1/nope", {}, ctype="application/json")
    assert ei.value.code == 404
    assert json.loads(ei.value.read())["error"] == "NotFound"
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(_url(server, "/nope"), timeout=30)
    assert ei.value.code == 404


def test_submit_after_close_rejected(clip):
    server = ClipServer(clip)
    server.close()
    with pytest.raises(urllib.error.URLError):
        _post(server, "/v1/embed/text", {"texts": "x"})


def test_shutdown_race_maps_clip_errors_to_503(served):
    _, server = served
    server._closing = True  # the close() window, listener still up
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server, "/v1/embed/text", {"texts": []})
        assert ei.value.code == 503
    finally:
        server._closing = False


def test_metrics_endpoint(served):
    _, server = served
    _post(server, "/v1/embed/text", {"texts": ["metrics probe"]})
    _post(server, "/v1/embed/image", _jpeg(21), "image/jpeg")
    with pytest.raises(urllib.error.HTTPError):
        _post(server, "/v1/embed/text", {"texts": []})
    with urllib.request.urlopen(_url(server, "/v1/metrics"), timeout=30) as r:
        snap = json.loads(r.read())
    assert snap["requests"]["/v1/embed/text"] >= 1
    assert snap["items"]["/v1/embed/image"] >= 1
    lat = snap["latency"]["/v1/embed/text"]
    assert lat["p50_ms"] > 0 and lat["p95_ms"] >= lat["p50_ms"]
    assert any(k.startswith("/v1/embed/text:") for k in snap["errors"])
    assert snap["micro_batches"]["vision"] >= 1
    assert snap["uptime_s"] >= 0
    # the process's CUDA graph captures by what they hold (none on the CPU)
    from clip_embedder_tpu_torch.utils.logging import count

    count("graphs.captures", "a probe")
    with urllib.request.urlopen(_url(server, "/v1/metrics"), timeout=30) as r:
        captures = json.loads(r.read())["captures"]
    assert captures["a probe"] == snap["captures"].get("a probe", 0) + 1


# -- a mesh-backed deployment (the mesh cases of tests/test_serving_http.py):
# the same HTTP surface over the sharded embedders, on a mesh of eight CPU
# entries; every path must agree with the single-device port Clip

@pytest.fixture(scope="module")
def served_mesh(clip):
    from clip_embedder_tpu_torch.parallel import get_mesh

    with ClipServer(clip, max_delay_ms=5.0, mesh=get_mesh(devices=["cpu"] * 8)) as server:
        yield clip, server


def test_mesh_server_serves_image_embeddings(served_mesh):
    clip, server = served_mesh
    assert server.mesh is not None and dict(server.mesh.shape) == {"data": 8, "model": 1}
    jpg = _jpeg(9)
    got = _post(server, "/v1/embed/image", jpg, "image/jpeg")
    np.testing.assert_allclose(np.asarray(got["embeddings"][0], np.float32),
                               clip.vision.embed_image(jpg), atol=1e-4)
    with ClipServer(clip) as plain:
        assert plain.mesh is None


def test_mesh_server_embeds_match_single_device(served_mesh):
    clip, server = served_mesh
    jpgs = [_jpeg(10), _jpeg(11), _jpeg(12)]
    got = _post(server, "/v1/embed/image", {"images_b64": [_b64(j) for j in jpgs]})
    np.testing.assert_allclose(np.asarray(got["embeddings"], np.float32),
                               clip.vision.embed_images(jpgs), atol=1e-4)
    texts = ["a cat", "a dog", "a beignet", "x"]
    got = _post(server, "/v1/embed/text", {"texts": texts})
    np.testing.assert_allclose(np.asarray(got["embeddings"], np.float32),
                               clip.text.embed_texts(texts), atol=1e-4)


def test_mesh_server_classify_and_rank_parity(served_mesh):
    clip, server = served_mesh
    jpg = _jpeg(13)
    labels = ["a photo of a cat", "a photo of a dog"]
    got = _post(server, "/v1/classify", {"image_b64": _b64(jpg), "labels": labels})
    expect = clip.classify(jpg, labels)
    assert [r[0] for r in got["results"]] == [e[0] for e in expect]
    np.testing.assert_allclose([r[1] for r in got["results"]], [e[1] for e in expect],
                               atol=1e-4)
    jpgs = [_jpeg(14), _jpeg(15)]
    got = _post(server, "/v1/rank", {"images_b64": [_b64(j) for j in jpgs], "text": "the cat"})
    expect = clip.rank_images(jpgs, "the cat")
    assert [r[0] for r in got["results"]] == [e[0] for e in expect]


def test_mesh_server_concurrent_singles_coalesce(served_mesh):
    clip, server = served_mesh
    jpg = _jpeg(16)
    expect = clip.vision.embed_image(jpg)
    before = server._vision_batcher.batches
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        results = list(pool.map(lambda _: _post(server, "/v1/embed/image", jpg, "image/jpeg"),
                                range(16)))
    for got in results:
        np.testing.assert_allclose(np.asarray(got["embeddings"][0], np.float32), expect,
                                   atol=1e-4)
    # concurrent singles share sharded device steps, as on one device
    assert server._vision_batcher.batches - before < 16


# -- the port's departures from the JAX server --------------------------------

def test_body_over_the_cap_is_413_unread(served):
    """The JAX server reads whatever Content-Length a client sends
    (clip_embedder_tpu/serving.py:384): one request can make it allocate
    and wait for any number of bytes. The port answers 413 from the header
    alone, before reading, and drops the connection."""
    _, server = served
    conn = http.client.HTTPConnection(*server.address, timeout=30)
    try:
        conn.putrequest("POST", "/v1/embed/image")
        conn.putheader("Content-Type", "image/jpeg")
        conn.putheader("Content-Length", str(serving.MAX_BODY_BYTES + 1))
        conn.endheaders()  # and no body at all
        resp = conn.getresponse()
        assert resp.status == 413
        assert json.loads(resp.read())["error"] == "PayloadTooLarge"
    finally:
        conn.close()
    snap = _metrics(server)
    assert snap["errors"]["/v1/embed/image:PayloadTooLarge"] >= 1
    _post(server, "/v1/embed/text", {"texts": "still serving"})


def test_negative_content_length_is_400(served):
    _, server = served
    conn = http.client.HTTPConnection(*server.address, timeout=30)
    try:
        conn.putrequest("POST", "/v1/embed/text")
        conn.putheader("Content-Length", "-5")
        conn.endheaders()
        assert conn.getresponse().status == 400
    finally:
        conn.close()


def _metrics(server):
    with urllib.request.urlopen(_url(server, "/v1/metrics"), timeout=30) as r:
        return json.loads(r.read())


def test_stalled_body_times_out(clip, monkeypatch):
    """The JAX server sets no socket timeout: a client that announces a
    body and never sends it holds a handler thread forever. The port's
    handler gives up after REQUEST_TIMEOUT_S (shortened here) with 408."""
    monkeypatch.setattr(serving, "REQUEST_TIMEOUT_S", 0.5)
    with ClipServer(clip) as server, socket.create_connection(server.address,
                                                              timeout=30) as sock:
        sock.sendall(b"POST /v1/embed/text HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\nContent-Length: 100\r\n\r\n{")
        t0 = time.monotonic()
        reply = b""
        while chunk := sock.recv(4096):
            reply += chunk
        assert time.monotonic() - t0 < 20
        assert reply.startswith(b"HTTP/1.0 408"), reply[:80]
        assert b"RequestTimeout" in reply


def test_undecodable_image_fails_only_its_own_request(clip):
    """Requests released together into one window (a 300 ms window, max
    batch 8), one of them not an image. The JAX server submits each
    request's raw bytes to the micro-batcher, whose ``embed_images`` then
    raises for the whole window: every request in it gets 400. The port
    decodes in the handler thread, so the bad upload gets its 400 and the
    others their rows."""
    jpgs = [_jpeg(40 + i) for i in range(4)]
    bodies = jpgs[:2] + [b"not an image"] + jpgs[2:]
    gate = threading.Barrier(len(bodies))

    def one(body):
        gate.wait()
        try:
            return 200, _post(server, "/v1/embed/image", body, "image/jpeg")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with ClipServer(clip, max_batch=8, max_delay_ms=300.0) as server:
        with cf.ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            replies = list(pool.map(one, bodies))
        windows = server._vision_batcher.batches
    assert [code for code, _ in replies] == [200, 200, 400, 200, 200]
    assert replies[2][1]["error"] == "ImageError"
    good = [r["embeddings"][0] for code, r in replies if code == 200]
    np.testing.assert_allclose(np.asarray(good, np.float32), clip.vision.embed_images(jpgs),
                               atol=1e-5)
    assert windows <= 2


def test_a_burst_of_64_uploads_is_served(served):
    """64 clients released together, each uploading one JPEG. The JAX
    server listens with socketserver's backlog of 5: on this test's host,
    44-46 of such a burst's connections were reset. The port's server
    listens with a backlog of 128 and serves every one, with the direct
    call's row."""
    clip, server = served
    jpg = _jpeg(50)
    expect = clip.vision.embed_image(jpg)
    gate = threading.Barrier(64)

    def one(_):
        gate.wait()
        conn = http.client.HTTPConnection(*server.address, timeout=60)
        try:
            conn.request("POST", "/v1/embed/image", body=jpg,
                         headers={"Content-Type": "image/jpeg"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    with cf.ThreadPoolExecutor(max_workers=64) as pool:
        replies = list(pool.map(one, range(64)))
    assert [code for code, _ in replies] == [200] * 64
    for _, reply in replies:
        np.testing.assert_allclose(np.asarray(reply["embeddings"][0], np.float32), expect,
                                   atol=1e-5)


# -- the same requests to a JAX server and a port server ----------------------

def test_jax_and_port_servers_agree(model_dir, served):
    """One JAX server (the JAX Clip) and one port server (the port's Clip
    on the CPU) over the same dir: the same requests give embeddings within
    1e-5 and the same classify and rank order."""
    from clip_embedder_tpu import Clip as JaxClip
    from clip_embedder_tpu.serving import ClipServer as JaxServer

    _, port_server = served
    jpgs = [_jpeg(30), _jpeg(31), _jpeg(32)]
    labels = ["a photo of a cat", "a photo of a dog", "a beignet"]
    requests = [
        ("/v1/embed/image", jpgs[0], "image/jpeg"),
        ("/v1/embed/image", {"images_b64": [_b64(j) for j in jpgs]}, "application/json"),
        ("/v1/embed/text", {"texts": "a photo of a cat"}, "application/json"),
        ("/v1/embed/text", {"texts": labels}, "application/json"),
        ("/v1/classify", {"image_b64": _b64(jpgs[1]), "labels": labels}, "application/json"),
        ("/v1/rank", {"images_b64": [_b64(j) for j in jpgs], "text": "the cat"},
         "application/json"),
    ]
    with JaxServer(JaxClip.from_local_dir(model_dir), max_delay_ms=5.0) as jax_server:
        for path, payload, ctype in requests:
            got = _post(port_server, path, payload, ctype)
            ref = _post(jax_server, path, payload, ctype)
            assert sorted(got) == sorted(ref)
            if "embeddings" in ref:
                np.testing.assert_allclose(np.asarray(got["embeddings"], np.float32),
                                           np.asarray(ref["embeddings"], np.float32),
                                           atol=1e-5, err_msg=path)
            else:
                assert [r[0] for r in got["results"]] == [r[0] for r in ref["results"]]
                np.testing.assert_allclose([r[1] for r in got["results"]],
                                           [r[1] for r in ref["results"]], atol=1e-5)


# -- threads sharing one Preprocessor -----------------------------------------

def test_preprocess_weight_lru_is_thread_safe():
    """Eight threads hit one resize-weight LRU, as a server's handler
    threads and its micro-batcher do through one Preprocessor. Unlike
    clip_embedder_tpu/ops/preprocess.py:272-288, whose hit path pops and
    re-inserts the key unguarded (a second thread's pop then raises
    KeyError), the port holds a lock around the cache. The cache is cut to
    two entries over three keys here, so hits, misses and evictions all
    race; a short switch interval makes the interleavings frequent."""
    from clip_embedder_tpu_torch.ops.preprocess import Preprocessor, preprocess_weights_for

    pre = Preprocessor(image_size=32, mean=(0.5,) * 3, std=(0.5,) * 3,
                       interpolation="bicubic", resize_mode="shortest", device="cpu")
    pre._WEIGHTS_CACHE_MAX = 2
    keys = [(100, 100, 128, 128), (100, 100, 128, 128), (60, 90, 128, 128),
            (100, 100, 128, 128), (90, 60, 128, 128)]
    want = {k: preprocess_weights_for(k[0], k[1], 32, interpolation="bicubic",
                                      resize_mode="shortest", padded_h=k[2], padded_w=k[3])
            for k in set(keys)}
    errors, calls = [], [0] * 8
    stop = time.monotonic() + 2.0

    def hammer(i):
        try:
            while time.monotonic() < stop:
                k = keys[calls[i] % len(keys)]
                wh, ww = pre._weights(*k)
                if not (np.array_equal(wh, want[k][0]) and np.array_equal(ww, want[k][1])):
                    raise AssertionError(f"wrong matrices for {k}")
                calls[i] += 1
        except Exception as e:  # noqa: BLE001 (every failure is the finding)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert min(calls) > 0
    assert len(pre._weights_cache) <= 2


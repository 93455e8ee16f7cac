"""Serving: ``warmup`` (build the kernels and touch the batch buckets a
deployment will hit before traffic arrives), ``MicroBatcher`` (coalesce
single-item requests from concurrent callers into one device step per
window) and ``ClipServer`` (a stdlib HTTP service over a ``Clip``).

Counterpart of ``clip_embedder_tpu.serving``, with the same endpoints,
status codes and JSON shapes. The reference scales concurrent callers by
replicating sessions (``duplicate()``, reference src/clip.rs:69-73); on one
card one large batch beats many small ones, so concurrent single-item
requests share a forward instead. Every server thread launches on the
card's current stream, so their launches run in stream order.

Where the JAX package's server departs from that contract, this one does
not copy it: a request body over ``MAX_BODY_BYTES`` is answered 413
without being read (the JAX server reads any ``Content-Length``), a
connection that sends nothing for ``REQUEST_TIMEOUT_S`` is dropped (408
when it stalls inside a body), a single image is decoded in its handler
thread before it joins a micro-batch (the JAX server's collector decodes
them, in turn, and one undecodable image fails its whole window), and the
listen backlog is 128, not socketserver's 5, under which a burst of
concurrent uploads has its connections reset.
``mesh=`` (a sharded deployment) is not ported yet.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from collections import Counter, defaultdict, deque
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterable, Sequence

import numpy as np

from .errors import ClipError, ConfigError, InferenceError
from .utils.images import to_rgb_array
from .utils.logging import get_logger, timed

# the largest request body read (a JSON batch of 32 base64 JPEGs of a few
# MB each fits); a larger Content-Length is answered 413 unread
MAX_BODY_BYTES = 64 << 20
# seconds a connection may leave a request line, header or body unsent
REQUEST_TIMEOUT_S = 30.0


def warmup(
    clip_or_embedder,
    *,
    batch_sizes: Iterable[int] = (1, 8, 32),
    image_sizes: Iterable[tuple[int, int]] = ((512, 512),),
    texts: bool = True,
) -> None:
    """Run the embed paths once at each batch bucket, so that no request
    pays the first call's cost (the kernels' nvcc build on the card, the
    rope tables, cuBLAS's first choice of algorithm).

    Accepts a ``Clip`` or a single embedder; ``image_sizes`` are source
    sizes (before the resize).
    """
    logger = get_logger()
    vision = getattr(clip_or_embedder, "vision", None)
    text = getattr(clip_or_embedder, "text", None)
    if vision is None and hasattr(clip_or_embedder, "embed_images"):
        vision = clip_or_embedder
    if text is None and hasattr(clip_or_embedder, "embed_texts"):
        text = clip_or_embedder

    rng = np.random.default_rng(0)
    for batch in batch_sizes:
        if vision is not None:
            for h, w in image_sizes:
                with timed(f"warmup vision batch={batch} src={h}x{w}", logger):
                    vision.embed_images([rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                                         for _ in range(batch)])
        if text is not None and texts:
            with timed(f"warmup text batch={batch}", logger):
                text.embed_texts(["warmup"] * batch)


_STOP = object()


class ServerMetrics:
    """Thread-safe per-endpoint serving metrics: requests, items, errors,
    and latency percentiles over a sliding window (``GET /v1/metrics``)."""

    _WINDOW = 2048  # latency samples kept per endpoint

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._requests: dict[str, int] = Counter()
        self._items: dict[str, int] = Counter()
        self._errors: dict[str, int] = Counter()
        self._lat = defaultdict(lambda: deque(maxlen=self._WINDOW))
        self._t0 = time.time()

    def observe(self, endpoint: str, *, items: int, seconds: float,
                error: str | None = None) -> None:
        with self._lock:
            self._requests[endpoint] += 1
            self._items[endpoint] += items
            if error is not None:
                self._errors[f"{endpoint}:{error}"] += 1
            else:
                self._lat[endpoint].append(seconds * 1e3)

    def snapshot(self) -> dict:
        with self._lock:
            lat = {}
            for ep, window in self._lat.items():
                if not window:
                    continue
                s = sorted(window)
                lat[ep] = {
                    "p50_ms": round(s[len(s) // 2], 3),
                    "p95_ms": round(s[int(len(s) * 0.95)], 3),
                    "max_ms": round(s[-1], 3),
                    "window": len(s),
                }
            return {
                "uptime_s": round(time.time() - self._t0, 1),
                "requests": dict(self._requests),
                "items": dict(self._items),
                "errors": dict(self._errors),
                "latency": lat,
            }


class _NoSuchEndpoint(Exception):
    """Unknown route: HTTP 404 (a wrong URL is not a malformed request)."""


class _PayloadTooLarge(Exception):
    """A Content-Length over ``MAX_BODY_BYTES``: HTTP 413."""


class MicroBatcher:
    """Coalesce single-item embed requests from concurrent callers into
    batched device steps.

    ``embed_fn`` maps a list of items to an ``[N, D]`` array (a bound
    ``VisionEmbedder.embed_images`` or ``TextEmbedder.embed_texts``, or any
    callable with that contract). A collector thread drains the submission
    queue: the first item opens a window, further items join until
    ``max_batch`` is reached or ``max_delay_ms`` elapses, then the whole
    window runs as one forward. A request waits at most ``max_delay_ms``
    plus one device step.

    The embedders pad a batch to a power of two, so a ``max_batch`` equal
    to a warmed bucket (``warmup(..., batch_sizes=...)``) keeps first calls
    out of the traffic.

    Thread-safe; a context manager. A failed forward fails exactly the
    callers whose items were in that window; later windows are unaffected.
    """

    def __init__(
        self,
        embed_fn: Callable[[Sequence[Any]], np.ndarray],
        *,
        max_batch: int = 32,
        max_delay_ms: float = 2.0,
    ) -> None:
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._embed_fn = embed_fn
        self._max_batch = int(max_batch)
        self._max_delay = float(max_delay_ms) / 1e3
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        # makes submit()'s closed-check + put atomic against close(): without
        # it a submit could pass the check, lose the CPU, and enqueue behind
        # a drained fence, leaving its Future unresolved forever
        self._submit_lock = threading.Lock()
        self.batches = 0   # windows run
        self.items = 0     # items embedded
        self._worker = threading.Thread(target=self._run, name="clip-microbatcher",
                                        daemon=True)
        self._worker.start()

    # -- submission ---------------------------------------------------------

    def submit(self, item: Any) -> "Future[np.ndarray]":
        """Enqueue one item; resolves to its ``[D]`` embedding row."""
        fut: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise InferenceError("MicroBatcher is closed")
            self._queue.put((item, fut))
        return fut

    def embed(self, item: Any) -> np.ndarray:
        """Blocking form of :meth:`submit`."""
        return self.submit(item).result()

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Drain the items already submitted, then stop the collector.
        Later :meth:`submit` calls raise ``InferenceError``."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True      # reject new work first,
            self._queue.put(_STOP)   # then fence the queue (FIFO: earlier
        self._worker.join()          # submissions drain before the fence)
        # the lock keeps a submit from slipping behind the fence; fail any
        # leftover all the same rather than leave it hanging
        while True:
            try:
                leftover = self._queue.get_nowait()
            except queue.Empty:
                break
            if leftover is not _STOP:
                leftover[1].set_exception(InferenceError("MicroBatcher is closed"))

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- collector ----------------------------------------------------------

    def _run(self) -> None:
        logger = get_logger()
        while True:
            first = self._queue.get()
            if first is _STOP:
                return
            window = [first]
            deadline = time.monotonic() + self._max_delay
            stop = False
            while len(window) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                window.append(nxt)
            items = [item for item, _ in window]
            try:
                rows = self._embed_fn(items)
            except Exception as e:  # to this window's callers
                for _, fut in window:
                    fut.set_exception(e)
            except BaseException as e:
                # KeyboardInterrupt / SystemExit in embed_fn: fail this
                # window's and every queued future, so blocked callers do not
                # hang on a dead collector, close the batcher, and re-raise
                err = InferenceError(f"embed_fn raised {type(e).__name__}; batcher closed")
                with self._submit_lock:
                    self._closed = True
                    for _, fut in window:
                        fut.set_exception(err)
                    while True:
                        try:
                            queued = self._queue.get_nowait()
                        except queue.Empty:
                            break
                        if queued is not _STOP:
                            queued[1].set_exception(err)
                raise
            else:
                if len(rows) != len(window):
                    err = InferenceError(
                        f"embed_fn returned {len(rows)} rows for {len(window)} items")
                    for _, fut in window:
                        fut.set_exception(err)
                else:
                    for (_, fut), row in zip(window, rows):
                        fut.set_result(np.asarray(row))
            self.batches += 1
            self.items += len(window)
            logger.debug("microbatch: %d items", len(window))
            if stop:
                return


class _HTTPServer(ThreadingHTTPServer):
    # a listen backlog for a burst of concurrent clients: with socketserver's
    # 5, most connections of a burst of 64 uploads were reset
    request_queue_size = 128


class ClipServer:
    """A minimal HTTP embedding service over a ``Clip`` (stdlib
    ``ThreadingHTTPServer``). Single-item image and text requests ride one
    :class:`MicroBatcher` per modality, so concurrent callers coalesce into
    batched device steps; list requests go straight to the bulk embed path.

    Endpoints (JSON unless noted):

    - ``GET  /healthz`` → ``{"status": "ok", "batches": n}``
    - ``POST /v1/embed/image``: body = raw image bytes (any ``image/*`` or
      ``application/octet-stream`` type), or JSON ``{"images_b64": [...]}``
      → ``{"embeddings": [[...], ...]}``
    - ``POST /v1/embed/text``: ``{"texts": ["...", ...]}`` (or one string)
      → ``{"embeddings": [[...], ...]}``
    - ``POST /v1/classify``: ``{"image_b64": "...", "labels": [...]}`` →
      ``{"results": [[label, prob], ...]}``, descending (the reference's
      classify, src/clip.rs:94-132)
    - ``POST /v1/rank``: ``{"images_b64": [...], "text": "..."}`` →
      ``{"results": [[index, prob], ...]}``, descending
    - ``GET  /v1/metrics`` → :class:`ServerMetrics`' snapshot plus the
      micro-batch counts

    Client errors (bad JSON, an undecodable image, an empty batch) are 400
    with ``{"error": <class>, "message": ...}``; a ``ClipError`` while the
    server closes is 503; an unknown route 404; a body over
    ``MAX_BODY_BYTES`` 413; a body stalled past ``REQUEST_TIMEOUT_S`` 408;
    anything else 500. Binds loopback by default: put a real ingress in
    front for anything public. Call :func:`warmup` first, so that no
    request pays the kernels' build.
    """

    def __init__(
        self,
        clip,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 32,
        max_delay_ms: float = 2.0,
        mesh=None,
    ) -> None:
        if mesh is not None:
            raise ConfigError("ClipServer(mesh=...) (a sharded deployment) is not yet "
                              "ported to the torch package")
        self._clip = clip
        self._closing = False
        self.metrics = ServerMetrics()
        self._embed_images = clip.vision.embed_images
        self._embed_texts = clip.text.embed_texts
        self._vision_batcher = MicroBatcher(self._embed_images, max_batch=max_batch,
                                            max_delay_ms=max_delay_ms)
        self._text_batcher = MicroBatcher(self._embed_texts, max_batch=max_batch,
                                          max_delay_ms=max_delay_ms)
        server = self

        class Handler(BaseHTTPRequestHandler):
            timeout = REQUEST_TIMEOUT_S  # on the socket: every read and write

            def log_message(self, fmt, *args):  # noqa: A003
                get_logger().debug("http: " + fmt, *args)

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                if n < 0:
                    raise ValueError(f"negative Content-Length {n}")
                if n > MAX_BODY_BYTES:
                    raise _PayloadTooLarge(
                        f"request body of {n} bytes is over the {MAX_BODY_BYTES}-byte limit")
                return self.rfile.read(n)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._send(200, {"status": "ok",
                                     "batches": server._vision_batcher.batches
                                     + server._text_batcher.batches})
                elif self.path == "/v1/metrics":
                    snap = server.metrics.snapshot()
                    snap["micro_batches"] = {"vision": server._vision_batcher.batches,
                                             "text": server._text_batcher.batches}
                    self._send(200, snap)
                else:
                    self._send(404, {"error": "NotFound", "message": self.path})

            def do_POST(self):  # noqa: N802
                t0 = time.perf_counter()
                try:
                    payload = self._route(self.path, self._body(),
                                          self.headers.get("Content-Type", ""))
                except ClipError as e:
                    # a valid request racing a graceful shutdown is not a
                    # client error: handler threads outlive shutdown(), so
                    # the batchers may be closed already; 503 says retry
                    code = 503 if server._closing else 400
                    self._observe(t0, error=type(e).__name__)
                    self._send(code, {"error": type(e).__name__, "message": str(e)})
                except _NoSuchEndpoint as e:
                    self._send(404, {"error": "NotFound", "message": str(e)})
                except _PayloadTooLarge as e:
                    self._refuse(t0, 413, "PayloadTooLarge", e)
                except TimeoutError as e:
                    self._refuse(t0, 408, "RequestTimeout", e)
                except (ValueError, KeyError, TypeError) as e:
                    self._observe(t0, error=type(e).__name__)
                    self._send(400, {"error": type(e).__name__, "message": str(e)})
                except Exception as e:  # noqa: BLE001
                    self._observe(t0, error=type(e).__name__)
                    self._send(500, {"error": type(e).__name__, "message": str(e)})
                else:
                    rows = payload.get("embeddings") or payload.get("results") or ()
                    self._observe(t0, items=len(rows))
                    self._send(200, payload)

            def _refuse(self, t0: float, code: int, error: str, e: Exception) -> None:
                """Answer a request whose body was not read, and drop the
                connection (what is left of the body cannot be parsed as
                the next request)."""
                self._observe(t0, error=error)
                self.close_connection = True
                self._send(code, {"error": error, "message": str(e)})

            def _observe(self, t0: float, *, items: int = 0, error: str | None = None) -> None:
                server.metrics.observe(self.path, items=items,
                                       seconds=time.perf_counter() - t0, error=error)

            def _route(self, path: str, body: bytes, ctype: str) -> dict:
                if path == "/v1/embed/image":
                    if ctype.startswith("application/json"):
                        imgs = [base64.b64decode(b) for b in json.loads(body)["images_b64"]]
                        if not imgs:
                            raise InferenceError("Empty batch")
                        return {"embeddings": np.asarray(server._embed_images(imgs)).tolist()}
                    return {"embeddings": [server._embed_image(body).tolist()]}
                if path == "/v1/embed/text":
                    texts = json.loads(body)["texts"]
                    if isinstance(texts, str):
                        texts = [texts]
                    if len(texts) == 1:
                        return {"embeddings": [server._text_batcher.embed(texts[0]).tolist()]}
                    return {"embeddings": np.asarray(server._embed_texts(texts)).tolist()}
                if path == "/v1/classify":
                    req = json.loads(body)
                    img = base64.b64decode(req["image_b64"])
                    return {"results": server._classify(img, req["labels"])}
                if path == "/v1/rank":
                    req = json.loads(body)
                    imgs = [base64.b64decode(b) for b in req["images_b64"]]
                    return {"results": server._rank(imgs, req["text"])}
                raise _NoSuchEndpoint(f"no such endpoint: {path}")

        self._httpd = _HTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="clip-http",
                                        daemon=True)
        self._thread.start()

    # classify / rank on the server's own embed paths, the single image (or
    # text) riding its MicroBatcher so concurrent callers coalesce; scoring
    # is Clip.classify / rank_images' (reference: src/clip.rs:94-170)

    def _embed_image(self, image) -> np.ndarray:
        """One image's row through the vision MicroBatcher, decoded here, in
        the calling handler thread, so that an undecodable image fails its
        own request alone. (The JAX server submits the raw bytes: its
        collector decodes a window's images inside ``embed_images``, and
        one bad upload fails every request of its window.)"""
        return self._vision_batcher.embed(to_rgb_array(image))

    def _classify(self, image, labels) -> list[tuple[str, float]]:
        v = self._embed_image(image)
        t = np.asarray(self._embed_texts([str(label) for label in labels]))
        scale, bias = self._clip._scale_bias()
        probs = self._clip._activate(t @ v * scale + bias)
        return sorted(zip([str(label) for label in labels], probs.tolist()),
                      key=lambda kv: kv[1], reverse=True)

    def _rank(self, images, text: str) -> list[tuple[int, float]]:
        embs = np.asarray(self._embed_images(images))
        t = self._text_batcher.embed(text)
        scale, bias = self._clip._scale_bias()
        probs = self._clip._activate(embs @ t * scale + bias)
        return sorted(enumerate(probs.tolist()), key=lambda kv: kv[1], reverse=True)

    @property
    def address(self) -> tuple[str, int]:
        """The bound (host, port): the port the OS chose for ``port=0``."""
        return self._httpd.server_address[:2]

    def close(self) -> None:
        self._closing = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
        self._vision_batcher.close()
        self._text_batcher.close()

    def __enter__(self) -> "ClipServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

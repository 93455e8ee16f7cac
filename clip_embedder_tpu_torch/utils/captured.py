"""Compiled paths: on the card, each tower forward (the tensor-parallel one
too), the preprocess resize, the corpus search and the train step captured
once per input shape as a CUDA graph, then replayed.

Counterpart of the JAX package's jitted paths
(``clip_embedder_tpu.vision._jitted_vision_forward``,
``text._jitted_text_forward``, the per-shard-layout programs of
``parallel/embed.py``, the tensor-parallel forward included,
``ops.preprocess.resize_normalize``, ``parallel.search._sharded_topk``,
``train.make_sharded_train_step``'s jitted step): there each is one
program, compiled once per input shape, and the power-of-two batch buckets
(``ops.preprocess.bucket_batch``) keep the programs few. Here
``forward(tower, *args, **kwargs)`` is ``tower(*args, **kwargs)`` under
``torch.inference_mode``:

* On the CPU it runs the tower eagerly, as the caller asked.
* On a CUDA device it replays the tower's graph for the call's key: the
  device and every argument, a tensor by shape and dtype, anything else
  (``attn_impl``, ``channels_first``) by value. The pixel size and the
  context length are fixed per model, so a key is a batch bucket: at most
  log2(max batch) + 1 graphs an embedder and impl. Every family captures,
  the ONNX executor's graphs too (``onnx_exec`` makes each static value's
  device tensor once and reuses it).
* A key's first call captures its graph (``GraphSet.capture``): one eager
  warm-up on a side stream, which builds and loads the kernels' libraries
  (``ops.cuda.library``), sets their attributes, lets CUDA load its modules
  lazily and makes a tower's cached tables (EVA02's and PE-Core's rope, the
  executor's static tensors) outside the graph's memory; then the forward
  captured into static copies of the tensor arguments, in
  ``"thread_local"`` mode, so that other threads' eager CUDA work cannot
  break it, and under ``HostReadGuard``. There is no fallback: a forward
  that cannot be captured raises ``CaptureError`` naming the op or launch
  at fault, and never runs eager on the card.
* A replay copies the arguments into the static buffers, replays, and
  returns a fresh copy of the static output: the next replay overwrites it
  (a data-parallel mesh of two entries of one card replays one graph twice
  in a call; ``parallel.EmbedPipeline`` keeps a batch's rows on the device
  while the next batch runs).
* The graphs belong to their owner (``graphs_of``): one ``GraphSet`` a
  tower module (a ``parallel.tensor_parallel.TPViT`` too), a
  ``Preprocessor`` (``ops.preprocess``: its resize per padded shape, whose
  static inputs are its own reused device buffers), a ``CorpusIndex``
  (``parallel.search``: its search per query and k bucket) or a train
  step's optimizer (``train``: the forward, the backward and the AdamW
  update per batch shape, its warm-up a forward and backward alone). The
  embedders that share a tower (``duplicate()``, the repeated
  entries of a mesh) share its graphs, as ``duplicate()`` shares the JAX
  package's jit cache. A set keeps one memory pool, shared by its graphs,
  so that it reserves about what its largest shape needs, and one lock
  that serialises its captures and replays: ``ClipServer`` calls an
  embedder from its micro-batcher thread and from its handler threads at
  once. Each replay's stream first waits for the set's previous replay on
  that device (``GraphSet.in_order``), so callers on different streams
  never share the static buffers or the pool's scratch in flight.
  Captures are serialised across the process too, and Python's cyclic
  collector is paused during each: a graph freed on the capturing thread
  by a dying owner would invalidate the capture (``_collector_paused``).
* A capture may fix TF32 for its f32 products on or off (``tf32``): the
  flag is process-wide and only a capture sets it, under the process's
  capture lock; a graph keeps the cuBLAS math mode of its capture.
* The graphs read the tower's weights where they lie: an update in place
  (``copy_``, ``fill_``) shows in the next replay, a weight replaced by a
  new tensor does not (build a new tower module).
* The kernel wrappers' launch counts (``.launches`` and the packed kernel's
  counts by form) count the launches the device runs: a key's warm-up
  counts its own, as any eager forward does; its capture, which launches
  nothing, counts nothing (``ops.cuda.tallied``); each replay adds the
  launches its capture recorded. A bucket's first call so counts two
  forwards, a later call one. Each graph keeps its ``cudaGraph_t``:
  ``chip_smoke.py`` holds each capture's recorded launches to the graph's
  kernel nodes.

A CUDA graph is captured on one device: PyTorch's capture does not span
devices. So a path over several distinct cards (a tensor-parallel mesh row,
or a train step's mesh, over two cards or more) runs eagerly, as a route
chosen by the layout (``several_devices``), never taken on a failure; a path on
one card (the mesh's entries all one device, as two ``cuda:0`` entries
are) is captured, and a capture that fails raises ``CaptureError``.

The port's counterpart of ``utils/compilation_cache.py`` (the persistent
XLA cache) is ``ops.cuda``'s ``_build/``: the kernels' libraries, keyed by a
hash of their sources, reused by every later process.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..errors import InferenceError
from ..ops import cuda
from . import logging as tracing

aten = torch.ops.aten

# ops that read tensor data on the host (``.item()``, ``bool(t)``,
# ``nonzero``, ``masked_select``, ``equal``, ``unique``) or make a tensor
# from host data (``torch.tensor``, ``torch.from_numpy``): a CUDA graph
# holds neither
HOST_READS = frozenset({
    aten.item, aten._local_scalar_dense, aten.is_nonzero, aten.nonzero, aten.masked_select,
    aten.equal, aten._unique, aten._unique2, aten.unique_dim, aten.unique_consecutive,
    aten.unique_dim_consecutive, aten.lift_fresh,
})


class CaptureError(InferenceError):
    """A forward that a CUDA graph cannot hold."""


def _to_host(func, args, kwargs) -> bool:
    """The op copies a device tensor to the CPU (``.cpu()``, ``.numpy()``,
    ``.tolist()``)."""
    packet = func.overloadpacket
    if packet is aten.copy_:
        return args[0].device.type == "cpu" and isinstance(args[1], torch.Tensor) \
            and args[1].device.type != "cpu"
    if packet not in (aten.to, aten._to_copy) or args[0].device.type == "cpu":
        return False
    dev = kwargs.get("device")
    if dev is None:
        dev = next((a for a in args[1:] if isinstance(a, (torch.device, str))), None)
    if isinstance(dev, torch.Tensor):
        dev = dev.device
    return dev is not None and torch.device(dev).type == "cpu"


class HostReadGuard(TorchDispatchMode):
    """Raises ``CaptureError`` on an op of ``HOST_READS`` or a copy to the
    CPU: around every capture, and the CPU tests' audit of the towers."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in HOST_READS or _to_host(func, args, kwargs):
            raise CaptureError(
                f"{func} reads tensor data on the host inside a captured forward: a CUDA "
                "graph cannot hold it, and its result would be fixed at the capture")
        return func(*args, **kwargs)


def _tensor_args(args, kwargs) -> list[torch.Tensor]:
    return [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]


def _key_of(v):
    return (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else v


def _call_key(device, args, kwargs) -> tuple:
    return (device, tuple(_key_of(a) for a in args),
            tuple(sorted((k, _key_of(v)) for k, v in kwargs.items())))


class _Graph:
    """One capture: the graph, its static input tensors (in call order) and
    output (a tensor or a tuple of tensors), the launches it recorded and
    its capture seconds."""

    def __init__(self, graph, inputs, output, launches, seconds):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.launches, self.seconds = launches, seconds

    def replay(self) -> None:
        """Replay on the current stream; the launches its capture recorded
        go to the wrappers' counts."""
        self.graph.replay()
        for (wrapper, counter, form), n in self.launches.items():
            cuda.count(wrapper, counter, form, n)


# one capture at a time in the process: ``torch.cuda.graph`` synchronises
# the device as it begins, which another thread's capture would not survive
_capture_lock = threading.Lock()


@contextlib.contextmanager
def _matmul_tf32(on: bool | None):
    """TF32 for f32 matmuls on or off while the block runs (the
    process-wide flag, restored after); None leaves it as it is. Only a
    capture sets it, holding ``_capture_lock``."""
    if on is None:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class GraphSet:
    """The captured graphs of one owner, one graph a key (``graphs``), each
    key's capture time in seconds (``capture_seconds``), one memory pool,
    one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graphs: dict[tuple, _Graph] = {}
        self._pool = None
        self._done: dict[torch.device, torch.cuda.Event] = {}  # each device's last replay

    @property
    def capture_seconds(self) -> dict[tuple, float]:
        return {k: g.seconds for k, g in self.graphs.items()}

    @contextlib.contextmanager
    def in_order(self, device: torch.device):
        """Yields the device's current stream, which first waits for this
        set's previous block on the device (on whatever stream it ran); the
        block's work is the next one the set's later blocks wait for. The
        caller holds ``lock``."""
        stream = torch.cuda.current_stream(device)
        device = stream.device  # "cuda" and "cuda:0" are one device here
        done = self._done.get(device)
        if done is None:
            done = self._done[device] = torch.cuda.Event()
        else:
            stream.wait_event(done)
        yield stream
        done.record(stream)

    def capture(self, fn, device: torch.device, inputs=(), *, what: str,
                tf32: bool | None = None, warmup=None) -> _Graph:
        """Warm up and capture ``fn()``, which reads the static tensors
        ``inputs`` on ``device`` (current), into this set's pool; ``tf32``
        fixes TF32 for its f32 products while it is captured (None: as the
        process has it). The warm-up runs ``warmup()`` (default ``fn()``)
        eagerly on a side stream, where ``fn`` must not run twice (a train
        step's update). Counted in ``graphs.captures`` by ``what`` and timed
        as the span ``graphs.capture`` (``utils.logging``), both around it."""
        t0 = time.perf_counter()
        tracing.count("graphs.captures", what)
        with tracing.span("graphs.capture", what=what,
                          shapes=[tuple(t.shape) for t in inputs]):
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with _capture_lock, _matmul_tf32(tf32):
                with torch.cuda.stream(side):
                    (warmup or fn)()
                current.wait_stream(side)
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                # keep_graph: the graph keeps its cudaGraph_t (``raw_cuda_graph``),
                # whose kernel nodes a caller can read (chip_smoke.py counts them)
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                try:
                    with _collector_paused(), torch.cuda.graph(graph, pool=self._pool,
                                                               capture_error_mode="thread_local"):
                        with cuda.tallied() as launches, HostReadGuard():
                            output = fn()
                    graph.instantiate()
                except RuntimeError as err:
                    raise CaptureError(f"{what} on {device} could not be captured as a CUDA "
                                       f"graph: {err}") from err
        return _Graph(graph, list(inputs), output, launches, time.perf_counter() - t0)

    def run(self, tower: nn.Module, device: torch.device, args, kwargs) -> torch.Tensor:
        """Replay the tower's graph of this call's key (captured at its
        first call): the arguments copied into its static buffers, a fresh
        copy of its output returned."""
        key = _call_key(device, args, kwargs)
        with self.lock, torch.cuda.device(device), self.in_order(device):
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = self._capture_tower(tower, device, args, kwargs)
            for static, given in zip(g.inputs, _tensor_args(args, kwargs)):
                static.copy_(given)
            g.replay()
            return g.output.clone()

    def _capture_tower(self, tower, device, args, kwargs) -> _Graph:
        args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        kwargs = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
        name = type(tower).__name__
        g = self.capture(lambda: tower(*args, **kwargs), device, _tensor_args(args, kwargs),
                         what=f"{name}'s forward")
        if not isinstance(g.output, torch.Tensor):
            raise CaptureError(f"{name}'s forward returned {type(g.output).__name__}, "
                               "not one tensor")
        return g


def several_devices(devices) -> bool:
    """The devices (``torch.device``s or names, repeats allowed) are more
    than one device, "cuda" counted as the current card: a path over them
    cannot be one CUDA graph (the module docstring)."""
    def key(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    return len({key(d) for d in devices}) > 1


_sets: "weakref.WeakKeyDictionary[object, GraphSet]" = weakref.WeakKeyDictionary()
_sets_lock = threading.Lock()


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic collector paused while a graph is captured: an owner
    that dies in a reference cycle frees its graphs when the collector
    finds it, on whatever thread allocates, and a graph destroyed on the
    capturing thread (``cudaGraphExecDestroy``) is a call no capture allows:
    it invalidates the capture. Captures hold ``_capture_lock``, so one
    pause is open at a time; the garbage waits for the next collection."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def graphs_of(owner, *, create: bool = False) -> GraphSet | None:
    """The ``GraphSet`` of ``owner`` (a tower module, a ``Preprocessor``, a
    ``CorpusIndex``, a train step's optimizer; made with ``create``; None if
    it has none). It lives as long as the owner does."""
    with _sets_lock:
        s = _sets.get(owner)
        if s is None and create:
            s = _sets[owner] = GraphSet()
        return s


def graph_sets() -> list[GraphSet]:
    """Every live owner's ``GraphSet``."""
    with _sets_lock:
        return list(_sets.values())


def forward(tower: nn.Module, *args, **kwargs) -> torch.Tensor:
    """``tower(*args, **kwargs)`` under ``torch.inference_mode``: eager on the
    CPU, else its captured graph replayed (the module docstring). The
    tensor arguments lie on one device."""
    tensors = _tensor_args(args, kwargs)
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise InferenceError(f"a tower's inputs lie on {sorted({str(t.device) for t in tensors})}"
                             ", not on one device")
    with torch.inference_mode():
        if device.type != "cuda":
            return tower(*args, **kwargs)
        return graphs_of(tower, create=True).run(tower, device, args, kwargs)

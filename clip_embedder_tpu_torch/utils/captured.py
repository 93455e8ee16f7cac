"""Compiled tower forwards: on the card, each tower forward captured once per
input shape as a CUDA graph, then replayed.

Counterpart of the JAX package's jitted forwards
(``clip_embedder_tpu.vision._jitted_vision_forward``,
``text._jitted_text_forward``, the per-shard-layout programs of
``parallel/embed.py``): there a tower forward is one program, compiled once
per input shape, and the power-of-two batch buckets
(``ops.preprocess.bucket_batch``) keep the programs few. Here
``forward(family, tower, *args, **kwargs)`` is ``tower(*args, **kwargs)``
under ``torch.inference_mode``:

* On the CPU it runs the tower eagerly, as the caller asked.
* On a CUDA device it replays the tower's graph for the call's key: the
  device and every argument, a tensor by shape and dtype, anything else
  (``attn_impl``, ``channels_first``) by value. The pixel size and the
  context length are fixed per model, so a key is a batch bucket: at most
  log2(max batch) + 1 graphs an embedder and impl.
* A key's first call captures its graph (``GraphSet.capture``): one eager
  warm-up on a side stream, which builds and loads the kernels' libraries
  (``ops.cuda.library``), sets their attributes, lets CUDA load its modules
  lazily and makes a tower's cached tables (EVA02's and PE-Core's rope)
  outside the graph's memory; then the forward captured into static copies
  of the tensor arguments, in ``"thread_local"`` mode, so that other
  threads' eager CUDA work (the server's preprocess) cannot break it, and
  under ``HostReadGuard``. There is no fallback: a forward that cannot be
  captured raises ``CaptureError`` naming the op or launch at fault, and
  never runs eager on the card.
* A replay copies the arguments into the static buffers, replays, and
  returns a fresh copy of the static output: the next replay overwrites it
  (a data-parallel mesh of two entries of one card replays one graph twice
  in a call; ``parallel.EmbedPipeline`` keeps a batch's rows on the device
  while the next batch runs).
* The graphs belong to the tower module (``graphs_of``), one ``GraphSet``
  a tower, so the embedders that share a tower (``duplicate()``, the
  repeated entries of a mesh) share its graphs, as ``duplicate()`` shares
  the JAX package's jit cache. A set keeps one memory pool, shared by its
  buckets, and one lock that serialises its captures and replays:
  ``ClipServer`` calls an embedder from its micro-batcher thread and from
  its handler threads at once. Each replay's stream first waits for the
  set's previous replay, so callers on different streams never share the
  static buffers or the pool's scratch in flight. Captures are serialised
  across the process too.
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

The families in ``EAGER_FAMILIES`` stay eager on the card, by name. The
tensor-parallel forward, the preprocess, ``CorpusIndex.search`` and the
training step do not come here.

The port's counterpart of ``utils/compilation_cache.py`` (the persistent
XLA cache) is ``ops.cuda``'s ``_build/``: the kernels' libraries, keyed by a
hash of their sources, reused by every later process.
"""

from __future__ import annotations

import threading
import time
import weakref

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from ..errors import InferenceError
from ..ops import cuda

aten = torch.ops.aten

# The ONNX executor (``onnx_exec``) makes device tensors from the graph's
# host constants (numpy) on every call (``onnx_exec._tensor``): a copy from
# pageable host memory, which synchronises, and which a graph would hold
# fixed at its capture.
EAGER_FAMILIES = frozenset({"onnx"})

# ops that read tensor data on the host (``.item()``, ``bool(t)``,
# ``nonzero``, ``masked_select``, ``equal``, ``unique``) or make a tensor
# from host data (``torch.tensor``): a CUDA graph holds neither
HOST_READS = frozenset({
    aten.item, aten._local_scalar_dense, aten.is_nonzero, aten.nonzero, aten.masked_select,
    aten.equal, aten._unique, aten._unique2, aten.unique_dim, aten.unique_consecutive,
    aten.unique_dim_consecutive, aten.lift_fresh,
})


class CaptureError(InferenceError):
    """A tower forward that a CUDA graph cannot hold."""


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
                f"{func} reads tensor data on the host inside a tower forward: a CUDA graph "
                "cannot hold it, and its result would be fixed at the capture")
        return func(*args, **kwargs)


def _tensor_args(args, kwargs) -> list[torch.Tensor]:
    return [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]


def _key_of(v):
    return (tuple(v.shape), v.dtype) if isinstance(v, torch.Tensor) else v


def _call_key(device, args, kwargs) -> tuple:
    return (device, tuple(_key_of(a) for a in args),
            tuple(sorted((k, _key_of(v)) for k, v in kwargs.items())))


class _Graph:
    """One captured forward: the graph, its static input tensors (in call
    order) and output, the launches it recorded and its capture seconds."""

    def __init__(self, graph, inputs, output, launches, seconds):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.launches, self.seconds = launches, seconds


# one capture at a time in the process: ``torch.cuda.graph`` synchronises
# the device as it begins, which another thread's capture would not survive
_capture_lock = threading.Lock()


class GraphSet:
    """The captured forwards of one tower module (which lies on one
    device), one graph a key (``graphs``), each key's capture time in
    seconds (``capture_seconds``), one memory pool."""

    def __init__(self):
        self.lock = threading.Lock()
        self.graphs: dict[tuple, _Graph] = {}
        self._pool = None
        self._done = None  # the event the last replay's stream recorded

    @property
    def capture_seconds(self) -> dict[tuple, float]:
        return {k: g.seconds for k, g in self.graphs.items()}

    def capture(self, tower: nn.Module, device: torch.device, args, kwargs) -> _Graph:
        """Warm up and capture ``tower(*args, **kwargs)`` (tensors on
        ``device``, which is current) into static copies of the tensors."""
        t0 = time.perf_counter()
        args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        kwargs = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in kwargs.items()}
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with _capture_lock:
            with torch.cuda.stream(side):
                tower(*args, **kwargs)
            current.wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # keep_graph: the graph keeps its cudaGraph_t (``raw_cuda_graph``),
            # whose kernel nodes a caller can read (chip_smoke.py counts them)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            try:
                with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                    with cuda.tallied() as launches, HostReadGuard():
                        output = tower(*args, **kwargs)
                graph.instantiate()
            except RuntimeError as err:
                raise CaptureError(f"{type(tower).__name__}'s forward on {device} could not "
                                   f"be captured as a CUDA graph: {err}") from err
        if not isinstance(output, torch.Tensor):
            raise CaptureError(f"{type(tower).__name__}'s forward returned "
                               f"{type(output).__name__}, not one tensor")
        return _Graph(graph, _tensor_args(args, kwargs), output, launches,
                      time.perf_counter() - t0)

    def run(self, tower: nn.Module, device: torch.device, args, kwargs) -> torch.Tensor:
        """Replay the graph of this call's key (captured at its first call):
        the arguments copied into its static buffers, a fresh copy of its
        output returned."""
        key = _call_key(device, args, kwargs)
        with self.lock, torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            if self._done is None:
                self._done = torch.cuda.Event()
            else:
                stream.wait_event(self._done)
            g = self.graphs.get(key)
            if g is None:
                g = self.graphs[key] = self.capture(tower, device, args, kwargs)
            for static, given in zip(g.inputs, _tensor_args(args, kwargs)):
                static.copy_(given)
            g.graph.replay()
            out = g.output.clone()
            self._done.record(stream)
            for (wrapper, counter, form), n in g.launches.items():
                cuda.count(wrapper, counter, form, n)
            return out


_sets: "weakref.WeakKeyDictionary[nn.Module, GraphSet]" = weakref.WeakKeyDictionary()
_sets_lock = threading.Lock()


def graphs_of(tower: nn.Module, *, create: bool = False) -> GraphSet | None:
    """The tower's ``GraphSet`` (made with ``create``; None if it has none).
    It lives as long as the tower does."""
    with _sets_lock:
        s = _sets.get(tower)
        if s is None and create:
            s = _sets[tower] = GraphSet()
        return s


def graph_sets() -> list[GraphSet]:
    """Every live tower's ``GraphSet``."""
    with _sets_lock:
        return list(_sets.values())


def forward(family: str, tower: nn.Module, *args, **kwargs) -> torch.Tensor:
    """``tower(*args, **kwargs)`` under ``torch.inference_mode``: eager on the
    CPU and for the ``EAGER_FAMILIES``, else its captured graph replayed
    (the module docstring). The tensor arguments lie on one device."""
    tensors = _tensor_args(args, kwargs)
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise InferenceError(f"a tower's inputs lie on {sorted({str(t.device) for t in tensors})}"
                             ", not on one device")
    with torch.inference_mode():
        if device.type != "cuda" or family in EAGER_FAMILIES:
            return tower(*args, **kwargs)
        return graphs_of(tower, create=True).run(tower, device, args, kwargs)

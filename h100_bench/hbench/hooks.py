"""What the benchmark wraps around the program's layers: the count of CUDA
graph captures (``GraphSet.capture``, always), and in a traced run the host
time of each ``Preprocessor.__call__`` and the profiler's named ranges around
the calls into each layer. Counts are taken only while the window is open.

The program has no capture counter and no spans of its own yet; these
wrappers are the benchmark's, installed at set-up and taken off before the
reference runs."""

from __future__ import annotations

import contextlib
import time


class Hooks:
    def __init__(self, trace: bool):
        self.trace = trace
        self.window_open = False
        self.captures = 0
        self.captured: list[str] = []  # what each capture in the window held
        self.preprocess: list[tuple[float, float]] = []  # each call's (start, end), s
        self._undo: list = []

    def span(self, name: str):
        """A named range in the profiler's trace (traced runs only)."""
        if not self.trace:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def open_window(self) -> None:
        self.captures = 0
        self.captured = []
        self.preprocess = []
        self.window_open = True

    def close_window(self) -> None:
        self.window_open = False

    def counters(self, keep=None) -> dict:
        """The window's capture count, and the host ms of each preprocess
        call that ``keep(start, end)`` keeps (all without it)."""
        return {"captures": self.captures, "captured": self.captured[:5],
                "preprocess_ms": [(b - a) * 1e3 for a, b in self.preprocess
                                  if keep is None or keep(a, b)]}

    def _patch(self, owner, name: str, value) -> None:
        self._undo.append((owner, name, owner.__dict__.get(name, _MISSING)))
        setattr(owner, name, value)

    def install(self, embedder) -> None:
        from clip_embedder_tpu_torch.parallel import pipeline
        from clip_embedder_tpu_torch.utils.captured import GraphSet

        hooks = self
        capture = GraphSet.capture

        def counted_capture(graph_set, fn, device, inputs=(), **kwargs):
            if hooks.window_open:
                hooks.captures += 1
                hooks.captured.append(f"{kwargs.get('what')}: "
                                      f"{[tuple(t.shape) for t in inputs][:2]}")
            with hooks.span("bench.capture"):
                return capture(graph_set, fn, device, inputs, **kwargs)

        self._patch(GraphSet, "capture", counted_capture)
        if not self.trace:
            return
        self._patch(embedder, "preprocessor", _TimedPreprocessor(embedder.preprocessor, self))
        read_back = pipeline._read_back

        def spanned_read_back(embs, n):
            with hooks.span("bench.read_back"):
                return read_back(embs, n)

        self._patch(pipeline, "_read_back", spanned_read_back)

    def uninstall(self) -> None:
        while self._undo:
            owner, name, old = self._undo.pop()
            if old is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


_MISSING = object()


class _TimedPreprocessor:
    """The embedder's ``Preprocessor`` with each call timed on the host
    clock (staging and enqueue: the call returns before the device is done)
    and named in the trace; every other attribute is the preprocessor's."""

    def __init__(self, inner, hooks: Hooks):
        self._inner, self._hooks = inner, hooks

    def __call__(self, arrays):
        t = time.perf_counter()
        with self._hooks.span("bench.preprocess"):
            out = self._inner(arrays)
        if self._hooks.window_open:
            self._hooks.preprocess.append((t, time.perf_counter()))
        return out

    def __getattr__(self, name):
        return getattr(self._inner, name)

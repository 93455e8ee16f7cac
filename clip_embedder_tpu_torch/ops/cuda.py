"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` file exports a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``. Nothing is built at import: the first launch (or an explicit
``build_all()``) compiles every source at once, one ``nvcc`` process per
file running in parallel, into ``clip_embedder_tpu_torch/_build/``. A
library's file name carries a hash of its source and the compiler flags, so
an edited source rebuilds and an unchanged one is reused.

Kernels launch through ``launch``: on the device of the tensor they are
given (the CUDA runtime's current device is set to it for the call, since
the sources set their attributes, encode their tensor maps and launch on
the current device) and on PyTorch's current stream there; a kernel
returns ``cudaGetLastError()``, and ``launch`` turns a non-zero code into
an error.

Each wrapper counts its kernel's launches through ``count``, so that a run
can show it went through the kernel; ``tallied`` diverts a thread's counts
for a block (``utils.captured``: a graph's capture launches nothing, and its
replays add what it recorded).

The kernels have no backward. A wrapper calls ``no_grad_operands`` before it
launches: with autograd on, an operand that requires grad raises, where the
kernel's fresh output would otherwise end the gradient without a word (a
JAX Pallas kernel without a VJP cannot be differentiated either). Serving
runs under ``torch.inference_mode``, so it never gets there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_flags(stem: str) -> tuple[str, ...]:
    """``NVCC_FLAGS`` and the source's own namespace, ``CLIPK_SOURCE``
    (``csrc/common.cuh``): every kernel of ``csrc/<stem>.cu`` is named
    ``...src_<stem>::...``, so that a profiler's kernel names say which
    library, and so which wrapper, launched them."""
    return (*NVCC_FLAGS, f"-DCLIPK_SOURCE=src_{stem}")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(nvcc_flags(src.stem)).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all(stems=None) -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` (or those of ``stems``) not yet built, all
    ``nvcc`` processes at once. Returns {stem: library path}; the compiler's
    output (registers, shared memory, spills) is kept beside each library as
    ``.log``."""
    todo = {src.stem: (src, _lib_path(src)) for src in sources()
            if stems is None or src.stem in stems}
    missing = {k: v for k, v in todo.items() if not v[1].is_file()}
    if missing:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for stem, (src, out) in missing.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *nvcc_flags(stem), "-o", str(tmp), str(src)]
            procs[stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{stem}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: out for stem, (_, out) in todo.items()}


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``: if it is not built
    yet, every source not yet built is, at once."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = _lib_path(CSRC / f"{stem}.cu")
            lib = ctypes.CDLL(str(path if path.is_file() else build_all()[stem]))
            _libs[stem] = lib
        return lib


_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def kernel(stem: str, name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry ``name`` of ``csrc/<stem>.cu``, its signature (``argtypes``,
    an int cudaError returned) set once, when it is first fetched after the
    library loads: a launch then costs a dict lookup, not a re-declaration."""
    fn = _entries.get((stem, name))
    if fn is None:
        fn = getattr(library(stem), name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _entries[(stem, name)] = fn
    return fn


VOID_P, INT, LONG, FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(fn: ctypes._CFuncPtr, name: str, on: torch.Tensor, *args) -> None:
    """Call the C entry ``fn`` with ``args`` and the current stream of
    ``on``'s device, with that device current for the call: a wrapper's
    operands all lie on ``on``'s device, which need not be the current
    one (a mesh shard on ``cuda:1``). Raises if the launch failed."""
    with torch.cuda.device(on.device):
        code = fn(*args, stream_ptr(on))
    check(code, name)


_tally = threading.local()
_count_lock = threading.Lock()


def count(wrapper, counter: str = "launches", form: str | None = None, n: int = 1) -> None:
    """Add ``n`` launches of ``wrapper``'s kernel to its count ``counter``: an
    int attribute of the wrapper or, with ``form``, that entry of a dict
    attribute (the packed kernel's counts by mask form, ...). Inside this
    thread's ``tallied`` block they go to its tally instead."""
    tally = getattr(_tally, "counts", None)
    if tally is not None:
        key = (wrapper, counter, form)
        tally[key] = tally.get(key, 0) + n
        return
    with _count_lock:
        if form is None:
            setattr(wrapper, counter, getattr(wrapper, counter) + n)
        else:
            getattr(wrapper, counter)[form] += n


@contextmanager
def tallied():
    """Collect this thread's ``count`` calls, for the block, into the dict it
    yields (``{(wrapper, counter, form): n}``) in place of the wrappers'
    counts."""
    outer = getattr(_tally, "counts", None)
    _tally.counts = {}
    try:
        yield _tally.counts
    finally:
        _tally.counts = outer


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def f32_vector(t: torch.Tensor | None, n: int, like: torch.Tensor, what: str) -> torch.Tensor:
    """A [n] f32 vector on like's device, 16-byte aligned, as the kernels
    read their scales, biases and LayerNorm parameters (zeros for a missing
    bias)."""
    if t is None:
        return torch.zeros(n, dtype=torch.float32, device=like.device)
    if tuple(t.shape) != (n,) or t.device != like.device:
        raise ValueError(f"{what}: expected a [{n}] vector on {like.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    v = t.to(torch.float32).contiguous()
    return v.clone() if v.data_ptr() % 16 else v


def _tensors(node):
    if isinstance(node, torch.Tensor):
        yield node
    elif isinstance(node, (list, tuple)):
        for v in node:
            yield from _tensors(v)
    elif hasattr(node, "keys"):  # a dict or a weights.ParamTree
        for k in node.keys():
            yield from _tensors(node[k])


def requires_grad(*operands) -> bool:
    """Whether autograd is on and a tensor among ``operands`` (tensors, or
    trees of them: dicts, ``ParamTree``s, lists) requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(operands))


def no_grad_operands(what: str, *operands) -> None:
    """Raise when ``requires_grad(*operands)``: the kernel behind ``what``
    has no backward."""
    if requires_grad(*operands):
        raise RuntimeError(f"{what}: an operand requires grad, and the CUDA kernel has no "
                           "backward; call it under torch.no_grad() or use the eager impl")


def check_input(x: torch.Tensor, what: str) -> None:
    """A kernel's activation operand: f32 or bf16, contiguous, 16-byte
    aligned."""
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: the kernel takes f32 or bf16 activations, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")

"""Device mesh construction and basic placement helpers.

Counterpart of ``clip_embedder_tpu.parallel.mesh``. The JAX layer is
single-controller: one process holds a ``Mesh`` over its local devices and
every call returns its rows to that process. The port keeps that model: a
``Mesh`` is a ``[data, model]`` grid of ``torch.device``s that one process
owns, not a ``torch.distributed`` world (there every call would be a
collective that each rank must enter). Data parallelism runs each batch
shard on its device with no collective; tensor parallelism sums the
partial outputs of a model row, each moved to the device that needs it;
``CorpusIndex``'s gather is a concatenation of per-shard candidates.

A mesh may name one device more than once: the CPU tests' eight ``"cpu"``
entries play the role of the JAX tests' eight virtual devices, and two
``"cuda:0"`` entries run the sharded path on a one-card machine.
``init_distributed`` keeps the JAX role of a multi-host bootstrap.
"""

from __future__ import annotations

import copy
import math
from itertools import chain

import numpy as np
import torch
from torch import nn

from ..errors import DeviceError
from ..utils.logging import get_logger
from ..weights import tree_map

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A ``[data, model]`` grid of ``torch.device``s (``devices``, an
    object ndarray). ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise DeviceError(f"a mesh is a non-empty [data, model] grid, got {devices.shape}")
        self.devices = devices
        self.axis_names = (DATA_AXIS, MODEL_AXIS)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        grid = [[str(d) for d in row] for row in self.devices]
        return f"Mesh({self.shape}, {grid})"


def get_mesh(*, devices: list | None = None, model_parallel: int = 1) -> Mesh:
    """Build a ('data', 'model') mesh over ``devices`` (names or
    ``torch.device``s; an entry may repeat). With no list it takes every
    visible CUDA device once, and raises ``DeviceError`` when there is none:
    a CPU mesh must be asked for by name (``devices=["cpu"] * 8``).

    ``model_parallel=1`` (default) is pure data parallelism, the bulk
    embedding layout; larger values carve a model axis of adjacent devices
    for tensor parallelism.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceError("CUDA is not available; name the devices of a CPU mesh, e.g. "
                              "get_mesh(devices=['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0 or model_parallel < 1 or n % model_parallel != 0:
        raise DeviceError(f"model_parallel={model_parallel} does not divide {n} devices")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise DeviceError("CUDA is not available; pass CPU devices to run on the CPU")
        if d.type not in ("cuda", "cpu"):
            raise DeviceError(f"Unsupported device '{d}' (cuda or cpu)")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n // model_parallel, model_parallel))


def _tensors(module: nn.Module):
    return chain(module.parameters(), module.buffers())


def module_on(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` itself when all its weights are on ``device``, else a copy
    of it there (the original stays where it is: ``nn.Module.to`` would
    move it in place)."""
    device = torch.device(device)
    if all(t.device == device for t in _tensors(module)):
        return module
    memo = {}
    for t in _tensors(module):
        moved = t.to(device)
        memo[id(t)] = nn.Parameter(moved, requires_grad=False) \
            if isinstance(t, nn.Parameter) else moved
    return copy.deepcopy(module, memo)


def tree_to(tree, device: torch.device):
    """A tensor tree with every tensor on ``device`` (a tensor already
    there is kept, not copied)."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def replicate(tree_or_module, mesh: Mesh) -> dict:
    """One copy of a tensor tree or a module per distinct device of the
    mesh: ``{device: copy}`` (the weights layout for data-parallel
    embedding — every device holds the tower). A copy on the device the
    weights already live on is the original itself, so repeated mesh
    entries share storage."""
    if isinstance(tree_or_module, nn.Module):
        return {d: module_on(tree_or_module, d) for d in mesh.distinct_devices()}
    return {d: tree_to(tree_or_module, d) for d in mesh.distinct_devices()}


def shard_batch(array, mesh: Mesh) -> list[torch.Tensor]:
    """Split an array's leading axis evenly over the data axis, shard ``i``
    on the first device of mesh row ``i`` (the inputs layout). The leading
    axis must divide by the data-axis size (``pad_to_multiple``)."""
    t = torch.as_tensor(array)
    n_data = mesh.shape[DATA_AXIS]
    if t.shape[0] % n_data:
        raise DeviceError(f"a batch of {t.shape[0]} does not split over {n_data} data shards")
    return [s.to(d) for s, d in zip(t.chunk(n_data), mesh.devices[:, 0])]


def pad_to_multiple(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)


def init_distributed(**kwargs) -> None:
    """Multi-host bring-up: ``torch.distributed.init_process_group`` (NCCL
    where CUDA is available, gloo otherwise; ``init_method``,
    ``world_size`` and ``rank`` from ``kwargs`` or the environment) — the
    role ``jax.distributed.initialize`` plays in the JAX package. Call once
    per process before ``get_mesh``; without a coordinator configured it
    logs and returns."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    try:
        dist.init_process_group(**kwargs)
    except (ValueError, RuntimeError) as e:
        get_logger().info("distributed init skipped: %s", e)


def select_platform(preferences: list[str] | None = None, *, strict: bool = False) -> str:
    """Ordered platform preference with fallback — the analog of the
    reference's ordered execution-provider list (reference:
    src/lib.rs:90-93). torch has no global platform pin, so this returns
    the first of ``preferences`` (default ``["cuda", "cpu"]``) that is
    available, for the caller to pass as ``device=``. When none is, it
    returns ``"cpu"``, or raises ``DeviceError`` with ``strict=True`` (the
    reference's ``error_on_failure``: a misconfiguration fails loudly
    rather than landing on a slow fallback)."""
    preferences = preferences or ["cuda", "cpu"]
    for pref in preferences:
        if pref == "cpu" or (pref == "cuda" and torch.cuda.is_available()):
            return pref
    if strict:
        raise DeviceError(
            f"None of the preferred platforms {preferences} is available; strict platform "
            "selection refuses the silent fallback (reference: examples/debug_local.rs:57 "
            "error_on_failure)")
    return "cpu"

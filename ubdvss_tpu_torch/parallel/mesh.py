"""Device mesh and placement helpers: the port's distributed layer.

Counterpart of ``ubdvss_tpu/parallel/mesh.py``.  A ``Mesh`` is an array of
``torch.device`` entries with named axes, as JAX's is of its devices:

  * data parallelism: a 1-D ``Mesh('data')``; batches shard over the axis,
    weights are replicated (``inference.detect_program_batch(mesh=)``,
    ``StreamingDetector(mesh=)``, ``evaluate.run_evaluation(mesh=)``);
  * spatial tiling: a ``Mesh('spatial')`` over which
    ``parallel/tiling.py`` splits a large scan into row tiles.

One process and one Python thread drive every entry: work is launched on
each entry's device in turn (asynchronous on the card) and the results
are gathered on the first.  An entry may repeat a device, so one card (or
the CPU, in the tests) can stand for N: the sharding, halo and seam code
is the code N distinct cards run.  ``torch.distributed`` is not used here:
the serving API is single-controller (the caller passes a mesh and gets
the whole result back), and the kernels take raw device pointers.

``make_mesh`` takes every CUDA device by default and raises without one;
the CPU is used only when the caller lists it in ``devices``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


class Mesh:
    """Devices on named axes: ``devices`` a numpy object array of
    ``torch.device`` (``.size``, ``.flat``), ``axis_names`` a tuple and
    ``shape`` a dict of axis sizes, as JAX's ``Mesh``."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The entries along ``axis`` (index 0 on every other axis)."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _cuda_devices() -> list[torch.device]:
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise RuntimeError(
            "no CUDA device: a mesh takes the cards unless devices= lists others "
            "(devices=['cpu'] * n builds n CPU entries)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: int | None = None,
    axis: str | tuple[str, ...] = "data",
    devices: list | None = None,
    shape: tuple[int, ...] | None = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device), 1-D unless ``shape`` is given.  Entries may repeat a
    device; asking for more entries than ``devices`` holds raises."""
    devs = _cuda_devices() if devices is None else [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in devs):
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh entry names a CUDA device and there is none")
        devs = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None
                else d for d in devs]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} entries over {len(devs)} device(s)")
        devs = devs[:n_devices]
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if shape is None:
        if len(axes) != 1:
            raise ValueError("shape is required for a mesh of several axes")
        shape = (len(devs),)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def replicated(mesh: Mesh) -> list[torch.device]:
    """Where a replicated value lives: the mesh's distinct devices, in
    order of first appearance."""
    return list(dict.fromkeys(mesh.devices.flat))


def _tree_map(f, tree):
    """f on every tensor (numpy arrays taken as tensors) of a tree of dicts,
    lists and tuples; other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(f, v) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(tree)
    return f(tree) if isinstance(tree, torch.Tensor) else tree


def replicate_to_mesh(tree: Any, mesh: Mesh) -> list:
    """The tree (tensors in dicts, lists, tuples) on every mesh entry: a
    list in the mesh's flat order, one copy a distinct device, shared by
    the entries that repeat it (a tensor already there is not copied)."""
    copies = {d: _tree_map(lambda t, d=d: t.to(d), tree) for d in replicated(mesh)}
    return [copies[d] for d in mesh.devices.flat]


def shard_batch_to_mesh(batch: Any, mesh: Mesh, axis: str = "data", non_blocking: bool = False) -> list:
    """Split every tensor's leading dim over ``axis``: a list of the axis's
    shards, shard i the batch's structure with its slice on entry i (a 0-d
    tensor is copied whole).  Raises when a leading dim does not divide.
    ``non_blocking``: asynchronous copies from pinned host memory."""
    devs = mesh.axis_devices(axis)
    n = len(devs)

    def check(t):
        if t.ndim and t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} not divisible by the {n}-entry '{axis}' axis")
        return t

    batch = _tree_map(check, batch)

    def put(t, i, d):
        if t.ndim == 0:
            return t.to(d, non_blocking=non_blocking)
        step = t.shape[0] // n
        return t[i * step:(i + 1) * step].to(d, non_blocking=non_blocking)

    return [_tree_map(lambda t, i=i, d=d: put(t, i, d), batch) for i, d in enumerate(devs)]

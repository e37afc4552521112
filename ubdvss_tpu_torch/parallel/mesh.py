"""Device mesh and placement helpers: the port's distributed layer.

Counterpart of ``ubdvss_tpu/parallel/mesh.py``.  A ``Mesh`` is an array of
``torch.device`` entries with named axes, as JAX's is of its devices:

  * data parallelism: a 1-D ``Mesh('data')``; batches shard over the axis,
    weights are replicated (``inference.detect_program_batch(mesh=)``,
    ``StreamingDetector(mesh=)``, ``evaluate.run_evaluation(mesh=)``);
  * spatial tiling: a ``Mesh('spatial')`` over which
    ``parallel/tiling.py`` splits a large scan into row tiles;
  * data-parallel training: ``train.Trainer(mesh=)`` shards each batch
    over the data axis, runs the forward and backward of each shard on its
    entry, and sums the gradients onto the first entry
    (``reduce_to_first``), whose one optimizer state takes the step; the
    other distinct devices hold replicas of the parameters
    (``replicate_params``).

One process and one Python thread drive every entry: work is launched on
each entry's device in turn (asynchronous on the card) and the results
are gathered on the first.  An entry may repeat a device, so one card (or
the CPU, in the tests) can stand for N: the sharding, halo and seam code
is the code N distinct cards run.  Serving is single-controller (the
caller passes a mesh and gets the whole result back).  Training may also
span several processes, each driving its own mesh: a mesh built with a
``process_group`` (``train.setup_devices(distributed=True)``) is this
process's part of one global data axis of ``size * process_count``
entries, its shards are this process's contiguous slice of each global
batch, and ``reduce_to_first`` ends with a ``torch.distributed``
``all_reduce`` over the group.

``make_mesh`` takes every CUDA device by default and raises without one;
the CPU is used only when the caller lists it in ``devices``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Devices on named axes: ``devices`` a numpy object array of
    ``torch.device`` (``.size``, ``.flat``), ``axis_names`` a tuple and
    ``shape`` a dict of axis sizes, as JAX's ``Mesh``.  ``process_group``:
    the ``torch.distributed`` group whose processes each hold a mesh like
    this one (None: this process alone)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...], process_group=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_group = process_group

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def process_index(self) -> int:
        if self.process_group is None:
            return 0
        return dist.get_rank(self.process_group)

    @property
    def process_count(self) -> int:
        if self.process_group is None:
            return 1
        return dist.get_world_size(self.process_group)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The entries along ``axis`` (index 0 on every other axis)."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        procs = "" if self.process_group is None else f", process {self.process_index} of {self.process_count}"
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}{procs})"


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
    process_group=None,
) -> Mesh:
    """A mesh over the first ``n_devices`` of ``devices`` (default: every
    CUDA device), 1-D unless ``shape`` is given.  Entries may repeat a
    device; asking for more entries than ``devices`` holds raises.
    ``process_group``: see ``Mesh``."""
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
    return Mesh(arr.reshape(shape), axes, process_group)


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


def entry_rows(n_rows: int, mesh: Mesh, i: int, axis: str = "data") -> slice:
    """The rows of a batch of ``n_rows`` that entry ``i`` of ``axis`` holds:
    the batch splits into ``len(axis) * process_count`` equal shards, and
    this process's entry i takes shard ``process_index * len(axis) + i``.
    Raises when ``n_rows`` does not divide."""
    n_local = len(mesh.axis_devices(axis))
    n = n_local * mesh.process_count
    if n_rows % n:
        raise ValueError(f"batch of {n_rows} not divisible by the {n}-entry '{axis}' axis")
    step = n_rows // n
    gi = mesh.process_index * n_local + i
    return slice(gi * step, (gi + 1) * step)


def shard_batch_to_mesh(batch: Any, mesh: Mesh, axis: str = "data", non_blocking: bool = False) -> list:
    """Split every tensor's leading dim over ``axis``: a list of the axis's
    shards, shard i the batch's structure with its rows (``entry_rows``) on
    entry i (a 0-d tensor is copied whole).  Raises when a leading dim does
    not divide.  ``non_blocking``: asynchronous copies from pinned host
    memory."""
    devs = mesh.axis_devices(axis)

    def check(t):
        if t.ndim:
            entry_rows(t.shape[0], mesh, 0, axis)
        return t

    batch = _tree_map(check, batch)

    def put(t, i, d):
        if t.ndim == 0:
            return t.to(d, non_blocking=non_blocking)
        return t[entry_rows(t.shape[0], mesh, i, axis)].to(d, non_blocking=non_blocking)

    return [_tree_map(lambda t, i=i, d=d: put(t, i, d), batch) for i, d in enumerate(devs)]


def replicate_params(params: dict, devices: list, cache: dict) -> list[dict]:
    """``params`` (leaf tensors on ``devices[0]``'s device) on every entry
    of ``devices``, for a train step: an entry on that device takes
    ``params`` itself; each other distinct device holds one copy of leaf
    tensors, kept in ``cache`` (device -> dict) and refreshed in place on
    every call, so every replica equals the first entry's parameters after
    each update."""
    first = devices[0]
    with torch.no_grad():
        for d in dict.fromkeys(devices):
            if d == first:
                continue
            if d not in cache:
                cache[d] = {k: v.detach().to(d).requires_grad_(v.requires_grad) for k, v in params.items()}
            else:
                for k, v in params.items():
                    cache[d][k].copy_(v)
    return [params if d == first else cache[d] for d in devices]


def reduce_to_first(values: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The sum of one tensor an entry of the "data" axis (one shape and
    dtype), on the first entry's device: added in entry order 0..N-1, so
    that the result does not depend on timing, then summed over the mesh's
    processes (``torch.distributed.all_reduce``) when it has a
    ``process_group``; every process then holds the same sum."""
    first = mesh.axis_devices("data")[0]
    total = values[0].to(first, copy=True)
    for v in values[1:]:
        total += v.to(first)
    if mesh.process_group is not None:
        dist.all_reduce(total, group=mesh.process_group)
    return total

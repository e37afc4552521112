"""Tracing / profiling hooks on ``torch.profiler``.

Counterpart of ``ubdvss_tpu/utils/profiling.py``:

  * ``trace(logdir)`` captures a profile around a section and writes it as
    a Chrome trace (``chrome://tracing``, ui.perfetto.dev) into ``logdir``;
    a no-op for ``None``.  The card's kernels are traced when CUDA is
    available, the host's operators always.
  * ``annotate`` names a stage in the trace (``torch.profiler.record_function``,
    as the JAX package's ``jax.named_scope``).
  * ``start_server`` (``jax.profiler.start_server``, on-demand capture from
    TensorBoard) has no PyTorch counterpart and raises.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a profiler trace into ``logdir`` (no-op when it is None)."""
    if not logdir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


def start_server(port: int = 9999):
    """The JAX package's on-demand profiling server: PyTorch has none."""
    raise NotImplementedError(
        "start_server: torch.profiler has no on-demand capture server; "
        "use trace(logdir) around the section to profile"
    )


annotate = record_function  # stage annotation decorator/context

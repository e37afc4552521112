"""Streaming multi-frame pipeline: camera frames in, per-frame detections out.

Counterpart of ``ubdvss_tpu/streaming.py``.  Frames are batched and run
through ``detect_program_batch`` (fused route, detections only) with double
buffering: batch N+1 is copied host->device from a pinned buffer and
launched before batch N's results are pulled, so the card always has the
next batch queued while the host waits for and hands out the previous one.
Each batch's results are copied device->host right behind its work, all
leaves together, and the host waits once per batch, on that batch's event
(not on the whole stream, so the next batch keeps running).

Throughput-oriented: frames are batched; latency mode is batch_size 1.
A bf16 config (``NetConfig(dtype="bfloat16")``) runs the fused route's
bf16 trunk and the bf16 CCL and slots kernels, as ``detect_program_batch``
does; ``qparams`` (``ops/quant.quantize_trunk``) the int8 trunk.  A
``mesh`` (``parallel/mesh.py``) serves each batch data-parallel
(``detect_program_batch(mesh=)``): the pinned batch is copied to each
shard's device, and the results, gathered on the mesh's first entry, are
copied back from there.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch

from ubdvss_tpu_torch.inference import _check_mesh, _data_parallel, detect_program_batch, resolve_device
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.quant import qparams_to
from ubdvss_tpu_torch.parallel.mesh import replicate_to_mesh, shard_batch_to_mesh


class StreamingDetector:
    """Double-buffered frame-sequence detector.

    >>> sd = StreamingDetector(cfg, params, frame_hw=(240, 320), batch_size=64)
    >>> for frame_idx, dets in sd.process(frames):
    ...     ...

    Runs on the card unless ``device="cpu"``.  ``qparams`` serves the int8
    trunk (moved to the device once, here).  ``mesh`` shards each batch
    over the mesh (``batch_size`` must divide by its size); the weights are
    placed on each distinct device once, here.
    """

    def __init__(
        self,
        cfg: NetConfig,
        params: dict,
        frame_hw: tuple[int, int],
        batch_size: int = 8,
        qparams=None,
        mesh=None,
        device=None,
    ):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            _check_mesh(mesh, device, batch_size)
            device = mesh.devices.flat[0]  # where the shards' results are gathered
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.qparams = None if qparams is None else qparams_to(qparams, self.device)
        if mesh is not None:
            # one copy of the weights a distinct device, read by every shard there
            self._placed = replicate_to_mesh({"params": self.params, "qparams": self.qparams}, mesh)
        self.frame_hw = frame_hw
        self.batch_size = batch_size
        self.out_hw = cfg.grid_size(*frame_hw)
        self._pinned: list[torch.Tensor | None] = [None, None]

    def _pin(self, batch_np: np.ndarray, slot: int) -> torch.Tensor:
        """Host batch -> pinned buffer ``slot`` (on the card; the CPU takes
        the batch as it is).  A buffer is refilled two batches later, after
        the host has waited on the event of the batch that used it, which
        follows that batch's copies on the stream."""
        x = torch.from_numpy(batch_np)
        if self.device.type == "cpu":
            return x
        buf = self._pinned[slot]
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
            buf = self._pinned[slot] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return buf.copy_(x)

    def _launch(self, batch_np: np.ndarray, slot: int):
        """Queue one batch: H2D copies (to each shard's device over a mesh),
        the fused program, D2H copies of every result leaf.  Returns (host
        results, event recorded after them)."""
        x = self._pin(batch_np, slot)
        if self.mesh is None:
            res, _ = detect_program_batch(
                self.params, x.to(self.device, non_blocking=True), self.cfg, self.out_hw,
                qparams=self.qparams, detections_only=True, device=self.device,
            )
        else:
            shards = shard_batch_to_mesh(x, self.mesh, self.mesh.axis_names[0], non_blocking=True)
            res, _ = _data_parallel(
                detect_program_batch, self.mesh, self._placed, shards, None, self.out_hw, self.cfg,
                out_hw=self.out_hw, detections_only=True,
            )
        if self.device.type == "cpu":
            return res, None
        host = {}
        for k, v in res.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def process(self, frames: Iterable[np.ndarray]) -> Iterator[tuple[int, dict]]:
        """Yield (frame_index, per-frame dict of numpy arrays) in order.

        The card always has the next batch in flight before the previous
        batch's results are pulled (double buffering).  The tail batch is
        padded with zero frames, whose results are not yielded.
        """
        it = iter(frames)

        def next_batch():
            buf = []
            for f in it:
                buf.append(np.asarray(f))
                if len(buf) == self.batch_size:
                    break
            if not buf:
                return None
            n_real = len(buf)
            while len(buf) < self.batch_size:  # pad the tail batch
                buf.append(np.zeros_like(buf[0]))
            return np.stack(buf), n_real

        def pull(pending):
            pbase, pcount, (host, done) = pending
            if done is not None:
                done.synchronize()  # this batch only; the next one keeps running
            arrs = {k: v.numpy() for k, v in host.items()}
            for i in range(pcount):
                yield pbase + i, {k: a[i] for k, a in arrs.items()}

        base = 0
        slot = 0
        pending = None  # (base, count, (host results, event))
        nb = next_batch()
        while nb is not None:
            batch_np, n_real = nb
            launched = self._launch(batch_np, slot)  # in flight
            if pending is not None:
                yield from pull(pending)
            pending = (base, n_real, launched)
            base += n_real
            slot ^= 1
            nb = next_batch()
        if pending is not None:
            yield from pull(pending)

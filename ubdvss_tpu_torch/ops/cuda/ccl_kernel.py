"""Threshold + connected-component labelling: plain version and CUDA kernel.

Counterpart of ``ubdvss_tpu/ops/pallas/ccl_kernel.py``.  Labels are "raw":
each foreground pixel (logit > log(t / (1 - t))) holds the minimum linear
index of its component, background holds H*W.

``ccl_labels_reference`` copies the JAX algorithm round for round: a 3x3
(or cross) neighbour min, then a segmented run-min along W and along H by
shift doubling, repeated until nothing changes or H + W rounds have run —
so it equals the TPU kernel even where that cap binds.  The CUDA kernel
(``csrc/ccl_kernel.cu``) finds the true components by union-find in
shared memory (three passes, no rounds and no cap).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ubdvss_tpu_torch.ops.cuda import _build

# the largest label map one thread block keeps in shared memory (227 KB)
MAX_SHARED_BYTES = 232_448


def threshold_logit(threshold: float) -> float:
    """The detection threshold as an f32 logit: sigmoid(x) > t <=> x > it."""
    return float(np.float32(math.log(threshold / (1.0 - threshold))))


def _shift(x: torch.Tensor, d: int, axis: int, fill) -> torch.Tensor:
    """Shift x by +d (toward higher indices) along axis, filling with fill."""
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(axis, d, n - d).copy_(x.narrow(axis, 0, n - d))
    else:
        out.narrow(axis, 0, n + d).copy_(x.narrow(axis, -d, n + d))
    return out


def _neighbor_min(lab, sentinel, connectivity):
    """(B, H, W) 3x3 window min (8) or cross min (4)."""
    if connectivity == 8:
        m = torch.minimum(
            lab,
            torch.minimum(_shift(lab, 1, 2, sentinel), _shift(lab, -1, 2, sentinel)),
        )
        return torch.minimum(
            m, torch.minimum(_shift(m, 1, 1, sentinel), _shift(m, -1, 1, sentinel))
        )
    m = lab
    for d, ax in ((1, 1), (-1, 1), (1, 2), (-1, 2)):
        m = torch.minimum(m, _shift(lab, d, ax, sentinel))
    return m


def _run_ids(mask, axis):
    """Unique id per contiguous mask-run along axis (-1 at background)."""
    mi = mask.to(torch.int32)
    start = mi * (1 - _shift(mi, 1, axis, 0))
    return torch.where(mask, torch.cumsum(start, axis, dtype=torch.int32), -1)


def _run_min(lab, mask, sentinel, axis, runid):
    """Min within contiguous mask-runs along axis, by run-id doubling."""
    n = mask.shape[axis]
    x = torch.where(mask, lab, sentinel)
    d = 1
    while d < n:
        for s in (d, -d):
            same = _shift(runid, s, axis, -2) == runid
            x = torch.minimum(
                x, torch.where(same, _shift(x, s, axis, sentinel), sentinel)
            )
        d *= 2
    return torch.where(mask, x, sentinel)


def ccl_labels_reference(
    det_logits: torch.Tensor, threshold: float = 0.5, connectivity: int = 8
) -> torch.Tensor:
    """Plain version: (B, H, W) logits -> (B, H, W) int32 raw labels."""
    B, H, W = det_logits.shape
    sentinel = H * W
    mask = det_logits.to(torch.float32) > threshold_logit(threshold)
    lin = torch.arange(H * W, dtype=torch.int32, device=det_logits.device).view(1, H, W)
    lab = torch.where(mask, lin, sentinel)
    rid_w = _run_ids(mask, 2)
    rid_h = _run_ids(mask, 1)
    for _ in range(H + W):
        new = torch.where(mask, _neighbor_min(lab, sentinel, connectivity), sentinel)
        new = _run_min(new, mask, sentinel, 2, rid_w)
        new = _run_min(new, mask, sentinel, 1, rid_h)
        if torch.equal(new, lab):
            break
        lab = new
    return lab


_FUNCS = {"ccl_labels": [_build.P, _build.P, _build.I, _build.I, _build.I,
                         _build.F, _build.I, _build.P]}


def ccl_labels_from_logits(
    det_logits: torch.Tensor, threshold: float = 0.5, connectivity: int = 8
) -> torch.Tensor:
    """(B, H, W) f32 detection logits -> (B, H, W) int32 raw labels.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one block per image, the label map in shared memory) or raises.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if det_logits.device.type == "cpu":
        return ccl_labels_reference(det_logits, threshold, connectivity)
    _build.check_input(det_logits, "det_logits", torch.float32, 3)
    B, H, W = det_logits.shape
    if H * W * 4 > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"{H}x{W} label maps exceed one block's shared memory; the "
            "global-memory CCL for large scans is ROADMAP.md §1 item 7"
        )
    lib = _build.load("ccl_kernel", _FUNCS)
    out = torch.empty((B, H, W), dtype=torch.int32, device=det_logits.device)
    _build.launch(
        lib, "ccl_labels", det_logits.device, det_logits.data_ptr(),
        out.data_ptr(), B, H, W, threshold_logit(threshold), connectivity,
    )
    ccl_labels_from_logits.launches += 1
    return out


ccl_labels_from_logits.launches = 0

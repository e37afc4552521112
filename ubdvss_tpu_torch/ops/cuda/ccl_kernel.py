"""Threshold + connected-component labelling: plain version and CUDA kernel.

Counterpart of ``ubdvss_tpu/ops/pallas/ccl_kernel.py``.  Labels are "raw":
each foreground pixel (logit > log(t / (1 - t))) holds the minimum linear
index of its component, background holds H*W.

``ccl_labels_reference`` is the JAX algorithm round for round
(``ops/ccl.label_propagation``): a 3x3 (or cross) neighbour min, then a
segmented run-min along W and along H, repeated until nothing changes or
H + W rounds have run — so it equals the TPU kernel even where that cap
binds.  The CUDA kernels
(``csrc/ccl_kernel.cu``) find the true components by union-find (no
rounds and no cap): one block a map with the map in shared memory where it
fits (``MAX_SHARED_BYTES``), else ``ccl_labels_tiled`` over device memory
(tiles in shared memory, then the seams between them, then a flatten).

Both kernels read f32 or bf16 detection logits (the bf16 route's trunk
hands bf16 logits to postprocessing, as the JAX package does); each logit
is widened to f32, exactly, and compared with the f32 threshold logit, as
the JAX package compares ``det_logit.astype(f32)``.  A wrapper counts its
bf16 launches in ``launches_bf16`` and its f32 launches in ``launches``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ubdvss_tpu_torch.ops.ccl import label_propagation
from ubdvss_tpu_torch.ops.cuda import _build

# the largest label map one thread block keeps in shared memory (227 KB)
MAX_SHARED_BYTES = 232_448


def threshold_logit(threshold: float) -> float:
    """The detection threshold as an f32 logit: sigmoid(x) > t <=> x > it."""
    return float(np.float32(math.log(threshold / (1.0 - threshold))))


def ccl_labels_reference(
    det_logits: torch.Tensor, threshold: float = 0.5, connectivity: int = 8
) -> torch.Tensor:
    """Plain version: (B, H, W) logits -> (B, H, W) int32 raw labels, the
    XLA route's ``label_propagation`` (``ops/ccl.py``) on the thresholded
    maps, with its cap of H + W rounds."""
    mask = det_logits.to(torch.float32) > threshold_logit(threshold)
    return label_propagation(mask, connectivity)


_FUNCS = {
    **{"ccl_labels" + sfx: [_build.P, _build.P, _build.I, _build.I, _build.I, _build.F, _build.I,
                            _build.P] for sfx in ("", "_bf16")},
    **{"ccl_labels_tiled" + sfx: [_build.P, _build.P, _build.P, _build.I, _build.F, _build.I,
                                  _build.P] for sfx in ("", "_bf16")},
    "tiled_plan_ints": [],
}
# the tiled kernel's labels are int32 linear indices below 2^30
MAX_TILED_PIXELS = 1 << 30
# the logit dtypes the kernels read, and the suffix of their C entry points
LOGIT_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def count_launch(fn, dtype: torch.dtype) -> None:
    """One launch of ``fn``'s kernel at this logit dtype: bf16 launches in
    ``fn.launches_bf16``, f32 ones in ``fn.launches``."""
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def _check(det_logits: torch.Tensor) -> None:
    if det_logits.dtype not in LOGIT_DTYPES:
        raise TypeError(f"det_logits: expected float32 or bfloat16, got {det_logits.dtype}")
    _build.check_input(det_logits, "det_logits", det_logits.dtype, 3)
    B, H, W = det_logits.shape
    if H * W >= MAX_TILED_PIXELS or B > 65535:
        raise ValueError(f"{B} maps of {H}x{W}: the CCL kernels take H*W < 2^30, B <= 65535")


def ccl_labels_tiled(
    det_logits: torch.Tensor, threshold: float = 0.5, connectivity: int = 8
) -> torch.Tensor:
    """(B, H, W) f32 or bf16 detection logits -> (B, H, W) int32 raw labels,
    by the device-memory kernel at ``postproc_kernel.tiled_plan``'s
    geometry: tiles labelled in shared memory, the seams between tiles
    united by atomicMin on roots in device memory, then a flatten (three
    launches; any map size).  ``ccl_labels_from_logits`` takes it for maps
    larger than one block's shared memory.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if det_logits.device.type == "cpu":
        return ccl_labels_reference(det_logits, threshold, connectivity)
    _check(det_logits)
    from ubdvss_tpu_torch.ops.cuda.postproc_kernel import check_plan_length, tiled_plan

    arr = tiled_plan(*det_logits.shape, 1, 1).ints  # the CCL's geometry takes no K, C
    lib = _build.load("ccl_kernel", _FUNCS)
    check_plan_length(lib, "ccl_kernel")
    out = torch.empty(det_logits.shape, dtype=torch.int32, device=det_logits.device)
    _build.launch(
        lib, "ccl_labels_tiled" + LOGIT_DTYPES[det_logits.dtype], det_logits.device,
        det_logits.data_ptr(), out.data_ptr(), arr.ctypes.data, arr.size,
        threshold_logit(threshold), connectivity,
    )
    count_launch(ccl_labels_tiled, det_logits.dtype)
    return out


ccl_labels_tiled.launches = 0
ccl_labels_tiled.launches_bf16 = 0


def ccl_labels_from_logits(
    det_logits: torch.Tensor, threshold: float = 0.5, connectivity: int = 8
) -> torch.Tensor:
    """(B, H, W) f32 or bf16 detection logits -> (B, H, W) int32 raw labels.

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    or raises: one block per image with the label map in shared memory
    (counted here) where the map fits, else ``ccl_labels_tiled``.  Both give
    the same labels; the one-block kernel is kept for the maps it holds
    because it is the faster of the two on the batched 128² and 60x80 maps
    of the 512² path and the QVGA stream (``scripts/torch_kernel_ab.py``).
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if det_logits.device.type == "cpu":
        return ccl_labels_reference(det_logits, threshold, connectivity)
    _check(det_logits)
    B, H, W = det_logits.shape
    if H * W * 4 > MAX_SHARED_BYTES:
        return ccl_labels_tiled(det_logits, threshold, connectivity)
    lib = _build.load("ccl_kernel", _FUNCS)
    out = torch.empty((B, H, W), dtype=torch.int32, device=det_logits.device)
    _build.launch(
        lib, "ccl_labels" + LOGIT_DTYPES[det_logits.dtype], det_logits.device,
        det_logits.data_ptr(), out.data_ptr(), B, H, W, threshold_logit(threshold),
        connectivity,
    )
    count_launch(ccl_labels_from_logits, det_logits.dtype)
    return out


ccl_labels_from_logits.launches = 0
ccl_labels_from_logits.launches_bf16 = 0

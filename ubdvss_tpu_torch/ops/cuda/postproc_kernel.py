"""Component slots (K2) and per-component stats over the CCL labels.

Counterpart of ``ubdvss_tpu/ops/pallas/postproc_kernel.py``:

  * ``component_slots`` — from the raw labels: the root count, the K
    smallest roots in raster order (H*W pads), the slot map (0..K-1, K for
    pixels beyond slot K) and each slot's per-row min/max x (1<<30 / -1 on
    empty rows).  As in the TPU kernel, padding slots match the background
    label H*W: when an image has fewer than K components, background pixels
    take slot K-1 and every padding slot carries the background's extremes;
    ``postprocess_batch_fused`` masks them by ``rootvals``.
  * ``component_slots_from_logits`` — CCL (``ccl_kernel``) then slots.
  * ``component_stats_from_logits`` — plus areas, sigmoid sums and class
    softmax sums per slot.  Those sums are one-hot matrix products in plain
    f32 torch on every device, as the JAX package leaves them to XLA.

The JAX package stacks G images per CCL program (``_stack_group``) to
amortise TPU grid overhead; blocks run in parallel here, so there is no
stacking.
"""

from __future__ import annotations

import torch

from ubdvss_tpu_torch.ops.cuda import _build
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import (
    MAX_SHARED_BYTES,
    ccl_labels_from_logits,
    threshold_logit,
)

_BIG = 1 << 30


def component_slots_reference(
    det_logits: torch.Tensor, labels: torch.Tensor, max_components: int,
    threshold: float = 0.5,
) -> dict:
    """Plain version of the slots kernel (the JAX K-round loop, batched)."""
    B, H, W = det_logits.shape
    K = max_components
    N = H * W
    dev = det_logits.device
    mask = det_logits.to(torch.float32) > threshold_logit(threshold)
    lab = torch.where(mask, labels.to(torch.int32), N)
    lin = torch.arange(N, dtype=torch.int32, device=dev).view(1, H, W)
    cand = torch.where(mask & (lab == lin), lab, N).view(B, N)
    nroots = (cand != N).sum(1).to(torch.int32)
    roots = torch.sort(cand, dim=1).values[:, :K]  # ascending = raster order
    if roots.shape[1] < K:
        roots = torch.cat([roots, roots.new_full((B, K - roots.shape[1]), N)], 1)
    cols = torch.arange(W, dtype=torch.int32, device=dev).view(1, 1, W)
    slots = torch.full((B, H, W), K, dtype=torch.int32, device=dev)
    minx = torch.empty((B, K, H), dtype=torch.int32, device=dev)
    maxx = torch.empty((B, K, H), dtype=torch.int32, device=dev)
    for k in range(K):
        m = lab == roots[:, k].view(B, 1, 1)
        minx[:, k] = torch.where(m, cols, _BIG).amin(2)
        maxx[:, k] = torch.where(m, cols, -1).amax(2)
        slots = torch.where(m, k, slots)
    return {
        "rootvals": roots.to(torch.int32),
        "slots": slots,
        "minx": minx,
        "maxx": maxx,
        "num_components_total": nroots,
    }


_FUNCS = {"component_slots": [_build.P] * 7 + [_build.I] * 4 + [_build.F, _build.P]}


def component_slots(
    det_logits: torch.Tensor, labels: torch.Tensor, max_components: int,
    threshold: float = 0.5,
) -> dict:
    """Slots from (B, H, W) logits and raw labels (the slots kernel).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one block per image) or raises.
    """
    if det_logits.device.type == "cpu":
        return component_slots_reference(det_logits, labels, max_components, threshold)
    _build.check_input(det_logits, "det_logits", torch.float32, 3)
    _build.check_input(labels, "labels", torch.int32, 3, det_logits.device)
    if labels.shape != det_logits.shape:
        raise ValueError(f"labels {tuple(labels.shape)} != logits {tuple(det_logits.shape)}")
    B, H, W = det_logits.shape
    K = max_components
    if (K + 2 * K * H) * 4 > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"K={K} x H={H} extremes exceed one block's shared memory "
            "(large scans: ROADMAP.md §1 item 7)"
        )
    lib = _build.load("postproc_kernel", _FUNCS)
    dev = det_logits.device
    rootvals = torch.empty((B, K), dtype=torch.int32, device=dev)
    slots = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    minx = torch.empty((B, K, H), dtype=torch.int32, device=dev)
    maxx = torch.empty((B, K, H), dtype=torch.int32, device=dev)
    nroots = torch.empty((B,), dtype=torch.int32, device=dev)
    _build.launch(
        lib, "component_slots", dev, det_logits.data_ptr(), labels.data_ptr(),
        rootvals.data_ptr(), slots.data_ptr(), minx.data_ptr(), maxx.data_ptr(),
        nroots.data_ptr(), B, H, W, K, threshold_logit(threshold),
    )
    component_slots.launches += 1
    return {
        "rootvals": rootvals,
        "slots": slots,
        "minx": minx,
        "maxx": maxx,
        "num_components_total": nroots,
    }


component_slots.launches = 0


def component_slots_from_logits(
    det_logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """(B, H, W) detection logits -> slot map + rootvals + rect extremes.

    Returns dict: rootvals (B, K) int32 (H*W at padding), slots (B, H, W)
    int32, minx/maxx (B, K, H) int32, num_components_total (B,) int32.
    """
    det = det_logits.to(torch.float32).contiguous()
    labels = ccl_labels_from_logits(det, threshold, connectivity)
    return component_slots(det, labels, max_components, threshold)


def component_stats_from_logits(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """(B, H, W, C) NHWC logits -> per-component stats.

    Geometry from the kernels; areas, detection-probability sums and
    class-probability sums as one-hot products in f32.  Returns (B, K)
    rootvals/areas/det_sums, (B, K, n_cls) cls_sums (a zero column when
    detection-only), (B, K, H) minx/maxx, the slot map as ``labels`` and
    ``num_components_total``.
    """
    B, H, W, C = logits.shape
    K = max_components
    det = logits[..., 0].to(torch.float32).contiguous()
    geo = component_slots_from_logits(det, K, threshold, connectivity)
    k_ids = torch.arange(K, dtype=torch.int32, device=logits.device).view(1, K, 1)
    onehot = (geo["slots"].view(B, 1, H * W) == k_ids).to(torch.float32)  # (B, K, HW)
    areas = onehot.sum(-1)
    det_sums = torch.bmm(onehot, torch.sigmoid(det).view(B, H * W, 1))[..., 0]
    if C > 1:
        sm = torch.softmax(logits[..., 1:].to(torch.float32), dim=-1)
        cls_sums = torch.bmm(onehot, sm.reshape(B, H * W, C - 1))
    else:
        cls_sums = torch.zeros((B, K, 1), dtype=torch.float32, device=logits.device)
    return {
        "rootvals": geo["rootvals"],
        "areas": areas,
        "det_sums": det_sums,
        "cls_sums": cls_sums,
        "minx": geo["minx"],
        "maxx": geo["maxx"],
        "labels": geo["slots"],
        "num_components_total": geo["num_components_total"],
    }

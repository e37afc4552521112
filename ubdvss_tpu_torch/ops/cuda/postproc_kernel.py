"""Component slots and stats (K2), the fused compat geometry (K12c) over
the CCL labels.

Counterpart of ``ubdvss_tpu/ops/pallas/postproc_kernel.py``:

  * ``component_slots`` — from the logits and the raw labels: the root
    count, the K smallest roots in raster order (H*W pads), the slot map
    (0..K-1, K for pixels beyond slot K), each slot's per-row min/max x
    (1<<30 / -1 on empty rows), and each slot's stats: pixel count
    (``areas``), sum of sigmoid(det logit) (``det_sums``) and sums of the
    class softmax (``cls_sums``).  As in the TPU kernel, padding slots match
    the background label H*W: when an image has fewer than K components,
    background pixels take slot K-1 and every padding slot carries the
    background's extremes; ``postprocess_batch_fused`` masks them by
    ``rootvals``.
  * ``component_slots_tiled`` — the same outputs for maps where the
    cluster kernel's (K, H) extremes or K12c's half label map beside them
    exceed one block's shared memory (K=64 at a 256² map and beyond): the
    roots ranked over raster chunks, the pixel pass over row tiles with the
    extremes by integer atomics in device memory and the stats partials
    summed over the tiles in order (four launches; no float atomic).
    ``component_slots`` takes it where K12c cannot run.
  * ``geometry_compat`` — CCL, slots and stats as one kernel (K12c,
    ``_geometry_kernel_compat``; a cluster of two blocks per image), the
    same outputs as slots after CCL, stats bit for bit; past
    ``geometry_compat_fits`` it launches ``geometry_compat_large``, the
    phases of ``ccl_labels_tiled`` and ``component_slots_tiled`` in one
    cooperative launch, equal to that pair bit for bit.
  * ``component_geometry`` — CCL (``ccl_kernel``) then slots, or, when
    ``UBDVSS_PALLAS_COMPAT`` is ``"1"``, ``geometry_compat``: the JAX
    package's compat switch with its meaning.  The JAX package reads it
    once, at import; the port reads it at each call.  No route retries the
    other on an error.  ``component_slots_from_logits`` and
    ``component_stats_from_logits`` are the JAX functions of those names
    over it.

The JAX package leaves the stats to XLA, as one-hot contractions over the
slot map; their plain version here does the same in f32 torch, and that is
what a CPU tensor takes.  On the card K2 and K12c sum them in the pixel
pass that assigns the slots, reading the class logits where the head wrote
them, so no one-hot exists there.

The logits are f32 or bf16 (the bf16 route's trunk output).  On bf16
logits the class softmax is taken in f32 and each probability rounded to
bf16 before the f32 sums, as the JAX package stores it at the logits'
dtype (``postproc_kernel.py:461-466``); the sigmoid and the counts are not
rounded.  Each kernel has a bf16 instantiation, counted in its wrapper's
``launches_bf16`` (f32 launches in ``launches``).

The JAX package stacks G images per CCL program (``_stack_group``) to
amortise TPU grid overhead; blocks run in parallel here, so there is no
stacking.
"""

from __future__ import annotations

import os

import torch

from ubdvss_tpu_torch.ops.cuda import _build
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import (
    LOGIT_DTYPES,
    MAX_SHARED_BYTES,
    ccl_labels_from_logits,
    ccl_labels_reference,
    count_launch,
    threshold_logit,
)

_BIG = 1 << 30


_GEO_KEYS = ("rootvals", "slots", "minx", "maxx", "num_components_total")


def _as_nhwc(logits: torch.Tensor) -> torch.Tensor:
    """(B, H, W) detection logits or (B, H, W, C) logits -> (B, H, W, C)."""
    return logits[..., None] if logits.ndim == 3 else logits


def _stats_reference(logits: torch.Tensor, slots: torch.Tensor, K: int) -> dict:
    """Plain per-slot stats: areas, detection-probability sums and
    class-probability sums as one-hot products in f32, as the JAX package
    leaves them to XLA; (B, K, 1) zeros for cls_sums when C = 1.  The class
    softmax is taken in f32 and rounded to the logits' dtype (a no-op for
    f32 logits) before the f32 sums."""
    B, H, W, C = logits.shape
    det = logits[..., 0].to(torch.float32)
    k_ids = torch.arange(K, dtype=torch.int32, device=logits.device).view(1, K, 1)
    onehot = (slots.view(B, 1, H * W) == k_ids).to(torch.float32)  # (B, K, HW)
    areas = onehot.sum(-1)
    det_sums = torch.bmm(onehot, torch.sigmoid(det).reshape(B, H * W, 1))[..., 0]
    if C > 1:
        sm = torch.softmax(logits[..., 1:].to(torch.float32), dim=-1)
        sm = sm.to(logits.dtype).to(torch.float32)
        cls_sums = torch.bmm(onehot, sm.reshape(B, H * W, C - 1))
    else:
        cls_sums = torch.zeros((B, K, 1), dtype=torch.float32, device=logits.device)
    return {"areas": areas, "det_sums": det_sums, "cls_sums": cls_sums}


def component_slots_reference(
    logits: torch.Tensor, labels: torch.Tensor, max_components: int,
    threshold: float = 0.5,
) -> dict:
    """Plain version of the slots kernel: the JAX K-round loop, batched, then
    the one-hot stats.  ``logits`` is (B, H, W) or (B, H, W, C)."""
    logits = _as_nhwc(logits)
    B, H, W, _ = logits.shape
    K = max_components
    N = H * W
    dev = logits.device
    mask = logits[..., 0].to(torch.float32) > threshold_logit(threshold)
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
        **_stats_reference(logits, slots, K),
    }


_LOGITS_ARGS = [_build.P] + [_build.L] * 4 + [_build.I]
_FUNCS = {
    name + sfx: args
    for name, args in (
        ("component_slots",
         _LOGITS_ARGS + [_build.P] * 9 + [_build.I] * 5 + [_build.F, _build.P]),
        ("component_slots_tiled",
         _LOGITS_ARGS + [_build.P] * 12 + [_build.I] * 7 + [_build.F, _build.P]),
    )
    for sfx in LOGIT_DTYPES.values()
}


# the kernels' stats keep a pixel's class probabilities in registers, for
# at most this many channels (csrc/geometry.cuh, with_channel_bound)
MAX_CHANNELS = 33


def _check_logits(logits: torch.Tensor) -> None:
    """The kernels read the logits at their strides: f32 or bf16, 4 dims,
    on the card, at most MAX_CHANNELS channels."""
    if logits.device.type != "cuda":
        raise ValueError(f"logits: expected a CUDA tensor, got {logits.device}")
    if logits.dtype not in LOGIT_DTYPES:
        raise TypeError(f"logits: expected torch.float32 or torch.bfloat16, got {logits.dtype}")
    if logits.ndim != 4:
        raise ValueError(f"logits: expected 3 or 4 dims, got shape {tuple(logits.shape)}")
    if logits.shape[-1] > MAX_CHANNELS:
        raise NotImplementedError(
            f"{logits.shape[-1]} logit channels: the stats kernels take at most "
            f"{MAX_CHANNELS} (ROADMAP.md §2a)"
        )


# K2's blocks (a cluster) per image (csrc/geometry.cuh, kSlotCtas)
SLOT_CTAS = 2


def geometry_smem_words(H: int, W: int, K: int) -> int:
    """Shared-memory words of one K12c block besides its stats partials:
    the labels of its half of the rows, the roots, its own ranked roots and
    their count, the (K, H) extremes (csrc/geometry_kernel.cu)."""
    return (H + 1) // 2 * W + 2 * K + 1 + 2 * K * H


def stats_warps(H: int, W: int, K: int, C: int) -> int:
    """Warps of a K2 block and of a K12c block, each warp keeping one stats
    partial set: as many as K12c's shared memory leaves room for, at most
    32 and at least 1.  Both kernels take the same count, which fixes the
    order of the stats' sums, so that they agree bit for bit."""
    free = MAX_SHARED_BYTES - 1024 - geometry_smem_words(H, W, K) * 4
    return max(1, min(32, free // (K * (C + 1) * 4)))


def geometry_compat_fits(H: int, W: int, K: int, C: int) -> bool:
    """K12c runs at this shape: half the label map, the extremes and one
    stats partial set a warp fit one block's shared memory.  K2's cluster
    kernel serves exactly these shapes, so that the two agree bit for bit
    wherever both run; ``component_slots_tiled`` serves the rest."""
    words = geometry_smem_words(H, W, K) + stats_warps(H, W, K, C) * K * (C + 1)
    return words * 4 <= MAX_SHARED_BYTES


# component_slots_tiled: pixels a block ranks roots in, rows a pass block
# walks, and its warps (at most; csrc/postproc_kernel.cu kPassThreads / 32)
SLOTS_CHUNK = 8192
SLOTS_TILE_ROWS = 32
SLOTS_TILE_WARPS = 8


def _empty_outputs(B: int, H: int, W: int, K: int, C: int, dev) -> dict:
    """The eight outputs of K2 and K12c, in their C argument order."""
    shapes = {
        "rootvals": (B, K),
        "slots": (B, H, W),
        "minx": (B, K, H),
        "maxx": (B, K, H),
        "num_components_total": (B,),
    }
    out = {k: torch.empty(v, dtype=torch.int32, device=dev) for k, v in shapes.items()}
    for k, v in (("areas", (B, K)), ("det_sums", (B, K)), ("cls_sums", (B, K, max(C - 1, 1)))):
        out[k] = torch.empty(v, dtype=torch.float32, device=dev)
    return out


def component_slots(
    logits: torch.Tensor, labels: torch.Tensor, max_components: int,
    threshold: float = 0.5,
) -> dict:
    """Slots and stats from (B, H, W) detection logits or (B, H, W, C)
    logits at any strides, and the raw labels (the slots kernel).

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    or raises: a cluster of SLOT_CTAS blocks per image (counted here) where
    K12c could run (``geometry_compat_fits``), else
    ``component_slots_tiled``.
    """
    if logits.device.type == "cpu":
        return component_slots_reference(logits, labels, max_components, threshold)
    logits = _as_nhwc(logits)
    _check_slots_inputs(logits, labels)
    B, H, W, C = logits.shape
    K = max_components
    if not geometry_compat_fits(H, W, K, C):
        return component_slots_tiled(logits, labels, K, threshold)
    nw = stats_warps(H, W, K, C)
    lib = _build.load("postproc_kernel", _FUNCS)
    out = _empty_outputs(B, H, W, K, C, logits.device)
    _build.launch(
        lib, "component_slots" + LOGIT_DTYPES[logits.dtype], logits.device, logits.data_ptr(),
        *logits.stride(), C, labels.data_ptr(), *(t.data_ptr() for t in out.values()),
        B, H, W, K, 32 * nw, threshold_logit(threshold),
    )
    count_launch(component_slots, logits.dtype)
    return out


component_slots.launches = 0
component_slots.launches_bf16 = 0


def _check_slots_inputs(logits: torch.Tensor, labels: torch.Tensor) -> None:
    _check_logits(logits)
    _build.check_input(labels, "labels", torch.int32, 3, logits.device)
    B, H, W, _ = logits.shape
    if labels.shape != (B, H, W):
        raise ValueError(f"labels {tuple(labels.shape)} != logits {(B, H, W)}")
    if H * W >= 1 << 30 or B > 65535:
        raise ValueError(f"{B} maps of {H}x{W}: the slots kernels take H*W < 2^30, B <= 65535")


def component_slots_tiled(
    logits: torch.Tensor, labels: torch.Tensor, max_components: int,
    threshold: float = 0.5,
) -> dict:
    """``component_slots`` for maps of any size: the roots ranked over
    raster chunks of SLOTS_CHUNK pixels, then the pixel pass over tiles of
    SLOTS_TILE_ROWS rows by 32 columns a warp, the extremes in device
    memory, each tile's stats partials summed over the tiles in a fixed
    order (four launches).  Outputs as ``component_slots``; two launches
    agree bit for bit, and the stats with the cluster kernel's within f32
    rounding (another order of the sums).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if logits.device.type == "cpu":
        return component_slots_reference(logits, labels, max_components, threshold)
    logits = _as_nhwc(logits)
    _check_slots_inputs(logits, labels)
    B, H, W, C = logits.shape
    K = max_components
    nw = _tiled_pass_warps(W, K, C)
    threads = 32 * nw
    tiles = -(-W // threads) * -(-H // SLOTS_TILE_ROWS)
    dev = logits.device
    counts = torch.empty((B, -(-(H * W) // SLOTS_CHUNK)), dtype=torch.int32, device=dev)
    tpart = torch.empty((B, tiles, K, C), dtype=torch.float32, device=dev)
    tcnt = torch.empty((B, tiles, K), dtype=torch.int32, device=dev)
    lib = _build.load("postproc_kernel", _FUNCS)
    out = _empty_outputs(B, H, W, K, C, dev)
    _build.launch(
        lib, "component_slots_tiled" + LOGIT_DTYPES[logits.dtype], dev, logits.data_ptr(),
        *logits.stride(), C, labels.data_ptr(), *(t.data_ptr() for t in out.values()),
        counts.data_ptr(), tpart.data_ptr(), tcnt.data_ptr(),
        B, H, W, K, threads, SLOTS_CHUNK, SLOTS_TILE_ROWS, threshold_logit(threshold),
    )
    count_launch(component_slots_tiled, logits.dtype)
    return out


component_slots_tiled.launches = 0
component_slots_tiled.launches_bf16 = 0


def geometry_compat_reference(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """Plain version of K12c: the slots and stats of the CCL labels.  The
    TPU's K12c runs K1's rounds (with the same H+W cap) and then K2's, so
    this is exactly its semantics."""
    logits = _as_nhwc(logits)
    labels = ccl_labels_reference(logits[..., 0], threshold, connectivity)
    return component_slots_reference(logits, labels, max_components, threshold)


_GEO_FUNCS = {
    **{
        "geometry_compat" + sfx: _LOGITS_ARGS + [_build.P] * 8 + [_build.I] * 5
        + [_build.F, _build.I, _build.P]
        for sfx in LOGIT_DTYPES.values()
    },
    **{
        "geometry_compat_large" + sfx: _LOGITS_ARGS + [_build.P] * 12 + [_build.I] * 7
        + [_build.F, _build.I, _build.P]
        for sfx in LOGIT_DTYPES.values()
    },
}


def _tiled_pass_warps(W: int, K: int, C: int) -> int:
    """Warps of a pass tile of ``component_slots_tiled`` (and of its phase in
    ``geometry_compat_large``): up to SLOTS_TILE_WARPS, no more than the
    map's 32-column strips, each warp's stats partial set in shared memory."""
    nw = min(SLOTS_TILE_WARPS, -(-W // 32), (MAX_SHARED_BYTES - K * 4) // (K * (C + 1) * 4))
    if nw < 1:
        raise NotImplementedError(
            f"K={K}, C={C}: one warp's stats partial set exceeds one block's "
            "shared memory in the tiled slots kernel (ROADMAP.md §2a)"
        )
    return nw


def geometry_compat(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """(B, H, W) detection logits or (B, H, W, C) logits at any strides ->
    the slots and stats outputs, CCL and slots fused in one kernel (K12c, a
    cluster of SLOT_CTAS blocks per image, each holding half of the label
    rows in shared memory; union-find with no round cap, as K1).  Past
    ``geometry_compat_fits`` it is ``geometry_compat_large``'s one launch.

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    or raises.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if logits.device.type == "cpu":
        return geometry_compat_reference(logits, max_components, threshold, connectivity)
    logits = _as_nhwc(logits)
    _check_logits(logits)
    B, H, W, C = logits.shape
    K = max_components
    if not geometry_compat_fits(H, W, K, C):
        return geometry_compat_large(logits, K, threshold, connectivity)
    nw = stats_warps(H, W, K, C)
    lib = _build.load("geometry_kernel", _GEO_FUNCS)
    out = _empty_outputs(B, H, W, K, C, logits.device)
    _build.launch(
        lib, "geometry_compat" + LOGIT_DTYPES[logits.dtype], logits.device, logits.data_ptr(),
        *logits.stride(), C, *(t.data_ptr() for t in out.values()),
        B, H, W, K, 32 * nw, threshold_logit(threshold), connectivity,
    )
    count_launch(geometry_compat, logits.dtype)
    return out


geometry_compat.launches = 0
geometry_compat.launches_bf16 = 0


def geometry_compat_large(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """K12c for maps of any size (H*W < 2^30): the phases of
    ``ccl_labels_tiled`` (tiles, seams, flatten) and
    ``component_slots_tiled`` (count, rank, the tiled pixel pass with its
    tiles and warps, finish) in one cooperative launch of persistent
    blocks, grid-wide barriers between the phases, the labels in a
    device-memory workspace.  The eight outputs equal that pair's bit for
    bit.  ``geometry_compat`` takes it past ``geometry_compat_fits``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if logits.device.type == "cpu":
        return geometry_compat_reference(logits, max_components, threshold, connectivity)
    logits = _as_nhwc(logits)
    _check_logits(logits)
    B, H, W, C = logits.shape
    K = max_components
    if H * W >= 1 << 30:
        raise ValueError(f"a {H}x{W} map: the large K12c takes H*W < 2^30")
    nw = _tiled_pass_warps(W, K, C)
    tiles = -(-W // (32 * nw)) * -(-H // SLOTS_TILE_ROWS)
    dev = logits.device
    labels = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    counts = torch.empty((B, -(-(H * W) // SLOTS_CHUNK)), dtype=torch.int32, device=dev)
    tpart = torch.empty((B, tiles, K, C), dtype=torch.float32, device=dev)
    tcnt = torch.empty((B, tiles, K), dtype=torch.int32, device=dev)
    lib = _build.load("geometry_kernel", _GEO_FUNCS)
    out = _empty_outputs(B, H, W, K, C, dev)
    _build.launch(
        lib, "geometry_compat_large" + LOGIT_DTYPES[logits.dtype], dev, logits.data_ptr(),
        *logits.stride(), C, *(t.data_ptr() for t in out.values()), labels.data_ptr(),
        counts.data_ptr(), tpart.data_ptr(), tcnt.data_ptr(), B, H, W, K, nw, SLOTS_CHUNK,
        SLOTS_TILE_ROWS, threshold_logit(threshold), connectivity,
    )
    count_launch(geometry_compat_large, logits.dtype)
    return out


geometry_compat_large.launches = 0
geometry_compat_large.launches_bf16 = 0


def component_geometry(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """(B, H, W) detection logits or (B, H, W, C) logits -> the eight
    outputs of the slots kernel: CCL then slots, or K12c when
    ``UBDVSS_PALLAS_COMPAT`` is ``"1"`` (read at each call).  The logits
    stay at their dtype: the kernels read f32 or bf16, and CCL takes a
    (B, H, W) copy of the detection channel."""
    logits = _as_nhwc(logits)
    if os.environ.get("UBDVSS_PALLAS_COMPAT", "") == "1":
        return geometry_compat(logits, max_components, threshold, connectivity)
    labels = ccl_labels_from_logits(logits[..., 0].contiguous(), threshold, connectivity)
    return component_slots(logits, labels, max_components, threshold)


def component_slots_from_logits(
    det_logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """(B, H, W) detection logits -> slot map + rootvals + rect extremes,
    the five outputs of the JAX function of this name: rootvals (B, K)
    int32 (H*W at padding), slots (B, H, W) int32, minx/maxx (B, K, H)
    int32, num_components_total (B,) int32."""
    geo = component_geometry(det_logits, max_components, threshold, connectivity)
    return {k: geo[k] for k in _GEO_KEYS}


def component_stats_from_logits(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8,
) -> dict:
    """(B, H, W, C) NHWC logits -> per-component stats.

    Geometry and stats from the kernels on the card (the stats summed in
    K2's or K12c's pixel pass); on the CPU the stats are the plain one-hot
    products.  Returns (B, K) rootvals/areas/det_sums, (B, K, n_cls)
    cls_sums (a zero column when detection-only), (B, K, H) minx/maxx, the
    slot map as ``labels`` and ``num_components_total``.
    """
    geo = component_geometry(logits, max_components, threshold, connectivity)
    out = {k: geo[k] for k in ("rootvals", "areas", "det_sums", "cls_sums", "minx", "maxx")}
    out["labels"] = geo["slots"]
    out["num_components_total"] = geo["num_components_total"]
    return out

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
    exceed one block's shared memory (K=64 at a 256² map and beyond): each
    raster chunk's roots counted and listed, the pixel pass over bands of
    rows by the full width (each band gathering the K smallest roots,
    writing its rows' extremes and its stats partials), the partials summed
    over the bands in order (three launches; no float atomic), at the
    geometry of ``tiled_plan``, which ``ccl_labels_tiled`` and
    ``geometry_compat_large`` launch with too.  ``component_slots`` takes
    it where K12c cannot run.
  * ``geometry_compat`` — CCL, slots and stats as one kernel (K12c,
    ``_geometry_kernel_compat``; a cluster of blocks per image, each
    holding a band of the label rows), the same outputs as slots after
    CCL, stats bit for bit; past
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

K2 and K12c launch at one plan (``slot_plan``, ``SlotPlan``): a cluster
of 16, 8 or 4 blocks an image where all the batch's blocks fit the card at
once (a detect call's heatmap, the packed route's four 256² maps), else 2
(B >= 34 at 132 SMs: the main path's and the stream's B=64), each block
running ``stats_warps`` virtual warps of the pixel pass: two blocks run
the two-block kernels, a wider cluster the band kernels (each block a band
of rows; csrc/postproc_kernel.cu, csrc/geometry_kernel.cu).  The stats' sums
follow the virtual warps, so a batch of few images sums an image in
another order than a batch of 34 or more (within f32 rounding); K2 and
K12c of one batch agree bit for bit.

The JAX package leaves the stats to XLA, as one-hot contractions over the
slot map; their plain version here does the same in f32 torch, and that is
what a CPU tensor takes.  On the card K2 and K12c sum them in the pixel
pass that assigns the slots, reading the class logits where the head wrote
them, so no one-hot exists there.

Any logit channel count: the kernels' stats keep up to
``REGISTER_CHANNELS`` channels of a pixel, and its class sums, in
registers, one pixel pass reading each logit once (an instance compiled
for 1 or 17 channels, else for the least of ``STATS_BOUNDS`` that holds
C: ``stats_channel_bound``; past 17 channels the cluster kernels' warps
running their blocks' virtual warps in turn, so a thread has more
registers), and past it run one pixel pass a chunk of
``CHUNK_CLASSES`` classes (``class_chunks``; each pixel's softmax max and
denominator over all classes in each, so the sums are a single pass's).
The one limit is the tiled plan's: one warp's partial set, K (C + 1)
words, in one block's shared memory (``tiled_plan`` raises past it).

The logits are f32 or bf16 (the bf16 route's trunk output).  On bf16
logits the class softmax is taken in f32 and each probability rounded to
bf16 before the f32 sums, as the JAX package stores it at the logits'
dtype (``postproc_kernel.py:461-466``); the sigmoid and the counts are not
rounded.  Each kernel has a bf16 instantiation, counted in its wrapper's
``launches_bf16`` (f32 launches in ``launches``).

``packed_phases=(2, 2)`` (the packed route's logits, phase-major
(B, H/2, W/2, 4C), channel (2 py + px) C + c for pixel (2i + py, 2j + px),
``ubdvss_tpu/ops/pallas/postproc_kernel.py:381-477``): the kernels read
them in place at their phase strides (the ``_packed`` C entry points,
``geometry.cuh`` Phase), counted in each wrapper's ``launches_packed``
besides its ``launches``/``launches_bf16``; CCL takes a contiguous copy of
the unpacked detection channel, as the JAX package unpacks it.  The plain
versions sum the stats in the packed pixel order, as the JAX package's
``"bhwyx"`` contractions do.

The JAX package stacks G images per CCL program (``_stack_group``) to
amortise TPU grid overhead; blocks run in parallel here, so there is no
stacking.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np
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


def _check_phases(packed_phases) -> None:
    if packed_phases is not None and tuple(packed_phases) != (2, 2):
        raise NotImplementedError(f"packed_phases={packed_phases}: the port reads (2, 2) only, "
                                  "the packed route's layout")


def unpacked_shape(logits: torch.Tensor, packed_phases=None) -> tuple[int, int, int, int]:
    """(B, H, W, C) of the map ``logits`` hold, phase-major packed
    (B, H/2, W/2, 4C) with ``packed_phases=(2, 2)``."""
    _check_phases(packed_phases)
    B, h, w, c = logits.shape
    return (B, h, w, c) if packed_phases is None else (B, 2 * h, 2 * w, c // 4)


def detection_logits(logits: torch.Tensor, packed_phases=None) -> torch.Tensor:
    """The (B, H, W) detection channel of (B, H, W, C) logits, or of
    phase-major packed ones (a copy, unpacked)."""
    if packed_phases is None:
        return logits[..., 0]
    B, H, W, C = unpacked_shape(logits, packed_phases)
    lg = logits.reshape(B, H // 2, W // 2, 2, 2, C)[..., 0]
    return lg.permute(0, 1, 3, 2, 4).reshape(B, H, W)


def _stats_reference(logits: torch.Tensor, slots: torch.Tensor, K: int,
                     packed_phases=None) -> dict:
    """Plain per-slot stats: areas, detection-probability sums and
    class-probability sums as one-hot products in f32, as the JAX package
    leaves them to XLA; (B, K, 1) zeros for cls_sums when C = 1.  The class
    softmax is taken in f32 and rounded to the logits' dtype (a no-op for
    f32 logits) before the f32 sums.  Packed logits are summed in their
    own pixel order (cell, then phase), the slot map packed to match."""
    if packed_phases is not None:
        B, H, W, C = unpacked_shape(logits, packed_phases)
        logits = logits.reshape(B, H // 2, W // 2 * 4, C)
        slots = slots.reshape(B, H // 2, 2, W // 2, 2).permute(0, 1, 3, 2, 4)
        slots = slots.reshape(B, H // 2, W // 2 * 4)
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
    threshold: float = 0.5, packed_phases=None,
) -> dict:
    """Plain version of the slots kernel: the JAX K-round loop, batched, then
    the one-hot stats.  ``logits`` is (B, H, W) or (B, H, W, C), or
    phase-major packed with ``packed_phases``."""
    logits = _as_nhwc(logits)
    det = detection_logits(logits, packed_phases)
    B, H, W = det.shape
    K = max_components
    N = H * W
    dev = logits.device
    mask = det.to(torch.float32) > threshold_logit(threshold)
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
        **_stats_reference(logits, slots, K, packed_phases),
    }


def _entry_points(entries: dict) -> dict:
    """The C entry points' argtypes: each of ``entries`` (name: (args before
    the strides, args after them)) for both logit dtypes, with the four
    strides (logits, sb, sy, sx, sc), and as ``<name>_packed`` with the two
    phase strides after them."""
    out = {}
    for name, (head, tail) in entries.items():
        for sfx in LOGIT_DTYPES.values():
            out[name + sfx] = head + [_build.L] * 4 + tail
            out[name + "_packed" + sfx] = head + [_build.L] * 6 + tail
    return out


_FUNCS = _entry_points({
    "component_slots": ([_build.P], [_build.I] + [_build.P] * 9 + [_build.I] * 6
                        + [_build.F, _build.P]),
    "component_slots_tiled": ([_build.P], [_build.P] * 15 + [_build.I, _build.F, _build.P]),
})
_FUNCS["tiled_plan_ints"] = []
_FUNCS["stats_channel_bound"] = [_build.I]
_FUNCS["component_slots_room"] = [_build.I] * 7 + [_build.P]
_FUNCS["slot_plan_ints"] = [_build.I] * 3 + [_build.P] * 2


# The kernels' stats keep a pixel's class logits and class sums in
# registers, each logit loaded once, in one pixel pass up to
# REGISTER_CHANNELS channels; past it in chunks of CHUNK_CLASSES classes,
# one pass a chunk (csrc/geometry.cuh, with_channel_bound, kWideChannels,
# kChunkClasses).  Their instances: exact at STATS_EXACT channels, else the
# least of the guarded bounds STATS_BOUNDS that holds C (kStatsBounds).
REGISTER_CHANNELS, CHUNK_CLASSES = 65, 40
STATS_EXACT, STATS_BOUNDS = (1, 17), (5, 9, 16, 25, 33, 41, REGISTER_CHANNELS)


def stats_channel_bound(C: int) -> int:
    """The channel count the stats kernels are compiled for at C logit
    channels: C where exact, the bound that holds it, or past one pass
    REGISTER_CHANNELS + 1 (the chunks' marker); the C entry point
    ``stats_channel_bound`` returns the kernels' own."""
    if C in STATS_EXACT:
        return C
    return next((b for b in STATS_BOUNDS if C <= b), REGISTER_CHANNELS + 1)


def class_chunks(C: int) -> int:
    """The pixel passes of the stats kernels at C logit channels."""
    return 1 if C <= REGISTER_CHANNELS else -(-(C - 1) // CHUNK_CLASSES)


def _check_logits(logits: torch.Tensor, packed_phases=None) -> None:
    """The kernels read the logits at their strides: f32 or bf16, 4 dims,
    on the card, any channel count."""
    if logits.device.type != "cuda":
        raise ValueError(f"logits: expected a CUDA tensor, got {logits.device}")
    if logits.dtype not in LOGIT_DTYPES:
        raise TypeError(f"logits: expected torch.float32 or torch.bfloat16, got {logits.dtype}")
    if logits.ndim != 4:
        raise ValueError(f"logits: expected 3 or 4 dims, got shape {tuple(logits.shape)}")


def _strides(logits: torch.Tensor, C: int, packed_phases, name: str) -> tuple[str, tuple]:
    """The C entry point's name for this dtype and layout, and the logits'
    element strides it takes: (sb, sy, sx, sc), then for packed logits the
    phase strides (2 C sc, C sc)."""
    st = tuple(logits.stride())
    if packed_phases is not None:
        name += "_packed"
        st += (2 * C * st[3], C * st[3])
    return name + LOGIT_DTYPES[logits.dtype], st


def _count(fn, logits: torch.Tensor, packed_phases) -> None:
    count_launch(fn, logits.dtype)
    fn.launches_packed += packed_phases is not None


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


# The clusters of a slot plan past the least, 2 (csrc/geometry.cuh
# SlotPlan, kSlotCtas, kMaxSlotCtas), largest first; past 8 non-portable.
SLOT_BLOCKS = (16, 8, 4)


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """The launch plan of K2 and K12c (``struct SlotPlan`` in
    csrc/geometry.cuh): ``blocks`` blocks an image in one cluster, each
    running ``sets`` virtual warps of the pixel pass (one stats partial set
    each), block r the r-th run of ``sets``; the sums run over the partial
    sets in the virtual warps' order: on two blocks one running sum, on a
    wider cluster each block's running sum, then the running sum of the
    blocks' sums."""

    blocks: int
    sets: int

    @property
    def virtual_warps(self) -> int:
        return self.blocks * self.sets

    @property
    def threads(self) -> int:
        """32 x a block's virtual warps, the C entry points' ``threads``."""
        return 32 * self.sets

    def block_warps(self, r: int) -> range:
        """The virtual warps block ``r`` runs."""
        return range(r * self.sets, (r + 1) * self.sets)

    def sum_order(self) -> list[list[int]]:
        """The partial sets of each group of the sums, in order: each
        group's running sum, then the groups' (``slot_finish`` on two
        blocks, ``band_finish`` on more)."""
        if self.blocks == 2:
            return [list(range(self.virtual_warps))]
        return [list(self.block_warps(r)) for r in range(self.blocks)]

    @property
    def ints(self) -> tuple[int, int]:
        """(threads, blocks), as the C entry points take them."""
        return self.threads, self.blocks


def slot_plan(B: int, H: int, W: int, K: int, C: int, sms: int = 132,
              room: dict | None = None) -> SlotPlan:
    """The plan of K2 and K12c for B maps of H x W, K slots, C logit
    channels, on a card of ``sms`` SMs where ``room[g]`` clusters of g
    blocks run at once (None: as many as the SMs hold): each block runs
    ``stats_warps`` virtual warps; the largest cluster of SLOT_BLOCKS whose
    blocks all run at once (g B <= sms, B <= room[g]) takes every image;
    else two blocks an image (B >= 34 at 132 SMs: the main path's and the
    stream's B=64).  The C mirror is csrc/geometry.cuh ``slot_plan``
    (``slot_plan_ints``)."""
    sets = stats_warps(H, W, K, C)
    for g in SLOT_BLOCKS:
        if g * B <= sms and (room is None or B <= room.get(g, 0)):
            return SlotPlan(g, sets)
    return SlotPlan(2, sets)


@functools.lru_cache(maxsize=256)
def cluster_room(device_index: int, H: int, W: int, K: int, C: int, bf16: bool) -> dict:
    """{g: clusters of g blocks of K2 and of K12c the card runs at once,
    the fewer of the two} for each g of SLOT_BLOCKS, at ``stats_warps``
    virtual warps a block (``component_slots_room``,
    ``geometry_compat_room``: cudaOccupancyMaxActiveClusters)."""
    threads = 32 * stats_warps(H, W, K, C)
    dev = torch.device("cuda", device_index)
    room = {}
    for g in SLOT_BLOCKS:
        n = []
        for lib, fn in ((_build.load("postproc_kernel", _FUNCS), "component_slots_room"),
                        (_build.load("geometry_kernel", _GEO_FUNCS), "geometry_compat_room")):
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                err = getattr(lib, fn)(C, H, W, K, threads, g, int(bf16), ctypes.byref(out))
            _build.check(lib, err, fn)
            n.append(out.value)
        room[g] = min(n)
    return room


def launch_plan(logits: torch.Tensor, H: int, W: int, K: int, C: int) -> SlotPlan:
    """The plan of K2 and K12c for these logits on their card (its SMs and
    its room for each cluster size)."""
    dev = logits.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    room = cluster_room(index, H, W, K, C, logits.dtype == torch.bfloat16)
    return slot_plan(logits.shape[0], H, W, K, C, sms, room)


# The tiled kernels' geometry (``tiled_plan``): the device-memory CCL's
# tiles and threads, the roots' raster chunks (at least ROOTS_CHUNK pixels,
# at most MAX_CHUNKS an image, whose counts each pass block scans), the
# pixel pass's bands of PASS_ROWS rows by the full width, each row walked
# PASS_SEG columns at a time a warp, up to PASS_WARPS warps a band, and the
# finish's blocks of FINISH_THREADS threads, 32 sums a block
# (csrc/tiled.cuh kFinishThreads).
CCL_TILE = (32, 64)
CCL_THREADS, SEAM_THREADS = 512, 128
ROOTS_CHUNK, MAX_CHUNKS = 2048, 1024
PASS_ROWS, PASS_SEG, PASS_WARPS = 4, 256, 8
FINISH_THREADS = 256
# the order of the plan's ints (struct Plan in csrc/tiled.cuh)
PLAN_FIELDS = (
    "B", "H", "W", "K", "C",
    "tile_h", "tile_w", "ccl_threads", "seam_threads",
    "chunk", "nchunks",
    "pass_warps", "tile_rows", "seg", "nseg", "bands", "ext_smem",
    "fin_blocks",
)


@dataclasses.dataclass(frozen=True)
class TiledPlan:
    """The launch geometry of ``ccl_labels_tiled``, ``component_slots_tiled``
    and ``geometry_compat_large``, which the kernels read as ``ints``
    (``PLAN_FIELDS``), and the scratch it needs.  The pass keeps its band's
    extremes in shared memory (``ext_smem``) unless one warp's stats
    partial set leaves no room for them."""

    B: int
    H: int
    W: int
    K: int
    C: int
    tile_h: int
    tile_w: int
    ccl_threads: int
    seam_threads: int
    chunk: int
    nchunks: int
    pass_warps: int
    tile_rows: int
    seg: int
    nseg: int
    bands: int
    ext_smem: int
    fin_blocks: int

    @functools.cached_property
    def ints(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in PLAN_FIELDS], np.int32)

    @property
    def ccl_grid(self) -> tuple[int, int]:
        """(tile columns, tile rows) of one image."""
        return -(-self.W // self.tile_w), -(-self.H // self.tile_h)

    @property
    def ccl_smem(self) -> int:
        return self.tile_h * self.tile_w * 4

    @property
    def pass_smem(self) -> int:
        """Bytes of a pass band: its roots, then a stats partial set a warp
        and, with ``ext_smem``, its (K, tile_rows) min and max x, at least
        the 32 words the roots' scan takes first."""
        K, R = self.K, self.tile_rows
        rest = self.pass_warps * K * (self.C + 1) + self.ext_smem * 2 * K * R
        return 4 * (K + max(rest, 32))

    @property
    def large_smem(self) -> int:
        """Bytes of a block of ``geometry_compat_large``: every phase's,
        the finish's 512 words of scratch included."""
        return max(self.ccl_smem, self.pass_smem, 4 * 2 * FINISH_THREADS)

    def scratch_shapes(self) -> dict:
        """The int32 and f32 workspaces of the slots phases: the chunks'
        root counts and first-K lists, the bands' stats partials, and the
        bands' extremes when they do not fit shared memory."""
        B, K, C = self.B, self.K, self.C
        ext = (B, self.bands, 2, K, self.tile_rows) if not self.ext_smem else (1,)
        return {"counts": ((B, self.nchunks), torch.int32),
                "lists": ((B, self.nchunks, K), torch.int32),
                "tpart": ((B, self.bands, K, C), torch.float32),
                "tcnt": ((B, self.bands, K), torch.int32),
                "ext": (ext, torch.int32)}

    # the work items as the kernels walk them (the CPU tests hold their
    # coverage)
    def ccl_tile_pixels(self, tx: int, ty: int) -> tuple[np.ndarray, np.ndarray]:
        """(rows, columns) of CCL tile (tx, ty)."""
        y0, x0 = ty * self.tile_h, tx * self.tile_w
        return (np.arange(y0, min(y0 + self.tile_h, self.H)),
                np.arange(x0, min(x0 + self.tile_w, self.W)))

    def seam_pixels(self, tx: int, ty: int) -> list[tuple[int, int]]:
        """The (y, x) pixels CCL tile (tx, ty)'s seam pass visits, in its
        thread order: the top row, then the left and right columns below
        it, one column when the tile is one wide (``csrc/tiled.cuh``
        ccl_seam)."""
        rows, cols = self.ccl_tile_pixels(tx, ty)
        tw, th, y0, x0 = len(cols), len(rows), rows[0], cols[0]
        out = []
        for i in range(tw + (2 if tw > 1 else 1) * th):
            lx = i if i < tw else (0 if i < tw + th else tw - 1)
            ly = 0 if i < tw else (i - tw if i < tw + th else i - tw - th)
            if i >= tw and ly == 0:
                continue
            out.append((y0 + ly, x0 + lx))
        return out

    def flatten_groups(self) -> int:
        """The flatten's groups of four label words over the batch."""
        return -(-self.B * self.H * self.W // 4)

    def chunk_pixels(self, c: int) -> range:
        """The linear pixels of raster chunk ``c`` of an image."""
        return range(c * self.chunk, min((c + 1) * self.chunk, self.H * self.W))

    def band_units(self, band: int) -> dict[int, list[tuple[int, int, int]]]:
        """Warp w of pass band ``band``: its (row, first column, end column)
        segments in order (``csrc/tiled.cuh`` slots_pass)."""
        y0 = band * self.tile_rows
        rows = min(self.tile_rows, self.H - y0)
        out = {w: [] for w in range(self.pass_warps)}
        for u in range(rows * self.nseg):
            r, sg = divmod(u, self.nseg)
            xs = sg * self.seg
            out[u % self.pass_warps].append((y0 + r, xs, min(xs + self.seg, self.W)))
        return out

    def finish_items(self, f: int) -> range:
        """The sums finish block ``f`` writes: items of the image's K*C
        (slot, channel) sums, then its K counts."""
        return range(32 * f, min(32 * f + 32, self.K * (self.C + 1)))


@functools.lru_cache(maxsize=256)
def tiled_plan(B: int, H: int, W: int, K: int, C: int) -> TiledPlan:
    """The one launch plan of the tiled CCL, the tiled slots and the large
    K12c for B maps of H x W with K slots and C logit channels.  Raises
    NotImplementedError when one warp's stats partial set exceeds one
    block's shared memory."""
    N = H * W
    chunk = max(ROOTS_CHUNK, -(-(-(-N // MAX_CHUNKS)) // 256) * 256)  # nchunks <= MAX_CHUNKS
    seg = PASS_SEG
    nseg = -(-W // seg)
    R = PASS_ROWS
    words = MAX_SHARED_BYTES // 4
    set_words = K * (C + 1)
    nw = min(PASS_WARPS, R * nseg, (words - K) // set_words)
    if nw < 1:
        raise NotImplementedError(
            f"K={K}, C={C}: one warp's stats partial set, K (C + 1) = {set_words} words, "
            f"exceeds one block's shared memory ({MAX_SHARED_BYTES} B) in the tiled slots "
            "kernel (ROADMAP.md §2a)"
        )
    ext_smem = int(K + nw * set_words + 2 * K * R <= words)
    return TiledPlan(
        B=B, H=H, W=W, K=K, C=C, tile_h=CCL_TILE[0], tile_w=CCL_TILE[1],
        ccl_threads=CCL_THREADS, seam_threads=SEAM_THREADS,
        chunk=chunk, nchunks=-(-N // chunk), pass_warps=nw, tile_rows=R, seg=seg, nseg=nseg,
        bands=-(-H // R), ext_smem=ext_smem, fin_blocks=-(-K * (C + 1) // 32),
    )


def tiled_scratch(plan: TiledPlan, dev) -> dict:
    """The plan's workspaces on ``dev``, in the C entry points' order."""
    return {k: torch.empty(shape, dtype=dt, device=dev)
            for k, (shape, dt) in plan.scratch_shapes().items()}


_PLAN_CHECKED: set = set()  # libraries whose struct Plan matches PLAN_FIELDS


def check_plan_length(lib, name: str) -> None:
    """Raise unless the library reads as many plan ints as PLAN_FIELDS
    holds (once a library)."""
    if name not in _PLAN_CHECKED:
        if lib.tiled_plan_ints() != len(PLAN_FIELDS):
            raise RuntimeError(f"{name}: the kernels read {lib.tiled_plan_ints()} plan ints, "
                               f"the plan has {len(PLAN_FIELDS)}")
        _PLAN_CHECKED.add(name)


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
    threshold: float = 0.5, packed_phases=None,
) -> dict:
    """Slots and stats from (B, H, W) detection logits or (B, H, W, C)
    logits at any strides (phase-major packed with ``packed_phases``), and
    the raw labels (the slots kernel).

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    or raises: a cluster of blocks per image at ``launch_plan`` (counted
    here) where K12c could run (``geometry_compat_fits``), else
    ``component_slots_tiled``.  A cluster the card refuses raises.
    """
    if logits.device.type == "cpu":
        return component_slots_reference(logits, labels, max_components, threshold,
                                         packed_phases)
    logits = _as_nhwc(logits)
    _check_slots_inputs(logits, labels, packed_phases)
    B, H, W, C = unpacked_shape(logits, packed_phases)
    K = max_components
    if not geometry_compat_fits(H, W, K, C):
        return component_slots_tiled(logits, labels, K, threshold, packed_phases)
    plan = launch_plan(logits, H, W, K, C)
    lib = _build.load("postproc_kernel", _FUNCS)
    out = _empty_outputs(B, H, W, K, C, logits.device)
    fn, strides = _strides(logits, C, packed_phases, "component_slots")
    _build.launch(
        lib, fn, logits.device, logits.data_ptr(), *strides, C, labels.data_ptr(),
        *(t.data_ptr() for t in out.values()), B, H, W, K, *plan.ints, threshold_logit(threshold),
    )
    _count(component_slots, logits, packed_phases)
    return out


component_slots.launches = 0
component_slots.launches_bf16 = 0
component_slots.launches_packed = 0


def _check_slots_inputs(logits: torch.Tensor, labels: torch.Tensor, packed_phases=None) -> None:
    _check_logits(logits, packed_phases)
    B, H, W, _ = unpacked_shape(logits, packed_phases)
    _build.check_input(labels, "labels", torch.int32, 3, logits.device)
    if labels.shape != (B, H, W):
        raise ValueError(f"labels {tuple(labels.shape)} != logits {(B, H, W)}")
    if H * W >= 1 << 30 or B > 65535:
        raise ValueError(f"{B} maps of {H}x{W}: the slots kernels take H*W < 2^30, B <= 65535")


def component_slots_tiled(
    logits: torch.Tensor, labels: torch.Tensor, max_components: int,
    threshold: float = 0.5, packed_phases=None,
) -> dict:
    """``component_slots`` for maps of any size, at ``tiled_plan``'s
    geometry (three launches): each raster chunk's root count and first K
    roots; the pixel pass over bands of rows by the full width, each band
    gathering the image's K smallest roots from the chunks, writing its
    rows' slots and extremes and its stats partials; the sums over the
    bands in a fixed order.  Outputs as ``component_slots``; two launches
    agree bit for bit (no float atomic), and the stats with the cluster
    kernel's within f32 rounding (another order of the sums).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if logits.device.type == "cpu":
        return component_slots_reference(logits, labels, max_components, threshold,
                                         packed_phases)
    logits = _as_nhwc(logits)
    _check_slots_inputs(logits, labels, packed_phases)
    B, H, W, C = unpacked_shape(logits, packed_phases)
    plan = tiled_plan(B, H, W, max_components, C)
    dev = logits.device
    scratch = tiled_scratch(plan, dev)
    lib = _build.load("postproc_kernel", _FUNCS)
    check_plan_length(lib, "postproc_kernel")
    out = _empty_outputs(B, H, W, max_components, C, dev)
    arr = plan.ints
    fn, strides = _strides(logits, C, packed_phases, "component_slots_tiled")
    _build.launch(
        lib, fn, dev, logits.data_ptr(), *strides, labels.data_ptr(),
        *(t.data_ptr() for t in out.values()), *(t.data_ptr() for t in scratch.values()),
        arr.ctypes.data, arr.size, threshold_logit(threshold),
    )
    _count(component_slots_tiled, logits, packed_phases)
    return out


component_slots_tiled.launches = 0
component_slots_tiled.launches_bf16 = 0
component_slots_tiled.launches_packed = 0


def geometry_compat_reference(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8, packed_phases=None,
) -> dict:
    """Plain version of K12c: the slots and stats of the CCL labels.  The
    TPU's K12c runs K1's rounds (with the same H+W cap) and then K2's, so
    this is exactly its semantics."""
    logits = _as_nhwc(logits)
    labels = ccl_labels_reference(detection_logits(logits, packed_phases), threshold,
                                  connectivity)
    return component_slots_reference(logits, labels, max_components, threshold, packed_phases)


_GEO_FUNCS = _entry_points({
    "geometry_compat": ([_build.P], [_build.I] + [_build.P] * 8 + [_build.I] * 6
                        + [_build.F, _build.I, _build.P]),
    "geometry_compat_large": ([_build.P], [_build.P] * 15
                              + [_build.I, _build.F, _build.I, _build.P]),
})
_GEO_FUNCS["tiled_plan_ints"] = []
_GEO_FUNCS["geometry_compat_room"] = [_build.I] * 7 + [_build.P]


def geometry_compat(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8, packed_phases=None,
) -> dict:
    """(B, H, W) detection logits or (B, H, W, C) logits at any strides
    (phase-major packed with ``packed_phases``) -> the slots and stats
    outputs, CCL and slots fused in one kernel (K12c, a cluster of blocks
    per image at K2's ``launch_plan``, each holding a band of the label
    rows in shared memory; union-find with no round cap, as K1).  Past
    ``geometry_compat_fits`` it is ``geometry_compat_large``'s one launch.

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel
    or raises.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if logits.device.type == "cpu":
        return geometry_compat_reference(logits, max_components, threshold, connectivity,
                                         packed_phases)
    logits = _as_nhwc(logits)
    _check_logits(logits, packed_phases)
    B, H, W, C = unpacked_shape(logits, packed_phases)
    K = max_components
    if not geometry_compat_fits(H, W, K, C):
        return geometry_compat_large(logits, K, threshold, connectivity, packed_phases)
    plan = launch_plan(logits, H, W, K, C)
    lib = _build.load("geometry_kernel", _GEO_FUNCS)
    out = _empty_outputs(B, H, W, K, C, logits.device)
    fn, strides = _strides(logits, C, packed_phases, "geometry_compat")
    _build.launch(
        lib, fn, logits.device, logits.data_ptr(), *strides, C,
        *(t.data_ptr() for t in out.values()), B, H, W, K, *plan.ints, threshold_logit(threshold),
        connectivity,
    )
    _count(geometry_compat, logits, packed_phases)
    return out


geometry_compat.launches = 0
geometry_compat.launches_bf16 = 0
geometry_compat.launches_packed = 0


def geometry_compat_large(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8, packed_phases=None,
) -> dict:
    """K12c for maps of any size (H*W < 2^30): the phases of
    ``ccl_labels_tiled`` (tiles, seams, flatten) and
    ``component_slots_tiled`` (roots, the band pass, finish) at the same
    ``tiled_plan`` in one cooperative launch of persistent blocks,
    grid-wide barriers between the phases, the labels in a device-memory
    workspace.  The eight outputs equal that pair's bit for bit.
    ``geometry_compat`` takes it past ``geometry_compat_fits``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if logits.device.type == "cpu":
        return geometry_compat_reference(logits, max_components, threshold, connectivity,
                                         packed_phases)
    logits = _as_nhwc(logits)
    _check_logits(logits, packed_phases)
    B, H, W, C = unpacked_shape(logits, packed_phases)
    if H * W >= 1 << 30:
        raise ValueError(f"a {H}x{W} map: the large K12c takes H*W < 2^30")
    plan = tiled_plan(B, H, W, max_components, C)
    dev = logits.device
    labels = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    scratch = tiled_scratch(plan, dev)
    lib = _build.load("geometry_kernel", _GEO_FUNCS)
    check_plan_length(lib, "geometry_kernel")
    out = _empty_outputs(B, H, W, max_components, C, dev)
    arr = plan.ints
    fn, strides = _strides(logits, C, packed_phases, "geometry_compat_large")
    _build.launch(
        lib, fn, dev, logits.data_ptr(), *strides, *(t.data_ptr() for t in out.values()),
        labels.data_ptr(), *(t.data_ptr() for t in scratch.values()), arr.ctypes.data,
        arr.size, threshold_logit(threshold), connectivity,
    )
    _count(geometry_compat_large, logits, packed_phases)
    return out


geometry_compat_large.launches = 0
geometry_compat_large.launches_bf16 = 0
geometry_compat_large.launches_packed = 0


def component_geometry(
    logits: torch.Tensor, max_components: int, threshold: float = 0.5,
    connectivity: int = 8, packed_phases=None,
) -> dict:
    """(B, H, W) detection logits or (B, H, W, C) logits (phase-major
    packed with ``packed_phases``) -> the eight outputs of the slots
    kernel: CCL then slots, or K12c when ``UBDVSS_PALLAS_COMPAT`` is
    ``"1"`` (read at each call).  The logits stay at their dtype and
    layout: the kernels read f32 or bf16 at the logits' strides, and CCL
    takes a (B, H, W) copy of the (unpacked) detection channel."""
    logits = _as_nhwc(logits)
    if os.environ.get("UBDVSS_PALLAS_COMPAT", "") == "1":
        return geometry_compat(logits, max_components, threshold, connectivity, packed_phases)
    det = detection_logits(logits, packed_phases).contiguous()
    labels = ccl_labels_from_logits(det, threshold, connectivity)
    return component_slots(logits, labels, max_components, threshold, packed_phases)


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
    connectivity: int = 8, packed_phases=None,
) -> dict:
    """(B, H, W, C) NHWC logits -> per-component stats.

    Geometry and stats from the kernels on the card (the stats summed in
    K2's or K12c's pixel pass); on the CPU the stats are the plain one-hot
    products.  Returns (B, K) rootvals/areas/det_sums, (B, K, n_cls)
    cls_sums (a zero column when detection-only), (B, K, H) minx/maxx, the
    slot map as ``labels`` and ``num_components_total``.
    ``packed_phases=(py, px)``: the logits are space-to-depth packed,
    (B, H/py, W/px, py px C) phase-major (the packed route's); only (2, 2)
    is read.  The slot map and extremes are the unpacked map's.
    """
    geo = component_geometry(logits, max_components, threshold, connectivity, packed_phases)
    out = {k: geo[k] for k in ("rootvals", "areas", "det_sums", "cls_sums", "minx", "maxx")}
    out["labels"] = geo["slots"]
    out["num_components_total"] = geo["num_components_total"]
    return out

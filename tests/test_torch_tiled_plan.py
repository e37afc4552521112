"""PyTorch port: the launch plan of the tiled CCL, the tiled slots and the
large K12c (``ops/cuda/postproc_kernel.py`` ``tiled_plan``), on the CPU.

The kernels (``csrc/ccl_kernel.cu``, ``csrc/postproc_kernel.cu``,
``csrc/geometry_kernel.cu`` over ``csrc/tiled.cuh``) take every launch
dimension from the plan's ints.  Held here, for every shape the card tests
and ``chip_smoke.py`` give these kernels:

  * every pixel is covered by exactly one work item of each phase: the
    CCL's tiles, the seams (each tile's top row and side columns), the
    flatten's groups of four words, the roots' raster chunks, the pass's
    (row, segment) units of a band, and every sum by one finish block;
  * every index a phase writes lies inside the scratch the wrappers
    allocate, and each block's shared memory inside the H100's 227 KB;
  * ``ccl_labels_tiled``, ``component_slots_tiled`` and
    ``geometry_compat_large`` launch with the same plan (the wrappers
    driven on meta tensors, the launch intercepted);
  * the plan's ints are in the kernels' order, and the stats-partial cap
    raises where it did before the redesign and nowhere else.
"""

import ctypes

import numpy as np
import pytest
import torch

from ubdvss_tpu_torch.ops.cuda import _build, ccl_kernel
from ubdvss_tpu_torch.ops.cuda import postproc_kernel as pk

# (B, H, W) of every map the card tests and chip_smoke.py give the tiled
# kernels: the 2048² scans' 512² maps, the 4096² scan's 1024² map, the A4
# page's 1754x1240 and the 8192x1024 page's 2048x256 heatmaps, the detect
# call's 256², odd maps, one-pixel rows and columns, and small maps
SHAPES = [
    (8, 512, 512), (1, 1024, 1024), (1, 1754, 1240), (1, 2048, 256), (1, 256, 256),
    (3, 257, 1000), (2, 1, 60000), (2, 60000, 1), (1, 301, 299), (1, 256, 320),
    (2, 300, 1000), (2, 1000, 300), (2, 512, 250), (3, 128, 128), (4, 37, 53), (64, 60, 80),
]
# 41, 65: past the register chunk; 5, 25: the few and mid label sets
KC = [(16, 17), (64, 17), (64, 1), (1, 5), (16, 41), (64, 65), (16, 5), (16, 25)]


def _small(shapes, limit=600_000):
    """The shapes whose pixel-by-pixel walks stay quick (every shape's
    counts are checked in closed form elsewhere)."""
    return [s for s in shapes if s[1] * s[2] <= limit]


@pytest.mark.parametrize("B,H,W", _small(SHAPES))
def test_ccl_tiles_and_seams_cover_each_pixel_once(B, H, W):
    plan = pk.tiled_plan(B, H, W, 1, 1)
    ctx, cty = plan.ccl_grid
    seen = np.zeros((H, W), np.int32)
    border = np.zeros((H, W), np.int32)
    seam = np.zeros((H, W), np.int32)
    for ty in range(cty):
        for tx in range(ctx):
            rows, cols = plan.ccl_tile_pixels(tx, ty)
            seen[rows[:, None], cols[None, :]] += 1
            border[rows[0], cols] = 1
            border[rows, cols[0]] = 1
            border[rows, cols[-1]] = 1
            for y, x in plan.seam_pixels(tx, ty):
                seam[y, x] += 1
    assert (seen == 1).all()
    assert np.array_equal(seam, border)  # each border pixel once, nothing else
    assert plan.flatten_groups() * 4 >= B * H * W > (plan.flatten_groups() - 1) * 4


@pytest.mark.parametrize("K,C", KC)
@pytest.mark.parametrize("B,H,W", _small(SHAPES))
def test_slots_phases_cover_each_pixel_once(B, H, W, K, C):
    plan = pk.tiled_plan(B, H, W, K, C)
    N = H * W
    chunks = np.zeros(N, np.int32)
    for c in range(plan.nchunks):
        r = plan.chunk_pixels(c)
        chunks[r.start:r.stop] += 1
    assert (chunks == 1).all() and plan.nchunks <= pk.MAX_CHUNKS
    seen = np.zeros((H, W), np.int32)
    for band in range(plan.bands):
        units = plan.band_units(band)
        assert set(units) == set(range(plan.pass_warps))
        for segs in units.values():
            for y, xs, xe in segs:
                assert band * plan.tile_rows <= y < (band + 1) * plan.tile_rows
                seen[y, xs:xe] += 1
    assert (seen == 1).all()
    items = np.zeros(K * (C + 1), np.int32)
    for f in range(plan.fin_blocks):
        r = plan.finish_items(f)
        items[r.start:r.stop] += 1
    assert (items == 1).all()


@pytest.mark.parametrize("K,C", KC)
@pytest.mark.parametrize("B,H,W", SHAPES)
def test_scratch_and_shared_memory_fit(B, H, W, K, C):
    plan = pk.tiled_plan(B, H, W, K, C)
    N = H * W
    # the counts in closed form: chunks, bands and segments span the map
    assert plan.nchunks == -(-N // plan.chunk) and (plan.nchunks - 1) * plan.chunk < N
    assert plan.bands * plan.tile_rows >= H > (plan.bands - 1) * plan.tile_rows
    assert plan.nseg * plan.seg >= W > (plan.nseg - 1) * plan.seg and plan.seg % 32 == 0
    assert 1 <= plan.pass_warps <= min(pk.PASS_WARPS, plan.tile_rows * plan.nseg)
    # the largest index each phase writes, inside its allocation
    shapes = plan.scratch_shapes()
    size = {k: int(np.prod(s)) for k, (s, _) in shapes.items()}
    last_chunk = (B - 1) * plan.nchunks + plan.nchunks - 1
    assert last_chunk < size["counts"]
    assert last_chunk * K + K - 1 < size["lists"]
    last_band = (B - 1) * plan.bands + plan.bands - 1
    assert last_band * K * C + K * C - 1 < size["tpart"]
    assert last_band * K + K - 1 < size["tcnt"]
    if not plan.ext_smem:
        assert last_band * 2 * K * plan.tile_rows + 2 * K * plan.tile_rows - 1 < size["ext"]
    # shared memory: the CCL tile, the pass band, the one-launch kernel's block
    for smem in (plan.ccl_smem, plan.pass_smem, plan.large_smem):
        assert smem <= ccl_kernel.MAX_SHARED_BYTES
    words = plan.K + plan.pass_warps * K * (C + 1) + plan.ext_smem * 2 * K * plan.tile_rows
    assert plan.pass_smem == 4 * (K + max(words - K, 32))
    assert plan.large_smem >= max(plan.ccl_smem, plan.pass_smem, 4 * 2 * pk.FINISH_THREADS)
    assert plan.fin_blocks * 32 >= K * (C + 1) > (plan.fin_blocks - 1) * 32


def test_plan_ints_are_in_the_kernels_order():
    plan = pk.tiled_plan(8, 512, 512, 64, 17)
    ints = plan.ints
    assert ints.dtype == np.int32 and len(ints) == len(pk.PLAN_FIELDS)
    assert [int(v) for v in ints] == [getattr(plan, f) for f in pk.PLAN_FIELDS]
    # struct Plan in csrc/tiled.cuh: the same fields in the same order
    src = (_build.CSRC / "tiled.cuh").read_text()
    body = src[src.index("struct Plan {") + len("struct Plan {"):src.index("};", src.index("struct Plan {"))]
    fields = [f.strip() for line in body.splitlines() if line.strip().startswith("int ")
              for f in line.strip()[4:].rstrip(";").split(",")]
    assert tuple(fields) == pk.PLAN_FIELDS


@pytest.mark.parametrize("K,C", [(64, 17), (1000, 33), (1660, 33), (1661, 33), (3058, 17),
                                 (3059, 17)])
def test_stats_cap_is_the_one_before_the_redesign(K, C):
    """One warp's stats partial set beside the roots: the cap of PR 11's
    ``_tiled_pass_warps``, (MAX_SHARED_BYTES - 4 K) // (4 K (C + 1)) >= 1.
    Past it the wrappers raise NotImplementedError naming ROADMAP §2a and
    shared memory (the stats' only limit left at any channel count); the
    band's extremes go to a device-memory slice where only they no longer
    fit."""
    fits = (ccl_kernel.MAX_SHARED_BYTES - 4 * K) // (4 * K * (C + 1)) >= 1
    if not fits:
        with pytest.raises(NotImplementedError, match="shared memory.*ROADMAP.md §2a"):
            pk.tiled_plan(1, 512, 512, K, C)
        return
    plan = pk.tiled_plan(1, 512, 512, K, C)
    assert plan.pass_smem <= ccl_kernel.MAX_SHARED_BYTES
    assert plan.ext_smem == int(
        4 * (K + plan.pass_warps * K * (C + 1) + 2 * K * plan.tile_rows)
        <= ccl_kernel.MAX_SHARED_BYTES)


class _Lib:
    """A stand-in library: it reads the plan's ints where the wrapper
    launches and records them."""

    def __init__(self):
        self.plans = []

    def tiled_plan_ints(self):
        return len(pk.PLAN_FIELDS)


def _drive(monkeypatch, fn, *args, **kw):
    """Run a wrapper on meta tensors (no card, no data) with the library
    and the launch replaced: returns the plan ints it launched with."""
    lib = _Lib()

    def launch(_lib, name, dev, *a):
        ptr_i = next(i for i, v in enumerate(a[:-1]) if v == len(pk.PLAN_FIELDS)
                     and isinstance(a[i - 1], int) and a[i - 1] > 4096)
        arr = (ctypes.c_int32 * a[ptr_i]).from_address(a[ptr_i - 1])
        lib.plans.append((name, tuple(arr)))

    monkeypatch.setattr(pk, "_PLAN_CHECKED", set())  # the stand-in's check stays here
    monkeypatch.setattr(_build, "load", lambda *a, **k: lib)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(pk, "_check_logits", lambda *a, **k: None)
    monkeypatch.setattr(pk, "_check_slots_inputs", lambda *a, **k: None)
    monkeypatch.setattr(ccl_kernel, "_check", lambda *a, **k: None)
    fn(*args, **kw)
    (name, ints), = lib.plans
    return name, ints


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,K", [(8, 512, 512, 64), (1, 1024, 1024, 64),
                                     (1, 1754, 1240, 64), (2, 300, 1000, 16)])
def test_pair_and_large_compat_launch_one_plan(monkeypatch, B, H, W, K, dtype):
    C = 17
    logits = torch.empty((B, H, W, C), dtype=dtype, device="meta")
    labels = torch.empty((B, H, W), dtype=torch.int32, device="meta")
    counts = (pk.component_slots_tiled.launches, pk.component_slots_tiled.launches_bf16,
              pk.geometry_compat_large.launches, pk.geometry_compat_large.launches_bf16,
              ccl_kernel.ccl_labels_tiled.launches, ccl_kernel.ccl_labels_tiled.launches_bf16)
    try:
        name_s, slots = _drive(monkeypatch, pk.component_slots_tiled, logits, labels, K)
        name_l, large = _drive(monkeypatch, pk.geometry_compat_large, logits, K)
        name_c, ccl = _drive(monkeypatch, ccl_kernel.ccl_labels_tiled, logits[..., 0])
    finally:
        (pk.component_slots_tiled.launches, pk.component_slots_tiled.launches_bf16,
         pk.geometry_compat_large.launches, pk.geometry_compat_large.launches_bf16,
         ccl_kernel.ccl_labels_tiled.launches, ccl_kernel.ccl_labels_tiled.launches_bf16) = counts
    sfx = ccl_kernel.LOGIT_DTYPES[dtype]
    assert (name_s, name_l, name_c) == ("component_slots_tiled" + sfx,
                                       "geometry_compat_large" + sfx, "ccl_labels_tiled" + sfx)
    assert slots == large == tuple(pk.tiled_plan(B, H, W, K, C).ints.tolist())
    # the CCL's geometry takes no K or C: the same tiles as the large K12c's
    f = {name: i for i, name in enumerate(pk.PLAN_FIELDS)}
    for name in ("B", "H", "W", "tile_h", "tile_w", "ccl_threads", "seam_threads"):
        assert ccl[f[name]] == large[f[name]], name


@pytest.mark.parametrize("C", [41, 65])
@pytest.mark.parametrize("K", [16, 64])
def test_plan_at_channel_counts_past_the_register_chunk(K, C):
    """Past the stats' register chunk (geometry.cuh kWideChannels) the plan
    is the same function of K (C + 1): one partial set a warp beside the
    roots, the finish's blocks over every (slot, channel) sum and count, the
    bands' partials in the scratch; the kernels make one pixel pass a chunk
    of REGISTER_CHANNELS - 1 classes; K12c's cluster route is chosen by its
    shared memory at this C."""
    plan = pk.tiled_plan(2, 512, 512, K, C)
    assert plan.C == C and plan.fin_blocks == -(-K * (C + 1) // 32)
    items = [i for f in range(plan.fin_blocks) for i in plan.finish_items(f)]
    assert items == list(range(K * (C + 1)))
    assert plan.pass_smem <= ccl_kernel.MAX_SHARED_BYTES
    assert plan.pass_smem >= 4 * (K + plan.pass_warps * K * (C + 1))
    assert plan.scratch_shapes()["tpart"][0] == (2, plan.bands, K, C)
    assert pk.class_chunks(C) == -(-(C - 1) // (pk.REGISTER_CHANNELS - 1))
    words = pk.geometry_smem_words(128, 128, K) + pk.stats_warps(128, 128, K, C) * K * (C + 1)
    assert pk.geometry_compat_fits(128, 128, K, C) == (4 * words <= ccl_kernel.MAX_SHARED_BYTES)

"""PyTorch port: the launch plans of the width kernels, on the CPU.

The card's K4 runs its compiled widths (8, 16, 24, 32 channels, heads of up
to 32 outputs) as the exact instance, P pixels a thread d rows apart, and
takes every other C up to 32 (and every head past 32 outputs) as its
register kernel compiled for that C ("narrow"),
and the stats keep up to 65 logit channels of a pixel in registers in one
pixel pass.  Their kernels run only on the card; these tests hold, at the
ends of each range, what the wrappers decide on the host:

  * K4's instance and its block's shared memory at the compiled widths and
    off them, and a head at the edge of one block's shared memory, past
    which the per-pixel columns take it;
  * the exact instance's launch geometry (``exact_plan``), walked in numpy
    as the kernel indexes it, and the plan the wrapper passes to it;
  * the stats' instance (``stats_channel_bound``), virtual-warp count
    (``stats_warps``, which fixes the order of the sums), their class
    passes and the route (the cluster K2 / K12c or the tiled kernels) at
    the logit counts that end each compiled bound;
  * ``postprocess_batch_fused`` at 5 and 25 logits (the guarded bounds of
    5 and 25 on the card) and 97 (three class passes on the card)
    against the JAX package in interpret mode, unpacked and phase-major:
    labels, valid, areas and classes identical, scores within 1e-6, boxes
    within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ccl import blob_logits
from test_torch_postproc import assert_same_detections

from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops.postproc import postprocess_batch_fused as jax_postprocess_batch_fused
from ubdvss_tpu_torch import NetConfig
from ubdvss_tpu_torch.ops.cuda import context_kernel as ck
from ubdvss_tpu_torch.ops.cuda import postproc_kernel as pk
from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused

torch.set_num_threads(1)


@pytest.mark.parametrize("C, O, inst, smem", [
    (1, 1, "narrow", 52), (1, 41, "narrow", 372), (8, 32, "exact", 0), (8, 33, "narrow", 1764),
    (10, 17, "narrow", 1548), (16, 1, "exact", 0), (24, 33, "narrow", 6564),
    (31, 17, "narrow", 7260), (32, 32, "exact", 0), (32, 41, "narrow", 10788),
])
def test_k4_instance_and_shared_memory_up_to_32_channels(C, O, inst, smem):
    """K4 at C <= 32: the exact instance at its compiled widths with heads
    of up to 32 outputs, its weights static (the head layer's block, the
    largest, within the 48 KiB a block's static shared memory may hold),
    128 threads a block at every plan; at every other (C, O) the register
    kernel compiled for C ("narrow"), 256 threads a block, its taps,
    pointwise weights, biases and head (O (C + 1) floats) in dynamic
    shared memory."""
    assert ck.kernel_instance(C, O) == inst
    assert ck.kernel_smem(C, O) == (128 if inst == "exact" else 256, smem)
    if inst == "exact":
        assert ck.exact_smem(C) == 4 * (9 * C + C * C + C + 32 * (C + 1))
        assert ck.exact_smem(C) <= ck.STATIC_SHARED_LIMIT
        plan = ck.exact_plan(128, 128, 1)
        assert plan.threads == ck.kernel_smem(C, O)[0] == ck.EXACT_THREADS == 128
        assert plan.pixels == ck.EXACT_PIXELS == 2
        assert plan.blocks * plan.threads >= plan.rows * 128 > (plan.blocks - 1) * plan.threads


def test_k4_every_width_up_to_32_channels_fits_one_block():
    """Every C in 1..32 with heads of 1, 17, 33 and 41 outputs runs the
    exact instance (128 threads a block) or the register kernel compiled
    for C ("narrow", 256), within one block's 232,448 B."""
    for C in range(1, 33):
        for O in (1, 17, 33, 41):
            inst = ck.kernel_instance(C, O)
            exact = C in ck.EXACT_CHANNELS and O <= ck.EXACT_HEAD_OUTPUTS
            assert inst == ("exact" if exact else "narrow"), (C, O)
            threads, smem = ck.kernel_smem(C, O)
            assert threads == (128 if exact else 256), (C, O)
            assert smem <= ck.SHARED_MEMORY_LIMIT == 232_448, (C, O)


@pytest.mark.parametrize("C, O", [(1, 29050), (10, 5264), (32, 1720)])
def test_k4_narrow_head_past_shared_memory_takes_the_columns(C, O):
    """The largest head whose weights fit one narrow block beside the
    layer's runs narrow, within 232,448 B; one output more takes the
    per-pixel columns, as past 128 channels."""
    assert ck.kernel_instance(C, O) == "narrow"
    assert ck.SHARED_MEMORY_LIMIT - 4 * (C + 1) < ck.kernel_smem(C, O)[1] <= ck.SHARED_MEMORY_LIMIT
    assert ck.kernel_instance(C, O + 1) == "wide_columns"
    threads, smem = ck.kernel_smem(C, O + 1)
    assert threads in ck.COLUMN_THREADS and smem == 4 * 2 * C * threads


def _exact_walk(B, H, W, d):
    """The exact instance's launch of one layer walked in numpy as the
    kernel indexes it: each thread's batch, column and first row from its
    index, its pixels P rows d apart.  Returns the plan, the hits of every
    pixel of the B maps, and the number of distinct tap rows of each active
    thread with the number of its pixels on the map."""
    plan = ck.exact_plan(H, W, d)
    P, rows = plan.pixels, plan.rows
    b, q = np.divmod(np.arange(B * plan.blocks * plan.threads, dtype=np.int64),
                     plan.blocks * plan.threads)  # grid.y the batch
    b, q = b[q < rows * W], q[q < rows * W]
    t = q // W
    x = q - t * W
    y0 = ck.exact_first_row(t, d, P)
    assert (y0 < H).all() and (y0 >= 0).all(), "a row of threads with no pixel on the map"
    ys = y0[:, None] + d * np.arange(P)[None, :]  # (threads, P)
    on = ys < H
    hits = np.zeros((B, H, W), np.int64)
    np.add.at(hits, (np.broadcast_to(b[:, None], ys.shape)[on], ys[on],
                     np.broadcast_to(x[:, None], ys.shape)[on]), 1)
    # the tap rows of each thread's pixels on the map: y + ty d, ty = -1, 0, 1
    taps = ys[:, :, None] + d * np.arange(-1, 2)[None, None, :]
    taps = np.where(on[:, :, None], taps, -(1 << 40))
    flat = np.sort(taps.reshape(len(q), -1), axis=1)
    distinct = 1 + (np.diff(flat, axis=1) != 0).sum(1) - (~on).any(1)
    return plan, hits, distinct, on.sum(1)


@pytest.mark.parametrize("C", [8, 16, 24, 32])
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("H, W", [(37, 53), (60, 80), (128, 128), (512, 512), (2, 1)])
def test_k4_exact_plan_computes_every_pixel_once(H, W, d, C):
    """The exact instance's launch geometry (``exact_plan``, the numbers the
    wrapper passes to ``context_exact_kernel``, the same at each of its
    widths and at the head layer) walked in numpy: every pixel of every map
    computed by exactly one thread, every row of threads with its first
    pixel on the map, and each thread's pixels d rows apart in one column,
    so that its n pixels on the map share their tap rows: n + 2 of them,
    not 3 n.  P is the instance's, halved only where the map is too short
    for the thread's last pixel ((P - 1) d >= H)."""
    assert ck.kernel_instance(C, 17) == ck.kernel_instance(C, 32) == "exact"
    plan, hits, distinct, n_on = _exact_walk(2, H, W, d)
    assert (hits == 1).all(), f"{int((hits != 1).sum())} pixels not computed exactly once"
    assert (distinct == n_on + 2).all()
    assert ck.exact_thread_rows(H, d, plan.pixels) == plan.rows
    assert plan.pixels in (1, 2)
    assert plan.pixels == 1 or (plan.pixels - 1) * d < H
    assert plan.pixels == ck.EXACT_PIXELS or (2 * plan.pixels - 1) * d >= H


def test_k4_launch_passes_the_exact_plan(monkeypatch):
    """``fused_context_head`` on the card's path (meta tensors, the library
    and the launch intercepted) passes each layer's ``exact_plan`` (P, rows
    of threads, threads a block) at the asset's width and dilations, the
    head fused into the last layer, and zeros to an instance that takes no
    plan."""
    from ubdvss_tpu_torch.ops.cuda import _build

    calls = []
    monkeypatch.setattr(_build, "load", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda _lib, name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "check_input", lambda *a, **k: None)
    launches = ck.fused_context_head.launches, ck.fused_context_head.launches_packed
    dil = (1, 1, 2, 4, 8, 16, 1)
    try:
        for C, O, H, W in ((24, 17, 128, 128), (24, 17, 60, 80), (8, 32, 37, 53), (10, 17, 64, 64)):
            L = len(dil)
            w = [torch.empty(shape, device="meta") for shape in (
                (L, 9, C, 1, 1), (L, C, C), (L, C, 1, 1), (O, C), (O, 1, 1))]
            calls.clear()
            ck._launch_context_head(torch.empty((4, C, H, W), device="meta"), *w, dil, False)
            assert [name for name, _ in calls] == ["context_layer"] * L
            exact = ck.kernel_instance(C, O) == "exact"
            for li, (_, a) in enumerate(calls):
                assert a[7:14] == (4, C, H, W, dil[li], O, 0)
                last = li == L - 1
                assert (a[5] is None) == (a[6] is None) == (not last)
                plan = ck.exact_plan(H, W, dil[li]) if exact else None
                assert a[14:] == ((plan.pixels, plan.rows, plan.threads) if exact else (0, 0, 0))
    finally:
        ck.fused_context_head.launches, ck.fused_context_head.launches_packed = launches


_SHAPES = [(60, 80, 16), (64, 48, 64), (37, 53, 8), (200, 160, 16), (512, 512, 16)]


# the channel count the stats kernels are compiled for at C logit channels
_BOUND = {1: 1, 2: 5, 5: 5, 16: 16, 17: 17, 18: 25, 25: 25, 33: 33, 34: 41, 41: 41, 42: 65,
          65: 65, 66: 66, 81: 66, 82: 66, 97: 66, 121: 66, 122: 66}


@pytest.mark.parametrize("C, warps, passes", [
    (1, 32, 1), (17, 32, 1), (33, 32, 1), (34, 32, 1), (41, 32, 1), (42, 32, 1), (65, 32, 1),
    (66, 32, 2), (81, 32, 2), (82, 32, 3), (97, 29, 3), (121, 23, 3), (122, 23, 4),
    (2, 32, 1), (5, 32, 1), (16, 32, 1), (18, 32, 1), (25, 32, 1),
])
def test_stats_launch_keeps_the_virtual_warps(C, warps, passes):
    """The stats at the logit counts that end each compiled bound (5, 16,
    25, 33, 41, 65 and the exact 1 and 17; 40 classes a pass past 65): the
    instance ``stats_channel_bound`` names; at the main path's 128² maps
    and K=16, ``stats_warps`` virtual warps a block (the same at every
    bound, so the sums keep their order) and one or more class passes; at
    other shapes, between 1 and 32 virtual warps, and either the cluster
    K2 / K12c fits one block with one partial set a virtual warp or the
    tiled kernels plan the shape."""
    assert pk.stats_channel_bound(C) == _BOUND[C]
    assert pk.stats_warps(128, 128, 16, C) == warps
    assert pk.class_chunks(C) == passes
    assert pk.geometry_compat_fits(128, 128, 16, C)
    for H, W, K in _SHAPES:
        sets = pk.stats_warps(H, W, K, C)
        assert 1 <= sets <= 32
        if pk.geometry_compat_fits(H, W, K, C):
            assert (pk.geometry_smem_words(H, W, K) + sets * K * (C + 1)) * 4 <= pk.MAX_SHARED_BYTES
        else:
            assert pk.tiled_plan(2, H, W, K, C).ints.size > 0


def _fused_against_jax(O, packed):
    """postprocess_batch_fused on O-channel blob logits == JAX's in
    interpret mode, unpacked or phase-major."""
    rng = np.random.default_rng(O)
    det = blob_logits(O, B=3, n_blobs=6)
    logits = rng.normal(0, 2, det.shape + (O,)).astype(np.float32)
    logits[..., 0] = det
    kw = dict(class_names=tuple(f"sym{i}" for i in range(O - 1)), max_components=8,
              min_component_area=3, max_hull_points=8)
    cfg, jcfg = NetConfig(**kw), JaxNetConfig(**kw)
    phases = (2, 2) if packed else None
    if packed:
        B, H, W, C = logits.shape
        logits = np.ascontiguousarray(logits.reshape(B, H // 2, 2, W // 2, 2, C)
                                      .transpose(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C))
    ref = jax.device_get(jax_postprocess_batch_fused(jnp.asarray(logits), jcfg, interpret=True,
                                                     packed_phases=phases))
    out = postprocess_batch_fused(torch.from_numpy(logits), cfg, packed_phases=phases)
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_same_detections(out, ref)


@pytest.mark.parametrize("packed", [False, True])
def test_postprocess_fused_at_97_logits(packed):
    """postprocess_batch_fused on 97-channel blob logits (three class
    passes of the card's stats) == JAX's in interpret mode, unpacked and
    phase-major."""
    _fused_against_jax(97, packed)
    assert pk.class_chunks(97) == 3


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("O, bound", [(5, 5), (25, 25)])
def test_postprocess_fused_at_guarded_bounds(O, bound, packed):
    """postprocess_batch_fused on blob logits of 5 channels (4 classes: the
    guarded bound of 5 on the card) and 25 (24 classes: the bound of 25,
    its warps running two virtual warps each) == JAX's in interpret mode,
    unpacked and phase-major."""
    _fused_against_jax(O, packed)
    assert pk.stats_channel_bound(O) == bound and pk.class_chunks(O) == 1

"""PyTorch port: the launch plan of the cluster K2 and K12c
(``ops/cuda/postproc_kernel.slot_plan``, csrc/geometry.cuh ``SlotPlan``) on
the CPU: the blocks an image, the virtual warps each block runs and the
order of the stats' sums, a numpy walk of the kernels' root ranking by
bands and their pixel pass's runs, one plan for both wrappers (driven on
meta tensors, the launch intercepted), and the plain versions at the batch
sizes the plan spreads wide held against the JAX package's kernels in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ccl import blob_logits

from ubdvss_tpu.ops.pallas import postproc_kernel as jax_postproc_kernel
from ubdvss_tpu_torch.ops.cuda import _build
from ubdvss_tpu_torch.ops.cuda import ccl_kernel
from ubdvss_tpu_torch.ops.cuda import postproc_kernel as pk

torch.set_num_threads(1)

# (H, W, K, C) the plan serves: the main path's and the stream's maps, the
# detect heatmaps, the packed route's 256² maps, a narrow and a wide label set
_SHAPES = [(128, 128, 16, 17), (60, 80, 16, 17), (120, 160, 64, 17), (192, 256, 64, 17),
           (256, 256, 16, 17), (64, 48, 8, 5), (37, 53, 16, 41), (1, 40, 4, 1)]
# clusters of 16, 8 and 4 blocks a card of 132 SMs may run at once
_ROOMS = [None, {16: 7, 8: 16, 4: 33}, {16: 0, 8: 15, 4: 30}, {16: 8, 8: 0, 4: 0}]


@pytest.mark.parametrize("H,W", [(128, 128), (60, 80)])
@pytest.mark.parametrize("room", _ROOMS)
def test_main_path_and_stream_keep_the_two_block_plan(H, W, room):
    """B=64 on the main path's 128² and the stream's 60x80 maps: two blocks
    an image, ``stats_warps`` virtual warps a block, one running sum over
    all of them, as the two-block kernels summed before the plan."""
    plan = pk.slot_plan(64, H, W, 16, 17, 132, room)
    sets = pk.stats_warps(H, W, 16, 17)
    assert plan == pk.SlotPlan(2, sets)
    assert plan.ints == (32 * sets, 2)
    assert plan.sum_order() == [list(range(2 * sets))]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("room", _ROOMS)
@pytest.mark.parametrize("H,W,K,C", _SHAPES)
def test_blocks_stay_within_the_card(H, W, K, C, room, sms):
    """For every batch size: a cluster past two blocks holds every image's
    blocks on the card at once (blocks x B <= SMs, B <= its room), and it is
    the largest that does; the blocks' virtual warps are ``stats_warps``
    whatever B is."""
    sets = pk.stats_warps(H, W, K, C)
    for B in range(1, 140):
        plan = pk.slot_plan(B, H, W, K, C, sms, room)
        assert plan.sets == sets
        fits = [g for g in pk.SLOT_BLOCKS
                if g * B <= sms and (room is None or B <= room.get(g, 0))]
        if plan.blocks > 2:
            assert plan.blocks * B <= sms
            assert room is None or B <= room[plan.blocks]
            assert plan.blocks == max(fits)
        else:
            assert not fits
        if B >= 34 and sms == 132:
            assert plan.blocks == 2


@pytest.mark.parametrize("blocks", [2, 4, 8, 16])
@pytest.mark.parametrize("sets", [1, 7, 32])
def test_virtual_warps_and_the_order_of_the_sums(blocks, sets):
    """Every virtual warp belongs to exactly one block, block r's the r-th
    run of ``sets``; the order of the sums visits the virtual warps in
    order, once each, in one group on two blocks and in groups of a block's
    sets on a wider cluster; and the kernels' finish (a numpy copy of the
    loops of slot_finish on two blocks and of band_finish on more, f32)
    gives the running sums of the groups' running sums in that order."""
    plan = pk.SlotPlan(blocks, sets)
    grouped = blocks > 2
    owner = np.full(plan.virtual_warps, -1)
    for r in range(blocks):
        for v in plan.block_warps(r):
            assert owner[v] == -1
            owner[v] = r
    assert (owner >= 0).all()
    order = plan.sum_order()
    assert [v for g in order for v in g] == list(range(plan.virtual_warps))
    if grouped:
        assert order == [list(plan.block_warps(r)) for r in range(blocks)]
    parts = np.random.default_rng(blocks * sets).random((blocks, sets), dtype=np.float32) * 1e3
    parts = parts.astype(np.float32)  # one stat's partial sets, block by block
    # band_finish (a wider cluster): each block first sums its sets into set
    # 0, then each item adds set 0 of every block in block order;
    # slot_finish (two blocks): every set of each block in block order
    part = parts.copy()
    if grouped:
        for r in range(blocks):
            v = part[r, 0]
            for w in range(1, sets):
                v = np.float32(v + part[r, w])
            part[r, 0] = v
    per = 1 if grouped else sets
    got = np.float32(0)
    for r in range(blocks):
        for w in range(per):
            got = np.float32(got + part[r, w])
    want = np.float32(0)
    for g in order:
        t = np.float32(0)
        for v in g:
            t = np.float32(t + parts[v // sets, v % sets])
        want = np.float32(want + t)
    assert got == want


def _walk_roots(labels: np.ndarray, det: np.ndarray, K: int, blocks: int):
    """numpy copy of slot_rank and join_roots: each block ranks the roots
    of its band of rows (ceil(H / blocks) rows) in raster order, a
    block-wide tile of 1024 pixels at a time; the image's K smallest are
    the blocks' lists in block order."""
    H, W = labels.shape
    N = H * W
    span = -(-H // blocks) * W
    lab, d = labels.reshape(-1), det.reshape(-1)
    lists, counts = [], []
    for r in range(blocks):
        p0 = min(r * span, N)
        p1 = min(p0 + span, N)
        ranked, base = [], 0
        for t in range(p0, p1, 1024):
            p = np.arange(t, min(t + 1024, p1))
            root = (lab[p] == p) & (d[p] > 0)
            for q in p[root]:
                if base < K:
                    ranked.append(int(q))
                base += 1
        lists.append(ranked)
        counts.append(base)
    first = np.concatenate([[0], np.cumsum(counts)])
    roots = []
    for k in range(K):
        if k >= first[-1]:
            roots.append(N)
            continue
        r = int(np.searchsorted(first, k, side="right") - 1)
        roots.append(lists[r][k - first[r]])
    return np.array(roots), int(first[-1])


@pytest.mark.parametrize("blocks", [2, 4, 8, 16])
@pytest.mark.parametrize("K", [1, 4, 16, 64])
@pytest.mark.parametrize("H,W", [(120, 160), (64, 48), (5, 40), (1, 40), (33, 17)])
def test_band_ranking_gives_the_k_smallest_roots(H, W, K, blocks):
    """The roots ranked by bands and joined in block order are the plain
    version's rootvals and root count at every cluster size, bands with no
    row included (fewer rows than blocks)."""
    det = blob_logits(H * W + K, B=1, n_blobs=12, H=H, W=W)[0] if H >= 16 else (
        np.random.default_rng(K).normal(0, 1, (H, W)).astype(np.float32))
    t = torch.from_numpy(det[None])
    labels = ccl_kernel.ccl_labels_reference(t)
    ref = pk.component_slots_reference(t, labels, K)
    roots, total = _walk_roots(labels[0].numpy(), det, K, blocks)
    np.testing.assert_array_equal(roots, ref["rootvals"][0].numpy())
    assert total == int(ref["num_components_total"][0])


@pytest.mark.parametrize("H,W,K,C", _SHAPES)
@pytest.mark.parametrize("B", [1, 2, 4, 8, 64])
def test_pixel_pass_runs_cover_the_map_once(H, W, K, C, B):
    """The pixel pass's (32-column strip, row) runs, strip-major, cut into
    one run of ceil(runs / virtual warps) a virtual warp: every pixel of the
    map lies in exactly one virtual warp's runs, and so in one block's."""
    plan = pk.slot_plan(B, H, W, K, C)
    nv = plan.virtual_warps
    runs = -(-W // 32) * H
    per_v = -(-runs // nv)
    seen = np.zeros((H, W), np.int64)
    for r in range(plan.blocks):
        for v in plan.block_warps(r):
            for run in range(min(v * per_v, runs), min(v * per_v + per_v, runs)):
                y, x0 = run % H, run // H * 32
                seen[y, x0:min(x0 + 32, W)] += 1
    assert (seen == 1).all()


def _intercept(monkeypatch):
    """The wrappers on meta tensors: the library, the input checks and the
    launch replaced, the card's plan taken from slot_plan on 132 SMs with
    room for every cluster; returns the launches' (entry, ints after the
    sizes) and the plans asked for."""
    calls, plans = [], []
    monkeypatch.setattr(_build, "load", lambda *a, **k: None)
    monkeypatch.setattr(_build, "launch", lambda _lib, name, dev, *a: calls.append((name, a)))
    monkeypatch.setattr(_build, "check_input", lambda *a, **k: None)
    monkeypatch.setattr(pk, "_check_logits", lambda *a, **k: None)
    monkeypatch.setattr(pk, "_check_slots_inputs", lambda *a, **k: None)

    def launch_plan(logits, H, W, K, C):
        plans.append(pk.slot_plan(logits.shape[0], H, W, K, C, 132, {16: 7, 8: 16, 4: 33}))
        return plans[-1]

    monkeypatch.setattr(pk, "launch_plan", launch_plan)
    return calls, plans


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W", [(1, 128, 128), (1, 192, 256), (4, 256, 256), (8, 256, 256),
                                   (17, 128, 128), (64, 128, 128), (64, 60, 80)])
def test_k2_and_k12c_take_one_plan(monkeypatch, B, H, W, dtype, packed):
    """component_slots and geometry_compat on the card's path launch their
    cluster kernels with the same plan ints, (threads, blocks),
    right after the sizes (B, H, W, K), the threshold after them."""
    calls, plans = _intercept(monkeypatch)
    K, C = 16, 17
    phases = (2, 2) if packed else None
    shape = (B, H // 2, W // 2, 4 * C) if packed else (B, H, W, C)
    lg = torch.empty(shape, dtype=dtype, device="meta")
    lab = torch.empty((B, H, W), dtype=torch.int32, device="meta")
    counts = {f: (f.launches, f.launches_bf16, f.launches_packed)
              for f in (pk.component_slots, pk.geometry_compat)}
    try:
        pk.component_slots(lg, lab, K, packed_phases=phases)
        pk.geometry_compat(lg, K, packed_phases=phases)
    finally:
        for f, (a, b, c) in counts.items():
            f.launches, f.launches_bf16, f.launches_packed = a, b, c
    sfx = ("_packed" if packed else "") + ("_bf16" if dtype == torch.bfloat16 else "")
    assert [name for name, _ in calls] == ["component_slots" + sfx, "geometry_compat" + sfx]
    assert plans[0] == plans[1] == pk.slot_plan(B, H, W, K, C, 132, {16: 7, 8: 16, 4: 33})
    n_strides = 6 if packed else 4
    k2 = calls[0][1][1 + n_strides + 1 + 1 + 8:]  # logits, strides, C, labels, outputs
    k12 = calls[1][1][1 + n_strides + 1 + 8:]  # logits, strides, C, outputs
    assert k2[:4] == k12[:4] == (B, H, W, K)
    assert k2[4:6] == k12[4:6] == plans[0].ints
    assert isinstance(k2[6], float) and k2[6] == k12[6]


def test_plan_leaves_the_routes_alone():
    """The plan changes no route: the blocks' virtual warps are
    ``stats_warps`` and the cluster kernels run where
    ``geometry_compat_fits`` says, both functions of (H, W, K, C) alone."""
    for H, W, K, C in _SHAPES:
        sets = pk.stats_warps(H, W, K, C)
        words = pk.geometry_smem_words(H, W, K) + sets * K * (C + 1)
        assert pk.geometry_compat_fits(H, W, K, C) == (4 * words <= pk.MAX_SHARED_BYTES)
        assert {pk.slot_plan(B, H, W, K, C).sets for B in (1, 4, 64, 200)} == {sets}


def _jax_slots(lg: np.ndarray, K: int, compat: bool, monkeypatch):
    monkeypatch.setattr(jax_postproc_kernel, "_COMPAT", compat)
    return jax.device_get(jax_postproc_kernel.component_slots_from_logits.__wrapped__(
        jnp.asarray(lg), K, interpret=True))


@pytest.mark.parametrize("compat", [False, True])
def test_plain_slots_match_jax_on_one_detect_heatmap(monkeypatch, compat):
    """One 640x480 detect call's 120x160 heatmap (B=1, where the plan takes
    the widest cluster): the plain K2 after the plain CCL, and the plain
    K12c, against the JAX package's _roots_slots_extremes and
    _geometry_kernel_compat in interpret mode, all five outputs identical."""
    det = blob_logits(120, B=1, n_blobs=10, H=120, W=160)
    ref = _jax_slots(det, 16, compat, monkeypatch)
    t = torch.from_numpy(det)
    if compat:
        out = pk.geometry_compat_reference(t, 16)
    else:
        out = pk.component_slots_reference(t, ccl_kernel.ccl_labels_reference(t), 16)
    for key in pk._GEO_KEYS:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_plain_stats_match_jax_on_four_packed_maps():
    """Four 64² maps of phase-major packed logits (B=4, the packed route's
    1024² call in small): the plain stats against the JAX package's
    component_stats_from_logits(packed_phases=(2, 2)) in interpret mode:
    geometry and areas identical, the means within 2e-6."""
    det = blob_logits(64, B=4, n_blobs=6, H=64, W=64)
    lg = np.random.default_rng(4).normal(0, 2, det.shape + (17,)).astype(np.float32)
    lg[..., 0] = det
    packed = lg.reshape(4, 32, 2, 32, 2, 17).transpose(0, 1, 3, 2, 4, 5).reshape(4, 32, 32, 68)
    ref = jax.device_get(jax_postproc_kernel.component_stats_from_logits(
        jnp.asarray(packed), 16, interpret=True, packed_phases=(2, 2)))
    out = pk.component_stats_from_logits(torch.from_numpy(packed), 16, packed_phases=(2, 2))
    for key in ("rootvals", "areas", "minx", "maxx", "labels", "num_components_total"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    area = np.maximum(np.asarray(ref["areas"]), 1)
    np.testing.assert_allclose(out["det_sums"].numpy() / area, np.asarray(ref["det_sums"]) / area,
                               atol=2e-6, rtol=0)
    np.testing.assert_allclose(out["cls_sums"].numpy() / area[..., None],
                               np.asarray(ref["cls_sums"]) / area[..., None], atol=2e-6, rtol=0)
    assert int(np.asarray(ref["num_components_total"]).min()) > 0

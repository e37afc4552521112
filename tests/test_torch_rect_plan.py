"""PyTorch port: the tall rect instance's plan (``ops/cuda/rect_kernel.py``
``tall_plan``) and a numpy walk of its hull steps, on the CPU.

The tall instance (``csrc/rect_kernel.cu``, ``rect_cluster_kernel``) takes
one component a cluster of eight blocks; every array size and offset comes
from ``tall_layout``, of which ``tall_plan`` is the copy.  Held here:

  * the blocks' compacted rows cover every height, in 32-row segments; the
    arrays' offsets are 16-byte aligned and fit one block's shared memory
    where the plan keeps them there, and the workspace takes over past it;
  * the merge levels: every segment group of a level is merged by exactly
    one block (the holder of its first segment, or block 0 where it
    finishes a component of at most ``solo_rows`` rows alone), and a level
    the plan calls "block" keeps each group inside one block;
  * a numpy walk of the kernel's hull steps — each 32-row segment's strict
    hull vertices by the slope rule, the pairwise merges with the 32-way
    bridge search and binary-searched tangents, the membership test on the
    merged hull — keeps exactly the rows the plain version's lockstep rounds
    keep (``rect_kernel._convexify``), on staircases, convex chains whose
    every row is a hull point, circles, noise with gaps, zig-zags and bars;
    and its directions (consecutive kept points, one equal to the one before
    it dropped) are the plain version's edges with those repeats dropped;
  * the kernel's route — every row of a chain with no row concave in the
    lockstep's first round, the merge walk for the others — keeps the plain
    version's rows too.
"""

import numpy as np
import pytest
import torch

from ubdvss_tpu_torch.ops.cuda import rect_kernel as rk

SEG = rk.TALL_SEGMENT
HEIGHTS = (1995, 2048, 4096, 8192, 16_384, 17_000, 20_000, 100_000)


@pytest.mark.parametrize("H", HEIGHTS)
def test_tall_plan_covers_the_rows_and_fits(H):
    p = rk.tall_plan(H)
    assert p.hb >= SEG and p.hb & (p.hb - 1) == 0 and p.db == 2 * p.hb
    assert p.cluster * p.hb >= H and (p.hb == SEG or p.cluster * p.hb // 2 < H)
    offs = [p.off_hull, p.off_dirs, p.off_cnt, p.off_kept, p.off_scal, p.block_bytes]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    assert p.off_hull == 16 * p.hb and p.off_dirs - p.off_hull == 2 * 8 * p.hb
    assert p.off_cnt - p.off_dirs == 8 * 4 * p.db  # 2n - 2 < 2 H directions at most
    assert p.off_kept - p.off_cnt >= 2 * 4 * p.segments and p.off_scal - p.off_kept >= p.hb
    fixed = rk.TALL_CHUNK * (16 + 8)
    if p.in_shared:
        assert p.smem == fixed + p.block_bytes and p.workspace_bytes == 0
        assert p.smem + p.static_smem <= rk.MAX_SHARED_BYTES
    else:
        assert p.smem == fixed and p.workspace_bytes == p.cluster * p.block_bytes
        assert p.block_bytes + fixed + p.static_smem > rk.MAX_SHARED_BYTES
    assert rk.tall_slot_bytes(H) == p.workspace_bytes


def test_tall_plan_keeps_shared_memory_up_to_its_cap():
    """The arrays stay in the cluster's shared memory (97 B a row, a block's
    rows a power of two) up to 16,384 rows; every taller map takes the
    workspace."""
    cap = max(h for h in range(rk.MAX_EXACT_HEIGHT + 1, 40_000) if rk.tall_plan(h).in_shared)
    assert cap == 16_384
    assert all(not rk.tall_plan(h).in_shared for h in range(cap + 1, cap + 2000, 7))
    assert all(rk.tall_plan(h).in_shared for h in range(rk.MAX_EXACT_HEIGHT + 1, cap + 1, 97))


@pytest.mark.parametrize("H", HEIGHTS)
def test_merge_levels_cover_the_groups_once(H):
    """Every group of every level for n valid rows is merged once: by the
    block holding its first segment ("block" and "cluster" levels; a
    "block" level keeps each group inside that block, so a block barrier
    orders it) or by block 0 alone ("alone": a solo component's levels
    past the block-local ones, which stay "block"); a solo component never
    waits at a cluster level."""
    p = rk.tall_plan(H)
    hs = p.segments
    for n in sorted({1, 31, 33, 257, p.solo_rows, p.solo_rows + 1, H // 3, H - 1, H}):
        nseg = -(-n // SEG)
        levels = p.levels(n)
        assert 2 ** len(levels) >= nseg and (not levels or 2 ** (len(levels) - 1) < nseg)
        assert not (p.solo(n) and "cluster" in levels)
        assert levels == sorted(levels, key=("block", "cluster", "alone").index)
        for lv, how in enumerate(levels):
            gsz = 2 << lv
            owners = {}
            for r in range(1 if how == "alone" else p.cluster):
                s_lo = 0 if how == "alone" else r * hs
                g_lo = -(-s_lo // gsz)
                g_hi = -(-nseg // gsz) if how == "alone" else min(-(-(s_lo + hs) // gsz),
                                                                  -(-nseg // gsz))
                for g in range(g_lo, g_hi):
                    assert g not in owners
                    owners[g] = r
            assert sorted(owners) == list(range(-(-nseg // gsz)))
            if how == "block":
                for g, r in owners.items():
                    last = min(nseg, (g + 1) * gsz) - 1
                    assert last // hs == r == (g * gsz) // hs


# --- a numpy walk of the kernel's hull steps ----------------------------------


def _steeper(n0, d0, n1, d1):
    return n0 * d1 > n1 * d0


def _strict_vertices(pts, S):
    """strict_vertex over at most 32 points (y rising): the slope rule,
    sentinels -S, S."""
    assert len(pts) <= SEG
    out = []
    for i, (x, y) in enumerate(pts):
        en, ed, fn, fd = -S, 1, S, 1
        for k, (xk, yk) in enumerate(pts):
            if k < i and _steeper(x - xk, y - yk, en, ed):
                en, ed = x - xk, y - yk
            elif k > i and _steeper(fn, fd, xk - x, yk - y):
                fn, fd = xk - x, yk - y
        if _steeper(fn, fd, en, ed):
            out.append((x, y))
    return out


def _segment_vertices(xs, ys, s0, n, S):
    """One warp's level-0 step: the strict hull vertices of positions
    [s0, s0 + 32)."""
    return _strict_vertices([(xs[i], ys[i]) for i in range(s0, min(s0 + SEG, n))], S)


def _tangent(A, bx, by):
    lo, hi = 0, len(A) - 1
    while lo < hi:
        mid = (lo + hi) >> 1
        (ax, ay), (cx, cy) = A[mid], A[mid + 1]
        if (cx - ax) * (by - ay) >= (bx - ax) * (cy - ay):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _merge(A, B):
    """merge_hulls: the bridge by the warp's 32-way search, B behind A."""
    if not B:
        return A
    if not A:
        return B

    def past(j):
        (bx, by), (nx, ny) = B[j], B[j + 1]
        ax, ay = A[_tangent(A, bx, by)]
        return (nx - bx) * (by - ay) > (bx - ax) * (ny - by)

    lo, hi = 0, len(B) - 1
    while lo < hi:
        step = (hi - lo + 31) >> 5
        hits = [k for k in range(32) if lo + k * step < hi and past(lo + k * step)]
        if hits:
            k0 = hits[0]
            lo, hi = (lo + (k0 - 1) * step + 1 if k0 else lo), lo + k0 * step
        else:
            lo += (hi - 1 - lo) // step * step + 1
    i = _tangent(A, *B[lo])
    return A[: i + 1] + B[lo:]


def _walk_kept(xs, ys, S, plan):
    """The kernel's steps B and C on one chain (x already negated for the
    right chain): segment hulls, the plan's merge levels, membership."""
    n = len(xs)
    nseg = -(-n // SEG)
    groups = {s: _segment_vertices(xs, ys, s * SEG, n, S) for s in range(nseg)}
    for lv, _ in enumerate(plan.levels(n)):
        gsz = 2 << lv
        for sA in range(0, nseg, gsz):
            sB = sA + gsz // 2
            if sB < nseg:
                groups[sA] = _merge(groups[sA], groups.pop(sB))
    V = groups[0]
    vy = np.array([v[1] for v in V])
    kept = np.zeros(n, bool)
    for p, (x, y) in enumerate(zip(xs, ys)):
        k = int(np.searchsorted(vy, y, side="right")) - 1
        (vx, v_y) = V[k]
        if v_y == y:
            kept[p] = True
        else:
            wx, wy = V[k + 1]
            kept[p] = (x - vx) * (wy - v_y) == (wx - vx) * (y - v_y)
    return kept


def _directions(px, py):
    """Step D on one chain's kept points: (ex, ey) of each edge unless equal
    to the edge before it."""
    out = []
    for e in range(len(px) - 1):
        ex, ey = px[e + 1] - px[e], py[e + 1] - py[e]
        if e == 0 or (ex, ey) != (px[e] - px[e - 1], py[e] - py[e - 1]):
            out.append((ex, ey))
    return out


def _chains(kind, H, rng):
    """(min x, max x) a row, -1 max x where the row is empty."""
    y = np.arange(H)
    valid = np.ones(H, bool)
    if kind == "staircase":
        s = 0.6180339887 * rng.choice([-1.0, 1.0]) / rng.integers(1, 4)
        l = np.floor(10 + H * abs(s) + s * y).astype(np.int64)
        r = l + 5
    elif kind == "convex":  # every row a hull point: nondecreasing integer steps
        d = np.sort(rng.integers(-6, 7, H))
        l = 60_000 + np.cumsum(d)
        r = 200_000 - np.cumsum(d)
    elif kind == "circle":
        c = R = H / 2
        half = np.sqrt(np.maximum(R * R - (y - c) ** 2, 0))
        l = np.floor(5000 - half).astype(np.int64)
        r = np.ceil(5000 + half).astype(np.int64)
    elif kind == "noise-gaps":
        l = rng.integers(0, 300, H)
        r = l + rng.integers(0, 40, H)
        valid = rng.random(H) < 0.6
    elif kind == "zigzag":
        l = 100 + (y % 7) * 3
        r = l + 10 + (y % 5)
    else:  # an upright bar, rows missing in runs
        l, r = np.full(H, 40), np.full(H, 48)
        valid = (y // 37) % 3 != 1
    return np.where(valid, l, 1 << 30), np.where(valid, r, -1)


@pytest.mark.parametrize("kind", ["staircase", "convex", "circle", "noise-gaps", "zigzag", "bar"])
@pytest.mark.parametrize("H", [70, 1000, 2048, 4096])
def test_hull_walk_keeps_the_plain_versions_points(kind, H):
    rng = np.random.default_rng(H + len(kind))
    l, r = _chains(kind, H, rng)
    valid = r >= 0
    ys = [int(v) for v in np.nonzero(valid)[0]]
    S = int(r[valid].max()) + 1
    plan = rk.tall_plan(max(H, rk.MAX_EXACT_HEIGHT + 1))
    for sign, v in ((1, l), (-1, r)):
        xs = [int(sign * t) for t in v[valid]]
        kept = _walk_kept(xs, ys, S, plan)
        ref = rk._convexify(torch.from_numpy(v[None].astype(np.int64)), torch.from_numpy(valid[None]),
                            sign)[0].numpy()[valid]
        np.testing.assert_array_equal(kept, ref)
        px, py = np.asarray(v[valid])[kept], np.asarray(ys)[kept]
        dirs = _directions(px.tolist(), py.tolist())
        edges = list(zip(np.diff(px).tolist(), np.diff(py).tolist()))
        assert dirs == [e for i, e in enumerate(edges) if i == 0 or e != edges[i - 1]]
        if kind == "convex":
            assert kept.all()  # every row is a hull point



def _first_round_concave(xs, ys):
    """Step R on one chain's compacted points (x negated for the right
    chain): whether a point is strictly concave between its neighbours."""
    return any((xs[p] - xs[p - 1]) * (ys[p + 1] - ys[p - 1]) - (ys[p] - ys[p - 1])
               * (xs[p + 1] - xs[p - 1]) > 0 for p in range(1, len(xs) - 1))


@pytest.mark.parametrize("kind", ["staircase", "convex", "circle", "noise-gaps", "zigzag", "bar"])
@pytest.mark.parametrize("H", [70, 1000, 2048, 4096])
def test_first_round_then_merges_keep_the_plain_versions_points(kind, H):
    """The kernel's route: a chain with no row concave in the lockstep's
    first round keeps every row, the others go to the merge walk; either
    way the kept rows are the plain version's.  Convex chains and bars take
    the first branch, staircases the second."""
    rng = np.random.default_rng(H + 3 * len(kind))
    l, r = _chains(kind, H, rng)
    valid = r >= 0
    ys = [int(v) for v in np.nonzero(valid)[0]]
    S = int(r[valid].max()) + 1
    plan = rk.tall_plan(max(H, rk.MAX_EXACT_HEIGHT + 1))
    for sign, v in ((1, l), (-1, r)):
        xs = [int(sign * t) for t in v[valid]]
        ref = rk._convexify(torch.from_numpy(v[None].astype(np.int64)),
                            torch.from_numpy(valid[None]), sign)[0].numpy()[valid]
        convex = not _first_round_concave(xs, ys)
        kept = np.ones(len(xs), bool) if convex else _walk_kept(xs, ys, S, plan)
        np.testing.assert_array_equal(kept, ref)
        if kind in ("convex", "bar"):
            assert convex
        if kind == "staircase":  # a digital line: the merges finish it
            assert not convex

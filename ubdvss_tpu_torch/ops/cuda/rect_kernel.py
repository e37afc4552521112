"""Minimum-area rectangles from per-row extremes: plain versions + CUDA kernels.

Counterpart of ``ubdvss_tpu/ops/pallas/rect_kernel.py`` and its two TPU
kernels.  Per component, the left (min x) and right (max x) chains of the
row extremes are convexified by deleting strictly concave points (int32
cross products, collinear points kept); every hull edge direction is tried
with rotating calipers, and the minimum area wins within a 1e-6 relative
tolerance, ties broken by the folded caliper angle, then the first
direction (left chain by row, then right chain by row), then the
horizontal candidate.

  * ``min_area_rect_compact`` (K3, ``_rect_kernel_compact``, M =
    ``max_points`` < H): each chain's first M surviving points are packed,
    and the directions are projected over the 2M packed points.
  * ``min_area_rect_exact`` (K3x, ``_rect_kernel``, M None or >= H): no
    cap, and the directions are projected over every valid row's two
    extremes, as the TPU kernel does.  On the card it serves every height:
    up to ``MAX_EXACT_HEIGHT`` rows with a component's arrays in one
    block's shared memory, above it the tall instance (the same selection):
    a cluster of eight blocks a component, its arrays spread over their
    shared memory (``tall_plan``); a chain the lockstep's first round
    leaves convex keeps every row, the others have their hulls merged in
    logarithmic depth; past what the cluster holds, the arrays in a
    device-memory workspace.

Output rows (B, 9, K): ux, uy, min_u, max_u, min_v, max_v, any_edge, p0x,
p0y; ``rects_from_selection`` turns them into corners, centre, size, angle.

``min_area_rect_select_reference`` mirrors the JAX lockstep deletion rounds
vectorised over components.  The CUDA kernels (``csrc/rect_kernel.cu``)
reach the same points another way — at most 4 lockstep rounds, then a
row stays iff its largest slope back is at most its smallest slope
forward; the tall instance keeps every row of a chain the first round
finds convex and otherwise the points on the chain's hull, found by
merging 32-row segments' hulls — so comparing them with it also checks
those claims.  ``UBDVSS_PALLAS_COMPAT=1`` makes the JAX
kernels convexify the two chains one after the other instead of in
lockstep; that keeps the same points, so it changes nothing here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ubdvss_tpu_torch.ops.cuda import _build
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import MAX_SHARED_BYTES

_INF = 3.4e38
_BIG = 1 << 30
# amin * (1 + 1e-6) + 1e-9, with both constants as the f32 values JAX uses
_TIE_MUL = float(np.float32(1.0 + 1e-6))
_TIE_ADD = float(np.float32(1e-9))


def _prev_alive(alive: torch.Tensor) -> torch.Tensor:
    """(N, H) bool -> index of the nearest alive slot strictly before each
    position along the last axis, -1 where there is none."""
    H = alive.shape[-1]
    idx = torch.arange(H, device=alive.device).expand_as(alive)
    inc = torch.cummax(torch.where(alive, idx, -1), dim=-1).values
    return torch.cat([torch.full_like(inc[:, :1], -1), inc[:, :-1]], dim=1)


def _next_alive(alive: torch.Tensor) -> torch.Tensor:
    """Nearest alive slot strictly after each position, -1 where none."""
    H = alive.shape[-1]
    pf = _prev_alive(alive.flip(-1))
    return torch.where(pf >= 0, H - 1 - pf, -1).flip(-1)


def _convexify(
    v: torch.Tensor, alive: torch.Tensor, sign: int, max_rounds: int | None = None
) -> torch.Tensor:
    """Lockstep concave-point deletion on one chain to its fixpoint (or for
    at most ``max_rounds`` rounds).

    v (N, H) int64 x values, alive (N, H) bool; a round deletes every alive
    point whose alive neighbours both exist and for which
    sign * cross > 0 (the point is strictly inside the chain's side).
    """
    H = v.shape[-1]
    yi = torch.arange(H, device=v.device).expand_as(v)
    for _ in range(H if max_rounds is None else max_rounds):
        prv, nxt = _prev_alive(alive), _next_alive(alive)
        pc, nc = prv.clamp(min=0), nxt.clamp(min=0)
        px, nx = v.gather(1, pc), v.gather(1, nc)
        cross = (v - px) * (nc - pc) - (yi - pc) * (nx - px)
        concave = alive & (prv >= 0) & (nxt >= 0) & (sign * cross > 0)
        if not bool(concave.any()):
            break
        alive = alive & ~concave
    return alive


def _fold_phi_key(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """Monotone surrogate of the caliper rotation angle mod 90 degrees."""
    kx = torch.zeros_like(ux)
    ky = torch.zeros_like(uy)
    found = torch.zeros_like(ux, dtype=torch.bool)
    for cx, cy in ((ux, -uy), (-uy, -ux), (-ux, uy), (uy, ux)):
        ok = (cx > 0) & (cy >= 0) & ~found
        kx = torch.where(ok, cx, kx)
        ky = torch.where(ok, cy, ky)
        found = found | ok
    return torch.where(found, ky / torch.clamp(kx, min=1e-30), 0.0)


def _extents(ux, uy, px, py, pm, chunk_elems=1 << 24):
    """min/max of the u- and v-projections of the points (px, py) where pm,
    for every direction: (N, D) each.  Components go in chunks so that the
    (chunk, D, P) projection tensors stay near ``chunk_elems`` (a CPU batch
    of 64 images with K=64 would otherwise hold GBs)."""
    N, D = ux.shape
    step = max(1, chunk_elems // max(1, D * px.shape[1]))
    out = [[], [], [], []]
    for c0 in range(0, N, step):
        sl = slice(c0, c0 + step)
        a, b = ux[sl, :, None], uy[sl, :, None]
        x = px[sl].to(torch.float32)[:, None, :]
        y = py[sl].to(torch.float32)[:, None, :]
        m = pm[sl, None, :]
        pu = a * x + b * y
        pv = (-b) * x + a * y
        out[0].append(torch.where(m, pu, _INF).amin(2))
        out[1].append(torch.where(m, pu, -_INF).amax(2))
        out[2].append(torch.where(m, pv, _INF).amin(2))
        out[3].append(torch.where(m, pv, -_INF).amax(2))
    return [torch.cat(o) for o in out]


def min_area_rect_select_reference(
    minx: torch.Tensor, maxx: torch.Tensor, max_points: int | None
) -> torch.Tensor:
    """Plain version: (B, K, H) int32 extremes -> (B, 9, K) f32 rows.

    ``max_points`` = M < H is the compacted kernel: directions and points
    are each chain's first M hull points.  None or M >= H is the
    uncompacted kernel: every hull edge's direction, projected over every
    valid row's two extremes (an interior point's f32 projection can beat
    a hull point's by an ulp, so the point set is the TPU kernel's).  The
    two share everything else.
    """
    B, K, H = minx.shape
    exact = max_points is None or max_points >= H
    M = H if exact else max_points
    D = 2 * M
    dev = minx.device
    mv = minx.reshape(B * K, H).to(torch.int64)
    xv = maxx.reshape(B * K, H).to(torch.int64)
    Nc = B * K
    rowv = xv >= 0
    yi = torch.arange(H, device=dev).expand(Nc, H)

    # --- convexify both chains, pack each chain's first M points ---
    cx = torch.zeros((Nc, D), dtype=torch.int64, device=dev)
    cy = torch.zeros_like(cx)
    cok = torch.zeros((Nc, D), dtype=torch.bool, device=dev)
    for chain, (v, sign) in enumerate(((mv, 1), (xv, -1))):
        alive = _convexify(v, rowv, sign)
        rank = torch.cumsum(alive.to(torch.int64), 1)
        comp, row = torch.nonzero(alive & (rank <= M), as_tuple=True)
        slot = rank[comp, row] - 1 + chain * M
        cx[comp, slot] = v[comp, row]
        cy[comp, slot] = row
        cok[comp, slot] = True

    # --- hull edges between consecutive packed slots of one chain ---
    zero = torch.zeros((Nc, 1), dtype=torch.int64, device=dev)
    nx = torch.cat([cx[:, 1:], zero], 1)
    ny = torch.cat([cy[:, 1:], zero], 1)
    nok = torch.cat([cok[:, 1:], zero.to(torch.bool)], 1)
    dio = torch.arange(D, device=dev)
    chain_last = (dio == M - 1) | (dio == D - 1)
    ex = (nx - cx).to(torch.float32)
    ey = (ny - cy).to(torch.float32)
    el2 = ex * ex + ey * ey
    eok = cok & nok & ~chain_last & (el2 > 0)
    inv = torch.rsqrt(torch.clamp(el2, min=1e-30))
    ux = ex * inv
    uy = ey * inv

    # --- projections: (N, D dirs) over the packed points or every row ---
    if exact:
        pts = torch.cat([mv, xv], 1), torch.cat([yi, yi], 1), torch.cat([rowv, rowv], 1)
    else:
        pts = cx, cy, cok
    minu, maxu, minv, maxv = _extents(ux, uy, *pts)
    area = torch.where(eok, (maxu - minu) * (maxv - minv), _INF)
    phi = torch.where(eok, _fold_phi_key(ux, uy), _INF)

    # --- horizontal direction + degenerate point (full-res arrays) ---
    minall = torch.where(rowv, mv, _BIG).amin(1)
    maxall = torch.where(rowv, xv, -_BIG).amax(1)
    ytop = torch.where(rowv, yi, _BIG).amin(1)
    ybot = torch.where(rowv, yi, -_BIG).amax(1)
    has_rows = rowv.any(1)
    at_top = (yi == ytop[:, None]) & rowv
    at_bot = (yi == ybot[:, None]) & rowv
    top_two = torch.where(at_top, xv - mv, 0).sum(1) > 0
    bot_two = torch.where(at_bot, xv - mv, 0).sum(1) > 0
    h_ok = has_rows & (top_two | bot_two)
    h_area = torch.where(
        h_ok, (maxall - minall).to(torch.float32) * (ybot - ytop).to(torch.float32), _INF
    )

    # --- min area + phi tie-break (edge group, then horizontal) ---
    amin = torch.minimum(area.amin(1), h_area)
    thresh = amin * _TIE_MUL + _TIE_ADD
    tie = eok & (area <= thresh[:, None])
    phi_e = torch.where(tie, phi, _INF).amin(1)
    phi_h = torch.where(h_ok & (h_area <= thresh), 0.0, _INF)
    best_phi = torch.minimum(phi_e, phi_h)
    sel = tie & (phi <= best_phi[:, None])
    first = sel.to(torch.int32).argmax(1, keepdim=True)
    hit_e = sel.any(1)
    vals_e = [q.gather(1, first)[:, 0] for q in (ux, uy, minu, maxu, minv, maxv)]
    vals_h = [
        torch.ones_like(amin),
        torch.zeros_like(amin),
        minall.to(torch.float32),
        maxall.to(torch.float32),
        ytop.to(torch.float32),
        ybot.to(torch.float32),
    ]
    rows = [torch.where(hit_e, ve, vh) for ve, vh in zip(vals_e, vals_h)]
    # the horizontal candidate's key is 0 <= best_phi, so it hits when valid
    rows.append((hit_e | h_ok).to(torch.float32))
    rows.append(torch.where(at_top, mv, 0).sum(1).to(torch.float32))
    rows.append(torch.where(has_rows, ytop, 0).to(torch.float32))
    return torch.stack(rows, 1).reshape(B, K, 9).permute(0, 2, 1).contiguous()


_FUNCS = {
    "rect_select": [_build.P] * 3 + [_build.I] * 4 + [_build.P],
    "rect_select_exact": [_build.P] * 3 + [_build.I] * 3 + [_build.P],
    "rect_select_exact_tall": [_build.P] * 4 + [_build.I] * 4 + [_build.P],
    "rect_exact_max_height": [],
    "rect_tall_slot_size": [_build.I],
    "rect_tall_plan": [_build.I, _build.P],
}


def exact_smem_bytes(H: int) -> int:
    """Shared memory of the uncompacted kernel at M = H, as
    ``rect_smem_bytes<true>`` in ``csrc/rect_kernel.cu`` counts it: per row
    the float4 row, two packed points, eight per-direction floats over two
    directions, the compacted (y, min x, max x) and two kept-direction
    slots (29 words), plus the chains' bitmasks (4 words a 32 rows)."""
    return 29 * 4 * H + 16 * (-(-H // 32))


# the kernel's block-reduction slots (``RectShared<128>``: 20 ints and 8
# floats), static shared memory beside the arrays
_REDUCTION_BYTES = 112
# the tallest map whose component arrays fit one block's shared memory (1994
# rows); taller ones take the tall instance.  The library's
# rect_exact_max_height() returns the C side's value of the same formula.
MAX_EXACT_HEIGHT = next(
    h for h in range(1, 1 << 16)
    if exact_smem_bytes(h + 1) + _REDUCTION_BYTES > MAX_SHARED_BYTES
)


TALL_CLUSTER = 8  # blocks a component in the tall instance (the portable cluster size)
TALL_THREADS = 256
TALL_SEGMENT = 32  # rows a level-0 hull segment: one warp's
TALL_CHUNK = 512  # directions a projection pass
TALL_SOLO_ROWS = 1024  # a component of at most this many rows: block 0 alone
_TALL_SCALARS = 16
_TALL_STATIC = 8 * TALL_CLUSTER + 3 * 4 * (TALL_THREADS // 32)  # ``TallShared``


def _r16(n: int) -> int:
    return -(-n // 16) * 16


@dataclasses.dataclass(frozen=True)
class TallPlan:
    """The tall instance's layout at height H, as ``tall_layout`` in
    ``csrc/rect_kernel.cu`` computes it (``rect_tall_plan`` returns the same
    ints, in ``FIELDS`` order, for the card's test).  ``hb`` compacted rows
    a block (positions [r hb, (r + 1) hb) in block r; a power of two, so a
    position's block is a shift), ``db`` directions a block.  A block's
    arrays: rows (float4), the two chains' hull vertices then kept points
    (int2), eight direction arrays (f32), the segment groups' counts, the
    kept flags and the reduction scalars, from the offsets below,
    ``block_bytes`` in all; ``smem`` the dynamic shared memory a block (the
    arrays where ``in_shared``; the projection's partial extremes and
    staged directions always)."""

    cluster: int
    threads: int
    hb: int
    db: int
    off_hull: int
    off_dirs: int
    off_cnt: int
    off_kept: int
    off_scal: int
    block_bytes: int
    smem: int
    in_shared: int
    static_smem: int
    solo_rows: int

    FIELDS = ("cluster", "threads", "hb", "db", "off_hull", "off_dirs", "off_cnt", "off_kept",
              "off_scal", "block_bytes", "smem", "in_shared", "static_smem", "solo_rows")

    @property
    def segments(self) -> int:
        """Level-0 segments a block."""
        return self.hb // TALL_SEGMENT

    def solo(self, n: int) -> bool:
        """Whether block 0 finishes a component of ``n`` valid rows alone,
        with block barriers (its arrays stay spread over the cluster), once
        every block has merged what lies inside it."""
        return n <= self.solo_rows

    def levels(self, n: int) -> list[str]:
        """The hull merge levels for ``n`` valid rows (of a chain with a
        row concave in the lockstep's first round), each as the kernel
        runs it: "block" (each block merges the groups whose first segment
        it holds, all inside it: a block barrier before), "cluster" (the
        same across blocks: a cluster barrier before) or "alone" (block 0
        merges every group: a solo component's levels past the block-local
        ones, or all of them where block 0 holds every position)."""
        nseg = -(-n // TALL_SEGMENT)
        alone = self.solo(n) and n <= self.hb
        out, lv = [], 0
        while (1 << lv) < nseg:
            local = self.segments % (2 << lv) == 0
            alone = alone or (self.solo(n) and not local)
            out.append("alone" if alone else "block" if local else "cluster")
            lv += 1
        return out

    @property
    def workspace_bytes(self) -> int:
        """Device-memory workspace a cluster (0 where the arrays fit the
        cluster's shared memory; ``rect_tall_slot_size``)."""
        return 0 if self.in_shared else self.cluster * self.block_bytes


def tall_plan(H: int) -> TallPlan:
    """The tall instance's layout at height ``H`` (``TallPlan``)."""
    hb = TALL_SEGMENT
    while TALL_CLUSTER * hb < H:
        hb *= 2
    db = 2 * hb
    off_hull = 16 * hb
    off_dirs = off_hull + 2 * 8 * hb
    off_cnt = off_dirs + 8 * 4 * db
    off_kept = off_cnt + _r16(2 * 4 * (hb // TALL_SEGMENT))
    off_scal = off_kept + _r16(hb)
    block_bytes = off_scal + 4 * _TALL_SCALARS
    fixed = TALL_CHUNK * (16 + 8)
    in_shared = int(block_bytes + fixed + _TALL_STATIC <= MAX_SHARED_BYTES)
    return TallPlan(TALL_CLUSTER, TALL_THREADS, hb, db, off_hull, off_dirs, off_cnt, off_kept,
                    off_scal, block_bytes, fixed + (block_bytes if in_shared else 0), in_shared,
                    _TALL_STATIC, TALL_SOLO_ROWS)


def tall_slot_bytes(H: int) -> int:
    """The tall instance's device-memory workspace a cluster at height H (0
    where its arrays fit the cluster's shared memory)."""
    return tall_plan(H).workspace_bytes


# the tall instance's workspace at most (persistent clusters reuse their slot)
TALL_WORKSPACE_BYTES = 1 << 28


def _check_extremes(minx: torch.Tensor, maxx: torch.Tensor) -> None:
    _build.check_input(minx, "minx", torch.int32, 3)
    _build.check_input(maxx, "maxx", torch.int32, 3, minx.device)
    if maxx.shape != minx.shape:
        raise ValueError(f"maxx {tuple(maxx.shape)} != minx {tuple(minx.shape)}")


def min_area_rect_compact(
    minx: torch.Tensor, maxx: torch.Tensor, max_points: int
) -> torch.Tensor:
    """The compacted kernel (K3), M = ``max_points`` < H hull points per
    chain.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (one block per component) or raises."""
    B, K, H = minx.shape
    if not 0 < max_points < H:
        raise ValueError(f"max_points={max_points}: the compacted kernel takes 0 < M < H={H}")
    if minx.device.type == "cpu":
        return min_area_rect_select_reference(minx, maxx, max_points)
    _check_extremes(minx, maxx)
    if (20 * max_points + 3 * H + 4 * ((H + 31) // 32)) * 4 > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"H={H}, max_points={max_points}: a component's rows, points and "
            "directions exceed one block's shared memory in the compacted rect "
            "kernel (ROADMAP.md §2a)"
        )
    lib = _build.load("rect_kernel", _FUNCS)
    out = torch.empty((B, 9, K), dtype=torch.float32, device=minx.device)
    _build.launch(
        lib, "rect_select", minx.device, minx.data_ptr(), maxx.data_ptr(),
        out.data_ptr(), B, K, H, max_points,
    )
    min_area_rect_compact.launches += 1
    return out


min_area_rect_compact.launches = 0


def min_area_rect_exact(minx: torch.Tensor, maxx: torch.Tensor) -> torch.Tensor:
    """The uncompacted kernel (K3x): every hull edge's direction over every
    valid row's two extremes.  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises: one block a component with its
    arrays in shared memory up to ``MAX_EXACT_HEIGHT`` rows, else the tall
    instance (a cluster of blocks a component, ``tall_plan``; past what its
    shared memory holds, persistent clusters with the arrays in a workspace
    of ``tall_slot_bytes`` a cluster, at most ``TALL_WORKSPACE_BYTES``)."""
    B, K, H = minx.shape
    if minx.device.type == "cpu":
        return min_area_rect_select_reference(minx, maxx, None)
    _check_extremes(minx, maxx)
    if B * K * H >= 1 << 31:
        raise NotImplementedError(
            f"B={B}, K={K}, H={H}: the tall rect kernel takes B*K*H < 2^31 (ROADMAP.md §2a)"
        )
    lib = _build.load("rect_kernel", _FUNCS)
    out = torch.empty((B, 9, K), dtype=torch.float32, device=minx.device)
    if H <= MAX_EXACT_HEIGHT:
        _build.launch(
            lib, "rect_select_exact", minx.device, minx.data_ptr(), maxx.data_ptr(),
            out.data_ptr(), B, K, H,
        )
    else:
        slot = tall_slot_bytes(H)
        slots = max(1, min(B * K, TALL_WORKSPACE_BYTES // slot)) if slot else 0
        ws = torch.empty(slots * slot, dtype=torch.uint8, device=minx.device) if slot else None
        _build.launch(
            lib, "rect_select_exact_tall", minx.device, minx.data_ptr(), maxx.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), B, K, H, slots,
        )
    min_area_rect_exact.launches += 1
    return out


min_area_rect_exact.launches = 0


def min_area_rect_select(
    minx: torch.Tensor, maxx: torch.Tensor, max_points: int | None
) -> torch.Tensor:
    """(B, K, H) int32 extremes -> (B, 9, K) f32 selection rows, choosing
    the kernel as ``ubdvss_tpu/ops/pallas/rect_kernel.min_area_rect_select``
    does: the compacted one for M = ``max_points`` < H, else (compaction
    could drop nothing) the uncompacted one."""
    if max_points is None or max_points >= minx.shape[-1]:
        return min_area_rect_exact(minx, maxx)
    return min_area_rect_compact(minx, maxx, max_points)


def rects_from_selection(sel: torch.Tensor) -> dict:
    """(B, 9, K) kernel selection -> points (B, K, 4, 2), center, size,
    angle_deg, as ``ubdvss_tpu/ops/pallas/rect_kernel.rects_from_selection``."""
    ux, uy, mnu, mxu, mnv, mxv, anyf, p0x, p0y = sel.unbind(1)
    any_edge = anyf > 0.5
    c_u = 0.5 * (mnu + mxu)
    c_v = 0.5 * (mnv + mxv)
    cx = c_u * ux - c_v * uy
    cy = c_u * uy + c_v * ux
    bw = mxu - mnu
    bh = mxv - mnv
    angle = torch.rad2deg(torch.atan2(uy, ux)) % 180.0
    hw_x = 0.5 * bw * ux
    hw_y = 0.5 * bw * uy
    hh_x = -0.5 * bh * uy
    hh_y = 0.5 * bh * ux
    signs = torch.tensor(
        [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]],
        dtype=torch.float32, device=sel.device,
    )
    corners_x = cx[..., None] + signs[:, 0] * hw_x[..., None] + signs[:, 1] * hh_x[..., None]
    corners_y = cy[..., None] + signs[:, 0] * hw_y[..., None] + signs[:, 1] * hh_y[..., None]
    corners = torch.stack([corners_x, corners_y], dim=-1)  # (B, K, 4, 2)

    cx = torch.where(any_edge, cx, p0x)
    cy = torch.where(any_edge, cy, p0y)
    bw = torch.where(any_edge, bw, 0.0)
    bh = torch.where(any_edge, bh, 0.0)
    angle = torch.where(any_edge, angle, 0.0)
    pt = torch.stack([p0x, p0y], dim=-1)
    corners = torch.where(any_edge[..., None, None], corners, pt[..., None, :].expand_as(corners))
    return {
        "points": corners,
        "center": torch.stack([cx, cy], dim=-1),
        "size": torch.stack([bw, bh], dim=-1),
        "angle_deg": angle,
    }

"""Minimum-area rectangles from per-row extremes: plain version + CUDA kernel.

Counterpart of ``ubdvss_tpu/ops/pallas/rect_kernel.py`` on its production
route, ``_rect_kernel_compact`` (``max_points`` = M < H): per component,
the left (min x) and right (max x) chains of the row extremes are
convexified by deleting strictly concave points (int32 cross products,
collinear points kept), each chain's first M surviving points are packed,
every packed edge direction is tried with rotating calipers, and the
minimum area wins within a 1e-6 relative tolerance, ties broken by the
folded caliper angle, then the first slot, then the horizontal candidate.
Output rows (B, 9, K): ux, uy, min_u, max_u, min_v, max_v, any_edge, p0x,
p0y; ``rects_from_selection`` turns them into corners, centre, size, angle.

``min_area_rect_select_reference`` mirrors the JAX lockstep deletion rounds
vectorised over components; the CUDA kernel (``csrc/rect_kernel.cu``) runs
a monotone stack per chain, which keeps the same points, so comparing the
two also checks that claim.  The uncompacted kernel (``_rect_kernel``,
taken when M >= H) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ubdvss_tpu_torch.ops.cuda import _build

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


def _convexify(v: torch.Tensor, alive: torch.Tensor, sign: int) -> torch.Tensor:
    """Lockstep concave-point deletion on one chain to its fixpoint.

    v (N, H) int64 x values, alive (N, H) bool; a round deletes every alive
    point whose alive neighbours both exist and for which
    sign * cross > 0 (the point is strictly inside the chain's side).
    """
    H = v.shape[-1]
    yi = torch.arange(H, device=v.device).expand_as(v)
    for _ in range(H):
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


def min_area_rect_select_reference(
    minx: torch.Tensor, maxx: torch.Tensor, max_points: int
) -> torch.Tensor:
    """Plain version: (B, K, H) int32 extremes -> (B, 9, K) f32 rows."""
    B, K, H = minx.shape
    M = max_points
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

    # --- projections: (N, D dirs, D pts) ---
    pxf = cx.to(torch.float32)[:, None, :]
    pyf = cy.to(torch.float32)[:, None, :]
    pm = cok[:, None, :]
    pu = ux[:, :, None] * pxf + uy[:, :, None] * pyf
    pv = (-uy)[:, :, None] * pxf + ux[:, :, None] * pyf
    minu = torch.where(pm, pu, _INF).amin(2)
    maxu = torch.where(pm, pu, -_INF).amax(2)
    minv = torch.where(pm, pv, _INF).amin(2)
    maxv = torch.where(pm, pv, -_INF).amax(2)
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


_FUNCS = {"rect_select": [_build.P] * 3 + [_build.I] * 4 + [_build.P]}


def min_area_rect_select(
    minx: torch.Tensor, maxx: torch.Tensor, max_points: int | None
) -> torch.Tensor:
    """(B, K, H) int32 extremes -> (B, 9, K) f32 selection rows.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one block per component) or raises.
    """
    H = minx.shape[-1]
    if max_points is None or max_points >= H:
        raise NotImplementedError(
            f"max_points={max_points} >= H={H} asks for the uncompacted rect "
            "kernel (_rect_kernel), still to be ported: ROADMAP.md §2 K3x"
        )
    if minx.device.type == "cpu":
        return min_area_rect_select_reference(minx, maxx, max_points)
    _build.check_input(minx, "minx", torch.int32, 3)
    _build.check_input(maxx, "maxx", torch.int32, 3, minx.device)
    if maxx.shape != minx.shape:
        raise ValueError(f"maxx {tuple(maxx.shape)} != minx {tuple(minx.shape)}")
    if 2 * max_points > 1024:
        raise ValueError(f"max_points={max_points}: one thread per direction, 2M <= 1024")
    B, K, _ = minx.shape
    lib = _build.load("rect_kernel", _FUNCS)
    out = torch.empty((B, 9, K), dtype=torch.float32, device=minx.device)
    _build.launch(
        lib, "rect_select", minx.device, minx.data_ptr(), maxx.data_ptr(),
        out.data_ptr(), B, K, H, max_points,
    )
    min_area_rect_select.launches += 1
    return out


min_area_rect_select.launches = 0


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

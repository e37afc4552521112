"""Minimum-area rectangles, the XLA formulation, in plain torch.

Counterpart of ``ubdvss_tpu/ops/rect.py``: the exact rect fit the JAX
package's XLA route runs (``min_area_rect_from_mask_stack``), its
hull-compacted variant, and the serial monotone-chain hull with the
caliper over its vertices.

Per component, from the per-row x-extremes: the left and right chains are
convexified by deleting strictly concave points in lockstep rounds (int64
cross products, collinear points kept; the steps are K3/K3x's plain
version's, ``ops/cuda/rect_kernel._convexify``), every surviving chain
edge and the horizontal are tried as a caliper direction, and the minimum
area wins.  Ties are broken as the JAX formulation breaks them: among the
directions within ``amin·(1 + 1e-6) + 1e-9`` the smallest
``mod(-degrees(atan2(ey, ex)), 90)``, then the first.  (The kernels' plain
versions fold the angle another way, ``_fold_phi_key``; on an exact tie
the two may report one rectangle from its other side.)

The serving routes fit rects with the kernels (``ops/postproc.py``); this
module is the tail of the row-tiled scan (``parallel/tiling.py``) and the
XLA route's API.  Projections through a matmul run under ``exact_f32``.
"""

from __future__ import annotations

import numpy as np
import torch

from ubdvss_tpu_torch.models.model import exact_f32
from ubdvss_tpu_torch.ops.cuda.rect_kernel import _convexify

_INT_MAX = int(np.iinfo(np.int32).max)
_INF = float(np.float32(3.4e38))
_DEG = float(np.float32(180.0 / np.pi))
_TIE_MUL = float(np.float32(1.0 + 1e-6))
_TIE_ADD = float(np.float32(1e-9))
_SIGNS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


def _degrees(x: torch.Tensor) -> torch.Tensor:
    return x * _DEG


def _scan_neighbor(x, y, alive, axis, reverse):
    """For each slot: coords of the nearest alive slot strictly before it
    along ``axis`` (after it when ``reverse``), and whether there is one.

    The values are the JAX scan's to the last slot: an inclusive scan
    holds the latest alive slot's coords (0 before the first), shifted one
    step with wrap-around, and only the wrapped slot's flag is cleared.
    """
    x, y, alive = (torch.movedim(t, axis, -1) for t in (x, y, alive))
    if reverse:
        x, y, alive = x.flip(-1), y.flip(-1), alive.flip(-1)
    H = x.shape[-1]
    idx = torch.arange(H, device=x.device).expand(alive.shape)
    last = torch.cummax(torch.where(alive, idx, -1), dim=-1).values
    has = last >= 0
    pick = last.clamp(min=0)
    ix = torch.where(has, torch.where(alive, x, 0).gather(-1, pick), 0)
    iy = torch.where(has, torch.where(alive, y, 0).gather(-1, pick), 0)
    ex, ey, eh = (torch.roll(t, 1, -1) for t in (ix, iy, has))
    eh[..., 0] = False
    if reverse:
        ex, ey, eh = ex.flip(-1), ey.flip(-1), eh.flip(-1)
    return tuple(torch.movedim(t, -1, axis) for t in (ex, ey, eh))


def _convexify_chain(x, alive, sign, max_rounds=None):
    """Keep only the convex-envelope points of the chain (x[r], r): lockstep
    deletion of every point strictly on the chain's inner side of its alive
    neighbours' chord (``sign`` +1 for the left/min chain, -1 for the
    right/max chain) until a round deletes nothing or ``max_rounds``
    (default H) rounds.  x, alive (..., H); returns the alive mask."""
    H = x.shape[-1]
    v = x.reshape(-1, H).to(torch.int64)
    out = _convexify(v, alive.reshape(-1, H), sign, max_rounds)
    return out.reshape(alive.shape)


def _compact_chain(x: torch.Tensor, alive: torch.Tensor, M: int):
    """A chain's surviving entries packed to (..., M) slots in ascending
    row: ``(cx, cy, ok)``; exact when at most M entries survive."""
    H = x.shape[-1]
    y = torch.arange(H, dtype=torch.int32, device=x.device).expand(x.shape)
    key = torch.where(alive, H - 1 - y, -1)
    vals, idx = torch.topk(key, M, dim=-1)
    ok = vals >= 0
    cx = x.gather(-1, idx)
    return torch.where(ok, cx, 0), torch.where(ok, idx.to(torch.int32), 0), ok


def _first_last_rows(minx, y, rowvalid):
    """The topmost and bottommost valid row flags of each (..., H) chain."""
    _, _, phf = _scan_neighbor(minx, y, rowvalid, minx.ndim - 1, reverse=False)
    _, _, nhf = _scan_neighbor(minx, y, rowvalid, minx.ndim - 1, reverse=True)
    return rowvalid & ~phf, rowvalid & ~nhf


def min_area_rect_from_extremes(
    minx: torch.Tensor, maxx: torch.Tensor, rowvalid: torch.Tensor
) -> dict:
    """Exact min-area rect from per-row component extremes.

    minx, maxx: (..., H) int per-row extreme x (any value where invalid);
    rowvalid: (..., H) bool.  Returns a dict with leading dims (...):
    points (4, 2), center (2,), size (2,), angle_deg, valid — the
    conventions of ``min_area_rect``.
    """
    H = minx.shape[-1]
    y = torch.arange(H, dtype=torch.int32, device=minx.device).expand(minx.shape)
    minx = torch.where(rowvalid, minx, 0).to(torch.int32)
    maxx = torch.where(rowvalid, maxx, 0).to(torch.int32)
    alive_l = _convexify_chain(minx, rowvalid, +1)
    alive_r = _convexify_chain(maxx, rowvalid, -1)

    def chain_edges(x, alive):
        nx, ny, nh = _scan_neighbor(x, y, alive, minx.ndim - 1, reverse=True)
        return (nx - x).to(torch.float32), (ny - y).to(torch.float32), alive & nh

    lex, ley, lok = chain_edges(minx, alive_l)
    rex, rey, rok = chain_edges(maxx, alive_r)
    first_row, last_row = _first_last_rows(minx, y, rowvalid)
    horiz_ok = ((first_row | last_row) & (maxx > minx)).any(-1)

    one = torch.ones_like(minx[..., :1], dtype=torch.float32)
    ex = torch.cat([lex, rex, one], -1)
    ey = torch.cat([ley, rey, torch.zeros_like(one)], -1)
    eok = torch.cat([lok, rok, horiz_ok[..., None]], -1)
    pxs = torch.cat([minx, maxx], -1).to(torch.float32)
    pys = torch.cat([y, y], -1).to(torch.float32)
    pok = torch.cat([rowvalid, rowvalid], -1)
    p0x = torch.where(first_row, minx, 0).sum(-1).to(torch.float32)
    p0y = torch.where(first_row, y, 0).sum(-1).to(torch.float32)
    valid = rowvalid.sum(-1) > 0
    return _caliper_finish(ex, ey, eok, pxs, pys, pok, p0x, p0y, valid)


def _caliper_finish(ex, ey, eok, pxs, pys, pok, p0x, p0y, valid) -> dict:
    """Masked edge directions (..., D) and candidate points (..., P) -> the
    min-area rect dict (the JAX formulation's conventions and tie-break)."""
    elen = torch.sqrt(ex * ex + ey * ey)
    good = eok & (elen > 0)
    inv = 1.0 / torch.clamp(elen, min=1e-30)
    ux = ex * inv
    uy = ey * inv
    pu = ux[..., :, None] * pxs[..., None, :] + uy[..., :, None] * pys[..., None, :]
    pv = -uy[..., :, None] * pxs[..., None, :] + ux[..., :, None] * pys[..., None, :]
    pm = pok[..., None, :]
    min_u = torch.where(pm, pu, _INF).amin(-1)
    max_u = torch.where(pm, pu, -_INF).amax(-1)
    min_v = torch.where(pm, pv, _INF).amin(-1)
    max_v = torch.where(pm, pv, -_INF).amax(-1)
    del pu, pv
    w = max_u - min_u
    ht = max_v - min_v
    area = torch.where(good, w * ht, _INF)
    amin = area.amin(-1, keepdim=True)
    tie = good & (area <= amin * _TIE_MUL + _TIE_ADD)
    phi = torch.remainder(-_degrees(torch.atan2(ey, ex)), 90.0)
    best = torch.argmin(torch.where(tie, phi, _INF), dim=-1, keepdim=True)

    def take(a):
        return a.gather(-1, best)[..., 0]

    ubx, uby = take(ux), take(uy)
    c_u = 0.5 * (take(min_u) + take(max_u))
    c_v = 0.5 * (take(min_v) + take(max_v))
    cx = c_u * ubx - c_v * uby
    cy = c_u * uby + c_v * ubx
    bw = take(w)
    bh = take(ht)
    angle = torch.remainder(_degrees(torch.atan2(uby, ubx)), 180.0)
    hw_x, hw_y = 0.5 * bw * ubx, 0.5 * bw * uby
    hh_x, hh_y = -0.5 * bh * uby, 0.5 * bh * ubx
    signs = torch.tensor(_SIGNS, dtype=torch.float32, device=ex.device)
    corners_x = cx[..., None] + signs[:, 0] * hw_x[..., None] + signs[:, 1] * hh_x[..., None]
    corners_y = cy[..., None] + signs[:, 0] * hw_y[..., None] + signs[:, 1] * hh_y[..., None]
    corners = torch.stack([corners_x, corners_y], -1)

    any_edge = good.any(-1)
    cx = torch.where(any_edge, cx, p0x)
    cy = torch.where(any_edge, cy, p0y)
    bw = torch.where(any_edge, bw, 0.0)
    bh = torch.where(any_edge, bh, 0.0)
    angle = torch.where(any_edge, angle, 0.0)
    pt = torch.stack([p0x, p0y], -1)
    corners = torch.where(any_edge[..., None, None], corners, pt[..., None, :].expand(corners.shape))
    return {
        "points": corners,
        "center": torch.stack([cx, cy], -1),
        "size": torch.stack([bw, bh], -1),
        "angle_deg": angle,
        "valid": valid,
    }


def min_area_rect_from_extremes_compact(
    minx: torch.Tensor, maxx: torch.Tensor, rowvalid: torch.Tensor, max_points: int = 64
) -> dict:
    """``min_area_rect_from_extremes`` with each convexified chain packed to
    ``max_points`` slots before the caliper (the JAX package's large-heatmap
    variant): identical whenever each chain keeps at most that many points,
    else a chain's lowest rows are dropped."""
    H = minx.shape[-1]
    M = min(max_points, H)
    y = torch.arange(H, dtype=torch.int32, device=minx.device).expand(minx.shape)
    minx = torch.where(rowvalid, minx, 0).to(torch.int32)
    maxx = torch.where(rowvalid, maxx, 0).to(torch.int32)
    lx, ly, lok_p = _compact_chain(minx, _convexify_chain(minx, rowvalid, +1), M)
    rx, ry, rok_p = _compact_chain(maxx, _convexify_chain(maxx, rowvalid, -1), M)

    def edges(cx, cy, ok):
        nok = torch.roll(ok, -1, -1)
        nok[..., -1] = False
        return (
            (torch.roll(cx, -1, -1) - cx).to(torch.float32),
            (torch.roll(cy, -1, -1) - cy).to(torch.float32),
            ok & nok,
        )

    lex, ley, lok = edges(lx, ly, lok_p)
    rex, rey, rok = edges(rx, ry, rok_p)
    first_row, last_row = _first_last_rows(minx, y, rowvalid)
    horiz_ok = ((first_row | last_row) & (maxx > minx)).any(-1)

    one = torch.ones_like(lx[..., :1], dtype=torch.float32)
    ex = torch.cat([lex, rex, one], -1)
    ey = torch.cat([ley, rey, torch.zeros_like(one)], -1)
    eok = torch.cat([lok, rok, horiz_ok[..., None]], -1)
    pxs = torch.cat([lx, rx], -1).to(torch.float32)
    pys = torch.cat([ly, ry], -1).to(torch.float32)
    pok = torch.cat([lok_p, rok_p], -1)
    p0x = torch.where(first_row, minx, 0).sum(-1).to(torch.float32)
    p0y = torch.where(first_row, y, 0).sum(-1).to(torch.float32)
    valid = rowvalid.sum(-1) > 0
    return _caliper_finish(ex, ey, eok, pxs, pys, pok, p0x, p0y, valid)


def monotone_chain_hull(pts: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Convex hull of masked integer points by Andrew's monotone chain.

    pts (N, 2) int (x, y), valid (N,) bool.  Returns ``(hull, m)``: hull
    (N + 1, 2) int32, the vertices counter-clockwise (math coordinates) in
    slots [0, m), zeros beyond; m a 0-d int32 tensor (0 with no valid
    point, 1 for one distinct point, 2 for collinear points).  A
    sequential loop on the host, as the JAX function is a sequential
    stack; no serving path calls it.
    """
    n_slots = pts.shape[0]
    p = pts.detach().cpu().numpy().astype(np.int64)
    ok = valid.detach().cpu().numpy().astype(bool)
    # lexicographic (x, y) order, invalid points last (a stable sort, as JAX's)
    key = np.where(ok, p[:, 0] * (2 * 65536) + p[:, 1], np.iinfo(np.int64).max)
    p = p[np.argsort(key, kind="stable")][: int(ok.sum())]
    uniq = [tuple(q) for i, q in enumerate(p) if i == 0 or tuple(q) != tuple(p[i - 1])]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    hull: list = []
    for q in uniq:  # lower hull
        while len(hull) >= 2 and cross(hull[-2], hull[-1], q) <= 0:
            hull.pop()
        hull.append(q)
    lower = len(hull)
    for q in reversed(uniq[:-1]):  # upper hull
        while len(hull) >= lower + 1 and cross(hull[-2], hull[-1], q) <= 0:
            hull.pop()
        hull.append(q)
    nu = len(uniq)
    m = 0 if nu == 0 else 1 if nu == 1 else max(len(hull) - 1, 0)
    out = np.zeros((n_slots + 1, 2), np.int32)
    if hull:
        out[: len(hull)] = np.asarray(hull, np.int64)
    return torch.from_numpy(out).to(pts.device), torch.tensor(m, dtype=torch.int32, device=pts.device)


def min_area_rect(hull: torch.Tensor, m) -> dict:
    """Exact minimum-area rectangle over hull vertices.

    hull (M, 2) numeric, valid in [0, m), CCW or CW; m a vertex count.
    Returns points (4, 2) f32 corners in order, center (2,), size (2,)
    (w along the chosen edge, h along its normal), angle_deg in [0, 180)
    of the w side, valid (m > 0).
    """
    M = hull.shape[0]
    dev = hull.device
    m = torch.as_tensor(m, device=dev)
    h = hull.to(torch.float32)
    idx = torch.arange(M, device=dev)
    pvalid = idx < m
    nxt = torch.where(m > 0, (idx + 1) % torch.clamp(m, min=1), 0)
    e = h[nxt] - h
    elen = torch.sqrt((e * e).sum(1))
    good = pvalid & (elen > 0)
    u = e / torch.clamp(elen, min=1e-30)[:, None]
    v = torch.stack([-u[:, 1], u[:, 0]], 1)
    with exact_f32():
        pu = u @ h.T
        pv = v @ h.T
    pmask = pvalid[None, :]
    min_u = torch.where(pmask, pu, _INF).amin(1)
    max_u = torch.where(pmask, pu, -_INF).amax(1)
    min_v = torch.where(pmask, pv, _INF).amin(1)
    max_v = torch.where(pmask, pv, -_INF).amax(1)
    w = max_u - min_u
    ht = max_v - min_v
    area = torch.where(good, w * ht, _INF)
    tie = good & (area <= area.amin() * _TIE_MUL + _TIE_ADD)
    phi = torch.remainder(-_degrees(torch.atan2(e[:, 1], e[:, 0])), 90.0)
    best = torch.argmin(torch.where(tie, phi, _INF))

    ub, vb = u[best], v[best]
    c_u = 0.5 * (min_u[best] + max_u[best])
    c_v = 0.5 * (min_v[best] + max_v[best])
    center = c_u * ub + c_v * vb
    size = torch.stack([w[best], ht[best]])
    signs = torch.tensor(_SIGNS, dtype=torch.float32, device=dev)
    with exact_f32():
        corners = center[None, :] + signs @ torch.stack([0.5 * w[best] * ub, 0.5 * ht[best] * vb])
    angle = torch.remainder(_degrees(torch.atan2(ub[1], ub[0])), 180.0)

    any_edge = good.any()
    p0 = h[0]
    return {
        "points": torch.where(any_edge, corners, p0.expand(4, 2)),
        "center": torch.where(any_edge, center, p0),
        "size": torch.where(any_edge, size, torch.zeros(2, device=dev)),
        "angle_deg": torch.where(any_edge, angle, 0.0),
        "valid": m > 0,
    }


def min_area_rect_from_mask_stack(eq: torch.Tensor) -> dict:
    """(H, W, K) bool component masks -> the rect dict of each component
    (leading dim K), from its per-row extreme points."""
    H, W, K = eq.shape
    cols = torch.arange(W, dtype=torch.int32, device=eq.device)[None, :, None]
    minx = torch.where(eq, cols, _INT_MAX).amin(1).T
    maxx = torch.where(eq, cols, -1).amax(1).T
    row_any = eq.any(1).T
    return min_area_rect_from_extremes(minx, maxx, row_any)

"""Polygon rasterization — GT segmentation-map synthesis, in plain PyTorch.

Counterpart of ``ubdvss_tpu/ops/rasterize.py`` (XLA-level code there, no
Pallas kernel): ground-truth polygons (scaled by 1/cfg.scale to heatmap
resolution, rounded to int) are filled into a class-indexed int map, 0 =
background, 1 + class_index for barcode pixels.

Fill rule, as in the JAX package (cv2.fillPoly semantics on integer-vertex
polygons, boundary-inclusive): a pixel is written if its centre is inside
the polygon under the even-odd crossing rule, OR it lies on the DDA outline
of any edge.  The f32 formulas are the JAX package's, term for term: the
``where``-guarded divisions, each multiply-add rounded once (``_fma``, as
XLA contracts it under ``jit``: on integer vertices a DDA half-tie falls
on the other side otherwise), ``round`` half to even (``torch.round``, as
``jnp.round``), and the last-polygon-wins select-sum over the P slots.
The batch axis B is explicit where JAX vmaps; rows are evaluated in chunks
that bound the (B, P, V, rows, W) temporaries.

``rasterize_polygons_windowed`` serves size-bounded polygons (the
on-device synthesis's, ``DataConfig.raster_window``): each polygon is
evaluated on a window at its bounding box's centre, at even origins (an
odd shift would flip the half-to-even ties), and the windows are placed
into the grid with the polygon axis kept, so that the last polygon wins
exactly as on the dense path.
"""

from __future__ import annotations

import torch

# elements of the largest (B, P, V, rows, W) temporary of one row chunk
_CHUNK_ELEMENTS = 1 << 22


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as XLA contracts the JAX package's
    jitted multiply-add: the f64 product of two f32 values is exact."""
    return (a.to(torch.float64) * b.to(torch.float64) + c.to(torch.float64)).to(torch.float32)


def _interior_mask(px, py, x1, y1, vvalid, poly_ok, ys, W):
    """(B, P, R, W) even-odd interior test over the pixel centres of rows
    ``ys`` (R,) f32; px, py, x1, y1, vvalid (B, P, V), poly_ok (B, P)."""
    xs = torch.arange(W, dtype=torch.float32, device=px.device)
    y = ys.view(1, 1, 1, -1)
    px, py, x1, y1 = (t[..., None] for t in (px, py, x1, y1))  # (B, P, V, 1)
    cond = ((py <= y) & (y1 > y)) | ((y1 <= y) & (py > y))  # (B, P, V, R)
    t = torch.where(cond, (y - py) / torch.where(y1 == py, 1.0, y1 - py), 0.0)
    xcross = _fma(t, x1 - px, px)
    cross_valid = cond & vvalid[..., None]
    inside_ct = (cross_valid[..., None] & (xcross[..., None] > xs)).sum(dim=2)  # (B, P, R, W)
    return ((inside_ct % 2) == 1) & poly_ok[..., None, None]


def _outline_mask(px, py, x1, y1, vvalid, poly_ok, ys, W):
    """(B, P, R, W) dense DDA-equivalent edge rasterization over rows ``ys``:
    an x-major edge (|dx| >= |dy|) covers the pixels (X, round(py + (X-px)
    * dy/dx)) for the columns X between its endpoints, a y-major one the
    pixels (round(px + (Y-py) * dx/dy), Y) for its rows."""
    ok = vvalid & poly_ok[..., None]  # (B, P, V)
    dx, dy = x1 - px, y1 - py
    xmajor = dx.abs() >= dy.abs()
    sdx = torch.where(dx == 0, 1.0, dx)
    sdy = torch.where(dy == 0, 1.0, dy)
    xs = torch.arange(W, dtype=torch.float32, device=px.device)
    lox, hix = torch.minimum(px, x1), torch.maximum(px, x1)
    loy, hiy = torch.minimum(py, y1), torch.maximum(py, y1)
    # x-major: the edge's row at every column (B, P, V, W)
    yx = torch.round(_fma(xs - px[..., None], (dy / sdx)[..., None], py[..., None]))
    in_col = (xs >= lox[..., None]) & (xs <= hix[..., None])
    okx = (ok & xmajor)[..., None] & in_col  # (B, P, V, W)
    oky = ok & ~xmajor
    y = ys.view(1, 1, 1, -1)  # (1, 1, 1, R)
    on_x = okx[..., None, :] & (yx[..., None, :] == y[..., None])  # (B, P, V, R, W)
    # y-major: the edge's column at each row (B, P, V, R)
    xy = torch.round(_fma(y - py[..., None], (dx / sdy)[..., None], px[..., None]))
    row_ok = oky[..., None] & (y >= loy[..., None]) & (y <= hiy[..., None])
    on_y = row_ok[..., None] & (xy[..., None] == xs)
    return (on_x | on_y).any(dim=2)


def _edges(polys: torch.Tensor, n_verts: torch.Tensor):
    """The (B, P, V) start and end points of every edge of (B, P, V, 2)
    polygons, the valid-vertex mask and the (B, P) polygons with 3 or more
    vertices."""
    V = polys.shape[2]
    px = polys[..., 0].to(torch.float32)
    py = polys[..., 1].to(torch.float32)
    n_verts = n_verts.to(torch.int64)
    vidx = torch.arange(V, device=polys.device)
    vvalid = vidx < n_verts[..., None]  # (B, P, V)
    nxt = torch.where(
        n_verts[..., None] > 0,
        (vidx + 1) % torch.clamp(n_verts[..., None], min=1),
        0,
    )
    return px, py, torch.gather(px, 2, nxt), torch.gather(py, 2, nxt), vvalid, n_verts >= 3


def _hit_masks(px, py, x1, y1, vvalid, poly_ok, out_hw) -> torch.Tensor:
    """(B, P, H, W) interior-or-outline hits, in row chunks that bound the
    (B, P, V, rows, W) temporaries (16x larger on the card: a training
    batch's 128² grids in 8 chunks, its 40² windows in one)."""
    H, W = out_hw
    B, P, V = px.shape
    chunk = _CHUNK_ELEMENTS * (16 if px.is_cuda else 1)
    rows = max(1, chunk // max(1, B * P * V * W))
    return torch.cat([
        _interior_mask(px, py, x1, y1, vvalid, poly_ok, ys, W)
        | _outline_mask(px, py, x1, y1, vvalid, poly_ok, ys, W)
        for ys in torch.arange(H, dtype=torch.float32, device=px.device).split(rows)
    ], dim=2)


def _last_poly_class(hit: torch.Tensor, class_ids: torch.Tensor) -> torch.Tensor:
    """(B, P, H, W) hits -> (B, H, W) int32 map of the last hit polygon's
    class: a select-sum over the P slots, exact because the last index
    matches at most one slot."""
    B, P = hit.shape[:2]
    pidx = torch.arange(P, dtype=torch.int32, device=hit.device).view(1, P, 1, 1)
    last = torch.where(hit, pidx, -1).amax(dim=1)  # (B, H, W)
    cls = class_ids.to(torch.int32).view(B, P, 1, 1)
    return torch.where(last[:, None] == pidx, cls, 0).sum(dim=1, dtype=torch.int32)


def rasterize_polygons(
    polys: torch.Tensor,
    n_verts: torch.Tensor,
    class_ids: torch.Tensor,
    out_hw: tuple[int, int],
) -> torch.Tensor:
    """Fill polygons into class-index maps, a batch at once.

    Args:
      polys: (B, P, V, 2) vertices (x, y) in output-grid coords; slots
        beyond n_verts[b, p] ignored; polys with n_verts < 3 skipped.
      n_verts: (B, P) int vertex counts.
      class_ids: (B, P) int value written per polygon (1 + class_index);
        later polygons overwrite earlier ones (sequential fillPoly order).
      out_hw: (H, W) output size.

    Returns: (B, H, W) int32 maps, 0 background.
    """
    px, py, x1, y1, vvalid, poly_ok = _edges(polys, n_verts)
    return _last_poly_class(_hit_masks(px, py, x1, y1, vvalid, poly_ok, out_hw), class_ids)


def rasterize_polygons_windowed(
    polys: torch.Tensor,
    n_verts: torch.Tensor,
    class_ids: torch.Tensor,
    out_hw: tuple[int, int],
    window: int,
) -> torch.Tensor:
    """``rasterize_polygons`` for size-bounded polygons, a window each.

    Each polygon is evaluated on a ``window`` x ``window`` box (clipped to
    the grid) at its bounding box's centre instead of on the whole grid.
    Contract, as the JAX package's: a polygon whose bounding box exceeds
    ``window - 4`` (2 px a side for the anchor's rounding and the even
    origin) may be clipped to its window; within it the result equals the
    dense path's, overlapping polygons included.  Same arguments and
    result as ``rasterize_polygons``.
    """
    H, W = out_hw
    wn = min(window, H, W)
    B, P = polys.shape[:2]
    px, py, x1, y1, vvalid, poly_ok = _edges(polys, n_verts)
    # the window's anchor: the bounding box's centre, clamped in frame
    big = 1e9
    cx = (torch.where(vvalid, px, big).amin(2) + torch.where(vvalid, px, -big).amax(2)) / 2.0
    cy = (torch.where(vvalid, py, big).amin(2) + torch.where(vvalid, py, -big).amax(2)) / 2.0
    cx = torch.where(poly_ok, cx, 0.0)
    cy = torch.where(poly_ok, cy, 0.0)
    # EVEN origins: the crossing and DDA math rounds half-ties to even, and
    # an odd shift flips a tie's parity; even shifts keep every decision
    x0 = torch.clamp(torch.round(cx).to(torch.int64) - wn // 2, 0, W - wn) // 2 * 2
    y0 = torch.clamp(torch.round(cy).to(torch.int64) - wn // 2, 0, H - wn) // 2 * 2
    ox = x0.to(torch.float32)[..., None]
    oy = y0.to(torch.float32)[..., None]
    hit_w = _hit_masks(px - ox, py - oy, x1 - ox, y1 - oy, vvalid, poly_ok, (wn, wn))
    # each window into the grid, the polygon axis kept (overlap-exact)
    iw = torch.arange(wn, device=polys.device)
    pos = ((y0[..., None] + iw) * W)[..., :, None] + (x0[..., None] + iw)[..., None, :]  # (B, P, wn, wn)
    hit = torch.zeros((B, P, H * W), dtype=torch.bool, device=polys.device)
    hit.scatter_(2, pos.reshape(B, P, -1), hit_w.reshape(B, P, -1))
    return _last_poly_class(hit.view(B, P, H, W), class_ids)


def polygons_to_grid(
    polys: torch.Tensor, scale: int, round_to_int: bool = True
) -> torch.Tensor:
    """Input-resolution polygon coords -> heatmap-grid coords (1/scale),
    rounded to the nearest int (half to even)."""
    p = polys / float(scale)
    return torch.round(p) if round_to_int else p

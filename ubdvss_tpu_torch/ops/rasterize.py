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

``rasterize_polygons_windowed`` (the training synthesis path's object
windows) is not ported (ROADMAP.md §1 item 10b).
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
    H, W = out_hw
    B, P, V, _ = polys.shape
    dev = polys.device
    px = polys[..., 0].to(torch.float32)
    py = polys[..., 1].to(torch.float32)
    n_verts = n_verts.to(torch.int64)
    vidx = torch.arange(V, device=dev)
    vvalid = vidx < n_verts[..., None]  # (B, P, V)
    nxt = torch.where(
        n_verts[..., None] > 0,
        (vidx + 1) % torch.clamp(n_verts[..., None], min=1),
        0,
    )
    x1 = torch.gather(px, 2, nxt)
    y1 = torch.gather(py, 2, nxt)
    poly_ok = n_verts >= 3

    rows = max(1, _CHUNK_ELEMENTS // max(1, B * P * V * W))
    hit = torch.cat([
        _interior_mask(px, py, x1, y1, vvalid, poly_ok, ys, W)
        | _outline_mask(px, py, x1, y1, vvalid, poly_ok, ys, W)
        for ys in torch.arange(H, dtype=torch.float32, device=dev).split(rows)
    ], dim=2)  # (B, P, H, W)

    pidx = torch.arange(P, dtype=torch.int32, device=dev).view(1, P, 1, 1)
    last = torch.where(hit, pidx, -1).amax(dim=1)  # (B, H, W)
    # class lookup as a select-sum over the P slots, exact because `last`
    # matches at most one slot
    cls = class_ids.to(torch.int32).view(B, P, 1, 1)
    return torch.where(last[:, None] == pidx, cls, 0).sum(dim=1, dtype=torch.int32)


def polygons_to_grid(
    polys: torch.Tensor, scale: int, round_to_int: bool = True
) -> torch.Tensor:
    """Input-resolution polygon coords -> heatmap-grid coords (1/scale),
    rounded to the nearest int (half to even)."""
    p = polys / torch.tensor(float(scale), dtype=torch.float32, device=polys.device)
    return torch.round(p) if round_to_int else p

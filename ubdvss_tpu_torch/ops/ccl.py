"""Connected-component labelling by min-label propagation, in plain torch.

Counterpart of ``ubdvss_tpu/ops/ccl.py`` (the XLA route's CCL):

  1. every foreground pixel starts labelled with its own linear index, the
     background with the sentinel H*W;
  2. a round takes (a) the min over the 8- (or 4-) neighbourhood, (b) the
     min over each contiguous foreground run along W, (c) the same along H;
  3. rounds repeat until one changes nothing (then every pixel holds its
     component's minimum index) or ``max_iters`` rounds (default H + W)
     have run.

The run min is one ``torch.cummin`` a direction over the int64 key
``segment · (H·W + 1) + label``, whose segment index orders the keys so
that a scan never leaves its run (background pixels are segments of their
own).  Everything is integer arithmetic, so the labels are the JAX
package's bit for bit.  The same rounds are the plain version of the CCL
kernel (``ops/cuda/ccl_kernel.ccl_labels_reference``) and the per-tile
rounds of the row-tiled CCL (``parallel/tiling.py``).

``connected_components`` compacts the raw labels to 1..n in raster order
of each component's root (its topmost-leftmost pixel), 0 the background.
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, d: int, axis: int, fill) -> torch.Tensor:
    """Shift x by +d (toward higher indices) along axis, filling with fill."""
    n = x.shape[axis]
    out = torch.full_like(x, fill)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(axis, d, n - d).copy_(x.narrow(axis, 0, n - d))
    else:
        out.narrow(axis, 0, n + d).copy_(x.narrow(axis, -d, n + d))
    return out


def _neighbor_min(lab: torch.Tensor, sentinel: int, connectivity: int) -> torch.Tensor:
    """(..., H, W) min over the 3x3 window (8) or the cross (4)."""
    if connectivity == 8:
        m = torch.minimum(
            lab,
            torch.minimum(_shift(lab, 1, -1, sentinel), _shift(lab, -1, -1, sentinel)),
        )
        return torch.minimum(
            m, torch.minimum(_shift(m, 1, -2, sentinel), _shift(m, -1, -2, sentinel))
        )
    m = lab
    for d, ax in ((1, -2), (-1, -2), (1, -1), (-1, -1)):
        m = torch.minimum(m, _shift(lab, d, ax, sentinel))
    return m


def _segmented_run_min(
    lab: torch.Tensor, mask: torch.Tensor, sentinel: int, axis: int
) -> torch.Tensor:
    """Min of ``lab`` within each contiguous True-run of ``mask`` along
    ``axis``; the background holds ``sentinel``.

    Segments are the runs and each background element; ``seg`` numbers
    them 1.. along the axis.  A forward cummin over ``(n + 1 - seg)·big +
    v`` stays within the current segment (earlier segments' keys are
    larger), a backward one over ``seg·big + v`` likewise, and the two
    prefix minima together are the run's minimum.
    """
    n = mask.shape[axis]
    big = sentinel + 1
    seg = torch.cumsum((~(mask & _shift(mask, 1, axis, False))).to(torch.int64), axis)
    v = torch.where(mask, lab, sentinel).to(torch.int64)
    off_f = (n + 1 - seg) * big
    fwd = torch.cummin(off_f + v, axis).values - off_f
    off_b = seg * big
    bwd = torch.cummin((off_b + v).flip(axis), axis).values.flip(axis) - off_b
    return torch.where(mask, torch.minimum(fwd, bwd).to(lab.dtype), sentinel)


def _propagation_round(lab, mask, sentinel, connectivity):
    """One round: neighbourhood min, then the run min along W, then H."""
    lab = torch.where(mask, _neighbor_min(lab, sentinel, connectivity), sentinel)
    lab = _segmented_run_min(lab, mask, sentinel, -1)
    return _segmented_run_min(lab, mask, sentinel, -2)


def label_propagation(
    mask: torch.Tensor, connectivity: int = 8, max_iters: int | None = None
) -> torch.Tensor:
    """Raw min-index labels of a (..., H, W) mask: each foreground pixel its
    component's minimum linear index, the background H*W.  Rounds run
    until one changes nothing anywhere or ``max_iters`` (default H + W)."""
    h, w = mask.shape[-2], mask.shape[-1]
    sentinel = h * w
    if max_iters is None:
        max_iters = h + w
    mask = mask.to(torch.bool)
    idx = torch.arange(h * w, dtype=torch.int32, device=mask.device).reshape(h, w)
    lab = torch.where(mask, idx, sentinel)
    for _ in range(max_iters):
        new = _propagation_round(lab, mask, sentinel, connectivity)
        if torch.equal(new, lab):
            break
        lab = new
    return lab


def compact_labels(
    lab: torch.Tensor, mask: torch.Tensor, sentinel: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(H, W) raw min-index labels -> ``(labels, n)``: 1..n in raster order
    of each root (the pixel whose label is its own index), 0 the
    background; n the number of roots, a 0-d int32 tensor."""
    h, w = lab.shape
    idx = torch.arange(h * w, dtype=torch.int32, device=lab.device).reshape(h, w)
    rank = torch.cumsum((mask & (lab == idx)).reshape(-1).to(torch.int32), 0, dtype=torch.int32)
    tgt = torch.clamp(lab, 0, sentinel - 1).reshape(-1).long()
    return torch.where(mask, rank[tgt].reshape(h, w), 0).to(torch.int32), rank[-1]


def connected_components(
    mask: torch.Tensor, connectivity: int = 8, max_iters: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Label the components of an (H, W) boolean mask.

    Returns ``(labels, n)``: (H, W) int32, 0 the background, components
    numbered 1..n in raster order of their topmost-leftmost pixel; n a 0-d
    int32 tensor.  ``max_iters`` caps the rounds (default H + W).
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    h, w = mask.shape
    mask = mask.to(torch.bool)
    return compact_labels(label_propagation(mask, connectivity, max_iters), mask, h * w)

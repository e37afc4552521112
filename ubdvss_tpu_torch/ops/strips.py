"""Strip-tiled trunk execution for large scans.

Counterpart of the row and column strips of ``ubdvss_tpu/ops/strips.py``
(``strip_plan`` and ``strip_tiled_logits``, :33-89) and of
``receptive_field_halo`` (``ubdvss_tpu/parallel/tiling.py:47-54``), the
parts that ``detect_program_batch(n_strips=...)`` runs.  The batch is cut into
overlapping row (or column) strips whose overlap covers the FCN's
receptive field, the unchanged trunk runs on the (S*B)-strip batch, and
each strip's logits are cropped to its core and reassembled.

Exactness: a SAME-padded FCN output pixel depends only on inputs within
the receptive field, so the core outputs of a strip with a halo at least
that wide equal the whole image's wherever the strip window lies inside
the image; edge windows are clamped to the image, so the model's own SAME
padding falls on the true image edge.
"""

from __future__ import annotations

from typing import Callable

import torch


def receptive_field_halo(cfg) -> int:
    """Input-pixel halo covering the FCN receptive field, a multiple of
    scale: each 3x3 context conv at dilation d reaches d feature pixels a
    side, the two stride-2 downscale convs about 3 input pixels."""
    feat_radius = sum(cfg.dilations) + 1  # +1 head/safety
    return cfg.scale * (feat_radius + 1)


def strip_plan(H: int, scale: int, halo: int, n_strips: int) -> list[tuple[int, int]]:
    """Per-strip (window_start, core_offset) pairs, all multiples of scale.

    Every window has the same height ``H // n_strips + 2 * halo`` so strips
    batch into one tensor; edge windows are clamped into the image, which
    shifts their core offset instead.
    """
    if H % (n_strips * scale):
        raise ValueError(f"H={H} not divisible by n_strips*scale")
    if halo % scale:
        raise ValueError(f"halo={halo} not a multiple of scale={scale}")
    hs = H // n_strips
    win = hs + 2 * halo
    if win >= H:
        raise ValueError(f"strip window {win} >= image height {H}")
    plan = []
    for s in range(n_strips):
        start = min(max(s * hs - halo, 0), H - win)
        plan.append((start, s * hs - start))
    return plan


def strip_tiled_logits(
    trunk: Callable, x: torch.Tensor, scale: int, halo: int, n_strips: int, axis: int = 1
) -> torch.Tensor:
    """Run ``trunk`` ((B', h, w[, C]) images -> (B', h/scale, w/scale, O)
    logits, SAME padding) over strips of ``x`` along ``axis`` (1 = rows,
    2 = columns) and reassemble logits identical to ``trunk(x)``.

    ``x``: (B, H, W) or (B, H, W, C), its size along ``axis`` divisible by
    n_strips*scale.
    """
    B, H = x.shape[0], x.shape[axis]
    plan = strip_plan(H, scale, halo, n_strips)
    hs = H // n_strips
    win = hs + 2 * halo
    strips = torch.cat([x.narrow(axis, st, win) for st, _ in plan], dim=0)
    y = trunk(strips)  # (S*B, ..., win/scale, ..., O)
    cores = [
        y[s * B : (s + 1) * B].narrow(axis, off // scale, hs // scale)
        for s, (_, off) in enumerate(plan)
    ]
    return torch.cat(cores, dim=axis)

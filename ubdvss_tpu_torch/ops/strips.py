"""Strip-tiled trunk execution for large scans.

Counterpart of ``ubdvss_tpu/ops/strips.py`` and of
``receptive_field_halo`` (``ubdvss_tpu/parallel/tiling.py:47-54``).  The
batch is cut into overlapping row (or column) strips whose overlap covers
the FCN's receptive field, the unchanged trunk runs on the (S*B)-strip
batch, and each strip's logits are cropped to its core and reassembled:

  * ``strip_tiled_logits`` (``detect_program_batch(n_strips=...)``) and
    ``tile_2d_logits``, its rows-by-columns composition;
  * ``two_stage_tiled_trunk``: the stem and the context module tiled
    separately, each with its own halo (``stem_halo``, ``context_halo``;
    ``auto_two_stage_grids``), the route the JAX package's large scans
    take where the packed trunk does not apply;
  * ``packed_fused_trunk_tiled``: the packed trunk
    (``context_kernel.packed_fused_trunk``) tiled at the image level on
    axes of 4096 px and more (``packed_trunk_tile_grid``), identity below.

The JAX package tiles to keep its TPU's convolutions out of a slow
large-map regime; the port runs the same slicing and concatenation around
its own trunks, so both routes give the JAX package's logits.

Exactness: a SAME-padded FCN output pixel depends only on inputs within
the receptive field, so the core outputs of a strip with a halo at least
that wide equal the whole image's wherever the strip window lies inside
the image; edge windows are clamped to the image, so the model's own SAME
padding falls on the true image edge.
"""

from __future__ import annotations

from typing import Callable

import torch

from ubdvss_tpu_torch.models.model import compute_precision
from ubdvss_tpu_torch.ops.cuda.context_kernel import (
    context_head_route,
    context_head_route_maybe_packed,
    packed_fused_trunk,
    stem_apply,
)


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


def tile_2d_logits(trunk: Callable, x: torch.Tensor, scale: int, halo: int, grid) -> torch.Tensor:
    """2-D composition of ``strip_tiled_logits``: ``grid = (ny, nx)`` tiles
    over rows x columns, each window with the same ``halo`` on every side,
    so the reassembly equals ``trunk(x)`` by the receptive-field argument
    applied per axis."""
    ny, nx = grid
    if nx > 1:
        def fn(s):
            return strip_tiled_logits(trunk, s, scale, halo, nx, axis=2)
    else:
        fn = trunk
    if ny > 1:
        return strip_tiled_logits(fn, x, scale, halo, ny, axis=1)
    return fn(x)


# Receptive-field radii of the FCN's two stages: the two stride-2 3x3
# downscale convs reach 1 + 2 = 3 input pixels a side; each 3x3 context
# conv at dilation d reaches d feature pixels a side (the 1x1 head none).


def stem_halo(scale: int) -> int:
    """Input-pixel halo covering the downscale stem, rounded up to scale."""
    return scale * -(-3 // scale)


def context_halo(dilations) -> int:
    """Feature-pixel halo covering the dilated context stack and head."""
    return sum(dilations)


def auto_n_strips(H: int, scale: int, halo: int, target_core: int = 512) -> int:
    """Largest strip count with ~``target_core``-row cores that still
    divides H on the downscale grid and keeps windows inside the image;
    1 = don't tile."""
    n = max(1, H // target_core)
    while n > 1 and (H % (n * scale) or H // n + 2 * halo >= H):
        n -= 1
    return n


def auto_two_stage_grids(H: int, W: int, scale: int, dilations, stem_core: int = 512):
    """(stem_grid, ctx_grid) for ``two_stage_tiled_trunk``, the JAX
    package's choice: row strips of ~512-row cores for the stem, the
    context untiled."""
    sh = stem_halo(scale)
    return (auto_n_strips(H, scale, sh, stem_core), 1), (1, 1)


def two_stage_tiled_trunk(params: dict, x4: torch.Tensor, cfg, stem_grid, ctx_grid,
                          raw_gray: bool = False, return_packed: bool = False):
    """The FCN forward with per-stage 2-D tiling: the stem over
    ``stem_grid`` tiles with ``stem_halo``, then the context module and
    head over ``ctx_grid`` tiles of the features with ``context_halo``.
    ``x4``: (B, H, W, 1) images (raw [0, 255] gray with ``raw_gray``, else
    normalized).  Returns the (B, H/scale, W/scale, O) logits of the
    untiled trunk; with ``return_packed`` ``(logits, packed_phases)``, the
    logits handed over phase-major where the JAX package's s2d route fires
    and the context is untiled (``context_head_route_maybe_packed``, at
    the trunk's dtype), else ``(logits, None)``."""
    large = (x4.shape[1] // cfg.scale) * (x4.shape[2] // cfg.scale) > 128 * 128
    with compute_precision(cfg):
        def stem(s):
            return stem_apply(params, s, cfg, raw_gray=raw_gray)

        feat = tile_2d_logits(stem, x4, cfg.scale, stem_halo(cfg.scale), stem_grid)
        if return_packed and tuple(ctx_grid) == (1, 1):
            return context_head_route_maybe_packed(params, feat, cfg, large=large, act_out=True)

        def ctx(f):
            return context_head_route(params, f, cfg)

        logits = tile_2d_logits(ctx, feat, 1, context_halo(cfg.dilations), ctx_grid)
    return (logits, None) if return_packed else logits


def packed_trunk_tile_grid(H: int, W: int, cfg, target_core: int = 1024):
    """(halo, (ny, nx)) of the image-level tiling of the packed trunks
    (``packed_fused_trunk_tiled``, ``quant.int8_packed_trunk_tiled``): the
    receptive-field halo rounded up to 8 (tile windows stay aligned to the
    packed grid), ~1024-px cores on axes of 4096 px and more, no tiling
    below."""
    halo = receptive_field_halo(cfg)
    halo += (-halo) % 8
    ny = auto_n_strips(H, 8, halo, target_core) if H >= 4096 else 1
    nx = auto_n_strips(W, 8, halo, target_core) if W >= 4096 else 1
    return halo, (ny, nx)


def packed_fused_trunk_tiled(params: dict, x4: torch.Tensor, cfg, raw_gray: bool = False,
                             grid: tuple[int, int] | None = None) -> torch.Tensor:
    """``context_kernel.packed_fused_trunk`` over ``packed_trunk_tile_grid``'s
    tiles (or ``grid``): the untiled trunk's phase-major logits, at the
    trunk's dtype (``act_out``)."""
    halo, auto = packed_trunk_tile_grid(x4.shape[1], x4.shape[2], cfg)

    def fn(t):
        return packed_fused_trunk(params, t, cfg, raw_gray=raw_gray, act_out=True)

    return tile_2d_logits(fn, x4, 8, halo, auto if grid is None else grid)

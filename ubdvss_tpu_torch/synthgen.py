"""Synthetic training scenes made on the device (the device-fed pipeline).

Counterpart of ``ubdvss_tpu/synthgen.py``: whole training batches are
synthesized where the step runs — procedural barcode scenes rendered at
their augmented pose (the augmentation's affine is composed into the
render, so no image warp runs), their exact polygons, then photometric
jitter, normalize and the windowed rasterizer (``data.finalize_batch``) —
so that no host collate or copy sits between two steps.

Class signatures: the per-class constants (1D run-length tables and style
flags, postal level patterns, 2D module divisor and finder style) are built
on the host once a class list, from the same per-class generator draws as
``synthetic.py`` (``_class_rng``), so device scenes carry the class cues of
host-rendered ones (the transfer gate: the host-trained dense asset detects
and classifies device scenes).

The JAX package draws from ``jax.random`` keys; here a ``torch.Generator``
on the device draws the same quantities (``scene_draws``), and
``render_scenes`` does the arithmetic, so that the arithmetic can be held
against the JAX package on JAX's own draws.  Placement is JAX's: one object
a cell of a shuffled grid, jittered, so objects are disjoint without
rejection sampling.  Each object's texture is evaluated on a 128-px window
at its centre (objects are at most ~124 px across) and composed into the
frame by a scatter-add, exact because at most one object covers a pixel.
A batch's scenes are rendered together: the B x P objects' windows are one
(B*P, window) tensor, and each texel function runs once over all of them.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ubdvss_tpu_torch.data import (
    DataConfig,
    batch_seed,
    finalize_batch,
)
from ubdvss_tpu_torch.inference import resolve_device
from ubdvss_tpu_torch.net_config import CLASS_GROUPS, DEFAULT_CLASS_NAMES, NetConfig
from ubdvss_tpu_torch.ops.augment import (
    _invert_affine,
    _uniform,
    affine_draws,
    affine_from_draws,
    draw_rows,
    photometric_apply,
    photometric_draws,
)
from ubdvss_tpu_torch.ops.rasterize import _fma
from ubdvss_tpu_torch.synthetic import _1D_STYLE, _class_rng

# group ids
_G1D, _G2D, _GPOSTAL = 0, 1, 2

_N_RUNS = 96  # host _render_1d sequence length
_N_POSTAL = 48
_WINDOW = 128  # the render window's side (px)
_M32 = 0xFFFFFFFF


def _group_id(name: str) -> int:
    if name in CLASS_GROUPS["1D"]:
        return _G1D
    if name in CLASS_GROUPS["postal"]:
        return _GPOSTAL
    return _G2D


@functools.lru_cache(maxsize=8)
def build_class_tables(class_names: tuple[str, ...] = DEFAULT_CLASS_NAMES) -> dict:
    """Host-precomputed per-class signature constants (numpy, cached).

    Consumes the per-class RNG (``synthetic._class_rng``) in the same order
    as the host renderers, so the fixed class signatures are identical.
    """
    n = len(class_names)
    t = {
        "group": np.zeros(n, np.int32),
        # 1D: per-phase stripe-run boundary tables in module units, duty
        # folded in.  bounds[p, 2i] = end of dark run i, bounds[p, 2i+1] =
        # end of white run i, from the START of the stripe field for phase
        # p — linear, not cyclic: the host renderer counts Code39's
        # inter-character gaps from the field start (n_dark % 4).  96 pairs
        # cover >= 190 module units, beyond any bw/module the size sampler
        # can produce.
        "bounds": np.zeros((n, _N_RUNS, 2 * _N_RUNS), np.float32),
        "module": np.ones(n, np.float32),
        "band_frac": np.zeros(n, np.float32),
        "quiet_frac": np.zeros(n, np.float32),
        "stop_right_frac": np.zeros(n, np.float32),
        "stop_both_frac": np.zeros(n, np.float32),
        "bearer_frac": np.zeros(n, np.float32),
        "guards": np.zeros(n, np.float32),
        # postal
        "pitch": np.ones(n, np.float32),
        "levels": np.zeros((n, _N_POSTAL), np.float32),
        "updown": np.zeros((n, _N_POSTAL), np.float32),
        "align": np.zeros(n, np.int32),  # 0 bottom, 1 center, 2 4-state
        # 2D
        "mod_div": np.full(n, 10, np.float32),
        "finder": np.zeros(n, np.int32),
    }
    for c, name in enumerate(class_names):
        g = _group_id(name)
        t["group"][c] = g
        crng = _class_rng(name)
        if g == _G1D:
            style = _1D_STYLE.get(name, dict(module=3, duty=0.5))
            duty = float(style["duty"])
            wf = (1.0 - duty) / duty
            dark = crng.integers(1, 3, _N_RUNS).astype(np.float64)
            white = crng.integers(1, 3, _N_RUNS).astype(np.float64) * wf
            gaps = bool(style.get("gaps"))
            for p in range(_N_RUNS):
                x = 0.0
                for i in range(_N_RUNS):
                    j = (p + i) % _N_RUNS
                    t["bounds"][c, p, 2 * i] = x + dark[j]
                    x += dark[j] + white[j]
                    if gaps and (i + 1) % 4 == 0:
                        # Code39: inter-char gap after every 4th drawn bar
                        x += 3.0 * wf
                    t["bounds"][c, p, 2 * i + 1] = x
            t["module"][c] = float(style["module"])
            t["band_frac"][c] = 0.28 if style.get("band") else 0.0
            t["quiet_frac"][c] = 0.12 if style.get("quiet") else 0.0
            t["stop_right_frac"][c] = 0.10 if style.get("stop_right") else 0.0
            t["stop_both_frac"][c] = 0.08 if style.get("stop_both") else 0.0
            t["bearer_frac"][c] = 0.12 if style.get("bearer") else 0.0
            t["guards"][c] = 1.0 if style.get("guards") else 0.0
        elif g == _GPOSTAL:
            pstyle = {
                "Postnet": dict(pitch=4, levels=(0.45, 1.0), align="bottom"),
                "IntelligentMail": dict(pitch=5, levels=(0.4, 0.7, 1.0), align="4state"),
                "JapanPost": dict(pitch=7, levels=(0.5, 0.75, 1.0), align="center"),
                "RoyalMail": dict(pitch=3, levels=(0.4, 0.7, 1.0), align="4state"),
            }.get(name, dict(pitch=4, levels=(0.45, 0.7, 1.0), align="center"))
            t["pitch"][c] = float(pstyle["pitch"])
            t["levels"][c] = crng.choice(pstyle["levels"], _N_POSTAL)
            t["updown"][c] = crng.integers(0, 2, _N_POSTAL)
            t["align"][c] = {"bottom": 0, "center": 1, "4state": 2}[pstyle["align"]]
        else:  # 2D — same draw order as synthetic._render_barcode
            t["mod_div"][c] = float(crng.integers(8, 16))
            t["finder"][c] = int(crng.integers(0, 4))
    return t


@functools.lru_cache(maxsize=8)
def _device_tables(class_names: tuple[str, ...], dev: torch.device) -> dict:
    """``build_class_tables`` as tensors on ``dev``, copied there once (a
    copy to the card synchronizes, so never inside a step)."""
    return {k: torch.from_numpy(v).to(dev, torch.int64 if v.dtype == np.int32 else torch.float32)
            for k, v in build_class_tables(class_names).items()}


# uint32 multipliers of the hash, as int64 values congruent mod 2^32 and
# below 2^31 in magnitude: a product with a value below 2^32 stays inside
# int64 and its low 32 bits are the uint32 product's
_HASH_K = [k - 2**32 if k >= 2**31 else k for k in (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x2C1B3C6D, 0x297A2D39)]


def _hash01(r: torch.Tensor, c: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Deterministic per-cell uniform in [0, 1): the JAX package's uint32
    integer mix of (r, c, seed), in int64 with the wraparound masked
    (``>>`` on a masked non-negative value is the logical shift), then
    rounded to f32 and divided by 2^32.  r and c are small integers (a
    negative one wraps as a uint32 cast does); seeds may reach 2^32."""
    k1, k2, k3, k4, k5 = _HASH_K
    h = (r.to(torch.int64) * k1 ^ c.to(torch.int64) * k2 ^ (seed.to(torch.int64) & _M32) * k3) & _M32
    h = h ^ (h >> 15)
    h = (h * k4) & _M32
    h = h ^ (h >> 12)
    h = (h * k5) & _M32
    h = h ^ (h >> 15)
    return h.to(torch.float32) / float(2**32)


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def _fma_sep(a, x_col, y_row, b, c) -> torch.Tensor:
    """``fma(a, x, fl32(b * y)) + c`` — XLA's contraction of ``a*x + b*y +
    c`` under ``jit``, rounded the same way here (a texel decision can flip
    on one ulp of a coordinate) — over an outer grid of x (..., 1, X) and
    y (..., Y, 1): the products are taken on the small axes (the f64
    product of two f32 values is exact), and only the f64 sum, its
    rounding to f32 and ``+ c`` run a pixel each."""
    return (_f64(a) * _f64(x_col) + _f64(b * y_row)).to(torch.float32) + c


def _rdiv(v: float, t: torch.Tensor) -> torch.Tensor:
    """``v / t`` rounded once (torch computes ``float / tensor`` as
    ``reciprocal(t) * v``, two roundings)."""
    return torch.full_like(t, v) / t


def _col(t: torch.Tensor) -> torch.Tensor:
    """A per-object (N,) value as an (N, 1) column against (N, L) pixels."""
    return t.view(-1, 1)


_INF = float("inf")


def _in_intervals(u: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Whether each u (N, L) lies in any of its object's half-open intervals
    [starts, ends) (N, K): the intervals that have begun at u outnumber
    those that have ended (exact for overlapping ones; an interval set to
    [inf, inf) is off) — two binary searches instead of 2K compares."""
    def count(bounds):
        return torch.searchsorted(torch.sort(bounds, dim=1).values, u, right=True)

    return count(starts) > count(ends)


def _texel_1d(u, v, bw, bh, module_px, phase, T, c):
    """1D symbology texel, True where dark: u, v (N, L) object-frame
    coordinates; bw, bh, module_px (N, 1); phase, c (N,) int.  The JAX
    package's decisions, each interval test as its thresholds compare."""
    bf = _col(T["band_frac"][c])
    qf = _col(T["quiet_frac"][c])
    srf = _col(T["stop_right_frac"][c])
    sbf = _col(T["stop_both_frac"][c])
    bear = _col(T["bearer_frac"][c])
    band_h = torch.clamp(torch.floor(bf * bh), min=3.0) * (bf > 0)
    y1 = bh - 1.0 - band_h
    x0 = torch.where(qf > 0, torch.clamp(torch.floor(qf * bw), min=3.0), 1.0)
    x1 = torch.where(qf > 0, bw - x0, bw - 1.0)
    # stop blocks: [bw-1-sw_r, bw-1), [1, 1+sw_b) and [bw-1-sw_b, bw-1)
    sw_r = torch.clamp(torch.floor(srf * bw), min=6.0)
    sw_b = torch.clamp(torch.floor(sbf * bw), min=5.0)
    has_sr = srf > 0
    has_sb = sbf > 0
    in_y = (v >= 1.0) & (v < bh - 1.0)
    starts = torch.cat([torch.where(has_sr, bw - 1.0 - sw_r, _INF), torch.where(has_sb, 1.0, _INF),
                        torch.where(has_sb, bw - 1.0 - sw_b, _INF)], 1)
    ends = torch.cat([torch.where(has_sr, bw - 1.0, _INF), torch.where(has_sb, 1.0 + sw_b, _INF),
                      torch.where(has_sb, bw - 1.0, _INF)], 1)
    stop_dark = in_y & _in_intervals(u, starts, ends)
    pad = torch.clamp(module_px, min=2.0)
    x1 = torch.where(has_sr, bw - 1.0 - sw_r - pad, x1)
    x0 = torch.where(has_sb, 1.0 + sw_b + pad, x0)
    x1 = torch.where(has_sb, bw - 1.0 - sw_b - pad, x1)
    # stripe field: position in module units through the class's phase-p
    # boundary table, linear from the field start.  JAX counts the
    # boundaries <= s with a (pixels, 192) compare; a row strictly
    # increases, so it is a binary search.  A 0 put in front makes u >= x0
    # (s >= 0; u - x0 is never subnormal) the first boundary, so dark is an
    # odd count, and the last boundary dropped ends the field (JAX's
    # s < bounds[-1]).
    s = (u - x0) / torch.clamp(module_px, min=1e-3)
    bounds = T["bounds"][c, phase]  # (N, 192)
    bounds = torch.cat([torch.zeros_like(bounds[:, :1]), bounds[:, :-1]], 1)
    seg = torch.searchsorted(bounds, s, right=True)
    stripe_dark = ((seg & 1) == 1) & (u < x1) & (v >= 1.0) & (v < y1)
    # EAN13-style guard pairs descend through the text band: [gx, gx+gm)
    # and [g2, g2+gm) at three places
    fm = torch.floor(module_px)
    gm = torch.clamp(fm, min=1.0)
    on = _col(T["guards"][c]) > 0
    gs, ge = [], []
    for gx in (x0, torch.floor((x0 + x1) / 2.0), x1 - 2.0 - fm):
        gx = torch.minimum(torch.clamp(gx, min=1.0), bw - 3.0 - fm)
        g2 = gx + 2.0 * gm
        gs += [torch.where(on, gx, _INF), torch.where(on, g2, _INF)]
        ge += [torch.where(on, gx + gm, _INF), torch.where(on, g2 + gm, _INF)]
    guard_dark = in_y & _in_intervals(u, torch.cat(gs, 1), torch.cat(ge, 1))
    # ITF bearer bars along top and bottom (full width)
    tb = torch.clamp(torch.floor(bear * bh), min=2.0)
    has_bear = bear > 0
    bearer_dark = (v < torch.where(has_bear, tb, -_INF)) | (v >= torch.where(has_bear, bh - tb, _INF))
    marks = guard_dark | bearer_dark
    # the text band is forced white except where guards descend
    in_band = (v >= torch.where(bf > 0, y1, _INF)) & ~marks
    return (stripe_dark | stop_dark | marks) & ~in_band


def _texel_postal(u, v, bw, bh, phase, T, c):
    """Postal texel, True where dark (arguments as ``_texel_1d``'s).  A bar's
    rows depend on its level and up/down entry alone, so they are made for
    the 48 entries of each object and read a pixel by index (JAX's one-hot
    contractions are a TPU workaround)."""
    pitch = _col(T["pitch"][c])
    um1 = u - 1.0
    i = torch.floor(um1 / pitch)
    in_col = (um1 - i * pitch < 2.0) & (u >= 1.0) & (u < bw - 2.0)
    idx = torch.remainder(i.to(torch.int64) + _col(phase), _N_POSTAL)
    # the bar rows of every level-table entry (N, 48)
    frac = T["levels"][c]
    up = T["updown"][c] > 0.5
    bar_h = torch.clamp(torch.floor(bh * frac * 0.85), min=2.0)
    align = _col(T["align"][c])
    mid = torch.floor(bh / 2.0)
    stub = torch.clamp(torch.floor(0.2 * bh), min=1.0)
    r0 = torch.where(
        align == 0, bh - 1.0 - bar_h,
        torch.where(align == 1, torch.floor((bh - bar_h) / 2.0),
                    torch.where(up, mid - bar_h, mid - stub)))
    r1 = torch.where(
        align == 0, bh - 1.0,
        torch.where(align == 1, torch.floor((bh + bar_h) / 2.0),
                    torch.where(up, mid + stub, mid + bar_h)))
    lo = torch.gather(torch.clamp(r0, min=0.0), 1, idx)
    hi = torch.gather(torch.minimum(r1, bh), 1, idx)
    return in_col & (v >= lo) & (v < hi)


_CELLS = _WINDOW // 2  # module cells a side at most: modules are >= 2 px, objects fit the window


def _texel_2d(u, v, bw, bh, seed, T, c):
    """2D texel, True where dark (arguments as ``_texel_1d``'s; ``seed``
    (N,) the object's grid seed).  Every decision past the pixel's module
    cell (r, cc) depends on the cell alone, so it is made on each object's
    (64, 64) cell table — the hash included — and read a pixel by index."""
    N = u.shape[0]
    mod = torch.clamp(torch.floor(torch.minimum(bw, bh) / _col(T["mod_div"][c])), min=2.0)
    gh = torch.clamp(torch.floor((bh - 2.0) / mod), min=1.0).view(N, 1, 1)
    gw = torch.clamp(torch.floor((bw - 2.0) / mod), min=1.0).view(N, 1, 1)
    # the cell table: rows r (1, 64, 1), columns cc (1, 1, 64)
    k = torch.arange(_CELLS, device=u.device)
    r = k.view(1, -1, 1).to(torch.float32)
    cc = k.view(1, 1, -1).to(torch.float32)
    sd = seed.view(N, 1, 1)
    base = _hash01(k.view(1, -1, 1), k.view(1, 1, -1), sd) < 0.5
    style = T["finder"][c].view(N, 1, 1)
    fs = torch.clamp(torch.floor(torch.minimum(gh, gw) / 4.0), min=2.0)

    # style 0: QR corner rings (outer ring dark, inner hollow when fs > 2)
    def corner(r0, c0):
        inb = (r >= r0) & (r < r0 + fs) & (cc >= c0) & (cc < c0 + fs)
        inner = ((r >= r0 + 1) & (r < r0 + fs - 1)
                 & (cc >= c0 + 1) & (cc < c0 + fs - 1) & (fs > 2))
        return inb, inner

    o1, i1 = corner(0.0, 0.0)
    o2, i2 = corner(0.0, gw - fs)
    o3, i3 = corner(gh - fs, 0.0)
    s0 = torch.where(o1 | o2 | o3, ~(i1 | i2 | i3), base)
    # style 1: Aztec bullseye — chebyshev rings around the grid center
    cy, cx = torch.floor(gh / 2.0), torch.floor(gw / 2.0)
    cheb = torch.maximum((r - cy).abs(), (cc - cx).abs())
    s1 = torch.where(cheb <= 3.0, torch.remainder(cheb, 2.0) < 0.5, base)
    # style 2: DataMatrix L-border + dashed top/right
    s2 = (base | (cc == 0) | (r == gh - 1) | ((r == 0) & (torch.remainder(cc, 2.0) < 0.5))
          | ((cc == gw - 1) & (torch.remainder(r, 2.0) < 0.5)))
    # style 3: PDF417 start/stop bars + even-row high-density bands
    interior = (cc >= 2) & (cc < gw - 2)
    s3 = ((cc < 2) | (cc >= gw - 2)) | torch.where(
        (torch.remainder(r, 2.0) < 0.5) & interior,
        _hash01(k.view(1, -1, 1), k.view(1, 1, -1), sd + 101) < 0.7, base)
    dark = torch.where(style == 0, s0, torch.where(style == 1, s1, torch.where(style == 2, s2, s3)))
    table = dark & (r < gh) & (cc < gw)  # (N, 64, 64)
    # a pixel's cell: u, v in [1, bw-1) x [1, bh-1) put it at r, cc >= 0
    # and below 64; elsewhere it is off the grid and its read is masked
    rp = torch.floor((v - 1.0) / mod)
    cp = torch.floor((u - 1.0) / mod)
    on = (u >= 1.0) & (v >= 1.0) & (u < bw - 1.0) & (v < bh - 1.0)
    cell = (torch.clamp(rp, 0, _CELLS - 1) * _CELLS + torch.clamp(cp, 0, _CELLS - 1)).to(torch.int64)
    return on & torch.gather(table.view(N, -1), 1, cell)


@dataclasses.dataclass(frozen=True)
class SynthConfig:
    """Static parameters of the on-device generator."""

    hw: tuple[int, int] = (256, 256)
    n_objects: tuple[int, int] = (1, 4)
    max_polys: int = 8
    max_verts: int = 8
    class_names: tuple[str, ...] = DEFAULT_CLASS_NAMES
    margin: int = 8


def _grid(sc: SynthConfig) -> int:
    """Cells a side of the placement grid."""
    return max(1, math.ceil(math.sqrt(max(sc.max_polys, sc.n_objects[1]))))


def scene_draws(g: torch.Generator, sc: SynthConfig, n: int) -> dict:
    """Every random value of ``n`` scenes, drawn from ``g`` on its device:
    per scene the object count ``n``, the background ``base`` and its
    (H, W) unit ``noise``, the placement ``cells`` (the first P of a
    permutation of the grid's cells); per object (n, P) the class ``c``,
    the sizes ``bw`` and ``bh``, the rotation coin ``rot_u`` and angle
    ``ang`` (degrees), the jitters ``jx`` and ``jy``, the module-scale
    factor ``module_u``, the phases ``phase1d`` and ``phasep`` and the 2D
    grid seed ``seed2d``.  The ranges are ``generate_scene``'s."""
    H, W = sc.hw
    P = sc.max_polys
    gg = _grid(sc)
    dev = g.device
    bw_hi = max(41.0, min(108.0, W / 2))
    bh_hi = max(25.0, min(60.0, H / 3))

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    return {
        "n": randint(sc.n_objects[0], sc.n_objects[1] + 1, (n,)),
        "base": _uniform(g, (n,), 170.0, 240.0),
        "noise": torch.randn((n, H, W), generator=g, device=dev, dtype=torch.float32),
        # a uniform permutation: the order of iid uniforms
        "cells": torch.rand((n, gg * gg), generator=g, device=dev).argsort(dim=1)[:, :P],
        "c": randint(0, len(sc.class_names), (n, P)),
        "bw": _uniform(g, (n, P), 40.0, bw_hi),
        "bh": _uniform(g, (n, P), 24.0, bh_hi),
        "rot_u": _uniform(g, (n, P), 0.0, 1.0),
        "ang": _uniform(g, (n, P), -30.0, 30.0),
        "jx": _uniform(g, (n, P), -1.0, 1.0),
        "jy": _uniform(g, (n, P), -1.0, 1.0),
        "module_u": _uniform(g, (n, P), 0.9, 1.15),
        "phase1d": randint(0, _N_RUNS, (n, P)),
        "phasep": randint(0, _N_POSTAL, (n, P)),
        "seed2d": randint(0, 2**31 - 1, (n, P)),
    }


def render_scenes(
    draws: dict,
    sc: SynthConfig,
    affine: torch.Tensor | None = None,
    fill: float = 255.0,
):
    """The scenes of ``scene_draws``, rendered on the draws' device.

    Returns (imgs (B, H, W) f32 in [0, 255], polys (B, P, V, 2) f32,
    n_verts (B, P) int32, class_ids (B, P) int32) — the batch contract of
    ``data.pad_polygons`` over the host generator.

    ``affine``: optional (B, 2, 3) forward augmentation affines (scene
    coords -> output coords, ``ops.augment.affine_from_draws``), composed
    into the render: texel coordinates map each output pixel through the
    inverse affine into the object's frame, the polygons get the forward
    affine, and out-of-frame background becomes ``fill`` through the warp's
    1-px coverage edge.  Objects are shrunk so that their post-affine
    radius fits the render window (so an identity affine reproduces the
    scene without one).
    """
    H, W = sc.hw
    P = sc.max_polys
    gg = _grid(sc)
    cell_h = (H - 2 * sc.margin) / gg
    cell_w = (W - 2 * sc.margin) / gg
    wsy, wsx = min(_WINDOW, H), min(_WINDOW, W)
    B = draws["n"].shape[0]
    dev = draws["n"].device
    T = _device_tables(tuple(sc.class_names), dev)

    n = torch.clamp(draws["n"], max=P)
    # the background's values are continuous (no decision reads them): f32
    # as written, within an ulp of XLA's contracted multiply-adds
    img = draws["base"].view(B, 1, 1) + 6.0 * draws["noise"]
    if affine is not None:
        inv = _invert_affine(affine)  # (B, 2, 3)
        # similarity affines: |det| = s_g^2
        s_g = torch.sqrt((affine[:, 0, 0] * affine[:, 1, 1] - affine[:, 0, 1] * affine[:, 1, 0]).abs())
        # out-of-frame background -> fill, with the warp's 1-px edge
        yy = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
        xx = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
        i = inv.view(B, 6, 1, 1).unbind(1)
        sx = _fma_sep(i[0], xx, yy, i[1], i[2])
        sy = _fma_sep(i[3], xx, yy, i[4], i[5])
        w_in = (torch.clamp(sx + 1.0, 0.0, 1.0) * torch.clamp(W - sx, 0.0, 1.0)
                * torch.clamp(sy + 1.0, 0.0, 1.0) * torch.clamp(H - sy, 0.0, 1.0))
        img = img * w_in + fill * (1.0 - w_in)

    # per object (B, P)
    c = draws["c"]
    active = torch.arange(P, device=dev) < n[:, None]
    grp = T["group"][c]
    bw = draws["bw"]
    bh = torch.where(grp == _GPOSTAL, torch.clamp(draws["bh"] / 2.0, min=12.0), draws["bh"])
    ang = torch.where(draws["rot_u"] < 0.5, draws["ang"], 0.0) * (math.pi / 180.0)
    # cos and sin correctly rounded to f32 (through f64), so that the card,
    # the host CPU and XLA's (correctly rounded but for ~2% of sines) agree
    ang64 = ang.to(torch.float64)
    cth, sth = torch.cos(ang64).to(torch.float32), torch.sin(ang64).to(torch.float32)
    ext_x = cth.abs() * bw / 2 + sth.abs() * bh / 2
    ext_y = sth.abs() * bw / 2 + cth.abs() * bh / 2
    # shrink to fit the cell, 6 px of clearance a side (disjoint objects)
    s = torch.clamp(torch.minimum(
        _rdiv(cell_w / 2 - 6.0, torch.clamp(ext_x, min=1e-3)),
        _rdiv(cell_h / 2 - 6.0, torch.clamp(ext_y, min=1e-3))), max=1.0)
    if affine is not None:
        # cap the post-affine radius at the render window (ws/2 - 2)
        r0 = torch.sqrt((bw / 2) * (bw / 2) + (bh / 2) * (bh / 2))
        s = torch.minimum(s, _rdiv(min(wsy, wsx) / 2.0 - 2.0, torch.clamp(s_g[:, None] * r0, min=1e-3)))
    bw, bh, ext_x, ext_y = bw * s, bh * s, ext_x * s, ext_y * s
    cells = draws["cells"]
    row = torch.div(cells, gg, rounding_mode="floor").to(torch.float32)
    col = torch.remainder(cells, gg).to(torch.float32)
    cx0 = sc.margin + col * cell_w + cell_w / 2
    cy0 = sc.margin + row * cell_h + cell_h / 2
    cx = _fma(draws["jx"], torch.clamp(cell_w / 2 - ext_x - 6.0, min=0.0), cx0)
    cy = _fma(draws["jy"], torch.clamp(cell_h / 2 - ext_y - 6.0, min=0.0), cy0)
    module_px = T["module"][c] * draws["module_u"]

    # corners: (signs * half) @ rot.T + centre
    k4 = torch.arange(4, device=dev)  # made on the device: a host copy would synchronize
    sgn_x = torch.where((k4 == 1) | (k4 == 2), 1.0, -1.0)  # -1, 1, 1, -1
    sgn_y = torch.where(k4 >= 2, 1.0, -1.0)  # -1, -1, 1, 1
    hx = sgn_x * (bw / 2)[..., None]  # (B, P, 4)
    hy = sgn_y * (bh / 2)[..., None]
    corners = torch.stack([hx * cth[..., None] + hy * (-sth)[..., None] + cx[..., None],
                           hx * sth[..., None] + hy * cth[..., None] + cy[..., None]], -1)
    if affine is not None:
        # polygons and window centres in the OUTPUT frame; texel math stays
        # in the pre-affine frame through inv.  Elementwise, not a matmul:
        # the card then rounds as the host CPU does
        a = affine.view(B, 1, 6, 1).unbind(2)
        corners = torch.stack([corners[..., 0] * a[0] + corners[..., 1] * a[1] + a[2],
                               corners[..., 0] * a[3] + corners[..., 1] * a[4] + a[5]], -1)
        a = [t[..., 0] for t in a]
        cxo, cyo = cx * a[0] + cy * a[1] + a[2], cx * a[3] + cy * a[4] + a[5]
    else:
        cxo, cyo = cx, cy
    polys = torch.zeros((B, P, sc.max_verts, 2), dtype=torch.float32, device=dev)
    polys[:, :, :4] = torch.where(active[..., None, None], corners, 0.0)
    n_verts = torch.where(active, 4, 0).to(torch.int32)
    class_ids = torch.where(active, 1 + c, 0).to(torch.int32)

    # each object's window: its centre, clamped in frame
    x0 = torch.clamp(torch.round(cxo).to(torch.int64) - wsx // 2, 0, W - wsx)
    y0 = torch.clamp(torch.round(cyo).to(torch.int64) - wsy // 2, 0, H - wsy)
    N = B * P

    def flat(t):  # (B, P) -> (N, 1)
        return t.reshape(N, 1)

    def col3(t):  # (B, P) or (B,) -> (N, 1, 1)
        return (t if t.dim() == 2 else t[:, None].expand(B, P)).reshape(N, 1, 1)

    # window pixel coordinates in the frame: columns (N, 1, wsx), rows (N, wsy, 1)
    px = torch.arange(wsx, dtype=torch.float32, device=dev).view(1, 1, wsx) + col3(x0.to(torch.float32))
    py = torch.arange(wsy, dtype=torch.float32, device=dev).view(1, wsy, 1) + col3(y0.to(torch.float32))
    cth3, sth3 = col3(cth), col3(sth)
    if affine is None:
        rx = px - col3(cx)  # a column each
        ry = py - col3(cy)  # a row each
        u = _fma_sep(cth3, rx, ry, sth3, col3(bw) / 2)
        v = _fma_sep(cth3, ry, rx, -sth3, col3(bh) / 2)
    else:
        # output pixel -> pre-affine scene coords, then the object's frame
        i = [col3(t) for t in inv.reshape(B, 6).unbind(1)]
        rx = _fma_sep(i[0], px, py, i[1], i[2]) - col3(cx)
        ry = _fma_sep(i[3], px, py, i[4], i[5]) - col3(cy)
        u = torch.addcmul(_f64(sth3 * ry), _f64(rx), _f64(cth3)).to(torch.float32) + col3(bw) / 2
        v = torch.addcmul(_f64(-(sth3 * rx)), _f64(ry), _f64(cth3)).to(torch.float32) + col3(bh) / 2
    u = u.reshape(N, -1)
    v = v.reshape(N, -1)
    bwf, bhf = flat(bw), flat(bh)
    inside = (u >= 0) & (u < torch.where(flat(active), bwf, -_INF)) & (v >= 0) & (v < bhf)
    cf = c.reshape(N)
    d1 = _texel_1d(u, v, bwf, bhf, flat(module_px), draws["phase1d"].reshape(N), T, cf)
    dp = _texel_postal(u, v, bwf, bhf, draws["phasep"].reshape(N), T, cf)
    d2 = _texel_2d(u, v, bwf, bhf, draws["seed2d"].reshape(N), T, cf)
    gf = flat(grp)
    dark = torch.where(gf == _G1D, d1, torch.where(gf == _GPOSTAL, dp, d2))

    # compose: the objects are disjoint, so at most one window pixel lands
    # inside an object at any frame pixel, and a scatter-add of its value
    # + 256 (0 dark, 255 light: exact) marks it and carries it
    b_idx = torch.arange(B, device=dev).repeat_interleave(P)
    obj_pos = ((b_idx * H + y0.reshape(N)) * W + x0.reshape(N)).view(N, 1)
    pix_pos = (torch.arange(wsy, device=dev).view(-1, 1) * W + torch.arange(wsx, device=dev)).view(1, -1)
    frame = torch.zeros(B * H * W, dtype=torch.float32, device=dev)
    frame.index_add_(0, (obj_pos + pix_pos).view(-1),
                     torch.where(inside, torch.where(dark, 256.0, 511.0), 0.0).view(-1))
    frame = frame.view(B, H, W)
    img = torch.where(frame > 0, frame - 256.0, img)
    return torch.clamp(img, 0.0, 255.0), polys, n_verts, class_ids


def synth_raster_window(sc: SynthConfig, net_cfg: NetConfig) -> int:
    """The rasterizer's window (grid px) for synthesized objects: their
    size is capped by the render window, so the GT bound follows from it
    (+6, not +4: rounding the polygons to the grid grows a grid bounding
    box by up to 1 px a side), rounded up to 8 and clipped to the grid."""
    win_in = min(_WINDOW, sc.hw[0], sc.hw[1])
    wn = (win_in - 4) // net_cfg.scale + 6
    return min(-(-wn // 8) * 8, sc.hw[0] // net_cfg.scale, sc.hw[1] // net_cfg.scale)


def synth_batch_step(
    g: torch.Generator,
    sc: SynthConfig,
    net_cfg: NetConfig,
    data_cfg: DataConfig,
    train: bool = True,
    rows: slice | None = None,
) -> dict:
    """One training batch synthesized and finished on ``g``'s device:
    the scenes' draws, then (``train`` with ``data_cfg.augment``) the
    affines' and the photometric draws, all from ``g``; the render with
    the affine composed in (no warp), the photometric jitter, normalize and
    the windowed rasterizer.  Returns the batch contract.

    ``rows``: only those rows of the batch (a mesh entry's shard).  The
    draws are still made for the whole batch, in the same order, so the
    rows equal the whole batch's bit for bit; only they are rendered,
    jittered and rasterized."""
    if data_cfg.raster_window is None:
        data_cfg = dataclasses.replace(data_cfg, raster_window=synth_raster_window(sc, net_cfg))
    b = data_cfg.batch_size
    draws = draw_rows(scene_draws(g, sc, b), rows)
    acfg = data_cfg.augment
    if train and acfg is not None:
        m = affine_from_draws(draw_rows(affine_draws(g, acfg, b), rows), acfg, sc.hw)
        photo = draw_rows(photometric_draws(g, acfg, (b, *sc.hw)), rows)
        imgs, polys, n_verts, class_ids = render_scenes(draws, sc, affine=m, fill=acfg.fill_value)
        imgs = photometric_apply(imgs, photo, acfg)
    else:
        imgs, polys, n_verts, class_ids = render_scenes(draws, sc)
    return finalize_batch(imgs, polys, n_verts, class_ids, net_cfg, data_cfg)


def step_generator(seed: int, epoch: int, step: int, device) -> torch.Generator:
    """The generator of step ``step`` of ``epoch``: seeded from (seed,
    epoch, step) alone, so a run split into chunks of several steps draws
    the same stream as one step at a time."""
    return torch.Generator(device).manual_seed(batch_seed(seed, epoch, step))


class DeviceSyntheticBatches:
    """``Batches``-compatible iterable over scenes synthesized on
    ``device`` (the card unless ``device="cpu"``): the same batch contract,
    with no host collate or copy (``--train-data synthetic-device``)."""

    def __init__(
        self,
        net_cfg: NetConfig,
        data_cfg: DataConfig,
        n_samples: int = 256,
        seed: int = 0,
        n_objects: tuple[int, int] = (1, 4),
        class_names: tuple[str, ...] | None = None,
        train: bool = True,
        device=None,
    ):
        self.net_cfg = net_cfg
        self.data_cfg = data_cfg
        self.n_samples = n_samples
        self.seed = seed
        self.train = train
        self.device = resolve_device(device)
        self.sc = SynthConfig(
            hw=data_cfg.train_hw,
            n_objects=n_objects,
            max_polys=data_cfg.max_polys,
            max_verts=data_cfg.max_verts,
            class_names=tuple(class_names or net_cfg.class_names),
        )

    def __len__(self) -> int:
        return max(1, self.n_samples // self.data_cfg.batch_size)

    def batch_at(self, epoch: int, step: int) -> dict:
        """Step ``step`` of ``epoch``."""
        g = step_generator(self.seed, epoch, step, self.device)
        return synth_batch_step(g, self.sc, self.net_cfg, self.data_cfg, self.train)

    def epoch(self, epoch: int | None = None):
        epoch = 0 if epoch is None else epoch
        for step in range(len(self)):
            yield self.batch_at(epoch, step)

    def __iter__(self):
        return iter(self.epoch(None))

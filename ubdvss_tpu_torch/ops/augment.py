"""Train-time augmentation: random affine warp plus photometric jitter.

Counterpart of ``ubdvss_tpu/ops/augment.py``: random affine (rotation,
scale, translation, flips, optional crop) applied consistently to the image
(inverse-map two-pass resample) and to the GT polygons (forward affine on
the vertices), then brightness/contrast/gaussian noise on the [0, 255]
domain.  Targets are rasterized after augmentation.

Randomness comes from a ``torch.Generator`` (on the images' device); the
JAX package's PRNG streams are not reproduced.  Each factor has its own
draw, as JAX draws each from its own subkey, and the draws are kept apart
from the arithmetic (``affine_draws`` / ``affine_from_draws``,
``photometric_draws`` / ``photometric_apply``), so that the arithmetic can
be held against the JAX package's on JAX's own draws.

``affine_warp`` is the JAX package's two-pass (Catmull-Smith) resample, a
vertical then a horizontal 1-D pass at the positions and lerp weights
``_resample_axis0`` computes there.  The TPU formulation reaches each
pass's source rows through one-hot levels of statically shifted slices and
a two-diagonal matrix product; here a gather along the pass's axis reads
the same rows (edge-replicated, as the JAX pass's padding) with the same
weights.  The result is not bilinear: the composed lerps are about 1 px
softer than the 4-tap oracle ``affine_warp_gather`` on rotations, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    rotation_deg: float = 15.0
    scale_range: tuple[float, float] = (0.7, 1.4)
    translate_frac: float = 0.05
    flip_prob: float = 0.5  # x-mirror probability
    flip_y_prob: float = 0.0  # y-mirror probability (off by default)
    crop_frac: float = 0.0  # random crop: window side in [1-crop_frac, 1]
    brightness: float = 30.0  # additive, 0..255 domain
    contrast_range: tuple[float, float] = (0.8, 1.2)
    noise_std: float = 4.0
    fill_value: float = 255.0  # background fill for out-of-frame samples


def _f32(v: float) -> float:
    """``v`` rounded to f32, as a Python number: the arithmetic with it stays
    f32 and no scalar is copied to the card (which would synchronize)."""
    return float(np.float32(v))


def _uniform(g: torch.Generator, n, lo: float, hi: float) -> torch.Tensor:
    """f32 uniform in [lo, hi) of shape ``n`` (an int or a tuple), as
    ``jax.random.uniform`` maps its unit draw: u * (hi - lo) + lo, then max
    with lo (hi - lo taken in f32)."""
    u = torch.rand(n, generator=g, device=g.device, dtype=torch.float32)
    lo32 = _f32(lo)
    return torch.clamp(u * float(np.float32(hi) - np.float32(lo)) + lo32, min=lo32)


def affine_draws(g: torch.Generator, cfg: AugmentConfig, n: int) -> dict:
    """The random factors of ``n`` affines, one draw a factor: the angle in
    degrees, the scale, the translations as fractions of the frame, the
    two flip uniforms and (with ``crop_frac``) the crop side and its two
    offset uniforms, each (n,) f32 on the generator's device."""
    tf = cfg.translate_frac
    d = {
        "ang": _uniform(g, n, -cfg.rotation_deg, cfg.rotation_deg),
        "sc": _uniform(g, n, cfg.scale_range[0], cfg.scale_range[1]),
        "tx": _uniform(g, n, -tf, tf),
        "ty": _uniform(g, n, -tf, tf),
        "fx": _uniform(g, n, 0.0, 1.0),
        "fy": _uniform(g, n, 0.0, 1.0),
    }
    if cfg.crop_frac > 0.0:
        d["cs"] = _uniform(g, n, 1.0 - cfg.crop_frac, 1.0)
        d["cx"] = _uniform(g, n, 0.0, 1.0)
        d["cy"] = _uniform(g, n, 0.0, 1.0)
    return d


def affine_from_draws(d: dict, cfg: AugmentConfig, hw: tuple[int, int]) -> torch.Tensor:
    """(n, 2, 3) forward affines (about the image center, (x, y) coords)
    from ``affine_draws``: mirror x/y, then rotate and scale, then
    translate; with a crop, zoom the random window to the frame after it."""
    h, w = hw
    ang = d["ang"] * _f32(math.pi / 180.0)  # jnp.radians
    sc = d["sc"]
    tx, ty = d["tx"] * w, d["ty"] * h
    one = torch.ones_like(sc)
    flip_x = torch.where(d["fx"] < cfg.flip_prob, -one, one)
    flip_y = torch.where(d["fy"] < cfg.flip_y_prob, -one, one)
    c, s = torch.cos(ang) * sc, torch.sin(ang) * sc
    r00, r01, r10, r11 = c * flip_x, -s * flip_y, s * flip_x, c * flip_y
    cx, cy = w / 2.0, h / 2.0
    t0 = (cx + tx) - (r00 * cx + r01 * cy)
    t1 = (cy + ty) - (r10 * cx + r11 * cy)
    if cfg.crop_frac > 0.0:
        cs = d["cs"]
        ox = d["cx"] * (1.0 - cs) * w
        oy = d["cy"] * (1.0 - cs) * h
        inv = 1.0 / cs  # eye(2) / cs
        r00, r01, r10, r11 = inv * r00, inv * r01, inv * r10, inv * r11
        t0, t1 = inv * t0 + (-ox / cs), inv * t1 + (-oy / cs)
    return torch.stack([torch.stack([r00, r01, t0], -1), torch.stack([r10, r11, t1], -1)], -2)


def random_affine(g: torch.Generator, cfg: AugmentConfig, hw: tuple[int, int]) -> torch.Tensor:
    """(2, 3) forward affine (about the image center) in (x, y) coords."""
    return affine_from_draws(affine_draws(g, cfg, 1), cfg, hw)[0]


def transform_points(pts: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Forward-affine points: (..., 2) with a (2, 3) matrix, or (B, ..., 2)
    with a (B, 2, 3) stack (one matrix a leading index)."""
    a, t = matrix[..., :2], matrix[..., 2]
    if matrix.ndim == 2:
        return pts @ a.T + t
    shape = (matrix.shape[0],) + (1,) * (pts.ndim - 2) + (2,)
    return torch.einsum("b...j,bij->b...i", pts, a) + t.reshape(shape)


def _invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 2, 3) affines (a singular one divides by 1)."""
    a00, a01, a10, a11 = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a00 * a11 - a01 * a10
    det = torch.where(det == 0, torch.ones_like(det), det)
    i00, i01, i10, i11 = a11 / det, -a01 / det, -a10 / det, a00 / det
    t0, t1 = m[..., 0, 2], m[..., 1, 2]
    it0 = -i00 * t0 + -i01 * t1
    it1 = -i10 * t0 + -i11 * t1
    return torch.stack([torch.stack([i00, i01, it0], -1), torch.stack([i10, i11, it1], -1)], -2)


def affine_warp_gather(img: torch.Tensor, matrix: torch.Tensor, fill: float) -> torch.Tensor:
    """Reference warp of one (H, W) image: per-pixel 4-tap bilinear gather
    (the exact semantics; the oracle for ``affine_warp``)."""
    h, w = img.shape
    inv = _invert_affine(matrix)
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device), indexing="ij")
    src = transform_points(torch.stack([gx, gy], -1), inv)
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    x0i, y0i = x0.long(), y0.long()

    def tap(yi, xi):
        v = img[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        return torch.where(ok, v, fill)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x0i + 1) * fx
    bot = tap(y0i + 1, x0i) * (1 - fx) + tap(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


def _resample_axis0(
    img: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
    fill: float, max_shear: float,
) -> torch.Tensor:
    """1-D resample of (B, Hs, W) images along axis 1 at source rows
    V(y, x) = a*y + b + c*x (one (B,) coefficient each; column x
    unchanged), constant ``fill`` outside [0, Hs).

    The JAX pass first shears: column x reads rows F(x) + j of the
    edge-padded image, lerped by fr(x), where Q = c*(x - W/2) + ext is
    clipped to [0, 2*ext - 1.001] and split as F = floor(Q), fr = Q - F;
    then it scales: output row y lerps the sheared rows i0(y) and
    i0(y) + 1 by f0(y), from kf = a*y + b + c*W/2 + ext clipped to
    [0, jm - 1.5].  Composed, output (y, x) reads rows r, r+1, r+2 of the
    image, r = i0 + F - 2*ext, clamped (the padding replicates the edge),
    with those weights; then the exact 1-px partial-fill coverage on the
    true source position blends in ``fill``.  |c| must be <= max_shear.
    """
    B, hs, w0 = img.shape
    ext = int(math.ceil(max_shear * w0 / 2)) + 4
    jm = hs + 2 * ext
    xs = torch.arange(w0, dtype=torch.float32, device=img.device)
    ys = torch.arange(hs, dtype=torch.float32, device=img.device)
    q = c[:, None] * (xs - w0 / 2.0)  # (B, W)
    Q = torch.clamp(q + ext, 0.0, 2.0 * ext - 1.001)
    F = torch.floor(Q)
    fr = (Q - F)[:, None, :]
    p = a[:, None] * ys + b[:, None] + c[:, None] * (w0 / 2.0)  # (B, Hs)
    kf = torch.clamp(p + ext, 0.0, jm - 1.5)
    i0 = torch.floor(kf)
    f0 = (kf - i0)[:, :, None]
    r = (i0.long()[:, :, None] + F.long()[:, None, :]) - 2 * ext  # (B, Hs, W)

    def rows(k):
        return torch.gather(img, 1, (r + k).clamp(0, hs - 1))

    x0, x1, x2 = rows(0), rows(1), rows(2)
    lo = (1.0 - fr) * x0 + fr * x1
    hi = (1.0 - fr) * x1 + fr * x2
    out = (1.0 - f0) * lo + f0 * hi
    v = p[:, :, None] + q[:, None, :]
    w_in = torch.clamp(v + 1.0, 0.0, 1.0) * torch.clamp(hs - v, 0.0, 1.0)
    return out * w_in + fill * (1.0 - w_in)


def affine_warp(
    img: torch.Tensor, matrix: torch.Tensor, fill: float, max_shear: float = 0.62
) -> torch.Tensor:
    """Warp (H, W) images by forward (2, 3) affines — or (B, H, W) by
    (B, 2, 3) — with the JAX package's two-pass resample (module
    docstring), constant fill.  ``max_shear`` must bound both passes' shear
    coefficients |m10/m00| and |m01|; the default 0.62 covers rotations to
    ~31 deg with inverse scale up to ~1.45.  |m00| is clamped away from 0
    (rotations near 90 deg are out of the supported domain)."""
    if img.ndim == 2:
        return affine_warp(img[None], matrix[None], fill, max_shear)[0]
    inv = _invert_affine(matrix)
    i00 = inv[:, 0, 0]
    m00 = torch.where(i00.abs() < 0.05, torch.where(i00 < 0, -0.05, 0.05), i00)
    m01, tx = inv[:, 0, 1], inv[:, 0, 2]
    m10, m11, ty = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    # pass 1 (vertical): V(y, xi) = (m11 - m10*m01/m00)*y + (ty - m10*tx/m00)
    #                               + (m10/m00)*xi
    tmp = _resample_axis0(
        img, m11 - m10 * m01 / m00, ty - m10 * tx / m00, m10 / m00, fill, max_shear
    )
    # pass 2 (horizontal): U(y, xo) = m00*xo + tx + m01*y, on the transpose
    out_t = _resample_axis0(tmp.transpose(1, 2), m00, tx, m01, fill, max_shear)
    return out_t.transpose(1, 2)


def photometric_draws(g: torch.Generator, cfg: AugmentConfig, shape: tuple) -> dict:
    """The photometric draws of a (B, H, W) batch: brightness and contrast
    (B,) and unit gaussian noise (B, H, W), f32 on the generator's device."""
    n = shape[0]
    return {
        "b": _uniform(g, n, -cfg.brightness, cfg.brightness),
        "c": _uniform(g, n, cfg.contrast_range[0], cfg.contrast_range[1]),
        "noise": torch.randn(shape, generator=g, device=g.device, dtype=torch.float32),
    }


def photometric_apply(img: torch.Tensor, d: dict, cfg: AugmentConfig) -> torch.Tensor:
    """Brightness/contrast/noise on the [0, 255] domain, clipped back:
    (B, H, W) images with ``photometric_draws``."""
    out = (img - 127.5) * d["c"][:, None, None] + 127.5 + d["b"][:, None, None]
    out = out + d["noise"] * cfg.noise_std
    return torch.clamp(out, 0.0, 255.0)


def max_shear_for(cfg: AugmentConfig) -> float:
    """The warp's shear bound for a config: pass 1's shear is |tan(rot)|,
    pass 2's |m01| <= sin(rot) / scale_min (inverse upscale)."""
    th = math.radians(min(abs(cfg.rotation_deg), 85.0))
    return max(math.tan(th), math.sin(th) / max(cfg.scale_range[0], 0.1), 0.05) + 0.02


def draw_rows(d: dict, rows: slice | None) -> dict:
    """Those rows of every draw (each has the batch's leading dim); all of
    them for None."""
    return d if rows is None else {k: v[rows] for k, v in d.items()}


def augment_batch(
    g: torch.Generator,
    imgs: torch.Tensor,
    polys: torch.Tensor,
    cfg: AugmentConfig,
    n_draws: int | None = None,
    rows: slice | None = None,
):
    """(B, H, W) [0, 255] images + (B, P, V, 2) polys -> the augmented
    pair: a random affine a sample (its factors drawn first, for the whole
    batch), the two-pass warp, then the photometric jitter.

    ``n_draws`` and ``rows``: the images are the ``rows`` of a batch of
    ``n_draws`` (a shard of it, on a mesh); the draws are made for the
    whole batch, so each row gets the draws it gets in the whole batch."""
    n = imgs.shape[0] if n_draws is None else n_draws
    hw = tuple(imgs.shape[1:])
    m = affine_from_draws(draw_rows(affine_draws(g, cfg, n), rows), cfg, hw)
    out = affine_warp(imgs, m, cfg.fill_value, max_shear=max_shear_for(cfg))
    out = photometric_apply(out, draw_rows(photometric_draws(g, cfg, (n, *hw)), rows), cfg)
    return out, transform_points(polys, m)


def augment_sample(g: torch.Generator, img: torch.Tensor, polys: torch.Tensor, cfg: AugmentConfig):
    """One sample: (H, W) [0, 255] image + (P, V, 2) polys -> augmented pair."""
    out, p = augment_batch(g, img[None], polys[None], cfg)
    return out[0], p[0]

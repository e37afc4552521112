"""PyTorch port: min-area rect selection (K3) plain version held against the
JAX package's compacted Pallas kernel in interpret mode (CPU).

Rows agree within 1e-4 and ``any_edge`` is identical.  One difference is
allowed, and it selects the same rectangle: when two hull edges have folded
caliper angles that are equal in exact arithmetic (perpendicular sides of
a rectangle, or parallel edges of different length), the tie goes to the
smaller computed angle, which the last bit of ``rsqrt`` decides; XLA's CPU
``rsqrt`` and torch's round differently, so such a component may report the
other side of the same rectangle.  There the corners must match as a set
and the area must agree, the parity the JAX tests use against cv2
(tests/helpers.py)."""

from itertools import permutations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu.ops.pallas.rect_kernel import min_area_rect_select as jax_rect_select
from ubdvss_tpu_torch.ops.cuda.rect_kernel import (
    min_area_rect_select,
    rects_from_selection,
)

torch.set_num_threads(1)

_PERMS = np.array(list(permutations(range(4))))


def same_corner_sets(a: np.ndarray, b: np.ndarray, atol: float) -> np.ndarray:
    """(..., 4, 2) boxes -> (...) bool: b's corners are a's in some order."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.linalg.norm(a[..., :, None, :] - b[..., None, :, :], axis=-1)  # (..., 4, 4)
    per = d[..., np.arange(4), _PERMS]  # (..., 24, 4)
    return per.max(-1).min(-1) <= atol


def assert_same_boxes(a, b, atol=1e-4):
    """Boxes equal within atol up to the order of their corners."""
    ok = same_corner_sets(a, b, atol)
    assert ok.all(), np.argwhere(~ok)


def assert_rect_rows_equivalent(out: np.ndarray, ref: np.ndarray, atol=1e-4) -> int:
    """(B, 9, K) rows equal within atol, or the same rectangle (see the
    module docstring); returns how many components took the other side."""
    np.testing.assert_array_equal(out[:, 6], ref[:, 6])
    close = np.all(np.abs(out - ref) <= atol, axis=1)
    if close.all():
        return 0
    ro = rects_from_selection(torch.from_numpy(out))
    rr = rects_from_selection(torch.from_numpy(ref))
    flip = ~close
    assert same_corner_sets(ro["points"].numpy(), rr["points"].numpy(), atol)[flip].all()
    area_o = ro["size"].prod(-1).numpy()[flip]
    area_r = rr["size"].prod(-1).numpy()[flip]
    np.testing.assert_allclose(area_o, area_r, atol=atol, rtol=1e-6)
    return int(flip.sum())


def _extremes(masks: np.ndarray):
    """(B, K, H, W) bool -> per-row minx/maxx (B, K, H) int32."""
    W = masks.shape[-1]
    cols = np.arange(W)
    minx = np.where(masks, cols, 1 << 30).min(-1).astype(np.int32)
    maxx = np.where(masks, cols, -1).max(-1).astype(np.int32)
    return minx, maxx


def _rotated_rect(H, W, cx, cy, w, h, ang):
    yy, xx = np.mgrid[0:H, 0:W]
    c, s = np.cos(np.radians(ang)), np.sin(np.radians(ang))
    u = (xx - cx) * c + (yy - cy) * s
    v = -(xx - cx) * s + (yy - cy) * c
    return (np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)


def shape_masks(seed, B=3, K=8, H=32, W=32):
    """Rotated rectangles, tall bars (more rows than M), single rows,
    single pixels, thin diagonal bars and empty (padding) slots."""
    rng = np.random.default_rng(seed)
    m = np.zeros((B, K, H, W), bool)
    for b in range(B):
        for k in range(K):
            kind = (b * K + k) % 7
            if kind == 0:
                m[b, k] = _rotated_rect(
                    H, W, *rng.uniform(12, 20, 2), *rng.uniform(5, 16, 2),
                    rng.uniform(-45, 45),
                )
            elif kind == 1:  # tall axis-aligned bar: > M collinear chain points
                x0, y0 = rng.integers(2, 20), rng.integers(0, 6)
                m[b, k, y0 : y0 + rng.integers(20, 26), x0 : x0 + rng.integers(1, 5)] = True
            elif kind == 2:  # single row
                y, x0 = rng.integers(0, H), rng.integers(0, 20)
                m[b, k, y, x0 : x0 + rng.integers(1, 10)] = True
            elif kind == 3:  # single pixel
                m[b, k, rng.integers(0, H), rng.integers(0, W)] = True
            elif kind == 4:  # thin diagonal bar
                m[b, k] = _rotated_rect(
                    H, W, 16, 16, rng.uniform(18, 30), 1.5, rng.uniform(20, 70)
                )
            elif kind == 5:  # blob with a notch (concave chains)
                m[b, k, 4:24, 6:22] = True
                m[b, k, 10:16, 6 : 6 + rng.integers(2, 10)] = False
            # kind 6: empty slot
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rect_select_matches_pallas_interpret(seed):
    minx, maxx = _extremes(shape_masks(seed))
    ref = np.asarray(
        jax_rect_select(jnp.asarray(minx), jnp.asarray(maxx), interpret=True, max_points=8)
    )
    out = min_area_rect_select(torch.from_numpy(minx), torch.from_numpy(maxx), 8).numpy()
    assert out.shape == ref.shape == (3, 9, 8)
    assert_rect_rows_equivalent(out, ref)


def test_rect_rects_from_selection_matches_jax():
    """Corner/centre/size/angle reconstruction from identical rows."""
    from ubdvss_tpu.ops.pallas.rect_kernel import rects_from_selection as jax_rects

    minx, maxx = _extremes(shape_masks(5))
    sel = np.asarray(
        jax_rect_select(jnp.asarray(minx), jnp.asarray(maxx), interpret=True, max_points=8)
    )
    ref = jax_rects(jnp.asarray(sel))
    out = rects_from_selection(torch.from_numpy(np.array(sel)))
    for key in ("points", "center", "size", "angle_deg"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4, err_msg=key)


def test_rect_compaction_keeps_first_m_points():
    """A tall bar has more than M collinear points per chain: only the first
    M by rank feed the caliper directions and projections, on the TPU and
    here alike."""
    m = np.zeros((1, 1, 32, 32), bool)
    m[0, 0, 2:26, 5:8] = True
    minx, maxx = _extremes(m)
    out = min_area_rect_select(torch.from_numpy(minx), torch.from_numpy(maxx), 8)
    ref = np.asarray(
        jax_rect_select(jnp.asarray(minx), jnp.asarray(maxx), interpret=True, max_points=8)
    )
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)
    with pytest.raises(NotImplementedError, match="K3x"):
        min_area_rect_select(torch.from_numpy(minx), torch.from_numpy(maxx), 32)

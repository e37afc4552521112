"""PyTorch port: the XLA route's rect fit (``ops/rect.py``) held against the
JAX package's on the inputs of tests/test_rect.py — random point sets,
the degenerate ones (empty, one point, collinear), an axis-aligned
rectangle, a 90°-rotated set, blob and bar masks, the multi-blob fuzz
masks, the compaction case and tilted ellipses rotated by 90° and mirrored
(exact mirror ties) — plus small helpers against theirs.

``monotone_chain_hull``: hull slots [0, m) and m identical.  The rect
functions: ``valid`` identical, corner sets within 1e-4
(``same_corner_sets``), sizes within 1e-4, centres within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rect import same_corner_sets

from ubdvss_tpu.ops import rect as jrect
from ubdvss_tpu_torch.ops import rect as prect

torch.set_num_threads(1)
ATOL = 1e-4


def _pad(pts, n_slots):
    out = np.zeros((n_slots, 2), np.int32)
    out[: len(pts)] = pts
    valid = np.zeros(n_slots, bool)
    valid[: len(pts)] = True
    return out, valid


def assert_rects_match(got: dict, want: dict):
    """Rect dicts with any leading dims: valid identical, corners as sets,
    sizes and centres within 1e-4."""
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert same_corner_sets(got["points"], want["points"], ATOL).all()
    np.testing.assert_allclose(got["size"], want["size"], atol=ATOL)
    np.testing.assert_allclose(got["center"], want["center"], atol=ATOL)


def _point_sets():
    rng = np.random.default_rng(0)  # tests/test_rect.py's hull sets
    sets = [rng.integers(0, 50, (int(rng.integers(1, 60)), 2)) for _ in range(10)]
    rng = np.random.default_rng(1)  # its min_area_rect sets
    sets += [rng.integers(0, 100, (int(rng.integers(3, 80)), 2)) for _ in range(15)]
    pts = np.random.default_rng(2).integers(0, 60, (20, 2))
    sets += [pts, np.stack([pts[:, 1], -pts[:, 0] + 60], 1)]  # and rotated by 90°
    sets += [np.zeros((0, 2)), np.array([[3, 4]] * 3), np.array([[0, 0], [2, 2], [5, 5], [3, 3]]),
             np.array([[10, 20], [30, 20], [30, 25], [10, 25]])]
    return [np.asarray(s, np.int32) for s in sets]


POINT_SETS = _point_sets()


@pytest.mark.parametrize("i", range(len(POINT_SETS)))
def test_hull_and_min_area_rect_match_jax(i):
    padded, valid = _pad(POINT_SETS[i], 96)
    hj, mj = jax.jit(jrect.monotone_chain_hull)(jnp.asarray(padded), jnp.asarray(valid))
    hp, mp = prect.monotone_chain_hull(torch.from_numpy(padded), torch.from_numpy(valid))
    assert hp.shape == (97, 2) and hp.dtype == torch.int32
    m = int(mj)
    assert int(mp) == m
    np.testing.assert_array_equal(hp.numpy()[:m], np.asarray(hj)[:m])
    assert_rects_match(prect.min_area_rect(hp, mp), jax.jit(jrect.min_area_rect)(hj, mj))


def _mask_stack():
    """tests/test_rect.py's stack: an ellipse, a rotated bar, one pixel, empty."""
    H = W = 48
    eq = np.zeros((H, W, 4), bool)
    yy, xx = np.mgrid[:H, :W]
    eq[..., 0] = ((yy - 12) / 6.0) ** 2 + ((xx - 30) / 11.0) ** 2 <= 1
    eq[..., 1] = (np.abs((xx - 20) - (yy - 30)) <= 2) & (yy >= 24) & (yy <= 40) & (xx >= 10) & (xx <= 34)
    eq[32, 5, 2] = True
    return eq


def _fuzz_masks():
    """tests/test_rect.py's multi-blob fuzz masks (rotated rectangles)."""
    rng = np.random.default_rng(7)
    H = W = 40
    yy, xx = np.mgrid[:H, :W]
    out = []
    for _ in range(6):
        mask = np.zeros((H, W), bool)
        for _ in range(3):
            cy, cx = rng.integers(5, 35, 2)
            ry, rx = rng.integers(1, 7, 2)
            ang = rng.uniform(0, np.pi)
            dy, dx = yy - cy, xx - cx
            u = dy * np.cos(ang) - dx * np.sin(ang)
            v = dy * np.sin(ang) + dx * np.cos(ang)
            mask |= (np.abs(u) <= ry) & (np.abs(v) <= rx)
        out.append(mask)
    return np.stack(out, -1)


def _tilted_ellipses():
    """tests/test_rect.py's rot90 blobs, each also rotated by 90° and
    mirrored: symmetric shapes whose minimal rects tie exactly."""
    rng = np.random.default_rng(7)
    H = W = 48
    ys, xs = np.mgrid[0:H, 0:W]
    out = []
    for _ in range(3):
        y0, x0 = rng.integers(4, 20, 2)
        hh, ww = rng.integers(8, 20, 2)
        cy, cx = y0 + hh / 2, x0 + ww / 2
        e = (((ys - cy) * 0.8 + (xs - cx) * 0.6) / hh) ** 2 + (((xs - cx) * 0.8 - (ys - cy) * 0.6) / ww) ** 2
        m = e < 0.5
        out += [m, np.rot90(m).copy(), m[:, ::-1].copy()]
    return np.stack(out, -1)


STACKS = {"blobs": _mask_stack(), "fuzz": _fuzz_masks(), "ellipses": _tilted_ellipses()}


@pytest.mark.parametrize("name", list(STACKS))
def test_mask_stack_matches_jax(name):
    eq = STACKS[name]
    assert_rects_match(prect.min_area_rect_from_mask_stack(torch.from_numpy(eq)),
                       jrect.min_area_rect_from_mask_stack(jnp.asarray(eq)))


def _extremes(eq):
    """(H, W, K) masks -> (K, H) minx, maxx, rowvalid as numpy int32/bool."""
    xx = np.arange(eq.shape[1])[None, :, None]
    minx = np.where(eq, xx, 10**6).min(1).T.astype(np.int32)
    maxx = np.where(eq, xx, -1).max(1).T.astype(np.int32)
    return minx, maxx, eq.any(1).T


def _compaction_case():
    """tests/test_rect.py's compaction extremes: (3, 8, 256) rects,
    ellipses, parallelograms and empty slots."""
    rng = np.random.default_rng(1)
    B, K, H = 3, 8, 256
    minx = np.zeros((B, K, H), np.int32)
    maxx = np.full((B, K, H), -1, np.int32)
    for b in range(B):
        for k in range(K):
            kind = rng.integers(0, 4)
            y0 = int(rng.integers(0, H - 50)); h = int(rng.integers(1, 50))  # noqa: E702
            x0 = int(rng.integers(0, H - 80)); w = int(rng.integers(1, 60))  # noqa: E702
            yy = np.arange(y0, y0 + h)
            if kind == 0:
                minx[b, k, y0:y0 + h] = x0
                maxx[b, k, y0:y0 + h] = x0 + w
            elif kind == 1:
                cy = y0 + h / 2
                half = (w / 2) * np.sqrt(np.clip(1 - ((yy - cy) / (h / 2 + 1e-9)) ** 2, 0, 1))
                minx[b, k, y0:y0 + h] = (x0 + w / 2 - half).astype(int)
                maxx[b, k, y0:y0 + h] = (x0 + w / 2 + half).astype(int)
            elif kind == 2:
                minx[b, k, y0:y0 + h] = x0 + (yy - y0)
                maxx[b, k, y0:y0 + h] = x0 + w + (yy - y0)
    return minx, maxx, maxx >= 0


@pytest.mark.parametrize("case", ["fuzz", "ellipses", "compaction"])
@pytest.mark.parametrize("max_points", [None, 64, 4])
def test_from_extremes_match_jax(case, max_points):
    """The exact extremes fit (None) and the compacted one at M = 64 and at
    M = 4 (chains past M lose their lowest rows, on both sides alike)."""
    ex = _compaction_case() if case == "compaction" else _extremes(STACKS[case])
    jx = [jnp.asarray(a) for a in ex]
    px = [torch.from_numpy(np.ascontiguousarray(a)) for a in ex]
    if max_points is None:
        got, want = prect.min_area_rect_from_extremes(*px), jax.jit(jrect.min_area_rect_from_extremes)(*jx)
    else:
        got = prect.min_area_rect_from_extremes_compact(*px, max_points)
        want = jax.jit(jrect.min_area_rect_from_extremes_compact, static_argnums=3)(*jx, max_points)
    assert_rects_match(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_neighbor_and_chain_helpers_match_jax(reverse):
    """The nearest alive neighbour scan (its values everywhere, the wrapped
    slot's too), the convexified chains and their compaction."""
    minx, maxx, rowv = _extremes(STACKS["fuzz"])
    y = np.broadcast_to(np.arange(minx.shape[1], dtype=np.int32), minx.shape)
    want = jrect._scan_neighbor(jnp.asarray(minx), jnp.asarray(y), jnp.asarray(rowv), 1, reverse)
    got = prect._scan_neighbor(torch.from_numpy(minx), torch.from_numpy(y.copy()), torch.from_numpy(rowv), 1, reverse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for x, sign in ((minx, 1), (maxx, -1)):
        x = np.where(rowv, x, 0).astype(np.int32)
        aj = jrect._convexify_chain(jnp.asarray(x), jnp.asarray(rowv), sign)
        ap = prect._convexify_chain(torch.from_numpy(x), torch.from_numpy(rowv), sign)
        np.testing.assert_array_equal(ap.numpy(), np.asarray(aj))
        for g, w in zip(prect._compact_chain(torch.from_numpy(x), ap, 8), jrect._compact_chain(jnp.asarray(x), aj, 8)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

"""PyTorch port: min-area rect selection plain versions, compacted (K3) and
uncompacted (K3x), held against the JAX package's Pallas kernels in
interpret mode (CPU).

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
    # M >= H takes the uncompacted kernel on both sides, as M=None does
    ref_x = np.asarray(
        jax_rect_select(jnp.asarray(minx), jnp.asarray(maxx), interpret=True, max_points=None)
    )
    out_x = min_area_rect_select(torch.from_numpy(minx), torch.from_numpy(maxx), 32).numpy()
    np.testing.assert_allclose(out_x, ref_x, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rect_exact_matches_pallas_interpret(seed):
    """K3x's plain version (no compaction; every valid row's two extremes
    projected) against ``_rect_kernel`` in interpret mode, at H=32 with
    bars of more than M rows; rows within 1e-4, any_edge identical, exact
    ties only as the same rectangle (module docstring).  ``max_points=32``
    (M >= H) and ``None`` give the same rows on both sides."""
    minx, maxx = _extremes(shape_masks(seed))
    mn, mx = jnp.asarray(minx), jnp.asarray(maxx)
    ref = np.asarray(jax_rect_select(mn, mx, interpret=True, max_points=None))
    np.testing.assert_array_equal(
        np.asarray(jax_rect_select(mn, mx, interpret=True, max_points=32)), ref
    )
    tn, tx = torch.from_numpy(minx), torch.from_numpy(maxx)
    out = min_area_rect_select(tn, tx, None).numpy()
    np.testing.assert_array_equal(min_area_rect_select(tn, tx, 32).numpy(), out)
    assert out.shape == ref.shape == (3, 9, 8)
    assert_rect_rows_equivalent(out, ref)


def slope_rule(v: torch.Tensor, alive: torch.Tensor, sign: int) -> torch.Tensor:
    """Plain mirror of the compacted CUDA kernel's slope rule
    (``csrc/rect_kernel.cu``, step 2): an alive row p stays on the chain iff
    the largest slope dx/dy from p back to an earlier alive row is at most
    the smallest slope from p to a later one, slopes compared by integer
    cross-multiplication from the same sentinels; the right chain (sign -1)
    is the rule on -x.  (N, H) int64 x values and alive rows -> (N, H) bool
    kept rows."""
    x = sign * v
    N, H = x.shape
    y = torch.arange(H)
    s = torch.where(alive, v.abs(), 0).amax(1, keepdim=True) + 1
    e_n, e_d = -s.expand(N, H).clone(), torch.ones_like(x)
    f_n, f_d = s.expand(N, H).clone(), torch.ones_like(x)
    for j in range(H):
        aj, xj = alive[:, j : j + 1], x[:, j : j + 1]
        dy = (y - j).expand(N, H)
        take = aj & (y > j) & ((x - xj) * e_d > e_n * dy)
        e_n, e_d = torch.where(take, x - xj, e_n), torch.where(take, dy, e_d)
        take = aj & (y < j) & (f_n * (-dy) > (xj - x) * f_d)
        f_n, f_d = torch.where(take, xj - x, f_n), torch.where(take, -dy, f_d)
    return alive & (e_n * f_d <= f_n * e_d)


def hull_rows(v: torch.Tensor, valid: torch.Tensor, sign: int, rounds: int = 4) -> torch.Tensor:
    """The compacted kernel's hull membership: at most ``rounds`` lockstep
    rounds, then the slope rule over the rows left."""
    from ubdvss_tpu_torch.ops.cuda.rect_kernel import _convexify

    return slope_rule(v, _convexify(v, valid, sign, max_rounds=rounds), sign)


def _chain(rows, H=40):
    """{row: (minx, maxx)} -> (1, H) int64 minx, maxx and valid rows."""
    mn = torch.zeros((1, H), dtype=torch.int64)
    mx = torch.full((1, H), -1, dtype=torch.int64)
    for y, (a, b) in rows.items():
        mn[0, y], mx[0, y] = a, b
    return mn, mx, mx >= 0


def _adversarial_chains():
    rng = np.random.default_rng(0)
    w = 24
    yield "staircase", {y: (y, y + 2) for y in range(40)}
    yield "steep_staircase", {y: (3 * y % 37, 3 * y % 37 + 1) for y in range(40)}
    yield "collinear_run", {y: (5, 9) for y in range(3, 37)}
    yield "collinear_diagonal", {y: (10 + y // 2 * 2 - y % 2, 30) for y in range(40)}
    yield "one_row", {17: (4, 9)}
    yield "one_pixel", {0: (3, 3)}
    yield "two_rows", {5: (2, 8), 30: (6, 6)}
    yield "gaps", {y: (int(rng.integers(0, 10)), int(rng.integers(10, 20))) for y in range(0, 40, 7)}
    yield "zigzag", {y: (5 + 4 * (y % 2), 20 - 4 * (y % 2)) for y in range(40)}
    yield "zigzag_period3", {y: ((0, 6, 3)[y % 3], (30, 24, 27)[y % 3]) for y in range(1, 39)}
    yield "full_width", {y: (0, w - 1) for y in range(40)}
    yield "full_width_with_notch", {y: (0 if y % 9 else 6, w - 1 if y % 5 else w - 8) for y in range(40)}
    yield "convex_arc", {y: (int(round(0.04 * (y - 20) ** 2)), 30 - int(round(0.04 * (y - 20) ** 2)))
                         for y in range(40)}
    yield "concave_arc", {y: (16 - int(round(0.04 * (y - 20) ** 2)),
                              17 + int(round(0.04 * (y - 20) ** 2))) for y in range(40)}
    yield "noise", {y: tuple(sorted(int(t) for t in rng.integers(0, 40, 2)))
                    for y in range(40) if rng.random() < 0.6}
    # a collinear run between two far-left rows: lockstep peels one point
    # a round, so it has not settled after the kernel's 4 rounds
    yield "cascade", {y: (0 if y in (0, 39) else 10 + y, 60) for y in range(40)}


_CHAINS = dict(_adversarial_chains())


@pytest.mark.parametrize("rounds", [0, 1, 4, 16])
@pytest.mark.parametrize("name", sorted(_CHAINS))
def test_hull_rule_keeps_the_lockstep_points(name, rounds):
    """The compacted kernel's hull membership (lockstep rounds, then the
    slope rule) keeps exactly the rows that the lockstep concave-point
    deletion to its fixpoint (``_convexify``, the TPU kernels' rounds)
    keeps, on both chains, whether the slope rule starts from the valid
    rows (0 rounds) or after 1, 4 (the kernel's) or 16 rounds."""
    from ubdvss_tpu_torch.ops.cuda.rect_kernel import _convexify

    mn, mx, valid = _chain(_CHAINS[name])
    for v, sign in ((mn, 1), (mx, -1)):
        want = _convexify(v, valid, sign)
        got = hull_rows(v, valid, sign, rounds)
        assert torch.equal(got, want), (sign, got.nonzero().flatten(), want.nonzero().flatten())
    if name == "cascade":
        assert not torch.equal(_convexify(mn, valid, 1, max_rounds=16), _convexify(mn, valid, 1))


def test_hull_rule_keeps_the_lockstep_points_on_shapes():
    """The same on every component of the rect tests' shape masks, at H=32
    and H=128 (rotated rects, bars, rows, pixels, diagonals, notches)."""
    from ubdvss_tpu_torch.ops.cuda.rect_kernel import _convexify

    for seed, H in ((0, 32), (1, 32), (2, 128)):
        minx, maxx = _extremes(shape_masks(seed, H=H, W=H))
        mn = torch.from_numpy(minx).reshape(-1, H).long()
        mx = torch.from_numpy(maxx).reshape(-1, H).long()
        valid = mx >= 0
        for v, sign in ((mn, 1), (mx, -1)):
            want = _convexify(v, valid, sign)
            assert torch.equal(hull_rows(v, valid, sign), want)
            assert torch.equal(slope_rule(v, valid, sign), want)


def tall_masks(H=1088, W=96):
    """(K=6, H, W) component masks of a map taller than 1024 rows: a thin
    rectangle rotated 2 degrees over most rows, an upright bar over most
    rows (two columns of collinear chain points), a bar slanted at a
    golden-ratio slope over every row (staircase chains), a rotated
    rectangle of a hundred rows, a notched blob and an empty slot."""
    m = np.zeros((6, H, W), bool)
    m[0] = _rotated_rect(H, W, 48, H / 2, 18, H - 80, 2.0)
    m[1, 5 : H - 5, 10:14] = True
    y = np.arange(H)
    left = np.floor(20 + 0.0618 * y).astype(int)
    for dx in range(4):
        m[2, y, left + dx] = True
    m[3] = _rotated_rect(H, W, 60, 300, 30, 100, -25.0)
    m[4, 600:700, 30:70] = True
    m[4, 630:660, 30:45] = False
    return m


def test_rect_exact_past_1024_rows_matches_jax_mask_stack():
    """K3x's plain version at H=1088 (taller than 1024 rows) against the JAX
    package's XLA rect, ``min_area_rect_from_mask_stack``, on the same component
    masks: corners within 1e-4 as a set, sizes within 1e-4, the empty slot
    invalid on both sides."""
    from ubdvss_tpu.ops.rect import min_area_rect_from_mask_stack

    masks = tall_masks()
    ref = min_area_rect_from_mask_stack(jnp.asarray(masks.transpose(1, 2, 0)))
    minx, maxx = _extremes(masks[None])
    sel = min_area_rect_select(torch.from_numpy(minx), torch.from_numpy(maxx), None)
    out = rects_from_selection(sel)
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(valid, masks.any((1, 2)))
    np.testing.assert_array_equal(sel[0, 6].numpy() > 0.5, valid)
    assert_same_boxes(out["points"][0].numpy()[valid], np.asarray(ref["points"])[valid])
    np.testing.assert_allclose(np.sort(out["size"][0].numpy()[valid], -1),
                               np.sort(np.asarray(ref["size"])[valid], -1), atol=1e-4, rtol=0)

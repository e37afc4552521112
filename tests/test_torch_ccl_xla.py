"""PyTorch port: the XLA route's CCL (``ops/ccl.py``: ``label_propagation``,
``connected_components``) held against the JAX package's on the masks of
tests/test_ccl.py — adversarial, random at three densities, blobs, a
rectangular image and batched leading dims — at 4- and 8-connectivity.
Raw labels, compact labels and the count n must be identical (integer
arithmetic on both sides)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu.ops.ccl import connected_components as jax_connected_components
from ubdvss_tpu.ops.ccl import label_propagation as jax_label_propagation
from ubdvss_tpu_torch.ops.ccl import connected_components, label_propagation

torch.set_num_threads(1)

H = W = 32
SPIRAL = np.zeros((H, W), bool)  # tests/test_ccl.py's long snake
for _r in range(0, H, 4):
    SPIRAL[_r, :] = True
    if _r + 2 < H:
        SPIRAL[_r : _r + 3, W - 1 if (_r // 4) % 2 == 0 else 0] = True


SNAKE = np.zeros((H, W), bool)  # columns joined alternately at the bottom and top
for _c in range(0, W, 4):
    SNAKE[:, _c] = True
    SNAKE[0 if (_c // 4) % 2 else H - 1, _c : _c + 5] = True


def _single():
    m = np.zeros((H, W), bool)
    m[5, 7] = True
    return m


def _blobs():
    rng = np.random.default_rng(1)
    mask = np.zeros((64, 64), bool)
    yy, xx = np.mgrid[:64, :64]
    for _ in range(8):
        cy, cx = rng.integers(8, 56, 2)
        ry, rx = rng.integers(2, 8, 2)
        mask |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return mask


MASKS = {
    "empty": np.zeros((H, W), bool),
    "full": np.ones((H, W), bool),
    "diagonal": np.eye(H, dtype=bool),
    "checkerboard": np.indices((H, W)).sum(0) % 2 == 0,
    "spiral": SPIRAL,
    "snake": SNAKE,
    "single": _single(),
    **{f"random{d}": np.random.default_rng(0).random((48, 40)) < d for d in (0.05, 0.3, 0.5, 0.7)},
    "blobs": _blobs(),
    "rectangular": np.random.default_rng(2).random((17, 93)) < 0.4,
}


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", list(MASKS))
def test_connected_components_matches_jax(name, connectivity):
    mask = MASKS[name]
    want, n_want = jax_connected_components(jnp.asarray(mask), connectivity=connectivity)
    got, n_got = connected_components(torch.from_numpy(mask), connectivity=connectivity)
    assert got.dtype == torch.int32 and n_got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(n_got) == int(n_want)
    raw = label_propagation(torch.from_numpy(mask), connectivity)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(jax_label_propagation(jnp.asarray(mask), connectivity)))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_label_propagation_leading_dims_and_cap(connectivity):
    """(2, 3, H, W) masks (one loop over all of them, as JAX's), and a cap
    that binds (the snake stops after 3 rounds) — raw labels identical."""
    rng = np.random.default_rng(5)
    masks = rng.random((2, 3, 24, 20)) < 0.45
    masks[1, 2] = SNAKE[:24, :20]
    got = label_propagation(torch.from_numpy(masks), connectivity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_label_propagation(jnp.asarray(masks), connectivity)))
    capped = label_propagation(torch.from_numpy(SNAKE), connectivity, max_iters=3)
    want = jax_label_propagation(jnp.asarray(SNAKE), connectivity, max_iters=3)
    np.testing.assert_array_equal(capped.numpy(), np.asarray(want))
    assert not np.array_equal(capped.numpy(), label_propagation(torch.from_numpy(SNAKE), connectivity).numpy())


def test_connectivity_checked():
    with pytest.raises(ValueError, match="connectivity must be 4 or 8"):
        connected_components(torch.zeros((4, 4), dtype=torch.bool), connectivity=6)

"""PyTorch port: CCL (K1) and component slots (K2) plain versions held
against the JAX package's Pallas kernels in interpret mode (CPU); the
outputs must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu.ops.pallas.ccl_kernel import ccl_labels_from_logits as jax_ccl
from ubdvss_tpu.ops.pallas.postproc_kernel import (
    component_slots_from_logits as jax_slots,
)
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import ccl_labels_from_logits
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_slots_from_logits

torch.set_num_threads(1)


def blob_logits(seed, B=2, H=32, W=32, n_blobs=3):
    """Detection logits with rectangular blobs (may touch and merge)."""
    rng = np.random.default_rng(seed)
    lg = np.full((B, H, W), -6, np.float32)
    for b in range(B):
        for _ in range(n_blobs):
            cy, cx = rng.integers(1, H - 6, 2)
            h, w = rng.integers(2, 9, 2)
            lg[b, cy : cy + h, cx : cx + w] = 6
    return lg


def adversarial_logits(H=32, W=32):
    """Snake, checkerboard, diagonal staircase and noise maps."""
    snake = np.full((H, W), -6, np.float32)
    for c in range(0, W, 4):
        snake[:, c] = 6
        snake[0 if (c // 4) % 2 else H - 1, c : min(c + 5, W)] = 6
    checker = np.where(np.indices((H, W)).sum(0) % 2 == 0, 6.0, -6.0).astype(np.float32)
    stairs = np.full((H, W), -6, np.float32)
    for i in range(min(H, W)):
        stairs[i, i] = 6
        stairs[H - 1 - i, (i + 3) % W] = 6
    noise = np.random.default_rng(11).normal(0, 1, (H, W)).astype(np.float32)
    return np.stack([snake, checker, stairs, noise])


CASES = {
    "blobs": lambda: blob_logits(0),
    "dense_blobs": lambda: blob_logits(3, B=3, n_blobs=9),
    "adversarial": adversarial_logits,
}


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ccl_matches_pallas_interpret(case, connectivity):
    lg = CASES[case]()
    ref = np.asarray(jax_ccl(jnp.asarray(lg), connectivity=connectivity, interpret=True))
    out = ccl_labels_from_logits(torch.from_numpy(lg), connectivity=connectivity)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


def _assert_slots_equal(out, ref):
    for key in ("rootvals", "slots", "minx", "maxx", "num_components_total"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_slots_match_pallas_interpret(case, K):
    """All outputs identical, including padding slots (fewer than K
    components: background takes slot K-1 and every padding slot carries
    its extremes) and overflow (more than K: pixels beyond slot K)."""
    lg = CASES[case]()
    ref = jax.device_get(jax_slots(jnp.asarray(lg), K, interpret=True))
    out = component_slots_from_logits(torch.from_numpy(lg), K)
    _assert_slots_equal(out, ref)


def test_slots_seam_case_matches_pallas_interpret():
    """The JAX kernel stacks 8 images per CCL program here; blobs touching
    the top and bottom edges must not merge across images (the case of
    tests/test_pallas_ccl.py::test_grouped_stacking_isolates_images)."""
    H = W = 16
    B = 8
    lg = np.full((B, H, W), -6, np.float32)
    lg[:, :, 4:7] = 6
    lg[0::2, H - 3 :, 10:14] = 6
    lg[1::2, :3, 10:14] = 6
    ref = jax.device_get(jax_slots(jnp.asarray(lg), 8, interpret=True))
    out = component_slots_from_logits(torch.from_numpy(lg), 8)
    _assert_slots_equal(out, ref)
    np.testing.assert_array_equal(out["num_components_total"].numpy(), np.full(B, 2))

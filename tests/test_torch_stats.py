"""PyTorch port: the per-component stats (areas, sigmoid sums, class-softmax
sums) of ``component_stats_from_logits`` — on the CPU the plain one-hot
products that the card's K2 and K12c are held against — against the JAX
package's ``component_stats_from_logits`` with its Pallas kernels in
interpret mode.

Geometry outputs and areas are identical.  The sums are f32 in another
order than XLA's, so the means (sum / area) agree within 2e-6, the
tolerance the card's kernels are held to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ccl import adversarial_logits, blob_logits

from ubdvss_tpu.ops.pallas.postproc_kernel import (
    component_stats_from_logits as jax_stats,
)
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_stats_from_logits

torch.set_num_threads(1)

_EXACT = ("rootvals", "areas", "minx", "maxx", "labels", "num_components_total")


def _logits(det: np.ndarray, C: int, seed: int) -> np.ndarray:
    """(B, H, W) detection logits -> (B, H, W, C) with normal class logits."""
    lg = np.random.default_rng(seed).normal(0, 2, det.shape + (C,)).astype(np.float32)
    lg[..., 0] = det
    return lg


def _assert_stats_match(lg: np.ndarray, K: int):
    ref = jax.device_get(jax_stats(jnp.asarray(lg), K, interpret=True))
    # the head's layout: an NHWC view over (B, C, H, W) planes
    planes = torch.from_numpy(np.ascontiguousarray(lg.transpose(0, 3, 1, 2)))
    out = component_stats_from_logits(planes.permute(0, 2, 3, 1), K)
    assert sorted(out) == sorted(ref)
    for key in _EXACT:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    area = np.maximum(np.asarray(ref["areas"]), 1)
    np.testing.assert_allclose(
        out["det_sums"].numpy() / area, np.asarray(ref["det_sums"]) / area, atol=2e-6, rtol=0)
    np.testing.assert_allclose(
        out["cls_sums"].numpy() / area[..., None], np.asarray(ref["cls_sums"]) / area[..., None],
        atol=2e-6, rtol=0)
    return ref


@pytest.mark.parametrize("C", [1, 5, 17])
@pytest.mark.parametrize("K", [1, 4, 16])
def test_stats_match_jax_on_blobs(K, C):
    """Blob maps: with K=16 each image has fewer than K components, so the
    padding slot K-1 carries the background's stats; with K=1 and 4 some
    have more, and pixels beyond slot K count nowhere.  C=1 gives a zero
    class column."""
    lg = _logits(blob_logits(K + C, B=3, n_blobs=6), C, seed=K * C)
    ref = _assert_stats_match(lg, K)
    totals = np.asarray(ref["num_components_total"])
    if K == 16:
        assert (totals < K).all()
        assert (np.asarray(ref["areas"])[:, K - 1] > 0).all()  # the background
    if K == 1:
        assert (totals > K).any()
    if C == 1:
        assert not np.asarray(ref["cls_sums"]).any()


@pytest.mark.parametrize("K", [1, 8])
def test_stats_match_jax_on_adversarial_maps(K):
    """Snake, checkerboard, staircase and noise maps (more than K
    components), 17 channels."""
    _assert_stats_match(_logits(adversarial_logits(), 17, seed=K), K)


@pytest.mark.parametrize("C", [1, 17])
def test_stats_match_jax_at_qvga_heatmap(C):
    """The QVGA stream's 60x80 heatmaps, K=16, blobs and noise."""
    det = np.concatenate([blob_logits(3, B=1, H=60, W=80, n_blobs=5),
                          np.random.default_rng(4).normal(0, 1, (1, 60, 80)).astype(np.float32)])
    ref = _assert_stats_match(_logits(det, C, seed=C), 16)
    totals = np.asarray(ref["num_components_total"])
    assert totals[0] < 16 < totals[1]

"""PyTorch port: the routes of ``postprocess_batch_fused`` that take the
last two kernels, held against the JAX package with its Pallas kernels in
interpret mode (CPU): the uncompacted rect kernel (K3x, max_hull_points >=
the heatmap height) and the compat geometry (K12c, UBDVSS_PALLAS_COMPAT=1).
Tolerances as in test_torch_postproc.assert_same_detections, except where a
test states its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ccl import adversarial_logits, blob_logits
from test_torch_model import ASSETS
from test_torch_postproc import assert_same_detections, jax_scene_logits

from ubdvss_tpu.ops.pallas import postproc_kernel as jax_postproc_kernel
from ubdvss_tpu.ops.postproc import postprocess_batch_fused as jax_postprocess
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu_torch import NetConfig
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_slots_from_logits
from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused

torch.set_num_threads(1)


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_postprocess_fused_exact_rect_matches_jax_on_model_logits(asset):
    """max_hull_points=64 >= the 32-row heatmap: both sides take the
    uncompacted rect kernel (K3x); the same tolerances as above."""
    logits = jax_scene_logits(asset)
    cfg = NetConfig(max_components=16, max_hull_points=64)
    jcfg = jax_load_net_config(ASSETS[asset]).replace(max_components=16, max_hull_points=64)
    ref = jax.device_get(jax_postprocess(jnp.asarray(logits), jcfg, interpret=True))
    out = postprocess_batch_fused(torch.from_numpy(logits), cfg)
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_same_detections(out, ref)


def test_postprocess_fused_exact_rect_matches_jax_on_blobs():
    """Blob maps with classes through the uncompacted rect kernel (K3x,
    max_hull_points=32 >= H=32); the same tolerances as above."""
    K = 8
    rng = np.random.default_rng(K)
    det = blob_logits(9, B=3, n_blobs=6)
    logits = rng.normal(0, 2, det.shape + (5,)).astype(np.float32)
    logits[..., 0] = det
    names = ("a", "b", "c", "d")
    cfg = NetConfig(class_names=names, max_components=K, min_component_area=3,
                    max_hull_points=32)
    from ubdvss_tpu.net_config import NetConfig as JaxNetConfig

    jcfg = JaxNetConfig(class_names=names, max_components=K, min_component_area=3,
                        max_hull_points=32)
    ref = jax.device_get(jax_postprocess(jnp.asarray(logits), jcfg, interpret=True))
    out = postprocess_batch_fused(torch.from_numpy(logits), cfg)
    assert_same_detections(out, ref)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("K", [1, 8])
def test_compat_geometry_matches_jax_compat_kernel(monkeypatch, K, connectivity):
    """UBDVSS_PALLAS_COMPAT=1: the port's compat route (K12c's plain
    version on the CPU) against the JAX package's _geometry_kernel_compat
    in interpret mode, on 32x32 blob and adversarial maps; all five
    outputs identical.  The JAX side reads its switch at import, so the
    test sets its module flag and calls the function under its jit."""
    lg = np.concatenate([blob_logits(0), adversarial_logits()])
    monkeypatch.setattr(jax_postproc_kernel, "_COMPAT", True)
    ref = jax.device_get(jax_postproc_kernel.component_slots_from_logits.__wrapped__(
        jnp.asarray(lg), K, connectivity=connectivity, interpret=True))
    monkeypatch.setenv("UBDVSS_PALLAS_COMPAT", "1")
    out = component_slots_from_logits(torch.from_numpy(lg), K, connectivity=connectivity)
    assert sorted(out) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)

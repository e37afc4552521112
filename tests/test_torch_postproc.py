"""PyTorch port: ``postprocess_batch_fused`` (CCL -> slots -> stats ->
rects) on the JAX model's logits, held against the JAX package's fused
postprocessing with its Pallas kernels in interpret mode (CPU).  The
uncompacted rect (K3x) and compat geometry (K12c) routes are in
test_torch_postproc_routes.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ccl import blob_logits
from test_torch_rect import assert_same_boxes

from ubdvss_tpu.models.model import get_model as jax_get_model
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.ops.postproc import postprocess_batch_fused as jax_postprocess
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import NetConfig
from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from test_torch_model import ASSETS

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_scene_logits(asset, n=4, hw=128, seed=3):
    """The JAX model's logits on normalized synthetic scenes (computed once
    per asset; callers do not write to the array)."""
    jcfg = jax_load_net_config(ASSETS[asset])
    params = jax_load_params_npz(ASSETS[asset], init_params(jcfg, 0))
    reader = SyntheticMarkupReader(n_samples=n, image_hw=(hw, hw), seed=seed)
    x = np.stack([reader.sample_at(i).image for i in range(n)])
    x = (x.astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]
    return np.array(jax_get_model(jcfg).apply({"params": params}, jnp.asarray(x)))


def assert_same_detections(out: dict, ref: dict, score_atol=1e-6, box_atol=1e-4):
    """Slot-for-slot equality of two postprocessing results: masks, areas,
    classes and counts identical, scores and class probabilities within
    score_atol, boxes within box_atol up to corner order (the rect parity
    of tests/helpers.py; see test_torch_rect's module docstring)."""
    for key in ("valid", "areas", "classes", "num_detections", "num_components_total"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), atol=score_atol)
    np.testing.assert_allclose(
        out["class_probs"].numpy(), np.asarray(ref["class_probs"]), atol=score_atol
    )
    assert_same_boxes(out["boxes"].numpy(), np.asarray(ref["boxes"]), box_atol)
    np.testing.assert_allclose(out["center"].numpy(), np.asarray(ref["center"]), atol=box_atol)


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_postprocess_fused_matches_jax_on_model_logits(asset):
    logits = jax_scene_logits(asset)
    cfg = NetConfig(max_components=16, max_hull_points=16)
    jcfg = jax_load_net_config(ASSETS[asset]).replace(max_components=16, max_hull_points=16)
    ref = jax.device_get(jax_postprocess(jnp.asarray(logits), jcfg, interpret=True))
    out = postprocess_batch_fused(torch.from_numpy(logits), cfg)
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_same_detections(out, ref)


@pytest.mark.parametrize("K,min_area", [(4, 3), (8, 3), (8, 20)])
def test_postprocess_fused_matches_jax_on_blobs(K, min_area):
    """Blob maps with classes, more and fewer components than K, and the
    min_component_area cut."""
    rng = np.random.default_rng(K + min_area)
    det = blob_logits(7, B=3, n_blobs=6)
    logits = rng.normal(0, 2, det.shape + (5,)).astype(np.float32)
    logits[..., 0] = det
    names = ("a", "b", "c", "d")
    cfg = NetConfig(class_names=names, max_components=K, min_component_area=min_area,
                    max_hull_points=8)
    from ubdvss_tpu.net_config import NetConfig as JaxNetConfig

    jcfg = JaxNetConfig(class_names=names, max_components=K, min_component_area=min_area,
                        max_hull_points=8)
    ref = jax.device_get(jax_postprocess(jnp.asarray(logits), jcfg, interpret=True))
    out = postprocess_batch_fused(torch.from_numpy(logits), cfg)
    assert_same_detections(out, ref)


def test_exact_rect_beyond_128_rows_raises_naming_the_xla_route():
    """max_hull_points >= H > 128: the JAX package fits the rects with its
    XLA compact caliper at M = H, the port with K3x (the plain version
    here), both exact; nothing raises.  Two 256x64 maps of bars up to 240
    rows tall and a blob across three of them, with classes, against JAX's
    postprocess_batch_fused (interpret mode), to the tolerances above.  The
    foreground logit is 20, whose sigmoid is 1 in f32, so that the score
    sums over these components of up to 2,000 pixels are exact in any
    order."""
    from ubdvss_tpu.net_config import NetConfig as JaxNetConfig

    rng = np.random.default_rng(130)
    det = np.full((2, 256, 64), -6.0, np.float32)
    for b in range(2):
        for i, x0 in enumerate(range(3, 56, 9)):
            y0 = int(rng.integers(0, 16))
            det[b, y0 : 256 - int(rng.integers(0, 16)), x0 : x0 + 2 + i % 3] = 20
        det[b, 100:140, 20:40] = 20  # a blob across three bars
    logits = rng.normal(0, 2, det.shape + (5,)).astype(np.float32)
    logits[..., 0] = det
    names = ("a", "b", "c", "d")
    cfg = NetConfig(class_names=names, max_components=8, max_hull_points=256)
    jcfg = JaxNetConfig(class_names=names, max_components=8, max_hull_points=256)
    ref = jax.device_get(jax_postprocess(jnp.asarray(logits), jcfg, interpret=True))
    out = postprocess_batch_fused(torch.from_numpy(logits), cfg)
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_same_detections(out, ref)

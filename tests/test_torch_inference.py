"""PyTorch port: the serving entry points end to end on the CPU, held
against the JAX package's XLA route on the same synthetic scenes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import ASSETS, load_params
from test_torch_postproc import assert_same_detections
from test_torch_rect import assert_same_boxes

from ubdvss_tpu.inference import BarcodeDetector as JaxBarcodeDetector
from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import BarcodeDetector, detect_program_batch, load_net_config
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

# a det logit this close to the threshold may flip on conv rounding alone
MARGIN = 1e-4


def _jax_asset(asset, **kw):
    jcfg = jax_load_net_config(ASSETS[asset]).replace(**kw)
    return jcfg, jax_load_params_npz(ASSETS[asset], init_params(jcfg, 0))


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_detect_program_batch_matches_jax(asset):
    """The port's fused route (device='cpu': every kernel's plain version)
    == the JAX XLA route on 128x128 scenes, the logits within 1e-5 or 1e-6
    of max|logit| where that is more (1-3 f32 ulps: the two conv libraries
    sum in different orders, as tests/test_torch_model.py holds the model).
    max_hull_points=31 < H=32
    keeps the compacted rect route; no component of these scenes spans
    more than 28 rows, so compaction drops no hull point."""
    kw = dict(max_components=16, max_hull_points=31)
    jcfg, jparams = _jax_asset(asset, **kw)
    cfg = load_net_config(ASSETS[asset]).replace(**kw)
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(128, 128), seed=21)
    imgs = np.stack([reader.sample_at(i).image for i in range(4)])
    ref, ref_logits = jax.device_get(
        jax_detect_program_batch(jparams, jnp.asarray(imgs), jcfg, (128, 128), fused=False)
    )
    assert np.abs(ref_logits[..., 0]).min() > MARGIN
    out, logits = detect_program_batch(
        load_params(ASSETS[asset]), imgs, cfg, (128, 128), fused=True, device="cpu"
    )
    np.testing.assert_allclose(logits.numpy(), ref_logits,
                               atol=max(1e-5, 1e-6 * np.abs(ref_logits).max()))
    assert int(ref["num_detections"].sum()) > 0
    assert_same_detections(out, ref, score_atol=1e-5)


def test_barcode_detector_matches_jax():
    """BarcodeDetector.detect on an RGB image that needs a resize (509x301
    -> 508x300 grid), with the grid -> image rescale, vs the JAX detector."""
    jcfg, jparams = _jax_asset("dense")
    cfg = load_net_config(ASSETS["dense"])
    gray = SyntheticMarkupReader(n_samples=1, image_hw=(509, 301), seed=4).sample_at(0).image
    rgb = np.stack([gray, np.clip(gray.astype(int) + 9, 0, 255), gray], -1).astype(np.uint8)
    jdet = JaxBarcodeDetector(jcfg, jparams)
    assert np.abs(jdet.heatmap(rgb) - 0.5).min() > MARGIN / 4
    ref = jdet.detect(rgb)
    det = BarcodeDetector(cfg, load_params(ASSETS["dense"]), device="cpu")
    out = det.detect(rgb)
    assert len(ref) > 0 and len(out) == len(ref)
    for o, r in zip(out, ref):
        assert (o.class_id, o.class_name, o.area) == (r.class_id, r.class_name, r.area)
        assert abs(o.score - r.score) < 1e-5
        assert_same_boxes(o.box[None], r.box[None], 1e-3)
        np.testing.assert_allclose(o.center, r.center, atol=1e-3)


def test_barcode_detector_serves_small_images_like_jax():
    """A 240x320 camera frame with the asset's own NetConfig: the 60-row
    heatmap is within max_hull_points=64, so the port's rects take the
    uncompacted kernel (K3x; this raised before it was ported).  Against
    the JAX detector (its XLA route on the CPU): class, area identical,
    score within 1e-5, box within 1e-3 as a corner set, centre within 1e-3."""
    jcfg, jparams = _jax_asset("separable")
    cfg = load_net_config(ASSETS["separable"])
    assert cfg.max_hull_points >= 240 // cfg.scale
    gray = SyntheticMarkupReader(n_samples=1, image_hw=(240, 320), seed=12).sample_at(0).image
    jdet = JaxBarcodeDetector(jcfg, jparams)
    assert np.abs(jdet.heatmap(gray) - 0.5).min() > MARGIN / 4
    ref = jdet.detect(gray)
    out = BarcodeDetector(cfg, load_params(ASSETS["separable"]), device="cpu").detect(gray)
    assert len(ref) > 0 and len(out) == len(ref)
    for o, r in zip(out, ref):
        assert (o.class_id, o.class_name, o.area) == (r.class_id, r.class_name, r.area)
        assert abs(o.score - r.score) < 1e-5
        assert_same_boxes(o.box[None], r.box[None], 1e-3)
        np.testing.assert_allclose(o.center, r.center, atol=1e-3)

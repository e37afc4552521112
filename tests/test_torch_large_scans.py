"""PyTorch port: serving past 128x128 heatmaps on the CPU, held against the
JAX package on the same synthetic scenes, with the asset's own config
(24 channels, K=64, M=64).  On the port's side every kernel takes its
plain version.

Tolerances: logits within 1e-4 (two conv libraries, f32); valid, areas,
classes and counts identical; scores and class probabilities within 1e-5;
boxes within 1e-4 as corner sets (``assert_same_detections``), or 1e-3 in
image coordinates for ``BarcodeDetector`` (the grid -> image rescale).
Scenes are checked to hold no detection logit within 1e-4 of the
threshold, where one pixel may flip on conv rounding alone."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from test_torch_ccl import blob_logits
from test_torch_inference import MARGIN, _jax_asset
from test_torch_model import ASSETS, load_params
from test_torch_postproc import assert_same_detections
from test_torch_postproc_xla import compact_labels
from test_torch_rect import assert_same_boxes

from ubdvss_tpu.inference import BarcodeDetector as JaxBarcodeDetector
from ubdvss_tpu.inference import detect_preprocessed_batch as jax_detect_preprocessed_batch
from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch
from ubdvss_tpu.ops import strips as jax_strips
from ubdvss_tpu.ops.ccl import connected_components as jax_connected_components
from ubdvss_tpu.parallel.tiling import receptive_field_halo as jax_receptive_field_halo
from ubdvss_tpu.streaming import StreamingDetector as JaxStreamingDetector
from ubdvss_tpu_torch import (
    BarcodeDetector,
    StreamingDetector,
    detect_preprocessed_batch,
    detect_program_batch,
    load_net_config,
)
from ubdvss_tpu_torch.ops import strips
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import ccl_labels_reference
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_stats_from_logits
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

HW = (576, 576)  # 144x144 heatmaps: past the old 128x128 gate


@functools.lru_cache(maxsize=None)
def scans():
    """Two 576x576 scenes and the JAX XLA route's (result, logits) on them
    (computed once; callers do not write to the arrays).  No component
    spans more than max_hull_points=64 rows, so no chain holds more points
    than the fused route keeps, and the JAX fused route gives these
    detections too (the JAX package holds its two routes equal,
    tests/test_pallas_ccl.py)."""
    jcfg, jparams = _jax_asset("separable")
    reader = SyntheticMarkupReader(n_samples=2, image_hw=HW, seed=3)
    imgs = np.stack([reader.sample_at(i).image for i in range(2)])
    xla, logits = jax.device_get(
        jax_detect_program_batch(jparams, jnp.asarray(imgs), jcfg, HW, fused=False))
    assert np.abs(logits[..., 0]).min() > MARGIN
    assert int(xla["num_detections"].sum()) > 0
    stats = component_stats_from_logits(torch.tensor(logits), jcfg.max_components)
    rows = (stats["maxx"] >= 0).sum(-1)[stats["rootvals"] < HW[0] * HW[1] // 16]
    assert int(rows.max()) <= jcfg.max_hull_points
    return imgs, logits, xla


@functools.lru_cache(maxsize=None)
def port_fused():
    """The port's fused route on ``scans()``'s images: (result, logits)."""
    cfg = load_net_config(ASSETS["separable"])
    return detect_program_batch(load_params(ASSETS["separable"]), scans()[0], cfg, HW,
                                fused=True, device="cpu")


@pytest.mark.parametrize("fused", [None, True, False])
def test_detect_program_batch_past_the_gate_matches_jax(fused):
    """The fused route (K3 at M=64 < H=144), ``fused=False`` (exact rects,
    K3x) and the CPU's default (the XLA route, as JAX's CPU default)
    against the JAX XLA route, on the port's and JAX's own logits."""
    imgs, ref_logits, xla = scans()
    cfg = load_net_config(ASSETS["separable"])
    out, logits = port_fused() if fused else detect_program_batch(
        load_params(ASSETS["separable"]), imgs, cfg, HW, fused=fused, device="cpu")
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    assert_same_detections(out, xla, score_atol=1e-5)


@pytest.mark.parametrize("n_strips", [2, 4])
def test_n_strips_match_the_whole_trunk_and_jax(n_strips):
    """Row strips give the whole trunk's logits and detections; the strip
    plan and halo are the JAX package's; and the JAX strip_tiled_logits
    reassembles a SAME-padded trunk as the port's, by rows and by
    columns."""
    imgs, ref_logits, xla = scans()
    cfg = load_net_config(ASSETS["separable"])
    params = load_params(ASSETS["separable"])
    out, logits = detect_program_batch(params, imgs, cfg, HW, n_strips=n_strips, fused=True,
                                       device="cpu")
    whole, whole_logits = port_fused()
    np.testing.assert_allclose(logits.numpy(), whole_logits.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    for key in whole:
        assert torch.equal(out[key], whole[key]), key
    assert_same_detections(out, xla, score_atol=1e-5)

    halo = strips.receptive_field_halo(cfg)
    assert halo == jax_receptive_field_halo(_jax_asset("separable")[0])
    assert strips.strip_plan(HW[0], 4, halo, n_strips) == jax_strips.strip_plan(
        HW[0], 4, halo, n_strips)

    # a SAME-padded trunk whose window reaches 12 input pixels a side, then
    # stride 4: both strip tilings reassemble it exactly (integer-valued sums)
    x = np.random.default_rng(n_strips).integers(0, 9, (2, 96, 80)).astype(np.float32)

    def torch_trunk(s):
        y = torch.nn.functional.conv2d(s[:, None], torch.ones(1, 1, 25, 25), padding=12)
        return y[:, 0, ::4, ::4, None]

    def jax_trunk(s):
        y = lax.reduce_window(s, 0.0, lax.add, (1, 25, 25), (1, 1, 1), "SAME")
        return y[:, ::4, ::4, None]

    for axis in (1, 2):
        want = np.asarray(jax_strips.strip_tiled_logits(jax_trunk, jnp.asarray(x), 4, 16,
                                                        n_strips, axis=axis))
        got = strips.strip_tiled_logits(torch_trunk, torch.from_numpy(x), 4, 16, n_strips,
                                        axis=axis).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, torch_trunk(torch.from_numpy(x)).numpy())


def preprocessed():
    """``scans()``'s images normalized to [-1, 1], (B, H, W, 1) f32."""
    return (scans()[0].astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]


@functools.lru_cache(maxsize=None)
def jax_preprocessed():
    """JAX's detect_preprocessed_batch on ``preprocessed()`` (its XLA route
    on the CPU): (result, logits), computed once for both cases."""
    jcfg, jparams = _jax_asset("separable")
    return jax.device_get(
        jax_detect_preprocessed_batch(jparams, jnp.asarray(preprocessed()), jcfg, fused=False))


@pytest.mark.parametrize("fused", [None, True, False])
def test_detect_preprocessed_batch_matches_jax(fused):
    """Normalized (B, H, W, 1) images: the port's fused route,
    ``fused=False`` and the CPU's default (the XLA route) against JAX's
    ``detect_preprocessed_batch`` (its XLA route on the CPU)."""
    cfg = load_net_config(ASSETS["separable"])
    out, logits = detect_preprocessed_batch(
        load_params(ASSETS["separable"]), preprocessed(), cfg, fused=fused, device="cpu")
    ref, ref_logits = jax_preprocessed()
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    assert_same_detections(out, ref, score_atol=1e-5)


@pytest.mark.parametrize("hw,seed", [((480, 640), 31), ((720, 1280), 8)])
def test_barcode_detector_on_photos_matches_jax(hw, seed):
    """BarcodeDetector with the asset's config on a VGA photo (120x160
    heatmap) and a 720p frame (resized to 576x1024, a 144x256 heatmap),
    against the JAX detector: class, area identical, score within 1e-5,
    box and centre within 1e-3 (image coordinates)."""
    jcfg, jparams = _jax_asset("separable")
    cfg = load_net_config(ASSETS["separable"])
    h, w = cfg.grid_size(*hw)
    assert (h // 4) * (w // 4) > 128 * 128
    gray = SyntheticMarkupReader(n_samples=1, image_hw=hw, seed=seed).sample_at(0).image
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


def test_stream_at_720p_matches_jax():
    """StreamingDetector over 2 synthetic 720p frames (resized to 576x1024,
    144x256 heatmaps), one batch, against the JAX stream
    (its XLA route on the CPU): the asset's max_hull_points raised to the
    heatmap's 144 rows, so both take exact rects."""
    jcfg, jparams = _jax_asset("separable", max_hull_points=144)
    cfg = load_net_config(ASSETS["separable"]).replace(max_hull_points=144)
    reader = SyntheticMarkupReader(n_samples=2, image_hw=(720, 1280), seed=2)
    frames = [reader.sample_at(i).image for i in range(2)]
    port = StreamingDetector(cfg, load_params(ASSETS["separable"]), (720, 1280), batch_size=2,
                             device="cpu")
    out = list(port.process(iter(frames)))
    exp = jax.device_get(list(JaxStreamingDetector(jcfg, jparams, (720, 1280), 2).process(
        iter(frames))))
    assert [i for i, _ in out] == [i for i, _ in exp] == [0, 1]
    assert sum(int(d["num_detections"]) for _, d in exp) > 0
    for (_, o), (_, r) in zip(out, exp):
        assert_same_detections({k: torch.from_numpy(np.asarray(v)) for k, v in o.items()},
                               r, score_atol=1e-5)


@pytest.mark.parametrize("hw,connectivity", [((300, 300), 4), ((320, 480), 8)])
def test_plain_ccl_matches_jax_on_large_masks(hw, connectivity):
    """The plain CCL (the device-memory kernel's plain version) against
    JAX's connected_components on blob masks of 300x300 and larger, whose
    components are reached well inside the H+W round cap: labels
    identical after raster-order compaction."""
    det = blob_logits(sum(hw) + connectivity, B=2, H=hw[0], W=hw[1], n_blobs=40)
    raw = ccl_labels_reference(torch.from_numpy(det), 0.5, connectivity)
    mask = jnp.asarray(det) > 0.0
    ref = jax.vmap(lambda m: jax_connected_components(m, connectivity=connectivity)[0])(mask)
    labels = compact_labels(raw)
    assert labels.max() > 10
    np.testing.assert_array_equal(labels, np.asarray(ref))

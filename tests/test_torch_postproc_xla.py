"""PyTorch port: the XLA route's entry points — ``postprocess``,
``postprocess_batch``, ``detect_program``, ``BarcodeDetector.detect`` /
``.heatmap`` and ``detect_program_batch(fused=False)`` — held against the
JAX package's (CPU).  On the port's side every kernel takes its plain
version: CCL, slots and the uncompacted rect (K3x, every chain point
projected).

Labels, ``valid``, ``areas`` and ``classes`` identical; scores and class
probabilities within 1e-6; boxes within 1e-4 as corner sets (an exact
caliper tie may report the other side of the same rectangle; see
test_torch_rect's module docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ccl import adversarial_logits, blob_logits
from test_torch_inference import MARGIN, _jax_asset
from test_torch_model import ASSETS, load_params
from test_torch_postproc import assert_same_detections
from test_torch_rect import assert_same_boxes, same_corner_sets

from ubdvss_tpu.inference import BarcodeDetector as JaxBarcodeDetector
from ubdvss_tpu.inference import detect_program as jax_detect_program
from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops.ccl import connected_components as jax_connected_components
from ubdvss_tpu.ops import postproc as jpp
from ubdvss_tpu.ops.postproc import postprocess as jax_postprocess
from ubdvss_tpu.ops.postproc import postprocess_batch as jax_postprocess_batch
from ubdvss_tpu_torch import BarcodeDetector, NetConfig, detect_program, detect_program_batch
from ubdvss_tpu_torch import detect_preprocessed_batch, load_net_config
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import ccl_labels_from_logits
from ubdvss_tpu_torch.ops import postproc as pp
from ubdvss_tpu_torch.ops.ccl import connected_components, label_propagation
from ubdvss_tpu_torch.ops.postproc import postprocess, postprocess_batch, postprocess_batch_fused
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

NAMES = ("a", "b", "c", "d")


def _cfgs(**kw):
    return NetConfig(class_names=NAMES, **kw), JaxNetConfig(class_names=NAMES, **kw)


def _with_classes(det: np.ndarray, seed: int) -> np.ndarray:
    """(B, H, W) detection logits -> (B, H, W, 5) with normal class logits."""
    logits = np.random.default_rng(seed).normal(0, 2, det.shape + (5,)).astype(np.float32)
    logits[..., 0] = det
    return logits


def upright_bar(B=1, H=128, W=128, rows=100):
    """One upright bar, `rows` rows tall and 6 columns wide, in each map:
    its chains are two columns of collinear points, more than 64 each."""
    det = np.full((B, H, W), -6.0, np.float32)
    det[:, 10 : 10 + rows, 40:46] = 6.0
    return det


def compact_labels(raw: torch.Tensor) -> np.ndarray:
    """Raw min-index labels (B, H, W) -> 1..N raster-ordered labels, 0 at
    the background, as the JAX package's connected_components gives."""
    raw = raw.numpy()
    out = np.zeros_like(raw)
    N = raw.shape[1] * raw.shape[2]
    for b in range(raw.shape[0]):
        roots = np.unique(raw[b][raw[b] < N])
        out[b] = np.where(raw[b] < N, np.searchsorted(roots, raw[b]) + 1, 0)
    return out


def assert_same_labels(det: np.ndarray, threshold: float, connectivity: int):
    raw = ccl_labels_from_logits(torch.from_numpy(det), threshold, connectivity)
    mask = jax.nn.sigmoid(jnp.asarray(det)) > threshold
    ref = jax.vmap(lambda m: jax_connected_components(m, connectivity=connectivity)[0])(mask)
    np.testing.assert_array_equal(compact_labels(raw), np.asarray(ref))


def test_upright_bar_takes_the_exact_route():
    """A 100-row upright bar in a 128x128 map: postprocess equals the JAX
    postprocess, its box 100 rows tall; the fused route at M=64 keeps each
    chain's first 64 points only and cuts the box short."""
    logits = _with_classes(upright_bar(), 1)
    cfg, jcfg = _cfgs(max_components=8, max_hull_points=64)
    assert_same_labels(logits[..., 0], cfg.detection_threshold, 8)
    ref = jax.device_get(jax_postprocess(jnp.asarray(logits[0]), jcfg))
    out = postprocess(torch.from_numpy(logits[0]), cfg)
    assert sorted(out) == sorted(ref)
    assert int(ref["num_detections"]) == 1
    assert_same_detections(out, ref)
    assert float(out["size"][0].max()) == pytest.approx(99 * cfg.scale)
    fused = postprocess_batch_fused(torch.from_numpy(logits), cfg)
    assert not same_corner_sets(fused["boxes"][0, :1].numpy(), ref["boxes"][:1], 1e-4).any()
    assert float(fused["size"][0, 0].max()) < 99 * cfg.scale


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("K,n_blobs", [(4, 9), (16, 6)])
def test_postprocess_batch_matches_jax_on_blobs(K, n_blobs, connectivity):
    """Blob maps with several components (more than K=4 of them, or fewer
    than K=16, so that padding slots stay empty), the bar and the
    adversarial maps, through postprocess_batch, against the JAX one."""
    det = np.concatenate([
        blob_logits(K + connectivity, B=3, n_blobs=n_blobs),
        upright_bar(H=32, W=32, rows=20),
        adversarial_logits(),
    ])
    logits = _with_classes(det, K)
    cfg, jcfg = _cfgs(max_components=K, min_component_area=3)
    assert_same_labels(det, cfg.detection_threshold, connectivity)
    ref = jax.device_get(jax_postprocess_batch(jnp.asarray(logits), jcfg, connectivity))
    out = postprocess_batch(torch.from_numpy(logits), cfg, connectivity)
    totals = np.asarray(ref["num_components_total"])
    assert ((totals > K) if K == 4 else (totals < K)).any()
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_same_detections(out, ref)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_postprocess_one_image_matches_jax(connectivity):
    """postprocess on each image alone == the JAX postprocess, and == the
    port's postprocess_batch row by row (float outputs within 1e-6: the
    plain stats' products sum in another order at another batch size)."""
    logits = _with_classes(blob_logits(3, B=2, n_blobs=5), 3)
    cfg, jcfg = _cfgs(max_components=4, min_component_area=3)
    batch = postprocess_batch(torch.from_numpy(logits), cfg, connectivity)
    for b in range(len(logits)):
        ref = jax.device_get(jax_postprocess(jnp.asarray(logits[b]), jcfg, connectivity))
        out = postprocess(torch.from_numpy(logits[b]), cfg, connectivity)
        assert out["boxes"].shape == (4, 4, 2) and out["num_detections"].shape == ()
        assert_same_detections(out, ref)
        for key in out:
            if out[key].is_floating_point():
                torch.testing.assert_close(out[key], batch[key][b], atol=1e-6, rtol=0)
            else:
                assert torch.equal(out[key], batch[key][b]), key


def _tail_maps(K):
    """Blob maps, the bar and the adversarial maps (some with more
    components than K), with class logits: (B, 32, 32, 5)."""
    det = np.concatenate([blob_logits(K, B=3, n_blobs=9), upright_bar(H=32, W=32, rows=20),
                          adversarial_logits()])
    return _with_classes(det, K + 1)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("K", [4, 16])
def test_xla_tail_from_raw_labels_matches_jax(K, connectivity):
    """roots_from_raw_labels (all maps at once, as leading dims) ->
    eq_from_raw_labels -> finish_from_eq with the true count, image by
    image, against the JAX functions on the same raw labels: roots, masks
    and every int identical, scores and class probs within 1e-6, boxes
    within 1e-4 as corner sets."""
    logits = _tail_maps(K)
    cfg, jcfg = _cfgs(max_components=K, min_component_area=3)
    mask = torch.sigmoid(torch.from_numpy(logits[..., 0])) > cfg.detection_threshold
    raw = label_propagation(mask, connectivity)
    rv, ok = pp.roots_from_raw_labels(raw, K)
    jrv, jok = jpp.roots_from_raw_labels(jnp.asarray(raw.numpy()), K)
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    eq = pp.eq_from_raw_labels(raw, rv, ok)
    np.testing.assert_array_equal(eq.numpy(), np.asarray(jpp.eq_from_raw_labels(jnp.asarray(raw.numpy()), jrv, jok)))
    lin = torch.arange(32 * 32, dtype=torch.int32).reshape(32, 32)
    n_over = 0
    for b in range(len(logits)):
        total = ((raw[b] == lin) & (raw[b] < 32 * 32)).sum().to(torch.int32)
        out = pp.finish_from_eq(torch.from_numpy(logits[b]), eq[b], cfg, num_components_total=total)
        ref = jax.device_get(jpp.finish_from_eq(jnp.asarray(logits[b]), jnp.asarray(eq[b].numpy()), jcfg,
                                                num_components_total=jnp.int32(int(total))))
        assert sorted(out) == sorted(ref)
        assert_same_detections(out, ref)
        n_over += int(total) > K
        none = pp.finish_from_eq(torch.from_numpy(logits[b]), eq[b], cfg)
        assert int(none["num_components_total"]) == int(
            jpp.finish_from_eq(jnp.asarray(logits[b]), jnp.asarray(eq[b].numpy()), jcfg)["num_components_total"])
    assert n_over > 0 or (K, connectivity) == (16, 8)  # maps past K, but for 16 8-connected


@pytest.mark.parametrize("classification", [True, False])
def test_finish_postprocess_matches_jax(classification):
    """finish_postprocess on compact labels (connected_components) against
    the JAX function: num_components_total is the true count past the K
    cut; the detection-only head gives zero classes and unit probs."""
    logits = _tail_maps(4)
    if not classification:
        logits = logits[..., :1]
    cfg, jcfg = _cfgs(max_components=4, min_component_area=3, classification=classification)
    for b in range(len(logits)):
        mask = torch.sigmoid(torch.from_numpy(logits[b, ..., 0])) > cfg.detection_threshold
        labels, n = connected_components(mask)
        out = pp.finish_postprocess(torch.from_numpy(logits[b]), labels, cfg)
        ref = jax.device_get(jpp.finish_postprocess(jnp.asarray(logits[b]), jnp.asarray(labels.numpy()), jcfg))
        assert_same_detections(out, ref)
        assert int(out["num_components_total"]) == int(n)


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_detect_program_batch_xla_route_matches_jax(asset):
    """detect_program_batch(fused=False) on 128x128 scenes == the JAX
    package's XLA route: the same inputs, default hull cap."""
    jcfg, jparams = _jax_asset(asset, max_components=16)
    cfg = load_net_config(ASSETS[asset]).replace(max_components=16)
    reader = SyntheticMarkupReader(n_samples=3, image_hw=(128, 128), seed=33)
    imgs = np.stack([reader.sample_at(i).image for i in range(3)])
    ref, ref_logits = jax.device_get(
        jax_detect_program_batch(jparams, jnp.asarray(imgs), jcfg, (128, 128), fused=False)
    )
    assert np.abs(ref_logits[..., 0]).min() > MARGIN
    out, logits = detect_program_batch(
        load_params(ASSETS[asset]), imgs, cfg, (128, 128), fused=False, device="cpu"
    )
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    assert int(ref["num_detections"].sum()) > 0
    assert_same_detections(out, ref, score_atol=1e-5)


def _scene_512():
    img = SyntheticMarkupReader(n_samples=1, image_hw=(512, 512), seed=8).sample_at(0).image
    jcfg, jparams = _jax_asset("separable")
    return img, jcfg, jparams, load_net_config(ASSETS["separable"])


def test_detect_program_matches_jax_on_a_512_scene():
    """detect_program on one 512x512 scene (the context kernel's route on
    the port's side): logits within 1e-4 of the flax model's, detections
    equal to the JAX detect_program's (scores within 1e-5: conv rounding)."""
    img, jcfg, jparams, cfg = _scene_512()
    ref, ref_logits = jax.device_get(jax_detect_program(jparams, jnp.asarray(img), jcfg, (512, 512)))
    assert np.abs(ref_logits[..., 0]).min() > MARGIN
    out, logits = detect_program(load_params(ASSETS["separable"]), img, cfg, (512, 512),
                                 device="cpu")
    assert logits.shape == (128, 128, 17)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    assert int(ref["num_detections"]) > 0
    assert_same_detections(out, ref, score_atol=1e-5)


def test_detector_detect_and_heatmap_match_jax_on_a_512_scene():
    """BarcodeDetector.detect and .heatmap on the same scene, RGB, against
    the JAX detector's."""
    img, jcfg, jparams, cfg = _scene_512()
    rgb = np.stack([img, np.clip(img.astype(int) + 5, 0, 255), img], -1).astype(np.uint8)
    jdet = JaxBarcodeDetector(jcfg, jparams)
    det = BarcodeDetector(cfg, load_params(ASSETS["separable"]), device="cpu")
    heat, ref_heat = det.heatmap(rgb), jdet.heatmap(rgb)
    assert heat.shape == ref_heat.shape == (128, 128)
    np.testing.assert_allclose(heat, ref_heat, atol=1e-5)
    assert np.abs(ref_heat - 0.5).min() > MARGIN / 4
    ref, out = jdet.detect(rgb), det.detect(rgb)
    assert len(ref) > 0 and len(out) == len(ref)
    for o, r in zip(out, ref):
        assert (o.class_id, o.class_name, o.area) == (r.class_id, r.class_name, r.area)
        assert abs(o.score - r.score) < 1e-5
        assert_same_boxes(o.box[None], r.box[None], 1e-3)
        np.testing.assert_allclose(o.center, r.center, atol=1e-3)


def striped_bar_page(seed=1):
    """A (1, 512, 128) uint8 page, flat gray, with one upright 1D-code
    band 400 px tall and 40 wide, its stripes constant down the band: the
    detection mask's edges are straight, so each chain holds about 100
    collinear points, more than the asset's max_hull_points=64."""
    rng = np.random.default_rng(seed)
    img = np.full((512, 128), 210, np.uint8)
    stripes = np.repeat(rng.random(20) < 0.5, rng.integers(2, 5, 20))[:40]
    img[40:440, 44 : 44 + len(stripes)] = np.where(stripes, 0, 255)
    return img[None]


def _port_mode(mode, img):
    """The asset's config and weights in f32, bf16 (the weights cast, as
    bench.py does) or int8 (qparams calibrated on the CPU on the page)."""
    from ubdvss_tpu_torch.ops.quant import quantize_trunk

    cfg = load_net_config(ASSETS["separable"])
    params = load_params(ASSETS["separable"])
    if mode == "bfloat16":
        return cfg.replace(dtype="bfloat16"), {k: v.to(torch.bfloat16) for k, v in params.items()}, {}
    if mode == "int8":
        calib = torch.from_numpy((img.astype(np.float32) / 127.5 - 1.0)[..., None])
        return cfg, params, dict(qparams=quantize_trunk(params, cfg, calib))
    return cfg, params, {}


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_fused_none_takes_the_exact_route_on_the_cpu(mode):
    """``fused=None`` resolves by the device, as the JAX package resolves it
    by the backend (ubdvss_tpu/inference.py:159-160, :478-479): on the CPU
    ``detect_program_batch`` and ``detect_preprocessed_batch`` take the XLA
    route, bit for bit the ``fused=False`` call, on the f32, bf16 and int8
    branches.  The upright bar's box is then 400 px tall, as JAX's CPU
    default gives it (f32: detections equal), while ``fused=True`` still
    compacts each chain to its first 64 points and cuts the box short."""
    img = striped_bar_page()
    cfg, params, kw = _port_mode(mode, img)
    x = (img.astype(np.float32) / 127.5 - 1.0)[..., None]
    runs = {}
    for fused in (None, False, True):
        runs[fused] = (
            detect_program_batch(params, img, cfg, (512, 128), fused=fused, device="cpu", **kw)[0],
            detect_preprocessed_batch(params, x, cfg, fused=fused, device="cpu", **kw)[0],
        )
    for default, xla in zip(runs[None], runs[False]):
        for key in xla:
            assert torch.equal(default[key], xla[key]), key
    default, fused = runs[None][0], runs[True][0]
    assert int(default["num_detections"][0]) == int(fused["num_detections"][0]) == 1
    tall = float(default["size"][0, 0].max())
    assert tall >= 396 and float(fused["size"][0, 0].max()) < tall - 50
    if mode == "float32":
        jcfg, jparams = _jax_asset("separable")
        ref, ref_logits = jax.device_get(jax_detect_program_batch(jparams, jnp.asarray(img), jcfg,
                                                                  (512, 128)))
        assert np.abs(ref_logits[..., 0]).min() > MARGIN
        assert_same_detections(default, ref, score_atol=1e-5)


def tall_page(seed=0):
    """A (4160, 64) uint8 page (a 1040x16 heatmap, taller than 1024 rows)
    with one 2D-code-like band 33 px wide over all but its first and last
    20 rows, slanted by 0.004 px a row: one component of 1032 heatmap rows
    whose chains are long staircases."""
    H, W = 4160, 64
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 210.0, np.float32) + rng.normal(0, 6, (H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    u = xx - (32 + 0.004 * (yy - H / 2))
    inside = (np.abs(u) <= 16) & (yy >= 20) & (yy < H - 20)
    grid = rng.random((H // 6 + 2, W // 6 + 8)) < 0.5
    dark = grid[yy // 6, ((u + 16) // 6).astype(int).clip(0, W // 6 + 7)]
    img[inside] = np.where(dark[inside], 0.0, 255.0)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_detect_program_on_a_tall_page_matches_jax():
    """detect_program on a page whose heatmap is taller than 1024 rows (K3x's
    plain version here) against the JAX detect_program on the CPU: logits
    within 1e-4; labels, valid, areas and classes identical, scores within
    1e-5, boxes within 1e-3 px as corner sets (at 4096 px and beyond one f32
    ulp is 4.9e-4 px, so 1e-4 is below the resolution of either side)."""
    img = tall_page()
    jcfg, jparams = _jax_asset("separable", max_components=4)
    cfg = load_net_config(ASSETS["separable"]).replace(max_components=4)
    ref, ref_logits = jax.device_get(jax_detect_program(jparams, jnp.asarray(img), jcfg, img.shape))
    assert np.abs(ref_logits[..., 0]).min() > MARGIN
    out, logits = detect_program(load_params(ASSETS["separable"]), img, cfg, img.shape,
                                 device="cpu")
    assert logits.shape == (1040, 16, 17)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    assert int(ref["num_detections"]) == 1
    assert float(np.asarray(ref["size"])[0].max()) > 1024 * cfg.scale
    assert_same_detections(out, ref, score_atol=1e-5, box_atol=1e-3)

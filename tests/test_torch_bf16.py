"""PyTorch port: the bf16 mode (``NetConfig(dtype="bfloat16")``, the JAX
package's throughput mode) on the CPU, held against the JAX package on
the same inputs, with the weights cast to bf16 as ``bench.py:290-291``
casts them.

Bit equality with the JAX package is not the bar here: XLA's CPU backend
may keep f32 precision across fused bf16 elementwise ops, and its convs
sum in another order than oneDNN's, so one bf16 rounding may fall the
other way and the difference then travels through the later layers.  The
tolerances, each stated beside its test with the largest difference
measured on these inputs:

  * logits in bf16 ulps of max|logit| (one ulp = 2^-8 of it);
  * detections by ``assert_bf16_detections``: a pixel may change sides of
    the threshold only where its detection logit lies within the logit
    tolerance of the threshold, and an image where one did is left out;
    in every other image valid, areas, classes and counts are identical
    (a class id only where its top two mean probabilities are further
    apart than the class tolerance), boxes within 1.5 px as corner sets
    (the JAX package's bound between its own routes,
    tests/test_quant.py:160-166), scores and class probabilities within
    their stated tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_model import ASSETS
from test_torch_rect import assert_same_boxes

from ubdvss_tpu.inference import BarcodeDetector as JaxBarcodeDetector
from ubdvss_tpu.inference import detect_program as jax_detect_program
from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch
from ubdvss_tpu.models.model import dense_equivalent_apply as jax_dense_equivalent_apply
from ubdvss_tpu.models.model import get_model as jax_get_model
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.models.model import param_count as jax_param_count
from ubdvss_tpu.ops.pallas import context_kernel as jax_ck
from ubdvss_tpu.ops.pallas.postproc_kernel import (
    component_stats_from_logits as jax_component_stats_from_logits,
)
from ubdvss_tpu.ops.postproc import postprocess_batch_fused as jax_postprocess_batch_fused
from ubdvss_tpu.ops.preproc import preprocess as jax_preprocess
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import (
    BarcodeDetector,
    StreamingDetector,
    detect_preprocessed_batch,
    detect_program,
    detect_program_batch,
    get_model,
    load_net_config,
    params_from_flat,
)
from ubdvss_tpu_torch.models.model import dense_equivalent_apply, param_count
from ubdvss_tpu_torch.ops.cuda import context_kernel
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import threshold_logit
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_stats_from_logits
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

BF16_ULP = 2.0**-8  # of max|logit|
FCN_ULPS = 2  # BarcodeFCN's logits (flax's layers: depthwise, then pointwise)
LOGIT_ULPS = 4  # the fused route's logits (the dense-equivalent context)
SCORE_TOL = 1e-3  # mean detection probability of a component
CLS_TOL = 1e-2  # mean class probabilities of a component
BOX_PX = 1.5


@functools.lru_cache(maxsize=None)
def _jax_bf16(asset, max_components=16):
    """The JAX config and flax params of an asset in the bf16 mode, the
    weights cast to bf16 as bench.py does."""
    jcfg = jax_load_net_config(ASSETS[asset]).replace(
        dtype="bfloat16", max_components=max_components)
    params = jax_load_params_npz(ASSETS[asset], init_params(jcfg, 0))
    return jcfg, jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)


def _flat(jparams) -> dict:
    """flax params -> the flat "/"-keyed host arrays of a weight file."""
    return flatten_dict(jax.device_get(jparams), sep="/")


@functools.lru_cache(maxsize=None)
def _port_bf16(asset, max_components=16):
    cfg = load_net_config(ASSETS[asset]).replace(dtype="bfloat16", max_components=max_components)
    return cfg, params_from_flat(_flat(_jax_bf16(asset, max_components)[1]))


def _scenes(n, hw, seed):
    reader = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed)
    return np.stack([reader.sample_at(i).image for i in range(n)])


def _ulps(out, ref) -> float:
    """max |out - ref| in bf16 ulps of max|ref|."""
    return float(np.abs(np.asarray(out, np.float32) - np.asarray(ref, np.float32)).max()
                 / (np.abs(np.asarray(ref, np.float32)).max() * BF16_ULP))


def assert_bf16_detections(out, ref, port_logits, ref_logits, cfg, logit_ulps=LOGIT_ULPS,
                           score_tol=SCORE_TOL, cls_tol=CLS_TOL) -> dict:
    """The rule of the module docstring.  Returns what was measured: the
    images left out, the largest score, class-probability and box
    differences."""
    out = {k: np.asarray(v) for k, v in out.items()}
    ref = {k: np.asarray(v) for k, v in ref.items()}
    pl = np.asarray(port_logits, np.float32)[..., 0]
    rl = np.asarray(ref_logits, np.float32)[..., 0]
    thr = threshold_logit(cfg.detection_threshold)
    tol = logit_ulps * BF16_ULP * np.abs(np.asarray(ref_logits, np.float32)).max()
    flipped = (pl > thr) != (rl > thr)
    assert (np.abs(rl[flipped] - thr) <= tol).all(), "a mask differs away from the threshold"
    keep = ~flipped.reshape(len(pl), -1).any(1)
    assert keep.sum() >= max(1, len(keep) // 2)
    for key in ("valid", "areas", "num_detections", "num_components_total"):
        np.testing.assert_array_equal(out[key][keep], ref[key][keep], err_msg=key)
    v = ref["valid"][keep]
    assert v.any()
    srt = np.sort(ref["class_probs"][keep], -1)
    sure = v & (srt[..., -1] - srt[..., -2] > cls_tol)
    np.testing.assert_array_equal(out["classes"][keep][sure], ref["classes"][keep][sure])
    d_score = np.abs(out["scores"][keep][v] - ref["scores"][keep][v]).max()
    d_cls = np.abs(out["class_probs"][keep][v] - ref["class_probs"][keep][v]).max()
    assert d_score <= score_tol and d_cls <= cls_tol, (d_score, d_cls)
    assert_same_boxes(out["boxes"][keep][v], ref["boxes"][keep][v], BOX_PX)
    d_box = np.abs(out["boxes"][keep][v] - ref["boxes"][keep][v]).max()
    return {"left_out": int((~keep).sum()), "score": d_score, "cls": d_cls, "box": d_box}


def test_net_config_dtype_matches_jax():
    """``dtype`` takes "float32" and "bfloat16", as the JAX package's
    NetConfig does, with the same JSON; ``compute_dtype`` is the torch
    dtype, and an entry point refuses any other dtype."""
    from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
    from ubdvss_tpu_torch import NetConfig

    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = NetConfig(dtype=name)
        assert cfg.to_json() == JaxNetConfig(dtype=name).to_json()
        assert NetConfig.from_json(cfg.to_json()).compute_dtype == dt
    _, params = _port_bf16("separable")
    with pytest.raises(ValueError, match="float16"):
        detect_program_batch(params, np.zeros((1, 64, 64), np.uint8),
                             NetConfig(dtype="float16"), (64, 64), device="cpu")


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_params_from_flat_carries_bf16_params_bit_for_bit(asset):
    """JAX params cast to bf16 (ml_dtypes arrays from jax.device_get) reach
    the port's state_dict exactly: the f32 upcast of each value, and back in
    bf16 the same bits.  param_count equals the JAX package's."""
    _, jparams = _jax_bf16(asset)
    flat = _flat(jparams)
    assert all(a.dtype == ml_dtypes.bfloat16 for a in flat.values())
    params = params_from_flat(flat)
    for key, arr in flat.items():
        t = params[key.replace("/kernel", "/weight").replace("/", ".")]
        ref = np.asarray(arr, np.float32)
        if ref.ndim == 4:
            ref = ref.transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(t.numpy(), ref)
        bits = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        want = np.ascontiguousarray(arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr)
        np.testing.assert_array_equal(bits, want.view(np.uint16))
    assert param_count(params) == jax_param_count(jparams) == param_count(flat)


@pytest.mark.parametrize("hw", [64, 128])
@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_bf16_fcn_matches_flax(asset, hw):
    """BarcodeFCN in bf16 against flax's get_model(cfg).apply in bf16 on
    normalized scenes: within FCN_ULPS bf16 ulps of max|logit| (measured:
    equal bit for bit on both assets at 64² and 128²)."""
    jcfg, jparams = _jax_bf16(asset)
    cfg, params = _port_bf16(asset)
    x = _scenes(2, (hw, hw), hw)
    x = (x.astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]
    ref = np.asarray(jax_get_model(jcfg).apply({"params": jparams}, jnp.asarray(x)))
    model = get_model(cfg)
    model.load_state_dict(params)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert _ulps(out.numpy(), ref) <= FCN_ULPS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_dense_equivalent_apply_matches_jax(asset, dtype):
    """dense_equivalent_apply against the JAX function on 128² scenes: f32
    within max(1e-5, 1e-6 max|logit|) (the bar of test_fcn_matches_flax;
    measured 1.1e-5 at |logit| 26, 2.7e-5 at 52 on the dense asset); bf16,
    where the rank-1 kernel is a bf16 product of bf16 factors, within 2
    bf16 ulps of max|logit| (measured 1.26 on the separable asset, 0 on the
    dense one)."""
    if dtype == "float32":
        jcfg = jax_load_net_config(ASSETS[asset])
        jparams = jax_load_params_npz(ASSETS[asset], init_params(jcfg, 0))
        cfg = load_net_config(ASSETS[asset])
        params = params_from_flat(_flat(jparams))
    else:
        jcfg, jparams = _jax_bf16(asset)
        cfg, params = _port_bf16(asset)
    x = _scenes(2, (128, 128), 128)
    x = (x.astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]
    ref = np.asarray(jax_dense_equivalent_apply(jparams, jnp.asarray(x), jcfg))
    with torch.no_grad():
        out = dense_equivalent_apply(params, torch.from_numpy(x), cfg).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=max(1e-5, 1e-6 * np.abs(ref).max()))
    else:
        assert _ulps(out, ref) <= 2


def test_bf16_trunk_pieces_match_jax():
    """The bf16 trunk of the fused route piece by piece against the JAX
    functions on uint8 128² scenes fed as bf16: stem_apply(raw_gray=True)
    within 1 bf16 ulp of max|feature| (measured 0.21: one feature of
    98,304 differs); dense_context_head(act_out=True) on the JAX stem's
    features, bf16 logits within 2 ulps of max|logit| (measured 1.0);
    fused_model_apply(act_out=True) within LOGIT_ULPS (measured 0.97)."""
    jcfg, jparams = _jax_bf16("separable")
    cfg, params = _port_bf16("separable")
    imgs = _scenes(4, (128, 128), 21)
    xj = jnp.asarray(imgs).astype(jnp.bfloat16)[..., None]
    xt = torch.from_numpy(imgs).to(torch.bfloat16)[..., None]
    feat_ref = np.asarray(jax_ck.stem_apply(jparams, xj, jcfg, raw_gray=True))
    with torch.no_grad():
        feat = context_kernel.stem_apply(params, xt, cfg, raw_gray=True)
    assert feat.dtype == torch.float32
    assert _ulps(feat.numpy(), feat_ref) <= 1
    dil = tuple(jcfg.dilations)
    w_ref = jax_ck._pack_weights(jparams, dil)
    head_ref = jax_ck.dense_context_head(
        jnp.asarray(feat_ref), *w_ref, dil, act_dtype=jnp.bfloat16, act_out=True)
    assert head_ref.dtype == jnp.bfloat16
    with torch.no_grad():
        w = context_kernel._pack_weights(params, dil)
        head = context_kernel.dense_context_head(
            torch.from_numpy(np.array(feat_ref)), *w, dil, act_dtype=torch.bfloat16,
            act_out=True)
    assert head.dtype == torch.bfloat16
    assert _ulps(head.float().numpy(), np.asarray(head_ref.astype(jnp.float32))) <= 2
    ref = jax_ck.fused_model_apply(jparams, xj, jcfg, raw_gray=True, act_out=True)
    with torch.no_grad():
        out = context_kernel.fused_model_apply(params, xt, cfg, raw_gray=True, act_out=True)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    assert _ulps(out.float().numpy(), np.asarray(ref.astype(jnp.float32))) <= LOGIT_ULPS


def test_bf16_stats_match_jax():
    """The plain stats on bf16 logits (32x48 blob maps, 5 channels) against
    the JAX package's component_stats_from_logits (interpret mode): the
    class softmax in f32, rounded to bf16, summed in f32.  Geometry and
    areas identical; det_sums / areas and cls_sums / areas within 2e-6
    (measured 4.2e-7 and 8.9e-8).  The unrounded f32 softmax's means
    differ from JAX's by more than 1e-5, so the check sees the rounding."""
    from test_torch_ccl import blob_logits

    rng = np.random.default_rng(32)
    logits = rng.normal(0, 2, (3, 32, 48, 5)).astype(np.float32)
    logits[..., 0] = blob_logits(48, B=3, H=32, W=48, n_blobs=5)
    lg16 = torch.from_numpy(logits).to(torch.bfloat16)
    ref = jax.device_get(jax_component_stats_from_logits(
        jnp.asarray(lg16.float().numpy()).astype(jnp.bfloat16), 8, interpret=True))
    out = component_stats_from_logits(lg16, 8)
    for key in ("rootvals", "minx", "maxx", "labels", "num_components_total", "areas"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    area = np.maximum(np.asarray(ref["areas"]), 1)
    np.testing.assert_allclose(out["det_sums"].numpy() / area, ref["det_sums"] / area, atol=2e-6)
    np.testing.assert_allclose(out["cls_sums"].numpy() / area[..., None],
                               ref["cls_sums"] / area[..., None], atol=2e-6)
    unrounded = component_stats_from_logits(lg16.float(), 8)["cls_sums"].numpy()
    assert np.abs(unrounded / area[..., None] - ref["cls_sums"] / area[..., None]).max() > 1e-5


def _jax_fused(jparams, jcfg, x, raw):
    """What the JAX package's fused program runs on a (B, H, W) batch:
    fused_model_apply(act_out=True) -> postprocess_batch_fused (interpret
    mode).  Returns (res, f32 logits)."""
    logits = jax_ck.fused_model_apply(jparams, x[..., None], jcfg, raw_gray=raw, act_out=True)
    res = jax_postprocess_batch_fused(logits, jcfg, interpret=True)
    return jax.device_get(res), np.asarray(logits.astype(jnp.float32))


@pytest.mark.parametrize("case", ["raw", "resize", "strips"])
def test_bf16_detect_program_batch_fused_matches_jax(case):
    """detect_program_batch's fused route in bf16 (device="cpu"), against
    the JAX package's fused program on the same scenes: raw 128² uint8
    scenes (fed as bf16, the stem's fold), RGB scenes resized 150x130 ->
    128x128 (f32 until the stem), and n_strips=2 on raw 576x128 scenes
    (against the whole trunk's program).  Logits within LOGIT_ULPS
    (measured 0.97, 1.32 and 1.47), detections by assert_bf16_detections
    (measured: no image left out; scores within 7.3e-5, 2.2e-4 and 8.2e-5,
    class probabilities 5.5e-4, 4.6e-4 and 2.4e-4, box corners 1.5e-5,
    2.3e-5 and 1.5e-4 px).  The returned logits are f32."""
    jcfg, jparams = _jax_bf16("separable")
    cfg, params = _port_bf16("separable")
    kw = {}
    if case == "resize":
        gray = _scenes(4, (150, 130), 22)
        imgs = np.stack([gray, np.clip(gray.astype(int) + 9, 0, 255), gray], -1).astype(np.uint8)
        xj = jax.vmap(lambda im: jax_preprocess(im, (128, 128), "rgb"))(jnp.asarray(imgs))[..., 0]
        raw = False
    elif case == "raw":
        imgs = _scenes(4, (128, 128), 21)
    else:  # two row strips need a strip taller than twice the halo
        imgs = _scenes(2, (576, 128), 25)
        kw = dict(n_strips=2)
    if case != "resize":
        xj = jnp.asarray(imgs).astype(jnp.bfloat16)
        raw = True
    ref, ref_logits = _jax_fused(jparams, jcfg, xj, raw)
    out, logits = detect_program_batch(params, imgs, cfg, (128, 128) if raw is False else
                                       imgs.shape[1:3], fused=True, device="cpu", **kw)
    assert logits.dtype == torch.float32
    assert _ulps(logits.numpy(), ref_logits) <= LOGIT_ULPS
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_bf16_detections(out, ref, logits, ref_logits, cfg)


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_bf16_xla_route_matches_jax(asset):
    """detect_program_batch(fused=False) in bf16 runs BarcodeFCN in bf16
    and the XLA route's postprocessing, as the JAX package's does: against
    JAX's on 128² scenes, logits within FCN_ULPS (measured 0.58 on either
    asset), detections by assert_bf16_detections (measured: scores 3.1e-5
    and 3.0e-4, class probabilities 2.6e-5 and 2.0e-3, dense and separable
    asset)."""
    jcfg, jparams = _jax_bf16(asset)
    cfg, params = _port_bf16(asset)
    imgs = _scenes(3, (128, 128), 23)
    ref, ref_logits = jax.device_get(
        jax_detect_program_batch(jparams, jnp.asarray(imgs), jcfg, (128, 128), fused=False))
    out, logits = detect_program_batch(params, imgs, cfg, (128, 128), fused=False, device="cpu")
    assert _ulps(logits.numpy(), ref_logits) <= FCN_ULPS
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_bf16_detections(out, ref, logits, ref_logits, cfg, logit_ulps=FCN_ULPS)


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_bf16_detect_program_and_detector_match_jax(asset):
    """detect_program, BarcodeDetector.detect and .heatmap in bf16 against
    the JAX package's on a 240x320 camera frame (the asset's config, K=64:
    exact rects): logits within FCN_ULPS (measured 0.57 and 1.07, dense
    and separable asset), detections by assert_bf16_detections (measured:
    scores 3.2e-6 and 4.6e-6, class probabilities 4.1e-4 and 4.5e-3); the
    heatmap within a quarter of the logit tolerance (the sigmoid's largest
    slope; measured 4.7e-4 and 2.9e-3); the detector's boxes within 1.5
    px, classes and areas identical, scores within SCORE_TOL."""
    jcfg, jparams = _jax_bf16(asset, 64)
    cfg, params = _port_bf16(asset, 64)
    img = _scenes(1, (240, 320), 12)[0]
    out_hw = cfg.grid_size(240, 320)
    ref, ref_logits = jax.device_get(jax_detect_program(jparams, jnp.asarray(img), jcfg, out_hw))
    out, logits = detect_program(params, img, cfg, out_hw, device="cpu")
    assert logits.dtype == torch.float32
    assert _ulps(logits.numpy(), ref_logits) <= FCN_ULPS
    assert_bf16_detections({k: v[None] for k, v in out.items()},
                           {k: np.asarray(v)[None] for k, v in ref.items()},
                           logits[None], ref_logits[None], cfg, logit_ulps=FCN_ULPS)
    jdet = JaxBarcodeDetector(jcfg, jparams)
    det = BarcodeDetector(cfg, params, device="cpu")
    np.testing.assert_allclose(det.heatmap(img), jdet.heatmap(img),
                               atol=0.25 * FCN_ULPS * BF16_ULP * np.abs(ref_logits).max())
    want, got = jdet.detect(img), det.detect(img)
    assert len(want) > 0 and len(got) == len(want)
    for o, r in zip(got, want):
        assert (o.class_id, o.class_name, o.area) == (r.class_id, r.class_name, r.area)
        assert abs(o.score - r.score) <= SCORE_TOL
        assert_same_boxes(o.box[None], r.box[None], BOX_PX)


def test_bf16_detect_preprocessed_batch_matches_jax():
    """detect_preprocessed_batch in bf16 on normalized 128² scenes (the
    fused route: the stem casts them to bf16) against the JAX package's
    fused program on the same images; tolerances as the fused route's
    (measured: logits 0.65 ulps, scores 9.7e-5, class probabilities
    3.9e-4)."""
    jcfg, jparams = _jax_bf16("separable")
    cfg, params = _port_bf16("separable")
    x = _scenes(4, (128, 128), 24)
    x = (x.astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]
    ref, ref_logits = _jax_fused(jparams, jcfg, jnp.asarray(x[..., 0]), False)
    out, logits = detect_preprocessed_batch(params, x, cfg, fused=True, device="cpu")
    assert logits.dtype == torch.float32
    assert _ulps(logits.numpy(), ref_logits) <= LOGIT_ULPS
    assert_bf16_detections(out, ref, logits, ref_logits, cfg)


def test_bf16_stream_matches_jax():
    """StreamingDetector in bf16 (device="cpu", 120x160 frames, batch 4, a
    padded tail) against the JAX package's stream on the CPU, frame by
    frame, under assert_bf16_detections: both resolve ``fused=None`` to the
    XLA route off their accelerator (BarcodeFCN in bf16, exact rects), so
    the reference is JAX's ``detect_program_batch(fused=False)`` on the
    same frames, logits within FCN_ULPS."""
    jcfg, jparams = _jax_bf16("separable")
    cfg, params = _port_bf16("separable")
    frames = _scenes(10, (120, 160), 13)
    ref, ref_logits = jax.device_get(
        jax_detect_program_batch(jparams, jnp.asarray(frames), jcfg, (120, 160), fused=False))
    port = StreamingDetector(cfg, params, (120, 160), batch_size=4, device="cpu")
    got = list(port.process(iter(frames)))
    assert [i for i, _ in got] == list(range(10))
    out = {k: np.stack([d[k] for _, d in got]) for k in got[0][1]}
    logits = []  # the stream's own batches, the tail padded with zero frames
    for b0 in range(0, 10, 4):
        batch = np.zeros((4, 120, 160), np.uint8)
        batch[: len(frames[b0:b0 + 4])] = frames[b0:b0 + 4]
        logits.append(detect_program_batch(params, batch, cfg, (120, 160), device="cpu")[1])
    logits = torch.cat(logits)[:10]
    assert _ulps(logits.numpy(), ref_logits) <= FCN_ULPS
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_bf16_detections(out, ref, logits, ref_logits, cfg, logit_ulps=FCN_ULPS)

"""PyTorch port: the int8 serving mode (``ops/quant.py``, the JAX package's
production serving route) on the CPU, held against the JAX package's
jitted functions on the same inputs.

Bit equality is the bar wherever the integer path decides: the JAX
package's jitted ``_qconv`` rounds ``acc * ws + b`` once (XLA fuses it into
a multiply-add), and so does the port (``qconv_kernel``'s docstring), so
given the same qparams every requantized activation and every f32 logit
is equal.  The calibration side runs f32 convolutions, which sum in
another order than XLA's: scales within rtol 1e-5, logits within 2e-5
(``tests/test_quant.py:42``), corrected biases within 1e-5.  Detections of
the int8 entry points on the same qparams follow ``assert_same_detections``
(masks, areas, classes and counts identical, scores within 1e-6, boxes
within 1e-4 as corner sets).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_model import ASSETS, load_params
from test_torch_postproc import assert_same_detections

from ubdvss_tpu import NetConfig as JaxNetConfig
from ubdvss_tpu.inference import BarcodeDetector as JaxBarcodeDetector
from ubdvss_tpu.inference import _detect_program_batch_int8 as _jax_detect_program_batch_int8
from ubdvss_tpu.inference import detect_preprocessed_batch as jax_detect_preprocessed_batch
from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.ops import quant as jq
from ubdvss_tpu.ops.postproc import postprocess_batch_fused as jax_postprocess_batch_fused
from ubdvss_tpu.streaming import StreamingDetector as JaxStreamingDetector
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import (
    BarcodeDetector,
    NetConfig,
    StreamingDetector,
    detect_preprocessed_batch,
    detect_program_batch,
    load_net_config,
    params_from_flat,
    qparams_from_numpy,
)
from ubdvss_tpu_torch.models.model import conv2d_same
from ubdvss_tpu_torch.ops import quant as pq
from ubdvss_tpu_torch.ops.cuda import qconv_kernel
from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

# narrow random configs: dilation 16 puts every off-centre tap of a 16x16
# map into the padding; the dense one is a separable_context=False model
NARROW = {
    "separable": dict(channels=8, dilations=(1, 2, 16), max_components=8),
    "dense": dict(channels=8, dilations=(1, 4, 16), separable_context=False, max_components=8),
}


def _scenes(n, hw, seed):
    reader = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed)
    return np.stack([reader.sample_at(i).image for i in range(n)])


def _norm(raw):
    """bench.py's calibration images: u8 / 127.5 - 1 in numpy, (N, H, W, 1)."""
    return (raw.astype(np.float32) / 127.5 - 1.0)[..., None]


@functools.lru_cache(maxsize=None)
def _models(kind):
    """(JAX cfg, JAX params, port cfg, port params) of an asset ("separable",
    "dense", K=16) or of a narrow random config ("narrow-separable", ...)."""
    if kind.startswith("narrow-"):
        kw = NARROW[kind[len("narrow-"):]]
        jcfg, cfg = JaxNetConfig(**kw), NetConfig(**kw)
        jparams = init_params(jcfg, 0)
        return jcfg, jparams, cfg, params_from_flat(flatten_dict(jax.device_get(jparams), sep="/"))
    jcfg = jax_load_net_config(ASSETS[kind]).replace(max_components=16)
    cfg = load_net_config(ASSETS[kind]).replace(max_components=16)
    return jcfg, jax_load_params_npz(ASSETS[kind], init_params(jcfg, 0)), cfg, load_params(ASSETS[kind])


@functools.lru_cache(maxsize=None)
def _jax_qparams(kind, hw=64):
    """The JAX package's qparams calibrated on 4 scenes (seed 5), as host
    arrays, and the port's copy of them."""
    jcfg, jparams, _, _ = _models(kind)
    q = jax.tree.map(np.asarray, jq.quantize_trunk(jparams, jcfg, jnp.asarray(_norm(_scenes(4, (hw, hw), 5)))))
    return q, qparams_from_numpy(q)


def _jax_trunk_steps(q, x, jcfg, raw_gray):
    """Every requantized activation of the JAX package's int8 trunk and its
    logits, each layer through the jitted ``_qconv``."""
    qconv = jax.jit(jq._qconv, static_argnums=(3, 4))
    qx = jax.jit(jq._quantize_input, static_argnums=1)(jnp.asarray(x), raw_gray)
    s, L, outs = q["s_in"], q["layers"], []
    for i, (st, d) in enumerate([((2, 2), (1, 1))] * 2 + [((1, 1), (d, d)) for d in jcfg.dilations]):
        qx = qconv(qx, L[i], s[i + 1], st, d)
        outs.append(np.asarray(qx))
    outs.append(np.asarray(qconv(qx, q["head"], None, (1, 1), (1, 1))))
    return outs


@pytest.mark.parametrize("kind", ["narrow-separable", "narrow-dense", "separable"])
def test_qweight_and_build_qparams_identical(kind):
    """Same f32 params and scales -> the same int8 kernels and ws, bit for
    bit (the rank-1 product, the scale folding and the rounding)."""
    jcfg, jparams, cfg, params = _models(kind)
    rng = np.random.default_rng(1)
    k = rng.normal(0, 0.3, (3, 3, 8, 12)).astype(np.float32)
    k[..., 3] = 0.0  # an all-zero output channel: the 1e-12 floor
    jqk, jws = jq._qweight(jnp.asarray(k))
    qk, ws = pq._qweight(torch.from_numpy(k))
    np.testing.assert_array_equal(qk.numpy(), np.asarray(jqk))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    scales = [np.full((1,), 127.0, np.float32)] + [
        rng.uniform(20, 200, cfg.channels).astype(np.float32) for _ in range(1 + len(cfg.dilations) + 1)
    ]
    jb = jq.build_qparams(jparams, jcfg, [jnp.asarray(s) for s in scales])
    pb = pq.build_qparams(params, cfg, [torch.from_numpy(s) for s in scales])
    for a, b in zip(jb["layers"] + [jb["head"]], pb["layers"] + [pb["head"]]):
        np.testing.assert_array_equal(b["q"].numpy(), np.asarray(a["q"]))
        np.testing.assert_array_equal(b["ws"].numpy(), np.asarray(a["ws"]))
        np.testing.assert_array_equal(b["b"].numpy(), np.asarray(a["b"]))


@pytest.mark.parametrize("kind", ["narrow-dense", "separable"])
def test_calibration_matches_jax(kind):
    """trunk_intermediates' logits within 2e-5, calibrate_scales within
    rtol 1e-5 (f32 convs, summed in another order)."""
    jcfg, jparams, cfg, params = _models(kind)
    x = _norm(_scenes(3, (64, 64), 5))
    jacts, jlog = jq.trunk_intermediates(jparams, jnp.asarray(x), jcfg)
    acts, logits = pq.trunk_intermediates(params, torch.from_numpy(x), cfg)
    assert len(acts) == len(jacts) == 2 + len(cfg.dilations)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=2e-5, rtol=0)
    js = jq.calibrate_scales(jparams, jcfg, jnp.asarray(x))
    ps = pq.calibrate_scales(params, cfg, torch.from_numpy(x))
    for a, b in zip(js, ps):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=0)


def test_calib_tiles_match_jax():
    x = np.random.default_rng(2).normal(0, 0.5, (2, 1030, 600, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        pq._calib_tiles(torch.from_numpy(x)).numpy(), np.asarray(jq._calib_tiles(jnp.asarray(x))))


@pytest.mark.parametrize("kind", ["narrow-separable", "separable"])
def test_bias_correction_matches_jax(kind):
    """The same uncorrected qparams -> corrected biases within 1e-5 (the
    f32 targets and the means sum in another order); kernels, ws and s_in
    untouched."""
    jcfg, jparams, cfg, params = _models(kind)
    x = _norm(_scenes(4, (64, 64), 9))
    jb = jq.build_qparams(jparams, jcfg, jq.calibrate_scales(jparams, jcfg, jnp.asarray(x)))
    jc = jax.tree.map(np.asarray, jq.bias_correct_qparams(jb, jparams, jcfg, jnp.asarray(x)))
    pb = qparams_from_numpy(jax.tree.map(np.asarray, jb))
    pc = pq.bias_correct_qparams(pb, params, cfg, torch.from_numpy(x))
    for a, b, u in zip(jc["layers"] + [jc["head"]], pc["layers"] + [pc["head"]],
                       pb["layers"] + [pb["head"]]):
        np.testing.assert_allclose(b["b"].numpy(), a["b"], atol=1e-5, rtol=0)
        assert b["q"] is u["q"] and b["ws"] is u["ws"]
    assert pc["s_in"] is pb["s_in"]


def _gray_of_rgb(seed, shape=(2, 40, 52)):
    """The f32 gray of random RGB pixels; its last row holds f32 values
    within 8 ulps of an x * (127/127.5) - 127 = k + 1/2 boundary where one
    rounding and two round apart."""
    rgb = np.random.default_rng(seed).integers(0, 256, shape + (3,), dtype=np.uint8)
    gray = np.array(jax.jit(lambda v: v @ jnp.asarray([0.299, 0.587, 0.114], jnp.float32))(
        rgb.astype(np.float32)))
    c = np.float32(127 / 127.5)
    ties = ((np.arange(-127, 127) + 127.5) / np.float64(c)).astype(np.float32)
    near = (ties.view(np.int32)[:, None] + np.arange(-8, 9)).ravel().view(np.float32)
    apart = np.round((near.astype(np.float64) * c - 127).astype(np.float32)) != np.round(
        near * c - np.float32(127))
    gray[-1, -1] = np.resize(near[apart], shape[-1])
    return gray


@pytest.mark.parametrize("mode", ["raw-uint8", "raw-rgb-gray", "normalized"])
def test_quantize_input_bit_for_bit(mode):
    """The input quantization against the jitted JAX function: the raw
    recipe x * (127/127.5) - 127 is one fused multiply-add under jit."""
    rng = np.random.default_rng(4)
    if mode == "raw-uint8":
        x = np.tile(np.arange(256, dtype=np.uint8), (2, 3, 1))
    elif mode == "raw-rgb-gray":
        x = _gray_of_rgb(4)
    else:  # every value in [-1, 1] at .5 / 127 steps, plus noise
        x = np.concatenate([np.arange(-254, 255, dtype=np.float32) / 254.0,
                            rng.uniform(-1.1, 1.1, 1539).astype(np.float32)]).reshape(2, 16, 64, 1)
    raw = mode != "normalized"
    ref = np.asarray(jax.jit(jq._quantize_input, static_argnums=1)(jnp.asarray(x, jnp.float32), raw))
    out = qconv_kernel.quantize_input(torch.from_numpy(x), raw)
    assert out.dtype == torch.int8 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    if mode == "raw-rgb-gray":  # the two-step recipe would differ on these values
        c = np.float32(127 / 127.5)
        two = np.clip(np.round(x * c - np.float32(127)), -127, 127).astype(np.int8)[..., None]
        assert (two != ref).any()


def _layer(rng, ks, cin, cout, sat=False):
    if sat:
        q = np.where(rng.random((ks, ks, cin, cout)) < 0.5, -127, 127).astype(np.int8)
    else:
        q = rng.integers(-127, 128, (ks, ks, cin, cout)).astype(np.int8)
    return dict(q=q, ws=rng.uniform(1e-4, 2e-3, cout).astype(np.float32),
                b=rng.normal(0, 0.5, cout).astype(np.float32))


LAYER_CASES = {
    # name: (input shape, input kind, ks, cout, stride, dil, requant)
    "layer0-raw-odd": ((2, 37, 53), "raw", 3, 8, 2, 1, True),
    "layer0-norm": ((2, 32, 48), "norm", 3, 8, 2, 1, True),
    "stem-s2-odd": ((2, 19, 27, 8), "int8", 3, 8, 2, 1, True),
    "stem-s2-even": ((2, 16, 24, 8), "int8", 3, 12, 2, 1, True),
    "context-d1": ((2, 16, 20, 8), "int8", 3, 8, 1, 1, True),
    "context-d4": ((2, 16, 20, 8), "int8", 3, 8, 1, 4, True),
    "context-d16": ((2, 16, 16, 24), "int8", 3, 24, 1, 16, True),
    "head": ((2, 16, 20, 24), "int8", 1, 17, 1, 1, False),
    "saturated": ((2, 12, 12, 24), "sat", 3, 24, 1, 1, False),
    "zeros": ((2, 12, 12, 8), "zeros", 3, 8, 1, 2, True),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_qconv_reference_matches_jitted_qconv(case):
    """qconv_reference == the jitted JAX _qconv bit for bit, for each layer
    kind; the saturated case reaches |acc| = 9 * 24 * 127^2 = 3,483,864."""
    shape, kind, ks, cout, stride, dil, requant = LAYER_CASES[case]
    rng = np.random.default_rng(len(case))
    cin = shape[3] if len(shape) == 4 else 1
    layer = _layer(rng, ks, cin, cout, sat=kind == "sat")
    if kind == "raw":
        x = rng.uniform(0, 255, shape).astype(np.float32)
        jx = jq._quantize_input(jnp.asarray(x), True)
    elif kind == "norm":
        x = rng.uniform(-1, 1, shape + (1,)).astype(np.float32)
        jx = jq._quantize_input(jnp.asarray(x), False)
    elif kind == "sat":
        x = np.full(shape, 127, np.int8)
        x[1] = -127  # the second image drives every accumulator to -3,483,864
        layer["q"][:] = 127
        jx = jnp.asarray(x)
    elif kind == "zeros":
        x = np.zeros(shape, np.int8)
        jx = jnp.asarray(x)
    else:
        x = rng.integers(-127, 128, shape).astype(np.int8)
        jx = jnp.asarray(x)
    s_out = rng.uniform(5, 60, cout).astype(np.float32) if requant else None
    ref = np.asarray(jax.jit(jq._qconv, static_argnums=(3, 4))(
        jx, jax.tree.map(jnp.asarray, layer), None if s_out is None else jnp.asarray(s_out),
        (stride, stride), (dil, dil)))
    out = qconv_kernel.qconv_reference(
        torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in layer.items()},
        None if s_out is None else torch.from_numpy(s_out), stride, dil, raw_gray=kind == "raw")
    assert out.shape == ref.shape and out.dtype == (torch.int8 if requant else torch.float32)
    np.testing.assert_array_equal(out.numpy(), ref)
    if kind == "sat":  # interior accumulators, recovered from the logits
        acc = (ref[:, 1:-1, 1:-1] - layer["b"]) / layer["ws"]
        np.testing.assert_allclose(acc[0], 9 * 24 * 127**2, rtol=1e-6)
        np.testing.assert_allclose(acc[1], -9 * 24 * 127**2, rtol=1e-6)


def test_two_step_epilogue_would_fail():
    """Pins the FMA finding: acc * ws + b taken as two f32 roundings (what
    torch gives for ``acc.float() * ws + b``) misses the jitted JAX layer
    on many outputs, where qconv_reference (one rounding) equals it."""
    rng = np.random.default_rng(12)
    layer = _layer(rng, 3, 24, 24)
    x = rng.integers(-127, 128, (2, 16, 16, 24)).astype(np.int8)
    ref = np.asarray(jax.jit(jq._qconv, static_argnums=(3, 4))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, layer), None, (1, 1), (2, 2)))
    t = {k: torch.from_numpy(v) for k, v in layer.items()}
    np.testing.assert_array_equal(qconv_kernel.qconv_reference(torch.from_numpy(x), t, None, 1, 2).numpy(), ref)
    acc = conv2d_same(torch.from_numpy(x).permute(0, 3, 1, 2).double(),
                      t["q"].permute(3, 2, 0, 1).double(), None, 1, 2).float()
    two = (acc * t["ws"].view(1, -1, 1, 1) + t["b"].view(1, -1, 1, 1)).permute(0, 2, 3, 1).numpy()
    assert (two != ref).mean() > 0.05


@pytest.mark.parametrize("kind", ["narrow-separable", "narrow-dense", "separable", "dense"])
@pytest.mark.parametrize("raw_gray", [True, False])
def test_int8_trunk_apply_bit_for_bit(kind, raw_gray):
    """The port's int8_trunk_apply on the JAX qparams (qparams_from_numpy):
    every requantized activation and the f32 logits equal the jitted JAX
    trunk's bit for bit, and its logits equal int8_trunk_apply's."""
    jcfg, _, cfg, _ = _models(kind)
    q, pqp = _jax_qparams(kind)
    raw = _scenes(2, (64, 64), 8)
    x = raw if raw_gray else _norm(raw)
    ref = _jax_trunk_steps(q, x.astype(np.float32), jcfg, raw_gray)
    np.testing.assert_array_equal(
        np.asarray(jq.int8_trunk_apply(q, jnp.asarray(x, jnp.float32), jcfg, raw_gray=raw_gray)), ref[-1])
    qx = torch.from_numpy(x)
    specs = pq._conv_specs(cfg)
    for i, (st, d) in enumerate(specs):
        qx = qconv_kernel.qconv_reference(qx, pqp["layers"][i], pqp["s_in"][i + 1], st, d,
                                          raw_gray=raw_gray)
        np.testing.assert_array_equal(qx.numpy(), ref[i], err_msg=f"layer {i}")
    np.testing.assert_array_equal(qconv_kernel.qconv_reference(qx, pqp["head"], None, 1, 1).numpy(),
                                  ref[-1])
    logits = pq.int8_trunk_apply(pqp, torch.from_numpy(x), cfg, raw_gray=raw_gray)
    np.testing.assert_array_equal(logits.numpy(), ref[-1])


@pytest.mark.parametrize("fused", [True, False])
def test_detect_program_batch_int8_matches_jax(fused):
    """detect_program_batch(qparams=) on 128x128 uint8 scenes (raw grayscale
    into layer 0) and on RGB scenes resized 120x136 -> 128x128 (the
    normalize rounded once, as under jit), fused (JAX: its int8 branch's
    logits + postprocess_batch_fused in the Pallas interpreter) and
    fused=False (JAX: its XLA route)."""
    jcfg, _, cfg, params = _models("separable")
    q, pqp = _jax_qparams("separable")
    gray = _scenes(2, (128, 128), 21)
    rgb = np.repeat(_scenes(2, (120, 136), 22)[..., None], 3, -1)
    rgb[..., 0] //= 2  # not gray
    outs = []
    for imgs in (gray, rgb):
        out, logits = detect_program_batch(params, imgs, cfg, (128, 128), qparams=pqp,
                                           fused=fused, device="cpu")
        outs.append(out)
        ref, jl = jax.device_get(_jax_detect_program_batch_int8(
            q, jnp.asarray(imgs), jcfg, (128, 128), "rgb", False, False))
        if fused:
            ref = jax.device_get(jax_postprocess_batch_fused(jnp.asarray(jl), jcfg, interpret=True))
        np.testing.assert_array_equal(logits.numpy(), jl)
        assert int(np.asarray(ref["num_detections"]).sum()) > 0
        assert_same_detections(out, ref)
    res, none = detect_program_batch(params, gray, cfg, (128, 128), qparams=pqp,
                                     detections_only=True, fused=fused, device="cpu")
    assert none is None
    for k, v in res.items():
        assert torch.equal(v, outs[0][k]), k


def test_detect_preprocessed_batch_int8_dense_fused():
    """detect_preprocessed_batch(qparams=) on a dense config: the int8 route's
    fused postprocessing serves it (the f32 route's would not), as the JAX
    package's _detect_preprocessed_int8 does; fused=False its XLA route."""
    jcfg, _, cfg, params = _models("dense")
    q, pqp = _jax_qparams("dense")
    x = _norm(_scenes(3, (128, 128), 23))
    jl = np.asarray(jq.int8_trunk_apply(q, jnp.asarray(x), jcfg))
    out, logits = detect_preprocessed_batch(params, x, cfg, qparams=pqp, fused=True, device="cpu")
    np.testing.assert_array_equal(logits.numpy(), jl)
    ref = jax.device_get(jax_postprocess_batch_fused(jnp.asarray(jl), jcfg, interpret=True))
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_same_detections(out, ref)
    out, _ = detect_preprocessed_batch(params, x, cfg, qparams=pqp, fused=False, device="cpu")
    ref, _ = jax.device_get(jax_detect_preprocessed_batch(None, jnp.asarray(x), jcfg, fused=False, qparams=q))
    assert_same_detections(out, ref)


def test_barcode_detector_int8_matches_jax(asset="separable"):
    """BarcodeDetector(qparams=).detect (detect_program_int8: preprocess,
    the int8 trunk, postprocess) on a 128x128 scene and on a 130x94 one
    resized to its 128x96 grid, against the JAX detector; heatmap stays on
    the f32 params."""
    jcfg, jparams, cfg, params = _models(asset)
    q, pqp = _jax_qparams(asset)
    det = BarcodeDetector(cfg, params, qparams=pqp, device="cpu")
    ref_det = JaxBarcodeDetector(jcfg, jparams, qparams=jax.tree.map(jnp.asarray, q))
    n = 0
    for img in (_scenes(1, (128, 128), 24)[0], _scenes(1, (130, 94), 25)[0]):
        got, want = det.detect(img), ref_det.detect(img)
        assert len(got) == len(want)
        for o, r in zip(got, want):
            assert (o.class_id, o.area) == (r.class_id, r.area)
            assert abs(o.score - r.score) <= 1e-6
            np.testing.assert_allclose(o.center, r.center, atol=1e-4)
        n += len(got)
    assert n > 0
    np.testing.assert_allclose(det.heatmap(img), ref_det.heatmap(img), atol=1e-5)


def test_streaming_int8_matches_jax():
    """StreamingDetector(qparams=) over 6 QVGA-shaped frames, batch 4 (a
    padded tail), against the JAX stream with the same qparams."""
    jcfg, jparams, cfg, params = _models("separable")
    q, pqp = _jax_qparams("separable")
    frames = list(_scenes(6, (120, 160), 26))
    port = StreamingDetector(cfg, params, (120, 160), batch_size=4, qparams=pqp, device="cpu")
    ref = JaxStreamingDetector(jcfg, jparams, (120, 160), batch_size=4,
                               qparams=jax.tree.map(jnp.asarray, q))
    out, exp = list(port.process(iter(frames))), list(ref.process(iter(frames)))
    assert [i for i, _ in out] == [i for i, _ in exp] == list(range(6))
    stack = lambda rs: {k: np.stack([r[k] for _, r in rs]) for k in rs[0][1]}
    o, e = stack(out), stack(exp)
    assert int(e["num_detections"].sum()) > 0
    assert_same_detections({k: torch.from_numpy(v) for k, v in o.items()}, e)


def test_port_int8_contract_against_port_f32():
    """The JAX int8 mode's contract (tests/test_quant.py:171-230) on the port
    alone: port-calibrated int8 (32 calibration scenes, seed 77) against the
    port's f32 trunk on 4 scenes (seed 11), asset weights, K=8."""
    _, _, cfg, params = _models("separable")
    cfg = cfg.replace(max_components=8, min_component_area=3, max_hull_points=31)
    norm = torch.from_numpy(_norm(_scenes(4, (128, 128), 11)))
    calib = torch.from_numpy(_norm(_scenes(32, (128, 128), 77)))
    _, fl = pq.trunk_intermediates(params, norm, cfg)
    rf = postprocess_batch_fused(fl, cfg)
    v = rf["valid"].numpy()
    assert v.sum() > 0
    q0 = pq.quantize_trunk(params, cfg, calib, bias_correct=False)
    ql = pq.int8_trunk_apply(q0, norm, cfg)
    assert float((ql - fl).abs().max()) < 2.0 and float((ql - fl).abs().mean()) < 0.3
    rq = postprocess_batch_fused(ql, cfg)
    for key in ("valid", "classes", "num_detections"):
        np.testing.assert_array_equal(rq[key].numpy(), rf[key].numpy(), err_msg=key)
    np.testing.assert_allclose(rq["boxes"].numpy()[v], rf["boxes"].numpy()[v], atol=1.5)
    q1 = pq.quantize_trunk(params, cfg, calib)
    ql1 = pq.int8_trunk_apply(q1, norm, cfg)
    assert float((ql1 - fl).abs().max()) < 2.0
    assert float((ql1 - fl).abs().mean()) <= float((ql - fl).abs().mean())
    rq1 = postprocess_batch_fused(ql1, cfg)
    for key in ("valid", "num_detections"):
        np.testing.assert_array_equal(rq1[key].numpy(), rf[key].numpy(), err_msg=key)
    np.testing.assert_allclose(rq1["boxes"].numpy()[v], rf["boxes"].numpy()[v], atol=1.5)
    top2 = np.sort(rf["class_probs"].numpy(), -1)
    flipped = (rq1["classes"].numpy() != rf["classes"].numpy()) & v
    assert np.all((top2[..., -1] - top2[..., -2])[flipped] < 0.05)
    np.testing.assert_array_equal(q0["layers"][0]["q"].numpy(), q1["layers"][0]["q"].numpy())


def test_int8_mesh_still_raises():
    """int8 qparams over a mesh are served (tests/test_torch_parallel.py);
    a batch the mesh does not divide raises on every entry point, and so
    does an object that is no mesh."""
    from ubdvss_tpu_torch.parallel import make_mesh

    _, _, cfg, params = _models("separable")
    _, pqp = _jax_qparams("separable")
    imgs = np.zeros((1, 64, 64), np.uint8)
    two = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="divisible"):
        detect_program_batch(params, imgs, cfg, (64, 64), qparams=pqp, mesh=two, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        detect_preprocessed_batch(params, _norm(imgs), cfg, qparams=pqp, mesh=two, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        StreamingDetector(cfg, params, (64, 64), batch_size=3, qparams=pqp, mesh=two, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        detect_program_batch(params, imgs, cfg, (64, 64), qparams=pqp, mesh=object(), device="cpu")


def test_detect_cli_int8_matches_jax(tmp_path):
    """The port's CLI with --int8 against the JAX CLI on the same PNG files
    and weights: each calibrates on the images (f32 convs summed in another
    order, so the qparams may differ in the last bits), then detects;
    the same detections and classes, scores within 1e-4, boxes within
    1e-3 px."""
    cv2 = pytest.importorskip("cv2")
    from ubdvss_tpu import detect as jax_detect
    from ubdvss_tpu_torch import detect as port_detect

    for i, img in enumerate(_scenes(3, (128, 128), 3)):
        cv2.imwrite(str(tmp_path / f"im{i}.png"), img)
    args = ["--images", str(tmp_path), "--checkpoint", str(ASSETS["separable"]), "--int8"]
    want = jax_detect.main(args + ["--output", str(tmp_path / "jax.json")])
    got = port_detect.main(args + ["--output", str(tmp_path / "port.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    assert set(got) == set(want) and sum(map(len, want.values())) > 0
    for path in want:
        assert [d["class"] for d in got[path]] == [d["class"] for d in want[path]]
        for o, r in zip(got[path], want[path]):
            assert abs(o["score"] - r["score"]) <= 1e-4
            np.testing.assert_allclose(o["box"], r["box"], atol=1e-3)


def test_detect_cli_unported_inputs_raise(tmp_path):
    """A log directory without a training checkpoint is refused, and one of
    the JAX package's orbax checkpoints names --export-npz; the port's own
    log directories (tests/test_torch_train.py), Keras weights and
    --save-overlays (tests/test_torch_utils.py) are served."""
    from ubdvss_tpu_torch import detect as port_detect

    for ckpt in ("logdir", str(tmp_path)):
        with pytest.raises(FileNotFoundError, match="no training checkpoint"):
            port_detect.main(["--images", str(tmp_path), "--device", "cpu", "--checkpoint", ckpt])
    (tmp_path / "checkpoints" / "3").mkdir(parents=True)
    with pytest.raises(ValueError, match="--export-npz"):
        port_detect.main(["--images", str(tmp_path), "--device", "cpu", "--checkpoint", str(tmp_path)])

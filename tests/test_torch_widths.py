"""PyTorch port: every channel width and class count the JAX package
serves, on the CPU, held against the JAX package on the same inputs.

The card's kernels take any width (ROADMAP §2a): K4 at any C and O, the
stats at any logit channel count, the int8 trunk at any Cin and Cout.  On
the CPU each wrapper runs its plain version, which these tests hold to
the JAX package at C in {10, 48} (10: no compiled K4 width and no multiple
of 4; 48: past every register design) and O in {1, 41} (detection only;
40 symbologies):

  * K4's plain version against ``_pallas_context_head`` in interpret mode,
    within 1e-5;
  * ``postprocess_batch_fused`` on 41-channel logits (unpacked and
    phase-major) against JAX's in interpret mode: labels, valid, areas
    and classes identical, scores within 1e-6, boxes within 1e-4;
  * ``int8_trunk_apply`` on the JAX package's qparams bit for bit, the
    port's ``quantize_trunk`` in the JAX package's shapes, and the card's
    padded qparams (``kernel_qparams``) giving the same logits;
  * ``detect_program_batch`` in f32 and int8, B=2 at 128², against JAX's
    (f32 scores within 1e-5, the f32 route's tolerance),
    at the four configurations ``chip_smoke.py``'s phase "every width"
    drives: wide (C=48, O=41: the asset's 24 channels carried into the
    first 24, the rest drawn from a seed at a small scale), narrow
    (C=10, O=17: ``init_params`` at a seed, the head scaled up and its
    detection bias set below 0 so that the detection logits leave the
    threshold), few (the asset cut to its detection row and four
    symbologies' rows, O=5) and mid (the asset's 17 rows and eight drawn
    from a seed, O=25).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from test_torch_ccl import blob_logits
from test_torch_model import ASSETS
from test_torch_postproc import assert_same_detections

from ubdvss_tpu.inference import _detect_program_batch_int8 as jax_detect_program_batch_int8
from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch
from ubdvss_tpu.models.model import init_params as jax_init_params
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops import quant as jq
from ubdvss_tpu.ops.pallas.context_kernel import _pack_weights as jax_pack_weights
from ubdvss_tpu.ops.pallas.context_kernel import _pallas_context_head
from ubdvss_tpu.ops.postproc import postprocess_batch_fused as jax_postprocess_batch_fused
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu_torch import NetConfig, detect_program_batch, params_from_flat, qparams_from_numpy
from ubdvss_tpu_torch.models.model import init_params
from ubdvss_tpu_torch.ops import quant as pq
from ubdvss_tpu_torch.ops.cuda import context_kernel as ck
from ubdvss_tpu_torch.ops.cuda import qconv_kernel as qk
from ubdvss_tpu_torch.ops.cuda import postproc_kernel
from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.utils.checkpoint import flat_from_params, load_net_config, load_params_npz

torch.set_num_threads(1)

WIDTHS = (10, 48)
OUTPUTS = (1, 41)
MARGIN = 1e-4  # a det logit this close to the threshold may flip on rounding alone


def _names(O):
    return tuple(f"sym{i}" for i in range(O - 1))


def _scenes(n, hw, seed):
    reader = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed)
    return np.stack([reader.sample_at(i).image for i in range(n)])


def _norm(raw):
    return (raw.astype(np.float32) / 127.5 - 1.0)[..., None]


def carry_flat(flat, channels, n_out, seed, scale=0.02):
    """The flat weights of a checkpoint carried into a config of
    ``channels`` and ``n_out`` head outputs: every array's overlap with the
    new shape kept, the rest drawn from ``seed`` at ``scale``."""
    C = flat["downscale_0/bias"].shape[0]
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(flat):
        a = flat[k]
        shape = list(a.shape)
        for i in range(a.ndim):
            if a.shape[i] == C and (a.ndim == 1 or i >= 2):
                shape[i] = channels
        if k.startswith("head/"):
            shape[-1] = n_out
        new = rng.normal(0, scale, shape).astype(np.float32)
        ov = tuple(slice(0, min(x, y)) for x, y in zip(a.shape, shape))
        new[ov] = a[ov]
        out[k] = new
    return out


# the label sets of "few" (the asset's rows of four symbologies) and "mid"
# (the asset's 16 and eight more)
FEW_CLASSES = ("QRCode", "DataMatrix", "EAN13", "Code128")
MID_EXTRA = ("GS1DataBar", "GS1DataBarExpanded", "GS1DataBarLimited", "GS1Composite", "DotCode",
             "AustraliaPost", "KIXCode", "IdentCode")


@functools.lru_cache(maxsize=None)
def _config(name):
    """(JAX cfg, JAX params, port cfg, port params) of "wide" (C=48, O=41),
    "narrow" (C=10, O=17), "few" (the asset with its detection row and the
    head rows of FEW_CLASSES: O=5) or "mid" (the asset's 17 rows and eight
    drawn from a seed at a small scale: O=25), K=16 and M=31 (compacted
    rects)."""
    base = load_net_config(ASSETS["separable"])
    kw = dict(max_components=16, max_hull_points=31)
    if name == "wide":
        kw.update(channels=48, class_names=_names(41))
        flat = carry_flat(load_params_npz(ASSETS["separable"]), 48, 41, seed=7)
    elif name == "few":
        kw.update(class_names=FEW_CLASSES)
        flat = dict(load_params_npz(ASSETS["separable"]))
        rows = [0] + [1 + base.class_names.index(n) for n in FEW_CLASSES]
        flat["head/kernel"] = flat["head/kernel"][..., rows]
        flat["head/bias"] = flat["head/bias"][rows]
    elif name == "mid":
        kw.update(class_names=base.class_names + MID_EXTRA)
        flat = carry_flat(load_params_npz(ASSETS["separable"]), base.channels, 25, seed=7)
    else:
        kw.update(channels=10)
        p = init_params(base.replace(**kw), 0)
        p["head.weight"] = p["head.weight"] * 1000.0
        p["head.bias"][0] = -0.5
        flat = flat_from_params(p)
    jcfg = jax_load_net_config(ASSETS["separable"]).replace(**kw)
    return jcfg, unflatten_dict(flat, sep="/"), base.replace(**kw), params_from_flat(flat)


@pytest.mark.parametrize("O", OUTPUTS)
@pytest.mark.parametrize("C", WIDTHS)
def test_context_reference_matches_pallas_at_any_width(C, O):
    """Plain K4 == the Pallas kernel in interpret mode within 1e-5 at a
    width no compiled instance has, plain and packed, and the wrapper on a
    CPU tensor takes the plain version."""
    jcfg = JaxNetConfig(channels=C, class_names=_names(O), dilations=(1, 2, 4))
    params = jax_init_params(jcfg, 5)
    rng = np.random.default_rng(C + O)
    xc = rng.normal(0, 1, (2, C, 16, 16)).astype(np.float32)
    w = jax_pack_weights(params, jcfg.dilations)
    ref = np.asarray(_pallas_context_head(jnp.asarray(xc), *w, jcfg.dilations, True))
    tw = [torch.from_numpy(np.array(a)) for a in w]
    out = ck.context_head_reference(torch.from_numpy(xc), *tw, jcfg.dilations)
    assert out.shape == (2, O, 16, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    wrapped = ck.fused_context_head(torch.from_numpy(xc), *tw, jcfg.dilations)
    assert torch.equal(wrapped, out)
    packed = ck.fused_context_head(torch.from_numpy(xc), *tw, jcfg.dilations, packed=True)
    assert torch.equal(packed, ck._s2d_planes(out))


@pytest.mark.parametrize("C,O,instance", [(24, 17, "exact"), (8, 32, "exact"), (24, 33, "narrow"),
                                          (10, 17, "narrow"), (4, 1, "narrow"), (48, 41, "wide"),
                                          (33, 1, "wide"), (96, 17, "wide"), (128, 41, "wide"),
                                          (128, 400, "wide_columns"), (160, 41, "wide_columns")])
def test_context_kernel_instance_and_shared_memory(C, O, instance):
    """The card's instance of K4 at each width, and its shared memory: the
    compiled widths keep the register design, other widths up to 32 (or a
    head past 32 outputs) take it compiled for C ("narrow"); from 33 to 128
    channels a
    tile of 128 pixels by C channels a block of 256 threads, its weights
    grouped by a warp's OT outputs (6, 8, 12 or 16, so that C outputs make
    at most eight groups), each group's rows rounded to 4 floats; a width
    whose tile and weights fit no block, past 128 channels or with a large
    head, the per-pixel shared-memory columns; each within one block's
    shared memory; a width whose columns fit no block is the only one the
    card refuses."""
    assert ck.kernel_instance(C, O) == instance
    threads, smem = ck.kernel_smem(C, O)
    assert threads in (256, 128, 64, 32) and smem <= ck.SHARED_MEMORY_LIMIT
    if instance == "wide":
        ot = 6 if C <= 48 else 8 if C <= 64 else 12 if C <= 96 else 16
        assert ck.tile_outputs(C) == ot and -(-C // ot) <= 8
        groups = -(-C // ot) + -(-O // ot)
        assert threads == 256
        assert smem == 4 * (128 * C + groups * C * (-(-ot // 4) * 4) + 9 * C + C + O)
        assert ck.tile_smem(C, O, head=False) == smem - 4 * (-(-O // ot) * C * (-(-ot // 4) * 4) + O)
    if instance == "wide_columns":
        assert smem == 4 * 2 * C * threads and ck.tile_smem(C, O) > ck.SHARED_MEMORY_LIMIT
    assert ck.kernel_smem(48, 41) == (256, 49_700)
    threads, smem = ck.kernel_smem(2000, 41)
    assert threads == 0 and smem > ck.SHARED_MEMORY_LIMIT


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("O", OUTPUTS)
def test_postprocess_fused_at_any_class_count(O, packed):
    """postprocess_batch_fused on O-channel blob logits (41: the stats
    kernels' exact one-pass instance for 40 symbologies) == JAX's in
    interpret mode, unpacked and phase-major; the stats kernels' pass count
    at that width."""
    rng = np.random.default_rng(O)
    det = blob_logits(O, B=3, n_blobs=6)
    logits = rng.normal(0, 2, det.shape + (O,)).astype(np.float32)
    logits[..., 0] = det
    kw = dict(class_names=_names(O), max_components=8, min_component_area=3, max_hull_points=8)
    cfg, jcfg = NetConfig(**kw), JaxNetConfig(**kw)
    phases = (2, 2) if packed else None
    if packed:
        B, H, W, C = logits.shape
        logits = np.ascontiguousarray(logits.reshape(B, H // 2, 2, W // 2, 2, C)
                                      .transpose(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C))
    ref = jax.device_get(jax_postprocess_batch_fused(jnp.asarray(logits), jcfg, interpret=True,
                                                     packed_phases=phases))
    out = postprocess_batch_fused(torch.from_numpy(logits), cfg, packed_phases=phases)
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    assert_same_detections(out, ref)
    assert postproc_kernel.class_chunks(O) == 1


@functools.lru_cache(maxsize=None)
def _int8_models(C, O):
    jcfg = JaxNetConfig(channels=C, class_names=_names(O), dilations=(1, 2, 4))
    jparams = jax_init_params(jcfg, C + O)
    cfg = NetConfig(channels=C, class_names=_names(O), dilations=(1, 2, 4))
    params = params_from_flat(flatten_dict(jax.device_get(jparams), sep="/"))
    calib = _norm(_scenes(4, (64, 64), 5))
    q = jax.tree.map(np.asarray, jq.quantize_trunk(jparams, jcfg, jnp.asarray(calib)))
    return jcfg, cfg, params, calib, q


@pytest.mark.parametrize("O", OUTPUTS)
@pytest.mark.parametrize("C", WIDTHS)
def test_int8_trunk_at_any_width_bit_for_bit(C, O):
    """int8_trunk_apply on the JAX package's qparams == JAX's bit for bit,
    raw grayscale and normalized; the card's padded qparams
    (kernel_qparams: channels to a multiple of 4, exact zeros there) give
    the same logits through the plain versions; the port's quantize_trunk
    keeps the JAX package's shapes, its scales within rtol 1e-5."""
    jcfg, cfg, params, calib, q = _int8_models(C, O)
    pqp = qparams_from_numpy(q)
    raw = _scenes(2, (64, 64), 8)
    for raw_gray, x in ((True, raw.astype(np.float32)), (False, _norm(raw))):
        ref = np.asarray(jq.int8_trunk_apply(q, jnp.asarray(x), jcfg, raw_gray=raw_gray))
        out = pq.int8_trunk_apply(pqp, torch.from_numpy(x), cfg, raw_gray=raw_gray)
        assert out.shape == (2, 16, 16, O)
        np.testing.assert_array_equal(out.numpy(), ref)
        padded = pq.kernel_qparams(pqp)
        assert (padded is pqp) == (C % 4 == 0)
        np.testing.assert_array_equal(
            pq.int8_trunk_apply(padded, torch.from_numpy(x), cfg, raw_gray=raw_gray).numpy(), ref)
    own = pq.quantize_trunk(params, cfg, torch.from_numpy(calib))
    for a, b in zip(own["layers"] + [own["head"]], pqp["layers"] + [pqp["head"]]):
        assert a["q"].shape == b["q"].shape and a["q"].dtype == b["q"].dtype == torch.int8
        assert a["ws"].shape == b["ws"].shape and a["b"].shape == b["b"].shape
    for a, b in zip(own["s_in"], pqp["s_in"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_padded_channels_hold_exact_zeros():
    """kernel_qparams at C=10: every layer padded to 12 channels, the
    padded outputs' weights zero with ws = 1, b = 0, s_out = 1, so each
    padded channel of every requantized activation is 0 and the next
    layer's zero weights ignore it; the head keeps its outputs."""
    _, cfg, _, _, q = _int8_models(10, 41)
    pqp = pq.kernel_qparams(qparams_from_numpy(q))
    assert [layer["q"].shape[3] for layer in pqp["layers"]] == [12] * 5
    assert tuple(pqp["head"]["q"].shape) == (1, 1, 12, 41)
    for i, (layer, s) in enumerate(zip(pqp["layers"], pqp["s_in"][1:])):
        assert not layer["q"][..., 10:].any() and (i == 0 or not layer["q"][:, :, 10:].any())
        assert (layer["ws"][10:] == 1).all() and (layer["b"][10:] == 0).all() and (s[10:] == 1).all()
    assert not pqp["head"]["q"][:, :, 10:].any()
    x = torch.from_numpy(_scenes(1, (64, 64), 3))
    L, s = pqp["layers"], pqp["s_in"]
    qx = qk.qstem_reference(x, L[0], s[1], L[1], s[2], raw_gray=True)
    assert not qx[..., 10:].any() and qx[..., :10].any()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("name", ["wide", "narrow", "few", "mid"])
def test_detect_program_batch_at_any_width(name, dtype):
    """detect_program_batch at the wide, narrow, few and mid configurations, B=2 at
    128² on the CPU, == the JAX package's: f32 against its XLA route (logits
    within 1e-5, or 1e-6 of max|logit| where that is more, scores within
    1e-5, as tests/test_torch_inference.py holds the asset's f32 route), int8 on JAX's qparams against its int8
    branch with postprocess_batch_fused in interpret mode (logits bit for
    bit, scores within 1e-6)."""
    jcfg, jparams, cfg, params = _config(name)
    imgs = _scenes(2, (128, 128), 21)
    if dtype == "float32":
        ref, ref_logits = jax.device_get(
            jax_detect_program_batch(jparams, jnp.asarray(imgs), jcfg, (128, 128), fused=False))
        out, logits = detect_program_batch(params, imgs, cfg, (128, 128), fused=True,
                                           device="cpu")
        np.testing.assert_allclose(logits.numpy(), ref_logits,
                                   atol=max(1e-5, 1e-6 * np.abs(ref_logits).max()))
    else:
        calib = jnp.asarray(_norm(_scenes(4, (128, 128), 5)))
        q = jax.tree.map(np.asarray, jq.quantize_trunk(jparams, jcfg, calib))
        _, ref_logits = jax.device_get(jax_detect_program_batch_int8(
            q, jnp.asarray(imgs), jcfg, (128, 128), "rgb", False, False))
        ref = jax.device_get(jax_postprocess_batch_fused(jnp.asarray(ref_logits), jcfg,
                                                         interpret=True))
        out, logits = detect_program_batch(params, imgs, cfg, (128, 128), fused=True,
                                           qparams=qparams_from_numpy(q), device="cpu")
        np.testing.assert_array_equal(logits.numpy(), ref_logits)
    assert logits.shape == (2, 32, 32, jcfg.n_output_channels)
    assert np.abs(ref_logits[..., 0]).min() > MARGIN
    assert (np.asarray(ref["num_detections"]) > 0).all()
    assert_same_detections(out, ref, score_atol=1e-5 if dtype == "float32" else 1e-6)

"""PyTorch port: the packed large-scan route on the CPU — the space-to-depth
layout helpers, the packed formulation (``packed_stem_apply``,
``s2d_context_head``, ``packed_fused_trunk``), K4's and ``qconv_head``'s
phase-major stores (their plain versions), the packed int8 trunk and the
postprocessing of phase-major logits — held against the JAX package's
functions of the same names on the same numpy inputs.

Tolerances: the packing helpers and the int8 trunks bit for bit; f32
convolutions within 1e-5 (the stem, one layer stack on small maps) and
1e-4 for whole trunks, as ``tests/test_context_kernel.py:123-199`` holds
the JAX package's own; the postprocessing as ``assert_same_detections``
(masks, areas, classes and counts identical, scores within 1e-6, boxes
within 1e-4); the stats' means within 2e-6 (``test_torch_stats.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax import lax
from test_torch_ccl import blob_logits
from test_torch_postproc import assert_same_detections

from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops import quant as jq
from ubdvss_tpu.ops.pallas import context_kernel as jck
from ubdvss_tpu.ops.pallas.postproc_kernel import component_stats_from_logits as jax_stats
from ubdvss_tpu.ops.postproc import postprocess_batch_fused as jax_postprocess_batch_fused
from ubdvss_tpu_torch import NetConfig, params_from_flat, qparams_from_numpy
from ubdvss_tpu_torch.ops import quant as pq
from ubdvss_tpu_torch.ops.cuda import context_kernel as ck
from ubdvss_tpu_torch.ops.cuda import qconv_kernel
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_stats_from_logits
from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _models(**kw):
    """(JAX cfg, JAX params, port cfg, port params) of a random config."""
    jcfg, cfg = JaxNetConfig(**kw), NetConfig(**kw)
    jparams = init_params(jcfg, 3)
    return jcfg, jparams, cfg, params_from_flat(flatten_dict(jax.device_get(jparams), sep="/"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_s2d_and_d2s_match_jax():
    x = np.random.default_rng(0).normal(0, 1, (2, 6, 10, 3)).astype(np.float32)
    packed = ck._s2d(_t(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jck._s2d(jnp.asarray(x))))
    assert tuple(packed.shape) == (2, 3, 5, 12)
    np.testing.assert_array_equal(ck._d2s(packed, 3).numpy(), x)
    np.testing.assert_array_equal(
        ck._d2s(packed, 3).numpy(), np.asarray(jck._d2s(jnp.asarray(packed.numpy()), 3)))


@pytest.mark.parametrize("d", [1, 2, 4, 16])
def test_pack_kernels_match_jax(d):
    """The packed kernels hold the same values at the same places: the
    cross-phase d=1 kernel, the block-diagonal even-d ones and the stride-2
    stem kernel."""
    k = np.random.default_rng(d).normal(0, 1, (3, 3, 4, 5)).astype(np.float32)
    kp, dp = ck._pack_s2d_kernel(_t(k), d)
    jkp, jdp = jck._pack_s2d_kernel(jnp.asarray(k), d)
    assert dp == jdp
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(ck._pack_stride2_kernel(_t(k)).numpy(),
                                  np.asarray(jck._pack_stride2_kernel(jnp.asarray(k))))


@pytest.mark.parametrize("d", [3, 5])
def test_pack_s2d_kernel_rejects_odd_dilation(d):
    k = torch.zeros((3, 3, 4, 4))
    with pytest.raises(ValueError):
        ck._pack_s2d_kernel(k, d)
    with pytest.raises(ValueError):
        jck._pack_s2d_kernel(jnp.zeros((3, 3, 4, 4)), d)


@pytest.mark.parametrize("hw", [(40, 48), (64, 64), (41, 48)])
def test_s2d_context_head_matches_jax_and_dense(hw):
    """The full dilation schedule; the odd 41 rows take the dense
    fallback.  Packed logits (``unpack=False``) too on even maps."""
    jcfg, jparams, cfg, params = _models()
    w = ck._pack_weights(params, cfg.dilations)
    jw = jck._pack_weights(jparams, jcfg.dilations)
    x = np.random.default_rng(6).normal(0, 1, (2, *hw, cfg.channels)).astype(np.float32)
    out = ck.s2d_context_head(_t(x), *w, cfg.dilations)
    ref = np.asarray(jck.s2d_context_head(jnp.asarray(x), *jw, jcfg.dilations,
                                          precision=lax.Precision.HIGHEST))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    dense = ck.dense_context_head(_t(x), *w, cfg.dilations)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5)
    if hw[0] % 2 == 0:
        packed = ck.s2d_context_head(_t(x), *w, cfg.dilations, unpack=False)
        jpacked = jck.s2d_context_head(jnp.asarray(x), *jw, jcfg.dilations, unpack=False,
                                       precision=lax.Precision.HIGHEST)
        assert tuple(packed.shape) == (2, hw[0] // 2, hw[1] // 2, 4 * cfg.n_output_channels)
        np.testing.assert_allclose(packed.numpy(), np.asarray(jpacked), atol=1e-5)


@pytest.mark.parametrize("raw_gray", [False, True])
def test_packed_stem_matches_jax(raw_gray):
    """packed_stem_apply == JAX's and == _s2d(stem_apply(...)), the SAME
    borders and the raw-gray fold included."""
    jcfg, jparams, cfg, params = _models(dilations=(1, 2))
    rng = np.random.default_rng(8)
    lo, hi = (0.0, 255.0) if raw_gray else (-1.0, 1.0)
    x = rng.uniform(lo, hi, (2, 64, 48, 1)).astype(np.float32)
    got = ck.packed_stem_apply(params, _t(x), cfg, raw_gray=raw_gray)
    ref = jck.packed_stem_apply(jparams, jnp.asarray(x), jcfg, raw_gray=raw_gray, large=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    direct = ck._s2d(ck.stem_apply(params, _t(x), cfg, raw_gray=raw_gray))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)


def test_packed_stem_rejects_unaligned_sizes():
    _, _, cfg, params = _models(dilations=(1, 2))
    with pytest.raises(ValueError):
        ck.packed_stem_apply(params, torch.zeros((1, 60, 64, 1)), cfg)


def test_packed_fused_trunk_matches_jax():
    """The whole packed trunk (full dilation schedule, raw gray) == JAX's,
    and unpacks to fused_model_apply's logits (the port's and JAX's)."""
    jcfg, jparams, cfg, params = _models()
    x = np.random.default_rng(9).uniform(0, 255, (1, 64, 64, 1)).astype(np.float32)
    packed = ck.packed_fused_trunk(params, _t(x), cfg, raw_gray=True)
    ref = jck.packed_fused_trunk(jparams, jnp.asarray(x), jcfg, raw_gray=True)
    assert tuple(packed.shape) == (1, 8, 8, 4 * cfg.n_output_channels)
    np.testing.assert_allclose(packed.numpy(), np.asarray(ref), atol=1e-4)
    got = ck._d2s(packed, cfg.n_output_channels)
    np.testing.assert_allclose(
        got.numpy(), ck.fused_model_apply(params, _t(x), cfg, raw_gray=True).numpy(), atol=1e-4)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jck.fused_model_apply(jparams, jnp.asarray(x), jcfg,
                                                      raw_gray=True)), atol=1e-4)


def test_route_gates_match_jax():
    jcfg, _, cfg, _ = _models()
    jodd, _, odd, _ = _models(dilations=(1, 3))
    for Hf, Wf in [(256, 256), (258, 256), (258, 258), (259, 258), (512, 512), (128, 1024)]:
        for large in (False, True):
            for a, b in ((cfg, jcfg), (odd, jodd)):
                assert ck._s2d_route_selected(a, Hf, Wf, large) == jck._s2d_route_selected(
                    b, Hf, Wf, large), (Hf, Wf, large, a.dilations)
    for hw in [(1024, 1024), (1024, 256), (2048, 2048), (1024, 1028), (4096, 512), (512, 512)]:
        for a, b in ((cfg, jcfg), (odd, jodd)):
            assert ck.packed_trunk_selected(a, hw) == jck.packed_trunk_selected(b, hw), hw


def test_context_head_route_maybe_packed_matches_jax():
    """Past 256² feature maps the s2d route fires (f32 needs ``large``):
    phase-major logits and (2, 2) == JAX's; without ``large`` the unpacked
    logits and None (the gate itself is held to JAX's above)."""
    jcfg, jparams, cfg, params = _models(channels=8, dilations=(1, 2))
    feat = np.random.default_rng(4).normal(0, 1, (1, 258, 256, 8)).astype(np.float32)
    out, pp = ck.context_head_route_maybe_packed(params, _t(feat), cfg, large=True)
    ref, jpp = jck.context_head_route_maybe_packed(jparams, jnp.asarray(feat), jcfg, large=True)
    assert pp == jpp == (2, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    direct = ck.context_head_route(params, _t(feat), cfg)
    np.testing.assert_allclose(ck._d2s(out, 17).numpy(), direct.numpy(), atol=1e-5)
    out, pp = ck.context_head_route_maybe_packed(params, _t(feat), cfg, large=False)
    assert pp is None and torch.equal(out, direct)


def test_context_kernel_packed_store_plain_version():
    """fused_context_head(packed=True) on the CPU: the planes whose NHWC
    view is _s2d of the unpacked logits, bit for bit, and the gradient
    of the unpacked route through _d2s."""
    rng = np.random.default_rng(2)
    C, O, dil = 8, 5, (1, 2)
    L = len(dil)
    x = _t(rng.normal(0, 1, (2, C, 12, 10)).astype(np.float32))
    w = [_t(rng.normal(0, 0.3, s).astype(np.float32))
         for s in ((L, 9, C, 1, 1), (L, C, C), (L, C, 1, 1), (O, C), (O, 1, 1))]
    out = ck.fused_context_head(x, *w, dil)
    packed = ck.fused_context_head(x, *w, dil, packed=True)
    assert tuple(packed.shape) == (2, 4 * O, 6, 5) and packed.is_contiguous()
    assert torch.equal(packed.permute(0, 2, 3, 1), ck._s2d(out.permute(0, 2, 3, 1)))
    tgt = _t(rng.normal(0, 1, (2, 6, 5, 4 * O)).astype(np.float32))
    xg = x.clone().requires_grad_(True)
    loss = (ck.fused_context_head(xg, *w, dil, packed=True).permute(0, 2, 3, 1) * tgt).sum()
    g = torch.autograd.grad(loss, xg)[0]
    xr = x.clone().requires_grad_(True)
    loss_r = (ck.fused_context_head(xr, *w, dil).permute(0, 2, 3, 1) * ck._d2s(tgt, O)).sum()
    torch.testing.assert_close(g, torch.autograd.grad(loss_r, xr)[0], atol=1e-6, rtol=0)


# -- the packed int8 trunk ---------------------------------------------------


@functools.lru_cache(maxsize=None)
def _int8(hw=(128, 136)):
    """Raw and normalized images, and the JAX and port qparams of a narrow
    separable config calibrated on them (JAX's, carried over)."""
    jcfg, jparams, cfg, _ = _models(channels=8, dilations=(1, 2, 4), max_components=8)
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (2, *hw)).astype(np.float32)
    norm = (raw / 127.5 - 1.0)[..., None].astype(np.float32)
    q = jq.quantize_trunk(jparams, jcfg, jnp.asarray(norm))
    return jcfg, cfg, q, qparams_from_numpy(jax.device_get(q)), raw, norm


def test_int8_packed_trunk_bit_exact():
    """The packed int8 trunk == JAX's and == the direct trunk, bit for bit,
    phase-major (B, H/8, W/8, 4 O), the raw-gray quantization included."""
    jcfg, cfg, q, qt, raw, norm = _int8()
    packed = pq.int8_packed_trunk_apply(qt, _t(norm), cfg)
    assert tuple(packed.shape) == (2, 16, 17, 4 * cfg.n_output_channels)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jq.int8_packed_trunk_apply(q, jnp.asarray(norm), jcfg)))
    direct = pq.int8_trunk_apply(qt, _t(norm), cfg)
    assert torch.equal(pq.int8_packed_trunk_apply(qt, _t(norm), cfg, unpack=True), direct)
    assert torch.equal(ck._d2s(packed, cfg.n_output_channels), direct)
    packed_raw = pq.int8_packed_trunk_apply(qt, _t(raw), cfg, raw_gray=True, unpack=True)
    assert torch.equal(packed_raw, direct)
    packed_u8 = pq.int8_packed_trunk_apply(qt, _t(raw.astype(np.uint8)), cfg, raw_gray=True)
    assert torch.equal(packed_u8, packed)


def test_int8_packed_trunk_tiled_bit_exact():
    """A forced (2, 2) tiling == JAX's and == the untiled packed trunk."""
    jcfg, cfg, q, qt, raw, _ = _int8((192, 208))
    tiled = pq.int8_packed_trunk_tiled(qt, _t(raw), cfg, raw_gray=True, grid=(2, 2))
    ref = jq.int8_packed_trunk_tiled(q, jnp.asarray(raw), jcfg, raw_gray=True, grid=(2, 2))
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(ref))
    assert torch.equal(tiled, pq.int8_packed_trunk_apply(qt, _t(raw), cfg, raw_gray=True))
    # identity below 4096 px
    assert torch.equal(pq.int8_packed_trunk_tiled(qt, _t(raw), cfg, raw_gray=True),
                       pq.int8_packed_trunk_apply(qt, _t(raw), cfg, raw_gray=True))


def test_qconv_head_packed_store_plain_version():
    """qconv_head(packed=True) on the CPU == _s2d of the unpacked launch,
    bit for bit; odd maps are refused by the plan."""
    _, cfg, _, qt, raw, _ = _int8()
    L, s, n = qt["layers"], qt["s_in"], len(cfg.dilations)
    x = qconv_kernel.qstem(_t(raw), L[0], s[1], L[1], s[2], raw_gray=True)
    args = (x, L[1 + n], s[2 + n], cfg.dilations[-1], qt["head"])
    out = qconv_kernel.qconv_head(*args)
    packed = qconv_kernel.qconv_head(*args, packed=True)
    assert torch.equal(packed, ck._s2d(out))
    plan = qconv_kernel.tile_plan("conv", 2, 32, 34, 8, 8, dil=4, nh=17, packed=True)
    assert plan.packed == 1
    with pytest.raises(ValueError):
        qconv_kernel.tile_plan("conv", 2, 31, 34, 8, 8, dil=4, nh=17, packed=True)
    with pytest.raises(ValueError):
        qconv_kernel.tile_plan("conv", 2, 32, 34, 8, 8, dil=4, packed=True)


# -- postprocessing of phase-major logits --------------------------------------


def _class_logits(seed, B=2, H=32, W=32, C=5):
    """Blob detection logits with a class logit raised inside each blob."""
    rng = np.random.default_rng(seed)
    lg = rng.normal(-1.0, 1.0, (B, H, W, C)).astype(np.float32)
    lg[..., 0] = blob_logits(seed, B, H, W, n_blobs=4)
    for b in range(B):
        blob = lg[b, ..., 0] > 0
        lg[b, blob, 1 + int(rng.integers(C - 1))] += 4.0
    return lg


@pytest.mark.parametrize("K,min_area", [(8, 3), (2, 3)])
def test_postprocess_batch_fused_packed_matches_jax(K, min_area):
    """packed_phases=(2, 2) == JAX's (Pallas in interpret mode) and == the
    unpacked call, on the packed logits as the head's (B, 4C, H/2, W/2)
    planes (the card's layout) and as a contiguous NHWC tensor."""
    kw = dict(class_names=("a", "b", "c", "d"), max_components=K, min_component_area=min_area)
    jcfg, cfg = JaxNetConfig(**kw), NetConfig(**kw)
    lg = _class_logits(K)
    packed = np.asarray(jck._s2d(jnp.asarray(lg)))
    planes = _t(packed.transpose(0, 3, 1, 2).copy()).permute(0, 2, 3, 1)
    unpacked = postprocess_batch_fused(_t(lg), cfg)
    assert int(unpacked["num_detections"].sum()) > 0
    ref = None
    if K == 8:  # JAX's interpret-mode kernels once; K=2 is held to the unpacked call
        ref = jax.device_get(jax_postprocess_batch_fused(
            jnp.asarray(packed), jcfg, interpret=True, packed_phases=(2, 2)))
    for logits in (_t(packed), planes):
        out = postprocess_batch_fused(logits, cfg, packed_phases=(2, 2))
        if ref is not None:
            assert_same_detections(out, ref)
        for k, v in unpacked.items():
            torch.testing.assert_close(out[k], v, atol=1e-6, rtol=0, msg=k)


@pytest.mark.parametrize("C", [1, 17])
def test_stats_from_packed_logits_match_jax(C):
    """component_stats_from_logits(packed_phases=(2, 2)) == JAX's: the
    geometry of the unpacked map identical, the sums (taken in the packed
    pixel order, as JAX's "bhwyx" contractions) within 2e-6 as means."""
    lg = np.random.default_rng(C).normal(0, 2, (3, 32, 40, C)).astype(np.float32)
    lg[..., 0] = blob_logits(C, B=3, H=32, W=40, n_blobs=6)
    packed = np.asarray(jck._s2d(jnp.asarray(lg)))
    K = 8
    ref = jax.device_get(jax_stats(jnp.asarray(packed), K, interpret=True, packed_phases=(2, 2)))
    out = component_stats_from_logits(_t(packed), K, packed_phases=(2, 2))
    assert sorted(out) == sorted(ref)
    for key in ("rootvals", "areas", "minx", "maxx", "labels", "num_components_total"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)
    area = np.maximum(np.asarray(ref["areas"]), 1)
    np.testing.assert_allclose(out["det_sums"].numpy() / area,
                               np.asarray(ref["det_sums"]) / area, atol=2e-6, rtol=0)
    np.testing.assert_allclose(out["cls_sums"].numpy() / area[..., None],
                               np.asarray(ref["cls_sums"]) / area[..., None], atol=2e-6, rtol=0)


def test_packed_phases_other_than_2x2_are_refused():
    lg = torch.zeros((1, 8, 8, 4))
    with pytest.raises(NotImplementedError):
        component_stats_from_logits(lg, 4, packed_phases=(1, 2))

"""PyTorch port: the tiled trunks of ``ops/strips.py`` and the large-scan
route gate of ``inference.py`` on the CPU, held against the JAX package's
functions of the same names on the same numpy inputs.

Tolerances: the plans and gates equal; tiled f32 logits within 1e-5 of the
untiled trunk and of JAX's (a SAME-padded output pixel depends only on its
receptive field, so tiling changes no arithmetic), 1e-4 for the packed
trunk against JAX's (two conv libraries over the whole trunk); the auto
route's detections as ``assert_same_detections`` against the JAX XLA route.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_inference import MARGIN, _jax_asset
from test_torch_model import ASSETS, load_params
from test_torch_postproc import assert_same_detections

from ubdvss_tpu import inference as jinf
from ubdvss_tpu.models.model import get_model as jax_get_model
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops import strips as js
from ubdvss_tpu.ops.pallas import context_kernel as jck
from ubdvss_tpu.parallel.tiling import receptive_field_halo as jax_receptive_field_halo
from ubdvss_tpu_torch import NetConfig, detect_program_batch, load_net_config, params_from_flat
from ubdvss_tpu_torch import inference
from ubdvss_tpu_torch.ops import strips
from ubdvss_tpu_torch.ops.cuda import context_kernel as ck
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _models(**kw):
    """(JAX cfg, JAX params, port cfg, port params) of a random config."""
    jcfg, cfg = JaxNetConfig(**kw), NetConfig(**kw)
    jparams = init_params(jcfg, 0)
    return jcfg, jparams, cfg, params_from_flat(flatten_dict(jax.device_get(jparams), sep="/"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def test_tile_2d_logits_match_full_and_jax():
    jcfg, jparams, cfg, params = _models(dilations=(1, 2))
    halo = strips.receptive_field_halo(cfg)
    assert halo == jax_receptive_field_halo(jcfg)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 160, 128, 1)).astype(np.float32)
    full = ck.fused_model_apply(params, _t(x), cfg)
    model = jax_get_model(jcfg)

    def jtrunk(s):
        return model.apply({"params": jparams}, s)

    for grid in [(2, 1), (1, 2), (2, 2)]:
        tiled = strips.tile_2d_logits(lambda s: ck.fused_model_apply(params, s, cfg), _t(x),
                                      cfg.scale, halo, grid)
        assert tiled.shape == full.shape
        np.testing.assert_allclose(tiled.numpy(), full.numpy(), atol=1e-5, err_msg=str(grid))
        ref = js.tile_2d_logits(jtrunk, jnp.asarray(x), jcfg.scale, halo, grid)
        np.testing.assert_allclose(tiled.numpy(), np.asarray(ref), atol=1e-5, err_msg=str(grid))


@pytest.mark.parametrize("raw_gray", [False, True])
def test_two_stage_tiled_trunk_matches_fused_and_jax(raw_gray):
    """Per-stage 2-D tiling (stem halo 4, context halo sum(dilations)),
    clamped edge tiles and the raw-gray fold included."""
    jcfg, jparams, cfg, params = _models(dilations=(1, 2))
    rng = np.random.default_rng(3)
    lo, hi = (0.0, 255.0) if raw_gray else (-1.0, 1.0)
    x = rng.uniform(lo, hi, (2, 128, 64, 1)).astype(np.float32)
    full = ck.fused_model_apply(params, _t(x), cfg, raw_gray=raw_gray)
    tiled = strips.two_stage_tiled_trunk(params, _t(x), cfg, (2, 2), (2, 2), raw_gray=raw_gray)
    assert tiled.shape == full.shape
    np.testing.assert_allclose(tiled.numpy(), full.numpy(), atol=1e-5)
    ref = js.two_stage_tiled_trunk(jparams, jnp.asarray(x), jcfg, (2, 2), (2, 2),
                                   raw_gray=raw_gray)
    np.testing.assert_allclose(tiled.numpy(), np.asarray(ref), atol=1e-5)
    out, pp = strips.two_stage_tiled_trunk(params, _t(x), cfg, (2, 2), (2, 2),
                                           raw_gray=raw_gray, return_packed=True)
    assert pp is None and torch.equal(out, tiled)


def test_two_stage_tiled_trunk_returns_packed_past_256_squared():
    """With an untiled context past 256² feature maps the s2d route fires:
    phase-major logits and (2, 2), as JAX's."""
    jcfg, jparams, cfg, params = _models(channels=8, dilations=(1, 2))
    x = np.random.default_rng(4).uniform(0, 255, (1, 1040, 1032, 1)).astype(np.float32)
    sg, cg = strips.auto_two_stage_grids(1040, 1032, cfg.scale, cfg.dilations)
    assert (sg, cg) == js.auto_two_stage_grids(1040, 1032, jcfg.scale, jcfg.dilations)
    out, pp = strips.two_stage_tiled_trunk(params, _t(x), cfg, sg, cg, raw_gray=True,
                                           return_packed=True)
    ref, jpp = js.two_stage_tiled_trunk(jparams, jnp.asarray(x), jcfg, sg, cg, raw_gray=True,
                                        return_packed=True)
    assert pp == jpp == (2, 2)
    assert tuple(out.shape) == (1, 130, 129, 4 * cfg.n_output_channels)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)
    full = ck.fused_model_apply(params, _t(x), cfg, raw_gray=True)
    np.testing.assert_allclose(ck._d2s(out, cfg.n_output_channels).numpy(), full.numpy(),
                               atol=1e-4)


def test_packed_fused_trunk_tiled_matches_untiled_and_jax():
    """A forced (2, 2) grid == the untiled packed trunk and == JAX's."""
    jcfg, jparams, cfg, params = _models(dilations=(1, 2))
    x = np.random.default_rng(5).uniform(0, 255, (1, 192, 160, 1)).astype(np.float32)
    tiled = strips.packed_fused_trunk_tiled(params, _t(x), cfg, raw_gray=True, grid=(2, 2))
    untiled = ck.packed_fused_trunk(params, _t(x), cfg, raw_gray=True)
    assert tiled.shape == untiled.shape == (1, 24, 20, 4 * cfg.n_output_channels)
    np.testing.assert_allclose(tiled.numpy(), untiled.numpy(), atol=1e-5)
    ref = js.packed_fused_trunk_tiled(jparams, jnp.asarray(x), jcfg, raw_gray=True, grid=(2, 2))
    np.testing.assert_allclose(tiled.numpy(), np.asarray(ref), atol=1e-4)
    # identity below 4096 px
    assert torch.equal(strips.packed_fused_trunk_tiled(params, _t(x), cfg, raw_gray=True),
                       untiled)


def test_plans_match_jax():
    """auto_n_strips, auto_two_stage_grids, packed_trunk_tile_grid and the
    halos equal JAX's on a sweep of sizes and configs."""
    for kw in ({}, {"dilations": (1, 2)}, {"dilations": (1, 3, 9)}, {"scale": 8}):
        jcfg, cfg = JaxNetConfig(**kw), NetConfig(**kw)
        assert strips.stem_halo(cfg.scale) == js.stem_halo(jcfg.scale)
        assert strips.context_halo(cfg.dilations) == js.context_halo(jcfg.dilations)
        for H in (256, 512, 1000, 1024, 2048, 3000, 4096, 4104, 6144, 8192):
            for W in (512, 1024, 4096, 5000):
                assert strips.packed_trunk_tile_grid(H, W, cfg) == js.packed_trunk_tile_grid(
                    H, W, jcfg), (kw, H, W)
                assert strips.auto_two_stage_grids(H, W, cfg.scale, cfg.dilations) == \
                    js.auto_two_stage_grids(H, W, jcfg.scale, jcfg.dilations), (kw, H, W)
            for halo in (4, 20, 140, 144):
                for core in (512, 1024):
                    assert strips.auto_n_strips(H, 8, halo, core) == js.auto_n_strips(
                        H, 8, halo, core), (H, halo, core)
    assert strips.packed_trunk_tile_grid(4096, 4096, NetConfig()) == (144, (4, 4))
    assert strips.packed_trunk_tile_grid(2048, 2048, NetConfig())[1] == (1, 1)


_GATE_HW = [(1024, 1024), (1024, 256), (256, 1024), (2048, 2048), (1024, 1028), (1020, 1024),
            (4096, 4096), (4096, 512), (512, 512), (1000, 1000), (1024, 768), (8192, 1024)]


def _jax_int8_gate(cfg, out_hw, fused):
    """The JAX package's packed int8 gate, written inline in its
    ``_detect_program_batch_int8`` (``ubdvss_tpu/inference.py:304-310``)."""
    return fused and (
        cfg.scale == 4
        and out_hw[0] % 8 == 0
        and out_hw[1] % 8 == 0
        and all(d == 1 or d % 2 == 0 for d in cfg.dilations)
        and (out_hw[0] // 4) * (out_hw[1] // 4) >= 256 * 256
    )


@pytest.mark.parametrize("kw", [{}, {"dilations": (1, 3)}, {"separable_context": False},
                                {"scale": 8}])
def test_route_gates_match_jax(kw):
    """_auto_strips, _auto_two_stage, the int8 gate and the fused heatmap
    limit equal JAX's, 1024x256 and 2048² among the shapes."""
    jcfg, cfg = JaxNetConfig(**kw), NetConfig(**kw)
    for hw in _GATE_HW:
        for fused in (False, True):
            for n in (None, 1, 2):
                assert inference._auto_two_stage(cfg, hw, n, fused) == jinf._auto_two_stage(
                    jcfg, hw, n, fused), (kw, hw, fused, n)
                assert inference._auto_strips(cfg, hw, n) == jinf._auto_strips(jcfg, hw, n)
            assert inference._int8_packed(cfg, hw, fused) == _jax_int8_gate(jcfg, hw, fused)
        assert inference._fused_heatmap_limit(cfg) == jinf._fused_heatmap_limit(jcfg)
    assert not inference._auto_two_stage(cfg, (1024, 256), None, True)
    assert inference._auto_two_stage(NetConfig(), (2048, 2048), None, True)
    assert not inference._auto_two_stage(NetConfig(), (2048, 2048), 1, True)


@functools.lru_cache(maxsize=None)
def _scan_1024():
    """One 1024² scene (seed 5) and the JAX XLA route's (result, logits)."""
    jcfg, jparams = _jax_asset("separable")
    img = SyntheticMarkupReader(n_samples=1, image_hw=(1024, 1024), seed=5).sample_at(0).image
    imgs = img[None]
    res, logits = jax.device_get(jinf.detect_program_batch(
        jparams, jnp.asarray(imgs), jcfg, (1024, 1024), fused=False))
    assert np.abs(logits[..., 0]).min() > MARGIN
    assert int(res["num_detections"].sum()) > 0
    return imgs, logits, res


@pytest.mark.parametrize("entry", ["program", "preprocessed"])
def test_auto_route_at_1024_matches_jax(entry, monkeypatch):
    """A 1024² scan takes the packed route (the packed trunk called, the
    phase-major logits postprocessed) and gives the JAX XLA route's logits
    and detections; n_strips=1 takes the whole-image trunk to the same."""
    imgs, ref_logits, ref = _scan_1024()
    cfg = load_net_config(ASSETS["separable"])
    params = load_params(ASSETS["separable"])
    calls = []
    real = inference.packed_fused_trunk_tiled
    monkeypatch.setattr(inference, "packed_fused_trunk_tiled",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if entry == "program":
        def run(**kw):
            return detect_program_batch(params, imgs, cfg, (1024, 1024), fused=True,
                                        device="cpu", **kw)
    else:
        x = (imgs.astype(np.float32) / np.float32(127.5) - 1.0)[..., None]

        def run(**kw):
            return inference.detect_preprocessed_batch(params, x, cfg, fused=True,
                                                       device="cpu", **kw)
    res, logits = run()
    assert calls == [1]
    assert logits.dtype == torch.float32 and tuple(logits.shape) == ref_logits.shape
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    assert_same_detections(res, ref, score_atol=1e-5, box_atol=4e-4)
    res1, logits1 = run(n_strips=1)
    assert calls == [1]
    np.testing.assert_allclose(logits1.numpy(), logits.numpy(), atol=1e-4)
    assert_same_detections(res1, ref, score_atol=1e-5, box_atol=4e-4)

"""PyTorch port: config, weight carry, preprocessing and the FCN forward
held against the JAX package on the same numpy inputs (CPU)."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu.models.model import get_model as jax_get_model
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops.preproc import preprocess as jax_preprocess
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import (
    NetConfig,
    detect_program_batch,
    get_model,
    load_net_config,
    load_params_npz,
    params_from_flat,
)
from ubdvss_tpu_torch.ops.preproc import preprocess_batch
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
def load_params(path):
    return params_from_flat(load_params_npz(path))


ASSETS = {
    "separable": REPO / "assets" / "pretrained_synthetic.npz",
    "dense": REPO / "assets" / "pretrained_dense_synthetic.npz",
}


def _jax_asset(path):
    cfg = jax_load_net_config(path)
    return cfg, jax_load_params_npz(path, init_params(cfg, 0))


@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_net_config_sidecar_matches_jax(asset):
    """Both sidecars load, and the port's NetConfig writes the same JSON."""
    cfg = load_net_config(ASSETS[asset])
    jcfg = jax_load_net_config(ASSETS[asset])
    assert cfg.to_json() == jcfg.to_json()
    assert NetConfig.from_json(cfg.to_json()) == cfg
    assert NetConfig().to_json() == JaxNetConfig().to_json()
    assert cfg.grid_size(509, 301) == jcfg.grid_size(509, 301)
    assert json.loads(cfg.to_json())["separable_context"] == (asset == "separable")


@pytest.mark.parametrize("hw", [64, 128])
@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_fcn_matches_flax(asset, hw):
    """params_from_flat + BarcodeFCN == flax get_model(cfg).apply on
    normalized synthetic scenes: f32 logits within 1e-5 (the JAX package's
    own parity bar), or within 1e-6 of the largest |logit| where that is
    more — the dense asset's logits reach |x| ~ 26 here, where one f32 ulp
    is 2e-6, and the two conv libraries sum 216 products per pixel and
    layer in different orders."""
    jcfg, jparams = _jax_asset(ASSETS[asset])
    cfg = load_net_config(ASSETS[asset])
    reader = SyntheticMarkupReader(n_samples=2, image_hw=(hw, hw), seed=hw)
    x = np.stack([reader.sample_at(i).image for i in range(2)])
    x = (x.astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]
    ref = np.asarray(jax_get_model(jcfg).apply({"params": jparams}, jnp.asarray(x)))
    model = get_model(cfg)
    model.load_state_dict(load_params(ASSETS[asset]))
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, hw // 4, hw // 4, cfg.n_output_channels)
    np.testing.assert_allclose(out, ref, atol=max(1e-5, 1e-6 * np.abs(ref).max()))
    n_params = sum(int(np.prod(v.shape)) for v in np.load(ASSETS[asset]).values())
    assert sum(p.numel() for p in model.parameters()) == n_params


def _halo_tile(hw, seed):
    """A tile of a larger image padded with rows beyond its top edge, as
    parallel/tiling.py builds one for the first tile: 16 rows outside the
    image (zeros, their mask 0), then the scene; (2, H, W, 1) normalized
    images and the (2, H, W, 1) boundary mask."""
    reader = SyntheticMarkupReader(n_samples=2, image_hw=(hw - 16, hw), seed=seed)
    x = np.zeros((2, hw, hw), np.float32)
    x[:, 16:] = np.stack([reader.sample_at(i).image for i in range(2)])
    x = (x * np.float32(1 / 127.5) - 1.0)[..., None]
    m = np.zeros((2, hw, hw, 1), np.float32)
    m[:, 16:] = 1.0
    return x, m


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("asset", sorted(ASSETS))
def test_fcn_boundary_mask_matches_flax(asset, dtype):
    """BarcodeFCN(x, boundary_mask=) == flax's apply(..., boundary_mask=) on
    a halo-padded 64² tile: f32 within test_fcn_matches_flax's bound, bf16
    within test_torch_bf16's FCN_ULPS bf16 ulps of max|logit|; None gives
    the unmasked forward exactly."""
    x, m = _halo_tile(64, 3)
    if dtype == "float32":
        jcfg, jparams = _jax_asset(ASSETS[asset])
        cfg, params = load_net_config(ASSETS[asset]), load_params(ASSETS[asset])
    else:
        from test_torch_bf16 import _jax_bf16, _port_bf16

        jcfg, jparams = _jax_bf16(asset)
        cfg, params = _port_bf16(asset)
    ref = np.asarray(jax_get_model(jcfg).apply({"params": jparams}, jnp.asarray(x),
                                               boundary_mask=jnp.asarray(m)))
    model = get_model(cfg)
    model.load_state_dict(params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), boundary_mask=torch.from_numpy(m)).numpy()
        plain = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=max(1e-5, 1e-6 * np.abs(ref).max()))
    else:
        from test_torch_bf16 import FCN_ULPS, _ulps

        assert _ulps(out, ref) <= FCN_ULPS
    with torch.no_grad():
        np.testing.assert_array_equal(model(torch.from_numpy(x), None).numpy(), plain)
    assert not np.array_equal(out, plain)  # the mask changed the tile's border rows


@pytest.mark.parametrize(
    "in_hw,out_hw,order",
    [
        ((37, 53), (20, 28), "rgb"),
        ((37, 53), (20, 28), "bgr"),
        ((64, 48), (128, 100), "rgb"),
        ((61, 90), (61, 90), "bgr"),
    ],
)
def test_preprocess_matches_jax(in_hw, out_hw, order):
    """grayscale (rgb/bgr) + bilinear resize (odd/even, up/down, identity)
    + normalize, within 1e-5."""
    rng = np.random.default_rng(sum(in_hw))
    imgs = rng.integers(0, 256, (2, *in_hw, 3)).astype(np.uint8)
    out = preprocess_batch(torch.from_numpy(imgs), out_hw, order).numpy()
    ref = np.stack(
        [np.asarray(jax_preprocess(jnp.asarray(im), out_hw, order)) for im in imgs]
    )
    assert out.shape == ref.shape == (2, *out_hw, 1)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_port_imports_no_jax():
    """ubdvss_tpu_torch (every module) and chip_smoke.py import no jax, flax,
    cv2, keras, tensorflow, h5py or ubdvss_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ubdvss_tpu_torch\n"
        "for m in pkgutil.walk_packages(ubdvss_tpu_torch.__path__, 'ubdvss_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'keras', "
        "'tensorflow', 'h5py', 'ubdvss_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_default_device_is_the_card():
    """Entry points run on the card unless asked for the CPU: without CUDA
    they raise instead of quietly running on the CPU."""
    cfg = NetConfig()
    params = load_params(ASSETS["separable"])
    imgs = np.zeros((1, 64, 64), np.uint8)
    if torch.cuda.is_available():
        res, _ = detect_program_batch(params, imgs, cfg.replace(max_hull_points=8), (64, 64))
        assert res["valid"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            detect_program_batch(params, imgs, cfg, (64, 64))


@pytest.mark.parametrize(
    "kw,exc,match",
    [
        # the ids the cases had beside the bf16 case, which the bf16 slice
        # removed (the bf16 route is served: tests/test_torch_bf16.py); int8
        # qparams are served (tests/test_torch_int8.py), and so is a mesh
        # (tests/test_torch_parallel.py) that divides the batch
        pytest.param(dict(qparams={}, mesh="2 cpu entries"), ValueError, "divisible", id="kw1-int8"),
        pytest.param(dict(mesh=object()), TypeError, "Mesh", id="kw2-mesh"),
    ],
)
def test_unported_routes_raise(kw, exc, match):
    """A mesh the batch cannot run on raises (a batch of 1 over 2 entries,
    an object that is no mesh); none falls back to another route or to a
    smaller mesh."""
    from ubdvss_tpu_torch.parallel import make_mesh

    args = dict(
        params=load_params(ASSETS["separable"]),
        imgs=np.zeros((1, 64, 64), np.uint8),
        cfg=NetConfig(max_hull_points=8),
        out_hw=(64, 64),
        device="cpu",
    )
    args.update(kw)
    if args["mesh"] == "2 cpu entries":
        args["mesh"] = make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(exc, match=match):
        detect_program_batch(**args)


@pytest.mark.parametrize(
    "kw",
    [
        # row strips over a 576x576 scene (the whole trunk's logits)
        dict(n_strips=2, in_hw=(576, 576), out_hw=(576, 576), fused=True),
        # a 512x512 scene resized to 1024x1024: a 256x256 heatmap
        dict(in_hw=(512, 512), out_hw=(1024, 1024), fused=True),
    ],
)
def test_large_routes_are_served(kw):
    """``n_strips`` and heatmaps past 128x128, which raised before the
    large-scan slice, against the JAX package's detect_program_batch (its
    XLA route on the CPU): logits within 1e-4; valid, areas and classes
    identical, scores within 1e-5, boxes within 1e-4 as corner sets.
    max_hull_points is past the heatmap's height, so both take exact
    rects."""
    from test_torch_postproc import assert_same_detections

    from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch

    kw = dict(kw)
    in_hw, out_hw = kw.pop("in_hw"), kw.pop("out_hw")
    cfg, jcfg = NetConfig(max_hull_points=1024), JaxNetConfig(max_hull_points=1024)
    reader = SyntheticMarkupReader(n_samples=1, image_hw=in_hw, seed=17)
    imgs = np.stack([reader.sample_at(0).image])
    _, jparams = _jax_asset(ASSETS["separable"])
    ref, ref_logits = jax_detect_program_batch(jparams, jnp.asarray(imgs), jcfg, out_hw, fused=False)
    ref_logits = np.asarray(ref_logits)
    assert np.abs(ref_logits[..., 0]).min() > 1e-4
    out, logits = detect_program_batch(
        load_params(ASSETS["separable"]), imgs, cfg, out_hw, device="cpu", **kw)
    np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
    assert int(ref["num_detections"].sum()) > 0
    assert_same_detections(out, ref, score_atol=1e-5)


@pytest.mark.parametrize(
    "kw,post",
    [
        # the XLA route: exact rects (K3x's plain version here)
        (dict(fused=False), "postprocess_batch"),
        # M >= H > 128: the JAX package takes its XLA caliper at M = H,
        # which is exact too; the port takes K3x
        (dict(cfg=NetConfig(max_hull_points=512), out_hw=(1024, 64), fused=True),
         "postprocess_batch_fused"),
    ],
)
def test_xla_route_entry_points_are_served(kw, post):
    """``fused=False`` and ``max_hull_points >= H > 128`` run to the end and
    give the postprocessing of their route on the call's own logits."""
    from ubdvss_tpu_torch.ops import postproc

    args = dict(
        params=load_params(ASSETS["separable"]),
        imgs=np.random.default_rng(0).integers(0, 256, (1, 64, 64), dtype=np.uint8),
        cfg=NetConfig(max_hull_points=8),
        out_hw=(64, 64),
        device="cpu",
    )
    args.update(kw)
    res, logits = detect_program_batch(**args)
    want = getattr(postproc, post)(logits, args["cfg"])
    assert sorted(res) == sorted(want)
    for key in want:
        assert torch.equal(res[key], want[key]), key

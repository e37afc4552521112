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
    cv2 or ubdvss_tpu module."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ubdvss_tpu_torch\n"
        "for m in pkgutil.walk_packages(ubdvss_tpu_torch.__path__, 'ubdvss_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'cv2', 'ubdvss_tpu')]\n"
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
    "kw,match",
    [
        (dict(cfg=NetConfig(dtype="bfloat16")), "bf16"),
        (dict(qparams={}), "int8"),
        (dict(mesh=object()), "mesh"),
        (dict(n_strips=2), "n_strips"),
        (dict(fused=False), "XLA"),
        (dict(out_hw=(1024, 1024)), "large-scan"),
        (dict(cfg=NetConfig(max_hull_points=64)), "K3x"),
    ],
)
def test_unported_routes_raise(kw, match):
    """Routes outside this slice raise NotImplementedError naming their
    ROADMAP.md item; none falls back to another route."""
    args = dict(
        params=load_params(ASSETS["separable"]),
        imgs=np.zeros((1, 64, 64), np.uint8),
        cfg=NetConfig(max_hull_points=8),
        out_hw=(64, 64),
        device="cpu",
    )
    args.update(kw)
    with pytest.raises(NotImplementedError, match=match) as e:
        detect_program_batch(**args)
    assert "ROADMAP.md" in str(e.value)

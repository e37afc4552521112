"""PyTorch port: the train-time augmentation (``ops/augment.py``) and the
train half of the batch pipeline (``data.py``) against the JAX package on
the CPU.

JAX's PRNG streams are not reproduced: the port draws from a
``torch.Generator``.  So the arithmetic is held on JAX's own draws — the
values ``random_affine`` and ``photometric`` draw from their subkeys,
recomputed here from the same keys — and the sampling is held by its
properties (determinism under a seed, independent factors, flips, crop).

Tolerances (f32 on the [0, 255] image domain):
  * affines from the same draws: 2e-6 absolute plus 5e-7 relative (about
    4 ulps: cos/sin of XLA and of torch may differ by an ulp, and the
    translation sums it into values of up to ~100);
  * ``affine_warp`` against the JAX package's ``affine_warp`` (not the
    gather oracle) on the ident, shift, zoom and rot10 cases: 5e-3
    absolute, 2e-5 of the domain (the two passes' lerps and XLA's dot
    round in another order);
  * the photometric arithmetic on the same draws: 6.2e-5, 4 f32 ulps at
    255 (XLA fuses it into multiply-adds under jit);
  * untransformed batches (``augment=None``): bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu import data as jdata
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops import augment as ja
from ubdvss_tpu.synthetic import SyntheticMarkupReader as JaxSyntheticMarkupReader
from ubdvss_tpu_torch import data as pdata
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops import augment as pa
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

CONFIGS = {
    "default": pa.AugmentConfig(),
    "crop_flip_y": pa.AugmentConfig(crop_frac=0.3, flip_y_prob=0.5, rotation_deg=25.0),
}


def _jax_cfg(cfg):
    return ja.AugmentConfig(**cfg.__dict__)


def _jax_affine_draws(key, cfg):
    """The values JAX's ``random_affine`` draws from its nine subkeys."""
    k = jax.random.split(key, 9)
    u = jax.random.uniform
    tf = cfg.translate_frac
    d = {
        "ang": u(k[0], (), minval=-cfg.rotation_deg, maxval=cfg.rotation_deg),
        "sc": u(k[1], (), minval=cfg.scale_range[0], maxval=cfg.scale_range[1]),
        "tx": u(k[2], (), minval=-tf, maxval=tf),
        "ty": u(k[3], (), minval=-tf, maxval=tf),
        "fx": u(k[4]),
        "fy": u(k[5]),
    }
    if cfg.crop_frac > 0.0:
        d["cs"] = u(k[6], (), minval=1.0 - cfg.crop_frac, maxval=1.0)
        d["cx"] = u(k[7])
        d["cy"] = u(k[8])
    return {n: torch.tensor(np.asarray(v))[None] for n, v in d.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_affine_from_jax_draws(name):
    cfg = CONFIGS[name]
    for seed in range(8):
        key = jax.random.key(seed)
        want = np.asarray(jax.jit(ja.random_affine, static_argnums=(1, 2))(key, _jax_cfg(cfg), (48, 64)))
        got = pa.affine_from_draws(_jax_affine_draws(key, cfg), cfg, (48, 64))[0].numpy()
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=2e-6)


def test_transform_and_invert_match_jax():
    rng = np.random.default_rng(0)
    m = rng.normal(0, 1, (4, 2, 3)).astype(np.float32)
    pts = rng.uniform(0, 64, (4, 3, 5, 2)).astype(np.float32)
    got = pa.transform_points(torch.from_numpy(pts), torch.from_numpy(m)).numpy()
    inv = pa._invert_affine(torch.from_numpy(m)).numpy()
    for i in range(4):
        np.testing.assert_allclose(got[i], np.asarray(ja.transform_points(pts[i], m[i])), atol=1e-5)
        np.testing.assert_allclose(inv[i], np.asarray(ja._invert_affine(jnp.asarray(m[i]))), rtol=1e-6, atol=1e-6)
        single = pa.transform_points(torch.from_numpy(pts[i]), torch.from_numpy(m[i])).numpy()
        np.testing.assert_allclose(single, got[i], atol=1e-5)


def _warp_images(s=64):
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, (s, s)).astype(np.float32)
    return {"plane": yy * 2.0 + xx, "noise": noise}


def _warp_cases(s=64):
    c10, s10 = np.cos(np.radians(10)), np.sin(np.radians(10))
    cx = cy = s / 2
    return {
        "ident": [[1, 0, 0], [0, 1, 0]],
        "shift": [[1, 0, 0.5], [0, 1, 0.25]],
        "zoom": [[1.3, 0, cx - 1.3 * cx], [0, 1.3, cy - 1.3 * cy]],
        "rot10": [[c10, -s10, cx - c10 * cx + s10 * cy], [s10, c10, cy - s10 * cx - c10 * cy]],
    }


@pytest.mark.parametrize("case", ["ident", "shift", "zoom", "rot10"])
def test_affine_warp_matches_jax(case):
    """The two-pass warp against JAX's two-pass warp (not the oracle), one
    image at a time and as a batch; the 4-tap oracle against JAX's oracle."""
    m = np.asarray(_warp_cases()[case], np.float32)
    imgs = _warp_images()
    warp = jax.jit(ja.affine_warp, static_argnums=(2, 3))
    for img in imgs.values():
        want = np.asarray(warp(img, m, -1.0, 0.62))
        got = pa.affine_warp(torch.from_numpy(img), torch.from_numpy(m), -1.0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
        np.testing.assert_array_equal(got == -1.0, want == -1.0)
        oracle = pa.affine_warp_gather(torch.from_numpy(img), torch.from_numpy(m), -1.0).numpy()
        np.testing.assert_allclose(oracle, np.asarray(ja.affine_warp_gather(img, m, -1.0)), atol=1e-4)
    stack = torch.from_numpy(np.stack(list(imgs.values())))
    batch = pa.affine_warp(stack, torch.from_numpy(np.stack([m, m])), -1.0)
    for i, img in enumerate(imgs.values()):
        single = pa.affine_warp(torch.from_numpy(img), torch.from_numpy(m), -1.0)
        np.testing.assert_array_equal(batch[i].numpy(), single.numpy())


def test_photometric_on_jax_draws():
    cfg = pa.AugmentConfig()
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        d = {
            "b": torch.tensor(np.asarray(jax.random.uniform(k1, (), minval=-cfg.brightness,
                                                            maxval=cfg.brightness)))[None],
            "c": torch.tensor(np.asarray(jax.random.uniform(
                k2, (), minval=cfg.contrast_range[0], maxval=cfg.contrast_range[1])))[None],
            "noise": torch.tensor(np.asarray(jax.random.normal(k3, img.shape)))[None],
        }
        want = np.asarray(jax.jit(ja.photometric, static_argnums=(2,))(key, img, _jax_cfg(cfg)))
        got = pa.photometric_apply(torch.from_numpy(img)[None], d, cfg)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=6.2e-5)


def test_draw_ranges_and_determinism():
    """Every draw lies in its config range; a seed gives one batch; the
    translations are independent (the JAX package's decorrelation test)."""
    cfg = pa.AugmentConfig(rotation_deg=0.0, scale_range=(1.0, 1.0), flip_prob=0.0, translate_frac=0.2)
    d = pa.affine_draws(torch.Generator().manual_seed(0), cfg, 500)
    t = pa.affine_from_draws(d, cfg, (64, 64))[:, :, 2].numpy()  # the center cancels
    assert abs(np.corrcoef(t[:, 0], t[:, 1])[0, 1]) < 0.2
    assert (np.abs(t) <= 0.2 * 64 + 1e-4).all() and t.std(0).min() > 1.0
    full = pa.affine_draws(torch.Generator().manual_seed(1), CONFIGS["crop_flip_y"], 2000)
    c = CONFIGS["crop_flip_y"]
    assert float(full["ang"].abs().max()) <= c.rotation_deg
    assert float(full["cs"].min()) >= 1.0 - c.crop_frac and float(full["cs"].max()) <= 1.0
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 32, 32)).astype(np.float32))
    polys = torch.from_numpy(rng.uniform(0, 32, (2, 2, 4, 2)).astype(np.float32))
    i1, p1 = pa.augment_batch(torch.Generator().manual_seed(42), img, polys, pa.AugmentConfig())
    i2, p2 = pa.augment_batch(torch.Generator().manual_seed(42), img, polys, pa.AugmentConfig())
    i3, _ = pa.augment_batch(torch.Generator().manual_seed(43), img, polys, pa.AugmentConfig())
    assert torch.equal(i1, i2) and torch.equal(p1, p2) and not torch.allclose(i1, i3)
    assert float(i1.min()) >= 0.0 and float(i1.max()) <= 255.0
    s_img, s_p = pa.augment_sample(torch.Generator().manual_seed(42), img[0], polys[0], pa.AugmentConfig())
    assert s_img.shape == img[0].shape and s_p.shape == polys[0].shape


def test_flip_y_and_crop_keep_image_and_polygons_together():
    """flip_y_prob=1 mirrors rows and polygon y about the center (the JAX
    package's test); a crop zooms, and a bright blob's polygon follows it."""
    quiet = dict(rotation_deg=0.0, scale_range=(1.0, 1.0), translate_frac=0.0, flip_prob=0.0,
                 brightness=0.0, contrast_range=(1.0, 1.0), noise_std=0.0)
    cfg = pa.AugmentConfig(flip_y_prob=1.0, **quiet)
    img = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    m = pa.random_affine(torch.Generator().manual_seed(0), cfg, (4, 4))
    out = pa.affine_warp(img, m, 0.0)
    np.testing.assert_allclose(out[1:].numpy(), img.numpy()[:0:-1])
    np.testing.assert_allclose(pa.transform_points(torch.tensor([[1.0, 1.0]]), m).numpy(), [[1.0, 3.0]],
                               atol=1e-5)
    crop = pa.AugmentConfig(crop_frac=0.4, **quiet)
    blob = torch.zeros((64, 64))
    blob[30:34, 20:24] = 255.0
    for seed in range(5):
        m = pa.random_affine(torch.Generator().manual_seed(seed), crop, (64, 64))
        assert float(m[0, 0]) >= 1.0 - 1e-6 and abs(float(m[0, 1])) < 1e-6
        out = pa.affine_warp(blob, m, 0.0, max_shear=pa.max_shear_for(crop))
        cx, cy = pa.transform_points(torch.tensor([[22.0, 32.0]]), m)[0].tolist()
        ys, xs = np.nonzero(out.numpy() > 128)
        assert abs(xs.mean() - cx) < 1.5 and abs(ys.mean() - cy) < 1.5


def test_train_batches_without_augment_equal_jax():
    """Batches(train=True, augment=None): the JAX package's shuffle, and
    images, polygons and segmaps bit for bit, over two epochs."""
    cfg, jcfg = NetConfig(), JaxNetConfig()
    dc = pdata.DataConfig(batch_size=2, train_hw=(32, 32), augment=None, seed=5)
    jdc = jdata.DataConfig(batch_size=2, train_hw=(32, 32), augment=None, seed=5)
    reader = SyntheticMarkupReader(n_samples=5, image_hw=(32, 32), seed=4)
    jreader = JaxSyntheticMarkupReader(n_samples=5, image_hw=(32, 32), seed=4)
    port = pdata.Batches(reader, cfg, dc, train=True, device="cpu")
    ref = jdata.Batches(jreader, jcfg, jdc, train=True)
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for k in ("images", "segmap", "polys", "n_verts", "class_ids"):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def test_train_batches_augment_per_epoch_and_batch():
    """Augmented batches: the batch contract, a fresh draw each batch and
    each epoch, the same batch again for the same (seed, epoch, index)."""
    cfg = NetConfig()
    dc = pdata.DataConfig(batch_size=2, train_hw=(32, 32), shuffle=False, seed=3)
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(32, 32), seed=4)
    b = pdata.Batches(reader, cfg, dc, train=True, device="cpu")
    e0, e0b, e1 = list(b.epoch(0)), list(b.epoch(0)), list(b.epoch(1))
    plain = list(pdata.Batches(reader, cfg, pdata.DataConfig(batch_size=2, train_hw=(32, 32), augment=None),
                               train=False, device="cpu").epoch(0))
    for x, y, z, p in zip(e0, e0b, e1, plain):
        assert x["images"].shape == (2, 32, 32, 1) and x["segmap"].shape == (2, 8, 8)
        assert x["segmap"].dtype == p["segmap"].dtype and x["polys"].shape == p["polys"].shape
        assert torch.equal(x["images"], y["images"]) and torch.equal(x["polys"], y["polys"])
        assert not torch.equal(x["images"], z["images"]) and not torch.equal(x["images"], p["images"])
    assert not torch.equal(e0[0]["images"], e0[1]["images"])
    assert pdata.batch_seed(7, 0) != pdata.batch_seed(7, 1) != pdata.batch_seed(8, 1)
    with pytest.raises(ValueError, match="generator"):
        pdata.device_batch_step(plain[0]["images"][..., 0], plain[0]["polys"], plain[0]["n_verts"],
                                plain[0]["class_ids"], cfg, dc, True)

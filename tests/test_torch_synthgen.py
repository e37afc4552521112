"""PyTorch port: the on-device scene synthesis (``synthgen.py``) and the
windowed rasterizer against the JAX package on the CPU.

JAX's PRNG streams are not reproduced: the port draws from a
``torch.Generator``.  So the arithmetic is held on JAX's own draws — the
values ``generate_scene`` draws from its keys, recomputed here from the
same keys (``_jax_scene_draws``) — and the sampling by its properties.

Tolerances:
  * ``build_class_tables``, ``_hash01`` (seeds past 2^31 included), each
    texel function on JAX's (u, v) and parameters, and the windowed
    rasterizer: bit for bit;
  * ``render_scenes`` on JAX's draws against ``generate_scene`` at 96²,
    128², 160² and 192², with and without an affine: polygons within 1e-4
    (JAX's own identity-affine bar), ``n_verts`` and ``class_ids``
    identical, every pixel within 1e-3 except texel flips (a texel decision
    taken on the other side by one ulp of a coordinate), at most 1 in 10^4
    window pixels.  Measured: 0 flips in every case, pixels within 1.9e-4
    (the coverage edge of an affine's out-of-frame fill) and 1.6e-5 without
    an affine, polygons within 1.6e-5.  The multiply-adds XLA contracts
    under ``jit`` are rounded once in the port (``synthgen._fma``); without
    that a case showed up to 1.2e-3 of its window pixels flipped.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu import synthgen as js
from ubdvss_tpu.data import DataConfig as JaxDataConfig
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops import rasterize as jrast
from ubdvss_tpu.ops.augment import AugmentConfig as JaxAugmentConfig
from ubdvss_tpu_torch import synthgen as ps
from ubdvss_tpu_torch.data import DataConfig
from ubdvss_tpu_torch.evaluate import _collect_batch, evaluate_detections
from ubdvss_tpu_torch.inference import detect_program_batch
from ubdvss_tpu_torch.net_config import DEFAULT_CLASS_NAMES, NetConfig
from ubdvss_tpu_torch.ops import rasterize as prast
from ubdvss_tpu_torch.ops.augment import AugmentConfig, affine_from_draws, affine_draws
from ubdvss_tpu_torch.synthetic import _render_barcode
from ubdvss_tpu_torch.utils.checkpoint import load_params_npz, params_from_flat

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")


def _jax_scene_draws(key, sc):
    """The values ``generate_scene`` draws from ``key``, as ``scene_draws``'
    (1, ...) tensors."""
    H, W = sc.hw
    P = sc.max_polys
    g = max(1, math.ceil(math.sqrt(max(P, sc.n_objects[1]))))
    bw_hi = max(41.0, min(108.0, W / 2))
    bh_hi = max(25.0, min(60.0, H / 3))
    u = jax.random.uniform
    k_n, k_bg, k_noise, k_perm, k_obj = jax.random.split(key, 5)
    d = {
        "n": jax.random.randint(k_n, (), sc.n_objects[0], sc.n_objects[1] + 1),
        "base": u(k_bg, (), minval=170.0, maxval=240.0),
        "noise": jax.random.normal(k_noise, (H, W)),
        "cells": jax.random.permutation(k_perm, g * g)[:P],
    }
    per = {k: [] for k in ("c", "bw", "bh", "rot_u", "ang", "jx", "jy", "module_u", "phase1d",
                           "phasep", "seed2d")}
    for i in range(P):
        ks = jax.random.split(jax.random.fold_in(k_obj, i), 8)
        kk = jax.random.split(ks[7], 4)
        per["c"].append(jax.random.randint(ks[0], (), 0, len(sc.class_names)))
        per["bw"].append(u(ks[1], (), minval=40.0, maxval=bw_hi))
        per["bh"].append(u(ks[2], (), minval=24.0, maxval=bh_hi))
        per["rot_u"].append(u(ks[3], ()))
        per["ang"].append(u(ks[4], (), minval=-30.0, maxval=30.0))
        per["jx"].append(u(ks[5], (), minval=-1.0, maxval=1.0))
        per["jy"].append(u(ks[6], (), minval=-1.0, maxval=1.0))
        per["module_u"].append(u(kk[0], (), minval=0.9, maxval=1.15))
        per["phase1d"].append(jax.random.randint(kk[1], (), 0, 96))
        per["phasep"].append(jax.random.randint(kk[2], (), 0, 48))
        per["seed2d"].append(jax.random.randint(kk[3], (), 0, 2**31 - 1, dtype=jnp.int32).astype(jnp.uint32))
    d.update({k: np.stack([np.asarray(x) for x in v]) for k, v in per.items()})

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(a.astype(np.int64 if a.dtype.kind in "iu" else np.float32))[None]

    return {k: t(v) for k, v in d.items()}


def _cat(draws):
    return {k: torch.cat([d[k] for d in draws]) for k in draws[0]}


def _similarity(hw, s):
    """A rotation-and-scale about the centre plus a shift (the kind of
    affine ``random_affine`` makes), varied with ``s``."""
    th = 0.3 * (s - 4) / 4
    sc = 0.8 + 0.05 * s
    c, si = math.cos(th) * sc, math.sin(th) * sc
    cx, cy = hw[1] / 2, hw[0] / 2
    return np.array([[c, -si, cx - c * cx + si * cy + 3.0], [si, c, cy - si * cx - c * cy - 2.0]], np.float32)


def test_class_tables_match_jax():
    for names in (DEFAULT_CLASS_NAMES, ("EAN13", "Code39", "Postnet", "QRCode", "Mystery")):
        want = js.build_class_tables(names)
        got = ps.build_class_tables(names)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_hash01_matches_jax():
    rng = np.random.default_rng(0)
    r = rng.integers(-300, 300, 4096).astype(np.int32)
    c = rng.integers(-300, 300, 4096).astype(np.int32)
    seed = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    seed[:4] = [0, 2**31 - 2, 2**31, 2**32 - 1]
    assert (seed >= 2**31).sum() > 1000
    want = np.asarray(jax.jit(js._hash01)(jnp.asarray(r), jnp.asarray(c), jnp.asarray(seed)))
    got = ps._hash01(torch.from_numpy(r.astype(np.int64)), torch.from_numpy(c.astype(np.int64)),
                     torch.from_numpy(seed.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    # the PDF417 rows' second stream, seed + 101, wraps past 2^32 as uint32
    want = np.asarray(jax.jit(lambda a, b, s: js._hash01(a, b, s + jnp.uint32(101)))(r, c, seed))
    got = ps._hash01(torch.from_numpy(r.astype(np.int64)), torch.from_numpy(c.astype(np.int64)),
                     torch.from_numpy(seed.astype(np.int64)) + 101).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["1d", "postal", "2d"])
def test_texel_matches_jax(kind):
    """Each texel function of every class on JAX's (u, v) grid and
    parameters, several objects at once in the port."""
    names = DEFAULT_CLASS_NAMES
    tj = {k: jnp.asarray(v) for k, v in js.build_class_tables(names).items()}
    tp = ps._device_tables(names, torch.device("cpu"))
    vv, uu = np.mgrid[0:70, 0:124].astype(np.float32)
    rng = np.random.default_rng(1)
    objs = []
    for cid in range(len(names)):
        for _ in range(2):
            bw = np.float32(rng.uniform(20, 110))
            bh = np.float32(rng.uniform(12, 60))
            objs.append(dict(c=cid, bw=bw, bh=bh, mp=np.float32(tj["module"][cid] * rng.uniform(0.9, 1.15)),
                             ph1=int(rng.integers(0, 96)), php=int(rng.integers(0, 48)),
                             seed=int(rng.integers(0, 2**31 - 1)),
                             u=(uu * np.float32(rng.uniform(0.8, 1.1)) - np.float32(rng.uniform(0, 8))),
                             v=(vv * np.float32(rng.uniform(0.8, 1.1)) - np.float32(rng.uniform(0, 8)))))
    jfn = {
        "1d": jax.jit(lambda u, v, bw, bh, mp, ph, c: js._texel_1d(u, v, bw, bh, mp, ph, tj, c)),
        "postal": jax.jit(lambda u, v, bw, bh, ph, c: js._texel_postal(u, v, bw, bh, ph, tj, c)),
        "2d": jax.jit(lambda u, v, bw, bh, sd, c: js._texel_2d(u, v, bw, bh, sd, tj, c)),
    }[kind]
    want = []
    for o in objs:
        if kind == "1d":
            args = (o["mp"], o["ph1"])
        elif kind == "postal":
            args = (o["php"],)
        else:
            args = (jnp.uint32(o["seed"]),)
        want.append(np.asarray(jfn(o["u"], o["v"], o["bw"], o["bh"], *args, o["c"])).ravel())
    u = torch.from_numpy(np.stack([o["u"].ravel() for o in objs]))
    v = torch.from_numpy(np.stack([o["v"].ravel() for o in objs]))

    def col(k):
        return torch.tensor([[o[k]] for o in objs], dtype=torch.float32)

    def ints(k):
        return torch.tensor([o[k] for o in objs])

    c = ints("c")
    if kind == "1d":
        got = ps._texel_1d(u, v, col("bw"), col("bh"), col("mp"), ints("ph1"), tp, c)
    elif kind == "postal":
        got = ps._texel_postal(u, v, col("bw"), col("bh"), ints("php"), tp, c)
    else:
        got = ps._texel_2d(u, v, col("bw"), col("bh"), ints("seed"), tp, c)
    assert got.dtype == torch.bool  # JAX's texels are {0, 1} f32
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), np.stack(want))
    assert 0 < float(got.to(torch.float32).mean()) < 1


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
@pytest.mark.parametrize("side", [96, 128, 160, 192])
def test_render_scenes_matches_jax(side, affine):
    hw = (side, side)
    sc = js.SynthConfig(hw=hw, n_objects=(1, 4), max_polys=4)
    psc = ps.SynthConfig(hw=hw, n_objects=(1, 4), max_polys=4)
    keys = [jax.random.PRNGKey(s) for s in range(6)]
    ms = np.stack([_similarity(hw, s) for s in range(len(keys))])
    if affine:
        gen = jax.jit(lambda k, m: js.generate_scene(k, sc, affine=m))
        want = [jax.device_get(gen(k, m)) for k, m in zip(keys, ms)]
    else:
        gen = jax.jit(lambda k: js.generate_scene(k, sc))
        want = [jax.device_get(gen(k)) for k in keys]
    draws = _cat([_jax_scene_draws(k, sc) for k in keys])
    imgs, polys, nv, ci = ps.render_scenes(draws, psc, affine=torch.from_numpy(ms) if affine else None)
    w_img, w_polys, w_nv, w_ci = (np.stack([w[i] for w in want]) for i in range(4))
    np.testing.assert_array_equal(nv.numpy(), w_nv)
    np.testing.assert_array_equal(ci.numpy(), w_ci)
    np.testing.assert_allclose(polys.numpy(), w_polys, rtol=0, atol=1e-4)
    diff = np.abs(imgs.numpy() - w_img)
    flips = int((diff > 1e-3).sum())
    window_px = int((w_nv > 0).sum()) * min(128, side) ** 2
    assert flips <= 1e-4 * window_px, (flips, window_px)
    assert imgs.dtype == torch.float32 and float(imgs.min()) >= 0 and float(imgs.max()) <= 255


def test_windowed_rasterizer_matches_jax_and_dense():
    """tests/test_rasterize.py:84's polygons (bounded, overlapping, hugging
    the border), a batch at once: bit for bit JAX's windowed version, and
    the port's dense one."""
    rng = np.random.default_rng(0)
    H = W = 64
    wn = 24
    B, P, V = 6, 5, 6
    polys = np.zeros((B, P, V, 2), np.float32)
    n_verts = np.zeros((B, P), np.int32)
    class_ids = np.zeros((B, P), np.int32)
    for b in range(B):
        for p in range(P):
            cx, cy = rng.uniform(2, W - 2), rng.uniform(2, H - 2)
            nv = int(rng.integers(3, V + 1))
            ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
            r = rng.uniform(2, (wn - 5) / 2, nv)
            polys[b, p, :nv, 0] = np.clip(np.round(cx + r * np.cos(ang)), 0, W - 1)
            polys[b, p, :nv, 1] = np.clip(np.round(cy + r * np.sin(ang)), 0, H - 1)
            n_verts[b, p] = nv
            class_ids[b, p] = 1 + int(rng.integers(0, 4))
    n_verts[0, 1] = 2  # a degenerate polygon is skipped
    args = tuple(torch.from_numpy(a) for a in (polys, n_verts, class_ids))
    got = prast.rasterize_polygons_windowed(*args, (H, W), wn).numpy()
    want = np.stack([np.asarray(jrast.rasterize_polygons_windowed(polys[b], n_verts[b], class_ids[b], (H, W), wn))
                     for b in range(B)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, prast.rasterize_polygons(*args, (H, W)).numpy())
    assert got.dtype == np.int32 and (got > 0).any()


def _jax_raster_window(hw, net_cfg, monkeypatch):
    """The raster window JAX's ``synth_batch_step`` derives, read from the
    ``DataConfig`` it hands ``finalize_batch`` (traced abstractly)."""
    import ubdvss_tpu.data as jdata

    seen = []
    real = jdata.finalize_batch

    def spy(imgs, polys, n_verts, class_ids, cfg, dc):
        seen.append(dc.raster_window)
        return real(imgs, polys, n_verts, class_ids, cfg, dc)

    monkeypatch.setattr(jdata, "finalize_batch", spy)
    sc = js.SynthConfig(hw=hw, max_polys=4)
    dc = JaxDataConfig(batch_size=1, train_hw=hw, max_polys=4, augment=None)
    jax.eval_shape(lambda k: js.synth_batch_step.__wrapped__(k, sc, net_cfg, dc, False), jax.random.PRNGKey(0))
    return seen[-1]


@pytest.mark.parametrize("hw", [(64, 64), (96, 160), (256, 256), (512, 512)])
def test_synth_raster_window_matches_jax(hw, monkeypatch):
    want = _jax_raster_window(hw, JaxNetConfig(), monkeypatch)
    assert ps.synth_raster_window(ps.SynthConfig(hw=hw, max_polys=4), NetConfig()) == want


@pytest.mark.parametrize("train", [True, False], ids=["augmented", "plain"])
def test_synth_batch_step_contract(train):
    """The batch contract, per-step variation, and segmaps that line up
    with the polygons (tests/test_synthgen.py:186-212)."""
    cfg = NetConfig(max_components=4)
    dc = DataConfig(batch_size=3, train_hw=(96, 96), max_polys=4)
    sc = ps.SynthConfig(hw=(96, 96), n_objects=(1, 3), max_polys=4)
    b = ps.synth_batch_step(ps.step_generator(0, 0, 0, "cpu"), sc, cfg, dc, train)
    again = ps.synth_batch_step(ps.step_generator(0, 0, 0, "cpu"), sc, cfg, dc, train)
    other = ps.synth_batch_step(ps.step_generator(0, 0, 1, "cpu"), sc, cfg, dc, train)
    assert set(b) == {"images", "segmap", "polys", "n_verts", "class_ids"}
    assert b["images"].shape == (3, 96, 96, 1) and b["images"].dtype == torch.float32
    assert b["segmap"].shape == (3, 24, 24) and b["segmap"].dtype == torch.int32
    assert b["polys"].shape == (3, 4, 8, 2)
    assert float(b["images"].abs().max()) <= 1.0 + 1e-6
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert not torch.equal(b["images"], other["images"])
    # the windowed segmap equals the dense rasterization of the same polygons
    dense = prast.rasterize_polygons(prast.polygons_to_grid(b["polys"], cfg.scale), b["n_verts"],
                                     b["class_ids"], (24, 24))
    assert torch.equal(b["segmap"], dense)
    for i in range(3):
        for p in range(4):
            if b["n_verts"][i, p]:
                pts = b["polys"][i, p, :4] / cfg.scale
                if pts.min() >= 0 and pts[:, 0].max() < 24 and pts[:, 1].max() < 24:
                    assert bool((b["segmap"][i] == b["class_ids"][i, p]).any())


def test_scene_contract_and_determinism():
    """tests/test_synthgen.py:25-55 on the port's generator."""
    sc = ps.SynthConfig(hw=(96, 96), n_objects=(1, 3), max_polys=4)

    def scene(seed):
        g = torch.Generator().manual_seed(seed)
        return ps.render_scenes(ps.scene_draws(g, sc, 2), sc)

    a, b = scene(3), scene(3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], scene(4)[0])
    img, polys, n_verts, class_ids = (t.numpy() for t in a)
    assert img.shape == (2, 96, 96) and img.dtype == np.float32
    assert img.min() >= 0.0 and img.max() <= 255.0
    for i in range(2):
        assert 1 <= int((n_verts[i] > 0).sum()) <= 3
        for p in range(4):
            if n_verts[i, p]:
                assert n_verts[i, p] == 4 and 1 <= class_ids[i, p] <= len(sc.class_names)
                pts = polys[i, p, :4]
                assert pts.min() >= 0 and pts.max() <= 96
                cx, cy = pts[:, 0].mean(), pts[:, 1].mean()
                y0, y1 = int(max(0, cy - 8)), int(min(96, cy + 8))
                x0, x1 = int(max(0, cx - 8)), int(min(96, cx + 8))
                assert img[i, y0:y1, x0:x1].min() < 140, f"object {p} has no dark texture"


def test_objects_disjoint():
    """tests/test_synthgen.py:58-85: the cell placement keeps the objects'
    bounding boxes pairwise disjoint."""
    sc = ps.SynthConfig(hw=(128, 128), n_objects=(4, 4), max_polys=4)
    _, polys, n_verts, _ = ps.render_scenes(ps.scene_draws(torch.Generator().manual_seed(0), sc, 8), sc)
    for b in range(8):
        boxes = [(p[:4, 0].min(), p[:4, 1].min(), p[:4, 0].max(), p[:4, 1].max())
                 for p, nv in zip(polys[b].numpy(), n_verts[b].numpy()) if nv]
        assert len(boxes) == 4
        for i in range(4):
            for j in range(i + 1, 4):
                a, c = boxes[i], boxes[j]
                assert a[2] <= c[0] or c[2] <= a[0] or a[3] <= c[1] or c[3] <= a[1], (b, i, j)


def test_1d_duty_signature_matches_host():
    """tests/test_synthgen.py:88-113: the stripe field's dark fraction of a
    1D class matches the host renderer's."""
    names = ("EAN13", "Code93", "Codabar")
    tp = ps._device_tables(names, torch.device("cpu"))
    rng = np.random.default_rng(0)
    vv, uu = np.mgrid[0:40, 0:96].astype(np.float32)
    u = torch.from_numpy(uu.reshape(1, -1))
    v = torch.from_numpy(vv.reshape(1, -1))
    for c, name in enumerate(names):
        col = torch.tensor([[96.0]]), torch.tensor([[40.0]]), tp["module"][c].view(1, 1)
        dark = ps._texel_1d(u, v, *col, torch.tensor([0]), tp, torch.tensor([c]))
        host = _render_barcode(rng, 96, 40, "1D", name)
        assert abs(float(dark.to(torch.float32).mean()) - float((host < 128).mean())) < 0.12, name


def test_identity_affine_reproduces_scene():
    """tests/test_synthgen.py:116-134 on the port's generator."""
    sc = ps.SynthConfig(hw=(128, 128), n_objects=(2, 4), max_polys=4)
    draws = ps.scene_draws(torch.Generator().manual_seed(5), sc, 4)
    ident = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).expand(4, 2, 3)
    a = ps.render_scenes(draws, sc)
    b = ps.render_scenes(draws, sc, affine=ident)
    np.testing.assert_allclose(b[1].numpy(), a[1].numpy(), atol=1e-4)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), atol=1e-3)


def test_affine_translation_and_rotation():
    """tests/test_synthgen.py:137-182: a translation shifts the polygons
    exactly and the texture with them; a rotation with a downscale leaves a
    fill border and texture inside every polygon."""
    sc = ps.SynthConfig(hw=(160, 160), n_objects=(2, 2), max_polys=4)
    draws = ps.scene_draws(torch.Generator().manual_seed(11), sc, 2)
    t = torch.tensor([[1.0, 0.0, 9.0], [0.0, 1.0, -13.0]]).expand(2, 2, 3)
    _, p0, nv0, _ = ps.render_scenes(draws, sc)
    img1, p1, nv1, _ = ps.render_scenes(draws, sc, affine=t)
    assert torch.equal(nv0, nv1)
    m = nv1 > 0
    np.testing.assert_allclose(p1[m][:, :4].numpy(), (p0[m][:, :4] + torch.tensor([9.0, -13.0])).numpy(), atol=1e-4)
    sc = ps.SynthConfig(hw=(192, 192), n_objects=(3, 3), max_polys=4)
    acfg = AugmentConfig(rotation_deg=25.0, scale_range=(0.75, 0.75), translate_frac=0.0)
    g = torch.Generator().manual_seed(2)
    aff = affine_from_draws(affine_draws(g, acfg, 2), acfg, sc.hw)
    for imgs, polys, nv in [(img1, p1, nv1),
                            ps.render_scenes(ps.scene_draws(g, sc, 2), sc, affine=aff)[:3]]:
        side = imgs.shape[-1]
        for i in range(2):
            for p in range(4):
                if nv[i, p]:
                    cx, cy = float(polys[i, p, :4, 0].mean()), float(polys[i, p, :4, 1].mean())
                    y0, y1 = int(max(0, cy - 6)), int(min(side, cy + 6))
                    x0, x1 = int(max(0, cx - 6)), int(min(side, cx + 6))
                    assert float(imgs[i, y0:y1, x0:x1].min()) < 140
    assert float(imgs[:, 0, 0].min()) > 250.0 and float(imgs[:, -1, -1].min()) > 250.0


def test_device_synthetic_batches_contract():
    """tests/test_synthgen.py:215-233: the iterable's contract, its length,
    and fresh scenes a new epoch."""
    cfg = NetConfig(max_components=4)
    dc = DataConfig(batch_size=2, train_hw=(64, 64), max_polys=4)
    batches = ps.DeviceSyntheticBatches(cfg, dc, n_samples=4, seed=1, device="cpu")
    assert len(batches) == 2
    e0 = list(batches.epoch(0))
    assert len(e0) == 2 and e0[0]["images"].shape == (2, 64, 64, 1) and e0[0]["segmap"].shape == (2, 16, 16)
    assert all(torch.equal(a["images"], b["images"]) for a, b in zip(e0, batches.epoch(0)))
    assert not torch.equal(e0[0]["images"], next(iter(batches.epoch(1)))["images"])
    assert not torch.equal(e0[0]["images"], e0[1]["images"])
    assert torch.equal(e0[1]["images"], batches.batch_at(0, 1)["images"])
    assert ps.SynthConfig().__dict__ == js.SynthConfig().__dict__
    assert AugmentConfig().__dict__ == JaxAugmentConfig().__dict__


def test_transfer_gate_on_port_scenes():
    """tests/test_synthgen.py:236-267 on the port's generator: the dense
    asset, trained on host-rendered scenes, detects and classifies 16
    port-generated 256² scenes (the class tables carry the host's cues)."""
    cfg = NetConfig(max_components=8, separable_context=False)
    params = params_from_flat(load_params_npz(os.path.join(ASSETS, "pretrained_dense_synthetic.npz")))
    sc = ps.SynthConfig(hw=(256, 256), n_objects=(1, 3), max_polys=4)
    imgs, polys, n_verts, class_ids = ps.render_scenes(
        ps.scene_draws(ps.step_generator(7, 0, 0, "cpu"), sc, 16), sc)
    res, _ = detect_program_batch(params, imgs, cfg, (256, 256), fused=False, device="cpu")
    per_image: list[dict] = []
    _collect_batch(per_image, {k: v.numpy() for k, v in res.items()}, polys.numpy(), n_verts.numpy(),
                   class_ids.numpy())
    r = evaluate_detections(per_image, class_names=cfg.class_names)
    assert r.f1 >= 0.95, r.f1
    assert r.class_accuracy >= 0.75, r.class_accuracy

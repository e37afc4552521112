"""PyTorch port: the evaluation half of the input pipeline (``data.py``),
the rasterizer, the markup readers and the prefetch thread, on the CPU,
held against the JAX package on the same inputs.

Tolerances: none.  ``Batches(train=False)``'s images are held bit for bit
in both collate routes (one batched resize for same-shaped images, one
resize a sample otherwise; the normalize rounded once, as under ``jit``),
and the polygons, vertex counts, class ids and rasterized segmaps equal.
"""

import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubdvss_tpu import data as jdata
from ubdvss_tpu import markup as jmarkup
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.ops import rasterize as jrast
from ubdvss_tpu.synthetic import SyntheticMarkupReader as JaxSyntheticMarkupReader
from ubdvss_tpu_torch import data as pdata
from ubdvss_tpu_torch import markup as pmarkup
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops import rasterize as prast
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.utils.prefetch import prefetched

torch.set_num_threads(1)


class _ListReader:
    """A reader over given samples (the port's Sample type, which the JAX
    package's functions read by duck typing)."""

    def __init__(self, samples):
        self._samples = samples

    def samples(self):
        return self._samples


def _samples(shapes, seed):
    """Synthetic samples of the given (H, W) or (H, W, 3) shapes; an RGB one
    gets its scene in the green channel and unequal red and blue."""
    out = []
    for i, shape in enumerate(shapes):
        s = SyntheticMarkupReader(n_samples=1, image_hw=shape[:2], seed=seed + i).sample_at(0)
        if len(shape) == 3:
            g = s.image.astype(np.int32)
            s = pmarkup.Sample(s.image_path, s.objects,
                               np.stack([g // 2, g, 255 - g], -1).astype(np.uint8))
        out.append(s)
    return out


# XLA's CPU dot picks by shape between a fused multiply-add order and
# rounded products summed (the JAX package's own two collate routes
# differ: tests/test_data.py:336 holds them to 1e-4).  Where every product
# and sum is exact, any order gives the same bits: grid-aligned sources
# and resizes by dyadic ratios (here 3/4, 5/4, 5/8 and 3/2).
# Elsewhere (RGB luma, a 5/6 ratio) the images are held within 2**-21
# after the normalize (two f32 ulps of 255 before it, 3.05e-5, are 2.4e-7
# after it), ROADMAP.md §3 F3.
EXACT, ULPS = 0.0, 2.0 ** -21
COLLATE_CASES = {
    # name: (source shapes, train_hw, route, tolerance): "batched" = one
    # stacked copy and a batched resize, "per-sample" = a resize a sample
    "gray-identity": ([(64, 64)] * 3, (64, 64), "batched", EXACT),
    "gray-dyadic": ([(48, 80)] * 3, (64, 64), "batched", EXACT),
    "mixed-dyadic": ([(48, 60), (64, 72), (40, 36)], (64, 48), "per-sample", EXACT),
    "gray-5/6": ([(64, 40)] * 3, (64, 48), "batched", ULPS),
    "rgb": ([(40, 36, 3)] * 3, (64, 48), "batched", ULPS),
    "mixed-rgb-5/6": ([(48, 80), (64, 40), (40, 36, 3)], (64, 48), "per-sample", ULPS),
}


@pytest.mark.parametrize("case", sorted(COLLATE_CASES))
def test_batches_eval_match_jax(case, monkeypatch):
    """``Batches(train=False)`` against the JAX package's on the same
    samples, through the collate route the case names (a remainder batch
    of 1 included): images bit for bit where the resize is exact in any
    order, else within the case's tolerance; polys, n_verts, class_ids
    and segmap equal."""
    shapes, hw, route, atol = COLLATE_CASES[case]
    samples = _samples(shapes + shapes[:1], seed=11)
    dc = pdata.DataConfig(batch_size=3, train_hw=hw, max_polys=6, augment=None,
                          shuffle=False, drop_remainder=False)
    jdc = jdata.DataConfig(batch_size=3, train_hw=hw, max_polys=6, augment=None,
                           shuffle=False, drop_remainder=False)
    calls = {"batched": 0, "per-sample": 0}
    for name, kind in (("_batch_to_train_shape", "batched"), ("_to_train_shape", "per-sample")):
        def spy(*a, _f=getattr(pdata, name), _k=kind):
            calls[_k] += 1
            return _f(*a)
        monkeypatch.setattr(pdata, name, spy)
    got = list(pdata.Batches(_ListReader(samples), NetConfig(), dc, train=False, device="cpu"))
    want = list(jdata.Batches(_ListReader(samples), JaxNetConfig(), jdc, train=False).epoch(0))
    assert len(got) == len(want) == 2
    # the remainder batch of one sample takes the batched route
    assert calls == ({"batched": 2, "per-sample": 0} if route == "batched"
                     else {"batched": 1, "per-sample": 3})
    for g, w in zip(got, want):
        w = {k: np.array(v) for k, v in jax.device_get(w).items()}
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == torch.from_numpy(w[k]).dtype, k
            if k == "images":
                np.testing.assert_allclose(g[k].numpy(), w[k], rtol=0, atol=atol)
            else:
                np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)
    assert any((b["segmap"] > 0).any() for b in got)


def test_batches_len_and_drop_remainder():
    reader = SyntheticMarkupReader(n_samples=5, image_hw=(32, 32))
    for drop, n in ((True, 2), (False, 3)):
        dc = pdata.DataConfig(batch_size=2, train_hw=(32, 32), augment=None, drop_remainder=drop)
        b = pdata.Batches(reader, NetConfig(), dc, train=False, device="cpu")
        assert len(b) == n == len(list(b.epoch(0)))
        jb = jdata.Batches(JaxSyntheticMarkupReader(n_samples=5, image_hw=(32, 32)), JaxNetConfig(),
                           jdata.DataConfig(batch_size=2, train_hw=(32, 32), drop_remainder=drop),
                           train=False)
        assert len(jb) == n


def test_training_paths_raise_naming_item_10():
    """Training batches are served (tests/test_torch_augment.py), and so is
    the windowed rasterizer of the on-device synthesis: with
    ``raster_window`` set, the batches' segmaps equal the dense ones (the
    synthetic objects fit the window)."""
    reader = SyntheticMarkupReader(n_samples=2, image_hw=(32, 32))
    batch = next(iter(pdata.Batches(reader, NetConfig(), pdata.DataConfig(batch_size=2, train_hw=(32, 32)),
                                    train=True, device="cpu")))
    assert batch["images"].shape == (2, 32, 32, 1)
    dc = pdata.DataConfig(batch_size=2, train_hw=(32, 32), augment=None)
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(32, 32), seed=3)
    for wn in (4, 8, 16):
        win = dataclasses.replace(dc, raster_window=wn)
        for a, b in zip(pdata.Batches(reader, NetConfig(), win, train=False, device="cpu").epoch(0),
                        pdata.Batches(reader, NetConfig(), dc, train=False, device="cpu").epoch(0)):
            assert (a["segmap"] > 0).any()
            if wn >= 8:  # every object fits: 8 is the whole 8x8 grid
                assert torch.equal(a["segmap"], b["segmap"])
            assert all(torch.equal(a[k], b[k]) for k in ("images", "polys", "n_verts", "class_ids"))
    assert pdata.DataConfig() == pdata.DataConfig(augment=pdata.AugmentConfig())
    assert pdata.AugmentConfig().__dict__ == jdata.AugmentConfig().__dict__


def test_pad_polygons_warns_and_matches_jax():
    rng = np.random.default_rng(4)
    s = pmarkup.Sample("<memory>", [
        pmarkup.BarcodeObject(rng.uniform(0, 64, (n, 2)).astype(np.float32), t)
        for n, t in ((5, "QRCode"), (4, "EAN13"), (4, "Postnet"))])
    for cls in (True, False):
        cfg, jcfg = NetConfig(classification=cls), JaxNetConfig(classification=cls)
        with pytest.warns(UserWarning, match="DROPPED"):
            got = pdata.pad_polygons(s, cfg, 2, 3)
        with pytest.warns(UserWarning, match="DROPPED"):
            want = jdata.pad_polygons(s, jcfg, 2, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _pad(polys, V=16):
    P = len(polys)
    pad = np.zeros((P, V, 2), np.float32)
    nv = np.zeros(P, np.int32)
    for i, p in enumerate(polys):
        pad[i, : len(p)] = p
        nv[i] = len(p)
    return pad, nv


def _quads(seed):
    rng = np.random.default_rng(seed)
    polys = []
    for _ in range(3):
        cx, cy = rng.uniform(6, 26, 2)
        w, h = rng.uniform(3, 8, 2)
        ang = rng.uniform(0, np.pi)
        c, s = np.cos(ang), np.sin(ang)
        base = np.array([[-w, -h], [w, -h], [w, h], [-w, h]])
        polys.append((base @ np.array([[c, -s], [s, c]]) + [cx, cy]).round())
    return polys, [1, 2, 3], (32, 32)


RASTER_CASES = {  # tests/test_rasterize.py's cases
    "axis-aligned": ([[(2, 3), (10, 3), (10, 8), (2, 8)]], [1], (16, 16)),
    "triangle-overlap-order": ([[(1, 1), (12, 2), (6, 12)], [(4, 4), (14, 4), (14, 14), (4, 14)]],
                               [3, 7], (16, 16)),
    **{f"convex-quads-{s}": _quads(s) for s in range(4)},
    "degenerate": ([[(3, 3)], [(1, 1), (5, 5)]], [1, 2], (8, 8)),
}


@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_rasterize_polygons_matches_jax(case):
    polys, cids, hw = RASTER_CASES[case]
    pad, nv = _pad(polys)
    ci = np.asarray(cids, np.int32)
    want = np.asarray(jrast.rasterize_polygons(pad, nv, ci, hw))
    got = prast.rasterize_polygons(torch.from_numpy(pad)[None], torch.from_numpy(nv)[None],
                                   torch.from_numpy(ci)[None], hw)[0]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "degenerate":
        assert want.sum() == 0


@pytest.mark.parametrize("integer", [True, False])
def test_rasterize_random_polygons_batch_matches_jax(integer):
    """Random polygons of up to 8 vertices (self-intersecting, out of frame,
    n_verts 0..8) in a batch of 3, integer or fractional vertices, against
    the vmapped JAX rasterizer; the row chunking is forced small."""
    rng = np.random.default_rng(5 + integer)
    polys = rng.uniform(-3, 40, (3, 6, 8, 2)).astype(np.float32)
    if integer:
        polys = np.round(polys)
    nv = rng.integers(0, 9, (3, 6)).astype(np.int32)
    ci = rng.integers(1, 17, (3, 6)).astype(np.int32)
    hw = (29, 37)
    want = np.asarray(jax.vmap(lambda p, n, c: jrast.rasterize_polygons(p, n, c, hw))(
        jnp.asarray(polys), jnp.asarray(nv), jnp.asarray(ci)))
    args = [torch.from_numpy(a) for a in (polys, nv, ci)]
    np.testing.assert_array_equal(prast.rasterize_polygons(*args, hw).numpy(), want)
    chunk, prast._CHUNK_ELEMENTS = prast._CHUNK_ELEMENTS, 3 * 6 * 8 * 37 * 4
    try:
        np.testing.assert_array_equal(prast.rasterize_polygons(*args, hw).numpy(), want)
    finally:
        prast._CHUNK_ELEMENTS = chunk
    grid = np.array([[[10.0, 14.0], [22.0, 6.0], [6.0, 2.0], [-2.0, 9.0]]], np.float32)
    np.testing.assert_array_equal(prast.polygons_to_grid(torch.from_numpy(grid), 4).numpy(),
                                  np.asarray(jrast.polygons_to_grid(grid, 4)))


def _write_dataset(root, cv2):
    rng = np.random.default_rng(3)
    names = ["b.png", "a.png", "sub/c.png"]
    (root / "sub").mkdir()
    markup = {}
    for i, name in enumerate(names):
        img = rng.integers(0, 256, (20 + i, 24, 3) if i == 1 else (20 + i, 24)).astype(np.uint8)
        cv2.imwrite(str(root / name), img)
        objs = [{"type": t, "points": rng.uniform(0, 20, (k, 2)).round(2).tolist()}
                for t, k in (("QRCode", 4), ("EAN13", 3))[: 1 + i % 2]]
        markup[name] = objs
        pts = "".join(f'<point x="{x}" y="{y}"/>' for x, y in objs[0]["points"])
        (root / name).with_suffix(".xml").write_text(
            f'<image name="{name.split("/")[-1]}"><barcode type="{objs[0]["type"]}">{pts}'
            "</barcode></image>")
    return markup


@pytest.mark.parametrize("fmt", ["zvz-json", "zvz-xml"])
def test_markup_readers_match_jax(fmt, tmp_path):
    """The JSON and XML readers on files written with cv2: the same samples
    (paths, polygons, types) as the JAX package's readers, and load_image
    the same pixels (BGR -> RGB)."""
    cv2 = pytest.importorskip("cv2")
    markup = _write_dataset(tmp_path, cv2)
    if fmt == "zvz-json":
        pmarkup.write_json_markup(tmp_path, markup)
        assert json.loads((tmp_path / "markup.json").read_text()) == markup
    got = pmarkup.get_markup_reader(fmt, tmp_path).samples()
    want = jmarkup.get_markup_reader(fmt, tmp_path).samples()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.image_path == w.image_path and g.types == w.types
        for a, b in zip(g.polygons, w.polygons):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pdata.load_image(g), jdata.load_image(w))
    with pytest.raises(FileNotFoundError):
        pdata.load_image(pmarkup.Sample(str(tmp_path / "missing.png"), []))


def test_reader_registry():
    r = pmarkup.get_markup_reader("synthetic", None, n_samples=2, image_hw=(32, 48))
    assert isinstance(r, SyntheticMarkupReader) and len(r) == 2
    np.testing.assert_array_equal(
        r.samples()[1].image,
        JaxSyntheticMarkupReader(n_samples=2, image_hw=(32, 48)).samples()[1].image)
    with pytest.raises(ValueError, match="unknown markup format"):
        pmarkup.get_markup_reader("nope", ".")

    class One(pmarkup.MarkupReader):
        def __init__(self, root):
            self.root = root

        def samples(self):
            return [pmarkup.Sample(str(self.root), [])]

    pmarkup.register_reader("one", One)
    try:
        assert len(pmarkup.get_markup_reader("one", "x")) == 1
    finally:
        del pmarkup._READERS["one"]


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetched_order(depth):
    assert list(prefetched(iter(range(20)), depth=depth)) == list(range(20))
    assert list(prefetched([], depth=depth)) == []


def test_prefetched_reraises_where_consumed():
    """The worker runs ``depth`` items ahead of the consumer (one more is
    built and waits to be queued), and the source's exception is raised
    after the items before it, where the next item would be consumed."""
    seen = []

    def source():
        for i in range(5):
            seen.append(i)
            yield i
        raise KeyError("boom")

    it = prefetched(source(), depth=2)
    assert next(it) == 0
    for _ in range(500):
        if len(seen) >= 4:
            break
        threading.Event().wait(0.01)
    threading.Event().wait(0.05)
    assert seen == [0, 1, 2, 3]
    got = []
    with pytest.raises(KeyError, match="boom"):
        for x in it:
            got.append(x)
    assert got == [1, 2, 3, 4]
    workers = [t for t in threading.enumerate() if t.name == "batch-prefetch"]
    assert all(t.daemon for t in workers)

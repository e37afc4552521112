"""PyTorch port: object-level evaluation (``evaluate.py``) on the CPU, held
against the JAX package on the same inputs.

Tolerances: none.  The matcher and the report are the JAX package's numpy
code; ``run_evaluation`` in both packages on the CPU gives equal reports
(every count identical, F1 and the per-class figures exact), in resized
and native mode, f32 and int8 (the JAX package's qparams carried over by
``qparams_from_numpy``).
"""

import dataclasses
import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model import ASSETS, load_params

from ubdvss_tpu import evaluate as jeval
from ubdvss_tpu.data import Batches as JaxBatches
from ubdvss_tpu.data import DataConfig as JaxDataConfig
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.net_config import DEFAULT_CLASS_NAMES
from ubdvss_tpu.ops import quant as jq
from ubdvss_tpu.synthetic import SyntheticMarkupReader as JaxSyntheticMarkupReader
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import evaluate as peval
from ubdvss_tpu_torch import load_net_config, qparams_from_numpy
from ubdvss_tpu_torch.data import DataConfig
from ubdvss_tpu_torch.ops.quant import quantize_trunk
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)


def _box(x, y, w, h):
    return np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]], float)


def _rotated(rng, n):
    out = []
    for _ in range(n):
        cx, cy = rng.uniform(10, 90, 2)
        w, h = rng.uniform(4, 20, 2)
        a = rng.uniform(0, np.pi)
        c, s = np.cos(a), np.sin(a)
        out.append(np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
                   @ np.array([[c, -s], [s, c]]) + [cx, cy])
    return np.stack(out) if out else np.zeros((0, 4, 2))


def _random_images(seed):
    """Images whose predictions are jittered copies of their GT (and
    strays), so that matches, near misses and misses all occur."""
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(6):
        gt = _rotated(rng, int(rng.integers(0, 5)))
        keep = gt[rng.random(len(gt)) < 0.8]
        pred = np.concatenate([keep + rng.normal(0, 2, keep.shape), _rotated(rng, int(rng.integers(0, 3)))])
        recs.append(dict(
            pred_boxes=pred, pred_scores=rng.random(len(pred)).astype(np.float32),
            pred_classes=rng.integers(0, 16, len(pred)),
            gt_polys=list(gt), gt_classes=[int(c) for c in rng.integers(0, 16, len(gt))]))
    return recs


def _one(pred, scores, classes, gts, gt_classes):
    return dict(pred_boxes=np.stack(pred) if pred else np.zeros((0, 4, 2)),
                pred_scores=np.asarray(scores), pred_classes=np.asarray(classes),
                gt_polys=gts, gt_classes=gt_classes)


_N = DEFAULT_CLASS_NAMES
MATCH_CASES = {  # tests/test_evaluate.py:13-106, then seeded random images
    "simple-tp-fp-fn": [_one([_box(1, 1, 10, 10), _box(100, 100, 5, 5)], [0.9, 0.8], [1, 0],
                             [_box(0, 0, 10, 10), _box(50, 50, 10, 10)], [1, 2])],
    "greedy-score-order": [_one([_box(0, 0, 10, 10), _box(1, 1, 10, 10)], [0.5, 0.9], [0, 0],
                                [_box(0, 0, 10, 10)], [0])],
    "iou-threshold": [_one([_box(8, 8, 10, 10)], [1.0], [0], [_box(0, 0, 10, 10)], [0])],
    "aggregation": [_one([_box(0, 0, 10, 10)], [0.9], [3], [_box(0, 0, 10, 10)], [3]),
                    _one([], [], np.zeros(0, int), [_box(5, 5, 4, 4)], [1])],
    "per-class-and-group": [
        _one([_box(0, 0, 10, 10), _box(40, 40, 10, 10)], [0.9, 0.8],
             [_N.index("QRCode")] * 2, [_box(0, 0, 10, 10), _box(40, 40, 10, 10)],
             [_N.index("QRCode"), _N.index("EAN13")]),
        _one([_box(80, 80, 5, 5)], [0.7], [_N.index("EAN13")], [_box(0, 0, 10, 10)],
             [_N.index("Aztec")])],
    **{f"random-{s}": _random_images(s) for s in range(3)},
}


@pytest.mark.parametrize("names", [None, _N], ids=["detection-only", "classes"])
@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_matcher_and_report_match_jax(case, names):
    """match_image(_detailed) per image and evaluate_detections over the
    images: equal to the JAX package's (the same EvalResult, field for
    field)."""
    recs = MATCH_CASES[case]
    for r in recs:
        args = (r["pred_boxes"], r["pred_scores"], r["pred_classes"], r["gt_polys"], r["gt_classes"])
        assert peval.match_image_detailed(*args) == jeval.match_image_detailed(*args)
        assert peval.match_image(*args, iou_threshold=0.3) == jeval.match_image(*args, iou_threshold=0.3)
    got = peval.evaluate_detections(recs, class_names=names)
    want = jeval.evaluate_detections(recs, class_names=names)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    if case.startswith("random"):
        assert 0 < got.tp < got.n_pred and got.fn > 0


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX cfg, JAX params, port cfg, port params) of the separable asset."""
    path = ASSETS["separable"]
    jcfg = jax_load_net_config(path)
    return jcfg, jax_load_params_npz(path, init_params(jcfg, 0)), load_net_config(path), load_params(path)


def _readers(n, hw, seed=0):
    return (SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed),
            JaxSyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed))


@functools.lru_cache(maxsize=None)
def _jax_qparams():
    """The JAX package's qparams by its CLI's protocol (the first 8 images
    of the eval pipeline), as host arrays."""
    jcfg, jparams, _, _ = _models()
    _, jreader = _readers(10, (128, 128))
    jdc = JaxDataConfig(batch_size=4, train_hw=(128, 128), max_polys=32, augment=None,
                        shuffle=False, drop_remainder=False)
    cal = np.concatenate([np.asarray(b["images"]) for b in JaxBatches(jreader, jcfg, jdc, train=False).epoch(0)])
    return jax.tree.map(np.asarray, jq.quantize_trunk(jparams, jcfg, jnp.asarray(cal[:8])))


def _fed(mod, run):
    """``run()`` with ``mod.detect_preprocessed_batch`` spied on: its result
    and the image batches fed to the model, as numpy arrays."""
    fed = []
    orig = mod.detect_preprocessed_batch

    def spy(params_, x, cfg_, **kw):
        fed.append(np.array(x))
        return orig(params_, x, cfg_, **kw)

    with mock.patch.object(mod, "detect_preprocessed_batch", spy):
        return run(), fed


def _assert_same_feed(got, want):
    """The batches fed to the model are the JAX package's, bit for bit."""
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_run_evaluation_resized_matches_jax(mode):
    """10 synthetic 128² scenes at batch 4 (a remainder of 2) on the asset:
    the batches fed to the model bit for bit (normalized with one
    rounding) and both packages' reports equal; the prefetch thread
    changes nothing."""
    jcfg, jparams, cfg, params = _models()
    reader, jreader = _readers(10, (128, 128))
    q = _jax_qparams() if mode == "int8" else None
    want, want_fed = _fed(jeval, lambda: jeval.run_evaluation(jparams, jreader, jcfg, JaxDataConfig(
        batch_size=4, train_hw=(128, 128), max_polys=32), qparams=q))
    dc = DataConfig(batch_size=4, train_hw=(128, 128), max_polys=32)
    pq = None if q is None else qparams_from_numpy(q)
    got, got_fed = _fed(peval, lambda: peval.run_evaluation(params, reader, cfg, dc, qparams=pq,
                                                            device="cpu"))
    _assert_same_feed(got_fed, want_fed)
    assert got.to_json() == want.to_json()
    assert got.n_images == 10 and got.tp > 0 and got.per_class
    sync = peval.run_evaluation(params, reader, cfg, dc, qparams=pq, prefetch_depth=0, device="cpu")
    assert sync == got


class _Both:
    """Two source sizes: 5 scenes of 64x64 and 3 of 48x64."""

    def __init__(self, cls):
        self.parts = [cls(n_samples=5, image_hw=(64, 64), seed=2), cls(n_samples=3, image_hw=(48, 64), seed=3)]

    def samples(self):
        return [s for r in self.parts for s in r.samples()]


def test_run_evaluation_native_matches_jax():
    """Native mode on two source sizes (two grids) at batch 4: both buckets
    flush a padded remainder (1 and 3 images), every dispatched batch has 4
    images, bit for bit the JAX package's (normalized with two roundings,
    as JAX computes it eagerly there), the report equals the JAX
    package's, and equals the port's own batch-1 run (which pads
    nothing)."""
    jcfg, jparams, cfg, params = _models()
    jcfg, cfg = (c.replace(max_image_side=64) for c in (jcfg, cfg))
    want, want_fed = _fed(jeval, lambda: jeval.run_evaluation(
        jparams, _Both(JaxSyntheticMarkupReader), jcfg,
        JaxDataConfig(batch_size=4, train_hw=(64, 64)), native=True))
    got, got_fed = _fed(peval, lambda: peval.run_evaluation(
        params, _Both(SyntheticMarkupReader), cfg, DataConfig(batch_size=4, train_hw=(64, 64)),
        native=True, device="cpu"))
    assert sorted(g.shape for g in got_fed) == [(4, 48, 64, 1), (4, 64, 64, 1), (4, 64, 64, 1)]
    _assert_same_feed(got_fed, want_fed)
    assert got.to_json() == want.to_json()
    assert got.n_images == 8 and got.n_gt >= 8 and got.tp > 0
    one = peval.run_evaluation(params, _Both(SyntheticMarkupReader), cfg,
                               DataConfig(batch_size=1, train_hw=(64, 64)), native=True, device="cpu")
    assert one == got


def test_run_evaluation_int8_native_matches_jax():
    """The int8 trunk in native mode (the normalize rounded twice, as the
    JAX package computes it eagerly there) on the JAX package's qparams."""
    jcfg, jparams, cfg, params = _models()
    jcfg, cfg = (c.replace(max_image_side=64) for c in (jcfg, cfg))
    q = _jax_qparams()
    want = jeval.run_evaluation(jparams, _Both(JaxSyntheticMarkupReader), jcfg,
                                JaxDataConfig(batch_size=4, train_hw=(64, 64)), native=True, qparams=q)
    got = peval.run_evaluation(params, _Both(SyntheticMarkupReader), cfg,
                               DataConfig(batch_size=4, train_hw=(64, 64)), native=True,
                               qparams=qparams_from_numpy(q), device="cpu")
    assert got.to_json() == want.to_json() and got.tp > 0


def test_entry_points_default_to_the_card():
    """run_evaluation, Batches and the CLI run on the card unless asked for
    the CPU: without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only refusal cannot show")
    _, _, cfg, params = _models()
    reader, _ = _readers(2, (64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.run_evaluation(params, reader, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.Batches(reader, cfg, DataConfig(augment=None), train=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        peval.main(["--data", "synthetic", "--checkpoint", str(ASSETS["separable"]),
                    "--synthetic-samples", "2"])


def test_run_evaluation_mesh_raises_naming_item_9():
    """run_evaluation(mesh=) is served (tests/test_torch_parallel.py); a
    mesh that does not divide the batch size (8 over 3 entries) raises
    before anything runs, and so does an object that is no mesh."""
    from ubdvss_tpu_torch.parallel import make_mesh

    _, _, cfg, params = _models()
    reader, _ = _readers(2, (64, 64))
    with pytest.raises(ValueError, match="divisible"):
        peval.run_evaluation(params, reader, cfg, mesh=make_mesh(3, devices=["cpu"] * 3), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        peval.run_evaluation(params, reader, cfg, mesh=object(), device="cpu")


@pytest.mark.parametrize("native", [False, True], ids=["resized", "native"])
def test_cli_report_matches_jax(native, tmp_path, capsys):
    """``main`` on a synthetic dataset writes the report the JAX CLI writes
    on the same arguments (and prints it)."""
    args = ["--data", "synthetic", "--checkpoint", str(ASSETS["separable"]),
            "--synthetic-samples", "6", "--image-size", "64", "64", "--batch-size", "4"]
    if native:
        args.append("--eval-native")
    want = jeval.main(args + ["--report", str(tmp_path / "jax.json")])
    got = peval.main(args + ["--report", str(tmp_path / "port.json"), "--device", "cpu"])
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert got.to_json() == want.to_json() and got.tp > 0
    assert got.to_json() in capsys.readouterr().out


def test_cli_int8_calibrates_on_the_eval_images(tmp_path):
    """``--int8`` calibrates ``quantize_trunk`` on the first ``--int8-calib``
    images of the eval pipeline, then evaluates the int8 trunk: the same
    report as run_evaluation on those qparams."""
    _, _, cfg, params = _models()
    got = peval.main(["--data", "synthetic", "--checkpoint", str(ASSETS["separable"]),
                      "--synthetic-samples", "6", "--image-size", "64", "64", "--batch-size", "4",
                      "--int8", "--int8-calib", "5", "--device", "cpu"])
    reader, _ = _readers(6, (64, 64))
    dc = DataConfig(batch_size=4, train_hw=(64, 64), max_polys=32)
    cal = torch.cat([b["images"] for b in peval.Batches(
        reader, cfg, dataclasses.replace(dc, augment=None, shuffle=False), train=False, device="cpu")])
    want = peval.run_evaluation(params, reader, cfg, dc, qparams=quantize_trunk(params, cfg, cal[:5]),
                                device="cpu")
    assert got == want and got.n_images == 6


def test_cli_refusals(tmp_path):
    base = ["--data", "synthetic", "--synthetic-samples", "2", "--device", "cpu"]
    # --num-devices past the cards without --allow-cpu-mesh (served with it:
    # tests/test_torch_parallel.py)
    with pytest.raises(ValueError, match="allow-cpu-mesh"):
        peval.main(base + ["--checkpoint", str(ASSETS["separable"]),
                           "--num-devices", str(torch.cuda.device_count() + 2)])
    # a log directory without checkpoints, and one of the JAX package's orbax
    # checkpoints (tests/test_torch_train.py serves the port's own)
    with pytest.raises(FileNotFoundError, match="no training checkpoint"):
        peval.main(base + ["--checkpoint", str(tmp_path)])
    (tmp_path / "checkpoints" / "12" / "default").mkdir(parents=True)
    with pytest.raises(ValueError, match="--export-npz"):
        peval.main(base + ["--checkpoint", str(tmp_path)])
    assert json.loads(peval.EvalResult(1, 1, 1, 1, 1, 1, 1, 1, 0, 0).to_json())["per_class"] is None

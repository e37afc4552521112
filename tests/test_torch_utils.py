"""PyTorch port: the host utilities (``utils/geometry.py``,
``utils/visualization.py``, ``utils/keras_import.py``,
``utils/logging_util.py``, ``utils/profiling.py``) and the detect CLI's
Keras weights and overlays, on the CPU, held against the JAX package.

Tolerances: none for the numpy code (geometry, drawing, the metric
records apart from their wall-clock field); logits of Keras weights within
max(1e-5, 1e-6·max|logit|), the bound of ``tests/test_torch_model.py``
(convolutions summed in another order than XLA's); the detect CLI's
reports as ``tests/test_torch_int8.py``'s CLI test holds them (the same
detections and classes, scores within 1e-4, boxes within 1e-3 px).
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from test_torch_model import ASSETS

from ubdvss_tpu import detect as jax_detect
from ubdvss_tpu.models.model import get_model as jax_get_model
from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.utils import geometry as jgeo
from ubdvss_tpu.utils import logging_util as jlog
from ubdvss_tpu.utils import visualization as jvis
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import detect as port_detect
from ubdvss_tpu_torch import load_net_config, params_from_flat
from ubdvss_tpu_torch.models.model import exact_f32, get_model
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.utils import geometry as pgeo
from ubdvss_tpu_torch.utils import logging_util as plog
from ubdvss_tpu_torch.utils import profiling
from ubdvss_tpu_torch.utils import visualization as pvis

torch.set_num_threads(1)


def _quad(rng):
    cx, cy = rng.uniform(0, 30, 2)
    w, h = rng.uniform(1, 12, 2)
    a = rng.uniform(0, np.pi)
    c, s = np.cos(a), np.sin(a)
    return np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2 @ np.array([[c, -s], [s, c]]) + [cx, cy]


@pytest.mark.parametrize("seed", range(4))
def test_geometry_matches_jax(seed):
    """iou, polygon_area, clip_polygon and the intersection area of random
    convex quads (overlapping, nested, disjoint, one vertex order reversed)
    equal the JAX package's exactly."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        a, b = _quad(rng), _quad(rng)
        if rng.random() < 0.3:
            b = b[::-1]
        assert pgeo.iou(a, b) == jgeo.iou(a, b)
        assert pgeo.polygon_area(a) == jgeo.polygon_area(a)
        assert pgeo.polygon_intersection_area(a, b) == jgeo.polygon_intersection_area(a, b)
        np.testing.assert_array_equal(pgeo.clip_polygon(a, b), jgeo.clip_polygon(a, b))
    assert pgeo.polygon_area(np.zeros((2, 2))) == 0.0


@pytest.mark.parametrize("kind", ["gray", "rgb", "float-hw1"])
def test_visualization_matches_jax(kind):
    """draw_detections (boxes and GT polygons, clipped at the border),
    heatmap_overlay and detection_summary_image give the JAX package's
    arrays."""
    rng = np.random.default_rng(len(kind))
    img = {"gray": rng.integers(0, 256, (40, 52)).astype(np.uint8),
           "rgb": rng.integers(0, 256, (40, 52, 3)).astype(np.uint8),
           "float-hw1": rng.uniform(-20, 300, (40, 52, 1))}[kind]
    boxes = np.stack([_quad(rng) * 1.8 for _ in range(4)])
    gts = [_quad(rng) * 1.5 for _ in range(2)]
    np.testing.assert_array_equal(pvis.draw_detections(img, boxes, gt_polygons=gts),
                                  jvis.draw_detections(img, boxes, gt_polygons=gts))
    np.testing.assert_array_equal(pvis.draw_detections(img, []), jvis.draw_detections(img, []))
    hm = rng.random((10, 13)).astype(np.float32)
    np.testing.assert_array_equal(pvis.heatmap_overlay(img, hm, 0.4), jvis.heatmap_overlay(img, hm, 0.4))
    res = {"valid": np.array([True, False, True, True]), "boxes": boxes / 4}
    np.testing.assert_array_equal(pvis.detection_summary_image(img, res, gts, 4.0),
                                  jvis.detection_summary_image(img, res, gts, 4.0))


@pytest.mark.parametrize("asset", ["separable", "dense"])
def test_keras_weights_match_jax(asset, tmp_path):
    """An asset's weights put into ``build_keras_model`` and saved as an h5
    file: the port's ``load_keras_weights`` gives the state_dict
    ``params_from_flat`` gives of the JAX package's loaded params, bit for
    bit, and its logits match the JAX model's from the same file."""
    pytest.importorskip("keras")
    from oracle.keras_model import copy_flax_params_to_keras

    from ubdvss_tpu.utils import keras_import as jki
    from ubdvss_tpu_torch.utils import keras_import as pki

    jcfg = jax_load_net_config(ASSETS[asset])
    cfg = load_net_config(ASSETS[asset])
    km = pki.build_keras_model(cfg, (32, 32))
    jkm = jki.build_keras_model(jcfg, (32, 32))
    assert [(w.path, w.shape) for w in km.weights] == [(w.path, w.shape) for w in jkm.weights]
    copy_flax_params_to_keras(jax_load_params_npz(ASSETS[asset], init_params(jcfg, 0)), km, jcfg)
    path = str(tmp_path / "ref.weights.h5")
    km.save_weights(path)
    got = pki.load_keras_weights(path, cfg)
    jparams = jki.load_keras_weights(path, jcfg)
    want = params_from_flat(flatten_dict(jax.device_get(jparams), sep="/"))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = np.random.default_rng(0).normal(0, 1, (2, 32, 48, 1)).astype(np.float32)
    ref = np.asarray(jax_get_model(jcfg).apply({"params": jparams}, x))
    model = get_model(cfg)
    model.load_state_dict(got)
    with torch.no_grad(), exact_f32():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=max(1e-5, 1e-6 * float(np.abs(ref).max())))


def _compare_reports(got, want):
    assert set(got) == set(want) and sum(map(len, want.values())) > 0
    for path in want:
        assert [d["class"] for d in got[path]] == [d["class"] for d in want[path]]
        for o, r in zip(got[path], want[path]):
            assert abs(o["score"] - r["score"]) <= 1e-4
            np.testing.assert_allclose(o["box"], r["box"], atol=1e-3)


def test_detect_cli_keras_weights_and_overlays(tmp_path):
    """The port's detect CLI on an h5 file (its config from the
    ``net_config.json`` beside it) with ``--save-overlays``, against the JAX
    CLI on the same arguments: the same detections, one overlay a scene,
    each the port's boxes drawn on the scene."""
    cv2 = pytest.importorskip("cv2")
    pytest.importorskip("keras")
    from oracle.keras_model import copy_flax_params_to_keras

    from ubdvss_tpu_torch.utils.keras_import import build_keras_model

    jcfg = jax_load_net_config(ASSETS["separable"])
    km = build_keras_model(load_net_config(ASSETS["separable"]))
    copy_flax_params_to_keras(jax_load_params_npz(ASSETS["separable"], init_params(jcfg, 0)), km, jcfg)
    wdir = tmp_path / "weights"
    wdir.mkdir()
    km.save_weights(str(wdir / "ref.weights.h5"))
    shutil.copy(ASSETS["separable"].with_suffix(".net_config.json"), wdir / "net_config.json")
    imdir = tmp_path / "images"
    imdir.mkdir()
    reader = SyntheticMarkupReader(n_samples=2, image_hw=(128, 160), seed=3)
    for i in range(2):
        cv2.imwrite(str(imdir / f"im{i}.png"), reader.sample_at(i).image)
    args = ["--images", str(imdir), "--checkpoint", str(wdir / "ref.weights.h5")]
    want = jax_detect.main(args + ["--save-overlays", str(tmp_path / "jax_ov")])
    got = port_detect.main(args + ["--save-overlays", str(tmp_path / "ov"), "--device", "cpu",
                                   "--output", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(json.dumps(got))
    _compare_reports(got, want)
    assert sorted(p.name for p in (tmp_path / "ov").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax_ov").iterdir()) == ["im0.png", "im1.png"]
    for i in range(2):
        path = str(imdir / f"im{i}.png")
        boxes = np.array([d["box"] for d in got[path]])
        drawn = pvis.draw_detections(reader.sample_at(i).image, boxes)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "ov" / f"im{i}.png"))[..., ::-1], drawn)


def test_metric_logger_matches_jax(tmp_path, capsys):
    """The same JSONL records as the JAX package's MetricLogger apart from
    ``wall_s``, and the same stderr lines."""
    got, want = plog.MetricLogger(str(tmp_path / "port")), jlog.MetricLogger(str(tmp_path / "jax"))
    steps = [(1, {"loss": 0.5, "f1": np.float32(0.25)}, "train"), (2, {"loss": torch.tensor(1.5)}, "val")]
    lines = []
    for logger in (got, want):
        for step, metrics, prefix in steps:
            logger.log(step, metrics, prefix=prefix)
        logger.log_image(3, "overlay", np.zeros((8, 8, 3), np.uint8))
        logger.close()
        lines.append(capsys.readouterr().err)
    assert lines[0] == lines[1] and lines[0].count("\n") == 2

    def records(d):
        recs = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
        for r in recs:
            assert r.pop("wall_s") >= 0
        return recs

    assert records(tmp_path / "port") == records(tmp_path / "jax")
    plog.MetricLogger(None).log(0, {"x": 1.0})  # no logdir: stderr only
    assert "[train] step 0: x=1.0000" in capsys.readouterr().err


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("eval_stage"):
            torch.ones(8).add_(1)
    (trace_file,) = (tmp_path / "tr").iterdir()
    events = json.loads(trace_file.read_text())["traceEvents"]
    assert any(e.get("name") == "eval_stage" for e in events)
    with profiling.trace(None):
        pass
    with pytest.raises(NotImplementedError, match="no on-demand"):
        profiling.start_server()


def test_jax_config_defaults_match():
    """The net config the CLIs fall back to without a sidecar is the same
    in both packages (the Keras model is built from it)."""
    assert json.loads(JaxNetConfig().to_json()) == json.loads(port_detect.NetConfig().to_json())

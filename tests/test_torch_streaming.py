"""PyTorch port: ``StreamingDetector`` on the CPU held against the JAX
package's ``StreamingDetector`` (its XLA route on the CPU) on the same
frames.  Per frame, the rules of ``assert_same_detections``: masks, areas,
classes and counts identical, scores and class probabilities within 1e-5,
boxes within 1e-4 as corner sets (test_torch_rect's module docstring)."""

import jax
import numpy as np
import pytest
import torch
from test_torch_model import ASSETS, load_params
from test_torch_postproc import assert_same_detections

from ubdvss_tpu.models.model import init_params
from ubdvss_tpu.streaming import StreamingDetector as JaxStreamingDetector
from ubdvss_tpu.utils.checkpoint import load_net_config as jax_load_net_config
from ubdvss_tpu.utils.checkpoint import load_params_npz as jax_load_params_npz
from ubdvss_tpu_torch import StreamingDetector, load_net_config
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

torch.set_num_threads(1)

FRAME_HW = (120, 160)


@pytest.fixture(scope="module")
def detectors():
    """The port's and the JAX stream over the separable asset, K=16, its
    max_hull_points=64 >= the 30-row heatmap (the uncompacted rect route)."""
    path = ASSETS["separable"]
    jcfg = jax_load_net_config(path).replace(max_components=16)
    jparams = jax_load_params_npz(path, init_params(jcfg, 0))
    cfg = load_net_config(path).replace(max_components=16)
    port = StreamingDetector(cfg, load_params(path), FRAME_HW, batch_size=4, device="cpu")
    ref = JaxStreamingDetector(jcfg, jparams, FRAME_HW, batch_size=4)
    return port, ref


def test_stream_matches_jax(detectors):
    """10 frames, batch 4: two full batches and a padded tail."""
    port, ref = detectors
    reader = SyntheticMarkupReader(n_samples=10, image_hw=FRAME_HW, seed=13)
    frames = [reader.sample_at(i).image for i in range(10)]
    out = list(port.process(iter(frames)))
    exp = jax.device_get(list(ref.process(iter(frames))))
    assert [i for i, _ in out] == [i for i, _ in exp] == list(range(10))
    assert sum(int(d["num_detections"]) for _, d in exp) > 0
    for (_, o), (_, r) in zip(out, exp):
        assert sorted(o) == sorted(r)
        assert all(isinstance(v, (np.ndarray, np.generic)) for v in o.values())
        assert_same_detections({k: torch.from_numpy(np.asarray(v)) for k, v in o.items()},
                               r, score_atol=1e-5)


def test_stream_empty_and_short(detectors):
    """No frames yield nothing; fewer frames than one batch yield each
    frame once, in order."""
    port, ref = detectors
    assert list(port.process(iter([]))) == []
    frames = [np.zeros(FRAME_HW, np.uint8) for _ in range(2)]
    out = list(port.process(iter(frames)))
    exp = list(ref.process(iter(frames)))
    assert [i for i, _ in out] == [i for i, _ in exp] == [0, 1]
    for (_, o), (_, r) in zip(out, exp):
        assert int(o["num_detections"]) == int(r["num_detections"])


def test_stream_routes_not_ported_raise():
    """A mesh is served (tests/test_torch_parallel.py); one that does not
    divide the batch size, or an object that is no mesh, raises, with or
    without int8 qparams."""
    from ubdvss_tpu_torch.parallel import make_mesh

    cfg = load_net_config(ASSETS["separable"])
    params = load_params(ASSETS["separable"])
    three = make_mesh(3, devices=["cpu"] * 3)
    for kw, exc, match in ((dict(qparams={}, mesh=three), ValueError, "divisible"),
                           (dict(mesh=object()), TypeError, "Mesh")):
        with pytest.raises(exc, match=match):
            StreamingDetector(cfg, params, FRAME_HW, device="cpu", **kw)
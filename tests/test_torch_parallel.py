"""PyTorch port: the mesh layer (``parallel/mesh.py``), the row-tiled scan
and distributed CCL (``parallel/tiling.py``), data-parallel serving,
streaming and evaluation, and ``setup_devices``, on the CPU.

The port's meshes repeat the one CPU device (``devices=["cpu"] * n``);
JAX's run on tests/conftest.py's 8 virtual CPU devices.  Tolerances:
distributed CCL labels identical and the convergence flag equal to JAX's;
``tiled_detect`` against JAX's: logits within max(1e-5, 1e-6·max|logit|)
(test_torch_model's FCN bound), ints identical, boxes within 1e-4 as
corner sets; against the port's own ``detect_program``
(JAX's tests/test_parallel.py bounds): logits within 1e-4, ``valid``,
``areas`` and counts identical, boxes within 1e-3 as corner sets; DP
serving bit for bit equal to per-shard calls, and against JAX's
``detect_program_batch(mesh=)`` at the serving tests' tolerances (f32:
logits 1e-4, scores 1e-5; bf16: test_torch_bf16's; int8: logits bit for
bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import FCN_ULPS, _jax_bf16, _port_bf16, _ulps, assert_bf16_detections
from test_torch_int8 import _jax_qparams, _models
from test_torch_model import ASSETS, load_params
from test_torch_postproc import assert_same_detections
from test_torch_rect import same_corner_sets

from ubdvss_tpu.inference import detect_program_batch as jax_detect_program_batch
from ubdvss_tpu.ops.ccl import connected_components as jax_connected_components
from ubdvss_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ubdvss_tpu.parallel.tiling import distributed_connected_components as jax_dccl
from ubdvss_tpu.parallel.tiling import tiled_detect as jax_tiled_detect
from ubdvss_tpu_torch import StreamingDetector, detect_preprocessed_batch, detect_program, detect_program_batch
from ubdvss_tpu_torch import load_net_config
from ubdvss_tpu_torch import evaluate as peval
from ubdvss_tpu_torch.data import DataConfig
from ubdvss_tpu_torch.parallel import make_mesh, replicate_to_mesh, shard_batch_to_mesh
from ubdvss_tpu_torch.parallel.mesh import replicated
from ubdvss_tpu_torch.parallel.tiling import distributed_connected_components, receptive_field_halo, tiled_detect
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.train import setup_devices

torch.set_num_threads(1)


def cpu_mesh(n, axis="data"):
    return make_mesh(n, axis=axis, devices=["cpu"] * n)


def jax_cpu_mesh(n, axis):
    return jax_make_mesh(n, axis=axis, devices=jax.devices("cpu"))


def _scenes(n, hw, seed):
    reader = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed)
    return np.stack([reader.sample_at(i).image for i in range(n)])


def test_mesh_helpers():
    """Shapes and axes, repeated devices, one replica a distinct device,
    shards of the leading dim, and the errors: a batch that does not
    divide, more entries than devices, no card without devices=."""
    mesh = cpu_mesh(4)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 4} and mesh.size == 4
    assert mesh.devices.shape == (4,) and mesh.devices.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert replicated(mesh) == [torch.device("cpu")]
    grid = make_mesh(axis=("data", "model"), devices=["cpu"] * 4, shape=(2, 2))
    assert grid.shape == {"data": 2, "model": 2} and len(grid.axis_devices("model")) == 2
    w = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    reps = replicate_to_mesh(w, mesh)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    batch = {"x": torch.arange(8).reshape(8, 1), "y": np.arange(8), "s": torch.tensor(3)}
    shards = shard_batch_to_mesh(batch, mesh)
    assert [s["x"][:, 0].tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert shards[3]["y"].tolist() == [6, 7] and int(shards[2]["s"]) == 3
    with pytest.raises(ValueError, match="divisible"):
        shard_batch_to_mesh(torch.zeros(6, 2), mesh)
    with pytest.raises(ValueError, match="entries"):
        make_mesh(5, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2, devices=["cuda:0"] * 2)


def _ccl_masks():
    """tests/test_parallel.py:133-158's masks: random at three densities, a
    snake crossing every seam several times, one pixel on the n=2 seam."""
    H = W = 32
    rng = np.random.default_rng(0)
    cases = [rng.random((H, W)) < d for d in (0.3, 0.5, 0.7)]
    snake = np.zeros((H, W), bool)
    for c in range(0, W, 4):
        snake[:, c] = True
        snake[0 if (c // 4) % 2 else H - 1, c : c + 5] = True
    single = np.zeros((H, W), bool)
    single[15, 15] = True
    return cases + [snake, single]


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_distributed_ccl_matches_jax(n, connectivity):
    """Row-tiled CCL == JAX's on the same masks (labels identical,
    converged), and == the single-device connected_components."""
    jmesh, mesh = jax_cpu_mesh(n, "spatial"), cpu_mesh(n, "spatial")
    for mask in _ccl_masks():
        want, jconv = jax_dccl(jnp.asarray(mask), jmesh, connectivity=connectivity)
        got, conv = distributed_connected_components(torch.from_numpy(mask), mesh, connectivity=connectivity)
        assert bool(conv) and bool(jconv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        ref, _ = jax_connected_components(jnp.asarray(mask), connectivity=connectivity)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_distributed_ccl_cap_flag_matches_jax():
    """A 128² snake of 32 columns over 8 tiles needs more seam rounds than
    the cap To·n + 4n + 8 = 168: JAX's loop stops there with its flag
    False (its labels are already complete); the port's does the same."""
    n = 128
    snake = np.zeros((n, n), bool)
    for c in range(0, n, 4):
        snake[:, c] = True
        snake[0 if (c // 4) % 2 else n - 1, c : c + 5] = True
    want, jconv = jax_dccl(jnp.asarray(snake), jax_cpu_mesh(8, "spatial"))
    got, conv = distributed_connected_components(torch.from_numpy(snake), cpu_mesh(8, "spatial"))
    assert not bool(jconv) and not bool(conv)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _asset():
    """The separable asset's config at K=16 and its weights."""
    return load_net_config(ASSETS["separable"]).replace(max_components=16), load_params(ASSETS["separable"])


def test_tiled_detect_matches_jax():
    """tiled_detect on a 128² scene over 4 tiles (T = 32 rows, the asset's
    140-pixel halo clamped to 96 and fetched over three hops) against
    JAX's tiled_detect."""
    jcfg, jparams, cfg, params = _models("separable")
    img = _scenes(1, (128, 128), 4)[0]
    ref = jax.device_get(jax_tiled_detect(jparams, jnp.asarray(img), jcfg, jax_cpu_mesh(4, "spatial")))
    out = tiled_detect(params, img, cfg, cpu_mesh(4, "spatial"))
    assert sorted(out) == sorted(ref)
    assert bool(out["ccl_converged"]) and bool(ref["ccl_converged"])
    # test_fcn_matches_flax's bound: 1e-5, or an f32 ulp or two of |logit| ~ 20
    np.testing.assert_allclose(out["logits"].numpy(), ref["logits"],
                               atol=max(1e-5, 1e-6 * np.abs(ref["logits"]).max()))
    assert int(ref["num_detections"]) > 0
    assert_same_detections(out, ref, score_atol=1e-5)


@pytest.mark.parametrize(
    "H,W,n",
    [
        (128, 128, 2),  # one hop (T = 64 < the 140-pixel halo: clamped to 64)
        (64, 96, 8),  # thin tiles: T = 8 rows, the halo over seven hops
        (32, 64, 8),  # To == 1: one heatmap row a tile, both seams on it
    ],
)
def test_tiled_detect_matches_detect_program(H, W, n):
    """tiled_detect == the port's detect_program on the whole image."""
    cfg, params = _asset()
    img = _scenes(1, (H, W), 9)[0]
    assert receptive_field_halo(cfg) > H // n
    ref, ref_logits = detect_program(params, img, cfg, (H, W), device="cpu")
    out = tiled_detect(params, img, cfg, cpu_mesh(n, "spatial"))
    assert bool(out["ccl_converged"])
    np.testing.assert_allclose(out["logits"].numpy(), ref_logits.numpy(), atol=1e-4)
    for key in ("valid", "areas", "num_detections", "num_components_total"):
        np.testing.assert_array_equal(out[key].numpy(), ref[key].numpy(), err_msg=key)
    assert same_corner_sets(out["boxes"].numpy(), ref["boxes"].numpy(), 1e-3).all()
    np.testing.assert_allclose(out["scores"].numpy(), ref["scores"].numpy(), atol=1e-5)


def _dp_case(mode):
    """(port cfg, params, qparams, JAX cfg, params, qparams) of a mode."""
    if mode == "bfloat16":
        jcfg, jparams = _jax_bf16("separable")
        cfg, params = _port_bf16("separable")
        return cfg, params, None, jcfg, jparams, None
    jcfg, jparams, cfg, params = _models("separable")
    if mode == "int8":
        q, pqp = _jax_qparams("separable")
        return cfg, params, pqp, jcfg, jparams, q
    return cfg, params, None, jcfg, jparams, None


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_dp_serving_matches_shards_and_jax(mode):
    """detect_program_batch(mesh=) over 4 entries on 8 128² scenes: bit for
    bit the per-shard single-device calls, within the full-batch call's
    round-off, and against JAX's detect_program_batch(mesh=) on 4 devices;
    detect_preprocessed_batch(mesh=) bit for bit its shards too."""
    cfg, params, pqp, jcfg, jparams, q = _dp_case(mode)
    imgs = _scenes(8, (128, 128), 3)
    mesh = cpu_mesh(4)
    res, logits = detect_program_batch(params, imgs, cfg, (128, 128), qparams=pqp, mesh=mesh, device="cpu")
    shards = [detect_program_batch(params, imgs[i:i + 2], cfg, (128, 128), qparams=pqp, device="cpu")
              for i in range(0, 8, 2)]
    for k in res:
        assert torch.equal(res[k], torch.cat([s[0][k] for s in shards])), k
    assert torch.equal(logits, torch.cat([s[1] for s in shards]))
    full, _ = detect_program_batch(params, imgs, cfg, (128, 128), qparams=pqp, device="cpu")
    for k in full:
        if full[k].is_floating_point():
            torch.testing.assert_close(res[k], full[k], atol=1e-5, rtol=0)
        else:
            assert torch.equal(res[k], full[k]), k
    ref, ref_logits = jax.device_get(jax_detect_program_batch(
        jparams, jnp.asarray(imgs), jcfg, (128, 128), qparams=q, mesh=jax_cpu_mesh(4, "data")))
    assert int(np.asarray(ref["num_detections"]).sum()) > 0
    if mode == "bfloat16":
        assert _ulps(logits.numpy(), ref_logits) <= FCN_ULPS
        assert_bf16_detections(res, ref, logits, ref_logits, cfg, logit_ulps=FCN_ULPS)
    else:
        if mode == "int8":
            np.testing.assert_array_equal(logits.numpy(), ref_logits)
        else:
            np.testing.assert_allclose(logits.numpy(), ref_logits, atol=1e-4)
        assert_same_detections(res, ref, score_atol=1e-5)
    x = (imgs.astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]
    pre, _ = detect_preprocessed_batch(params, x, cfg, qparams=pqp, mesh=mesh, device="cpu")
    pre_shards = [detect_preprocessed_batch(params, x[i:i + 2], cfg, qparams=pqp, device="cpu")[0]
                  for i in range(0, 8, 2)]
    for k in pre:
        assert torch.equal(pre[k], torch.cat([s[k] for s in pre_shards])), k


def test_dp_serving_checks():
    """detections_only over a mesh, a batch the mesh does not divide, a
    mesh of another type, and a device that contradicts the mesh."""
    cfg, params = _asset()
    imgs = _scenes(4, (64, 64), 1)
    res, none = detect_program_batch(params, imgs, cfg, (64, 64), detections_only=True,
                                     mesh=cpu_mesh(2), device="cpu")
    assert none is None and res["valid"].shape == (4, 16)
    with pytest.raises(ValueError, match="divisible"):
        detect_program_batch(params, imgs[:3], cfg, (64, 64), mesh=cpu_mesh(2), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        detect_program_batch(params, imgs, cfg, (64, 64), mesh=object(), device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        detect_program_batch(params, imgs, cfg, (64, 64), mesh=cpu_mesh(2), device="cuda")


def test_streaming_over_a_mesh():
    """StreamingDetector(mesh=) over 2 entries: the same per-frame results
    as without a mesh, the tail batch padded; a batch size the mesh does
    not divide raises."""
    cfg = load_net_config(ASSETS["separable"]).replace(max_components=8)
    params = load_params(ASSETS["separable"])
    frames = list(_scenes(10, (64, 96), 3))
    plain = list(StreamingDetector(cfg, params, (64, 96), batch_size=4, device="cpu").process(iter(frames)))
    dp = list(StreamingDetector(cfg, params, (64, 96), batch_size=4, mesh=cpu_mesh(2), device="cpu")
              .process(iter(frames)))
    assert [i for i, _ in dp] == list(range(10))
    for (_, a), (_, b) in zip(plain, dp):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(int(d["num_detections"]) for _, d in dp) > 0
    with pytest.raises(ValueError, match="divisible"):
        StreamingDetector(cfg, params, (64, 96), batch_size=4, mesh=cpu_mesh(3), device="cpu")


@pytest.mark.parametrize("native", [False, True], ids=["resized", "native"])
def test_run_evaluation_over_a_mesh(native):
    """run_evaluation(mesh=) on 10 scenes at batch 4 (a remainder batch of
    2, padded and dropped) equals the run without a mesh; so does the
    CLI's --num-devices 2 --allow-cpu-mesh, and a batch size the mesh does
    not divide exits."""
    cfg, params = _asset()
    reader = SyntheticMarkupReader(n_samples=10, image_hw=(64, 64), seed=0)
    dc = DataConfig(batch_size=4, train_hw=(64, 64), max_polys=32)
    want = peval.run_evaluation(params, reader, cfg, dc, native=native, device="cpu")
    got = peval.run_evaluation(params, reader, cfg, dc, native=native, mesh=cpu_mesh(2), device="cpu")
    assert got == want and got.n_images == 10 and got.tp > 0
    if native:
        return
    args = ["--data", "synthetic", "--checkpoint", str(ASSETS["separable"]), "--synthetic-samples", "6",
            "--image-size", "64", "64", "--batch-size", "4", "--device", "cpu"]
    assert peval.main(args + ["--num-devices", "2", "--allow-cpu-mesh"]) == peval.main(args)
    with pytest.raises(SystemExit, match="divisible"):
        peval.main(args + ["--num-devices", "3", "--allow-cpu-mesh"])


def test_setup_devices_gating():
    """--num-devices past the cards raises naming --allow-cpu-mesh, and
    with it builds CPU entries; with no card at all it raises too (the
    port's deliberate difference: JAX falls back to its CPU devices), and
    so does distributed=True (tests/test_torch_distributed.py runs it)."""
    assert setup_devices(None) is None
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="allow-cpu-mesh"):
        setup_devices(str(n_cards + 1))
    mesh = setup_devices(str(n_cards + 3), allow_cpu_mesh=True)
    assert mesh.devices.size == n_cards + 3 and all(d.type == "cpu" for d in mesh.devices.flat)
    assert mesh.axis_names == ("data",)
    if n_cards == 0:
        with pytest.raises(ValueError, match="allow-cpu-mesh"):
            setup_devices("auto")
        assert setup_devices("auto", allow_cpu_mesh=True).devices.size == 1
    with pytest.raises(ValueError, match="integer or 'auto'"):
        setup_devices("two")
    if n_cards == 0:
        with pytest.raises(RuntimeError, match="allow-cpu-mesh"):
            setup_devices("1", distributed=True)

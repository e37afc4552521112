"""PyTorch port: the mesh paths on the card — data-parallel serving, the
stream and evaluation over four entries of one card, the row-tiled scan
and the distributed CCL — against the single-device calls on the card.

Marked ``cuda``; every test skips without a card.  On the H100 (no jax
there, so without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ubdvss_tpu_torch import (
    NetConfig,
    StreamingDetector,
    detect_program,
    detect_program_batch,
    load_net_config,
    load_params_npz,
    params_from_flat,
)
from ubdvss_tpu_torch.data import DataConfig
from ubdvss_tpu_torch.evaluate import run_evaluation
from ubdvss_tpu_torch.ops.ccl import connected_components
from ubdvss_tpu_torch.ops.cuda import ccl_kernel, context_kernel, postproc_kernel, rect_kernel
from ubdvss_tpu_torch.ops.quant import quantize_trunk
from ubdvss_tpu_torch.parallel import make_mesh
from ubdvss_tpu_torch.parallel.tiling import distributed_connected_components, tiled_detect
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

pytestmark = pytest.mark.cuda

ASSET = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _scenes(n, hw, seed):
    reader = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed)
    return np.stack([reader.sample_at(i).image for i in range(n)])


WRAPPERS = [(context_kernel.fused_context_head, "launches"), (ccl_kernel.ccl_labels_from_logits, "launches"),
            (ccl_kernel.ccl_labels_from_logits, "launches_bf16"), (postproc_kernel.component_slots, "launches"),
            (postproc_kernel.component_slots, "launches_bf16"), (rect_kernel.min_area_rect_compact, "launches")]


def _counts(run):
    for f, attr in WRAPPERS:
        setattr(f, attr, 0)
    out = run()
    torch.cuda.synchronize()
    return out, [getattr(f, attr) for f, attr in WRAPPERS]


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
def test_dp_serving_on_repeated_card(dev, mode):
    """detect_program_batch(mesh=) over 4 entries of the card on 16 256²
    scenes: bit for bit the four per-shard calls, 4x each kernel's launches
    of one shard's call, ints equal to the full-batch call."""
    cfg = NetConfig(max_components=16, dtype="bfloat16" if mode == "bfloat16" else "float32")
    params = params_from_flat(load_params_npz(ASSET))
    qparams = None
    imgs = _scenes(16, (256, 256), 7)
    if mode == "int8":
        x = torch.from_numpy(imgs[:8]).to(dev).float()[..., None] / 127.5 - 1.0
        qparams = quantize_trunk({k: v.to(dev) for k, v in params.items()}, cfg, x)
    mesh = make_mesh(4, devices=[dev] * 4)
    (res, logits), n_dp = _counts(lambda: detect_program_batch(params, imgs, cfg, (256, 256), qparams=qparams,
                                                               mesh=mesh))
    shards = []
    for i in range(0, 16, 4):
        out, n_one = _counts(lambda i=i: detect_program_batch(params, imgs[i:i + 4], cfg, (256, 256),
                                                              qparams=qparams))
        shards.append(out)
    assert n_dp == [4 * c for c in n_one] and sum(n_one) > 0
    for k in res:
        assert torch.equal(res[k], torch.cat([s[0][k] for s in shards])), k
    assert torch.equal(logits, torch.cat([s[1] for s in shards]))
    full, _ = detect_program_batch(params, imgs, cfg, (256, 256), qparams=qparams)
    for k in full:
        if not full[k].is_floating_point():
            assert torch.equal(res[k], full[k]), k
    assert int(res["num_detections"].sum()) > 0


def test_stream_and_evaluation_on_repeated_card(dev):
    """StreamingDetector(mesh=) and run_evaluation(mesh=) over 4 entries of
    the card equal the runs without a mesh (a remainder batch padded).  K2
    sums its stats in the order of its slot plan, which the batch's size
    picks (postproc_kernel.slot_plan), so the stream over the mesh equals
    bit for bit the stream at a shard's batch (4 frames); against the
    unsharded batch of 16 its ints are equal and its floats within the
    stats' 2e-6."""
    cfg = load_net_config(ASSET).replace(max_components=16)
    params = params_from_flat(load_params_npz(ASSET))
    mesh = make_mesh(4, devices=[dev] * 4)
    frames = list(_scenes(40, (240, 320), 7))
    a = list(StreamingDetector(cfg, params, (240, 320), batch_size=16).process(iter(frames)))
    b = list(StreamingDetector(cfg, params, (240, 320), batch_size=16, mesh=mesh).process(iter(frames)))
    c = list(StreamingDetector(cfg, params, (240, 320), batch_size=4).process(iter(frames)))
    assert [i for i, _ in b] == list(range(40))
    for (_, x), (_, y), (_, z) in zip(a, b, c):
        for k in x:
            np.testing.assert_array_equal(z[k], y[k], err_msg=k)
            if np.issubdtype(np.asarray(x[k]).dtype, np.floating):
                np.testing.assert_allclose(x[k], y[k], atol=2e-6, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    reader = SyntheticMarkupReader(n_samples=20, image_hw=(128, 128), seed=0)
    dc = DataConfig(batch_size=8, train_hw=(128, 128), max_polys=32)
    want = run_evaluation(params, reader, cfg, dc)
    assert run_evaluation(params, reader, cfg, dc, mesh=mesh) == want and want.tp > 0


@pytest.mark.parametrize("n", [4, 16])
def test_tiled_detect_on_repeated_card(dev, n):
    """tiled_detect of a 512² scan over n entries of the card (n=16: 32-row
    tiles, the halo over several hops) == detect_program on the whole
    scan: logits within 1e-4, valid and areas identical, boxes within 1e-3
    as corner sets, converged."""
    cfg = NetConfig(max_components=16)
    params = params_from_flat(load_params_npz(ASSET))
    img = _scenes(1, (512, 512), 11)[0]
    ref, ref_logits = detect_program(params, img, cfg, (512, 512))
    out = tiled_detect(params, img, cfg, make_mesh(n, axis="spatial", devices=[dev] * n))
    assert bool(out["ccl_converged"])
    assert float((out["logits"] - ref_logits).abs().max()) <= 1e-4
    assert torch.equal(out["valid"], ref["valid"]) and torch.equal(out["areas"], ref["areas"])
    a = out["boxes"].double().cpu().numpy()
    b = ref["boxes"].double().cpu().numpy()
    d = np.linalg.norm(a[:, :, None] - b[:, None], axis=-1)  # (K, 4, 4)
    assert (d.min(-1).max(-1) <= 1e-3).all()
    assert int(ref["num_detections"]) > 0


def test_ccl_on_the_card(dev):
    """connected_components on the card == K1's raw labels compacted; the
    row-tiled CCL over 2, 4 and 8 entries == connected_components."""
    rng = np.random.default_rng(0)
    maps = [rng.random((128, 128)) < d for d in (0.3, 0.5, 0.7)]
    snake = np.zeros((128, 128), bool)
    for c in range(0, 128, 16):
        snake[:, c] = True
        snake[0 if (c // 16) % 2 else 127, c : c + 17] = True
    maps.append(snake)
    for m in maps:
        mask = torch.from_numpy(m).to(dev)
        for conn in (4, 8):
            labels, n = connected_components(mask, conn)
            raw = ccl_kernel.ccl_labels_from_logits(torch.where(mask, 6.0, -6.0)[None], connectivity=conn)[0]
            roots = torch.unique(raw[raw < raw.numel()])
            want = torch.where(raw < raw.numel(), torch.searchsorted(roots, raw) + 1, 0).to(torch.int32)
            assert torch.equal(labels, want) and int(n) == roots.numel()
            for k in (2, 4, 8):
                got, conv = distributed_connected_components(
                    mask, make_mesh(k, axis="spatial", devices=[dev] * k), connectivity=conn)
                assert bool(conv) and torch.equal(got, labels)

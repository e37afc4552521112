"""PyTorch port: each CUDA kernel against its plain PyTorch version on the
card, at shapes and settings beyond the main path's (odd sizes, other K,
M, C, O, thresholds, connectivity), plus the wrappers' input checks.

Marked ``cuda``; every test skips without a card.  On the H100 (no jax
there, so without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from ubdvss_tpu_torch.ops.cuda import ccl_kernel, context_kernel, postproc_kernel, rect_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _maps(seed, B, H, W):
    """Blob, noise and snake detection-logit maps."""
    rng = np.random.default_rng(seed)
    lg = np.full((B, H, W), -4.0, np.float32)
    for b in range(B):
        kind = b % 3
        if kind == 0:
            for _ in range(8):
                y, x = rng.integers(0, H), rng.integers(0, W)
                lg[b, y : y + rng.integers(1, 12), x : x + rng.integers(1, 12)] = 4.0
        elif kind == 1:
            lg[b] = rng.normal(0, 1, (H, W))
        else:
            for c in range(0, W, 3):
                lg[b, :, c] = 4.0
                lg[b, 0 if (c // 3) % 2 else H - 1, c : c + 4] = 4.0
    return lg


@pytest.mark.parametrize("C,O", [(8, 1), (24, 17), (32, 32)])
@pytest.mark.parametrize("hw", [(128, 128), (37, 53)])
def test_context_kernel_matches_plain(dev, C, O, hw):
    rng = np.random.default_rng(C + O)
    dil = (1, 2, 16, 64)  # 64 puts every off-centre tap outside a 37x53 map
    L = len(dil)
    x = torch.from_numpy(rng.normal(0, 1, (3, C, *hw)).astype(np.float32)).to(dev)
    w = [
        torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).to(dev)
        for s, shape in (
            (0.3, (L, 9, C, 1, 1)), (0.3, (L, C, C)), (0.1, (L, C, 1, 1)),
            (0.3, (O, C)), (0.1, (O, 1, 1)),
        )
    ]
    context_kernel.fused_context_head.launches = 0
    out = context_kernel.fused_context_head(x, *w, dil)
    assert context_kernel.fused_context_head.launches == L
    with context_kernel.exact_f32():
        ref = context_kernel.context_head_reference(x, *w, dil)
    assert out.shape == (3, O, *hw)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("shape,thr", [((3, 128, 128), 0.5), ((4, 37, 53), 0.3), ((2, 200, 240), 0.5)])
def test_ccl_kernel_matches_plain(dev, shape, thr, connectivity):
    lg = torch.from_numpy(_maps(sum(shape), *shape)).to(dev)
    out = ccl_kernel.ccl_labels_from_logits(lg, thr, connectivity)
    ref = ccl_kernel.ccl_labels_reference(lg, thr, connectivity)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("K", [1, 16, 64])
@pytest.mark.parametrize("shape", [(3, 128, 128), (4, 37, 53)])
def test_slots_kernel_matches_plain(dev, shape, K):
    lg = torch.from_numpy(_maps(K, *shape)).to(dev)
    lab = ccl_kernel.ccl_labels_reference(lg)
    out = postproc_kernel.component_slots(lg, lab, K)
    ref = postproc_kernel.component_slots_reference(lg, lab, K)
    for key in ref:
        assert torch.equal(out[key], ref[key]), key


@pytest.mark.parametrize(
    "shape,M", [((3, 128, 128), 8), ((3, 128, 128), 64), ((4, 37, 53), 8), ((4, 37, 53), 32)]
)
def test_rect_kernel_matches_plain(dev, shape, M):
    lg = torch.from_numpy(_maps(M, *shape)).to(dev)
    geo = postproc_kernel.component_slots_reference(lg, ccl_kernel.ccl_labels_reference(lg), 16)
    out = rect_kernel.min_area_rect_select(geo["minx"], geo["maxx"], M)
    ref = rect_kernel.min_area_rect_select_reference(geo["minx"], geo["maxx"], M)
    assert torch.equal(out[:, 6], ref[:, 6])
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    lg = torch.zeros((2, 16, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ccl_kernel.ccl_labels_from_logits(lg.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        ccl_kernel.ccl_labels_from_logits(lg.double())
    with pytest.raises(NotImplementedError, match="shared memory"):
        ccl_kernel.ccl_labels_from_logits(torch.zeros((1, 256, 256), device=dev))
    lab = ccl_kernel.ccl_labels_from_logits(lg)
    with pytest.raises(TypeError, match="int32"):
        postproc_kernel.component_slots(lg, lab.long(), 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        postproc_kernel.component_slots(lg, lab.cpu(), 4)


@pytest.mark.parametrize("asset", ["pretrained_synthetic", "pretrained_dense_synthetic"])
def test_detector_on_card_matches_cpu(dev, asset):
    """BarcodeDetector on an RGB image that needs a resize (the route the
    main path's grid-aligned scenes skip), on the card vs the CPU, for the
    separable (context kernel) and dense (cuDNN context) assets."""
    from pathlib import Path

    from ubdvss_tpu_torch import (
        BarcodeDetector,
        load_net_config,
        load_params_npz,
        params_from_flat,
    )
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / f"{asset}.npz"
    cfg = load_net_config(path)
    params = params_from_flat(load_params_npz(path))
    gray = SyntheticMarkupReader(n_samples=1, image_hw=(509, 301), seed=4).sample_at(0).image
    rgb = np.stack([gray, np.clip(gray.astype(int) + 9, 0, 255), gray], -1).astype(np.uint8)
    out = BarcodeDetector(cfg, params, device=dev).detect(rgb)
    ref = BarcodeDetector(cfg, params, device="cpu").detect(rgb)
    assert len(ref) > 0 and len(out) == len(ref)
    for o, r in zip(out, ref):
        assert (o.class_id, o.area) == (r.class_id, r.area)
        assert abs(o.score - r.score) < 1e-5
        np.testing.assert_allclose(o.center, r.center, atol=1e-3)

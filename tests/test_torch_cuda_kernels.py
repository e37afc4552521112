"""PyTorch port: each CUDA kernel against its plain PyTorch version on the
card, at shapes and settings beyond the main path's (odd sizes, other K,
M, C, O, thresholds, connectivity), plus the wrappers' input checks.

Marked ``cuda``; every test skips without a card.  On the H100 (no jax
there, so without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
"""

from itertools import permutations

import numpy as np
import pytest
import torch

from ubdvss_tpu_torch.ops.cuda import (
    _build,
    ccl_kernel,
    context_kernel,
    postproc_kernel,
    qconv_kernel,
    rect_kernel,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def logit_bar(ref: torch.Tensor) -> float:
    """The bar of the card's f32 logits against their plain version:
    max(1e-5, 1e-6 max|logit|), the f32 route's against the JAX package."""
    return max(1e-5, 1e-6 * float(ref.abs().max()))


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


@pytest.mark.parametrize("dil", [(1, 2, 16, 64), (64, 16, 8, 16)])
@pytest.mark.parametrize("C,O", [(8, 1), (16, 17), (24, 17), (32, 32)])
@pytest.mark.parametrize("hw", [(128, 128), (37, 53), (60, 80)])
def test_context_kernel_matches_plain(dev, C, O, hw, dil):
    """K4's exact instance within logit_bar of the plain version at every
    compiled width.  64 puts every off-centre tap outside a 37x53 map and
    makes the plan take a pixel a thread; at 16 a thread's P d rows pass
    the end of the 37- and 60-row maps (the last group of rows cut, P
    halved on 37 rows); the head at 1, 64 and 16."""
    rng = np.random.default_rng(C + O)
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
    torch.testing.assert_close(out, ref, atol=logit_bar(ref), rtol=0)


def test_context_kernel_qvga_asset(dev):
    """The QVGA stream's shape (C=24, 60x80 heatmaps) with the asset's
    weights and dilations, on the stem's features of 240x320 frames."""
    from pathlib import Path

    from ubdvss_tpu_torch import load_net_config, load_params_npz, params_from_flat
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(path)
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(path)).items()}
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(240, 320), seed=3)
    frames = np.stack([reader.sample_at(i).image for i in range(4)])
    dil = tuple(cfg.dilations)
    with context_kernel.exact_f32():
        feat = context_kernel.stem_apply(
            params, torch.from_numpy(frames).to(dev).float()[..., None], cfg, raw_gray=True)
        xc = feat.permute(0, 3, 1, 2).contiguous()
        assert tuple(xc.shape) == (4, 24, 60, 80)
        w = context_kernel._pack_weights(params, dil)
        context_kernel.fused_context_head.launches = 0
        out = context_kernel.fused_context_head(xc, *w, dil)
        assert context_kernel.fused_context_head.launches == len(dil)
        ref = context_kernel.context_head_reference(xc, *w, dil)
    torch.testing.assert_close(out, ref, atol=logit_bar(ref), rtol=0)


def test_context_kernel_asset_main_path(dev):
    """The main path's K4 call: the asset's weights and dilations on the
    stem's features of 64 synthetic 512x512 scenes, (64, 24, 128, 128) in,
    17 logits out, seven launches, within logit_bar of the plain version."""
    from pathlib import Path

    from ubdvss_tpu_torch import load_net_config, load_params_npz, params_from_flat
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(path)
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(path)).items()}
    reader = SyntheticMarkupReader(n_samples=64, image_hw=(512, 512), seed=7)
    imgs = torch.from_numpy(np.stack([reader.sample_at(i).image for i in range(64)])).to(dev)
    dil = tuple(cfg.dilations)
    with context_kernel.exact_f32():
        xc = context_kernel.stem_apply(params, imgs.float()[..., None], cfg, raw_gray=True)
        xc = xc.permute(0, 3, 1, 2).contiguous()
        assert tuple(xc.shape) == (64, 24, 128, 128)
        w = context_kernel._pack_weights(params, dil)
        assert context_kernel.kernel_instance(24, w[3].shape[0]) == "exact"
        context_kernel.fused_context_head.launches = 0
        out = context_kernel.fused_context_head(xc, *w, dil)
        assert context_kernel.fused_context_head.launches == len(dil) == 7
        ref = context_kernel.context_head_reference(xc, *w, dil)
    assert out.shape == (64, 17, 128, 128)
    torch.testing.assert_close(out, ref, atol=logit_bar(ref), rtol=0)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("shape,thr", [((3, 128, 128), 0.5), ((4, 37, 53), 0.3), ((2, 200, 240), 0.5)])
def test_ccl_kernel_matches_plain(dev, shape, thr, connectivity):
    lg = torch.from_numpy(_maps(sum(shape), *shape)).to(dev)
    out = ccl_kernel.ccl_labels_from_logits(lg, thr, connectivity)
    ref = ccl_kernel.ccl_labels_reference(lg, thr, connectivity)
    assert torch.equal(out, ref)


def _spiral(H, W):
    """A one-pixel-wide spiral path with one-pixel gaps: one component whose
    geodesic length is about H*W/2."""
    m = np.zeros((H, W), bool)
    y, x, d, stuck = 0, 0, 0, 0
    m[0, 0] = True
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    while stuck < 2:
        dy, dx = dirs[d]
        ny, nx, ay, ax = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        if (0 <= ny < H and 0 <= nx < W and not m[ny, nx]
                and not (0 <= ay < H and 0 <= ax < W and m[ay, ax])):
            y, x, stuck = ny, nx, 0
            m[y, x] = True
        else:
            d, stuck = (d + 1) % 4, stuck + 1
    return m


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("hw", [(128, 128), (200, 240), (37, 53)])
def test_ccl_kernel_union_find_stress(dev, hw, connectivity):
    """Maps that stress union-find: full foreground, the checkerboard (one
    component under 8-connectivity), a spiral of geodesic length ~H*W/2;
    200x240 takes 192 KB of shared memory.  CCL and K12c identical to their
    plain versions."""
    H, W = hw
    spiral = _spiral(H, W)
    assert spiral.sum() >= 0.45 * H * W
    lg = np.stack([
        np.full((H, W), 4.0, np.float32),
        np.where(np.indices((H, W)).sum(0) % 2 == 0, 4.0, -4.0).astype(np.float32),
        np.where(spiral, 4.0, -4.0).astype(np.float32),
    ])
    lg = torch.from_numpy(lg).to(dev)
    out = ccl_kernel.ccl_labels_from_logits(lg, 0.5, connectivity)
    ref = ccl_kernel.ccl_labels_reference(lg, 0.5, connectivity)
    assert torch.equal(out, ref)
    assert bool((ref[0] == 0).all()) and bool((ref[2][torch.from_numpy(spiral).to(dev)] == 0).all())
    geo = postproc_kernel.geometry_compat(lg, 16, connectivity=connectivity)
    geo_ref = postproc_kernel.geometry_compat_reference(lg, 16, connectivity=connectivity)
    for key in _SLOT_KEYS:
        assert torch.equal(geo[key], geo_ref[key]), key
    # a 16384-pixel component of one constant logit: the plain version's f32
    # cuBLAS product drifts ~5e-6 from the exact mean there, so the kernel's
    # mean is held to the f64 sum
    onehot = (geo_ref["slots"].flatten(1)[:, None] == torch.arange(16, device=dev)[:, None])
    exact = torch.bmm(onehot.double(), torch.sigmoid(lg.double()).flatten(1)[..., None])[..., 0]
    area = geo_ref["areas"].clamp(min=1).double()
    torch.testing.assert_close(geo["det_sums"] / area, exact / area, atol=2e-6, rtol=0)


def _head_logits(det: np.ndarray, C: int, seed: int, dev) -> torch.Tensor:
    """(B, H, W) detection logits -> the (B, H, W, C) NHWC view over
    (B, C, H, W) planes that the head returns, class logits normal."""
    B, H, W = det.shape
    planes = np.random.default_rng(seed).normal(0, 2, (B, C, H, W)).astype(np.float32)
    planes[:, 0] = det
    return torch.from_numpy(planes).to(dev).permute(0, 2, 3, 1)


_SLOT_KEYS = ("rootvals", "slots", "minx", "maxx", "num_components_total", "areas")

# few images, where the slot plan spreads an image over the widest cluster:
# B = 1, 2, 4 at a 512² detect's, a 640x480's and a 1024x768's heatmap and
# the packed route's 256² maps (ops/cuda/postproc_kernel.py slot_plan)
_FEW_MAPS = [(B, H, W) for B in (1, 2, 4) for H, W in ((128, 128), (120, 160), (192, 256),
                                                        (256, 256))]


def assert_stats_close(out: dict, ref: dict, exact=None):
    """Slot outputs and areas identical; det_sums / areas and
    cls_sums / areas within 2e-6 (f32 sums in another order) of the plain
    version's, or of ``exact`` (``_stats_f64``) where given: on the larger
    maps' components of tens of thousands of pixels the plain version's
    f32 one-hot products drift from the exact sums by more than that."""
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], ref[key]), key
    want = ref if exact is None else exact
    area = ref["areas"].clamp(min=1).to(want["det_sums"].dtype)
    torch.testing.assert_close(out["det_sums"] / area, want["det_sums"] / area, atol=2e-6, rtol=0)
    torch.testing.assert_close(
        out["cls_sums"] / area[..., None], want["cls_sums"] / area[..., None], atol=2e-6, rtol=0)


@pytest.mark.parametrize("C", [1, 5, 17])
@pytest.mark.parametrize("K", [1, 16, 64])
@pytest.mark.parametrize("shape", [(3, 128, 128), (4, 37, 53), (6, 60, 80), *_FEW_MAPS])
def test_slots_kernel_matches_plain(dev, shape, K, C):
    """K2's eight outputs against its plain version: blob maps (fewer than
    K=16 components, so the padding slot K-1 carries the background),
    noise (more than K) and snakes; two launches bit for bit equal.  C=1
    and C=17 (the main path's) have their own compiled kernels, C=5 takes
    the guarded bound of 5 channels.  On few images (the widest clusters)
    the means are held to the f64 sums."""
    lg = _head_logits(_maps(K, *shape), C, K + C, dev)
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0])
    out = postproc_kernel.component_slots(lg, lab, K)
    ref = postproc_kernel.component_slots_reference(lg, lab, K)
    assert out["cls_sums"].shape == (shape[0], K, max(C - 1, 1))
    exact = None
    if shape in _FEW_MAPS:  # components of up to tens of thousands of pixels
        exact = _stats_f64(lg, ref["slots"], K)
        if C == 1:
            exact["cls_sums"] = ref["cls_sums"].double()
    assert_stats_close(out, ref, exact)
    again = postproc_kernel.component_slots(lg, lab, K)
    for key in out:
        assert torch.equal(out[key], again[key]), key
    totals = ref["num_components_total"]
    if K == 16:
        assert bool((totals < K).any())  # padding slots
    if K == 1:
        assert bool((totals > K).any())  # pixels beyond the slots
    if C == 1:
        assert not bool(out["cls_sums"].any())


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


@pytest.mark.parametrize("n,M", [(60, 1), (60, 8), (60, 59), (128, 1), (128, 8), (128, 64),
                                 (128, 127)])
def test_rect_compact_kernel_adversarial(dev, n, M):
    """K3 on chip_smoke's adversarial maps (snake, checkerboard, tall bars,
    single pixels, staircases, noise, a notched blob, empty) at n=60 and
    n=128, K=16, for M in {1, 8, 64, H-1} below H: any_edge identical, rows
    within 1e-4."""
    from chip_smoke import adversarial_maps

    g = postproc_kernel.geometry_compat_reference(
        torch.from_numpy(adversarial_maps(n)).to(dev), 16)
    minx, maxx = g["minx"].to(dev), g["maxx"].to(dev)
    rect_kernel.min_area_rect_compact.launches = 0
    out = rect_kernel.min_area_rect_select(minx, maxx, M)
    assert rect_kernel.min_area_rect_compact.launches == 1
    ref = rect_kernel.min_area_rect_select_reference(minx, maxx, M)
    assert torch.equal(out[:, 6], ref[:, 6])
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("M", [8, 39])
def test_rect_compact_kernel_long_lockstep(dev, M):
    """Chains that lockstep rounds peel one point a round (a collinear run
    between two far rows, on either side), so K3 finishes them with its
    slope rule after 4 rounds; staircases and zig-zags beside them."""
    H = 40
    mn = np.full((1, 4, H), 1 << 30, np.int32)
    mx = np.full((1, 4, H), -1, np.int32)
    y = np.arange(H)
    mn[0, 0], mx[0, 0] = np.where((y == 0) | (y == H - 1), 0, 10 + y), 60
    mn[0, 1], mx[0, 1] = 0, np.where((y == 0) | (y == H - 1), 90, 50 - y)
    mn[0, 2], mx[0, 2] = y, y + 3
    mn[0, 3, ::2], mx[0, 3, ::2] = 5 + 4 * (y[::2] % 4 == 0), 20
    minx, maxx = torch.from_numpy(mn).to(dev), torch.from_numpy(mx).to(dev)
    out = rect_kernel.min_area_rect_compact(minx, maxx, M)
    ref = rect_kernel.min_area_rect_select_reference(minx, maxx, M)
    assert torch.equal(out[:, 6], ref[:, 6])
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


def test_rect_compact_kernel_main_path_extremes(dev):
    """K3 on the extremes of the main path's shape: 4 synthetic 512x512
    scenes through the asset's model, K=16, M=64 and M=8."""
    from pathlib import Path

    from ubdvss_tpu_torch import load_params_npz, params_from_flat
    from ubdvss_tpu_torch.net_config import NetConfig
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(path)).items()}
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(512, 512), seed=7)
    imgs = torch.from_numpy(np.stack([reader.sample_at(i).image for i in range(4)])).to(dev)
    logits = context_kernel.fused_model_apply(params, imgs.float()[..., None], NetConfig(),
                                              raw_gray=True)
    g = postproc_kernel.component_slots_from_logits(logits[..., 0].contiguous(), 16)
    assert int((g["num_components_total"] > 0).sum()) == 4
    for M in (64, 8):
        out = rect_kernel.min_area_rect_compact(g["minx"], g["maxx"], M)
        ref = rect_kernel.min_area_rect_select_reference(g["minx"], g["maxx"], M)
        assert torch.equal(out[:, 6], ref[:, 6])
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


def _tall_bar_extremes(H, W, seed):
    """(1, 16, H) extremes of one map of bars (some taller than 64 rows,
    of different widths and slants) and blobs, through the plain CCL and
    slots, K=16."""
    t = torch.from_numpy(_tall_bar_extremes_map(H, W, seed))
    geo = postproc_kernel.component_slots_reference(t, ccl_kernel.ccl_labels_reference(t), 16)
    return geo["minx"], geo["maxx"]


def _tall_bar_extremes_map(H, W, seed):
    """The (1, H, W) detection logits of _tall_bar_extremes."""
    rng = np.random.default_rng(seed)
    lg = np.full((1, H, W), -4.0, np.float32)
    for i, x0 in enumerate(range(2, W - 6, 9)):
        y0 = int(rng.integers(0, max(1, H // 8)))
        y1 = H - int(rng.integers(0, max(1, H // 8)))
        slant = (i % 3) * (W / 4) / H  # upright, then slanted bars
        for y in range(y0, y1):
            x = int(x0 + slant * (y - y0)) % (W - 5)
            lg[0, y, x : x + 1 + i % 4] = 4.0
    return lg


@pytest.mark.parametrize("K", [1, 16])
@pytest.mark.parametrize("H", [32, 60, 128])
def test_rect_exact_kernel_matches_plain(dev, H, K):
    """K3x (no compaction, every valid row projected) against its plain
    version on blob, noise and snake maps plus bars taller than 64 rows:
    any_edge identical, rows within 1e-4."""
    W = H + 20
    lg = torch.from_numpy(_maps(H + K, 3, H, W)).to(dev)
    geo = postproc_kernel.component_slots_reference(lg, ccl_kernel.ccl_labels_reference(lg), K)
    bars = _tall_bar_extremes(H, W, H + K)
    minx = torch.cat([geo["minx"], bars[0][:, :K].to(dev)])
    maxx = torch.cat([geo["maxx"], bars[1][:, :K].to(dev)])
    rect_kernel.min_area_rect_exact.launches = 0
    out = rect_kernel.min_area_rect_select(minx, maxx, None)
    assert rect_kernel.min_area_rect_exact.launches == 1
    ref = rect_kernel.min_area_rect_select_reference(minx, maxx, None)
    assert torch.equal(out[:, 6], ref[:, 6])
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    # M >= H takes the same kernel
    torch.testing.assert_close(rect_kernel.min_area_rect_select(minx, maxx, H), out, atol=0, rtol=0)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("K", [1, 16, 64])
@pytest.mark.parametrize("shape", [(3, 128, 128), (4, 37, 53), (3, 256, 64), (2, 1, 40),
                                   *_FEW_MAPS])
def test_geometry_compat_kernel_matches_plain_and_pair(dev, shape, K, connectivity):
    """K12c's slot outputs identical to its plain version, its stats within
    the plain version's tolerance, and all eight outputs bit for bit equal
    to slots after CCL on the card (K2 sums in the same order); a tall map,
    and a one-row map whose second block holds no row."""
    lg = _head_logits(_maps(K + connectivity, *shape), 17, K, dev)
    out = postproc_kernel.geometry_compat(lg, K, connectivity=connectivity)
    ref = postproc_kernel.geometry_compat_reference(lg, K, connectivity=connectivity)
    det = lg[..., 0].contiguous()
    pair = postproc_kernel.component_slots(
        lg, ccl_kernel.ccl_labels_from_logits(det, connectivity=connectivity), K)
    assert_stats_close(out, ref, _stats_f64(lg, ref["slots"], K) if shape in _FEW_MAPS else None)
    for key in ref:
        assert torch.equal(out[key], pair[key]), key


def test_compat_switch_selects_the_fused_kernel(dev, monkeypatch):
    lg = torch.from_numpy(_maps(5, 2, 64, 64)).to(dev)
    for f in (postproc_kernel.geometry_compat, postproc_kernel.component_slots,
              ccl_kernel.ccl_labels_from_logits):
        f.launches = 0
    lg = _head_logits(lg.cpu().numpy(), 17, 5, dev)
    default = postproc_kernel.component_stats_from_logits(lg, 8)
    monkeypatch.setenv("UBDVSS_PALLAS_COMPAT", "1")
    compat = postproc_kernel.component_stats_from_logits(lg, 8)
    assert postproc_kernel.geometry_compat.launches == 1
    assert postproc_kernel.component_slots.launches == 1
    assert ccl_kernel.ccl_labels_from_logits.launches == 1
    for key in default:
        assert torch.equal(compat[key], default[key]), key


def test_kernel_wrappers_reject_what_they_do_not_take(dev):
    lg = torch.zeros((2, 16, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ccl_kernel.ccl_labels_from_logits(lg.transpose(1, 2))
    with pytest.raises(TypeError, match="float32"):
        ccl_kernel.ccl_labels_from_logits(lg.double())
    # a map past one block's shared memory takes the device-memory kernel
    big = torch.from_numpy(_maps(1, 1, 256, 256)).to(dev)
    assert torch.equal(ccl_kernel.ccl_labels_from_logits(big), ccl_kernel.ccl_labels_reference(big))
    lab = ccl_kernel.ccl_labels_from_logits(lg)
    with pytest.raises(TypeError, match="int32"):
        postproc_kernel.component_slots(lg, lab.long(), 4)
    with pytest.raises(TypeError, match="float32"):
        postproc_kernel.component_slots(lg.double(), lab, 4)
    # past the stats' register chunk the kernels take the logits in chunks
    wide = _head_logits(_maps(34, 2, 16, 16), postproc_kernel.REGISTER_CHANNELS + 1, 34, dev)
    wide_lab = ccl_kernel.ccl_labels_reference(wide[..., 0])
    assert_stats_close(postproc_kernel.component_slots(wide, wide_lab, 4),
                       postproc_kernel.component_slots_reference(wide, wide_lab, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        postproc_kernel.component_slots(lg, lab.cpu(), 4)
    # past one block's shared memory K12c launches its large kernel, equal
    # to the tiled pair bit for bit, and K3x serves a 1025-row map
    big = torch.from_numpy(_maps(3, 1, 400, 300)).to(dev)
    postproc_kernel.geometry_compat_large.launches = 0
    fused = postproc_kernel.geometry_compat(big, 16)
    assert postproc_kernel.geometry_compat_large.launches == 1
    pair = postproc_kernel.component_slots_tiled(big, ccl_kernel.ccl_labels_tiled(big), 16)
    for key in pair:
        assert torch.equal(fused[key], pair[key]), key
    minx, maxx = (t.to(dev) for t in _synthetic_extremes(1, 4, 1025, 1025))
    out = rect_kernel.min_area_rect_exact(minx, maxx)
    ref = rect_kernel.min_area_rect_select_reference(minx, maxx, None)
    assert torch.equal(out[:, 6], ref[:, 6])
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("C,O", [(4, 17), (24, 33), (40, 17)])
def test_channel_caps_name_their_roadmap_item(dev, C, O):
    """The widths that were the port's channel caps (ROADMAP.md §2a): the
    context kernel at C outside (8, 16, 24, 32) or O > 32 equals its plain
    version, and the stats kernels (K2, K12c) at one channel past their
    register chunk equal theirs, as the JAX kernels and the plain versions
    take any width."""
    rng = np.random.default_rng(C + O)
    x = torch.from_numpy(rng.normal(0, 1, (1, C, 8, 8)).astype(np.float32)).to(dev)
    w = [torch.from_numpy(rng.normal(0, 0.3, shape).astype(np.float32)).to(dev)
         for shape in ((1, 9, C, 1, 1), (1, C, C), (1, C, 1, 1), (O, C), (O, 1, 1))]
    out = context_kernel.fused_context_head(x, *w, (1,))
    with context_kernel.exact_f32():
        ref = context_kernel.context_head_reference(x, *w, (1,))
    torch.testing.assert_close(out, ref, atol=logit_bar(ref), rtol=0)
    lg = _head_logits(_maps(C, 1, 8, 8), postproc_kernel.REGISTER_CHANNELS + 1, C, dev)
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0])
    ref = postproc_kernel.component_slots_reference(lg, lab, 4)
    for call in (lambda: postproc_kernel.component_slots(lg, lab, 4),
                 lambda: postproc_kernel.geometry_compat(lg, 4)):
        assert_stats_close(call(), ref)


def test_kernels_at_a_tall_shape(dev):
    """A 1024x256 scan's 256x64 heatmap, which the entry points serve (the
    route gate is on area): K4, K1, K2, K3 and K3x against their plain
    versions, K12c bit for bit equal to K1 -> K2."""
    B, C, H, W, K = 2, 24, 256, 64, 16
    rng = np.random.default_rng(256)
    x = torch.from_numpy(rng.normal(0, 1, (B, C, H, W)).astype(np.float32)).to(dev)
    dil = (1, 2, 16, 1)
    w = [torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).to(dev)
         for s, shape in ((0.3, (4, 9, C, 1, 1)), (0.3, (4, C, C)), (0.1, (4, C, 1, 1)),
                          (0.3, (17, C)), (0.1, (17, 1, 1)))]
    out = context_kernel.fused_context_head(x, *w, dil)
    with context_kernel.exact_f32():
        ref = context_kernel.context_head_reference(x, *w, dil)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)

    det = np.concatenate([_maps(H, 3, H, W), _tall_bar_extremes_map(H, W, 7)])
    lg = _head_logits(det, 17, 3, dev)
    for conn in (4, 8):
        lab = ccl_kernel.ccl_labels_from_logits(lg[..., 0].contiguous(), connectivity=conn)
        assert torch.equal(lab, ccl_kernel.ccl_labels_reference(lg[..., 0], connectivity=conn))
        geo = postproc_kernel.component_slots(lg, lab, K)
        assert_stats_close(geo, postproc_kernel.component_slots_reference(lg, lab, K))
        fused = postproc_kernel.geometry_compat(lg, K, connectivity=conn)
        for key in geo:
            assert torch.equal(fused[key], geo[key]), key
    for M in (64, None):
        sel = rect_kernel.min_area_rect_select(geo["minx"], geo["maxx"], M)
        sel_p = rect_kernel.min_area_rect_select_reference(geo["minx"], geo["maxx"], M)
        assert torch.equal(sel[:, 6], sel_p[:, 6])
        torch.testing.assert_close(sel, sel_p, atol=1e-4, rtol=0)


def _synthetic_extremes(B, K, H, seed):
    """(B, K, H) int32 extremes without a CCL: upright bars of every height
    (collinear chains), slanted bars (staircases), rotated rectangles, rows
    of noise, a single row, a single point and empty slots."""
    rng = np.random.default_rng(seed)
    y = np.arange(H)
    mn = np.full((B, K, H), 1 << 30, np.int64)
    mx = np.full((B, K, H), -1, np.int64)
    for b in range(B):
        for k in range(K):
            kind = (k + b) % 7
            y0 = int(rng.integers(0, max(1, H // 4)))
            y1 = H - int(rng.integers(0, max(1, H // 4)))
            rows = (y >= y0) & (y < y1)
            if kind == 0:  # upright bar
                x0 = int(rng.integers(0, 200))
                mn[b, k, rows], mx[b, k, rows] = x0, x0 + int(rng.integers(0, 9))
            elif kind == 1:  # slanted bar
                s = rng.uniform(-2.5, 2.5)
                xs = np.floor(300 + s * (y - y0)).astype(np.int64)
                mn[b, k, rows], mx[b, k, rows] = xs[rows], xs[rows] + int(rng.integers(1, 6))
            elif kind == 2:  # rotated rectangle
                a = rng.uniform(0, np.pi)
                hw, hh = rng.uniform(3, 60), rng.uniform(3, H / 3)
                cy, cx = (y0 + y1) / 2, 400.0
                for yy in range(y0, y1):
                    xs = np.arange(0, 800)
                    u = (xs - cx) * np.cos(a) + (yy - cy) * np.sin(a)
                    v = -(xs - cx) * np.sin(a) + (yy - cy) * np.cos(a)
                    inside = xs[(np.abs(u) <= hw) & (np.abs(v) <= hh)]
                    if inside.size:
                        mn[b, k, yy], mx[b, k, yy] = inside.min(), inside.max()
            elif kind == 3:  # noise rows
                keep = rows & (rng.random(H) < 0.7)
                lo = rng.integers(0, 300, H)
                mn[b, k, keep], mx[b, k, keep] = lo[keep], lo[keep] + rng.integers(0, 40, H)[keep]
            elif kind == 4:  # one row
                mn[b, k, y0], mx[b, k, y0] = 5, 5 + int(rng.integers(0, 30))
            elif kind == 5:  # one point
                mn[b, k, y1 - 1] = mx[b, k, y1 - 1] = 7
    return (torch.from_numpy(mn.astype(np.int32)), torch.from_numpy(mx.astype(np.int32)))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H", [60, 128, 513, 1024, 1088, rect_kernel.MAX_EXACT_HEIGHT, 2048, 4096])
def test_rect_exact_kernel_heights(dev, H, B):
    """K3x at every height: in one block's shared memory up to
    MAX_EXACT_HEIGHT (1994 rows), the tall instance past it (2048, 4096: a
    16,384 px page), at B=1 (a detect call) and B=3, on synthetic extremes
    (K=16): any_edge identical, rows within 1e-4; two launches bit for bit
    equal."""
    minx, maxx = (t.to(dev) for t in _synthetic_extremes(B, 16, H, H + B))
    rect_kernel.min_area_rect_exact.launches = 0
    out = rect_kernel.min_area_rect_exact(minx, maxx)
    assert rect_kernel.min_area_rect_exact.launches == 1
    ref = rect_kernel.min_area_rect_select_reference(minx, maxx, None)
    assert torch.equal(out[:, 6], ref[:, 6])
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert torch.equal(rect_kernel.min_area_rect_exact(minx, maxx), out)


def _staircase_extremes(B, K, H, seed):
    """``_synthetic_extremes`` with slot 0 of each image a bar 5 pixels wide
    rotated off the axes at a golden-ratio slope and spanning every row: a
    digital line whose two chains are long staircases that the kernels'
    four lockstep rounds do not settle, so the slope rule runs over
    thousands of rows."""
    mn, mx = (t.numpy().copy() for t in _synthetic_extremes(B, K, H, seed))
    y = np.arange(H)
    for b in range(B):
        s = 0.6180339887 * (1 if b % 2 == 0 else -1) / (1 + b)  # x per row
        left = np.floor(10 + (H * abs(s) if s < 0 else 0) + s * y).astype(np.int32)
        mn[b, 0], mx[b, 0] = left, left + 5
    return torch.from_numpy(mn), torch.from_numpy(mx)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H", [1088, rect_kernel.MAX_EXACT_HEIGHT, 2048, 4096])
def test_rect_exact_kernel_long_staircase(dev, H, B):
    """K3x on a rotated bar spanning every row (``_staircase_extremes``)
    beside the synthetic components, in the one-block instance and past
    its cap: any_edge identical, rows within 1e-4 of the plain version (or
    the same rectangle on an exact caliper tie)."""
    minx, maxx = (t.to(dev) for t in _staircase_extremes(B, 16, H, H + 7))
    out = rect_kernel.min_area_rect_exact(minx, maxx)
    ref = rect_kernel.min_area_rect_select_reference(minx, maxx, None)
    _assert_rect_rows(out, ref)


def _assert_rect_rows(out, ref, atol=1e-4):
    """(B, 9, K) rows: any_edge identical, rows within atol, or on an exact
    caliper tie the same rectangle by its other side (the same corner set
    and area; ROADMAP.md §3 Standing)."""
    assert torch.equal(out[:, 6], ref[:, 6])
    close = ((out - ref).abs() <= atol).all(1)
    if bool(close.all()):
        return
    ro, rr = rect_kernel.rects_from_selection(out), rect_kernel.rects_from_selection(ref)
    perms = np.array(list(permutations(range(4))))
    a, b = ro["points"][~close].cpu().numpy(), rr["points"][~close].cpu().numpy()
    d = np.linalg.norm(a[:, :, None] - b[:, None], axis=-1)
    assert (d[:, np.arange(4), perms].max(-1).min(-1) <= atol).all()
    torch.testing.assert_close(ro["size"][~close].prod(-1), rr["size"][~close].prod(-1),
                               atol=atol, rtol=1e-6)


def test_rect_exact_height_cap_is_one_formula(dev):
    """The exact kernel's cap and the tall instance's layout (rect_tall_plan)
    and workspace slot (rect_tall_slot_size) are the C side's formulas and
    the wrapper's copies of them agree; the tall instance launched directly
    at heights the one-block kernel serves gives that kernel's rows bit for
    bit (the same selection by another design)."""
    import ctypes

    from ubdvss_tpu_torch.ops.cuda import _build

    lib = _build.load("rect_kernel", rect_kernel._FUNCS)
    assert lib.rect_exact_max_height() == rect_kernel.MAX_EXACT_HEIGHT == 1994
    for H in (60, 1995, 2048, 4096, 16_384, 16_385, 100_000):
        assert lib.rect_tall_slot_size(H) == rect_kernel.tall_slot_bytes(H)
        got = (ctypes.c_int * 14)()
        lib.rect_tall_plan(H, got)
        plan = rect_kernel.tall_plan(H)
        assert list(got) == [getattr(plan, f) for f in plan.FIELDS], H
    for H in (60, 1024, rect_kernel.MAX_EXACT_HEIGHT):
        minx, maxx = (t.to(dev) for t in _staircase_extremes(3, 16, H, H))
        one = rect_kernel.min_area_rect_exact(minx, maxx)
        tall = torch.empty_like(one)
        _build.launch(lib, "rect_select_exact_tall", dev, minx.data_ptr(), maxx.data_ptr(),
                      tall.data_ptr(), None, 3, 16, H, 0)
        assert torch.equal(tall, one), H


def _round_extremes(B, K, H, seed, gaps=False):
    """``_synthetic_extremes`` with slot 0 of each image a convex blob over
    every row whose every row is a hull point on both chains: integer steps
    nondecreasing from -40 to 40 (the most distinct directions a chain of
    integer points spanning H rows can have at this width); with ``gaps``
    a third of its rows empty in runs."""
    mn, mx = (t.numpy().copy() for t in _synthetic_extremes(B, K, H, seed))
    rng = np.random.default_rng(seed)
    for b in range(B):
        d = np.sort(rng.integers(-40, 41, H))
        c = np.cumsum(d)
        c -= c.min()
        left = 100 + c
        right = 100 + 2 * int(c.max()) + 50 - c
        keep = ((np.arange(H) + 13 * b) // 61) % 3 != 1 if gaps else np.ones(H, bool)
        mn[b, 0] = np.where(keep, left, 1 << 30)
        mx[b, 0] = np.where(keep, right, -1)
    return torch.from_numpy(mn), torch.from_numpy(mx)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("H", [2048, 4096, 8192])
@pytest.mark.parametrize("kind", ["staircase", "round", "round-gaps"])
def test_rect_tall_cluster_matches_plain(dev, kind, H, B):
    """The tall instance (a cluster a component) beside the synthetic
    components: a staircase over every row, a convex blob over every row
    whose every row is a hull point, the blob with rows missing in runs;
    any_edge identical, rows within 1e-4 of the plain version (or the same
    rectangle on an exact caliper tie)."""
    make = _staircase_extremes if kind == "staircase" else _round_extremes
    extra = {"gaps": True} if kind == "round-gaps" else {}
    minx, maxx = (t.to(dev) for t in make(B, 16, H, H + B, **extra))
    rect_kernel.min_area_rect_exact.launches = 0
    out = rect_kernel.min_area_rect_exact(minx, maxx)
    assert rect_kernel.min_area_rect_exact.launches == 1
    ref = rect_kernel.min_area_rect_select_reference(minx, maxx, None)
    _assert_rect_rows(out, ref)


def _solo_extremes(B, K, h, seed):
    """(B, K, h) extremes of components of 1 to 1,024 rows (the tall
    instance's solo size) at offsets down the map, so that most span
    several blocks' rows: staircases, zig-zags and circles, which have rows
    concave in the lockstep's first round, convex chains and bars with
    gaps, which have none, noise rows, one row and empty slots."""
    rng = np.random.default_rng(seed)
    mn = np.full((B, K, h), 1 << 30, np.int64)
    mx = np.full((B, K, h), -1, np.int64)
    for b in range(B):
        for k in range(K):
            kind = (k + b) % 8
            n = int(rng.integers(200, 1025))
            y0 = int(rng.integers(0, h - n))
            y = np.arange(n)
            if kind == 0:  # staircase
                l = np.floor(10 + 0.6180339887 / (1 + b) * y).astype(np.int64)
                r = l + 5
            elif kind == 1:  # zig-zag
                l, r = 100 + (y % 7) * 3, 110 + (y % 7) * 3 + (y % 5)
            elif kind == 2:  # circle
                half = np.sqrt(np.maximum((n / 2) ** 2 - (y - n / 2) ** 2, 0))
                l, r = np.floor(600 - half).astype(np.int64), np.ceil(600 + half).astype(np.int64)
            elif kind == 3:  # convex: every row a hull point
                c = np.cumsum(np.sort(rng.integers(-6, 7, n)))
                c -= c.min()
                l, r = 100 + c, 150 + 2 * int(c.max()) - c
            elif kind == 4:  # an upright bar, rows missing in runs
                l, r = np.full(n, 40), np.full(n, 48)
                keep = (y // 37) % 3 != 1
                l, r = np.where(keep, l, 1 << 30), np.where(keep, r, -1)
            elif kind == 5:  # noise rows
                l = rng.integers(0, 300, n)
                r = np.where(rng.random(n) < 0.7, l + rng.integers(0, 40, n), -1)
                l = np.where(r >= 0, l, 1 << 30)
            elif kind == 6:  # one row
                l, r = np.full(n, 1 << 30), np.full(n, -1)
                l[n // 2], r[n // 2] = 5, 30
            else:  # empty
                continue
            mn[b, k, y0:y0 + n], mx[b, k, y0:y0 + n] = l, r
    return torch.from_numpy(mn.astype(np.int32)), torch.from_numpy(mx.astype(np.int32))


@pytest.mark.parametrize("H", [2048, 4096, 20_000])
def test_rect_tall_solo_components_match_the_one_block_kernel(dev, H):
    """Components of at most 1,024 rows on a tall map, which block 0 of
    the tall instance finishes alone, merging hulls only for the chains
    with a row concave in the lockstep's first round (in the cluster's
    shared memory, or at 20,000 rows in the workspace): the rows of the
    same components on a map the one-block kernel serves, bit for bit, and
    those hold the plain version."""
    h = rect_kernel.MAX_EXACT_HEIGHT
    mn, mx = _solo_extremes(2, 16, h, H)
    pad = (2, 16, H - h)
    minx = torch.cat([mn, torch.full(pad, 1 << 30, dtype=torch.int32)], -1).to(dev)
    maxx = torch.cat([mx, torch.full(pad, -1, dtype=torch.int32)], -1).to(dev)
    out = rect_kernel.min_area_rect_exact(minx, maxx)
    one = rect_kernel.min_area_rect_exact(mn.to(dev), mx.to(dev))
    assert torch.equal(out, one)
    _assert_rect_rows(one, rect_kernel.min_area_rect_select_reference(mn.to(dev), mx.to(dev), None))


def test_rect_tall_cluster_past_shared_memory(dev):
    """Past what the cluster's shared memory holds (20,000 rows) the arrays
    take the workspace (persistent clusters): a map whose components (a
    staircase, a convex blob, the synthetic kinds, empty slots) lie in its
    first 4,096 rows gives the rows of the same components on the 4,096-row
    map bit for bit (the selection reads only valid rows), which hold the
    plain version; one and three persistent clusters over the eight
    components give the same rows."""
    from ubdvss_tpu_torch.ops.cuda import _build

    H, h = 20_000, 4096
    assert not rect_kernel.tall_plan(H).in_shared and rect_kernel.tall_plan(h).in_shared
    lib = _build.load("rect_kernel", rect_kernel._FUNCS)
    for make in (_staircase_extremes, _round_extremes):
        mn, mx = make(1, 8, h, 5)
        pad = (1, 8, H - h)
        minx = torch.cat([mn, torch.full(pad, 1 << 30, dtype=torch.int32)], -1).to(dev)
        maxx = torch.cat([mx, torch.full(pad, -1, dtype=torch.int32)], -1).to(dev)
        out = rect_kernel.min_area_rect_exact(minx, maxx)
        small = rect_kernel.min_area_rect_exact(mn.to(dev), mx.to(dev))
        assert torch.equal(out, small)
        for slots in (1, 3):
            few = torch.empty_like(out)
            ws = torch.empty(slots * rect_kernel.tall_slot_bytes(H), dtype=torch.uint8, device=dev)
            _build.launch(lib, "rect_select_exact_tall", dev, minx.data_ptr(), maxx.data_ptr(),
                          few.data_ptr(), ws.data_ptr(), 1, 8, H, slots)
            assert torch.equal(few, out), slots
        _assert_rect_rows(small, rect_kernel.min_area_rect_select_reference(mn.to(dev), mx.to(dev),
                                                                            None))


def test_rect_exact_kernel_detect_extremes(dev):
    """K3x at a detect call's shape, B=1, K=16, H=128: the extremes of each
    of 4 synthetic 512x512 scenes alone, through the asset's model."""
    from pathlib import Path

    from ubdvss_tpu_torch import load_params_npz, params_from_flat
    from ubdvss_tpu_torch.net_config import NetConfig
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(path)).items()}
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(512, 512), seed=9)
    imgs = torch.from_numpy(np.stack([reader.sample_at(i).image for i in range(4)])).to(dev)
    logits = context_kernel.fused_model_apply(params, imgs.float()[..., None], NetConfig(),
                                              raw_gray=True)
    g = postproc_kernel.component_slots_from_logits(logits[..., 0].contiguous(), 16)
    for b in range(4):
        minx, maxx = g["minx"][b : b + 1].contiguous(), g["maxx"][b : b + 1].contiguous()
        out = rect_kernel.min_area_rect_exact(minx, maxx)
        ref = rect_kernel.min_area_rect_select_reference(minx, maxx, None)
        assert torch.equal(out[:, 6], ref[:, 6])
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


def test_streaming_on_card_matches_cpu(dev):
    """StreamingDetector on the card against the CPU: 10 QVGA-shaped frames
    (120x160, 30-row heatmaps, so the rects take K3x), batch 4 with a
    padded tail; masks, areas and classes identical, scores within 1e-5,
    boxes within 1e-3 as corner sets (an exact caliper tie may report the
    other side of the same rectangle)."""
    from pathlib import Path

    from ubdvss_tpu_torch import StreamingDetector, load_net_config, load_params_npz, params_from_flat
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(path).replace(max_components=16)
    params = params_from_flat(load_params_npz(path))
    reader = SyntheticMarkupReader(n_samples=10, image_hw=(120, 160), seed=5)
    frames = [reader.sample_at(i).image for i in range(10)]
    rect_kernel.min_area_rect_exact.launches = 0
    out = list(StreamingDetector(cfg, params, (120, 160), 4, device=dev).process(frames))
    assert rect_kernel.min_area_rect_exact.launches == 3
    ref = list(StreamingDetector(cfg, params, (120, 160), 4, device="cpu").process(frames))
    assert [i for i, _ in out] == [i for i, _ in ref] == list(range(10))
    assert sum(int(r["num_detections"]) for _, r in ref) > 0
    perms = np.array(list(permutations(range(4))))
    for (_, o), (_, r) in zip(out, ref):
        for key in ("valid", "areas", "classes", "num_detections", "num_components_total"):
            np.testing.assert_array_equal(o[key], r[key], err_msg=key)
        np.testing.assert_allclose(o["scores"], r["scores"], atol=1e-5)
        v = r["valid"]
        d = np.linalg.norm(o["boxes"][v][:, :, None] - r["boxes"][v][:, None], axis=-1)
        assert (d[:, np.arange(4), perms].max(-1).min(-1) <= 1e-3).all()


def test_detect_on_an_a4_page_matches_cpu(dev):
    """BarcodeDetector.detect on one synthetic A4 page at 600 dpi (7016x4960
    uint8, a 1754x1240 heatmap past the fused route's limit), the asset's
    config with max_image_side raised to keep the page's resolution, on
    the card against the CPU: the device-memory CCL, the tiled slots and
    K3x at 1754 rows launched, K3 not; classes and areas identical, scores
    within 1e-5, boxes within 2e-3 px as corner sets (one f32 ulp is 4.9e-4
    px past 4096 px)."""
    from pathlib import Path

    from ubdvss_tpu_torch import BarcodeDetector, load_net_config, load_params_npz, params_from_flat
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(path).replace(max_image_side=8192)
    params = params_from_flat(load_params_npz(path))
    page = SyntheticMarkupReader(n_samples=1, image_hw=(7016, 4960), seed=7,
                                 n_objects=(3, 6)).sample_at(0).image
    counted = (ccl_kernel.ccl_labels_tiled, postproc_kernel.component_slots_tiled,
               rect_kernel.min_area_rect_exact, rect_kernel.min_area_rect_compact)
    for f in counted:
        f.launches = 0
    out = BarcodeDetector(cfg, params, device=dev).detect(page)
    assert [f.launches for f in counted] == [1, 1, 1, 0]
    ref = BarcodeDetector(cfg, params, device="cpu").detect(page)
    assert len(ref) > 0 and len(out) == len(ref)
    perms = np.array(list(permutations(range(4))))
    for o, r in zip(out, ref):
        assert (o.class_id, o.area) == (r.class_id, r.area)
        assert abs(o.score - r.score) < 1e-5
        d = np.linalg.norm(o.box[:, None] - r.box[None], axis=-1)
        assert d[np.arange(4), perms].max(-1).min() <= 2e-3


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


def _uncapped_labels(lg: np.ndarray, connectivity: int) -> np.ndarray:
    """(B, H, W) logits -> the true components' min-index labels (H*W at
    the background), from scipy.ndimage.label: no round cap, so it holds
    the device-memory CCL on maps whose components the plain version's
    H+W rounds would need long to reach."""
    from scipy import ndimage

    B, H, W = lg.shape
    N = H * W
    st = np.ones((3, 3), bool) if connectivity == 8 else ndimage.generate_binary_structure(2, 1)
    out = np.empty((B, H, W), np.int32)
    for b in range(B):
        lab, n = ndimage.label(lg[b] > ccl_kernel.threshold_logit(0.5), structure=st)
        mins = np.full(n + 1, N, np.int64)
        np.minimum.at(mins, lab.ravel(), np.arange(N))
        out[b] = np.where(lab > 0, mins[lab], N)
    return out


def _large_map(kind: str, B: int, H: int, W: int) -> np.ndarray:
    if kind == "maps":  # blobs, noise, snake
        return _maps(H + W, B, H, W)
    if kind == "noise":
        return np.random.default_rng(H * W).normal(0, 1, (B, H, W)).astype(np.float32)
    if kind == "spiral":  # crosses every tile seam, one component
        return np.broadcast_to(np.where(_spiral(H, W), 4.0, -4.0), (B, H, W)).astype(np.float32)
    if kind == "checker":  # joins only at pixel (and tile) corners under 8-connectivity
        return np.broadcast_to(
            np.where(np.indices((H, W)).sum(0) % 2 == 0, 4.0, -4.0), (B, H, W)).astype(np.float32)
    return np.full((B, H, W), 4.0 if kind == "full" else -4.0, np.float32)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("kind,shape", [
    ("maps", (3, 256, 256)), ("maps", (3, 512, 512)), ("maps", (3, 1024, 1024)),
    ("maps", (3, 257, 1000)), ("noise", (2, 1, 60000)), ("noise", (2, 60000, 1)),
    ("spiral", (1, 301, 299)), ("checker", (1, 256, 320)), ("full", (2, 512, 512)),
    ("empty", (1, 512, 512)), ("maps", (3, 128, 128)), ("maps", (4, 37, 53)),
    ("maps", (64, 60, 80)),
])
def test_ccl_tiled_matches_uncapped_reference(dev, kind, shape, connectivity):
    """The device-memory CCL against scipy's components (min-index labels):
    256², 512², 1024², odd shapes past one block's shared memory, one-pixel
    rows and columns, a spiral through every tile seam, the checkerboard,
    full and empty maps; small maps too, where the router takes the
    one-block kernel.  Labels identical; ccl_labels_from_logits takes the
    tiled kernel exactly where the map exceeds one block's shared memory."""
    lg = _large_map(kind, *shape)
    ref = torch.from_numpy(_uncapped_labels(lg, connectivity)).to(dev)
    t = torch.from_numpy(lg).to(dev)
    out = ccl_kernel.ccl_labels_tiled(t, 0.5, connectivity)
    assert torch.equal(out, ref)
    ccl_kernel.ccl_labels_tiled.launches = 0
    ccl_kernel.ccl_labels_from_logits.launches = 0
    routed = ccl_kernel.ccl_labels_from_logits(t, 0.5, connectivity)
    assert torch.equal(routed, ref)
    big = shape[1] * shape[2] * 4 > ccl_kernel.MAX_SHARED_BYTES
    assert (ccl_kernel.ccl_labels_tiled.launches, ccl_kernel.ccl_labels_from_logits.launches) == (
        (1, 0) if big else (0, 1))


def _stats_f64(lg: torch.Tensor, slots: torch.Tensor, K: int) -> dict:
    """The plain version's stats, its one-hot products taken in f64 (at a
    million pixels a component the f32 products drift from the exact sum
    by more than the kernels' own rounding).  On bf16 logits the class
    probabilities are the f32 softmax rounded to bf16, as the kernels and
    the JAX package sum them."""
    B, H, W, C = lg.shape
    onehot = (slots.view(B, 1, H * W) == torch.arange(K, device=lg.device).view(1, K, 1)).double()
    det = torch.sigmoid(lg[..., 0].double()).reshape(B, H * W, 1)
    if lg.dtype == torch.bfloat16:
        cls = torch.softmax(lg[..., 1:].float(), -1).bfloat16().double().reshape(B, H * W, C - 1)
    else:
        cls = torch.softmax(lg[..., 1:].double(), -1).reshape(B, H * W, C - 1)
    return {"det_sums": torch.bmm(onehot, det)[..., 0], "cls_sums": torch.bmm(onehot, cls)}


@pytest.mark.parametrize("H,W", [(256, 256), (512, 512), (1024, 1024), (512, 250), (300, 1000)])
@pytest.mark.parametrize("K", [16, 64])
def test_slots_tiled_matches_plain(dev, K, H, W):
    """The tiled slots kernel against the plain version on blob (fewer than
    K components: padding slots), noise (more than K) and snake maps: slot
    outputs and areas identical, det_sums / areas and cls_sums / areas
    within 2e-6 of the plain one-hot sums (in f64), two launches bit for
    bit; component_slots takes it where K12c cannot run.  The non-square
    maps' widths are no multiple of the pass block's threads, so lanes past
    the last column and a partial last tile column run (out_hw=(2048, 1000)
    gives the 512x250 heatmap)."""
    lg = _head_logits(_maps(K + H, 3, H, W), 17, K, dev)
    lab = torch.from_numpy(_uncapped_labels(lg[..., 0].cpu().numpy(), 8)).to(dev)
    component_slots_tiled = postproc_kernel.component_slots_tiled
    out = component_slots_tiled(lg, lab, K)
    ref = postproc_kernel.component_slots_reference(lg, lab, K)
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], ref[key]), key
    exact = _stats_f64(lg, ref["slots"], K)
    area = ref["areas"].clamp(min=1).double()
    torch.testing.assert_close(out["det_sums"] / area, exact["det_sums"] / area, atol=2e-6, rtol=0)
    torch.testing.assert_close(out["cls_sums"] / area[..., None],
                               exact["cls_sums"] / area[..., None], atol=2e-6, rtol=0)
    again = component_slots_tiled(lg, lab, K)
    for key in out:
        assert torch.equal(out[key], again[key]), key
    totals = ref["num_components_total"]
    assert bool((totals < K).any()) and bool((totals > K).any())
    component_slots_tiled.launches = postproc_kernel.component_slots.launches = 0
    routed = postproc_kernel.component_slots(lg, lab, K)
    fits = postproc_kernel.geometry_compat_fits(H, W, K, 17)
    assert (component_slots_tiled.launches, postproc_kernel.component_slots.launches) == (
        (0, 1) if fits else (1, 0))
    assert torch.equal(routed["slots"], out["slots"])


@pytest.mark.parametrize("H", [512, 1024])
def test_rect_kernels_at_large_heights(dev, H):
    """K3 (M=64) and K3x on K=64 synthetic extremes at the large scans'
    heights (2048² and 4096² scans' heatmaps): any_edge identical, rows
    within 1e-4."""
    minx, maxx = (t.to(dev) for t in _synthetic_extremes(2, 64, H, H))
    for M in (64, None):
        out = rect_kernel.min_area_rect_select(minx, maxx, M)
        ref = rect_kernel.min_area_rect_select_reference(minx, maxx, M)
        assert torch.equal(out[:, 6], ref[:, 6])
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


_LARGE_COMPAT_SHAPES = [(3, 512, 512), (1, 1024, 1024), (2, 300, 1000), (2, 1000, 300)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("shape", _LARGE_COMPAT_SHAPES)
def test_geometry_compat_large_matches_tiled_pair(dev, shape, K, dtype):
    """K12c past one block's shared memory (the 2048² scans' 512² maps, the
    4096² scan's 1024² map, and maps whose widths are no multiple of a pass
    tile's): one launch of ``geometry_compat_large`` (counted at the
    logits' dtype), none of the cluster K12c, and its eight outputs bit for
    bit equal to ``ccl_labels_tiled`` then ``component_slots_tiled`` on
    the same logits, f32 and bf16."""
    B, H, W = shape
    lg = _head_logits(_maps(K + H, B, H, W), 17, K, dev).to(getattr(torch, dtype))
    assert not postproc_kernel.geometry_compat_fits(H, W, K, 17)
    large = postproc_kernel.geometry_compat_large
    for f in (large, postproc_kernel.geometry_compat, ccl_kernel.ccl_labels_tiled,
              postproc_kernel.component_slots_tiled):
        f.launches = f.launches_bf16 = 0
    out = postproc_kernel.geometry_compat(lg, K)
    bf16 = dtype == "bfloat16"
    assert (large.launches, large.launches_bf16) == (int(not bf16), int(bf16))
    assert postproc_kernel.geometry_compat.launches + postproc_kernel.geometry_compat.launches_bf16 == 0
    assert ccl_kernel.ccl_labels_tiled.launches + postproc_kernel.component_slots_tiled.launches == 0
    lab = ccl_kernel.ccl_labels_tiled(lg[..., 0].contiguous())
    pair = postproc_kernel.component_slots_tiled(lg, lab, K)
    for key in pair:
        assert torch.equal(out[key], pair[key]), key
    again = postproc_kernel.geometry_compat(lg, K)
    for key in pair:
        assert torch.equal(again[key], out[key]), key


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("kind", ["noise", "spiral", "checker", "full", "empty"])
def test_geometry_compat_large_on_adversarial_maps(dev, kind, connectivity):
    """The large K12c on the device-memory CCL's adversarial maps at 512²
    (noise, a spiral through every tile seam, the checkerboard, full and
    empty), K=64: its slots equal the tiled pair's bit for bit, and its
    components are scipy's (the slot map of the uncapped labels)."""
    lg = _head_logits(_large_map(kind, 1, 512, 512), 17, 5, dev)
    out = postproc_kernel.geometry_compat_large(lg, 64, connectivity=connectivity)
    lab = ccl_kernel.ccl_labels_tiled(lg[..., 0].contiguous(), 0.5, connectivity)
    pair = postproc_kernel.component_slots_tiled(lg, lab, 64)
    for key in pair:
        assert torch.equal(out[key], pair[key]), key
    ref = torch.from_numpy(_uncapped_labels(lg[..., 0].cpu().numpy(), connectivity)).to(dev)
    slots = postproc_kernel.component_slots_reference(lg, ref, 64)
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], slots[key]), key


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("kind", ["spiral", "checker", "full"])
@pytest.mark.parametrize("B,blocks", [(1, 16), (12, 8), (24, 4), (40, 2)])
def test_geometry_compat_at_every_cluster_on_adversarial_maps(dev, kind, connectivity, B, blocks):
    """K12c at each cluster size its plan takes (16, 8, 4 and 2 blocks an
    image, by the batch's size) on the adversarial maps of the large K12c's
    test at 192x256 (a spiral through every band's seam, the
    checkerboard, full), K=16: its components are scipy's (the slot map of
    the uncapped labels), and its eight outputs K2's after K1 bit for bit."""
    H, W, K = 192, 256, 16
    lg = _head_logits(_large_map(kind, B, H, W), 17, 5, dev)
    plan = postproc_kernel.launch_plan(lg, H, W, K, 17)
    assert plan.blocks == blocks, plan
    out = postproc_kernel.geometry_compat(lg, K, connectivity=connectivity)
    ref = torch.from_numpy(_uncapped_labels(lg[..., 0].cpu().numpy(), connectivity)).to(dev)
    slots = postproc_kernel.component_slots_reference(lg, ref, K)
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], slots[key]), key
    pair = postproc_kernel.component_slots(
        lg, ccl_kernel.ccl_labels_from_logits(lg[..., 0].contiguous(), 0.5, connectivity), K)
    for key in pair:
        assert torch.equal(out[key], pair[key]), key


@pytest.mark.parametrize("B", [1, 4, 9, 17, 34, 64])
def test_slot_plan_is_the_c_mirrors(dev, B):
    """The plan the wrappers launch is ``slot_plan_ints``' (csrc/geometry.cuh
    slot_plan) for the card's SMs and room, at the main path's 128² maps
    and the packed route's 256², f32 and bf16; a cluster past two blocks
    keeps every image on the card at once."""
    import ctypes

    lib = _build.load("postproc_kernel", postproc_kernel._FUNCS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for H, W in ((128, 128), (256, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            lg = torch.empty((B, H, W, 17), dtype=dtype, device=dev)
            plan = postproc_kernel.launch_plan(lg, H, W, 16, 17)
            room = postproc_kernel.cluster_room(dev.index or 0, H, W, 16, 17,
                                                dtype == torch.bfloat16)
            arr = (ctypes.c_int * 3)(*(room[g] for g in postproc_kernel.SLOT_BLOCKS))
            out = (ctypes.c_int * 2)()
            assert lib.slot_plan_ints(B, plan.sets, sms, arr, out) == 0
            assert tuple(out) == (plan.blocks, plan.sets)
            if plan.blocks > 2:
                assert plan.blocks * B <= sms and B <= room[plan.blocks]


# ---- the tiled kernels' plan edges (ops/cuda/postproc_kernel.py tiled_plan) ----

_PLAN_EDGE_SHAPES = [(2, 257, 513), (1, 1023, 257), (3, 5, 4099), (2, 61, 33), (1, 300, 1000)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("shape", _PLAN_EDGE_SHAPES)
def test_tiled_kernels_on_band_chunk_and_segment_edges(dev, shape, K, dtype):
    """The tiled CCL, the tiled slots and the large K12c where the plan's
    work items end mid-map: heights no multiple of a pass band's rows or a
    CCL tile's, widths one past a pass segment or a tile, raster chunks
    that end mid-row, maps a few rows tall, components that cross the bands
    and the segments (snakes and blobs).  Labels are scipy's; slot outputs
    and areas identical to the plain version's; the means within 2e-6 of
    the f64 sums (bf16: plus the rounding-boundary slack); the large K12c
    bit for bit the pair."""
    B, H, W = shape
    lg = _head_logits(_maps(H * 7 + W, B, H, W), 17, K, dev).to(getattr(torch, dtype))
    det = lg[..., 0].contiguous()
    ref_lab = torch.from_numpy(_uncapped_labels(det.float().cpu().numpy(), 8)).to(dev)
    lab = ccl_kernel.ccl_labels_tiled(det)
    assert torch.equal(lab, ref_lab)
    out = postproc_kernel.component_slots_tiled(lg, lab, K)
    ref = postproc_kernel.component_slots_reference(lg, lab, K)
    exact = _stats_f64(lg, ref["slots"], K)
    if dtype == "bfloat16":
        assert_bf16_stats_close(out, ref, lg, K, exact=exact)
    else:
        for key in _SLOT_KEYS:
            assert torch.equal(out[key], ref[key]), key
        area = ref["areas"].clamp(min=1).double()
        torch.testing.assert_close(out["det_sums"] / area, exact["det_sums"] / area, atol=2e-6,
                                   rtol=0)
        torch.testing.assert_close(out["cls_sums"] / area[..., None],
                                   exact["cls_sums"] / area[..., None], atol=2e-6, rtol=0)
    large = postproc_kernel.geometry_compat_large(lg, K)
    for key in out:
        assert torch.equal(large[key], out[key]), key


def test_slots_tiled_band_extremes_in_device_memory(dev):
    """K=1600 slots of 33 channels: one warp's stats partial set beside the
    roots fits shared memory, the band's extremes beside it do not, so the
    plan keeps them in a device-memory slice of their own (``ext_smem``
    0).  Isolated pixels on every other row and column give more than K
    components (and chunks of more than K roots); the slot outputs and areas
    equal the plain version's, the means are within 2e-6 of the f64 sums,
    and the large K12c equals the pair bit for bit."""
    B, H, W, K, C = 1, 64, 700, 1600, 33
    plan = postproc_kernel.tiled_plan(B, H, W, K, C)
    assert plan.ext_smem == 0 and plan.pass_warps == 1
    dots = np.full((B, H, W), -4.0, np.float32)
    dots[:, ::2, ::2] = 4.0
    lg = _head_logits(dots, C, 3, dev)
    lab = ccl_kernel.ccl_labels_tiled(lg[..., 0].contiguous())
    out = postproc_kernel.component_slots_tiled(lg, lab, K)
    ref = postproc_kernel.component_slots_reference(lg, lab, K)
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], ref[key]), key
    assert int(ref["num_components_total"][0]) > K
    exact = _stats_f64(lg, ref["slots"], K)
    area = ref["areas"].clamp(min=1).double()
    torch.testing.assert_close(out["det_sums"] / area, exact["det_sums"] / area, atol=2e-6, rtol=0)
    torch.testing.assert_close(out["cls_sums"] / area[..., None],
                               exact["cls_sums"] / area[..., None], atol=2e-6, rtol=0)
    large = postproc_kernel.geometry_compat_large(lg, K)
    for key in out:
        assert torch.equal(large[key], out[key]), key


# ---- bf16 logits (the bf16 route's trunk output) ----

_BF16_SHAPES = [(3, 128, 128, 16), (3, 256, 64, 16), (2, 512, 512, 64),
                *((*m, 16) for m in _FEW_MAPS)]


def _bf16_head_logits(shape, layout, dev):
    """bf16 (B, H, W, 17) logits over blob, noise and snake detection maps:
    the NHWC view over (B, 17, H, W) planes, or channels-last storage (what
    cuDNN's bf16 head may write)."""
    B, H, W, K = shape
    lg = _head_logits(_maps(H + K, B, H, W), 17, K, dev).to(torch.bfloat16)
    return lg.contiguous() if layout == "channels_last" else lg


def _bf16_cls_slack(lg: torch.Tensor, slots: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K, C-1): per slot and class, the most the sum of the bf16-rounded
    class probabilities can move when the kernel's f32 softmax differs from
    torch's by a few ulps (expf against torch's exp, another order of the
    denominator's sum): the bf16 step at every probability of the slot that
    lies within 8 f32 ulps of a bf16 rounding boundary."""
    B, H, W, C = lg.shape
    sm = torch.softmax(lg[..., 1:].float(), -1)
    step = (sm * (1 + 8 * 2.0**-24)).bfloat16().float() - (sm * (1 - 8 * 2.0**-24)).bfloat16().float()
    onehot = (slots.view(B, 1, H * W) == torch.arange(K, device=lg.device).view(1, K, 1)).float()
    return torch.bmm(onehot, step.reshape(B, H * W, C - 1))


def assert_bf16_stats_close(out: dict, ref: dict, lg: torch.Tensor, K: int, exact=None) -> float:
    """Slot outputs and areas identical; det_sums / areas within 2e-6 (the
    sigmoid is not rounded); cls_sums / areas within 2e-6 plus the slack of
    probabilities at a bf16 rounding boundary (``_bf16_cls_slack``) over
    the area, of the plain version or of ``exact`` (``_stats_f64``).
    Returns the largest cls error past 2e-6 in bf16 steps a pixel."""
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], ref[key]), key
    want = ref if exact is None else exact
    area = ref["areas"].clamp(min=1).to(want["det_sums"].dtype)
    torch.testing.assert_close(out["det_sums"] / area, want["det_sums"] / area, atol=2e-6, rtol=0)
    err = (out["cls_sums"] / area[..., None] - want["cls_sums"] / area[..., None]).abs()
    slack = _bf16_cls_slack(lg, ref["slots"], K).to(err.dtype) / area[..., None]
    assert bool((err <= 2e-6 + slack).all()), float((err - slack).max())
    return float((err - 2e-6).clamp(min=0).max())


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("shape", _BF16_SHAPES)
def test_bf16_ccl_matches_plain(dev, shape, connectivity):
    """K1 (one block a map) and the device-memory K1 on bf16 detection
    logits: labels identical to the plain version's and to the kernels' on
    the f32 copy of the same logits; the router takes the bf16 kernels
    (``launches_bf16``) and no f32 one."""
    B, H, W, K = shape
    lg = torch.from_numpy(_maps(H + K, B, H, W)).to(dev).to(torch.bfloat16)
    ref = ccl_kernel.ccl_labels_reference(lg, 0.5, connectivity)
    assert torch.equal(ccl_kernel.ccl_labels_tiled(lg, 0.5, connectivity), ref)
    for f in (ccl_kernel.ccl_labels_tiled, ccl_kernel.ccl_labels_from_logits):
        f.launches = f.launches_bf16 = 0
    routed = ccl_kernel.ccl_labels_from_logits(lg, 0.5, connectivity)
    assert torch.equal(routed, ref)
    assert torch.equal(routed, ccl_kernel.ccl_labels_from_logits(lg.float(), 0.5, connectivity))
    big = H * W * 4 > ccl_kernel.MAX_SHARED_BYTES
    tiled, one = ccl_kernel.ccl_labels_tiled, ccl_kernel.ccl_labels_from_logits
    assert (tiled.launches_bf16, one.launches_bf16) == ((1, 0) if big else (0, 1))
    assert (tiled.launches, one.launches) == ((1, 0) if big else (0, 1))  # the f32 copy's


@pytest.mark.parametrize("layout", ["planes", "channels_last"])
@pytest.mark.parametrize("shape", _BF16_SHAPES)
def test_bf16_slots_match_plain_and_compat(dev, shape, layout):
    """K2 (the cluster kernel where K12c fits, else the tiled one) and the
    tiled K2 on bf16 logits, at 128², the tall 256x64 map and a 512² map
    with K=64: slot outputs and areas identical to the plain version's and
    to the kernels' on the f32 copy of the logits; means within the bounds
    of ``assert_bf16_stats_close`` (the large map's against the sums in
    f64); two launches bit for bit; K12c, where it runs, equal to K2 bit for
    bit on bf16 too."""
    B, H, W, K = shape
    lg = _bf16_head_logits(shape, layout, dev)
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0])
    fits = postproc_kernel.geometry_compat_fits(H, W, K, 17)
    for f in (postproc_kernel.component_slots, postproc_kernel.component_slots_tiled):
        f.launches = f.launches_bf16 = 0
    out = postproc_kernel.component_slots(lg, lab, K)
    assert (postproc_kernel.component_slots.launches_bf16,
            postproc_kernel.component_slots_tiled.launches_bf16) == ((1, 0) if fits else (0, 1))
    ref = postproc_kernel.component_slots_reference(lg, lab, K)
    exact = None if fits and (B, H, W) not in _FEW_MAPS else _stats_f64(lg, ref["slots"], K)
    assert_bf16_stats_close(out, ref, lg, K, exact)
    again = postproc_kernel.component_slots(lg, lab, K)
    for key in out:
        assert torch.equal(out[key], again[key]), key
    f32 = postproc_kernel.component_slots(lg.float(), lab, K)
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], f32[key]), key
    tiled = postproc_kernel.component_slots_tiled(lg, lab, K)
    assert_bf16_stats_close(tiled, ref, lg, K, _stats_f64(lg, ref["slots"], K))
    if fits:
        fused = postproc_kernel.geometry_compat(lg, K)
        assert postproc_kernel.geometry_compat.launches_bf16 >= 1
        for key in out:
            assert torch.equal(fused[key], out[key]), key
    assert postproc_kernel.component_slots.launches == int(fits)  # the f32 copy's launch


def test_bf16_wrappers_raise_where_f32_ones_do(dev):
    """No route falls back to another: on bf16 logits the stats kernels one
    channel past their register chunk serve the logits as on f32 (within
    the bounds of ``assert_bf16_stats_close``); K12c past its shared memory
    launches its large bf16 kernel, as on f32, equal to the bf16 tiled pair
    bit for bit."""
    big = torch.from_numpy(_maps(3, 1, 400, 300)).to(dev).to(torch.bfloat16)
    postproc_kernel.geometry_compat_large.launches_bf16 = 0
    fused = postproc_kernel.geometry_compat(big, 16)
    assert postproc_kernel.geometry_compat_large.launches_bf16 == 1
    pair = postproc_kernel.component_slots_tiled(big, ccl_kernel.ccl_labels_tiled(big), 16)
    for key in pair:
        assert torch.equal(fused[key], pair[key]), key
    wide = postproc_kernel.REGISTER_CHANNELS + 1
    lg = _head_logits(_maps(wide, 1, 8, 8), wide, wide, dev).to(torch.bfloat16)
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0])
    ref = postproc_kernel.component_slots_reference(lg, lab, 4)
    for call in (lambda: postproc_kernel.component_slots(lg, lab, 4),
                 lambda: postproc_kernel.component_slots_tiled(lg, lab, 4),
                 lambda: postproc_kernel.geometry_compat(lg, 4)):
        assert_bf16_stats_close(call(), ref, lg, 4, _stats_f64(lg, ref["slots"], 4))
    with pytest.raises(TypeError, match="bfloat16"):
        ccl_kernel.ccl_labels_from_logits(big.half())


def _assert_bf16_route_matches(out, ref, lg_out, lg_ref, logit_ulps=4):
    """A bf16 route on the card against the same route on the CPU (cuDNN
    and oneDNN sum in other orders, so one bf16 rounding may differ): logits
    within ``logit_ulps`` bf16 ulps of max|logit|; a pixel may change sides
    of the threshold only within that tolerance of it, and an image where
    one did is left out; elsewhere valid, areas, counts identical, classes
    where the top two mean probabilities are more than 1e-2 apart, scores
    within 1e-3, class probabilities within 1e-2, boxes within 1.5 px as
    corner sets (tests/test_torch_bf16.py's tolerances)."""
    out = {k: v.cpu().numpy() for k, v in out.items()}
    ref = {k: v.numpy() for k, v in ref.items()}
    lo, lr = lg_out.cpu().numpy(), lg_ref.numpy()
    tol = logit_ulps * 2.0**-8 * np.abs(lr).max()
    assert np.abs(lo - lr).max() <= tol
    flipped = (lo[..., 0] > 0) != (lr[..., 0] > 0)
    assert (np.abs(lr[..., 0][flipped]) <= tol).all()
    keep = ~flipped.reshape(len(lo), -1).any(1)
    assert keep.any()
    for key in ("valid", "areas", "num_detections", "num_components_total"):
        np.testing.assert_array_equal(out[key][keep], ref[key][keep], err_msg=key)
    v = ref["valid"][keep]
    assert v.any()
    srt = np.sort(ref["class_probs"][keep], -1)
    sure = v & (srt[..., -1] - srt[..., -2] > 1e-2)
    np.testing.assert_array_equal(out["classes"][keep][sure], ref["classes"][keep][sure])
    np.testing.assert_allclose(out["scores"][keep][v], ref["scores"][keep][v], atol=1e-3)
    np.testing.assert_allclose(out["class_probs"][keep][v], ref["class_probs"][keep][v], atol=1e-2)
    perms = np.array(list(permutations(range(4))))
    d = np.linalg.norm(out["boxes"][keep][v][:, :, None] - ref["boxes"][keep][v][:, None], axis=-1)
    assert (d[:, np.arange(4), perms].max(-1).min(-1) <= 1.5).all()


@pytest.mark.parametrize("asset,case", [
    ("pretrained_synthetic", "fused"), ("pretrained_synthetic", "xla"),
    ("pretrained_synthetic", "strips"), ("pretrained_synthetic", "preprocessed"),
    ("pretrained_dense_synthetic", "fused"),
])
def test_bf16_entry_points_on_card_match_cpu(dev, asset, case):
    """The bf16 mode's batch entry points on the card (the weights cast to
    bf16, as bench.py does) against the same calls on the CPU: the fused
    route (bf16 stem and dense-equivalent context, the bf16 CCL and slots
    kernels; K4 not launched), ``fused=False`` (BarcodeFCN in bf16, f32
    logits, the f32 kernels), ``n_strips=2`` on 576x128 scenes,
    ``detect_preprocessed_batch``, and a dense config (BarcodeFCN on the
    fused postprocessing).  The returned logits are f32."""
    from pathlib import Path

    from ubdvss_tpu_torch import (
        detect_preprocessed_batch,
        detect_program_batch,
        load_net_config,
        load_params_npz,
        params_from_flat,
    )
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / f"{asset}.npz"
    cfg = load_net_config(path).replace(dtype="bfloat16", max_components=16)
    params = {k: v.to(torch.bfloat16) for k, v in params_from_flat(load_params_npz(path)).items()}
    hw = (576, 128) if case == "strips" else (128, 128)
    reader = SyntheticMarkupReader(n_samples=4, image_hw=hw, seed=31)
    imgs = np.stack([reader.sample_at(i).image for i in range(4)])
    context_kernel.fused_context_head.launches = 0
    for f in (ccl_kernel.ccl_labels_from_logits, postproc_kernel.component_slots):
        f.launches = f.launches_bf16 = 0
    if case == "preprocessed":
        x = (imgs.astype(np.float32) * np.float32(1 / 127.5) - 1.0)[..., None]
        out, lg = detect_preprocessed_batch(params, x, cfg, device=dev)
        ref, lg_ref = detect_preprocessed_batch(params, x, cfg, fused=True, device="cpu")
    else:
        # fused=None is the fused route on the card and the XLA route on
        # the CPU, so the CPU's call names its route
        kw = {"xla": dict(fused=False), "strips": dict(n_strips=2)}.get(case, {})
        out, lg = detect_program_batch(params, imgs, cfg, hw, device=dev, **kw)
        ref, lg_ref = detect_program_batch(params, imgs, cfg, hw, device="cpu",
                                           **{"fused": True, **kw})
    assert lg.dtype == lg_ref.dtype == torch.float32
    assert context_kernel.fused_context_head.launches == 0
    bf16_trunk = cfg.separable_context and case != "xla"
    assert ccl_kernel.ccl_labels_from_logits.launches_bf16 == int(bf16_trunk)
    assert postproc_kernel.component_slots.launches_bf16 == int(bf16_trunk)
    assert ccl_kernel.ccl_labels_from_logits.launches == int(not bf16_trunk)
    assert int(ref["num_detections"].sum()) > 0
    _assert_bf16_route_matches(out, ref, lg, lg_ref)



# the int8 trunk's kernels: (kernel, input shape, input kind, cout,
# dilation, head outputs).  qstem takes the image (layer 0 to cout, then
# layer 1 to cout); qconv an int8 NHWC map, 3x3 stride 1; qconv_head that
# and a 1x1 head.  The main path's layer shapes at B=2, odd sizes, ragged
# tile edges, dilation 16 on 128² and on the stream's 60x80, saturation
# (at 24 channels |acc| = 3,483,864; at 32, "sat-wide", 4,645,152, past the
# epilogue's conversion-free window), zeros, one image, a 1024² map and a
# 4096² image, other widths.
_QCONV_CASES = {
    "layer0-u8-512": ("qstem", (2, 512, 512), "u8", 24, 1, 0),
    "layer0-f32raw-odd": ("qstem", (2, 75, 101), "f32raw", 24, 1, 0),  # 38x51, then 19x26
    "layer0-norm-qvga": ("qstem", (2, 240, 320), "norm", 24, 1, 0),
    "stem1-256": ("qstem", (2, 512, 512), "f32raw", 24, 1, 0),
    "stem1-odd": ("qstem", (2, 73, 105), "u8", 24, 1, 0),  # layer 1 on 37x53
    "stem-one-image": ("qstem", (1, 512, 512), "u8", 24, 1, 0),
    "stem-4096": ("qstem", (1, 4096, 4096), "u8", 24, 1, 0),
    "stem-zeros": ("qstem", (1, 160, 96), "norm-zeros", 24, 1, 0),
    "context-d1": ("qconv", (2, 128, 128, 24), "int8", 24, 1, 0),
    "context-d2": ("qconv", (2, 128, 128, 24), "int8", 24, 2, 0),
    "context-d8": ("qconv", (2, 128, 128, 24), "int8", 24, 8, 0),
    "context-d16": ("qconv", (2, 128, 128, 24), "int8", 24, 16, 0),
    "context-qvga": ("qconv", (2, 60, 80, 24), "int8", 24, 4, 0),
    "context-qvga-d16": ("qconv", (2, 60, 80, 24), "int8", 24, 16, 0),
    "ragged-33x47": ("qconv", (2, 33, 47, 24), "int8", 24, 1, 0),
    "ragged-19x26": ("qconv", (2, 19, 26, 24), "int8", 24, 4, 0),
    "map-1024-d16": ("qconv", (1, 1024, 1024, 24), "int8", 24, 16, 0),
    "saturated-requant": ("qconv", (2, 40, 40, 24), "sat", 24, 1, 0),
    "zeros": ("qconv", (1, 40, 40, 24), "zeros", 24, 2, 0),
    "one-image": ("qconv", (1, 128, 128, 24), "int8", 24, 16, 0),
    "widths-4-to-8": ("qconv", (2, 50, 30, 4), "int8", 8, 3, 0),
    "widths-32-to-32": ("qstem", (2, 100, 60), "u8", 32, 1, 0),
    "widths-16-to-12": ("qconv", (2, 50, 30, 16), "int8", 12, 1, 0),
    "head-17": ("qconv_head", (2, 128, 128, 24), "int8", 24, 1, 17),
    "logits-3x3": ("qconv_head", (1, 33, 47, 24), "int8", 24, 2, 17),
    "saturated": ("qconv_head", (2, 40, 40, 24), "sat", 24, 1, 17),
    "head-qvga-d16": ("qconv_head", (2, 60, 80, 24), "int8", 24, 16, 17),
    "head-ragged-19x26": ("qconv_head", (2, 19, 26, 24), "int8", 24, 1, 17),
    "head-one-image": ("qconv_head", (1, 128, 128, 24), "int8", 24, 1, 17),
    "head-1024": ("qconv_head", (1, 1024, 1024, 24), "int8", 24, 1, 17),
    "head-narrow": ("qconv_head", (2, 19, 26, 8), "int8", 8, 2, 5),
    "head-widths-32": ("qconv_head", (1, 33, 47, 32), "int8", 32, 16, 32),
    "saturated-32": ("qconv", (2, 40, 40, 32), "sat-wide", 32, 1, 0),
    "saturated-32-head": ("qconv_head", (2, 40, 40, 32), "sat-wide", 32, 1, 17),
    "stem-saturated-32": ("qstem", (2, 100, 76), "sat-wide", 32, 1, 0),
}


def _qconv_layer(rng, ks, cin, cout, dev, sat=None):
    q = rng.integers(-127, 128, (ks, ks, cin, cout)).astype(np.int8)
    ws = rng.uniform(1e-4, 2e-3, cout).astype(np.float32)
    b = rng.normal(0, 0.5, cout).astype(np.float32)
    if sat == "signs":
        q[:] = np.where(rng.random(q.shape) < 0.5, -127, 127)
    elif sat == "ones":  # every weight 127: |acc| = 9 * Cin * 127^2
        q[:] = 127
    elif sat == "extreme":  # +-127 by output channel, ws of that sign mapping 9 Cin 127^2 to 40
        sign = np.where(np.arange(cout) % 2 == 0, 1, -1)
        q[:] = (127 * sign).astype(np.int8)
        ws = (np.float32(40.0 / (ks * ks * cin * 127**2)) * sign).astype(np.float32)
        b[:] = 0
    layer = dict(q=q, ws=ws, b=b)
    return {k: torch.from_numpy(v).to(dev) for k, v in layer.items()}


def _qconv_call(case, dev):
    """(wrapper, its arguments, plain version) of a case."""
    fn_name, shape, kind, cout, dil, nh = _QCONV_CASES[case]
    rng = np.random.default_rng(len(case) + 7 * cout)
    scale = lambda c: torch.from_numpy(rng.uniform(5, 60, c).astype(np.float32)).to(dev)  # noqa: E731
    if fn_name == "qstem" and kind == "sat-wide":
        # raw 255 quantizes to 127; layer 0 (every weight 127, ws 1/127) puts
        # 127 at every pixel of its map, layer 1 reaches 9 * 32 * 127^2
        img = torch.full(shape, 255, dtype=torch.uint8, device=dev)
        l0 = dict(q=torch.full((3, 3, 1, cout), 127, dtype=torch.int8, device=dev),
                  ws=torch.full((cout,), 1 / 127, device=dev), b=torch.zeros(cout, device=dev))
        ones = torch.ones(cout, device=dev)
        args = (img, l0, ones, _qconv_layer(rng, 3, cout, cout, dev, sat="extreme"), ones, True)
        return qconv_kernel.qstem, args, qconv_kernel.qstem_reference
    if fn_name == "qstem":
        if kind == "u8":
            x = rng.integers(0, 256, shape).astype(np.uint8)
        elif kind == "f32raw":
            x = rng.uniform(0, 255, shape).astype(np.float32)
        elif kind == "norm":
            x = rng.uniform(-1.05, 1.05, shape + (1,)).astype(np.float32)
        else:  # normalized zeros quantize to int8 0
            x = np.zeros(shape + (1,), np.float32)
        args = (torch.from_numpy(x).to(dev), _qconv_layer(rng, 3, 1, cout, dev), scale(cout),
                _qconv_layer(rng, 3, cout, cout, dev), scale(cout), kind in ("u8", "f32raw"))
        return qconv_kernel.qstem, args, qconv_kernel.qstem_reference
    cin = shape[3]
    if kind in ("sat", "sat-wide"):  # |acc| = 9 * Cin * 127^2 inside
        x = np.full(shape, 127, np.int8)
        x[1] = -127
    elif kind == "zeros":
        x = np.zeros(shape, np.int8)
    else:
        x = rng.integers(-127, 128, shape).astype(np.int8)
    x = torch.from_numpy(x).to(dev)
    sat = {"sat": "ones" if fn_name == "qconv_head" else "signs", "sat-wide": "extreme"}.get(kind)
    layer = _qconv_layer(rng, 3, cin, cout, dev, sat=sat)
    s_out = torch.ones(cout, device=dev) if kind == "sat-wide" else scale(cout)
    if fn_name == "qconv":
        return qconv_kernel.qconv, (x, layer, s_out, dil), _qconv_plain
    args = (x, layer, s_out, dil, _qconv_layer(rng, 1, cout, nh, dev))
    return qconv_kernel.qconv_head, args, qconv_kernel.qconv_head_reference


def _qconv_plain(x, layer, s_out, dil):
    return qconv_kernel.qconv_reference(x, layer, s_out, 1, dil)


def _to_cpu(a):
    if torch.is_tensor(a):
        return a.cpu()
    if isinstance(a, dict):
        return {k: v.cpu() for k, v in a.items()}
    return a


@pytest.mark.parametrize("case", sorted(_QCONV_CASES))
def test_qconv_kernel_matches_plain_bit_for_bit(dev, case):
    """The int8 trunk's kernels (qstem, qconv, qconv_head) == their plain
    versions on the card (f64 convs with cuDNN off, the epilogue rounded
    once) and on the CPU, bit for bit, int8 activations and f32 logits
    alike; one launch of the case's kernel and none of the others."""
    fn, args, plain = _qconv_call(case, dev)
    kernels = (qconv_kernel.qstem, qconv_kernel.qconv, qconv_kernel.qconv_head)
    for f in kernels:
        f.launches = 0
    out = fn(*args)
    torch.cuda.synchronize()
    assert [f.launches for f in kernels] == [int(f is fn) for f in kernels]
    ref = plain(*args)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out, ref)
    if case in ("saturated", "saturated-requant"):
        assert ref.abs().max() > 0
    if _QCONV_CASES[case][2] == "sat-wide" and fn is not qconv_kernel.qconv_head:
        assert bool((out[0, 1:-1, 1:-1] == 40).all())  # both signs' accumulators exact
    assert torch.equal(out.cpu(), plain(*(_to_cpu(a) for a in args)))


@pytest.mark.parametrize("cin,cout", [(6, 24), (36, 24), (24, 36), (24, 17)])
def test_qconv_channel_caps_name_their_roadmap_item(dev, cin, cout):
    """The widths that were qconv's channel caps (ROADMAP.md §2a): a count
    that is not a multiple of 4 (padded inside the wrapper) or past 32 (the
    any-width kernel) == the plain version bit for bit, on the card and on
    the CPU."""
    rng = np.random.default_rng(cin * 100 + cout)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 8, 8, cin)).astype(np.int8)).to(dev)
    layer = _qconv_layer(rng, 3, cin, cout, dev)
    s_out = torch.from_numpy(rng.uniform(5, 60, cout).astype(np.float32)).to(dev)
    out = qconv_kernel.qconv(x, layer, s_out, 1)
    ref = _qconv_plain(x, layer, s_out, 1)
    assert out.shape == (1, 8, 8, cout) and torch.equal(out, ref)
    assert torch.equal(out.cpu(), _qconv_plain(x.cpu(), _to_cpu(layer), s_out.cpu(), 1))


# qconv_layer (the bias correction's single layers: qconv_layer_f32, then
# requantize for int8 out): (input shape, input kind, kernel size, cout,
# stride, dilation, int8 out).  Layer 0 on the normalized image, the
# stride-2 layer, the dilated context layers and the head, f32
# pre-activations and requantized outputs, odd sizes, 32 channels saturated
# (|acc| = 4,645,152).
_QLAYER_CASES = {
    "layer0-f32": ((4, 75, 101), "norm", 3, 24, 2, 1, False),
    "layer0-int8": ((4, 64, 64), "norm", 3, 24, 2, 1, True),
    "stride2-f32": ((4, 38, 51, 24), "int8", 3, 24, 2, 1, False),
    "stride2-int8": ((4, 64, 64, 24), "int8", 3, 24, 2, 1, True),
    "context-d16-f32": ((4, 32, 32, 24), "int8", 3, 24, 1, 16, False),
    "context-d4-int8": ((2, 19, 26, 24), "int8", 3, 24, 1, 4, True),
    "head-f32": ((4, 32, 32, 24), "int8", 1, 17, 1, 1, False),
    "saturated-32-f32": ((2, 20, 20, 32), "sat", 3, 32, 1, 1, False),
    "saturated-32-int8": ((2, 20, 20, 32), "sat", 3, 32, 1, 1, True),
}


@pytest.mark.parametrize("case", sorted(_QLAYER_CASES))
def test_qconv_layer_matches_plain_bit_for_bit(dev, case):
    """The bias correction's layer (qconv_layer_f32, then for int8 out
    requantize with the layer's bias) == qconv_reference on the card and on
    the CPU, bit for bit, f32 pre-activations and int8 outputs alike: one
    launch of the layer's tensor-core kernel (qlayer0_tc for layer 0,
    qconv_tc_f32 for the others), whose accumulators equal
    qconv_acc_reference's, and for int8 out one requantize launch."""
    shape, kind, ks, cout, stride, dil, requant = _QLAYER_CASES[case]
    rng = np.random.default_rng(len(case) + cout)
    if kind == "norm":
        x = rng.uniform(-1.05, 1.05, shape + (1,)).astype(np.float32)
        cin = 1
    elif kind == "sat":
        x = np.full(shape, 127, np.int8)
        x[1] = -127
        cin = shape[3]
    else:
        x = rng.integers(-127, 128, shape).astype(np.int8)
        cin = shape[3]
    x = torch.from_numpy(x).to(dev)
    layer = _qconv_layer(rng, ks, cin, cout, dev, sat="extreme" if kind == "sat" else None)
    s_out = torch.from_numpy(rng.uniform(5, 60, cout).astype(np.float32)).to(dev) if requant else None
    qconv_kernel.qconv_layer_f32.launches = qconv_kernel.requantize.launches = 0
    out, acc = qconv_kernel.qconv_layer_f32(x, layer, stride, dil, with_acc=requant)
    if requant:
        out = qconv_kernel.requantize(acc, layer["ws"], layer["b"], s_out)
    torch.cuda.synchronize()
    assert qconv_kernel.qconv_layer_f32.launches == 1
    assert qconv_kernel.requantize.launches == int(requant)
    y, acc = qconv_kernel.qconv_layer_f32(x, layer, stride, dil)
    assert torch.equal(acc, qconv_kernel.qconv_acc_reference(x, layer, stride, dil))
    assert torch.equal(y, qconv_kernel.qconv_reference(x, layer, None, stride, dil))
    ref = qconv_kernel.qconv_reference(x, layer, s_out, stride, dil)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.equal(out, ref)
    if kind == "sat" and not requant:  # the interior pre-activations: acc_max * ws = 40
        assert float((out[0, 1:-1, 1:-1] - 40).abs().max()) < 1e-4
    cpu = qconv_kernel.qconv_reference(*(_to_cpu(a) for a in (x, layer, s_out)), stride, dil)
    assert torch.equal(out.cpu(), cpu)


def test_bias_correction_on_card_matches_host_cpu(dev):
    """A whole bias_correct_qparams on the card (one qconv_layer_f32 a layer
    and the head, one requantize a layer) against the host CPU's on the same
    qparams and calibration images: weights and scales untouched, the
    corrected biases within chip_smoke.check_qparams' 1e-3 (the f32
    reference convs sum in another order on the card; the int8 walk is
    exact)."""
    from pathlib import Path

    from ubdvss_tpu_torch import load_net_config, load_params_npz, params_from_flat
    from ubdvss_tpu_torch.ops.quant import (
        bias_correct_qparams,
        build_qparams,
        calibrate_scales,
        qparams_to,
    )
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(path)
    params = params_from_flat(load_params_npz(path))
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(256, 192), seed=43)
    imgs = np.stack([reader.sample_at(i).image for i in range(4)])
    calib = torch.from_numpy((imgs.astype(np.float32) / 127.5 - 1.0)[..., None])
    q = build_qparams(params, cfg, calibrate_scales(params, cfg, calib))
    host = bias_correct_qparams(q, params, cfg, calib)
    qconv_kernel.qconv_layer_f32.launches = qconv_kernel.requantize.launches = 0
    card = bias_correct_qparams(qparams_to(q, dev), {k: v.to(dev) for k, v in params.items()},
                                cfg, calib.to(dev))
    torch.cuda.synchronize()
    n = 2 + len(cfg.dilations)
    assert (qconv_kernel.qconv_layer_f32.launches, qconv_kernel.requantize.launches) == (n + 1, n)
    card = qparams_to(card, "cpu")
    for a, b in zip(card["layers"] + [card["head"]], host["layers"] + [host["head"]]):
        assert torch.equal(a["q"], b["q"]) and torch.equal(a["ws"], b["ws"])
        assert float((a["b"] - b["b"]).abs().max()) <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(card["s_in"], host["s_in"]))


@pytest.mark.parametrize("kernel,c0,c1,nh", [("qstem", 6, 24, 0), ("qstem", 24, 36, 0),
                                             ("qstem", 36, 24, 0), ("qconv_head", 6, 24, 17),
                                             ("qconv_head", 24, 36, 17), ("qconv_head", 24, 24, 33)])
def test_qstem_and_qconv_head_past_their_old_caps_bit_for_bit(dev, kernel, c0, c1, nh):
    """The widths that were once qstem's and qconv_head's channel caps ==
    the plain versions bit for bit: a count padded to a multiple of 4
    inside the wrapper, widths past 32 and a head of 33 logits through the
    any-width kernels."""
    rng = np.random.default_rng(c0 * 1000 + c1 * 10 + nh)
    scale = lambda c: torch.from_numpy(rng.uniform(5, 60, c).astype(np.float32)).to(dev)  # noqa: E731
    if kernel == "qstem":
        img = torch.from_numpy(rng.integers(0, 256, (1, 32, 32)).astype(np.uint8)).to(dev)
        args = (img, _qconv_layer(rng, 3, 1, c0, dev), scale(c0), _qconv_layer(rng, 3, c0, c1, dev),
                scale(c1), True)
        fn, plain = qconv_kernel.qstem, qconv_kernel.qstem_reference
    else:
        x = torch.from_numpy(rng.integers(-127, 128, (1, 8, 8, c0)).astype(np.int8)).to(dev)
        args = (x, _qconv_layer(rng, 3, c0, c1, dev), scale(c1), 1, _qconv_layer(rng, 1, c1, nh, dev))
        fn, plain = qconv_kernel.qconv_head, qconv_kernel.qconv_head_reference
    out = fn(*args)
    assert torch.equal(out, plain(*args))
    assert torch.equal(out.cpu(), plain(*(_to_cpu(a) for a in args)))


def test_int8_entry_points_on_card_match_cpu(dev):
    """The int8 route on the card against the CPU with the same qparams
    (calibrated on the card, the bias correction through qconv_layer_f32
    and requantize):
    int8_trunk_apply eight launches (qstem once,
    qconv once a context layer but the last, qconv_head once) and no
    context-kernel launch, logits bit for bit; detect_program_batch fused
    and fused=False, BarcodeDetector.detect and the stream: masks, areas,
    classes and counts identical, scores within 1e-5, boxes within 1e-3 as
    corner sets."""
    from pathlib import Path

    from ubdvss_tpu_torch import (
        BarcodeDetector,
        StreamingDetector,
        detect_program_batch,
        load_net_config,
        load_params_npz,
        params_from_flat,
    )
    from ubdvss_tpu_torch.ops.quant import int8_trunk_apply, qparams_to, quantize_trunk
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    path = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(path).replace(max_components=16)
    params = params_from_flat(load_params_npz(path))
    reader = SyntheticMarkupReader(n_samples=6, image_hw=(128, 160), seed=41)
    imgs = np.stack([reader.sample_at(i).image for i in range(6)])
    calib = torch.from_numpy((imgs.astype(np.float32) / 127.5 - 1.0)[..., None]).to(dev)
    kernels = (qconv_kernel.qstem, qconv_kernel.qconv, qconv_kernel.qconv_head)
    for f in (*kernels, qconv_kernel.qconv_layer_f32, qconv_kernel.requantize):
        f.launches = 0
    q = quantize_trunk({k: v.to(dev) for k, v in params.items()}, cfg, calib)
    # the bias correction: one convolution a layer and the head (its f32
    # pre-activation and accumulator), one requantization a layer
    assert qconv_kernel.qconv_layer_f32.launches == 2 + len(cfg.dilations) + 1
    assert qconv_kernel.requantize.launches == 2 + len(cfg.dilations)
    assert [f.launches for f in kernels] == [0, 0, 0]
    q_cpu = qparams_to(q, "cpu")
    context_kernel.fused_context_head.launches = 0
    lg = int8_trunk_apply(q, torch.from_numpy(imgs).to(dev), cfg, raw_gray=True)
    assert [f.launches for f in kernels] == [1, len(cfg.dilations) - 1, 1]
    assert context_kernel.fused_context_head.launches == 0
    assert torch.equal(lg.cpu(), int8_trunk_apply(q_cpu, torch.from_numpy(imgs), cfg, raw_gray=True))
    perms = np.array(list(permutations(range(4))))

    def same(o, r):
        o = {k: np.asarray(v.cpu() if torch.is_tensor(v) else v) for k, v in o.items()}
        r = {k: np.asarray(v) for k, v in r.items()}
        for key in ("valid", "areas", "classes", "num_detections", "num_components_total"):
            np.testing.assert_array_equal(o[key], r[key], err_msg=key)
        np.testing.assert_allclose(o["scores"], r["scores"], atol=1e-5)
        v = r["valid"]
        d = np.linalg.norm(o["boxes"][v][:, :, None] - r["boxes"][v][:, None], axis=-1)
        assert (d[:, np.arange(4), perms].max(-1).min(-1) <= 1e-3).all()

    for fused in (True, False):
        out, lg = detect_program_batch(params, imgs, cfg, (128, 160), qparams=q, fused=fused, device=dev)
        ref, lg_ref = detect_program_batch(params, imgs, cfg, (128, 160), qparams=q_cpu, fused=fused,
                                           device="cpu")
        assert torch.equal(lg.cpu(), lg_ref) and int(ref["num_detections"].sum()) > 0
        same(out, ref)
    dets = BarcodeDetector(cfg, params, qparams=q, device=dev).detect(imgs[0])
    ref_dets = BarcodeDetector(cfg, params, qparams=q_cpu, device="cpu").detect(imgs[0])
    assert len(dets) == len(ref_dets) > 0
    for o, r in zip(dets, ref_dets):
        assert (o.class_id, o.area) == (r.class_id, r.area) and abs(o.score - r.score) < 1e-5
    out = list(StreamingDetector(cfg, params, (128, 160), 4, qparams=q, device=dev).process(imgs))
    ref = list(StreamingDetector(cfg, params, (128, 160), 4, qparams=q_cpu, device="cpu").process(imgs))
    for (_, o), (_, r) in zip(out, ref):
        same(o, r)


# -- the packed route's modes: K4's and qconv_head's phase-major stores, K2
# and K12c reading phase-major logits (each against its plain version: the
# same kernel's unpacked launch, packed by ``_s2d``) ---------------------------


@pytest.mark.parametrize("C,O", [(24, 17), (8, 1), (16, 17), (32, 32)])
@pytest.mark.parametrize("hw", [(128, 128), (38, 54)])
def test_context_kernel_packed_store(dev, C, O, hw):
    """The packed store writes _s2d of the unpacked launch's logits, bit
    for bit (the same arithmetic, another address), counted once a call in
    ``launches_packed``; an odd map is refused."""
    rng = np.random.default_rng(C + hw[1])
    dil = (1, 2, 4)
    L = len(dil)
    x = torch.from_numpy(rng.normal(0, 1, (3, C, *hw)).astype(np.float32)).to(dev)
    w = [torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).to(dev)
         for s, shape in ((0.3, (L, 9, C, 1, 1)), (0.3, (L, C, C)), (0.1, (L, C, 1, 1)),
                          (0.3, (O, C)), (0.1, (O, 1, 1)))]
    f = context_kernel.fused_context_head
    f.launches = f.launches_packed = 0
    out = f(x, *w, dil)
    packed = f(x, *w, dil, packed=True)
    assert (f.launches, f.launches_packed) == (2 * L, 1)
    assert packed.shape == (3, 4 * O, hw[0] // 2, hw[1] // 2)
    assert torch.equal(packed.permute(0, 2, 3, 1), context_kernel._s2d(out.permute(0, 2, 3, 1)))
    with pytest.raises(ValueError):
        f(x[..., :-1].contiguous(), *w, dil, packed=True)


def test_qconv_head_packed_store(dev):
    """qconv_head's packed store == _s2d of its unpacked launch and == the
    plain packed version, bit for bit, at the asset's widths (24 channels,
    17 logits) on a map whose rows end in a partial run."""
    rng = np.random.default_rng(3)
    cin, cout, nh = 24, 24, 17
    layer = {"q": torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8)),
             "ws": torch.from_numpy(rng.uniform(1e-4, 3e-4, cout).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))}
    head = {"q": torch.from_numpy(rng.integers(-127, 128, (1, 1, cout, nh), dtype=np.int8)),
            "ws": torch.from_numpy(rng.uniform(1e-3, 2e-3, nh).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(0, 0.1, nh).astype(np.float32))}
    s_out = torch.from_numpy(rng.uniform(20, 40, cout).astype(np.float32))
    x = torch.from_numpy(rng.integers(-127, 128, (2, 40, 150, cin), dtype=np.int8))
    to = lambda d: {k: v.to(dev) for k, v in d.items()}  # noqa: E731
    f = qconv_kernel.qconv_head
    f.launches = f.launches_packed = 0
    args = (x.to(dev), to(layer), s_out.to(dev), 4, to(head))
    out = f(*args)
    packed = f(*args, packed=True)
    assert (f.launches, f.launches_packed) == (2, 1)
    assert packed.shape == (2, 20, 75, 4 * nh)
    assert torch.equal(packed, context_kernel._s2d(out))
    assert torch.equal(packed.cpu(), qconv_kernel.qconv_head_reference(
        x, layer, s_out, 4, head, packed=True))


def _packed_logits(lg: torch.Tensor, layout: str) -> torch.Tensor:
    """Phase-major packed logits of (B, H, W, C) ``lg``: as the NHWC view
    of K4's packed (B, 4C, H/2, W/2) planes, or contiguous NHWC (the bf16
    route's ``_s2d`` copy)."""
    p = context_kernel._s2d(lg)
    return p.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) if layout == "planes" else \
        p.contiguous()


_PACKED_SHAPES = [(8, 512, 512, 64), (3, 128, 128, 16), (4, 38, 54, 16),
                  *((*m, 16) for m in _FEW_MAPS)]


@pytest.mark.parametrize("layout", ["planes", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _PACKED_SHAPES)
def test_slots_read_phase_major_logits(dev, shape, dtype, layout):
    """K2 (the cluster kernel where K12c fits, the tiled one past it) on
    phase-major logits == the same kernel on the unpacked logits: slots,
    extremes, counts and areas bit for bit, the stats' means within 2e-6
    (the pass walks the same pixel order, so they come out equal too); and
    the plain version's geometry.  Counted in ``launches_packed``."""
    B, H, W, K = shape
    lg = _head_logits(_maps(H + K, B, H, W), 17, K, dev).to(getattr(torch, dtype))
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0].float())
    pk = _packed_logits(lg, layout)
    tiled = not postproc_kernel.geometry_compat_fits(H, W, K, 17)
    f = postproc_kernel.component_slots_tiled if tiled else postproc_kernel.component_slots
    f.launches_packed = 0
    ref = postproc_kernel.component_slots(lg, lab, K)
    out = postproc_kernel.component_slots(pk, lab, K, packed_phases=(2, 2))
    assert f.launches_packed == 1
    assert_stats_close(out, ref)
    plain = postproc_kernel.component_slots_reference(pk, lab, K, packed_phases=(2, 2))
    for key in _SLOT_KEYS:
        assert torch.equal(out[key], plain[key]), key


@pytest.mark.parametrize("layout", ["planes", "nhwc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _PACKED_SHAPES)
def test_geometry_compat_reads_phase_major_logits(dev, shape, dtype, layout):
    """K12c (the cluster kernel, or the large one past it) on phase-major
    logits == the same kernel on the unpacked logits, and its eight outputs
    == CCL then K2 on the packed logits, as on unpacked ones."""
    B, H, W, K = shape
    lg = _head_logits(_maps(H + 2 * K, B, H, W), 17, K, dev).to(getattr(torch, dtype))
    pk = _packed_logits(lg, layout)
    large = not postproc_kernel.geometry_compat_fits(H, W, K, 17)
    f = postproc_kernel.geometry_compat_large if large else postproc_kernel.geometry_compat
    f.launches_packed = 0
    ref = postproc_kernel.geometry_compat(lg, K)
    out = postproc_kernel.geometry_compat(pk, K, packed_phases=(2, 2))
    assert f.launches_packed == 1
    assert_stats_close(out, ref)
    lab = ccl_kernel.ccl_labels_from_logits(lg[..., 0].contiguous())
    pair = postproc_kernel.component_slots(pk, lab, K, packed_phases=(2, 2))
    for key in out:
        assert torch.equal(out[key], pair[key]), key


@pytest.mark.parametrize("name", ["component_slots", "component_slots_tiled", "geometry_compat",
                                  "geometry_compat_large"])
def test_packed_entry_points_with_no_phase_are_the_unpacked_ones(dev, name):
    """An unpacked launch is what it was: the ``_packed`` entry point with
    zero phase strides (s = m = 0 in geometry.cuh's pixel_offset) gives the
    unpacked entry point's eight outputs bit for bit, on the main path's
    NHWC view over planes."""
    B, H, W, K = (3, 128, 128, 16) if "large" not in name else (2, 512, 512, 64)
    lg = _head_logits(_maps(7, B, H, W), 17, 5, dev)
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0])
    fn = getattr(postproc_kernel, name)
    args = (lg, K) if name.startswith("geometry") else (lg, lab, K)
    ref = fn(*args)
    real = postproc_kernel._strides
    zero = lambda lg_, C, pp, n: (n + "_packed" + postproc_kernel.LOGIT_DTYPES[lg_.dtype],  # noqa: E731
                                  tuple(lg_.stride()) + (0, 0))
    postproc_kernel._strides = zero
    try:
        out = fn(*args)
    finally:
        postproc_kernel._strides = real
    for key in ref:
        assert torch.equal(out[key], ref[key]), key


def test_packed_route_on_card_matches_whole_image_route(dev):
    """detect_program_batch's packed route (the f32 trunk with K4's packed
    store, K2 reading it) at 1024² == n_strips=1's whole-image route on the
    card: logits bit for bit, detections identical; int8 too."""
    from pathlib import Path

    from ubdvss_tpu_torch import detect_program_batch, load_net_config, load_params_npz
    from ubdvss_tpu_torch import params_from_flat
    from ubdvss_tpu_torch.ops.quant import int8_trunk_apply, quantize_trunk
    from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    asset = Path(__file__).resolve().parents[1] / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(asset)
    params = params_from_flat(load_params_npz(asset))
    imgs = np.stack([SyntheticMarkupReader(n_samples=2, image_hw=(1024, 1024), seed=5)
                     .sample_at(i).image for i in range(2)])
    f = context_kernel.fused_context_head
    f.launches_packed = 0
    res, lg = detect_program_batch(params, imgs, cfg, (1024, 1024), device=dev)
    assert f.launches_packed == 1
    res1, lg1 = detect_program_batch(params, imgs, cfg, (1024, 1024), n_strips=1, device=dev)
    assert f.launches_packed == 1
    assert torch.equal(lg, lg1) and int(res["num_detections"].sum()) > 0
    for k in res:
        torch.testing.assert_close(res[k], res1[k], atol=1e-6, rtol=0, msg=k)
    calib = torch.from_numpy((imgs[:1].astype(np.float32) / 127.5 - 1.0)[..., None]).to(dev)
    q = quantize_trunk({k: v.to(dev) for k, v in params.items()}, cfg, calib)
    qconv_kernel.qconv_head.launches_packed = 0
    res8, lg8 = detect_program_batch(params, imgs, cfg, (1024, 1024), qparams=q, device=dev)
    assert qconv_kernel.qconv_head.launches_packed == 1
    direct = int8_trunk_apply(q, torch.from_numpy(imgs).to(dev), cfg, raw_gray=True)
    assert torch.equal(lg8, direct)
    ref8 = postprocess_batch_fused(direct, cfg)
    for k in res8:
        torch.testing.assert_close(res8[k], ref8[k], atol=1e-6, rtol=0, msg=k)


# ---- every width the JAX package serves (no channel caps) -------------------


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("O", [1, 33, 41])
@pytest.mark.parametrize("C", [1, 3, 4, 10, 12, 20, 31, 33, 40, 48, 64, 96, 160])
def test_context_kernel_any_width_matches_plain(dev, C, O, packed):
    """K4 at widths no compiled instance has: C up to 32 as the register
    kernel compiled for C (1, 3, 4, 10, 12, 20, 31; "narrow"), 33 to 128 as
    the tile (33, 40, 48, 64, 96), past it each pixel's columns in shared
    memory (160), heads of 1, 33 and 41 outputs, dilations 1, 2, 16 and 17:
    one launch a layer, within logit_bar of the plain version, on an odd
    37x53 map (unpacked; the tile's rows cross the map's, its last tile is
    partial and its stores scalar) and on 38x54 (packed, a row of W = 2
    mod 4 stored a pixel at a time): the packed store == the unpacked
    launch's phase-major planes bit for bit."""
    rng = np.random.default_rng(C * 100 + O)
    dil = (1, 2, 16, 17)
    L = len(dil)
    assert context_kernel.kernel_instance(C, O) == (
        "narrow" if C <= 32 else "wide" if C <= 128 else "wide_columns")
    H, W = (38, 54) if packed else (37, 53)
    x = torch.from_numpy(rng.normal(0, 1, (2, C, H, W)).astype(np.float32)).to(dev)
    w = [torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).to(dev)
         for s, shape in ((0.3, (L, 9, C, 1, 1)), (0.3 / np.sqrt(C / 8), (L, C, C)),
                          (0.1, (L, C, 1, 1)), (0.3, (O, C)), (0.1, (O, 1, 1)))]
    f = context_kernel.fused_context_head
    f.launches = f.launches_packed = 0
    out = f(x, *w, dil, packed=packed)
    assert (f.launches, f.launches_packed) == (L, int(packed))
    with context_kernel.exact_f32():
        ref = context_kernel.context_head_reference(x, *w, dil)
    if packed:
        assert torch.equal(out, context_kernel._s2d_planes(f(x, *w, dil)))
        ref = context_kernel._s2d_planes(ref)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, atol=logit_bar(ref), rtol=0)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [2, 5, 16, 18, 25, 33, 34, 41, 65, 97])
def test_stats_every_guarded_bound_match_plain(dev, C, dtype, packed):
    """The stats at the guarded bounds off the exact 1 and 17 channels (2
    and 5, 16, 18 and 25, 33, 34 and 41, 65: the ends of the bounds 5, 16,
    25, 33, 41 and 65, the bound that holds each from
    ``stats_channel_bound``; 97: three class passes of 40 classes), f32 and
    bf16, unpacked and phase-major:
    K2's cluster kernel against the plain version, K12c equal to it bit for
    bit, the tiled K2 against the sums in f64; and on a map past K12c's
    shared memory the large K12c equal to the tiled pair bit for bit."""
    B, H, W, K = 3, 64, 48, 16
    assert postproc_kernel.stats_channel_bound(C) not in postproc_kernel.STATS_EXACT
    lg = _head_logits(_maps(C, B, H, W), C, C, dev).to(getattr(torch, dtype))
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0].float())
    phases = (2, 2) if packed else None
    src = _packed_logits(lg, "planes") if packed else lg
    close = (assert_stats_close if dtype == "float32" else
             lambda o, r: assert_bf16_stats_close(o, r, lg, K))
    ref = postproc_kernel.component_slots_reference(lg, lab, K)
    assert postproc_kernel.geometry_compat_fits(H, W, K, C)
    out = postproc_kernel.component_slots(src, lab, K, packed_phases=phases)
    close(out, ref)
    fused = postproc_kernel.geometry_compat(src, K, packed_phases=phases)
    for key in out:
        assert torch.equal(fused[key], out[key]), key
    tiled = postproc_kernel.component_slots_tiled(src, lab, K, packed_phases=phases)
    if dtype == "float32":
        exact = _stats_f64(lg, ref["slots"], K)
        for key in _SLOT_KEYS:
            assert torch.equal(tiled[key], ref[key]), key
        area = ref["areas"].clamp(min=1).double()
        torch.testing.assert_close(tiled["cls_sums"].double() / area[..., None],
                                   exact["cls_sums"] / area[..., None], atol=2e-6, rtol=0)
    else:
        assert_bf16_stats_close(tiled, ref, lg, K, _stats_f64(lg, ref["slots"], K))
    big = _head_logits(_maps(C + 1, 1, 400, 300), C, C, dev).to(getattr(torch, dtype))
    big_src = _packed_logits(big, "planes") if packed else big
    large = postproc_kernel.geometry_compat_large
    large.launches = large.launches_bf16 = 0
    fused = postproc_kernel.geometry_compat(big_src, 16, packed_phases=phases)
    assert large.launches + large.launches_bf16 == 1
    pair = postproc_kernel.component_slots_tiled(
        big_src, ccl_kernel.ccl_labels_tiled(big[..., 0].contiguous()), 16, packed_phases=phases)
    for key in pair:
        assert torch.equal(fused[key], pair[key]), key


def test_stats_channel_bound_mirrors_the_kernels(dev):
    """stats_channel_bound, the Python mirror of the kernels' instance
    choice, returns the kernels' own (the C entry point, csrc/geometry.cuh
    with_channel_bound) at every logit count up to 200."""
    lib = _build.load("postproc_kernel", postproc_kernel._FUNCS)
    for C in range(1, 201):
        assert lib.stats_channel_bound(C) == postproc_kernel.stats_channel_bound(C), C


def test_stats_partial_set_past_shared_memory_names_it(dev):
    """The one width the stats kernels refuse: one warp's partial set,
    K (C + 1) words, past one block's shared memory."""
    C = postproc_kernel.MAX_SHARED_BYTES // (4 * 64)
    lg = torch.zeros((1, 8, 8, C), device=dev)
    lab = ccl_kernel.ccl_labels_reference(lg[..., 0])
    with pytest.raises(NotImplementedError, match="shared memory"):
        postproc_kernel.component_slots(lg, lab, 64)


# int8 at every width: (kernel, cin or c0, cout or c1, head outputs, dilation)
_QWIDTH_CASES = [(k, c, c, nh, d) for c in (6, 10, 36, 48) for k, nh, d in (
    ("qstem", 0, 1), ("qconv", 0, 2), ("qconv_head", 17, 1), ("qconv_head", 41, 16))]
_QWIDTH_CASES += [("qconv", 128, 8, 0, 1), ("qconv", 48, 64, 0, 4), ("qconv_head", 10, 48, 41, 2),
                  ("qstem", 10, 48, 0, 1), ("qstem", 48, 10, 0, 1)]
# the any-width conv's one-pass groups (40: five n8 tiles, 64: eight) and
# their staged stores, on a map whose runs end mid-row (50 columns)
_QWIDTH_CASES += [(k, c, c, nh, d) for c in (40, 64) for k, nh, d in (
    ("qconv", 0, 1), ("qconv", 0, 16), ("qconv_head", 41, 2), ("qconv_head", 33, 17))]
# the any-width stem's one pass and staged runs (40, 64) and its stores from
# the registers past one pass (68), on layer-1 maps whose runs end mid-row
# (25 columns), every input kind
_QWIDTH_CASES += [("qstem", c, c, 0, 1) for c in (40, 64)] + [("qstem", 36, 68, 0, 1)]


@pytest.mark.parametrize("kernel,c0,c1,nh,dil", _QWIDTH_CASES)
def test_int8_kernels_any_width_bit_for_bit(dev, kernel, c0, c1, nh, dil):
    """qstem (a uint8, an f32 raw and a normalized image), qconv and
    qconv_head (unpacked and packed) at widths that are
    not a multiple of 4 (padded inside the wrappers; no padded channel
    reaches the output) and past 32 (the any-width kernels: 128 input
    channels take the rounding conversion, acc_wide 2) == the plain
    versions bit for bit, on the card and on the CPU."""
    rng = np.random.default_rng(c0 * 1000 + c1 * 10 + nh + dil)
    scale = lambda c: torch.from_numpy(rng.uniform(5, 60, c).astype(np.float32)).to(dev)  # noqa: E731
    if kernel == "qstem":
        img = torch.from_numpy(rng.integers(0, 256, (2, 76, 100)).astype(np.uint8)).to(dev)
        layers = (_qconv_layer(rng, 3, 1, c0, dev), scale(c0), _qconv_layer(rng, 3, c0, c1, dev),
                  scale(c1))
        norm = torch.from_numpy(rng.uniform(-1.05, 1.05, (2, 76, 100, 1)).astype(np.float32)).to(dev)
        fns = [(qconv_kernel.qstem, qconv_kernel.qstem_reference, (x, *layers, raw))
               for x, raw in ((img, True), (img.float(), True), (norm, False))]
    else:
        x = torch.from_numpy(rng.integers(-127, 128, (2, 38, 50, c0)).astype(np.int8)).to(dev)
        layer = _qconv_layer(rng, 3, c0, c1, dev)
        if kernel == "qconv":
            fns = [(qconv_kernel.qconv, _qconv_plain, (x, layer, scale(c1), dil))]
        else:
            args = (x, layer, scale(c1), dil, _qconv_layer(rng, 1, c1, nh, dev))
            fns = [(qconv_kernel.qconv_head, qconv_kernel.qconv_head_reference, args)]
            packed = lambda *a: qconv_kernel.qconv_head(*a, packed=True)  # noqa: E731
            plain = lambda *a: qconv_kernel.qconv_head_reference(*a, packed=True)  # noqa: E731
            fns.append((packed, plain, args))
    for fn, plain, args in fns:
        out = fn(*args)
        assert torch.equal(out, plain(*args))
        assert torch.equal(out.cpu(), plain(*(_to_cpu(a) for a in args)))


@pytest.mark.parametrize("cin,cout,ks,stride,dil", [
    (6, 6, 3, 2, 1), (10, 10, 3, 1, 4), (36, 36, 3, 1, 2), (48, 48, 3, 2, 1), (48, 41, 1, 1, 1),
    (10, 17, 1, 1, 1), (128, 8, 3, 1, 1), (128, 41, 1, 1, 1), (1, 10, 3, 2, 1), (1, 48, 3, 2, 1),
    (1, 64, 3, 2, 1), (1, 33, 3, 2, 1)])
def test_int8_calibration_kinds_any_width_bit_for_bit(dev, cin, cout, ks, stride, dil):
    """The bias correction's kinds at any width: qconv_layer_f32 (layer 0
    from the image, its runs staged, at even and odd counts past 32; a
    3x3 layer at stride 1 or 2, the 1x1 head; Cin padded
    to a multiple of 4, f32 outputs of any count), with and without the
    accumulator, and requantize at any
    channel count == the plain versions bit for bit: pre-activations,
    accumulators (rounded to nearest even past 2^24 at 128 channels) and
    the int8 outputs."""
    rng = np.random.default_rng(cin * 100 + cout + ks)
    if cin == 1:
        x = torch.from_numpy(rng.uniform(-1.05, 1.05, (2, 76, 100, 1)).astype(np.float32)).to(dev)
    else:
        x = torch.from_numpy(rng.integers(-127, 128, (2, 38, 50, cin)).astype(np.int8)).to(dev)
    layer = _qconv_layer(rng, ks, cin, cout, dev)
    y, acc = qconv_kernel.qconv_layer_f32(x, layer, stride, dil)
    y_ref, acc_ref = qconv_kernel.qconv_layer_f32(x.cpu(), _to_cpu(layer), stride, dil)
    assert torch.equal(y.cpu(), y_ref) and torch.equal(acc.cpu(), acc_ref)
    y_only, none = qconv_kernel.qconv_layer_f32(x, layer, stride, dil, with_acc=False)
    assert none is None and torch.equal(y_only.cpu(), y_ref)
    s_out = torch.from_numpy(rng.uniform(5, 60, cout).astype(np.float32)).to(dev)
    q8 = qconv_kernel.requantize(acc, layer["ws"], layer["b"], s_out)
    assert torch.equal(q8.cpu(), qconv_kernel.requantize_reference(
        acc_ref, layer["ws"].cpu(), layer["b"].cpu(), s_out.cpu()))


@pytest.mark.parametrize("C,O", [(10, 17), (48, 41)])
def test_int8_trunk_any_width_matches_cpu(dev, C, O):
    """quantize_trunk on the card and int8_trunk_apply at the narrow and
    wide configurations' widths: the trunk's eight launches at the padded
    widths, logits bit for bit the CPU's on the same qparams, and the
    qparams in the JAX package's shapes (no padded channel in them)."""
    from ubdvss_tpu_torch import NetConfig
    from ubdvss_tpu_torch.models.model import init_params
    from ubdvss_tpu_torch.ops import quant

    cfg = NetConfig(channels=C, class_names=tuple(f"s{i}" for i in range(O - 1)))
    params = {k: v.to(dev) for k, v in init_params(cfg, 3).items()}
    rng = np.random.default_rng(C)
    calib = torch.from_numpy(rng.uniform(-1, 1, (4, 128, 128, 1)).astype(np.float32)).to(dev)
    q = quant.quantize_trunk(params, cfg, calib)
    assert [layer["q"].shape[3] for layer in q["layers"]] == [C] * (2 + len(cfg.dilations))
    assert tuple(q["head"]["q"].shape) == (1, 1, C, O)
    img = torch.from_numpy(rng.integers(0, 256, (2, 256, 256)).astype(np.uint8)).to(dev)
    for f in (qconv_kernel.qstem, qconv_kernel.qconv, qconv_kernel.qconv_head):
        f.launches = 0
    out = quant.int8_trunk_apply(q, img, cfg, raw_gray=True)
    assert [f.launches for f in (qconv_kernel.qstem, qconv_kernel.qconv,
                                 qconv_kernel.qconv_head)] == [1, len(cfg.dilations) - 1, 1]
    qc = {"layers": [_to_cpu(layer) for layer in q["layers"]], "head": _to_cpu(q["head"]),
          "s_in": [s.cpu() for s in q["s_in"]]}
    assert out.shape == (2, 64, 64, O)
    assert torch.equal(out.cpu(), quant.int8_trunk_apply(qc, img.cpu(), cfg, raw_gray=True))

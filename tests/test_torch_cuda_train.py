"""PyTorch port: training on the card against the same calls on the host
CPU — the context kernel's gradient, one train step (f32 and bf16), the
augmented train batches, the resumed step and the Trainer; and device-fed
training: the scene synthesis on the card against the host CPU on the same
draws, the windowed rasterizer against the dense one, fused against
unfused training.

Marked ``cuda``; every test skips without a card.  On the H100 (no jax
there, so without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py -q

Tolerances: the gradients of ``fused_model_apply`` (the context kernel
forward, the plain backward) against ``BarcodeFCN``'s on the card within
1e-3 absolute plus 1e-4 relative (the JAX package's bar for its Pallas
kernel's gradients); a train step on the card against the host CPU at
``tests/test_torch_train.py``'s tolerances against JAX (f32: parameters
2e-7, losses and grad_norm 1e-6 relative; bf16: parameters 1e-5, except
that up to 1% of them may lie 2 lr apart — Adam's first step is about
lr * sign(grad), and a gradient inside bf16's rounding noise may take the
other sign on the card — losses 1e-3 relative (a quarter of a bf16 ulp:
each logit is a bf16 value, and cuDNN's run-dependent summation order can
move one by an ulp; 8.8e-5 was seen), grad_norm 2e-2 relative, pixel
metrics 2e-3); a resumed step bit for bit with cuDNN's deterministic
algorithms.  Device-fed: the card's render of the host's draws within
1e-3 a pixel (texel flips at most 1 in 10^4 window pixels) and 1e-4 a
polygon vertex, vertex counts and classes identical, and the segmaps of
every image whose grid polygons agree identical; the windowed rasterizer
bit for bit the dense one; fused and unfused training, and the cache
against ``Batches``, within 2e-6 (the JAX package's bar) under cuDNN's
deterministic algorithms.
"""

import functools
from pathlib import Path

import pytest
import torch

from ubdvss_tpu_torch import load_net_config, load_params_npz, params_from_flat
from ubdvss_tpu_torch import synthgen
from ubdvss_tpu_torch.data import Batches, DataConfig, DeviceCachedBatches, finalize_batch
from ubdvss_tpu_torch.models.model import compute_precision, get_model
from ubdvss_tpu_torch.ops.cuda import context_kernel
from ubdvss_tpu_torch.ops.augment import AugmentConfig, affine_draws, affine_from_draws
from ubdvss_tpu_torch.ops.quant import normalize_fma
from ubdvss_tpu_torch.ops.rasterize import polygons_to_grid, rasterize_polygons, rasterize_polygons_windowed
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.train import Trainer, create_train_state, train_step
from ubdvss_tpu_torch.utils.checkpoint import CheckpointManager

pytestmark = pytest.mark.cuda

ASSET = Path(__file__).resolve().parent.parent / "assets" / "pretrained_synthetic.npz"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _asset():
    return load_net_config(ASSET), params_from_flat(load_params_npz(ASSET))


def _batch(n=4, hw=128, augment=True):
    cfg, _ = _asset()
    reader = SyntheticMarkupReader(n_samples=n, image_hw=(hw, hw), seed=7)
    dc = DataConfig(batch_size=n, train_hw=(hw, hw), seed=0)
    if not augment:
        dc = DataConfig(batch_size=n, train_hw=(hw, hw), augment=None)
    return next(iter(Batches(reader, cfg, dc, train=True, device="cpu").epoch(0)))


def test_fused_model_apply_gradient_on_the_card(dev):
    cfg, params = _asset()
    x = _batch()["images"].to(dev)
    r = torch.randn((x.shape[0], 32, 32, cfg.n_output_channels), generator=torch.Generator().manual_seed(1))
    r = r.to(dev)
    a = {k: v.to(dev).requires_grad_() for k, v in params.items()}
    model = get_model(cfg).to(dev)
    model.load_state_dict(params)
    context_kernel.fused_context_head.launches = 0
    with compute_precision(cfg):
        (context_kernel.fused_model_apply(a, x, cfg) * r).sum().backward()
        (model(x) * r).sum().backward()
    assert context_kernel.fused_context_head.launches == len(cfg.dilations)
    for name, p in model.named_parameters():
        torch.testing.assert_close(a[name].grad, p.grad, atol=1e-3, rtol=1e-4, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_card_equals_host_cpu(dev, dtype):
    cfg0, params = _asset()
    cfg = cfg0.replace(dtype=dtype)
    batch = _batch(n=8, hw=512)  # chip_smoke.py's step check: pixel metrics over 131,072 logits
    sc, mc = train_step(create_train_state(cfg, device=dev, params=params),
                        {k: v.to(dev) for k, v in batch.items()}, cfg)
    sh, mh = train_step(create_train_state(cfg, device="cpu", params=params), batch, cfg)
    p_tol, rel, g_rel = (2e-7, 1e-6, 1e-6) if dtype == "float32" else (1e-5, 1e-3, 2e-2)
    diff = torch.cat([(sc.params[k].detach().cpu() - v.detach()).abs().ravel() for k, v in sh.params.items()])
    if dtype == "float32":
        assert float(diff.max()) <= p_tol
    else:
        # Adam's first step is about lr * sign(grad): a bf16 gradient inside
        # the rounding noise may take the other sign on the card (cuDNN's
        # backward sums in a run-dependent order), putting its parameter
        # 2 lr away
        assert int((diff > p_tol).sum()) <= 0.01 * diff.numel() and float(diff.max()) <= 2e-3 + 1e-6
    for k, v in mh.items():
        a, b = float(mc[k]), float(v)
        if k.startswith("pixel_"):
            assert a == b if dtype == "float32" else abs(a - b) <= 2e-3, (k, a, b)
        else:
            assert abs(a - b) <= (g_rel if k == "grad_norm" else rel) * abs(b) + 1e-7, (k, a, b)


def test_augmented_batches_on_the_card(dev):
    cfg, _ = _asset()
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(128, 128), seed=3)
    b = Batches(reader, cfg, DataConfig(batch_size=2, train_hw=(128, 128), seed=1), train=True, device=dev)
    e0, again, e1 = list(b.epoch(0)), list(b.epoch(0)), list(b.epoch(1))
    for x, y, z in zip(e0, again, e1):
        assert x["images"].device.type == "cuda" and x["images"].shape == (2, 128, 128, 1)
        assert torch.equal(x["images"], y["images"]) and torch.equal(x["segmap"], y["segmap"])
        assert not torch.equal(x["images"], z["images"])
        # the normalize rounds x * (1/127.5) - 1 once, as the JAX package's
        # jitted batch step: 255 maps to 1 + 2^-23
        assert bool(torch.isfinite(x["images"]).all())
        assert float(x["images"].abs().max()) <= float(normalize_fma(torch.tensor(255.0)))


def test_resume_bitexact_on_the_card(dev, tmp_path):
    cfg, _ = _asset()
    batch = {k: v.to(dev) for k, v in _batch(augment=False).items()}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state = create_train_state(cfg, device=dev)
        for _ in range(3):
            state, _ = train_step(state, batch, cfg)
        CheckpointManager(tmp_path).save(3, state)
        restored = CheckpointManager(tmp_path).restore(create_train_state(cfg, seed=5, device=dev))
        s1, m1 = train_step(state, batch, cfg)
        s2, m2 = train_step(restored, batch, cfg)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert restored.step == 4
    assert all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)
    assert float(m1["loss"]) == float(m2["loss"])


def test_trainer_fit_on_the_card(dev, tmp_path):
    cfg, _ = _asset()
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(64, 64), seed=2)
    dc = DataConfig(batch_size=2, train_hw=(64, 64))
    tr = Trainer(cfg, dc, logdir=str(tmp_path), device=dev)
    tr.fit(Batches(reader, cfg, dc, train=True, device=dev), 2,
           Batches(reader, cfg, DataConfig(batch_size=2, train_hw=(64, 64), augment=None), train=False,
                   device=dev))
    assert tr.state.step == 4 and tr.state.device.type == "cuda"
    assert CheckpointManager(tmp_path / "checkpoints").latest_step() == 4
    assert tr.best_ckpt.best_step() in (2, 4)
    assert all(v.device.type == "cpu" for v in tr.export_params().values())


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
def test_render_on_the_card_equals_host_cpu(dev, affine):
    cfg, _ = _asset()
    sc = synthgen.SynthConfig(hw=(256, 256), max_polys=8)
    g = torch.Generator().manual_seed(3)
    draws = synthgen.scene_draws(g, sc, 16)
    acfg = AugmentConfig()
    m = affine_from_draws(affine_draws(g, acfg, 16), acfg, sc.hw) if affine else None
    host = synthgen.render_scenes(draws, sc, affine=m)
    card = synthgen.render_scenes({k: v.to(dev) for k, v in draws.items()}, sc,
                                  affine=None if m is None else m.to(dev))
    card = [t.cpu() for t in card]
    assert torch.equal(card[2], host[2]) and torch.equal(card[3], host[3])
    torch.testing.assert_close(card[1], host[1], rtol=0, atol=1e-4)
    flips = int(((card[0] - host[0]).abs() > 1e-3).sum())
    assert flips <= 1e-4 * int((host[2] > 0).sum()) * 128 * 128, flips
    dc = DataConfig(batch_size=16, train_hw=sc.hw, raster_window=synthgen.synth_raster_window(sc, cfg))
    seg_h = finalize_batch(*host, cfg, dc)["segmap"]
    seg_c = finalize_batch(*[t.to(dev) for t in card], cfg, dc)["segmap"].cpu()
    same_grid = (polygons_to_grid(card[1], cfg.scale) == polygons_to_grid(host[1], cfg.scale)).flatten(1).all(1)
    assert int(same_grid.sum()) >= 15
    assert torch.equal(seg_c[same_grid], seg_h[same_grid])


def test_windowed_rasterizer_on_the_card(dev):
    rng = torch.Generator().manual_seed(0)
    B, P, V, H, W, wn = 32, 8, 6, 128, 128, 40
    ang = torch.sort(torch.rand((B, P, V), generator=rng) * 6.283, dim=2).values
    r = 2 + torch.rand((B, P, V), generator=rng) * (wn - 5) / 2
    c = 2 + torch.rand((B, P, 1, 2), generator=rng) * (H - 4)
    polys = torch.clamp(torch.round(c + torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1)), 0, H - 1)
    nv = torch.randint(0, V + 1, (B, P), generator=rng)
    cid = torch.randint(1, 17, (B, P), generator=rng)
    args = [t.to(dev) for t in (polys, nv, cid)]
    win = rasterize_polygons_windowed(*args, (H, W), wn)
    assert torch.equal(win, rasterize_polygons(*args, (H, W)))
    assert torch.equal(win.cpu(), rasterize_polygons_windowed(polys, nv, cid, (H, W), wn))


def _same_params(a, b):
    for k, v in b.params.items():
        torch.testing.assert_close(a.params[k], v, rtol=0, atol=2e-6, msg=k)


def test_fused_equals_unfused_on_the_card(dev):
    cfg = load_net_config(ASSET)
    dc = DataConfig(batch_size=4, train_hw=(128, 128), seed=3)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        syn = synthgen.DeviceSyntheticBatches(cfg, dc, n_samples=12, seed=5, device=dev)
        reader = SyntheticMarkupReader(n_samples=12, image_hw=(128, 128), seed=9)
        cached = DeviceCachedBatches(reader, cfg, dc, device=dev)
        for batches, manual_src in ((syn, syn), (cached, Batches(reader, cfg, dc, device=dev))):
            state = create_train_state(cfg, device=dev)
            for epoch in range(2):
                for batch in manual_src.epoch(epoch):
                    state, _ = train_step(state, batch, cfg)
            for spd in (1, 4):
                tr = Trainer(cfg, dc, steps_per_dispatch=spd, device=dev)
                tr.fit(batches, 2)
                assert tr.state.step == state.step == 6
                _same_params(tr.state, state)
    finally:
        torch.backends.cudnn.deterministic = prev


def test_cls_weight_ramp_on_the_card(dev):
    """The ramp's weight is a 0-d host tensor (no copy to the card inside
    the step): the card's step with it equals the host CPU's."""
    cfg, params = _asset()
    batch = _batch(n=4, hw=128)
    sched = (cfg.classification_loss_weight, 2.0, 10.0)
    sc, mc = train_step(create_train_state(cfg, device=dev, params=params),
                        {k: v.to(dev) for k, v in batch.items()}, cfg, sched)
    sh, mh = train_step(create_train_state(cfg, device="cpu", params=params), batch, cfg, sched)
    assert float(mc["cls_weight"]) == float(mh["cls_weight"])
    assert abs(float(mc["loss"]) - float(mh["loss"])) <= 1e-6 * abs(float(mh["loss"])) + 1e-7

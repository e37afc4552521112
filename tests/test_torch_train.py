"""PyTorch port: training (``train.py``, ``models/model.py``'s
``init_params`` / ``train_apply``, the context kernel's gradient and
``utils/checkpoint.py``) against the JAX package on the CPU, at 8
channels, dilations (1, 2), 32²–64² images and batch 2.

Tolerances:
  * the gradients of ``fused_model_apply`` (the context kernel's autograd
    function) against ``jax.grad`` of the flax module on the same weights:
    2e-6 absolute plus 1e-5 relative (f32 convs summed in another order);
  * one ``train_step`` in f32: the parameters after Adam within 2e-7
    absolute (the update is lr x m/(sqrt(v)+eps), about lr = 1e-3 a
    parameter; optax and torch.optim order that quotient differently),
    the loss, its parts and ``grad_norm`` within 1e-6 relative, the pixel
    metrics exact; five steps: the parameters within 5e-7;
  * one ``train_step`` in bf16 (the dense-equivalent route): the
    parameters within 1e-5 (1% of the step), the losses within 1e-5
    relative, ``grad_norm`` within 2e-2 relative: the backward rounds its
    cotangents to bf16 (2^-8 an ulp) and XLA's CPU backend keeps excess
    precision across fused bf16 ops, so the two bf16 gradients differ by
    about 1% (on this batch the f32 grad_norm is 0.7127, JAX's bf16
    0.7178, the port's 0.7103);
  * the learning-rate schedules: 1e-6 relative to optax's;
  * a resumed step, the checkpoint round trip and ``save_params_npz``
    through the JAX package's ``load_params_npz``: bit for bit (logits
    within 1e-5).
"""

import json

import jax
import jax.numpy as jnp
import jax.tree_util as tu
import numpy as np
import pytest
import torch

from ubdvss_tpu import train as jtrain
from ubdvss_tpu.models import model as jmodel
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.utils import checkpoint as jckpt
from ubdvss_tpu_torch import detect as pdetect
from ubdvss_tpu_torch import evaluate as peval
from ubdvss_tpu_torch import train as ptrain
from ubdvss_tpu_torch.data import Batches, DataConfig
from ubdvss_tpu_torch.models.model import init_params, train_apply
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.cuda import context_kernel
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.utils.checkpoint import (
    CheckpointManager,
    flat_from_params,
    params_from_flat,
    save_params_npz,
)

torch.set_num_threads(1)

SMALL = dict(channels=8, dilations=(1, 2))


def _flat(tree) -> dict:
    return {"/".join(str(k.key) for k in kp): np.asarray(v) for kp, v in tu.tree_flatten_with_path(tree)[0]}


def _jax_params(seed=3, **kw):
    return jmodel.init_params(JaxNetConfig(**SMALL, **kw), seed)


def _batch(B=2, H=32, seed=0, classes=4):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (B, H, H, 1)).astype(np.float32)
    seg = rng.integers(0, classes, (B, H // 4, H // 4)) * (rng.random((B, H // 4, H // 4)) < 0.3)
    return imgs, seg.astype(np.int32)


def test_fused_model_apply_gradient_matches_jax():
    """F4: the context kernel's autograd function carries the gradient, and
    ``fused_model_apply``'s gradients equal ``jax.grad`` of the flax module."""
    jp = _jax_params()
    params = {k: v.requires_grad_() for k, v in params_from_flat(_flat(jp)).items()}
    cfg, jcfg = NetConfig(**SMALL), JaxNetConfig(**SMALL)
    imgs, _ = _batch(H=64)
    r = np.random.default_rng(1).normal(size=(2, 16, 16, cfg.n_output_channels)).astype(np.float32)
    out = context_kernel.fused_model_apply(params, torch.from_numpy(imgs), cfg)
    assert out.grad_fn is not None
    (out * torch.from_numpy(r)).sum().backward()
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jmodel.get_model(jcfg).apply({"params": p}, imgs) * r)))(jp)
    got = flat_from_params({k: v.grad for k, v in params.items()})
    want = _flat(jg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=2e-6, err_msg=k)


def test_context_head_backward_is_the_plain_gradient():
    """The autograd function's backward is autograd of the plain version, in
    every input; the forward counts no launch on the CPU."""
    rng = np.random.default_rng(2)
    C, O, dil = 8, 5, (1, 2)
    shapes = [(2, C, 12, 12), (2, 9, C, 1, 1), (2, C, C), (2, C, 1, 1), (O, C), (O, 1, 1)]
    args = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    g = torch.from_numpy(rng.normal(size=(2, O, 12, 12)).astype(np.float32))
    a = [t.clone().requires_grad_() for t in args]
    b = [t.clone().requires_grad_() for t in args]
    context_kernel.fused_context_head.launches = 0
    out = context_kernel.fused_context_head(*a, dil)
    ref = context_kernel.context_head_reference(*b, dil)
    assert torch.equal(out, ref.detach()) and context_kernel.fused_context_head.launches == 0
    out.backward(g)
    ref.backward(g)
    for x, y in zip(a, b):
        assert torch.equal(x.grad, y.grad)
    with torch.inference_mode():
        assert torch.equal(context_kernel.fused_context_head(*args, dil), ref.detach())


def test_init_params_layout_and_statistics():
    """flax's lecun-normal defaults in the port's layout: the names and
    shapes of ``params_from_flat`` of JAX's ``init_params``, zero biases,
    draws within two standard deviations, each kernel's standard deviation
    within 5% of sqrt(1/fan_in) over 24 seeds, one set of weights a seed."""
    cfg = NetConfig()
    want = params_from_flat(_flat(jmodel.init_params(JaxNetConfig(), 0)))
    draws = [init_params(cfg, s) for s in range(24)]
    assert {k: tuple(v.shape) for k, v in draws[0].items()} == {k: tuple(v.shape) for k, v in want.items()}
    for k, v in draws[0].items():
        if k.endswith("bias"):
            assert not v.any(), k
            continue
        fan_in = v.shape[1] * v.shape[2] * v.shape[3]
        sd = (1.0 / fan_in) ** 0.5
        pooled = torch.stack([d[k] for d in draws])
        assert float(pooled.abs().max()) <= 2 * sd / 0.87962566103423978 + 1e-6, k
        assert abs(float(pooled.std()) / sd - 1.0) < 0.05, (k, float(pooled.std()), sd)
        jstd = float(np.std(np.concatenate([_flat(jmodel.init_params(JaxNetConfig(), s))[
            k.replace(".", "/").replace("weight", "kernel")].ravel() for s in range(2)])))
        assert abs(jstd / sd - 1.0) < 0.15, (k, jstd)
    assert all(torch.equal(init_params(cfg, 7)[k], v) for k, v in init_params(cfg, 7).items())
    assert not torch.equal(draws[0]["head.weight"], draws[1]["head.weight"])


@pytest.mark.parametrize("kind", ["constant", "cosine", "exponential"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_lr_schedule_matches_optax(kind, warmup):
    decay = 100
    ours = ptrain.make_lr_schedule(kind, 1e-3, warmup, decay)
    ref = jtrain.make_lr_schedule(kind, 1e-3, warmup, decay)
    for count in sorted({0, 1, 5, max(warmup - 1, 0), warmup, warmup + 1, warmup + 50,
                         warmup + decay - 1, warmup + decay, warmup + decay + 7}):
        want = float(ref(jnp.int32(count)))
        assert ours(count) == pytest.approx(want, rel=1e-6, abs=1e-12), (count, ours(count), want)


def _jax_state(jcfg, jp, **kw):
    js = jtrain.create_train_state(jcfg, lr=1e-3, **kw)
    return js.replace(params=jp, opt_state=js.tx.init(jp))


def _assert_params(ps, js, atol):
    got, want = flat_from_params(ps.params), _flat(js.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


def _assert_metrics(pm, jm, rel, grad_rel):
    assert sorted(pm) == sorted(jm)
    for k in jm:
        a, b = float(pm[k]), float(jm[k])
        if k.startswith("pixel_"):
            assert a == b, k
        else:
            tol = grad_rel if k == "grad_norm" else rel
            assert abs(a - b) <= tol * abs(b) + 1e-7, (k, a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(dtype):
    """One step (and in f32 five) from the same weights and batch, against
    the JAX package's jitted ``train_step``."""
    jcfg, cfg = JaxNetConfig(**SMALL, dtype=dtype), NetConfig(**SMALL, dtype=dtype)
    jp = _jax_params(dtype=dtype)
    imgs, seg = _batch()
    js = _jax_state(jcfg, jp)
    ps = ptrain.create_train_state(cfg, lr=1e-3, device="cpu", params=params_from_flat(_flat(jp)))
    jb = {"images": jnp.asarray(imgs), "segmap": jnp.asarray(seg)}
    pb = {"images": torch.from_numpy(imgs), "segmap": torch.from_numpy(seg)}
    js, jm = jtrain.train_step(js, jb, jcfg)
    ps, pm = ptrain.train_step(ps, pb, cfg)
    assert ps.step == int(js.step) == 1
    if dtype == "float32":
        _assert_params(ps, js, 2e-7)
        _assert_metrics(pm, jm, 1e-6, 1e-6)
        for _ in range(4):
            js, jm = jtrain.train_step(js, jb, jcfg)
            ps, pm = ptrain.train_step(ps, pb, cfg)
        _assert_params(ps, js, 5e-7)
        _assert_metrics(pm, jm, 1e-6, 1e-6)
    else:
        _assert_params(ps, js, 1e-5)
        _assert_metrics(pm, jm, 1e-5, 2e-2)


def test_adamw_step_matches_optax():
    jcfg, cfg = JaxNetConfig(**SMALL), NetConfig(**SMALL)
    jp = _jax_params()
    imgs, seg = _batch(seed=4)
    js = _jax_state(jcfg, jp, weight_decay=0.05)
    ps = ptrain.create_train_state(cfg, lr=1e-3, weight_decay=0.05, device="cpu",
                                   params=params_from_flat(_flat(jp)))
    assert isinstance(ps.tx, torch.optim.AdamW)
    js, _ = jtrain.train_step(js, {"images": jnp.asarray(imgs), "segmap": jnp.asarray(seg)}, jcfg)
    ps, _ = ptrain.train_step(ps, {"images": torch.from_numpy(imgs), "segmap": torch.from_numpy(seg)}, cfg)
    _assert_params(ps, js, 2e-7)


def test_cls_weight_ramp_matches_jax():
    """The classification-loss weight ramps base -> end over ramp steps from
    the step count, then holds; the loss follows it."""
    jcfg, cfg = JaxNetConfig(**SMALL), NetConfig(**SMALL)
    jp = _jax_params()
    imgs, seg = _batch(seed=5)
    js = _jax_state(jcfg, jp)
    ps = ptrain.create_train_state(cfg, lr=1e-3, device="cpu", params=params_from_flat(_flat(jp)))
    sched = (1.0, 3.0, 3.0)
    seen = []
    for _ in range(5):
        js, jm = jtrain.train_step(js, {"images": jnp.asarray(imgs), "segmap": jnp.asarray(seg)}, jcfg,
                                   jnp.asarray(sched, jnp.float32))
        ps, pm = ptrain.train_step(ps, {"images": torch.from_numpy(imgs), "segmap": torch.from_numpy(seg)},
                                   cfg, sched)
        assert float(pm["cls_weight"]) == float(jm["cls_weight"])
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-6 * abs(float(jm["loss"]))
        seen.append(float(pm["cls_weight"]))
    assert seen == pytest.approx([1.0, 1 + 2 / 3, 1 + 4 / 3, 3.0, 3.0])


def test_checked_train_step_clean_and_poisoned():
    cfg = NetConfig(**SMALL)
    imgs, seg = _batch(seed=6)
    batch = {"images": torch.from_numpy(imgs), "segmap": torch.from_numpy(seg)}
    a = ptrain.create_train_state(cfg, device="cpu")
    b = ptrain.create_train_state(cfg, device="cpu")
    a, ma = ptrain.checked_train_step(a, batch, cfg)
    b, mb = ptrain.train_step(b, batch, cfg)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params) and float(ma["loss"]) > 0
    bad = ptrain.create_train_state(cfg, device="cpu",
                                    params={k: v * torch.nan for k, v in init_params(cfg).items()})
    with pytest.raises(FloatingPointError, match="loss"):
        ptrain.checked_train_step(bad, batch, cfg)
    assert bad.step == 0
    poisoned = dict(batch, images=batch["images"].clone())
    poisoned["images"][0, 0, 0, 0] = torch.inf
    with pytest.raises(FloatingPointError):
        ptrain.checked_train_step(ptrain.create_train_state(cfg, device="cpu"), poisoned, cfg)


def test_checkpoint_resume_bitexact(tmp_path):
    """Save after three steps, restore into a fresh state: parameters,
    optimizer state and step identical, and one more step from each is
    identical (the JAX package's resume test)."""
    cfg = NetConfig()
    reader = SyntheticMarkupReader(n_samples=4, image_hw=(64, 64), seed=2)
    dc = DataConfig(batch_size=2, train_hw=(64, 64), augment=None)
    batch = next(iter(Batches(reader, cfg, dc, train=True, device="cpu").epoch(0)))
    state = ptrain.create_train_state(cfg, lr=1e-3, device="cpu")
    for _ in range(3):
        state, _ = ptrain.train_step(state, batch, cfg)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(3, state)
    restored = CheckpointManager(tmp_path / "ck").restore(ptrain.create_train_state(cfg, lr=1e-3, seed=9,
                                                                                    device="cpu"))
    assert restored.step == 3
    for k in state.params:
        assert torch.equal(state.params[k], restored.params[k])
        sa, sb = state.tx.state[state.params[k]], restored.tx.state[restored.params[k]]
        assert all(torch.equal(sa[n], sb[n]) for n in ("exp_avg", "exp_avg_sq", "step"))
    s1, _ = ptrain.train_step(state, batch, cfg)
    s2, _ = ptrain.train_step(restored, batch, cfg)
    assert all(torch.equal(s1.params[k], s2.params[k]) for k in s1.params)


def test_checkpoint_manager_keeps_latest_and_best(tmp_path):
    cfg = NetConfig(**SMALL)
    state = ptrain.create_train_state(cfg, device="cpu")
    latest = CheckpointManager(tmp_path / "latest", max_to_keep=2)
    best = CheckpointManager(tmp_path / "best", max_to_keep=1, best_metric="f1")
    assert latest.latest_step() is None and best.best_step() is None
    for step, f1 in ((1, 0.5), (2, 0.9), (3, 0.7)):
        state.step = step
        latest.save(step, state)
        best.save(step, state, metrics={"f1": f1})
    assert latest._steps() == [2, 3] and latest.latest_step() == 3
    assert best._steps() == [2] and best.best_step() == 2
    assert CheckpointManager(tmp_path / "best").restore(state).step == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "none").restore(state)


def test_save_params_npz_read_by_jax(tmp_path):
    """The port's weight file is the JAX package's layout: its
    ``load_params_npz`` reads it, and its logits equal the port's."""
    cfg, jcfg = NetConfig(**SMALL), JaxNetConfig(**SMALL)
    params = init_params(cfg, 11)
    save_params_npz(tmp_path / "w.npz", params, cfg)
    assert json.loads((tmp_path / "w.net_config.json").read_text()) == json.loads(cfg.to_json())
    jp = jckpt.load_params_npz(tmp_path / "w.npz", jmodel.init_params(jcfg, 0))
    imgs, _ = _batch(H=64)
    want = np.asarray(jmodel.get_model(jcfg).apply({"params": jp}, imgs))
    with torch.no_grad():
        got = train_apply(params, torch.from_numpy(imgs), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    back = params_from_flat(dict(np.load(tmp_path / "w.npz")))
    assert all(torch.equal(back[k], v) for k, v in params.items())


def test_train_cli_and_the_logdir_clis(tmp_path):
    """The train CLI for one epoch at 64² (validation, the best checkpoint,
    the exported weights), then evaluate and detect from its log directory
    and its weight file (a .npy image, read without cv2)."""
    logdir = tmp_path / "run"
    tr = ptrain.main([
        "--train-data", "synthetic", "--val-data", "synthetic", "--epochs", "1",
        "--batch-size", "2", "--synthetic-samples", "4", "--train-size", "64", "64",
        "--logdir", str(logdir), "--export-npz", str(tmp_path / "w.npz"), "--device", "cpu",
        "--channels", "8", "--dilations", "1", "2", "--schedule", "cosine", "--warmup-steps", "1",
    ])
    assert tr.state.step == 2 and tr.cfg.channels == 8
    assert tr._last_train_metrics["loss"] > 0 and "pixel_f1" in tr._last_val_metrics
    assert CheckpointManager(logdir / "checkpoints").latest_step() == 2
    assert tr.best_ckpt.best_step() == 2 and (logdir / "metrics.jsonl").is_file()
    exported = params_from_flat(dict(np.load(tmp_path / "w.npz")))
    assert all(torch.equal(exported[k], v) for k, v in tr.export_params().items())
    args = ["--data", "synthetic", "--synthetic-samples", "2", "--image-size", "64", "64", "--device", "cpu"]
    from_dir = peval.main(args + ["--checkpoint", str(logdir)])
    from_npz = peval.main(args + ["--checkpoint", str(tmp_path / "w.npz")])
    assert from_dir.to_json() == from_npz.to_json()
    img = SyntheticMarkupReader(n_samples=1, image_hw=(64, 64), seed=3).sample_at(0).image
    np.save(tmp_path / "scene.npy", img)
    rep = pdetect.main(["--images", str(tmp_path / "scene.npy"), "--checkpoint", str(logdir),
                        "--device", "cpu"])
    rep_npz = pdetect.main(["--images", str(tmp_path / "scene.npy"), "--checkpoint",
                            str(tmp_path / "w.npz"), "--device", "cpu"])
    assert rep == rep_npz and list(rep) == [str(tmp_path / "scene.npy")]


def test_train_cli_refusals(tmp_path):
    """Nothing is refused any more: the mesh flags refuse only a fall back
    to the host CPU that was not asked for (``--num-devices`` past the
    cards, ``--distributed`` without one), and ``--allow-cpu-mesh`` alone
    trains as without it; the device-fed flags run
    (tests/test_torch_device_fed.py and tests/test_torch_train_mesh.py
    hold what they train)."""
    base = ["--train-data", "synthetic", "--device", "cpu"]
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="allow-cpu-mesh"):
        ptrain.main(base + ["--num-devices", str(n_cards + 1)])
    if n_cards == 0:
        with pytest.raises(RuntimeError, match="allow-cpu-mesh"):
            ptrain.main(base + ["--distributed"])
    small = ["--epochs", "1", "--batch-size", "2", "--synthetic-samples", "2", "--train-size", "32", "32",
             "--channels", "8", "--dilations", "1", "2", "--device", "cpu"]
    for args in (["--train-data", "synthetic", "--cache-device"],
                 ["--train-data", "synthetic", "--steps-per-dispatch", "4"],
                 ["--train-data", "synthetic", "--val-data", "synthetic-device"],
                 ["--train-data", "synthetic-device"],
                 ["--train-data", "synthetic", "--allow-cpu-mesh"]):
        tr = ptrain.main(args + small)
        assert tr.state.step == 1 and np.isfinite(tr._last_train_metrics["loss"]), args
        assert tr.mesh is None

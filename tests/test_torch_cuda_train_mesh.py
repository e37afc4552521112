"""PyTorch port: training over a data mesh on the card — four entries that
repeat the one card — against unsharded training on the card: the sharded
step, the fit over scenes synthesized on the card, and the fit over a
corpus held there and sharded over the entries.

Marked ``cuda``; every test skips without a card.  On the H100 (no jax
there, so without the JAX-importing conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_mesh.py -q

Tolerances (cuDNN's deterministic algorithms; a B/4 shard may take other
conv algorithms than the whole batch, so sums differ in order): the first
sharded step's reduced gradient within 1e-5 of each leaf's max|g| of the
unsharded gradient in f32 (2e-2 in bf16), its loss and parts within 1e-5
relative (bf16: 1e-3, tests/test_torch_cuda_train.py's bound), ``grad_norm`` within 1e-5 relative
(bf16: 2e-2), the pixel metrics within 1e-6 (bf16: 1e-2).  Adam divides
each gradient by its own running magnitude, so a gradient near zero turns
its sum-order difference into a step-sized one, and the mined loss's
top-k selection can then pick another pixel: after several steps (and in
the fits) the median parameter lies within 1e-5 (f32; the same tests run
on the CPU read 3e-8 after 3 steps and 1.6e-6 after the synthesized
fit's 4, the largest differences 1e-4) and every one within 2 lr a step
(both dtypes; bf16 read 2.9e-3 after 3 steps), and the fits' last losses
within 1e-3 relative.  The device-fed shards are the unsharded batch's
rows bit for bit.
"""

import pytest
import torch

from ubdvss_tpu_torch import train as ptrain
from ubdvss_tpu_torch.data import Batches, DataConfig, DeviceCachedBatches
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.parallel import make_mesh, shard_batch_to_mesh
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.synthgen import DeviceSyntheticBatches
from ubdvss_tpu_torch.train import Trainer, create_train_state

pytestmark = pytest.mark.cuda

CFG = NetConfig(max_components=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.deterministic = prev


def _mesh(dev):
    return make_mesh(4, devices=[dev] * 4)


def _record_shards(monkeypatch):
    seen = []
    inner = ptrain._mesh_step

    def spy(state, shards, *a):
        seen.append([{k: v.clone() for k, v in s.items()} for s in shards])
        return inner(state, shards, *a)

    monkeypatch.setattr(ptrain, "_mesh_step", spy)
    return seen


def _assert_adam_close(got: dict, want: dict, steps: int, f32: bool = True, lr: float = 1e-3) -> None:
    diff = torch.cat([(got[k] - v).detach().abs().ravel() for k, v in want.items()])
    assert float(diff.max()) <= 2 * lr * steps, float(diff.max())
    if f32:
        assert float(diff.median()) <= 1e-5, float(diff.median())


def _assert_last_loss(got: Trainer, want: Trainer) -> None:
    a, b = got._last_train_metrics["loss"], want._last_train_metrics["loss"]
    assert abs(a - b) <= 1e-3 * abs(b), (a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_step_on_the_card(dev, dtype):
    """(a) One step over 4 entries of the card against one unsharded step
    on it: the reduced gradient and the metrics; then two more steps
    each."""
    cfg = CFG.replace(dtype=dtype)
    f32 = dtype == "float32"
    reader = SyntheticMarkupReader(n_samples=8, image_hw=(128, 128), seed=0)
    dc = DataConfig(batch_size=8, train_hw=(128, 128), seed=0)
    batch = next(iter(Batches(reader, cfg, dc, train=True, device=dev).epoch(0)))
    mesh = _mesh(dev)
    shards = shard_batch_to_mesh(batch, mesh)
    one = create_train_state(cfg, lr=1e-3, device=dev)
    sharded = create_train_state(cfg, lr=1e-3, device=dev)
    one, m1 = ptrain.train_step(one, batch, cfg)
    sharded, m4 = ptrain.train_step(sharded, shards, cfg, mesh=mesh)
    for k, p in one.params.items():
        g_tol = (1e-5 if f32 else 2e-2) * float(p.grad.abs().max())
        assert float((sharded.params[k].grad - p.grad).abs().max()) <= g_tol, k
    assert sorted(m4) == sorted(m1)
    for k in m1:
        a, b = float(m4[k]), float(m1[k])
        if k.startswith("pixel_"):
            assert abs(a - b) <= (1e-6 if f32 else 1e-2), (k, a, b)
        elif k == "grad_norm":
            assert abs(a - b) <= (1e-5 if f32 else 2e-2) * abs(b), (k, a, b)
        else:
            assert abs(a - b) <= (1e-5 if f32 else 1e-3) * abs(b) + 1e-7, (k, a, b)
    for _ in range(2):
        one, _ = ptrain.train_step(one, batch, cfg)
        sharded, _ = ptrain.train_step(sharded, shards, cfg, mesh=mesh)
    _assert_adam_close(sharded.params, one.params, 3, f32)


def test_synth_fit_on_four_entries_of_the_card(dev, monkeypatch):
    """(b) The fit over scenes synthesized on the card, on 4 entries, ends
    where the unsharded fit does (within Adam's amplification of the sum
    order, above); each shard is the unsharded batch's rows
    bit for bit."""
    dc = DataConfig(batch_size=8, train_hw=(128, 128), max_polys=4, seed=2)
    batches = DeviceSyntheticBatches(CFG, dc, n_samples=16, seed=11, device=dev)
    t1 = Trainer(CFG, dc, seed=0, device=dev)
    t1.fit(batches, epochs=2)
    seen = _record_shards(monkeypatch)
    t4 = Trainer(CFG, dc, seed=0, mesh=_mesh(dev), steps_per_dispatch=2)
    t4.fit(batches, epochs=2)
    assert t4.state.step == t1.state.step == 4
    _assert_adam_close(t4.state.params, t1.state.params, 4)
    _assert_last_loss(t4, t1)
    for j, shards in enumerate(seen):
        whole = batches.batch_at(j // 2, j % 2)
        for i, s in enumerate(shards):
            assert all(torch.equal(s[k], whole[k][2 * i:2 * i + 2]) for k in whole), (j, i)


def test_cached_fit_on_four_entries_of_the_card(dev, monkeypatch):
    """(c) 10 samples held on the card over 4 entries: 12 rows, 3 an entry;
    the fit ends where the unsharded fit does, its shards the unsharded
    batches' rows bit for bit."""
    dc = DataConfig(batch_size=4, train_hw=(128, 128), max_polys=4, seed=6)
    reader = SyntheticMarkupReader(n_samples=10, image_hw=(128, 128), seed=13)
    b1 = DeviceCachedBatches(reader, CFG, dc, device=dev)
    t1 = Trainer(CFG, dc, seed=0, device=dev)
    t1.fit(b1, epochs=2)
    mesh = _mesh(dev)
    b4 = DeviceCachedBatches(reader, CFG, dc, mesh=mesh)
    assert [sh[0].shape[0] for sh in b4._shards] == [3] * 4
    assert all(sh[0].device == dev for sh in b4._shards)
    seen = _record_shards(monkeypatch)
    t4 = Trainer(CFG, dc, seed=0, mesh=mesh, steps_per_dispatch=4)
    t4.fit(b4, epochs=2)
    assert t4.state.step == t1.state.step == 4
    _assert_adam_close(t4.state.params, t1.state.params, 4)
    _assert_last_loss(t4, t1)
    order = b1.order(1)
    for j in range(2):
        whole = b1.batch_at(order, 1, j)
        for i, s in enumerate(seen[2 + j]):
            assert all(torch.equal(s[k], whole[k][i:i + 1]) for k in whole), (j, i)

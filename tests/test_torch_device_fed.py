"""PyTorch port: device-fed training (``train.py``'s fused steps and
``steps_per_dispatch``, ``data.DeviceCachedBatches``, ``data.GrainBatches``
and the train CLI's device-fed flags) on the CPU, at 8 channels,
dilations (1, 2), 64² scenes and batch 2.

Tolerances: fused and unfused training end at the same parameters within
2e-6 (the JAX package's bar, tests/test_trainer_extras.py:295-351; on the
CPU they are equal bit for bit); the cached and the worker-pool batches
equal ``Batches``' bit for bit.
"""

import numpy as np
import pytest
import torch

from ubdvss_tpu_torch import train as ptrain
from ubdvss_tpu_torch.data import Batches, DataConfig, DeviceCachedBatches, GrainBatches
from ubdvss_tpu_torch.markup import Sample
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.parallel import make_mesh
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.synthgen import DeviceSyntheticBatches
from ubdvss_tpu_torch.train import Trainer, create_train_state, train_step

torch.set_num_threads(1)

CFG = NetConfig(channels=8, dilations=(1, 2), max_components=4)


def _manual(batches, epochs, cfg=CFG):
    state = create_train_state(cfg, lr=1e-3, seed=0, device="cpu")
    for epoch in range(epochs):
        for batch in batches.epoch(epoch):
            state, _ = train_step(state, batch, cfg)
    return state


def _assert_same_params(got, want):
    for k, v in want.params.items():
        torch.testing.assert_close(got.params[k], v, rtol=0, atol=2e-6, msg=k)


@pytest.mark.parametrize("spd", [1, 2])
def test_fused_synth_matches_unfused_stream(spd):
    """``Trainer.fit`` over ``DeviceSyntheticBatches`` with
    ``steps_per_dispatch`` 1 and 2 ends at the parameters of a manual loop
    of ``batches.epoch(e)`` and ``train_step`` (tests/test_trainer_extras.py:295)."""
    dc = DataConfig(batch_size=2, train_hw=(64, 64), max_polys=4, seed=3)
    batches = DeviceSyntheticBatches(CFG, dc, n_samples=6, seed=5, device="cpu")
    tr = Trainer(CFG, dc, lr=1e-3, seed=0, steps_per_dispatch=spd, device="cpu")
    chunks = [k for _, k in tr._epoch_steps(batches, 0)]
    assert chunks == ([1, 1, 1] if spd == 1 else [2, 1])
    tr.fit(batches, epochs=2)
    assert tr.state.step == 6
    _assert_same_params(tr.state, _manual(batches, 2))


@pytest.mark.parametrize("spd", [1, 2])
def test_fused_cached_matches_unfused_stream(spd):
    """The same over ``DeviceCachedBatches`` (tests/test_trainer_extras.py:330),
    whose stream is ``Batches``' on the same reader."""
    dc = DataConfig(batch_size=2, train_hw=(64, 64), max_polys=4, seed=1)
    reader = SyntheticMarkupReader(n_samples=6, image_hw=(64, 64), seed=9)
    batches = DeviceCachedBatches(reader, CFG, dc, train=True, device="cpu")
    tr = Trainer(CFG, dc, lr=1e-3, seed=0, steps_per_dispatch=spd, device="cpu")
    tr.fit(batches, epochs=2)
    assert tr.state.step == 6
    want = _manual(batches, 2)
    _assert_same_params(tr.state, want)
    _assert_same_params(tr.state, _manual(Batches(reader, CFG, dc, train=True, device="cpu"), 2))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_cached_stream_equals_batches(train):
    """Sample for sample, augmented or not, with a partial tail."""
    dc = DataConfig(batch_size=2, train_hw=(48, 48), max_polys=4, seed=2, drop_remainder=False)
    reader = SyntheticMarkupReader(n_samples=5, image_hw=(48, 48), seed=4)
    cached = DeviceCachedBatches(reader, CFG, dc, train=train, device="cpu")
    streamed = Batches(reader, CFG, dc, train=train, device="cpu")
    assert len(cached) == len(streamed) == 3
    for epoch in (0, 1):
        got, want = list(cached.epoch(epoch)), list(streamed.epoch(epoch))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert set(a) == set(b)
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_cached_partial_tail_and_debug_path():
    """``drop_remainder=False``: the tail is one unfused step; under
    ``debug_checks`` nothing is fused.  Both end where the manual loop
    does."""
    dc = DataConfig(batch_size=2, train_hw=(48, 48), max_polys=4, seed=2, drop_remainder=False)
    reader = SyntheticMarkupReader(n_samples=5, image_hw=(48, 48), seed=4)
    batches = DeviceCachedBatches(reader, CFG, dc, train=True, device="cpu")
    tr = Trainer(CFG, dc, lr=1e-3, seed=0, steps_per_dispatch=4, device="cpu")
    assert [k for _, k in tr._epoch_steps(batches, 0)] == [2, 1]
    tr.fit(batches, epochs=1)
    dbg = Trainer(CFG, dc, lr=1e-3, seed=0, debug_checks=True, device="cpu")
    assert [k for _, k in dbg._epoch_steps(batches, 0)] == [1, 1, 1]
    dbg.fit(batches, epochs=1)
    want = _manual(batches, 1)
    assert tr.state.step == dbg.state.step == 3
    _assert_same_params(tr.state, want)
    _assert_same_params(dbg.state, want)


def test_fused_step_logs_and_saves_at_chunk_boundaries(tmp_path):
    dc = DataConfig(batch_size=2, train_hw=(64, 64), max_polys=4)
    batches = DeviceSyntheticBatches(CFG, dc, n_samples=10, seed=0, device="cpu")
    tr = Trainer(CFG, dc, logdir=str(tmp_path), log_every=1, checkpoint_every=2, steps_per_dispatch=3,
                 image_summaries=False, best_metric=None, device="cpu")
    assert tr._steps_per_dispatch() == 3
    assert Trainer(CFG, dc, device="cpu")._steps_per_dispatch() == 16
    tr.fit(batches, epochs=1)
    assert tr.state.step == 5 and tr.ckpt.latest_step() == 5
    logged = [int(line.split('"step": ')[1].split(",")[0])
              for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert logged == [3, 5]


def test_cache_memory_guard_and_mesh():
    """A corpus past 8 GB of f32 images raises before anything is loaded;
    a mesh shards the corpus, and the fused steps take one
    (tests/test_torch_train_mesh.py holds what they train)."""

    class _Big:
        def samples(self):
            return [Sample("<never loaded>", [], image=None)] * 8193

    with pytest.raises(ValueError, match="exceeds max_bytes"):
        DeviceCachedBatches(_Big(), CFG, DataConfig(train_hw=(512, 512)), device="cpu")
    reader = SyntheticMarkupReader(n_samples=2, image_hw=(32, 32))
    with pytest.raises(ValueError, match="exceeds max_bytes"):
        DeviceCachedBatches(reader, CFG, DataConfig(train_hw=(32, 32)), max_bytes=8191, device="cpu")
    mesh = make_mesh(2, devices=["cpu"] * 2)
    placed = DeviceCachedBatches(reader, CFG, DataConfig(train_hw=(32, 32)), mesh=mesh)
    assert placed.device == torch.device("cpu") and [sh[0].shape[0] for sh in placed._shards] == [1, 1]
    assert callable(ptrain.make_fused_synth_step(None, CFG, DataConfig(), mesh=mesh))
    assert callable(ptrain.make_fused_cached_step(CFG, DataConfig(), mesh=mesh))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_worker_pool_equals_batches(train):
    """``GrainBatches``: two spawned workers decode and pad; the batches
    equal ``Batches``' (its shuffle and generators), partial tail included."""
    dc = DataConfig(batch_size=2, train_hw=(48, 48), max_polys=4, seed=6, drop_remainder=False)
    reader = SyntheticMarkupReader(n_samples=5, image_hw=(48, 48), seed=8)
    pool = GrainBatches(reader, CFG, dc, train=train, worker_count=2 if train else 0, device="cpu")
    streamed = Batches(reader, CFG, dc, train=train, device="cpu")
    assert len(pool) == len(streamed) == 3
    got, want = list(pool.epoch(1)), list(streamed.epoch(1))
    assert len(got) == 3
    for a, b in zip(got, want):
        assert all(torch.equal(a[k], b[k]) for k in b)


def test_train_cli_device_fed(tmp_path):
    """The device-fed CLI forms on the CPU: scenes synthesized where the
    step runs (train and val), a chunk of 2 steps; and the cached corpus."""
    base = ["--epochs", "2", "--batch-size", "2", "--synthetic-samples", "4", "--train-size", "64", "64",
            "--channels", "8", "--dilations", "1", "2", "--device", "cpu"]
    tr = ptrain.main(["--train-data", "synthetic-device", "--val-data", "synthetic-device",
                      "--steps-per-dispatch", "2", "--logdir", str(tmp_path / "a")] + base)
    assert isinstance(tr, Trainer) and tr.state.step == 4 and tr.steps_per_dispatch == 2
    assert np.isfinite(tr._last_train_metrics["loss"]) and "pixel_f1" in tr._last_val_metrics
    assert tr.ckpt.latest_step() == 4
    tr = ptrain.main(["--train-data", "synthetic", "--cache-device"] + base)
    assert tr.state.step == 4 and np.isfinite(tr._last_train_metrics["loss"])

"""PyTorch port: training over a data mesh (``train.train_step(mesh=)``,
``Trainer(mesh=)``, the sharded device-fed and cached pipelines, the train
CLI's ``--num-devices``) against the JAX package's mesh training and the
port's unsharded training on the CPU, at 8 channels, dilations (1, 2), 64²
images and batch 8 (4 for the device-fed fits).

The port's meshes repeat the one CPU device (``devices=["cpu"] * n``);
JAX's run on tests/conftest.py's 8 virtual CPU devices.  Tolerances:
against JAX's ``train_step`` on a 4-device mesh, parameters within 1e-5 and
the loss within 1e-5 (JAX's own mesh test's bar,
tests/test_parallel.py:31-48); against the port's unsharded step,
parameters and the loss within 1e-5, ``grad_norm`` within 1e-6 relative
and the pixel metrics within 1e-6 (the sharded step sums the same
gradients in another order, and divides the summed counts); the device-fed
shards bit for bit the unsharded batch's rows; the fits within 1e-5 of the
unsharded fits (JAX's bar, tests/test_parallel.py:245-305); the CLI's
final loss within 1e-5 of the JAX CLI's on the same initial weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import SMALL, _flat

from ubdvss_tpu import train as jtrain
from ubdvss_tpu.models import model as jmodel
from ubdvss_tpu.net_config import NetConfig as JaxNetConfig
from ubdvss_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ubdvss_tpu.parallel.mesh import replicate_to_mesh as jax_replicate
from ubdvss_tpu.parallel.mesh import shard_batch_to_mesh as jax_shard
from ubdvss_tpu_torch import train as ptrain
from ubdvss_tpu_torch.data import Batches, DataConfig, DeviceCachedBatches
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.parallel import entry_rows, make_mesh, replicate_params, shard_batch_to_mesh
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.synthgen import DeviceSyntheticBatches
from ubdvss_tpu_torch.train import Trainer, create_train_state
from ubdvss_tpu_torch.utils.checkpoint import flat_from_params, params_from_flat

torch.set_num_threads(1)

CFG = NetConfig(**SMALL, max_components=4)


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _host_batch(B=8, seed=0):
    reader = SyntheticMarkupReader(n_samples=B, image_hw=(64, 64), seed=seed)
    dc = DataConfig(batch_size=B, train_hw=(64, 64), augment=None, shuffle=False)
    return next(iter(Batches(reader, CFG, dc, train=True, device="cpu").epoch(0)))


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].detach() - b[k].detach()).abs().max()) for k in b)


def _assert_unsharded_metrics(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = float(got[k]), float(want[k])
        if k.startswith("pixel_"):
            assert abs(a - b) <= 1e-6, (k, a, b)
        elif k == "grad_norm":
            assert abs(a - b) <= 1e-6 * abs(b), (k, a, b)
        else:
            assert abs(a - b) <= 1e-5, (k, a, b)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_step_matches_jax_mesh_and_unsharded(n):
    """(a) Three steps over an n-entry mesh from JAX's initial weights:
    JAX's ``train_step`` on its 4-device mesh, the port's unsharded step
    and the port's sharded step end together."""
    jcfg = JaxNetConfig(**SMALL, max_components=4)
    jp = jmodel.init_params(jcfg, 3)
    batch = _host_batch()
    jmesh = jax_make_mesh(4, axis="data", devices=jax.devices("cpu"))
    js = jtrain.create_train_state(jcfg, lr=1e-3)
    js = jax_replicate(js.replace(params=jp, opt_state=js.tx.init(jp)), jmesh)
    jb = jax_shard({"images": jnp.asarray(batch["images"].numpy()),
                    "segmap": jnp.asarray(batch["segmap"].numpy())}, jmesh)
    one = create_train_state(CFG, lr=1e-3, device="cpu", params=params_from_flat(_flat(jp)))
    sharded = create_train_state(CFG, lr=1e-3, device="cpu", params=params_from_flat(_flat(jp)))
    mesh = cpu_mesh(n)
    shards = shard_batch_to_mesh(batch, mesh)
    assert [s["images"].shape[0] for s in shards] == [8 // n] * n
    for _ in range(3):
        js, jm = jtrain.train_step(js, jb, jcfg)
        one, m1 = ptrain.train_step(one, batch, CFG)
        sharded, mn = ptrain.train_step(sharded, shards, CFG, mesh=mesh)
    assert sharded.step == one.step == int(js.step) == 3
    want = _flat(jax.device_get(js.params))
    got = flat_from_params({k: v.detach() for k, v in sharded.params.items()})
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)
    assert abs(float(mn["loss"]) - float(jm["loss"])) <= 1e-5
    assert _max_diff(sharded.params, one.params) <= 1e-5
    _assert_unsharded_metrics(mn, m1)


def test_sharded_step_cls_ramp_and_eval_step():
    """The cls-weight ramp and ``eval_step`` over a mesh give the unsharded
    values (the pixel metrics from summed counts, not a mean of shard
    ratios)."""
    batch = _host_batch(seed=5)
    mesh = cpu_mesh(4)
    shards = shard_batch_to_mesh(batch, mesh)
    sched = (1.0, 3.0, 3.0)
    one = create_train_state(CFG, lr=1e-3, device="cpu")
    sharded = create_train_state(CFG, lr=1e-3, device="cpu")
    for _ in range(2):
        one, m1 = ptrain.train_step(one, batch, CFG, sched)
        sharded, m4 = ptrain.train_step(sharded, shards, CFG, sched, mesh=mesh)
    assert float(m4["cls_weight"]) == float(m1["cls_weight"])
    _assert_unsharded_metrics(m4, m1)
    e1 = ptrain.eval_step(one, batch, CFG)
    e4 = ptrain.eval_step(one, shards, CFG, mesh=mesh)
    assert sorted(e4) == sorted(e1)
    for k in e1:
        assert abs(float(e4[k]) - float(e1[k])) <= (1e-6 if k.startswith("pixel_") else 1e-5), k
    per_shard_f1 = np.mean([float(ptrain.eval_step(one, s, CFG)["pixel_f1"]) for s in shards])
    assert float(e4["pixel_f1"]) == pytest.approx(float(e1["pixel_f1"]), abs=1e-6)
    assert per_shard_f1 != pytest.approx(float(e1["pixel_f1"]), abs=1e-6)


def test_replicas_one_a_distinct_device():
    """``replicate_params``: entries on the first entry's device share its
    leaves; each other distinct device holds one copy, made once and then
    refreshed in place (the "meta" device stands for a second card)."""
    params = {k: v.requires_grad_() for k, v in create_train_state(CFG, device="cpu").params.items()}
    cpu, meta = torch.device("cpu"), torch.device("meta")
    cache: dict = {}
    got = replicate_params(params, [cpu, meta, cpu, meta], cache)
    assert got[0] is params and got[2] is params and got[1] is got[3] is cache[meta]
    assert list(cache) == [meta] and all(v.device == meta and v.requires_grad for v in cache[meta].values())
    copies = {k: id(v) for k, v in cache[meta].items()}
    again = replicate_params(params, [cpu, meta, cpu, meta], cache)
    assert again[1] is cache[meta] and {k: id(v) for k, v in cache[meta].items()} == copies
    assert replicate_params(params, [cpu] * 4, {}) == [params] * 4


def _record_shards(monkeypatch):
    """Every shard list the mesh step takes, as it is given."""
    seen = []
    inner = ptrain._mesh_step

    def spy(state, shards, *a):
        seen.append([{k: v.clone() for k, v in s.items()} for s in shards])
        return inner(state, shards, *a)

    monkeypatch.setattr(ptrain, "_mesh_step", spy)
    return seen


def test_synth_fit_on_four_entries(monkeypatch):
    """(b) ``Trainer.fit`` of ``DeviceSyntheticBatches`` on 4 entries ends
    where the unsharded fit does (JAX's tests/test_parallel.py:245-270),
    chunked or not, and each step's shards are the unsharded batch's rows
    bit for bit."""
    dc = DataConfig(batch_size=4, train_hw=(64, 64), max_polys=4, seed=2)
    batches = DeviceSyntheticBatches(CFG, dc, n_samples=8, seed=11, device="cpu")
    t1 = Trainer(CFG, dc, lr=1e-3, seed=0, device="cpu")
    t1.fit(batches, epochs=2)
    seen = _record_shards(monkeypatch)
    for spd in (1, 2):
        t4 = Trainer(CFG, dc, lr=1e-3, seed=0, mesh=cpu_mesh(4), steps_per_dispatch=spd)
        t4.fit(batches, epochs=2)
        assert t4.state.step == t1.state.step == 4
        assert _max_diff(t4.state.params, t1.state.params) <= 1e-5
    assert len(seen) == 8
    for j, shards in enumerate(seen[:4]):
        whole = batches.batch_at(j // 2, j % 2)
        assert len(shards) == 4
        for i, s in enumerate(shards):
            assert all(torch.equal(s[k], whole[k][i:i + 1]) for k in whole), (j, i)


@pytest.mark.parametrize("drop_remainder", [True, False], ids=["full", "tail"])
def test_cached_fit_on_a_sharded_corpus(monkeypatch, drop_remainder):
    """(c) The cached pipeline with 10 samples: on 4 entries the corpus is
    padded to 12 rows, 3 an entry (JAX's tests/test_parallel.py:272-305),
    and the fit ends where the unsharded fit does, its shards the
    unsharded batches' rows bit for bit; with ``drop_remainder=False`` on 2
    entries the tail of 2 takes the same sharded step."""
    n = 4 if drop_remainder else 2
    dc = DataConfig(batch_size=4, train_hw=(64, 64), max_polys=4, seed=6, drop_remainder=drop_remainder)
    reader = SyntheticMarkupReader(n_samples=10, image_hw=(64, 64), seed=13)
    b1 = DeviceCachedBatches(reader, CFG, dc, train=True, device="cpu")
    t1 = Trainer(CFG, dc, lr=1e-3, seed=0, device="cpu")
    t1.fit(b1, epochs=2)
    mesh = cpu_mesh(n)
    bn = DeviceCachedBatches(reader, CFG, dc, train=True, mesh=mesh)
    rows = 12 if n == 4 else 10
    assert [tuple(a.shape[0] for a in sh) for sh in bn._shards] == [(rows // n,) * 4] * n
    assert bn._imgs is None
    shards_before = bn._shards
    bn.place_on_mesh(mesh)  # idempotent
    assert bn._shards is shards_before
    seen = _record_shards(monkeypatch)
    tn = Trainer(CFG, dc, lr=1e-3, seed=0, mesh=mesh, steps_per_dispatch=4)
    tn.fit(bn, epochs=2)
    assert tn.state.step == t1.state.step == (4 if drop_remainder else 6)
    assert _max_diff(tn.state.params, t1.state.params) <= 1e-5
    order = b1.order(1)
    want = [b1.batch_at(order, 1, bi) for bi in range(len(b1))]
    for j, whole in enumerate(want):
        shards = seen[len(want) + j]
        m = whole["images"].shape[0] // n
        for i, s in enumerate(shards):
            assert all(torch.equal(s[k], whole[k][i * m:(i + 1) * m]) for k in whole), (j, i)
    # the placed corpus still streams the whole batches of the unsharded one
    for a, b in zip(bn.epoch(1), want):
        assert all(torch.equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("debug_checks", [False, True], ids=["plain", "checked"])
def test_host_fed_fit_with_validation(debug_checks):
    """``Trainer(mesh=).fit`` over host-fed ``Batches`` (each prefetched
    batch sharded) with validation batches: the train and validation
    metrics and the parameters are the unsharded fit's, plain and under
    ``debug_checks``; ``best_metric`` reads the whole batches' metrics."""
    reader = SyntheticMarkupReader(n_samples=8, image_hw=(64, 64), seed=9)
    dc = DataConfig(batch_size=4, train_hw=(64, 64), max_polys=4, seed=1)
    train_b = Batches(reader, CFG, dc, train=True, device="cpu")
    val_b = Batches(reader, CFG, DataConfig(batch_size=4, train_hw=(64, 64), max_polys=4, shuffle=False),
                    train=False, device="cpu")
    kw = dict(lr=1e-3, seed=0, debug_checks=debug_checks)
    t1 = Trainer(CFG, dc, device="cpu", **kw)
    t1.fit(train_b, 2, val_b)
    t4 = Trainer(CFG, dc, mesh=cpu_mesh(4), **kw)
    t4.fit(train_b, 2, val_b)
    assert t4.state.step == t1.state.step == 4
    assert _max_diff(t4.state.params, t1.state.params) <= 1e-5
    for got, want in ((t4._last_train_metrics, t1._last_train_metrics),
                      (t4._last_val_metrics, t1._last_val_metrics)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert abs(got[k] - want[k]) <= (1e-6 if k.startswith("pixel_") else 1e-5 * abs(want[k])), k


def test_checked_step_under_mesh():
    """(d) The checked step over 4 entries: the loss and parameters of the
    unchecked one; a shard with a non-finite pixel raises before the
    update, the parameters untouched."""
    batch = _host_batch(seed=6)
    mesh = cpu_mesh(4)
    shards = shard_batch_to_mesh(batch, mesh)
    a = create_train_state(CFG, device="cpu")
    b = create_train_state(CFG, device="cpu")
    a, ma = ptrain.checked_train_step(a, shards, CFG, mesh=mesh)
    b, mb = ptrain.train_step(b, shards, CFG, mesh=mesh)
    assert float(ma["loss"]) == float(mb["loss"]) > 0
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    poisoned = [dict(s) for s in shards]
    poisoned[2]["images"] = poisoned[2]["images"].clone()
    poisoned[2]["images"][0, 5, 5, 0] = torch.nan
    before = {k: v.detach().clone() for k, v in b.params.items()}
    with pytest.raises(FloatingPointError):
        ptrain.checked_train_step(b, poisoned, CFG, mesh=mesh)
    assert b.step == 1 and all(torch.equal(before[k], b.params[k]) for k in before)
    tr = Trainer(CFG, DataConfig(batch_size=8, train_hw=(64, 64), augment=None), debug_checks=True,
                 mesh=mesh)
    with pytest.raises(FloatingPointError):
        tr.step_fn(tr.state, poisoned)


def test_mesh_refusals_and_closure_per_mesh():
    """(e) A batch size that does not divide the mesh raises ``ValueError``
    (JAX's train.py:334-339), so does a device other than the mesh's first
    entry and a shard list of the wrong length; a second ``fit`` on another
    mesh builds its own fused closure and still ends where the unsharded
    fit does."""
    dc = DataConfig(batch_size=4, train_hw=(64, 64), max_polys=4, seed=3)
    with pytest.raises(ValueError, match="not divisible by the 3-device data mesh"):
        Trainer(CFG, dc, mesh=cpu_mesh(3))
    with pytest.raises(ValueError, match="first entry"):
        Trainer(CFG, dc, mesh=cpu_mesh(2), device="meta")
    with pytest.raises(ValueError, match="list of 4 shards"):
        ptrain.train_step(create_train_state(CFG, device="cpu"), _host_batch(), CFG, mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match="not divisible"):
        entry_rows(6, cpu_mesh(4), 0)
    batches = DeviceSyntheticBatches(CFG, dc, n_samples=8, seed=5, device="cpu")
    t1 = Trainer(CFG, dc, seed=0, device="cpu")
    t1.fit(batches, epochs=2)
    tr = Trainer(CFG, dc, seed=0, mesh=cpu_mesh(2))
    tr.fit(batches, epochs=1)
    tr.mesh = cpu_mesh(4)
    tr.fit(batches, epochs=1)
    keys = list(tr._fused_steps)
    assert len(keys) == 2 and keys[0][-1] is not keys[1][-1]
    # the second fit ran its epoch 0 again, so compare with 0, 0
    t0 = Trainer(CFG, dc, seed=0, device="cpu")
    for _ in range(2):
        t0.fit(batches, epochs=1)
    assert _max_diff(tr.state.params, t0.state.params) <= 1e-5


def test_train_cli_num_devices_matches_jax_cli(monkeypatch):
    """(f) ``--num-devices 4 --allow-cpu-mesh``: the port's CLI on 4 CPU
    entries and the JAX CLI on 4 virtual CPU devices, from the same initial
    weights (the port's ``init_params`` made to return JAX's), end at the
    same loss; the port's mesh run also ends where its single-device run
    does."""
    jcfg = JaxNetConfig(**SMALL)
    monkeypatch.setattr(ptrain, "init_params",
                        lambda cfg, seed: params_from_flat(_flat(jmodel.init_params(jcfg, seed))))
    base = ["--train-data", "synthetic", "--epochs", "2", "--batch-size", "8", "--lr", "1e-3",
            "--synthetic-samples", "8", "--train-size", "64", "64", "--no-augment", "--seed", "3",
            "--channels", "8", "--dilations", "1", "2"]
    mesh_flags = ["--num-devices", "4", "--allow-cpu-mesh"]
    jt = jtrain.main(base + mesh_flags)
    assert jt.mesh is not None and jt.mesh.devices.size == 4
    t4 = ptrain.main(base + mesh_flags)
    assert t4.mesh.size == 4 and all(d.type == "cpu" for d in t4.mesh.devices.flat)
    assert t4.state.step == 2
    assert abs(t4._last_train_metrics["loss"] - jt._last_train_metrics["loss"]) <= 1e-5
    t1 = ptrain.main(base + ["--device", "cpu"])
    assert abs(t4._last_train_metrics["loss"] - t1._last_train_metrics["loss"]) <= 1e-5
    assert _max_diff(t4.state.params, t1.state.params) <= 1e-5

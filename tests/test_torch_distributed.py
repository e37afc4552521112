"""PyTorch port: training over several processes (``train.setup_devices(
distributed=True)``, the train CLI's ``--distributed``) on the CPU, as
gloo ranks (``--allow-cpu-mesh``): two ranks started as subprocesses
against one process's 2-entry mesh, a one-rank group in this process, and
the refusals.

Tolerances: the ranks' parameters after two steps within 1e-6 of the
one-process mesh's (the all-reduce adds the two ranks' sums in another
order than one process's two entries; on the CPU they are equal), and
identical across the ranks (every rank applies the same reduced gradient).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ubdvss_tpu_torch import train as ptrain
from ubdvss_tpu_torch.data import Batches, DataConfig
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.parallel import make_mesh, shard_batch_to_mesh
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader
from ubdvss_tpu_torch.utils.checkpoint import CheckpointManager, flat_from_params

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ARGS = ["--train-data", "synthetic", "--epochs", "1", "--batch-size", "4", "--synthetic-samples", "8",
        "--train-size", "64", "64", "--channels", "8", "--dilations", "1", "2", "--seed", "5",
        "--device", "cpu", "--allow-cpu-mesh"]

# one rank: the CLI, then its parameters and last metrics into a file; the
# MetricLogger's TensorFlow import is kept out (its writer is not what is
# tested, and it costs seconds a process)
RANK = """
import json, sys
import numpy as np
import torch
sys.modules["tensorflow"] = None
torch.set_num_threads(1)
from ubdvss_tpu_torch import train
from ubdvss_tpu_torch.utils.checkpoint import flat_from_params
out = sys.argv[1]
t = train.main(sys.argv[2:])
np.savez(out + ".npz", **flat_from_params({k: v.detach() for k, v in t.state.params.items()}))
json.dump({"rank": t.mesh.process_index, "world": t.mesh.process_count, "step": t.state.step,
           "entries": t.mesh.size, "loss": t._last_train_metrics["loss"]}, open(out + ".json", "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_a_two_entry_mesh(tmp_path):
    """(g) ``--distributed`` with two gloo ranks on a free localhost port,
    a process each, one entry each: after two steps (with the
    augmentation) both hold the parameters of one process's 2-entry mesh,
    and only rank 0 writes the log directory and the checkpoint."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(2):
        cmd = [sys.executable, "-c", RANK, str(tmp_path / f"rank{rank}"), *ARGS, "--distributed",
               "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id", str(rank),
               "--num-devices", "2", "--logdir", str(tmp_path / f"run{rank}")]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    assert "single process" not in outs[0][0] + outs[1][0]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert [(r["rank"], r["world"], r["step"], r["entries"]) for r in ranks] == [(0, 2, 2, 1), (1, 2, 2, 1)]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    one = ptrain.main(ARGS + ["--num-devices", "2"])
    assert one.mesh.size == 2 and one.mesh.process_group is None
    want = flat_from_params({k: v.detach() for k, v in one.state.params.items()})
    for k in want:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        np.testing.assert_allclose(got[0][k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert abs(ranks[0]["loss"] - one._last_train_metrics["loss"]) <= 1e-6
    assert CheckpointManager(tmp_path / "run0" / "checkpoints").latest_step() == 2
    assert (tmp_path / "run0" / "net_config.json").is_file()
    assert not (tmp_path / "run1").exists()


def test_one_rank_group_reduces_through_all_reduce(monkeypatch, capsys):
    """``setup_devices(distributed=True)`` in this process at world size 1
    (gloo): the single-process notice, a mesh of the process group, and a
    step that calls ``all_reduce`` and equals the step without a group."""
    port = _free_port()
    calls = []
    inner = dist.all_reduce

    def counting(t, *a, **kw):
        calls.append(tuple(t.shape))
        return inner(t, *a, **kw)

    monkeypatch.setattr(dist, "all_reduce", counting)
    mesh = ptrain.setup_devices("2", distributed=True, coordinator=f"localhost:{port}", num_processes=1,
                                process_id=0, allow_cpu_mesh=True)
    try:
        assert "single process" in capsys.readouterr().out
        assert mesh.size == 2 and mesh.process_count == 1 and mesh.process_index == 0
        assert "process 0 of 1" in repr(mesh)
        cfg = NetConfig(channels=8, dilations=(1, 2))
        reader = SyntheticMarkupReader(n_samples=4, image_hw=(64, 64), seed=1)
        batch = next(iter(Batches(reader, cfg, DataConfig(batch_size=4, train_hw=(64, 64), augment=None),
                                  device="cpu").epoch(0)))
        a = ptrain.create_train_state(cfg, device="cpu")
        b = ptrain.create_train_state(cfg, device="cpu")
        a, ma = ptrain.train_step(a, shard_batch_to_mesh(batch, mesh), cfg, mesh=mesh)
        local = make_mesh(2, devices=["cpu"] * 2)
        b, mb = ptrain.train_step(b, shard_batch_to_mesh(batch, local), cfg, mesh=local)
        assert len(calls) == 2  # the gradient, then the metric sums
        assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
        assert float(ma["loss"]) == float(mb["loss"])
    finally:
        dist.destroy_process_group()


def test_distributed_refusals():
    """Without a card and without ``allow_cpu_mesh``, ``--distributed``
    raises rather than training on the host CPU; a ``--num-devices`` that
    is not a count raises after the group is up, and a second call reuses
    the group (the environment's world, here one process)."""
    if torch.cuda.is_available():
        pytest.skip("the refusal is the card-less path")
    with pytest.raises(RuntimeError, match="allow-cpu-mesh"):
        ptrain.setup_devices("2", distributed=True)
    with pytest.raises(RuntimeError, match="allow-cpu-mesh"):
        ptrain.main(ARGS[:-1] + ["--distributed"])
    port = _free_port()
    try:
        with pytest.raises(ValueError, match="integer or 'auto'"):
            ptrain.setup_devices("two", distributed=True, coordinator=f"localhost:{port}", num_processes=1,
                                 process_id=0, allow_cpu_mesh=True)
        assert dist.is_initialized()
        mesh = ptrain.setup_devices("3", distributed=True, allow_cpu_mesh=True)
        assert mesh.size == 3 and mesh.process_count == 1
        assert ptrain.setup_devices(None, distributed=True, allow_cpu_mesh=True).size == 1
    finally:
        dist.destroy_process_group()

"""Training: the train step, the Trainer and the CLI entry point.

Counterpart of ``ubdvss_tpu/train.py``: the CLI over dataset paths /
epochs / batch size / lr / logdir / resume builds the model and the batch
pipeline, runs the fit loop with checkpoints and metric logging, and can
export portable weights.

    python -m ubdvss_tpu_torch.train --train-data synthetic --epochs 5 \
        --batch-size 8 --lr 1e-3 --logdir /tmp/run1 [--device cpu]
    python -m ubdvss_tpu_torch.train --train-data synthetic-device \
        --val-data synthetic-device [--steps-per-dispatch 16]
    python -m ubdvss_tpu_torch.train --train-data synthetic --cache-device

One step is the forward (``models/model.train_apply``: the module in f32,
the dense equivalent for bf16 separable configs), the mined loss, the
backward, an Adam (AdamW with ``weight_decay``) update with optax's
defaults and the learning rate of optax's schedule formulas read at the
step count before the update, and the pixel metrics.  The forward and the
backward run inside ``compute_precision(cfg)`` (TF32 off; bf16 reduced in
f32).  The state lives on the card unless ``device="cpu"`` is given.

Device-fed training: over scenes synthesized on the device
(``synthgen.DeviceSyntheticBatches``, ``--train-data synthetic-device``)
or a corpus held there (``data.DeviceCachedBatches``, ``--cache-device``)
the Trainer builds each batch and runs its step on one stream with no host
round trip between them (``make_fused_synth_step``,
``make_fused_cached_step``), ``steps_per_dispatch`` steps a call (JAX
scans them in one program; a CUDA graph of a chunk is not used here), and
logs and checkpoints at chunk boundaries.  The sample stream is the
unfused one's.  Host-fed batches keep the prefetch thread.

Data parallelism: ``Trainer(mesh=)`` (``--num-devices N``) shards each
batch over the mesh's data axis and runs the forward and backward of each
shard on its entry, one after another; the gradients are summed onto the
first entry in entry order and divided by the shards (the loss is a mean
of per-sample losses, so that is the whole batch's gradient), the one
optimizer state there takes the step, and the replicas on other devices
are refreshed from it.  The loss and its parts are the shards' mean, the
pixel metrics those of the summed counts, ``grad_norm`` the norm of the
reduced gradient: the unsharded step's values.  The device-fed pipelines
build each entry's shard on its entry from the whole batch's draws, so
sharded and unsharded training see the same samples.  ``--distributed``
(``setup_devices(distributed=True)``) runs one such mesh a process under
``torch.distributed`` (NCCL on the cards, gloo on the CPU when asked for),
each process taking its slice of every global batch, the gradients
summed over the processes by ``all_reduce``; process 0 alone writes logs,
checkpoints and ``net_config.json``.

    python -m ubdvss_tpu_torch.train --train-data synthetic --num-devices 4
    torchrun --nproc-per-node 2 -m ubdvss_tpu_torch.train --distributed \
        --train-data synthetic-device --num-devices 2
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import Any, Callable

import numpy as np
import torch

from ubdvss_tpu_torch.data import Batches, DataConfig, DeviceCachedBatches
from ubdvss_tpu_torch.inference import resolve_device
from ubdvss_tpu_torch.losses import total_loss
from ubdvss_tpu_torch.metrics import metrics_from_pixel_counts, pixel_counts, pixel_detection_metrics
from ubdvss_tpu_torch.models.model import compute_precision, init_params, train_apply
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.parallel.mesh import entry_rows, reduce_to_first, replicate_params, shard_batch_to_mesh
from ubdvss_tpu_torch.utils.checkpoint import CheckpointManager
from ubdvss_tpu_torch.utils.logging_util import MetricLogger

_F32 = np.float32


def make_lr_schedule(
    kind: str,
    lr: float,
    warmup_steps: int = 0,
    decay_steps: int = 10_000,
    end_factor: float = 0.01,
) -> Callable[[int], float]:
    """Step count -> learning rate, by the formulas of optax's
    ``constant_schedule``, ``cosine_decay_schedule(lr, decay_steps,
    alpha=end_factor)`` and ``exponential_decay(lr, decay_steps,
    decay_rate=end_factor)``, with a ``linear_schedule(0, lr,
    warmup_steps)`` joined in front (``join_schedules``), in f32 as optax
    computes them."""
    lr32 = _F32(lr)
    if kind == "constant":
        def sched(count):
            return lr32
    elif kind == "cosine":
        def sched(count):
            c = min(_F32(count), _F32(decay_steps))
            cos = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
            return lr32 * (_F32(1.0 - end_factor) * cos + _F32(end_factor))
    elif kind == "exponential":
        def sched(count):
            if count <= 0:
                return lr32
            return lr32 * np.power(_F32(end_factor), _F32(count) / _F32(decay_steps))
    else:
        raise ValueError(f"unknown schedule {kind!r}")
    if warmup_steps <= 0:
        return lambda count: float(sched(count))

    def warm(count):
        frac = _F32(1) - _F32(min(max(count, 0), warmup_steps)) / _F32(warmup_steps)
        return (_F32(0) - lr32) * frac + lr32

    return lambda count: float(warm(count) if count < warmup_steps else sched(count - warmup_steps))


@dataclasses.dataclass
class TrainState:
    """Parameters (leaf tensors in state_dict layout), their optimizer, the
    learning-rate schedule and the step count."""

    params: dict[str, torch.Tensor]
    tx: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0
    # the parameters' replicas on a mesh's other devices (device -> leaves;
    # parallel.mesh.replicate_params), refreshed before each sharded step
    replicas: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def state_dict(self) -> dict:
        """What a checkpoint holds: parameters, optimizer state, step and
        the generator states of the host and of the state's card."""
        rng = {"cpu": torch.get_rng_state()}
        if self.device.type == "cuda":
            rng["cuda"] = torch.cuda.get_rng_state(self.device)
        return {
            "params": {k: v.detach().clone() for k, v in self.params.items()},
            "opt_state": self.tx.state_dict(),
            "step": self.step,
            "rng": rng,
        }

    def load_state_dict(self, d: dict) -> None:
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(d["params"][k])
        self.tx.load_state_dict(d["opt_state"])
        self.step = int(d["step"])
        torch.set_rng_state(d["rng"]["cpu"].cpu())
        if "cuda" in d["rng"] and self.device.type == "cuda":
            torch.cuda.set_rng_state(d["rng"]["cuda"].cpu(), self.device)


def create_train_state(
    cfg: NetConfig,
    lr: float = 1e-3,
    seed: int = 0,
    weight_decay: float = 0.0,
    schedule: str = "constant",
    warmup_steps: int = 0,
    decay_steps: int = 10_000,
    device=None,
    params: dict | None = None,
) -> TrainState:
    """A fresh train state on ``device`` (the card unless "cpu"):
    ``init_params(cfg, seed)``, or a copy of ``params`` when given; Adam,
    or AdamW with ``weight_decay`` (every parameter decayed), at optax's
    defaults b1 0.9, b2 0.999, eps 1e-8."""
    dev = resolve_device(device)
    src = init_params(cfg, seed) if params is None else params
    leaves = {k: v.detach().to(dev, torch.float32).clone().requires_grad_() for k, v in src.items()}
    sched = make_lr_schedule(schedule, lr, warmup_steps, decay_steps)
    kw = dict(lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    tx = (
        torch.optim.AdamW(leaves.values(), weight_decay=weight_decay, **kw)
        if weight_decay
        else torch.optim.Adam(leaves.values(), **kw)
    )
    return TrainState(leaves, tx, sched)


def _cls_weight(step: int, cls_schedule) -> torch.Tensor:
    """The classification-loss weight of a (base, end, ramp_steps) ramp at
    ``step``, in f32 as the JAX step computes it from ``state.step``: a 0-d
    host tensor (the card reads it as a scalar, with no copy)."""
    base, end, ramp = (_F32(v) for v in cls_schedule)
    frac = np.clip(_F32(step) / max(ramp, _F32(1.0)), _F32(0.0), _F32(1.0))
    return torch.tensor(base + (end - base) * frac, dtype=torch.float32)


def _check_finite(what: str, tensors) -> None:
    for name, t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite {what}: {name}")


def _apply_update(state: TrainState, names: list, leaves: list, grads, checked: bool) -> None:
    if checked:
        _check_finite("gradient", zip(names, grads))
    for p, g in zip(leaves, grads):
        p.grad = g
    for group in state.tx.param_groups:
        group["lr"] = state.schedule(state.step)
    state.tx.step()
    state.step += 1
    if checked:
        _check_finite("parameter after the update", zip(names, leaves))


def _step(state: TrainState, batch: dict, cfg: NetConfig, cls_schedule, checked: bool):
    cls_w = None if cls_schedule is None else _cls_weight(state.step, cls_schedule)
    names = sorted(state.params)  # the JAX package's leaf order
    leaves = [state.params[k] for k in names]
    with compute_precision(cfg):
        logits = train_apply(state.params, batch["images"], cfg)
        loss, aux = total_loss(logits, batch["segmap"], cfg, cls_weight=cls_w)
        if checked:
            _check_finite("loss", [("loss", loss)])
        grads = torch.autograd.grad(loss, leaves)
    _apply_update(state, names, leaves, grads, checked)
    metrics = {k: v.detach() for k, v in aux.items()}
    metrics.update(pixel_detection_metrics(logits[..., 0].detach(), batch["segmap"]))
    metrics["grad_norm"] = torch.sqrt(sum(g.square().sum() for g in grads))
    if cls_w is not None:
        metrics["cls_weight"] = cls_w
    return state, metrics


def _shard_sums(aux: dict, logits: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
    """What a shard adds to the batch's metrics: its loss parts (means over
    its samples) in key order, then its ``pixel_counts``, as f64 (counts
    exact)."""
    parts = torch.stack([aux[k].detach().to(torch.float64) for k in sorted(aux)])
    return torch.cat([parts, pixel_counts(logits[..., 0].detach(), segmap).to(parts.device, torch.float64)])


def _metrics_from_sums(sums: torch.Tensor, keys: list, n_shards: int, n_pixels: int) -> dict:
    """The batch's metrics from ``_shard_sums`` summed over its
    ``n_shards`` equal shards of ``n_pixels`` pixels in all."""
    metrics = {k: (sums[i] / n_shards).to(torch.float32) for i, k in enumerate(keys)}
    metrics.update(metrics_from_pixel_counts(sums[len(keys):].to(torch.int64), n_pixels))
    return metrics


def _check_shards(shards, mesh) -> list:
    devs = mesh.axis_devices("data")
    if not isinstance(shards, (list, tuple)) or len(shards) != len(devs):
        raise ValueError(f"a mesh step takes a list of {len(devs)} shards (parallel.mesh.shard_batch_to_mesh)")
    return devs


def _mesh_step(state: TrainState, shards: list, cfg: NetConfig, cls_schedule, checked: bool, mesh):
    """``_step`` on a batch split over ``mesh``'s data axis: forward and
    backward of shard i on entry i with that entry's replica, the
    gradients and metric sums reduced onto the first entry (and over the
    processes), the update there."""
    devs = _check_shards(shards, mesh)
    n_shards = len(devs) * mesh.process_count
    cls_w = None if cls_schedule is None else _cls_weight(state.step, cls_schedule)
    names = sorted(state.params)
    flat_grads, sums = [], []
    for params, shard in zip(replicate_params(state.params, devs, state.replicas), shards):
        with compute_precision(cfg):
            logits = train_apply(params, shard["images"], cfg)
            loss, aux = total_loss(logits, shard["segmap"], cfg, cls_weight=cls_w)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        flat_grads.append(torch.cat([g.reshape(-1) for g in grads]))
        sums.append(_shard_sums(aux, logits, shard["segmap"]))
    flat = reduce_to_first(flat_grads, mesh) / n_shards
    n_pixels = sum(s["segmap"].numel() for s in shards) * mesh.process_count
    metrics = _metrics_from_sums(reduce_to_first(sums, mesh), sorted(aux), n_shards, n_pixels)
    if checked:
        _check_finite("loss", [("loss", metrics["loss"])])
    leaves = [state.params[k] for k in names]
    grads = [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in leaves]), leaves)]
    _apply_update(state, names, leaves, grads, checked)
    metrics["grad_norm"] = torch.sqrt(sum(g.square().sum() for g in grads))
    if cls_w is not None:
        metrics["cls_weight"] = cls_w
    return state, metrics


def train_step(state: TrainState, batch, cfg: NetConfig, cls_schedule=None, mesh=None):
    """One optimization step on ``state`` (updated in place); returns
    (state, metrics): the loss and its parts, the pixel metrics,
    ``grad_norm`` (the global norm of the gradients) and, with a
    ``cls_schedule`` (base, end, ramp_steps) — the classification-loss
    weight ramping linearly from base to end over ramp_steps, read from
    the step count — ``cls_weight``.  Metrics stay 0-d device tensors.

    ``mesh``: ``batch`` is the list of its shards over the mesh's data
    axis (``parallel.mesh.shard_batch_to_mesh``) and ``state`` lives on
    the axis's first entry; the step and its metrics are the whole
    batch's (module docstring)."""
    if mesh is not None:
        return _mesh_step(state, batch, cfg, cls_schedule, False, mesh)
    return _step(state, batch, cfg, cls_schedule, checked=False)


def checked_train_step(state: TrainState, batch, cfg: NetConfig, cls_schedule=None, mesh=None):
    """``train_step`` with finite checks on the loss, the gradients and the
    updated parameters: raises ``FloatingPointError`` naming the first
    poisoned one (a poisoned loss or gradient before the update).  Over a
    mesh the checks read the reduced values, so a poisoned shard raises
    in every process alike."""
    if mesh is not None:
        return _mesh_step(state, batch, cfg, cls_schedule, True, mesh)
    return _step(state, batch, cfg, cls_schedule, checked=True)


def make_fused_synth_step(sc, cfg: NetConfig, dc: DataConfig, mesh=None):
    """Steps over scenes synthesized on the device: ``fused(state, seed,
    epoch, step_idx, cls_schedule=None, steps=1)`` builds the batch of step
    ``step_idx + s`` of ``epoch`` (``synthgen.synth_batch_step`` from the
    generator of (seed, epoch, step)) and runs ``train_step`` on it, for
    ``s`` in ``range(steps)``, on the state's device with no host round
    trip between them; it returns the state and the last step's metrics.
    The stream is ``DeviceSyntheticBatches.epoch``'s, so fused and unfused
    training end at the same parameters.

    ``mesh``: each entry of the data axis seeds the step's generator on its
    own device, draws the whole batch's draws and synthesizes only its
    rows (``parallel.mesh.entry_rows``); the shards are the unsharded
    batch's rows bit for bit."""
    from ubdvss_tpu_torch.synthgen import step_generator, synth_batch_step

    def batch(seed, epoch, step, device):
        if mesh is None:
            return synth_batch_step(step_generator(seed, epoch, step, device), sc, cfg, dc, True)
        return [synth_batch_step(step_generator(seed, epoch, step, d), sc, cfg, dc, True,
                                 rows=entry_rows(dc.batch_size, mesh, i))
                for i, d in enumerate(mesh.axis_devices("data"))]

    def fused(state, seed, epoch, step_idx, cls_schedule=None, steps: int = 1):
        metrics = None
        for s in range(steps):
            state, metrics = train_step(state, batch(seed, epoch, step_idx + s, state.device), cfg,
                                        cls_schedule, mesh=mesh)
        return state, metrics

    return fused


def make_fused_cached_step(cfg: NetConfig, dc: DataConfig, mesh=None):
    """Steps over a corpus held on the device: ``fused(state, batches,
    order, epoch, bi, cls_schedule=None, steps=1)`` gathers batch
    ``bi + s`` of the epoch whose ``order`` is given from the
    ``data.DeviceCachedBatches`` ``batches`` (built with ``cfg`` and
    ``dc``), augments and rasterizes it and runs ``train_step``, for ``s``
    in ``range(steps)``; it returns the state and the last step's metrics.
    The stream is ``DeviceCachedBatches.epoch``'s.

    ``mesh``: ``order`` is the host order (``host_order``), the corpus is
    sharded over the mesh, and each entry builds its shard
    (``DeviceCachedBatches.shards_at``)."""

    def batch(batches, order, epoch, bi):
        if mesh is None:
            return batches.batch_at(order, epoch, bi)
        return batches.shards_at(order, epoch, bi, mesh)

    def fused(state, batches, order, epoch, bi, cls_schedule=None, steps: int = 1):
        metrics = None
        for b in range(steps):
            state, metrics = train_step(state, batch(batches, order, epoch, bi + b), cfg, cls_schedule, mesh=mesh)
        return state, metrics

    return fused


def eval_step(state: TrainState, batch, cfg: NetConfig, mesh=None) -> dict:
    """Loss and pixel metrics of a batch through the training forward.
    ``mesh``: ``batch`` is its shard list, as ``train_step``'s; the metrics
    are the whole batch's (the pixel metrics from the summed counts)."""
    if mesh is None:
        with torch.no_grad(), compute_precision(cfg):
            logits = train_apply(state.params, batch["images"], cfg)
            _, aux = total_loss(logits, batch["segmap"], cfg)
        metrics = dict(aux)
        metrics.update(pixel_detection_metrics(logits[..., 0], batch["segmap"]))
        return metrics
    devs = _check_shards(batch, mesh)
    sums = []
    with torch.no_grad(), compute_precision(cfg):
        for params, shard in zip(replicate_params(state.params, devs, state.replicas), batch):
            logits = train_apply(params, shard["images"], cfg)
            _, aux = total_loss(logits, shard["segmap"], cfg)
            sums.append(_shard_sums(aux, logits, shard["segmap"]))
    n_pixels = sum(s["segmap"].numel() for s in batch) * mesh.process_count
    return _metrics_from_sums(reduce_to_first(sums, mesh), sorted(aux), len(devs) * mesh.process_count, n_pixels)


@dataclasses.dataclass
class Trainer:
    """Fit loop with checkpoints (the latest ones, and the best by
    ``best_metric`` over the validation batches), metric logging,
    prediction image summaries, the learning-rate schedule, the
    cls-weight ramp and optional finite checks (``debug_checks``).

    ``mesh``: data parallelism over a ``parallel.mesh.Mesh`` with a "data"
    axis (module docstring); the batch size must divide into its entries
    (over all its processes).  The state lives on the axis's first entry,
    which ``device`` must be if given; logs and checkpoints are written by
    the mesh's process 0 alone."""

    cfg: NetConfig
    data_cfg: DataConfig
    lr: float = 1e-3
    schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 10_000
    weight_decay: float = 0.0
    logdir: str | None = None
    checkpoint_every: int = 200
    log_every: int = 20
    image_summaries: bool = True
    best_metric: str | None = "pixel_f1"
    debug_checks: bool = False
    seed: int = 0
    # cls-weight schedule: ramp classification_loss_weight -> cls_weight_end
    # over cls_weight_ramp_steps (None = constant cfg weight)
    cls_weight_end: float | None = None
    cls_weight_ramp_steps: int = 10_000
    device: Any = None
    # device-fed pipelines only: this many steps a dispatch (logging and
    # checkpoints fall on chunk boundaries); None = auto (16), 1 = a step
    steps_per_dispatch: int | None = None
    mesh: Any = None  # parallel.mesh.Mesh for data parallelism

    def __post_init__(self):
        if self.mesh is not None:
            n = len(self.mesh.axis_devices("data")) * self.mesh.process_count
            if self.data_cfg.batch_size % n:
                raise ValueError(f"batch_size={self.data_cfg.batch_size} not divisible by the {n}-device data mesh")
            first = self.mesh.axis_devices("data")[0]
            dev = None if self.device is None else torch.device(self.device)
            if dev is not None and (dev.type != first.type or dev.index not in (None, first.index)):
                raise ValueError(f"device {self.device} is not the mesh's first entry {first}")
            self.device = first
        self.device = resolve_device(self.device)
        self._chief = self.mesh is None or self.mesh.process_index == 0
        self.state = self.place_state(self._fresh_state())
        self.logger = MetricLogger(self.logdir if self._chief else None)
        if self.logdir and self._chief:
            # architecture sidecar: evaluate/detect rebuild the exact model
            os.makedirs(self.logdir, exist_ok=True)
            with open(f"{self.logdir}/net_config.json", "w") as f:
                f.write(self.cfg.to_json())
        self.ckpt = CheckpointManager(f"{self.logdir}/checkpoints") if self.logdir else None
        self.best_ckpt = (
            CheckpointManager(f"{self.logdir}/best", max_to_keep=1, best_metric=self.best_metric)
            if self.logdir and self.best_metric
            else None
        )
        self._last_val_metrics: dict | None = None
        self._last_train_metrics: dict | None = None
        # the fused data-into-step callables, by (pipeline kind, its configs)
        self._fused_steps: dict = {}

    def _fresh_state(self) -> TrainState:
        return create_train_state(
            self.cfg, self.lr, self.seed, weight_decay=self.weight_decay,
            schedule=self.schedule, warmup_steps=self.warmup_steps,
            decay_steps=self.decay_steps, device=self.device,
        )

    def maybe_resume(self) -> int:
        if self.ckpt and self.ckpt.latest_step() is not None:
            self.state = self.place_state(self.ckpt.restore(self.state))
            print(f"resumed from step {self.state.step}")
        return self.state.step

    def place_state(self, state: TrainState) -> TrainState:
        """The state as a mesh step takes it: its one optimizer state on the
        data axis's first entry, the parameters replicated on the other
        distinct devices (``parallel.mesh.replicate_params``; refreshed
        again before every step).  No-op without a mesh."""
        if self.mesh is not None:
            replicate_params(state.params, self.mesh.axis_devices("data"), state.replicas)
        return state

    def place_batch(self, batch: dict):
        """Shard every leaf's leading (batch) dim over the data mesh (this
        process's slice of it); no-op without a mesh."""
        if self.mesh is None:
            return batch
        return shard_batch_to_mesh(batch, self.mesh)

    def _cls_sched(self):
        if self.cls_weight_end is None:
            return None
        return (self.cfg.classification_loss_weight, self.cls_weight_end,
                float(self.cls_weight_ramp_steps))

    def step_fn(self, state: TrainState, batch):
        """One optimization step on an already-placed batch (checked under
        ``debug_checks``)."""
        step = checked_train_step if self.debug_checks else train_step
        return step(state, batch, self.cfg, self._cls_sched(), mesh=self.mesh)

    def _steps_per_dispatch(self) -> int:
        """Steps a dispatch on the device-fed pipelines: auto picks 16, as
        the JAX package (launch latency amortized over the chunk, logging
        and checkpoint cadence still usable)."""
        return 16 if self.steps_per_dispatch is None else max(1, self.steps_per_dispatch)

    def _epoch_steps(self, train_batches, epoch: int):
        """``(thunk, n_steps)`` pairs for one epoch, each ``thunk: state ->
        (state, metrics)`` advancing ``n_steps`` steps.

        The device-fed pipelines build the batch inside the step's callable
        (``make_fused_synth_step``, ``make_fused_cached_step``),
        ``steps_per_dispatch`` steps a thunk; the cached path's partial tail
        (``drop_remainder=False``) is one unfused step.  Under
        ``debug_checks`` nothing is fused (each step checked), and host-fed
        batches come through the prefetch thread, sharded over the mesh
        when there is one.  The fused callables are kept by (pipeline,
        configs, mesh): a second ``fit`` on another mesh builds its own."""
        from ubdvss_tpu_torch.synthgen import DeviceSyntheticBatches
        from ubdvss_tpu_torch.utils.prefetch import prefetched

        fuse = not self.debug_checks
        sched = self._cls_sched()
        k_max = self._steps_per_dispatch()
        if fuse and isinstance(train_batches, DeviceSyntheticBatches):
            tb = train_batches
            fkey = ("synth", tb.sc, tb.data_cfg, self.mesh)
            if fkey not in self._fused_steps:
                self._fused_steps[fkey] = make_fused_synth_step(tb.sc, self.cfg, tb.data_cfg, mesh=self.mesh)
            fused_s = self._fused_steps[fkey]
            n = len(tb)
            k = min(k_max, n)
            for s in range(0, n, k):
                kk = min(k, n - s)
                yield (lambda st, s=s, kk=kk: fused_s(st, tb.seed, epoch, s, sched, steps=kk)), kk
            return
        if fuse and isinstance(train_batches, DeviceCachedBatches):
            tb = train_batches
            fkey = ("cached", tb.data_cfg, self.mesh)
            if fkey not in self._fused_steps:
                self._fused_steps[fkey] = make_fused_cached_step(self.cfg, tb.data_cfg, mesh=self.mesh)
            fused_c = self._fused_steps[fkey]
            if self.mesh is None:
                order = tb.order(epoch)
            else:
                tb.place_on_mesh(self.mesh)
                order = tb.host_order(epoch)
            n_full = tb._n // tb.data_cfg.batch_size
            k = max(1, min(k_max, n_full))
            for bi in range(0, n_full, k):
                kk = min(k, n_full - bi)
                yield (lambda st, bi=bi, kk=kk: fused_c(st, tb, order, epoch, bi, sched, steps=kk)), kk
            if n_full < len(tb):  # the partial tail (drop_remainder=False)
                yield (lambda st: self.step_fn(st, tb.batch_at(order, epoch, n_full) if self.mesh is None
                                               else tb.shards_at(order, epoch, n_full, self.mesh))), 1
            return
        for batch in prefetched(train_batches.epoch(epoch), depth=2, device=self.device):
            yield (lambda st, b=batch: self.step_fn(st, self.place_batch(b))), 1

    def _image_summary(self, step: int, batch: dict) -> None:
        """Prediction overlays for the first val images (host, off the hot path)."""
        from ubdvss_tpu_torch.ops.postproc import postprocess_batch
        from ubdvss_tpu_torch.utils.visualization import detection_summary_image

        if self.mesh is not None:
            batch = self.place_batch(batch)[0]
        with torch.no_grad(), compute_precision(self.cfg):
            logits = train_apply(self.state.params, batch["images"][:2], self.cfg)
            res = {k: v.cpu().numpy() for k, v in postprocess_batch(logits, self.cfg).items()}
        imgs = batch["images"][:2, ..., 0].cpu().numpy() * 127.5 + 127.5
        for i in range(imgs.shape[0]):
            img = detection_summary_image(imgs[i], {k: v[i] for k, v in res.items()})
            self.logger.log_image(step, f"predictions_{i}", img)

    def fit(self, train_batches, epochs: int, val_batches=None) -> TrainState:
        """``epochs`` passes over ``train_batches`` (``_epoch_steps``: host-fed
        batches prefetched two deep, device-fed ones built inside the step's
        chunk), then the validation pass, if any; logs and checkpoints at
        chunk boundaries (the mesh's process 0 alone)."""
        step = self.state.step
        metrics = None
        last_logged = last_saved = step
        for epoch in range(epochs):
            for run, k in self._epoch_steps(train_batches, epoch):
                self.state, metrics = run(self.state)
                step += k
                if step - last_logged >= self.log_every:
                    self.logger.log(step, {k: float(v) for k, v in metrics.items()}, "train")
                    last_logged = step
                if self.ckpt and step - last_saved >= self.checkpoint_every:
                    if self._chief:
                        self.ckpt.save(step, self.state)
                    last_saved = step
            if val_batches is not None:
                agg: dict[str, list] = {}
                first_batch = None
                for batch in val_batches.epoch(0):
                    if first_batch is None:
                        first_batch = batch
                    for k, v in eval_step(self.state, self.place_batch(batch), self.cfg, mesh=self.mesh).items():
                        agg.setdefault(k, []).append(float(v))
                val_metrics = {k: float(np.mean(v)) for k, v in agg.items()}
                self._last_val_metrics = val_metrics
                self.logger.log(step, val_metrics, "val")
                if self.image_summaries and first_batch is not None and self._chief:
                    self._image_summary(step, first_batch)
                if self.best_ckpt and self.best_metric in val_metrics and self._chief:
                    self.best_ckpt.save(step, self.state, metrics=val_metrics)
        if metrics is not None:
            self._last_train_metrics = {k: float(v) for k, v in metrics.items()}
        if self.ckpt and self._chief:
            self.ckpt.save(step, self.state)
        return self.state

    def export_params(self, prefer_best: bool = True) -> dict[str, torch.Tensor]:
        """Host copy of the trained params — the best checkpoint's when a
        save-best checkpointer has ranked any, else the final step's."""
        if prefer_best and self.best_ckpt and self.best_ckpt.best_step() is not None:
            return self.best_ckpt.restore_params(self.best_ckpt.best_step())
        return {k: v.detach().cpu().clone() for k, v in self.state.params.items()}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the barcode detector")
    p.add_argument("--train-data", required=True,
                   help="dataset root, 'synthetic' (host-rendered), or "
                        "'synthetic-device' (scenes synthesized on the device: no host feed)")
    p.add_argument("--val-data", default=None)
    p.add_argument("--markup-format", default="zvz-json",
                   help="zvz-json | zvz-xml | synthetic")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--logdir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--train-size", type=int, nargs=2, default=(256, 256), metavar=("H", "W"))
    p.add_argument("--detection-only", action="store_true")
    p.add_argument("--channels", type=int, default=None,
                   help="context-module width (default NetConfig.channels)")
    p.add_argument("--dilations", type=int, nargs="+", default=None,
                   help="context-module dilation schedule")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16 = mixed-precision training (bf16 trunk, "
                        "f32 master weights/optimizer/logits)")
    p.add_argument("--no-separable-context", action="store_true",
                   help="dense 3x3 context convs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--synthetic-samples", type=int, default=256)
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="device-fed pipelines: steps a dispatch, no host round trip "
                        "between them (logging and checkpoints at chunk boundaries); "
                        "default auto (16), 1 = a step")
    p.add_argument("--cache-device", action="store_true",
                   help="hold the decoded training corpus on the device "
                        "(data.DeviceCachedBatches): no host collate or copy a step")
    p.add_argument("--schedule", default="constant", choices=["constant", "cosine", "exponential"])
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--decay-steps", type=int, default=10_000)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--cls-weight-end", type=float, default=None,
                   help="ramp the classification-loss weight linearly from its "
                        "NetConfig value to this over --cls-weight-ramp-steps")
    p.add_argument("--cls-weight-ramp-steps", type=int, default=10_000)
    p.add_argument("--export-npz", default=None,
                   help="after training, write portable weights (+ net_config "
                        "sidecar) here — best-checkpoint params when available, else final")
    p.add_argument("--debug-nan", action="store_true",
                   help="finite checks on the loss, gradients and parameters each step")
    p.add_argument("--profile", default=None, help="capture a torch.profiler trace into this dir")
    p.add_argument("--num-devices", default=None,
                   help="data-parallel over N mesh entries ('auto' = every card): each batch is sharded "
                        "over them, the gradients summed onto the first; with --distributed, N entries "
                        "over all the processes (default one a process)")
    p.add_argument("--allow-cpu-mesh", action="store_true",
                   help="permit --num-devices past the cards to take CPU entries, and --distributed "
                        "without a card to run gloo ranks on the CPU (tests and dry runs)")
    p.add_argument("--distributed", action="store_true",
                   help="several processes (torch.distributed: NCCL, one card a process): "
                        "init_process_group before the mesh; each process trains on its slice of "
                        "every batch and the gradients are all-reduced")
    p.add_argument("--coordinator", default=None,
                   help="with --distributed: host:port of process 0 (else the MASTER_ADDR, "
                        "MASTER_PORT, RANK and WORLD_SIZE environment, as torchrun sets it)")
    p.add_argument("--num-processes", type=int, default=None, help="with --distributed: the world size")
    p.add_argument("--process-id", type=int, default=None, help="with --distributed: this process's rank")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; under --num-devices / --distributed the mesh's entries decide")
    return p


def _setup_distributed(num_devices, coordinator, num_processes, process_id, allow_cpu_mesh):
    """``setup_devices(distributed=True)``: the process group first, then
    this process's mesh."""
    import torch.distributed as dist

    from ubdvss_tpu_torch.parallel.mesh import make_mesh

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards == 0 and not allow_cpu_mesh:
        raise RuntimeError(
            "--distributed: no CUDA device (NCCL takes one card a process); refusing to fall back "
            "to gloo ranks on the host CPU — pass --allow-cpu-mesh for CPU test and dry runs")
    if not dist.is_initialized():
        kw: dict[str, Any] = {"init_method": "env://" if coordinator is None else f"tcp://{coordinator}"}
        if num_processes is not None or coordinator is not None:
            kw["world_size"] = 1 if num_processes is None else num_processes
        if process_id is not None or coordinator is not None:
            kw["rank"] = 0 if process_id is None else process_id
        dist.init_process_group(backend="nccl" if n_cards else "gloo", **kw)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world <= 1:
        print("--distributed with a single process; the cross-process reduction has no other rank")
    if num_devices in (None, "auto"):
        n = world
    else:
        try:
            n = int(num_devices)
        except ValueError:
            raise ValueError(f"--num-devices must be an integer or 'auto', got {num_devices!r}") from None
    if n % world:
        raise ValueError(f"--num-devices {n} does not divide over {world} processes")
    if n_cards:
        torch.cuda.set_device(rank % n_cards)
        dev = torch.device("cuda", rank % n_cards)
    else:
        dev = torch.device("cpu")
    return make_mesh(n // world, axis="data", devices=[dev] * (n // world), process_group=dist.group.WORLD)


def setup_devices(
    num_devices: str | None,
    distributed: bool = False,
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    allow_cpu_mesh: bool = False,
):
    """Resolve a CLI's ``--num-devices`` request to a ``parallel.mesh.Mesh``
    on the axis "data", or None when none is asked for.

    ``"auto"`` takes every CUDA device, an integer the first n.  More than
    the cards present raises, naming ``--allow-cpu-mesh``; with it the
    mesh is n CPU entries (one for "auto"; tests and dry runs).  Unlike the JAX package,
    which falls back to its CPU devices when no accelerator exists, this
    raises without a card too unless ``allow_cpu_mesh`` is given: the
    port runs on the card unless asked for the CPU.

    ``distributed``: ``torch.distributed.init_process_group`` runs first,
    at ``tcp://<coordinator>`` with ``num_processes`` and ``process_id``
    when a coordinator is given, else from the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` environment (as torchrun
    sets it).  The backend is NCCL, each process taking card ``rank %
    device_count``; without a card it raises unless ``allow_cpu_mesh``,
    and then the ranks run gloo on the CPU.  ``num_devices`` counts the
    entries over all processes (default and "auto": one a process), each
    process's mesh repeating its device ``num_devices / world`` times,
    with the group as its ``process_group`` (it always reduces over it,
    one process included).
    """
    from ubdvss_tpu_torch.parallel.mesh import make_mesh

    if distributed:
        return _setup_distributed(num_devices, coordinator, num_processes, process_id, allow_cpu_mesh)
    if num_devices is None:
        return None
    if num_devices == "auto":
        n = None
    else:
        try:
            n = int(num_devices)
        except ValueError:
            raise ValueError(f"--num-devices must be an integer or 'auto', got {num_devices!r}") from None
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if (n is None and n_cards == 0) or (n is not None and n > n_cards):
        if not allow_cpu_mesh:
            raise ValueError(
                f"--num-devices {num_devices} exceeds the {n_cards} CUDA device(s); refusing to "
                "fall back to host CPU entries — pass --allow-cpu-mesh for CPU test and dry runs, "
                "or lower --num-devices")
        return make_mesh(n, axis="data", devices=["cpu"] * (n or 1))
    return make_mesh(n, axis="data")


def main(argv: list[str] | None = None) -> Trainer:
    args = build_argparser().parse_args(argv)
    mesh = setup_devices(args.num_devices, args.distributed, coordinator=args.coordinator,
                         num_processes=args.num_processes, process_id=args.process_id,
                         allow_cpu_mesh=args.allow_cpu_mesh)
    from ubdvss_tpu_torch.markup import get_markup_reader
    from ubdvss_tpu_torch.utils.checkpoint import save_params_npz
    from ubdvss_tpu_torch.utils.profiling import trace

    cfg_kw: dict[str, Any] = {"classification": not args.detection_only, "dtype": args.dtype}
    if args.channels is not None:
        cfg_kw["channels"] = args.channels
    if args.dilations is not None:
        cfg_kw["dilations"] = tuple(args.dilations)
    if args.no_separable_context:
        cfg_kw["separable_context"] = False
    cfg = NetConfig(**cfg_kw)
    dev = resolve_device(args.device) if mesh is None else mesh.axis_devices("data")[0]
    fmt = "synthetic" if args.train_data == "synthetic" else args.markup_format
    reader_kw: dict[str, Any] = {}
    if fmt == "synthetic":
        reader_kw = {"n_samples": args.synthetic_samples, "image_hw": tuple(args.train_size)}
    dc = DataConfig(
        batch_size=args.batch_size,
        train_hw=tuple(args.train_size),
        augment=None if args.no_augment else DataConfig().augment,
        seed=args.seed,
    )
    if args.train_data == "synthetic-device":
        from ubdvss_tpu_torch.synthgen import DeviceSyntheticBatches

        train_b = DeviceSyntheticBatches(cfg, dc, n_samples=args.synthetic_samples, seed=args.seed, device=dev)
    else:
        train_reader = get_markup_reader(fmt, args.train_data, **reader_kw)
        if args.cache_device:
            train_b = DeviceCachedBatches(train_reader, cfg, dc, train=True, mesh=mesh, device=dev)
        else:
            train_b = Batches(train_reader, cfg, dc, train=True, device=dev)
    val_b = None
    if args.val_data == "synthetic-device":
        from ubdvss_tpu_torch.synthgen import DeviceSyntheticBatches

        val_b = DeviceSyntheticBatches(cfg, dataclasses.replace(dc, shuffle=False),
                                       n_samples=args.synthetic_samples, seed=args.seed + 1,
                                       train=False, device=dev)
    elif args.val_data:
        vfmt = "synthetic" if args.val_data == "synthetic" else args.markup_format
        val_b = Batches(get_markup_reader(vfmt, args.val_data, **reader_kw), cfg,
                        dataclasses.replace(dc, shuffle=False), train=False, device=dev)
    trainer = Trainer(
        cfg, dc, lr=args.lr, schedule=args.schedule, warmup_steps=args.warmup_steps,
        decay_steps=args.decay_steps, weight_decay=args.weight_decay, logdir=args.logdir,
        debug_checks=args.debug_nan, seed=args.seed, cls_weight_end=args.cls_weight_end,
        cls_weight_ramp_steps=args.cls_weight_ramp_steps, device=dev,
        steps_per_dispatch=args.steps_per_dispatch, mesh=mesh,
    )
    if args.resume:
        trainer.maybe_resume()
    with trace(args.profile):
        trainer.fit(train_b, args.epochs, val_b)
    if args.export_npz and trainer._chief:
        save_params_npz(args.export_npz, trainer.export_params(), cfg=cfg)
    return trainer


if __name__ == "__main__":
    main()

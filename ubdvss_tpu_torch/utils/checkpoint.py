"""Weight files and training checkpoints.

Weight files: the flat ``.npz`` format and its ``.net_config.json``
sidecar.  The JAX package writes weights with ``save_params_npz``
(``ubdvss_tpu/utils/checkpoint.py``): one array per parameter, keyed by the
flax parameter path joined with ``"/"`` (``context_3/depthwise/kernel``),
kernels in HWIO layout.  ``params_from_flat`` carries those arrays into the
port's ``state_dict`` (OIHW kernels) and ``flat_from_params`` back, so the
two packages read each other's weight files (the port's ``save_params_npz``
writes the JAX layout); ``qparams_from_numpy`` carries the JAX package's
int8 qparams.

Training checkpoints: ``CheckpointManager`` keeps the train state —
parameters, optimizer state, step and generator states — in the port's own
format, one ``torch.save`` file a step (``ckpt_<step>.pt``, its metrics
beside it in ``ckpt_<step>.json``), where the JAX package keeps orbax
directories.  The port does not read orbax checkpoints: the JAX trainer's
``--export-npz`` file carries its weights across.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ubdvss_tpu_torch.net_config import NetConfig


def load_net_config(checkpoint: str | os.PathLike) -> NetConfig | None:
    """NetConfig from the sidecar next to a weight file or log directory,
    or None if absent.  Same search order as the JAX package:
    ``<stem>.net_config.json`` beside an ``.npz``, then ``net_config.json``
    in its directory and that directory's parent."""
    p = Path(checkpoint)
    candidates = []
    if p.suffix == ".npz":
        candidates.append(p.with_suffix(".net_config.json"))
        bases = [p.parent]
    else:
        bases = [p]
    bases.append(bases[0].parent)  # <logdir>/checkpoints -> <logdir>
    candidates.extend(base / "net_config.json" for base in bases)
    for side in candidates:
        if side.is_file():
            return NetConfig.from_json(side.read_text())
    return None


def load_params_npz(path: str | os.PathLike) -> dict[str, np.ndarray]:
    """The flat ``"/"``-keyed arrays of a weight file, as written by the
    JAX package's ``save_params_npz``."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def params_from_flat(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat JAX parameter arrays -> the port's ``BarcodeFCN`` state_dict.

    Key ``a/b/kernel`` becomes ``a.b.weight`` (``bias`` keeps its name).
    Every kernel in the flax model is HWIO — the stride-2 stem convs
    (3,3,Ci,Co), depthwise (3,3,1,C), pointwise and head (1,1,Ci,Co), dense
    context (3,3,C,C) — and torch wants OIHW, so each is permuted
    (3, 2, 0, 1); a depthwise (3,3,1,C) kernel becomes (C,1,3,3), which is
    exactly torch's ``groups=C`` layout.
    """
    out = {}
    for key, arr in flat.items():
        parts = key.split("/")
        t = torch.from_numpy(np.asarray(arr, np.float32).copy())
        if parts[-1] == "kernel":
            if t.ndim != 4:
                raise ValueError(f"{key}: expected a 4-D HWIO kernel, got {t.shape}")
            t = t.permute(3, 2, 0, 1).contiguous()
            parts[-1] = "weight"
        elif parts[-1] != "bias":
            raise ValueError(f"{key}: unknown parameter kind {parts[-1]!r}")
        out[".".join(parts)] = t
    return out


def qparams_from_numpy(qparams: dict) -> dict:
    """The JAX package's int8 qparams (``ubdvss_tpu/ops/quant.py``'s
    ``quantize_trunk``), as host arrays (e.g. ``jax.tree.map(np.asarray,
    q)``), -> the port's: the same structure (``layers`` [{q, ws, b}],
    ``head``, ``s_in``) as CPU tensors of the same dtypes (HWIO int8
    kernels, f32 vectors)."""
    def tensor(a):
        return torch.from_numpy(np.array(a, copy=True))

    def layer(L):
        return {k: tensor(L[k]) for k in ("q", "ws", "b")}

    return {
        "layers": [layer(L) for L in qparams["layers"]],
        "head": layer(qparams["head"]),
        "s_in": [tensor(s) for s in qparams["s_in"]],
    }


def flat_from_params(params: dict) -> dict[str, np.ndarray]:
    """The port's state_dict -> the JAX package's flat arrays (the inverse
    of ``params_from_flat``): ``a.b.weight`` becomes ``a/b/kernel`` with
    the OIHW kernel permuted to HWIO, ``bias`` keeps its name; f32."""
    out = {}
    for name, t in params.items():
        parts = name.split(".")
        a = t.detach().to("cpu", torch.float32).numpy()
        if parts[-1] == "weight":
            a = a.transpose(2, 3, 1, 0)
            parts[-1] = "kernel"
        elif parts[-1] != "bias":
            raise ValueError(f"{name}: unknown parameter kind {parts[-1]!r}")
        out["/".join(parts)] = np.ascontiguousarray(a)
    return out


def save_params_npz(path: str | os.PathLike, params: dict, cfg: NetConfig | None = None) -> None:
    """Portable flat weight file in the JAX package's layout, which its
    ``load_params_npz`` reads; with ``cfg`` also the
    ``<stem>.net_config.json`` sidecar (see ``load_net_config``)."""
    np.savez(path, **flat_from_params(params))
    if cfg is not None:
        Path(path).with_suffix(".net_config.json").write_text(cfg.to_json())


class CheckpointManager:
    """Save and restore train states in ``directory``.

    ``save(step, state, metrics=)`` writes ``state.state_dict()``; at most
    ``max_to_keep`` checkpoints stay: the latest ones, or with
    ``best_metric`` the best by that key of the metrics they were saved
    with (``best_mode`` "max" or "min"), the save-best-only analog.  The
    directory is created at the first save."""

    def __init__(
        self,
        directory: str | os.PathLike,
        max_to_keep: int = 3,
        best_metric: str | None = None,
        best_mode: str = "max",
    ):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode {best_mode!r}: expected 'max' or 'min'")
        self.directory = Path(directory).resolve()
        self.max_to_keep = max_to_keep
        self.best_metric = best_metric
        self.best_mode = best_mode

    def _path(self, step: int) -> Path:
        return self.directory / f"ckpt_{step}.pt"

    def _steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.stem[5:]) for p in self.directory.glob("ckpt_*.pt") if p.stem[5:].isdigit())

    def _metric(self, step: int) -> float | None:
        side = self._path(step).with_suffix(".json")
        if self.best_metric is None or not side.is_file():
            return None
        return json.loads(side.read_text()).get(self.best_metric)

    def _ranked(self) -> list[int]:
        """Kept steps, best first (latest first without a best metric)."""
        steps = self._steps()[::-1]
        if self.best_metric is None:
            return steps
        sign = -1.0 if self.best_mode == "max" else 1.0
        scored = [s for s in steps if self._metric(s) is not None]
        return sorted(scored, key=lambda s: sign * self._metric(s)) + [s for s in steps if s not in scored]

    def save(self, step: int, state: Any, metrics: dict | None = None) -> None:
        self.directory.mkdir(parents=True, exist_ok=True)
        path = self._path(step)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        if metrics is not None:
            path.with_suffix(".json").write_text(json.dumps({k: float(v) for k, v in metrics.items()}))
        for old in self._ranked()[self.max_to_keep:]:
            self._path(old).unlink()
            self._path(old).with_suffix(".json").unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def best_step(self) -> int | None:
        """The best-ranked step (the latest without a best metric)."""
        ranked = self._ranked()
        return ranked[0] if ranked else None

    def _load(self, step: int | None, device) -> dict:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(self._path(step), map_location=device, weights_only=True)

    def restore(self, target: Any, step: int | None = None) -> Any:
        """Load a checkpoint (the latest by default) into ``target``, a
        train state, in place; returns it."""
        target.load_state_dict(self._load(step, target.device))
        return target

    def restore_params(self, step: int | None = None) -> dict[str, torch.Tensor]:
        """A checkpoint's parameters alone, as CPU tensors."""
        return self._load(step, "cpu")["params"]

    def close(self) -> None:
        """Nothing stays open between calls; kept for the JAX interface."""


def load_logdir_params(logdir: str | os.PathLike) -> dict[str, torch.Tensor]:
    """The parameters of the latest checkpoint of a training log directory
    (``<logdir>/checkpoints``, as the port's Trainer writes it).  A
    directory of the JAX package's orbax checkpoints raises, naming the
    JAX trainer's ``--export-npz``."""
    ck = Path(logdir) / "checkpoints"
    mgr = CheckpointManager(ck)
    if mgr.latest_step() is None:
        if ck.is_dir() and any(p.is_dir() and p.name.isdigit() for p in ck.iterdir()):
            raise ValueError(
                f"{ck} holds the JAX package's orbax checkpoints, which the port does not "
                "read: export the weights with the JAX trainer's --export-npz and pass the .npz"
            )
        raise FileNotFoundError(f"no training checkpoint in {ck}")
    return mgr.restore_params()

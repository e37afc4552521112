"""Weight files: the flat ``.npz`` format and its ``.net_config.json`` sidecar.

The JAX package writes weights with ``save_params_npz``
(``ubdvss_tpu/utils/checkpoint.py``): one array per parameter, keyed by the
flax parameter path joined with ``"/"`` (``context_3/depthwise/kernel``),
kernels in HWIO layout.  ``params_from_flat`` carries those arrays into the
port's ``state_dict`` (OIHW kernels), so both packages serve the same
assets; ``qparams_from_numpy`` carries the JAX package's int8 qparams.
"""

from __future__ import annotations

import os
from pathlib import Path

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

"""Build and load the port's CUDA kernels (``ubdvss_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Libraries go to ``build/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source and the flags,
so an edited source is rebuilt at its next use.

The flags leave out ``--use_fast_math`` on purpose: the rectangle fit and
the softmax-side math must stay IEEE (exact division and square root).

Every C entry point takes device pointers, ``int`` sizes and the CUDA
stream, launches on that stream and returns ``cudaGetLastError()``;
``launch`` calls it with the tensors' device current and raises when that
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA kernels are built only on a machine with the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current source."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start_build(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish_build(name: str, job) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build(names) -> None:
    """Compile the named sources, all ``nvcc`` processes started together."""
    jobs = [(n, _start_build(n)) for n in names]
    errors = []
    for name, job in jobs:
        if job is None:
            continue
        try:
            _finish_build(name, job)
        except RuntimeError as e:  # finish every job before raising
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, functions: dict[str, list]) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with ``argtypes``
    set for each entry in ``functions`` (all return ``int``, a CUDA error
    code; ``error_string`` from ``common.cuh`` names it)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in functions.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_input(t, name: str, dtype, ndim: int, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and rank
    (and on ``device`` when given) — what every kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def launch(lib: ctypes.CDLL, fn: str, device, *args) -> None:
    """Call the C entry point ``fn`` with ``device`` current and its current
    stream appended as the last argument; raise on a CUDA error."""
    import torch

    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, fn)

"""ubdvss_tpu_torch — the PyTorch + CUDA port of ubdvss_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays as the reference the port
is tested against.  The port imports torch and numpy, never jax or
ubdvss_tpu.  Each Pallas kernel on the ported path has a hand-written CUDA
kernel under ``csrc/`` (built at first use by ``ops/cuda/_build.py``) and a
plain PyTorch version beside it, which CPU tensors take.
"""

from ubdvss_tpu_torch.inference import (
    BarcodeDetector,
    Detection,
    detect_preprocessed_batch,
    detect_program,
    detect_program_batch,
    detect_program_int8,
)
from ubdvss_tpu_torch.models.model import BarcodeFCN, get_model, init_params, param_count
from ubdvss_tpu_torch.net_config import CLASS_GROUPS, DEFAULT_CLASS_NAMES, NetConfig
from ubdvss_tpu_torch.streaming import StreamingDetector
from ubdvss_tpu_torch.utils.checkpoint import (
    load_net_config,
    load_params_npz,
    params_from_flat,
    qparams_from_numpy,
)

__all__ = [
    "BarcodeDetector",
    "BarcodeFCN",
    "CLASS_GROUPS",
    "DEFAULT_CLASS_NAMES",
    "Detection",
    "NetConfig",
    "StreamingDetector",
    "detect_preprocessed_batch",
    "detect_program",
    "detect_program_batch",
    "detect_program_int8",
    "get_model",
    "init_params",
    "load_net_config",
    "load_params_npz",
    "param_count",
    "params_from_flat",
    "qparams_from_numpy",
]

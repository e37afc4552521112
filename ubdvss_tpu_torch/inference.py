"""End-to-end inference API: image(s) -> detected barcode rectangles.

Counterpart of ``ubdvss_tpu/inference.py`` on its fused serving route
(``detect_program_batch`` with ``fused=True``): grayscale -> (resize +
normalize, or the raw no-resize fold into the stem) -> FCN trunk -> fused
postprocessing.  Entry points run on the card unless the caller asks for
the CPU (``device="cpu"``, where every kernel takes its plain version).

Routes of the JAX package this slice does not port raise
``NotImplementedError`` naming their ROADMAP.md item: bf16, int8
``qparams``, ``mesh``, ``n_strips`` / two-stage large-scan tiling,
heatmaps larger than 128x128 and the XLA (``fused=False``) route.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ubdvss_tpu_torch.models.model import exact_f32, get_model
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.cuda.context_kernel import fused_model_apply
from ubdvss_tpu_torch.ops.postproc import postprocess_batch_fused
from ubdvss_tpu_torch.ops.preproc import normalize, resize_bilinear, to_grayscale_batch


@dataclasses.dataclass
class Detection:
    """One detected barcode (host-side view of the device outputs)."""

    box: np.ndarray  # (4, 2) corners, input-image coords
    class_id: int
    class_name: str
    score: float
    area: int
    center: np.ndarray
    size: np.ndarray
    angle_deg: float


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device`` says
    otherwise.  Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless device='cpu' is given"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_route(cfg: NetConfig, out_hw, fused, n_strips, qparams, mesh) -> None:
    if fused is False:
        raise NotImplementedError(
            "fused=False (the XLA postprocessing route) is not ported: ROADMAP.md §1 item 4"
        )
    if qparams is not None:
        raise NotImplementedError("int8 qparams serving: ROADMAP.md §1 item 8")
    if mesh is not None:
        raise NotImplementedError("mesh data-parallel serving: ROADMAP.md §1 item 11")
    if n_strips is not None and n_strips > 1:
        raise NotImplementedError("n_strips strip tiling: ROADMAP.md §1 item 7")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"dtype={cfg.dtype!r}: ROADMAP.md §1 item 7 (bf16 route)")
    if out_hw[0] % cfg.scale or out_hw[1] % cfg.scale:
        raise ValueError(f"out_hw {out_hw} not aligned to scale={cfg.scale}")
    hf, wf = out_hw[0] // cfg.scale, out_hw[1] // cfg.scale
    if hf * wf > 128 * 128:
        raise NotImplementedError(
            f"{hf}x{wf} heatmaps are the large-scan regime (two-stage / "
            "s2d / dense context routes): ROADMAP.md §1 item 7"
        )


def detect_program_batch(
    params: dict,
    imgs,
    cfg: NetConfig,
    out_hw: tuple[int, int],
    channel_order: str = "rgb",
    fused: bool | None = None,
    n_strips: int | None = None,
    qparams=None,
    detections_only: bool = False,
    mesh=None,
    device=None,
):
    """Batched pipeline: (B, H, W[, C]) images -> batched detection tensors.

    ``params`` is the port's state_dict (``utils.checkpoint.params_from_flat``);
    ``imgs`` a numpy array or tensor, uint8 or float in [0, 255].  Returns
    ``(res, logits)``: the ``postprocess_batch_fused`` dict and the
    (B, H/4, W/4, C) f32 logits, or ``(res, None)`` with
    ``detections_only=True``.  Runs on ``device`` (default the card).
    """
    _check_route(cfg, tuple(out_hw), fused, n_strips, qparams, mesh)
    dev = resolve_device(device)
    x = torch.as_tensor(imgs).to(dev)
    params = {k: v.to(dev) for k, v in params.items()}
    with torch.inference_mode(), exact_f32():
        x = to_grayscale_batch(x, channel_order)
        # no-resize inputs skip the full-res normalize: x/127.5 - 1 is
        # folded into the stem's first conv (border-exact)
        raw = tuple(x.shape[1:]) == tuple(out_hw)
        if not raw:
            x = normalize(resize_bilinear(x, tuple(out_hw)))
        if cfg.separable_context:
            logits = fused_model_apply(params, x[..., None], cfg, raw_gray=raw)
        else:
            if raw:
                x = normalize(x)
            model = get_model(cfg).to(dev)
            model.load_state_dict(params)
            logits = model(x[..., None])
        res = postprocess_batch_fused(logits, cfg)
    if detections_only:
        return res, None
    return res, logits


class BarcodeDetector:
    """User-facing detector mirroring the JAX package's entry point.

    >>> det = BarcodeDetector(cfg, params)          # on the card
    >>> detections = det.detect(image)              # numpy HxW[x3]
    """

    def __init__(
        self, cfg: NetConfig, params: dict, channel_order: str = "rgb",
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.channel_order = channel_order

    def detect(self, image: np.ndarray) -> list[Detection]:
        h, w = image.shape[:2]
        out_hw = self.cfg.grid_size(h, w)
        res, _ = detect_program_batch(
            self.params, np.asarray(image)[None], self.cfg, out_hw,
            self.channel_order, detections_only=True, device=self.device,
        )
        res = {k: v[0].cpu().numpy() for k, v in res.items()}
        # grid -> original resolution rescale (exact when no resize happened)
        rescale = np.array([w / out_hw[1], h / out_hw[0]], np.float32)
        out = []
        for i in np.flatnonzero(res["valid"]):
            cid = int(res["classes"][i])
            out.append(
                Detection(
                    box=res["boxes"][i] * rescale,
                    class_id=cid,
                    class_name=(
                        self.cfg.class_names[cid] if self.cfg.classification else ""
                    ),
                    score=float(res["scores"][i]),
                    area=int(res["areas"][i]),
                    center=res["center"][i] * rescale,
                    size=res["size"][i] * rescale,
                    angle_deg=float(res["angle_deg"][i]),
                )
            )
        return out

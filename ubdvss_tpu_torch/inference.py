"""End-to-end inference API: image(s) -> detected barcode rectangles.

Counterpart of ``ubdvss_tpu/inference.py``:

  * ``detect_program`` — one image: preprocess -> FCN trunk -> the XLA
    route's ``postprocess`` (exact rects, K3x).  ``BarcodeDetector.detect``
    and ``.heatmap`` go through it, as in the JAX package.
  * ``detect_program_batch`` — a batch: grayscale -> (resize + normalize,
    or the raw no-resize fold into the stem) -> FCN trunk (whole, over
    ``n_strips`` row strips, or the large-scan route below) -> the fused
    postprocessing (``fused=True``) or the XLA route's
    ``postprocess_batch`` (``fused=False``).  As in the JAX package,
    ``fused=None`` resolves by the device: fused on the card, as JAX is
    fused on its TPU, the XLA route on the CPU.
  * ``detect_preprocessed_batch`` — the same over already-normalized
    (B, H, W, 1) images.

As in the JAX package, heatmaps larger than ``_fused_heatmap_limit`` a
side take the XLA route (``fused=False``).

The large-scan route, the JAX package's gate (``_auto_two_stage``): on
the fused route of a separable config, with ``n_strips=None``, a scan of
1024 px or more a side with a feature area of 256² or more runs the
packed trunk (``ops/strips.packed_fused_trunk_tiled``, image-level tiles
on axes of 4096 px and more) where ``packed_trunk_selected`` holds, else
the two-stage tiled trunk (``ops/strips.two_stage_tiled_trunk``), and
hands its phase-major logits to ``postprocess_batch_fused(packed_phases=
(2, 2))``; the logits returned are unpacked (``_d2s``) f32.  On the card
the packed trunk is the direct one with the layout made where the logits
are written (K4's or ``qconv_head``'s packed store; in bf16 one ``_s2d``
copy) and read in place by K2 or K12c.  ``n_strips=1`` forces the
whole-image trunk.  The trunk, by ``NetConfig.dtype``:

  * float32: a separable config runs the context kernel's (K4) route at
    every size, on every route; a dense config runs ``BarcodeFCN``;
  * bfloat16 (the JAX package's throughput mode): the fused route of a
    separable config runs ``fused_model_apply`` — the bf16 stem and the
    dense-equivalent context convs — and hands its bf16 logits to the
    fused postprocessing, whose kernels read bf16 (K1, K2, K12c); the raw
    no-resize batch is fed to it as bf16.  ``detect_program``,
    ``fused=False`` and dense configs run ``BarcodeFCN`` in bf16, whose
    logits are f32, as the JAX package's ``get_model(cfg).apply``.  The
    logits an entry point returns are f32, exact converts of the trunk's.

The int8 route (``qparams`` from ``ops/quant.quantize_trunk``, the JAX
package's production serving mode; ``NetConfig.dtype`` is not read on it,
as in JAX) runs ``int8_trunk_apply`` — eight launches of the int8 conv
kernels: ``qstem``, ``qconv`` for six context layers and ``qconv_head`` —
and the same postprocessing: ``detect_program_int8`` for one
image, ``detect_program_batch(qparams=)`` (raw grayscale when no resize is
needed, else the resized image normalized with one rounding; no heatmap
limit, as the JAX int8 branch comes before it; on the fused route the
packed int8 trunk ``int8_packed_trunk_tiled`` where ``_int8_packed`` holds,
feature areas of 256² and more, as in JAX) and
``detect_preprocessed_batch(qparams=)`` (the direct trunk; its fused
postprocessing serves dense configs too, as in JAX).  ``n_strips`` is not
read on it, as in JAX.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, where every kernel takes its plain version).

``mesh`` (``parallel/mesh.py``) serves ``detect_program_batch`` and
``detect_preprocessed_batch`` data-parallel, as the JAX package's
``shard_map`` does: the batch shards over the mesh's first axis (its size
must divide the batch), each shard runs the single-device pipeline on its
entry's device — the same route, the same kernels, the same launch
counters — with the weights placed once a distinct device, and the
results are concatenated on the first entry in shard order.  As in JAX,
past ``_fused_heatmap_limit`` the int8 route takes the XLA postprocessing
there too.  Each shard takes the large-scan route by its own shape.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ubdvss_tpu_torch.models.model import exact_f32, get_model
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.cuda.context_kernel import _d2s, fused_model_apply, packed_trunk_selected
from ubdvss_tpu_torch.ops.postproc import postprocess, postprocess_batch, postprocess_batch_fused
from ubdvss_tpu_torch.ops.preproc import (
    normalize,
    preprocess,
    resize_bilinear,
    to_grayscale_batch,
)
from ubdvss_tpu_torch.ops.quant import (
    int8_packed_trunk_tiled,
    int8_trunk_apply,
    normalize_fma,
    qparams_to,
)
from ubdvss_tpu_torch.ops.strips import (
    auto_two_stage_grids,
    packed_fused_trunk_tiled,
    receptive_field_halo,
    strip_tiled_logits,
    two_stage_tiled_trunk,
)
from ubdvss_tpu_torch.parallel.mesh import Mesh, replicate_to_mesh, shard_batch_to_mesh


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


def _check_route(cfg: NetConfig, hw, qparams=None) -> None:
    if qparams is None:
        cfg.compute_dtype  # float32 or bfloat16, else ValueError
    if hw[0] % cfg.scale or hw[1] % cfg.scale:
        raise ValueError(f"out_hw {hw} not aligned to scale={cfg.scale}")


def _fused_heatmap_limit(cfg: NetConfig) -> int:
    """Largest heatmap side the fused postprocessing serves, as in the JAX
    package (``ubdvss_tpu/inference.py:88-95``): 1024 for separable-context
    configs, 512 for dense ones.  Beyond it the XLA route serves."""
    return 1024 if cfg.separable_context else 512


def _resolve_fused(fused: bool | None, dev: torch.device) -> bool:
    """``fused=None`` resolved by the device, as the JAX package resolves it
    by the backend (``ubdvss_tpu/inference.py:159-160``, :478-479): the
    fused route on the card, the XLA route on the CPU."""
    return dev.type == "cuda" if fused is None else bool(fused)


def _fused_route(cfg: NetConfig, hw, fused: bool) -> bool:
    """The JAX package's route choice: the resolved ``fused`` unless the
    heatmap exceeds ``_fused_heatmap_limit``."""
    return fused and max(hw) // cfg.scale <= _fused_heatmap_limit(cfg)


def _tiled_trunk(trunk, x: torch.Tensor, cfg: NetConfig, n_strips: int | None) -> torch.Tensor:
    """``trunk(x)``, or its row-strip tiling for ``n_strips > 1``."""
    if n_strips is not None and n_strips > 1:
        return strip_tiled_logits(trunk, x, cfg.scale, receptive_field_halo(cfg), n_strips)
    return trunk(x)


def _auto_strips(cfg: NetConfig, out_hw, n_strips: int | None) -> int:
    """The row-strip count of the whole-image trunk (``ops/strips.py``):
    ``n_strips``, else 1 (large scans take ``_auto_two_stage``'s route
    instead), as the JAX package's ``_auto_strips``."""
    return 1 if n_strips is None else n_strips


def _auto_two_stage(cfg: NetConfig, out_hw, n_strips: int | None, fused: bool) -> bool:
    """The JAX package's large-scan gate (``ubdvss_tpu/inference.py:98-117``):
    the packed or two-stage trunk for the fused route of a separable config
    when ``n_strips`` is None, a side reaches 1024 px and the feature area
    256²; an explicit ``n_strips`` forces the whole-image trunk."""
    return (
        n_strips is None
        and fused
        and cfg.separable_context
        and max(out_hw) >= 1024
        and (out_hw[0] // cfg.scale) * (out_hw[1] // cfg.scale) >= 256 * 256
    )


def _int8_packed(cfg: NetConfig, out_hw, fused: bool) -> bool:
    """The JAX package's packed int8 gate (``ubdvss_tpu/inference.py:304-310``):
    the fused route, scale 4, sizes divisible by 8, dilations even or 1, a
    feature area of 256² or more; any architecture."""
    return fused and (
        cfg.scale == 4
        and out_hw[0] % 8 == 0
        and out_hw[1] % 8 == 0
        and all(d == 1 or d % 2 == 0 for d in cfg.dilations)
        and (out_hw[0] // 4) * (out_hw[1] // 4) >= 256 * 256
    )


def _large_scan_trunk(params: dict, x: torch.Tensor, cfg: NetConfig, raw: bool):
    """The large-scan trunk of (B, H, W) images: ``(logits, packed_phases)``
    from ``packed_fused_trunk_tiled`` (phase-major, (2, 2)) where
    ``packed_trunk_selected`` holds, else from ``two_stage_tiled_trunk``
    (row strips of the stem; packed where the s2d gate fires)."""
    x4 = x[..., None]
    if packed_trunk_selected(cfg, tuple(x.shape[1:3])):
        return packed_fused_trunk_tiled(params, x4, cfg, raw_gray=raw), (2, 2)
    sg, cg = auto_two_stage_grids(x.shape[1], x.shape[2], cfg.scale, cfg.dilations)
    return two_stage_tiled_trunk(params, x4, cfg, sg, cg, raw_gray=raw, return_packed=True)


def _unpack(logits: torch.Tensor, packed_phases) -> torch.Tensor:
    """The API's (B, H/4, W/4, O) f32 logits of a trunk's output."""
    if packed_phases is not None:
        logits = _d2s(logits, logits.shape[-1] // 4)
    return logits.to(torch.float32)


def _check_mesh(mesh, device, batch: int) -> None:
    """The data-parallel checks: a ``parallel.mesh.Mesh``, a ``device`` that
    agrees with its entries, every entry's device present, and a batch its
    size divides."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh: expected a ubdvss_tpu_torch.parallel.mesh.Mesh, got {type(mesh).__name__}")
    if device is not None:
        want = resolve_device(device)
        if any(d.type != want.type or (want.index is not None and d != want) for d in mesh.devices.flat):
            raise ValueError(f"device={device} contradicts the mesh {mesh}")
    for d in mesh.devices.flat:
        resolve_device(d)
    if batch % mesh.size:
        raise ValueError(f"batch {batch} not divisible by the {mesh.size}-device data mesh")


def _data_parallel(entry, mesh, placed: list, shards: list, fused, hw, cfg: NetConfig, **kw):
    """Data-parallel serving core: ``entry`` (the single-device function)
    on each shard (``parallel.mesh.shard_batch_to_mesh``) on its entry's
    device, with that device's copy of the weights (``placed``, from
    ``replicate_to_mesh`` of ``{"params", "qparams"}``); the results
    concatenated on the first entry in shard order."""
    devs = mesh.axis_devices(mesh.axis_names[0])
    fused = _resolve_fused(fused, devs[0])
    if max(hw) // cfg.scale > _fused_heatmap_limit(cfg):
        fused = False  # the unsharded entry's route choice, on the int8 route too (as JAX)
    flat = list(mesh.devices.flat)
    outs = []
    for shard, d in zip(shards, devs):
        w = placed[flat.index(d)]
        outs.append(entry(w["params"], shard, cfg=cfg, fused=fused, qparams=w["qparams"], device=d, **kw))
    res = {k: torch.cat([o[0][k].to(devs[0]) for o in outs]) for k in outs[0][0]}
    if outs[0][1] is None:
        return res, None
    return res, torch.cat([o[1].to(devs[0]) for o in outs])


def _serve_on_mesh(entry, mesh, device, params, qparams, x, fused, hw, cfg, **kw):
    """Shard ``x``, place the weights once a distinct device, serve."""
    x = torch.as_tensor(x)
    _check_mesh(mesh, device, x.shape[0])
    placed = replicate_to_mesh({"params": params, "qparams": qparams}, mesh)
    shards = shard_batch_to_mesh(x, mesh, mesh.axis_names[0])
    return _data_parallel(entry, mesh, placed, shards, fused, hw, cfg, **kw)


def _trunk(
    params: dict, x: torch.Tensor, cfg: NetConfig, raw: bool, fused: bool = True
) -> torch.Tensor:
    """(B, H, W) grayscale -> (B, H/4, W/4, C) logits.  ``raw``: x is
    unnormalized [0, 255], else already normalized.  A separable config
    runs ``fused_model_apply`` (bf16 logits in the bf16 mode) in f32 and
    on the fused route; else ``BarcodeFCN`` (f32 logits), as the JAX
    package's ``get_model(cfg).apply``."""
    if cfg.separable_context and (fused or cfg.compute_dtype == torch.float32):
        return fused_model_apply(params, x[..., None], cfg, raw_gray=raw, act_out=True)
    model = get_model(cfg).to(x.device)
    model.load_state_dict(params)
    return model((normalize(x) if raw else x)[..., None])


def detect_program(
    params: dict,
    img,
    cfg: NetConfig,
    out_hw: tuple[int, int],
    channel_order: str = "rgb",
    device=None,
):
    """One (H, W[, C]) image -> ``(res, logits)``: the XLA route's
    ``postprocess`` dict (every rect exact) and the (H'/4, W'/4, C) f32
    logits.  Runs on ``device`` (default the card)."""
    _check_route(cfg, tuple(out_hw))
    dev = resolve_device(device)
    x = torch.as_tensor(img).to(dev)
    params = {k: v.to(dev) for k, v in params.items()}
    with torch.inference_mode(), exact_f32():
        x = preprocess(x, tuple(out_hw), channel_order)
        logits = _trunk(params, x[None, ..., 0], cfg, raw=False, fused=False)[0]
        return postprocess(logits, cfg), logits


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
    ``(res, logits)``: the ``postprocess_batch_fused`` dict (or, with
    ``fused=False``, the XLA route's ``postprocess_batch`` dict) and the
    (B, H/4, W/4, C) f32 logits, or ``(res, None)`` with
    ``detections_only=True``.  Runs on ``device`` (default the card).

    Heatmaps larger than ``_fused_heatmap_limit`` a side take the XLA
    route, as in the JAX package; ``n_strips > 1`` runs the fused route's
    trunk over that many row strips (``ops/strips.py``), which gives the
    same logits, and ``n_strips=None`` takes the large-scan route (the
    module docstring) where the JAX package does.  ``qparams`` takes the
    int8 route (``ops/quant.py``) at any heatmap size.  ``fused=None`` is the fused route on the card and
    the XLA route on the CPU, on every branch, as the JAX package resolves
    it by its backend before the int8 branch.  ``mesh`` serves the batch
    data-parallel (the module docstring); ``device`` must then agree with
    the mesh's entries.
    """
    _check_route(cfg, tuple(out_hw), qparams)
    if mesh is not None:
        return _serve_on_mesh(
            detect_program_batch, mesh, device, params, qparams, imgs,
            fused, tuple(out_hw), cfg, out_hw=out_hw, channel_order=channel_order,
            n_strips=n_strips, detections_only=detections_only,
        )
    dev = resolve_device(device)
    fused = _resolve_fused(fused, dev)
    x = torch.as_tensor(imgs).to(dev)
    if qparams is not None:
        return _detect_program_batch_int8(
            qparams_to(qparams, dev), x, cfg, tuple(out_hw), channel_order,
            fused, detections_only,
        )
    params = {k: v.to(dev) for k, v in params.items()}
    fused = _fused_route(cfg, out_hw, fused)
    with torch.inference_mode(), exact_f32():
        # no-resize inputs skip the full-res normalize: x/127.5 - 1 is
        # folded into the stem's first conv (border-exact)
        raw = tuple(x.shape[1:3]) == tuple(out_hw)
        # the fused separable trunk casts its input to the compute dtype
        # first, so it is fed at that dtype (exact for uint8 0..255)
        feed = cfg.compute_dtype if raw and fused and cfg.separable_context else torch.float32
        x = to_grayscale_batch(x, channel_order, feed)
        if not raw:
            x = normalize(resize_bilinear(x, tuple(out_hw)))
        if _auto_two_stage(cfg, tuple(out_hw), n_strips, fused):
            logits, pp = _large_scan_trunk(params, x, cfg, raw)
            res = postprocess_batch_fused(logits, cfg, packed_phases=pp)
            return (res, None) if detections_only else (res, _unpack(logits, pp))
        trunk = functools.partial(_trunk, params, cfg=cfg, raw=raw, fused=fused)
        logits = _tiled_trunk(trunk, x, cfg, _auto_strips(cfg, out_hw, n_strips)) if fused else trunk(x)
        res = (postprocess_batch_fused if fused else postprocess_batch)(logits, cfg)
    if detections_only:
        return res, None
    return res, logits.to(torch.float32)


def _detect_program_batch_int8(
    qparams: dict, x: torch.Tensor, cfg: NetConfig, out_hw, channel_order: str,
    fused: bool, detections_only: bool,
):
    """The int8 route of ``detect_program_batch``, after the JAX package's
    ``_detect_program_batch_int8``: the raw grayscale batch when no resize
    is needed (a one-channel uint8 batch goes to the kernel as it is), else
    the resized image normalized; ``int8_trunk_apply``, or
    ``int8_packed_trunk_tiled`` where ``_int8_packed`` holds; the fused
    (reading packed logits in place) or the XLA route's postprocessing."""
    with torch.inference_mode(), exact_f32():
        raw = tuple(x.shape[1:3]) == out_hw
        if raw and x.dtype == torch.uint8 and (x.ndim == 3 or x.shape[-1] == 1):
            x = x.reshape(x.shape[:3]).contiguous()
        else:
            x = to_grayscale_batch(x, channel_order)
            if not raw:
                x = normalize_fma(resize_bilinear(x, out_hw))[..., None]
        if _int8_packed(cfg, out_hw, fused):
            logits = int8_packed_trunk_tiled(qparams, x, cfg, raw_gray=raw)
            res = postprocess_batch_fused(logits, cfg, packed_phases=(2, 2))
            return (res, None) if detections_only else (res, _unpack(logits, (2, 2)))
        logits = int8_trunk_apply(qparams, x, cfg, raw_gray=raw)
        res = (postprocess_batch_fused if fused else postprocess_batch)(logits, cfg)
    return (res, None) if detections_only else (res, logits)


def detect_program_int8(
    qparams: dict,
    img,
    cfg: NetConfig,
    out_hw: tuple[int, int],
    channel_order: str = "rgb",
    device=None,
):
    """``detect_program`` with the int8 trunk: one (H, W[, C]) image ->
    ``(res, logits)`` through ``preprocess`` (its normalize rounded once, as
    under ``jit``), ``int8_trunk_apply`` and the XLA route's
    ``postprocess``.  Runs on ``device`` (default the card)."""
    _check_route(cfg, tuple(out_hw), qparams)
    dev = resolve_device(device)
    x = torch.as_tensor(img).to(dev)
    qparams = qparams_to(qparams, dev)
    with torch.inference_mode(), exact_f32():
        x = to_grayscale_batch(x[None], channel_order)
        x = normalize_fma(resize_bilinear(x, tuple(out_hw)))[..., None]
        logits = int8_trunk_apply(qparams, x, cfg)[0]
        return postprocess(logits, cfg), logits


def detect_preprocessed_batch(
    params: dict,
    x,
    cfg: NetConfig,
    fused: bool | None = None,
    n_strips: int | None = None,
    qparams=None,
    mesh=None,
    device=None,
):
    """Detection over already-preprocessed images: (B, H, W, 1) f32
    normalized to [-1, 1] (the data pipeline's ``images``).  Returns
    ``(res, logits)`` as ``detect_program_batch``.

    The same route selection as ``detect_program_batch``; as in the JAX
    package, the fused postprocessing serves separable configs only, and
    a dense config takes the XLA route's — except on the int8 route
    (``qparams``), where it serves dense configs too.  Runs on ``device``
    (default the card), or data-parallel over ``mesh``.
    """
    x = torch.as_tensor(x)
    hw = tuple(x.shape[1:3])
    _check_route(cfg, hw, qparams)
    if mesh is not None:
        return _serve_on_mesh(
            detect_preprocessed_batch, mesh, device, params, qparams, x,
            fused, hw, cfg, n_strips=n_strips,
        )
    dev = resolve_device(device)
    fused = _resolve_fused(fused, dev)
    x = x.to(dev)
    if qparams is not None:
        with torch.inference_mode():
            x = x.to(torch.float32).contiguous()
            logits = int8_trunk_apply(qparams_to(qparams, dev), x, cfg)
            post = postprocess_batch_fused if fused else postprocess_batch
            return post(logits, cfg), logits
    params = {k: v.to(dev) for k, v in params.items()}
    fused = _fused_route(cfg, hw, fused)
    with torch.inference_mode(), exact_f32():
        x = x.to(torch.float32)[..., 0]
        if _auto_two_stage(cfg, hw, n_strips, fused):
            logits, pp = _large_scan_trunk(params, x, cfg, raw=False)
            return postprocess_batch_fused(logits, cfg, packed_phases=pp), _unpack(logits, pp)
        trunk = functools.partial(_trunk, params, cfg=cfg, raw=False, fused=fused)
        logits = _tiled_trunk(trunk, x, cfg, _auto_strips(cfg, hw, n_strips)) if fused else trunk(x)
        post = postprocess_batch_fused if fused and cfg.separable_context else postprocess_batch
        return post(logits, cfg), logits.to(torch.float32)


class BarcodeDetector:
    """User-facing detector mirroring the JAX package's entry point.

    >>> det = BarcodeDetector(cfg, params)          # on the card
    >>> detections = det.detect(image)              # numpy HxW[x3]

    ``qparams`` (``ops/quant.quantize_trunk``) switches ``detect`` to the
    int8 trunk (``detect_program_int8``); ``heatmap`` stays on ``params``,
    as in the JAX package.  Weights and qparams go to the device once, here.
    """

    def __init__(
        self, cfg: NetConfig, params: dict, channel_order: str = "rgb",
        qparams: dict | None = None, device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.channel_order = channel_order
        self.qparams = None if qparams is None else qparams_to(qparams, self.device)

    def detect(self, image: np.ndarray) -> list[Detection]:
        """The image's detections through ``detect_program`` (exact rects),
        or ``detect_program_int8`` with qparams, in input-image coordinates."""
        h, w = image.shape[:2]
        out_hw = self.cfg.grid_size(h, w)
        if self.qparams is not None:
            res, _ = detect_program_int8(
                self.qparams, image, self.cfg, out_hw, self.channel_order, device=self.device
            )
        else:
            res, _ = detect_program(
                self.params, image, self.cfg, out_hw, self.channel_order, device=self.device
            )
        res = {k: v.cpu().numpy() for k, v in res.items()}
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

    def heatmap(self, image: np.ndarray) -> np.ndarray:
        """Detection-probability heatmap at 1/scale resolution (debug/eval)."""
        h, w = image.shape[:2]
        out_hw = self.cfg.grid_size(h, w)
        _, logits = detect_program(
            self.params, image, self.cfg, out_hw, self.channel_order, device=self.device
        )
        return torch.sigmoid(logits[..., 0]).cpu().numpy()

"""Heatmap -> rectangles postprocessing: the fused route and the XLA route's
entry points.

Counterpart of ``ubdvss_tpu/ops/postproc.py``: sigmoid threshold ->
connected components -> the K smallest components (raster order) -> areas,
mean detection probability, mean class probabilities -> minimum-area
rectangle per component -> rects scaled by ``cfg.scale`` back to
input-image coordinates.  Outputs are fixed-size K-slot tensors plus a
``valid`` mask, exactly as the JAX package returns.

  * ``postprocess_batch_fused`` — the fused route: K1 -> K2 -> the rect
    kernel the JAX package picks by ``max_hull_points`` (K3 when M < H, the
    uncompacted K3x otherwise).
  * ``postprocess`` / ``postprocess_batch`` — the XLA route's entry points,
    one image or a batch.  The JAX package fits each rect exactly from
    every row's extremes (``min_area_rect_from_mask_stack``); that is what
    K3x computes, so here they run K1 -> K2 -> K3x with no hull cap.
  * ``roots_from_raw_labels`` -> ``eq_from_raw_labels`` -> ``finish_from_eq``,
    and ``finish_postprocess`` on compact labels — the XLA formulation's
    tail in plain torch (one-hot masks, einsum stats, ``ops/rect.py``), as
    the row-tiled scan (``parallel/tiling.py``) runs it after its
    distributed CCL.

On the CPU every kernel takes its plain version.  The logits are f32, or
bf16 from the bf16 route's trunk (the kernels read them at that dtype);
scores and class probabilities are f32 either way.
"""

from __future__ import annotations

import torch

from ubdvss_tpu_torch.models.model import exact_f32
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_stats_from_logits, unpacked_shape
from ubdvss_tpu_torch.ops.cuda.rect_kernel import (
    min_area_rect_select,
    rects_from_selection,
)
from ubdvss_tpu_torch.ops.rect import min_area_rect_from_mask_stack


def roots_from_raw_labels(raw_lab: torch.Tensor, max_components: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw min-index labels (..., H, W) -> the K smallest root values (the
    components in raster order, the sentinel H*W past the last) and their
    validity, each (..., K)."""
    H, W = raw_lab.shape[-2], raw_lab.shape[-1]
    sentinel = H * W
    lin = torch.arange(H * W, dtype=raw_lab.dtype, device=raw_lab.device).reshape(H, W)
    cand = torch.where((raw_lab == lin) & (raw_lab < sentinel), raw_lab, sentinel)
    rootvals = -torch.topk(-cand.reshape(*raw_lab.shape[:-2], H * W), max_components, dim=-1).values
    return rootvals, rootvals < sentinel


def eq_from_raw_labels(
    raw_lab: torch.Tensor, rootvals: torch.Tensor, root_valid: torch.Tensor
) -> torch.Tensor:
    """One mask a component, (..., H, W, K) bool, from raw labels."""
    eq = raw_lab[..., None] == rootvals[..., None, None, :]
    return eq & root_valid[..., None, None, :]


def finish_from_eq(
    logits: torch.Tensor, eq: torch.Tensor, cfg: NetConfig, num_components_total=None
) -> dict:
    """The tail given one image's (Ho, Wo, C) logits and its per-component
    masks eq (Ho, Wo, K): areas, scores, class probabilities (einsums in
    f32, TF32 off) and the exact rects (``min_area_rect_from_mask_stack``),
    in the ``postprocess`` dict.  ``num_components_total`` is the true
    count before the K cut; None takes the occupied slots."""
    det_prob = torch.sigmoid(logits[..., 0].to(torch.float32))
    K = cfg.max_components
    eqf = eq.to(torch.float32)
    areas = eq.sum((0, 1), dtype=torch.int32)
    valid = (areas > 0) & (areas >= cfg.min_component_area)
    safe_area = torch.clamp(areas, min=1).to(torch.float32)
    with exact_f32():
        scores = torch.einsum("hwk,hw->k", eqf, det_prob) / safe_area
        if cfg.classification and logits.shape[-1] > 1:
            cls_prob = torch.softmax(logits[..., 1:].to(torch.float32), dim=-1)
            class_probs = torch.einsum("hwk,hwc->kc", eqf, cls_prob) / safe_area[:, None]
            classes = torch.argmax(class_probs, dim=-1).to(torch.int32)
        else:
            classes = torch.zeros((K,), dtype=torch.int32, device=logits.device)
            class_probs = torch.ones((K, 1), dtype=torch.float32, device=logits.device)
    rects = min_area_rect_from_mask_stack(eq)
    s = float(cfg.scale)
    if num_components_total is None:
        num_components_total = (areas > 0).sum().to(torch.int32)
    final_valid = valid & rects["valid"]
    return {
        "num_components_total": num_components_total,
        "boxes": rects["points"] * s,
        "center": rects["center"] * s,
        "size": rects["size"] * s,
        "angle_deg": rects["angle_deg"],
        "classes": classes,
        "class_probs": class_probs,
        "scores": scores,
        "areas": areas,
        "valid": final_valid,
        "num_detections": final_valid.sum().to(torch.int32),
    }


def finish_postprocess(logits: torch.Tensor, labels: torch.Tensor, cfg: NetConfig) -> dict:
    """The tail given one image's COMPACT labels (1..n in raster order): the
    first K components' masks, and n = max(labels) as the true count."""
    K = cfg.max_components
    eq = labels[..., None] == torch.arange(1, K + 1, dtype=labels.dtype, device=labels.device)
    return finish_from_eq(logits, eq, cfg, num_components_total=labels.max().to(torch.int32))


def _postprocess(
    logits: torch.Tensor, cfg: NetConfig, connectivity: int, max_points: int | None,
    packed_phases=None,
) -> dict:
    """(B, Ho, Wo, C) NHWC logits (phase-major packed with
    ``packed_phases``) -> dict of (B, K, ...) detection tensors, the rects
    fitted with ``max_points`` hull points a chain (None: all)."""
    B, Ho, Wo, C = unpacked_shape(logits, packed_phases)
    K = cfg.max_components
    stats = component_stats_from_logits(
        logits, max_components=K, threshold=cfg.detection_threshold,
        connectivity=connectivity, packed_phases=packed_phases,
    )
    root_valid = stats["rootvals"] < Ho * Wo  # (B, K)
    # padded root slots matched the background in the slots kernel — zero
    # them here; areas come from an exact one-hot sum (integers < 2^24)
    areas = torch.where(root_valid, torch.round(stats["areas"]).to(torch.int32), 0)
    valid = root_valid & (areas >= cfg.min_component_area)
    safe_area = torch.clamp(areas, min=1).to(torch.float32)
    scores = torch.where(root_valid, stats["det_sums"], 0.0) / safe_area
    if cfg.classification and C > 1:
        class_probs = (
            torch.where(root_valid[..., None], stats["cls_sums"], 0.0)
            / safe_area[..., None]
        )
        classes = torch.argmax(class_probs, dim=-1).to(torch.int32)
    else:
        classes = torch.zeros((B, K), dtype=torch.int32, device=logits.device)
        class_probs = torch.ones((B, K, 1), dtype=torch.float32, device=logits.device)

    sel = min_area_rect_select(stats["minx"], stats["maxx"], max_points)
    rects = rects_from_selection(sel)
    rv = root_valid
    points = torch.where(rv[..., None, None], rects["points"], 0.0)
    center = torch.where(rv[..., None], rects["center"], 0.0)
    size = torch.where(rv[..., None], rects["size"], 0.0)
    angle = torch.where(rv, rects["angle_deg"], 0.0)
    rect_valid = (stats["maxx"] >= 0).any(-1) & root_valid
    s = float(cfg.scale)
    final_valid = valid & rect_valid
    return {
        "boxes": points * s,
        "center": center * s,
        "size": size * s,
        "angle_deg": angle,
        "classes": classes,
        "class_probs": class_probs,
        "scores": scores,
        "areas": areas,
        "valid": final_valid,
        "num_detections": final_valid.sum(-1).to(torch.int32),
        "num_components_total": stats["num_components_total"],
    }


def postprocess_batch_fused(
    logits: torch.Tensor, cfg: NetConfig, connectivity: int = 8,
    packed_phases: tuple[int, int] | None = None,
) -> dict:
    """(B, Ho, Wo, C) NHWC logits -> dict of (B, K, ...) detection tensors.

    Keys: boxes (B, K, 4, 2), center, size, angle_deg, classes, class_probs,
    scores, areas, valid, num_detections (B,), num_components_total (B,).
    The rects take K3 with M = ``cfg.max_hull_points`` < Ho, else K3x.  The
    JAX package serves M >= Ho > 128 by its XLA compact caliper at M = Ho,
    which is exact too, so K3x gives the same rects there.
    ``packed_phases=(2, 2)``: the logits arrive space-to-depth packed,
    (B, Ho/2, Wo/2, 4C) phase-major, from the packed route's trunk
    (``component_stats_from_logits``).
    """
    return _postprocess(logits, cfg, connectivity, cfg.max_hull_points, packed_phases)


def postprocess_batch(logits: torch.Tensor, cfg: NetConfig, connectivity: int = 8) -> dict:
    """The XLA route over a batch: (B, Ho, Wo, C) logits -> the dict of
    ``postprocess_batch_fused``, every rect exact (K3x, no hull cap)."""
    return _postprocess(logits, cfg, connectivity, None)


def postprocess(logits: torch.Tensor, cfg: NetConfig, connectivity: int = 8) -> dict:
    """One image's (Ho, Wo, C) logits -> the XLA route's dict: boxes (K, 4,
    2), center, size, angle_deg, classes, class_probs, scores, areas, valid
    (K, ...), num_detections and num_components_total ()."""
    return {k: v[0] for k, v in postprocess_batch(logits[None], cfg, connectivity).items()}

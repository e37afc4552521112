"""Heatmap -> rectangles postprocessing on the fused kernel route.

Counterpart of ``postprocess_batch_fused`` (``ubdvss_tpu/ops/postproc.py``):
sigmoid threshold -> connected components -> the K smallest components
(raster order) -> areas, mean detection probability, mean class
probabilities -> minimum-area rectangle per component -> rects scaled by
``cfg.scale`` back to input-image coordinates.  Outputs are fixed-size
K-slot tensors plus a ``valid`` mask, exactly as the JAX package returns.

The XLA route (``postprocess`` / ``postprocess_batch`` over ``ops/ccl.py``
and ``ops/rect.py``) is not ported yet (ROADMAP.md §1 item 4).
"""

from __future__ import annotations

import torch

from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.cuda.postproc_kernel import component_stats_from_logits
from ubdvss_tpu_torch.ops.cuda.rect_kernel import (
    min_area_rect_select,
    rects_from_selection,
)


def postprocess_batch_fused(
    logits: torch.Tensor, cfg: NetConfig, connectivity: int = 8
) -> dict:
    """(B, Ho, Wo, C) NHWC logits -> dict of (B, K, ...) detection tensors.

    Keys: boxes (B, K, 4, 2), center, size, angle_deg, classes, class_probs,
    scores, areas, valid, num_detections (B,), num_components_total (B,).
    """
    B, Ho, Wo, C = logits.shape
    K = cfg.max_components
    if cfg.max_hull_points >= Ho:
        raise NotImplementedError(
            f"max_hull_points={cfg.max_hull_points} >= heatmap height {Ho} "
            "takes the uncompacted rect kernel, still to be ported "
            "(ROADMAP.md §2 K3x)"
        )
    stats = component_stats_from_logits(
        logits, max_components=K, threshold=cfg.detection_threshold,
        connectivity=connectivity,
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

    sel = min_area_rect_select(stats["minx"], stats["maxx"], cfg.max_hull_points)
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

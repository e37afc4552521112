"""Pixelwise losses with hard-negative mining (paper §3.3).

Counterpart of ``ubdvss_tpu/losses.py``, with its semantics:

Detection channel: sigmoid binary cross-entropy over all positive (barcode)
pixels plus the k hardest negative pixels per image, k = hard_negative_ratio
× n_positives, capped at the negatives available, normalized by the number
of contributing pixels.  Images with no positives keep k = ratio negatives
so empty pages still push the detector down.

Classification channels: softmax cross-entropy, masked to GT barcode pixels
only (background never contributes), averaged over contributing pixels.

Total = detection_loss_weight * det + classification_loss_weight * cls.

The JAX package maps the single-image functions over the batch
(``jax.vmap``); here the batch is one more leading axis of the same
tensor ops (``_detection_loss_rows``), so the bisection's 31 rounds are 31
count-reductions over the whole batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ubdvss_tpu_torch.net_config import NetConfig

_F32_INF_BITS = 0x7F800000


def sigmoid_bce_from_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable per-element sigmoid cross-entropy."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _top_k_sum_bisect_rows(x: torch.Tensor, valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Row-wise sum of the k largest ``x[valid]`` without a sort.

    x: (R, N) f32 >= 0, valid (R, N) bool, k (R,) int.  With t = the k-th
    largest value, sum(top k) = sum over {x > t} plus the first
    (k - |{x > t}|) elements equal to t by flat index (the stable sort's
    tie order).  t is found by a 31-round bisection on the f32 bit
    pattern, read as int32 (monotone for x >= 0).  The elements equal to t
    are summed as themselves, not as ``(k - n_gt) * t``, so the boundary
    pixel keeps its gradient (t comes off the integer bisection).  A row
    with k = 0 sums to 0.
    """
    xb = torch.where(valid, x.detach().view(torch.int32), -1)
    rows = x.shape[0]
    lo = torch.zeros((rows, 1), dtype=torch.int32, device=x.device)
    hi = torch.full((rows, 1), _F32_INF_BITS, dtype=torch.int32, device=x.device)
    kk = k.view(rows, 1)
    # invariant: count(>= lo) >= k, count(>= hi) < k (hi = the +inf pattern)
    for _ in range(31):
        mid = lo + (hi - lo) // 2  # lo + hi would overflow int32
        ge = (xb >= mid).sum(1, keepdim=True)
        up = ge >= kk
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    t = lo.view(torch.float32)
    gt = valid & (x > t)
    n_gt = gt.sum(1, keepdim=True)
    eq = valid & (x == t)
    sel = eq & (torch.cumsum(eq.to(torch.int32), 1) <= kk - n_gt)
    s = torch.where(gt | sel, x, 0.0).sum(1)
    return torch.where(k > 0, s, 0.0)


def _top_k_sum_bisect(x: torch.Tensor, valid: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Sum of the k largest ``x[valid]`` of one flat (N,) array (see
    ``_top_k_sum_bisect_rows``)."""
    return _top_k_sum_bisect_rows(x[None], valid[None], torch.as_tensor(k).view(1))[0]


def _detection_loss_rows(
    det_logits: torch.Tensor, pos_mask: torch.Tensor, ratio: float, use_sort: bool = False,
) -> torch.Tensor:
    """(B, Ho, Wo) logits + bool positives -> (B,) mined BCE, one an image."""
    B = det_logits.shape[0]
    px = sigmoid_bce_from_logits(det_logits, pos_mask.to(torch.float32))
    flat = px.reshape(B, -1)
    pos = pos_mask.reshape(B, -1)
    n_pos = pos.sum(1, dtype=torch.int32)
    pos_sum = torch.where(pos, flat, 0.0).sum(1)
    ratio = float(np.float32(ratio))  # a Python number: no copy to the card
    k = torch.clamp(n_pos * ratio, min=ratio).to(torch.int32)
    k = torch.minimum(k, flat.shape[1] - n_pos)
    if use_sort:
        # hardest negatives: candidate negative losses sorted descending,
        # stable (ties by flat index), the first k kept
        neg_losses = torch.where(pos, -torch.inf, flat)
        neg_sorted = -torch.sort(-neg_losses, dim=1, stable=True).values
        rank = torch.arange(flat.shape[1], device=flat.device)
        neg_sum = torch.where(rank[None] < k[:, None], neg_sorted, 0.0).sum(1)
    else:
        neg_sum = _top_k_sum_bisect_rows(flat, ~pos, k)
    denom = torch.clamp(n_pos + k, min=1).to(torch.float32)
    return (pos_sum + neg_sum) / denom


def detection_loss_single(
    det_logits: torch.Tensor, pos_mask: torch.Tensor, ratio: float, use_sort: bool = False,
) -> torch.Tensor:
    """One image: (Ho, Wo) logits + bool positives -> scalar mined BCE.

    ``use_sort`` selects the stable-sort top-k formulation (the reference);
    the default is the sort-free bisection (identical sums and gradients)."""
    return _detection_loss_rows(det_logits[None], pos_mask[None], ratio, use_sort)[0]


def _classification_loss_rows(cls_logits: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
    """(B, Ho, Wo, C) logits + int segmap (0 bg, 1+cls) -> (B,) CE."""
    B = cls_logits.shape[0]
    mask = segmap > 0
    labels = torch.clamp(segmap - 1, min=0).long()
    logp = torch.log_softmax(cls_logits, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    n = mask.reshape(B, -1).sum(1)
    nll = torch.where(mask, -ll, 0.0).reshape(B, -1).sum(1)
    return nll / torch.clamp(n, min=1).to(torch.float32)


def classification_loss_single(cls_logits: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
    """One image: (Ho, Wo, C) logits + int segmap (0 bg, 1+cls) -> scalar CE."""
    return _classification_loss_rows(cls_logits[None], segmap[None])[0]


def total_loss(
    logits: torch.Tensor,
    segmap: torch.Tensor,
    cfg: NetConfig,
    cls_weight: torch.Tensor | float | None = None,
):
    """Batched combined loss.

    Args:
      logits: (B, Ho, Wo, 1 + n_classes) model output.
      segmap: (B, Ho, Wo) int GT (0 background, 1 + class_index).
      cls_weight: optional override of cfg.classification_loss_weight (the
        Trainer's cls-weight ramp passes the step-dependent value here).
    Returns: (scalar_loss, aux dict with "detection_loss", optionally
    "classification_loss", and "loss").
    """
    pos = segmap > 0
    det = _detection_loss_rows(logits[..., 0], pos, float(cfg.hard_negative_ratio)).mean()
    aux = {"detection_loss": det}
    loss = cfg.detection_loss_weight * det
    if cfg.classification and logits.shape[-1] > 1:
        w = cfg.classification_loss_weight if cls_weight is None else cls_weight
        cls = _classification_loss_rows(logits[..., 1:], segmap).mean()
        aux["classification_loss"] = cls
        loss = loss + w * cls
    aux["loss"] = loss
    return loss, aux

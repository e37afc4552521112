"""Pixel-level training metrics.

Counterpart of ``ubdvss_tpu/metrics.py``: precision, recall, F1 and
accuracy of the thresholded detection channel against the GT segmap, for
progress monitoring during training (the object-level metrics live in
evaluate.py).  They are ratios of counts, so the metrics of a batch split
over a mesh are those of its summed counts (``pixel_counts``,
``metrics_from_pixel_counts``), not a mean of the shards' ratios.
"""

from __future__ import annotations

import torch


def pixel_counts(det_logits: torch.Tensor, segmap: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """(B, Ho, Wo) logits + int GT map -> (4,) int64: true positives, false
    positives, false negatives and pixels predicted right.

    The threshold is applied as a logit, log(t / (1 - t)), rounded to f32
    as the JAX package computes it."""
    t = torch.tensor(threshold / (1.0 - threshold), dtype=torch.float32)
    pred = det_logits > torch.log(t).item()
    gt = segmap > 0
    return torch.stack([(pred & gt).sum(), (pred & ~gt).sum(), (~pred & gt).sum(), (pred == gt).sum()])


def metrics_from_pixel_counts(counts: torch.Tensor, n_pixels: int) -> dict:
    """``pixel_counts`` (summed over any number of batches) over ``n_pixels``
    pixels -> dict of scalar P/R/F1/accuracy."""
    tp, fp, fn, right = counts.unbind()
    precision = tp / torch.clamp(tp + fp, min=1)
    recall = tp / torch.clamp(tp + fn, min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    return {
        "pixel_precision": precision.to(torch.float32),
        "pixel_recall": recall.to(torch.float32),
        "pixel_f1": f1.to(torch.float32),
        "pixel_accuracy": (right / n_pixels).to(torch.float32),
    }


def pixel_detection_metrics(
    det_logits: torch.Tensor, segmap: torch.Tensor, threshold: float = 0.5
) -> dict:
    """(B, Ho, Wo) logits + int GT map -> dict of scalar P/R/F1/accuracy."""
    return metrics_from_pixel_counts(pixel_counts(det_logits, segmap, threshold), det_logits.numel())

"""Pixel-level training metrics.

Counterpart of ``ubdvss_tpu/metrics.py``: precision, recall, F1 and
accuracy of the thresholded detection channel against the GT segmap, for
progress monitoring during training (the object-level metrics live in
evaluate.py).
"""

from __future__ import annotations

import torch


def pixel_detection_metrics(
    det_logits: torch.Tensor, segmap: torch.Tensor, threshold: float = 0.5
) -> dict:
    """(B, Ho, Wo) logits + int GT map -> dict of scalar P/R/F1/accuracy.

    The threshold is applied as a logit, log(t / (1 - t)), rounded to f32
    as the JAX package computes it."""
    t = torch.tensor(threshold / (1.0 - threshold), dtype=torch.float32)
    pred = det_logits > torch.log(t).item()
    gt = segmap > 0
    tp = (pred & gt).sum()
    fp = (pred & ~gt).sum()
    fn = (~pred & gt).sum()
    precision = tp / torch.clamp(tp + fp, min=1)
    recall = tp / torch.clamp(tp + fn, min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-12)
    accuracy = (pred == gt).to(torch.float32).mean()
    return {
        "pixel_precision": precision.to(torch.float32),
        "pixel_recall": recall.to(torch.float32),
        "pixel_f1": f1.to(torch.float32),
        "pixel_accuracy": accuracy,
    }


"""Visualization helpers (numpy only).

A copy of ``ubdvss_tpu/utils/visualization.py``, which the port keeps so
that it never imports the JAX package.  The original module docstring
follows.

Visualization helpers (SURVEY.md §1 L10, §2a "Visualization").

Draw predicted/GT rectangles and detection heatmaps onto images for
TensorBoard summaries and debugging — host-side, off the hot path, pure
numpy (OpenCV stays a test-only oracle in this repo).
"""

from __future__ import annotations

import numpy as np

RED = (230, 60, 50)
GREEN = (60, 200, 90)
BLUE = (70, 120, 230)


def _to_rgb(image: np.ndarray) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.copy()


def draw_polygon(img: np.ndarray, pts: np.ndarray, color=RED, thickness: int = 1):
    """Draw a closed polygon by dense edge sampling (in place)."""
    h, w = img.shape[:2]
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    for i in range(n):
        a, b = pts[i], pts[(i + 1) % n]
        steps = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]), 1) * 2) + 1
        t = np.linspace(0.0, 1.0, steps)
        xs = np.round(a[0] + t * (b[0] - a[0])).astype(int)
        ys = np.round(a[1] + t * (b[1] - a[1])).astype(int)
        for dx in range(thickness):
            for dy in range(thickness):
                xi = np.clip(xs + dx, 0, w - 1)
                yi = np.clip(ys + dy, 0, h - 1)
                img[yi, xi] = color
    return img


def draw_detections(
    image: np.ndarray,
    boxes: np.ndarray | list,
    classes=None,
    gt_polygons: list | None = None,
    color=RED,
    gt_color=GREEN,
) -> np.ndarray:
    """Overlay predicted rects (and optional GT polygons) on an image.

    boxes: (N, 4, 2) corners in image coords (e.g. Detection.box values).
    """
    img = _to_rgb(image)
    if gt_polygons:
        for poly in gt_polygons:
            draw_polygon(img, poly, gt_color)
    for box in np.asarray(boxes).reshape(-1, 4, 2) if len(boxes) else []:
        draw_polygon(img, box, color, thickness=2)
    return img


def heatmap_overlay(
    image: np.ndarray, heatmap: np.ndarray, alpha: float = 0.5
) -> np.ndarray:
    """Blend a detection-probability heatmap (any resolution) over an image."""
    img = _to_rgb(image).astype(np.float32)
    h, w = img.shape[:2]
    hm = np.asarray(heatmap, np.float32)
    ry = int(np.ceil(h / hm.shape[0]))
    rx = int(np.ceil(w / hm.shape[1]))
    hm_up = np.kron(hm, np.ones((ry, rx)))[:h, :w]
    overlay = np.zeros_like(img)
    overlay[..., 0] = 255.0 * hm_up
    out = (1 - alpha * hm_up[..., None]) * img + alpha * hm_up[..., None] * overlay
    return np.clip(out, 0, 255).astype(np.uint8)


def detection_summary_image(
    image: np.ndarray,
    result: dict,
    gt_polygons: list | None = None,
    scale_to_image: float = 1.0,
) -> np.ndarray:
    """Image + valid boxes from a postprocess()/detect result dict."""
    valid = np.asarray(result["valid"])
    boxes = np.asarray(result["boxes"])[valid] * scale_to_image
    return draw_detections(image, boxes, gt_polygons=gt_polygons)

"""Host-side polygon geometry for object-level evaluation (numpy only).

A copy of ``ubdvss_tpu/utils/geometry.py``, which the port keeps so that
it never imports the JAX package.  The original module docstring follows.

Host-side polygon geometry for object-level evaluation.

Convex polygon intersection (Sutherland–Hodgman) + IoU between rotated
rectangles, written in plain numpy so OpenCV stays a test-only oracle
(SURVEY.md §4.2 "IoU matcher vs brute force").  Used by evaluate.py's
matcher — metric computation is host work in the reference too (SURVEY.md
§3.2) and is negligible next to inference.
"""

from __future__ import annotations

import numpy as np


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of an (N, 2) polygon (vertex order irrelevant: abs)."""
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman: clip `subject` by convex `clip` polygon."""
    def is_ccw(p):
        x, y = p[:, 0], p[:, 1]
        return (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) > 0

    cl = clip if is_ccw(clip) else clip[::-1]
    out = [tuple(p) for p in subject]
    n = len(cl)
    for i in range(n):
        if not out:
            return np.zeros((0, 2))
        a, b = cl[i], cl[(i + 1) % n]
        edge = (b[0] - a[0], b[1] - a[1])
        inp = out
        out = []

        def side(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0])

        for j in range(len(inp)):
            cur, nxt = inp[j], inp[(j + 1) % len(inp)]
            sc, sn = side(cur), side(nxt)
            if sc >= 0:
                out.append(cur)
            if (sc >= 0) != (sn >= 0):
                denom = sc - sn
                if abs(denom) > 1e-12:
                    t = sc / denom
                    out.append(
                        (
                            cur[0] + t * (nxt[0] - cur[0]),
                            cur[1] + t * (nxt[1] - cur[1]),
                        )
                    )
    return np.asarray(out, np.float64) if out else np.zeros((0, 2))


def polygon_intersection_area(a: np.ndarray, b: np.ndarray) -> float:
    return polygon_area(clip_polygon(np.asarray(a, np.float64), np.asarray(b, np.float64)))


def iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two convex polygons (e.g. (4, 2) rotated rect corners)."""
    inter = polygon_intersection_area(a, b)
    if inter <= 0:
        return 0.0
    union = polygon_area(np.asarray(a)) + polygon_area(np.asarray(b)) - inter
    return float(inter / union) if union > 0 else 0.0

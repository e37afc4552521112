"""Ground-truth markup data classes (numpy only).

The part of ``ubdvss_tpu/markup.py`` that ``synthetic.py`` needs: one
barcode's polygon and type, one sample, and the reader interface.  The JSON
and XML readers and the reader registry are not ported yet (ROADMAP.md §1
item 10).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BarcodeObject:
    """One ground-truth barcode: polygon in input-image coords + type."""

    points: np.ndarray  # (N, 2) float32, (x, y)
    type_name: str


@dataclasses.dataclass
class Sample:
    image_path: str
    objects: list[BarcodeObject]
    # in-memory image (synthetic datasets); loaded from image_path when None
    image: np.ndarray | None = None


class MarkupReader:
    """Base reader interface."""

    def samples(self) -> list[Sample]:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.samples())

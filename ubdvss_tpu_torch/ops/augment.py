"""Train-time augmentation settings.

The ``AugmentConfig`` of ``ubdvss_tpu/ops/augment.py``, field for field, so
that ``data.DataConfig`` keeps the JAX package's default.  The augmentation
itself (``augment_batch``: random affine warp and photometric jitter) is
training code and is not ported (ROADMAP.md §1 item 10).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    rotation_deg: float = 15.0
    scale_range: tuple[float, float] = (0.7, 1.4)
    translate_frac: float = 0.05
    flip_prob: float = 0.5  # x-mirror probability
    flip_y_prob: float = 0.0  # y-mirror probability (off by default)
    crop_frac: float = 0.0  # random crop: window side in [1-crop_frac, 1]
    brightness: float = 30.0  # additive, 0..255 domain
    contrast_range: tuple[float, float] = (0.8, 1.2)
    noise_std: float = 4.0
    fill_value: float = 255.0  # background fill for out-of-frame samples

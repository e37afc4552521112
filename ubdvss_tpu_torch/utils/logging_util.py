"""Metric logging.

A copy of ``ubdvss_tpu/utils/logging_util.py``, which the port keeps so
that it never imports the JAX package: the same JSONL records and stderr
line; TensorBoard scalars through TensorFlow when it is importable, as in
the JAX package.  The original module docstring follows.

Metric logging (SURVEY.md §5 "Metrics / logging / observability").

Reference: Keras progbar + TensorBoard scalars/image summaries.  Here:
structured JSONL metric stream (always) + stdout progress + optional
TensorBoard scalars when TensorFlow is importable.  Kept off the hot path —
callers log already-device_get'd python floats.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class MetricLogger:
    def __init__(self, logdir: str | None = None, use_tensorboard: bool = True):
        self.logdir = Path(logdir) if logdir else None
        self._jsonl = None
        self._tb = None
        if self.logdir:
            self.logdir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.logdir / "metrics.jsonl", "a")
            if use_tensorboard:
                try:
                    import tensorflow as tf  # noqa: F401

                    self._tb = tf.summary.create_file_writer(str(self.logdir))
                except Exception:
                    self._tb = None
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, prefix: str = "train") -> None:
        rec = {
            "step": step,
            "wall_s": round(time.time() - self._t0, 3),
            "prefix": prefix,
            **{k: float(v) for k, v in metrics.items()},
        }
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            import tensorflow as tf

            with self._tb.as_default():
                for k, v in metrics.items():
                    tf.summary.scalar(f"{prefix}/{k}", float(v), step=step)
        msg = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        print(f"[{prefix}] step {step}: {msg}", file=sys.stderr)

    def log_image(self, step: int, name: str, image, prefix: str = "val") -> None:
        """TensorBoard image summary (no-op without TF/logdir) — the
        reference's prediction-overlay summaries (SURVEY.md §5)."""
        if self._tb is None:
            return
        import numpy as np
        import tensorflow as tf

        img = np.asarray(image)
        if img.ndim == 3:
            img = img[None]
        with self._tb.as_default():
            tf.summary.image(f"{prefix}/{name}", img, step=step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()

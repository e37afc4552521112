"""Single-image / directory detection CLI of the port.

Counterpart of ``ubdvss_tpu/detect.py``, with the same flags and report,
plus ``--device`` (the card unless asked otherwise):

    python -m ubdvss_tpu_torch.detect --images scan.png \
        --checkpoint assets/pretrained_synthetic.npz [--int8] [--output out.json] \
        [--save-overlays outdir]

Weights are ``.npz`` files (with their ``.net_config.json`` sidecar, when
there is one), Keras ``.h5``/``.keras`` files (``utils/keras_import.py``,
keras imported only then) or a training log directory of the port's
Trainer (its latest checkpoint in ``<logdir>/checkpoints`` and its
``net_config.json``; the JAX package's orbax directories raise, naming its
``--export-npz``).  ``--int8`` calibrates the int8 trunk on the input
images themselves (``calibrate_qparams``).  Images are read, and overlays
written, with cv2; a ``.npy`` image file (an (H, W) or (H, W, 3) RGB uint8
array) is read with numpy, so the CLI runs where cv2 is not installed.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ubdvss_tpu_torch.inference import BarcodeDetector, resolve_device
from ubdvss_tpu_torch.net_config import NetConfig
from ubdvss_tpu_torch.ops.preproc import resize_bilinear, to_grayscale_batch
from ubdvss_tpu_torch.ops.quant import (
    bias_correct_qparams,
    build_qparams,
    calibrate_scales,
    normalize_fma,
)
from ubdvss_tpu_torch.utils.checkpoint import (
    load_logdir_params,
    load_net_config,
    load_params_npz,
    params_from_flat,
)
from ubdvss_tpu_torch.utils.visualization import draw_detections


def load_params(checkpoint: str, cfg: NetConfig) -> dict:
    """The port's state_dict from an ``.npz`` weight file, a Keras
    ``.h5``/``.keras`` file of ``cfg``'s architecture, or a training log
    directory (its latest checkpoint)."""
    if checkpoint.endswith(".npz"):
        return params_from_flat(load_params_npz(checkpoint))
    if checkpoint.endswith(".h5") or checkpoint.endswith(".keras"):
        from ubdvss_tpu_torch.utils.keras_import import load_keras_weights

        return load_keras_weights(checkpoint, cfg)
    return load_logdir_params(checkpoint)


def calibrate_qparams(params: dict, cfg: NetConfig, images, device=None) -> dict | None:
    """int8 qparams calibrated on the user's own images, as the JAX CLI's
    ``--int8`` does: each of at most 16 (H, W[, 3]) RGB images preprocessed
    to its grid size, its activation scales merged by elementwise minimum,
    ``build_qparams``, then bias correction over a common top-left crop of
    the images (at most 512², a multiple of 8, skipped under 32).  None
    when there is no image.  Runs on ``device`` (default the card)."""
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    scales, pool = None, []
    for img in list(images)[:16]:
        x = to_grayscale_batch(torch.as_tensor(np.ascontiguousarray(img)).to(dev)[None])
        x = normalize_fma(resize_bilinear(x, cfg.grid_size(*img.shape[:2])))[0, ..., None]
        # per-image shapes differ: merge absmax (min of scales) per image
        s = calibrate_scales(params, cfg, x[None])
        scales = s if scales is None else [torch.minimum(a, b) for a, b in zip(scales, s)]
        pool.append(x)
    if scales is None:
        return None
    qparams = build_qparams(params, cfg, scales)
    # bias correction over a common top-left crop (the mean-error
    # statistics are translation-invariant conv outputs)
    hc = min(min(p.shape[0] for p in pool), 512) // 8 * 8
    wc = min(min(p.shape[1] for p in pool), 512) // 8 * 8
    if hc >= 32 and wc >= 32:
        calib = torch.stack([p[:hc, :wc] for p in pool])
        qparams = bias_correct_qparams(qparams, params, cfg, calib)
    return qparams


def main(argv=None):
    p = argparse.ArgumentParser(description="Detect barcodes in images")
    p.add_argument("--images", nargs="+", required=True,
                   help="image files or directories")
    p.add_argument("--checkpoint", required=True,
                   help="training logdir, params .npz, or Keras .h5/.keras")
    p.add_argument("--detection-only", action="store_true")
    p.add_argument("--output", default=None, help="write JSON detections here")
    p.add_argument("--save-overlays", default=None,
                   help="directory for box-overlay images")
    p.add_argument("--int8", action="store_true",
                   help="int8 quantized trunk (PTQ; activation ranges "
                        "calibrated on the input images themselves)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = load_net_config(args.checkpoint)
    if cfg is None:
        cfg = NetConfig(classification=not args.detection_only)
    elif args.detection_only:
        cfg = cfg.replace(classification=False)
    params = load_params(args.checkpoint, cfg)

    paths: list[Path] = []
    for item in args.images:
        q = Path(item)
        paths.extend(sorted(q.glob("*")) if q.is_dir() else [q])

    def read(path):
        if path.suffix == ".npy":
            return np.load(path)
        import cv2

        img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        return img if img is None or img.ndim == 2 else img[..., ::-1]  # BGR -> RGB

    qparams = None
    if args.int8:
        calib = [img for img in map(read, paths[:16]) if img is not None]
        qparams = calibrate_qparams(params, cfg, calib, args.device)
    det = BarcodeDetector(cfg, params, qparams=qparams, device=args.device)

    report = {}
    for path in paths:
        img = read(path)
        if img is None:
            continue
        dets = det.detect(np.ascontiguousarray(img))
        report[str(path)] = [
            {
                "box": d.box.tolist(),
                "class": d.class_name,
                "score": d.score,
                "angle_deg": d.angle_deg,
            }
            for d in dets
        ]
        print(f"{path}: {len(dets)} detections")
        if args.save_overlays:
            import cv2

            out = draw_detections(img, np.stack([d.box for d in dets]) if dets else [])
            Path(args.save_overlays).mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(Path(args.save_overlays) / path.name), out[..., ::-1])
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()

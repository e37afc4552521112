"""Object-level evaluation: P/R/F1 at IoU>=0.5 + type accuracy.

Counterpart of ``ubdvss_tpu/evaluate.py``, run as

    python -m ubdvss_tpu_torch.evaluate --data synthetic \
        --checkpoint assets/pretrained_synthetic.npz [--int8] [--device cpu]

The model runs over a markup'd dataset on the device (the card unless
``device="cpu"``), rectangles come out of ``detect_preprocessed_batch``,
and the host greedily matches predictions to ground truth at IoU >= 0.5
(predictions in descending score order, each GT matched at most once),
reporting object-level precision/recall/F1 plus barcode-type accuracy over
the matched detections — aggregate, per-class and per-group
(``net_config.CLASS_GROUPS``) — as the JAX package's JSON report.  The
matcher and the report are the JAX package's numpy code, copied.

Two resolution modes, as in the JAX package:
  * resized (default): every image comes through ``data.Batches`` at one
    common ``train_hw``, GT polygons transformed identically; the batch
    normalize is rounded once (``ops/quant.normalize_fma``), as the JAX
    package's jitted batch step computes it;
  * native (``--eval-native``): each image at its own ``cfg.grid_size(h,
    w)``, batches bucketed by grid shape, remainder batches padded to
    ``batch_size`` with blank images that never enter the match records;
    the normalize is a multiply and a subtract (``ops/preproc.normalize``),
    as the JAX package computes it eagerly there.

``--checkpoint`` takes a weight file or a training log directory of the
port's Trainer (``detect.load_params``).  ``mesh`` (``--num-devices``,
through ``train.setup_devices``) evaluates data-parallel: each batch is
sharded over the mesh by ``detect_preprocessed_batch(mesh=)``, a resized
remainder batch padded to ``batch_size`` with zero images first (as the
JAX package does), and the pad rows never reach the match records.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from ubdvss_tpu_torch.data import Batches, DataConfig, _to_device, _to_train_shape, load_image, pad_polygons
from ubdvss_tpu_torch.inference import _check_mesh, _data_parallel, detect_preprocessed_batch, resolve_device
from ubdvss_tpu_torch.net_config import CLASS_GROUPS, NetConfig
from ubdvss_tpu_torch.ops.preproc import normalize
from ubdvss_tpu_torch.ops.quant import qparams_to
from ubdvss_tpu_torch.parallel.mesh import replicate_to_mesh, shard_batch_to_mesh
from ubdvss_tpu_torch.utils.geometry import iou as polygon_iou


@dataclasses.dataclass
class EvalResult:
    precision: float
    recall: float
    f1: float
    class_accuracy: float
    n_images: int
    n_gt: int
    n_pred: int
    tp: int
    fp: int
    fn: int
    # per-type and per-group detection/classification metrics; None when
    # class names were not supplied (detection-only mode)
    per_class: dict | None = None
    per_group: dict | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)


def _poly_area(p: np.ndarray) -> float:
    """Shoelace area of an (N, 2) polygon (convex rects/quads here)."""
    x, y = p[:, 0], p[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))) / 2.0


def match_image_detailed(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    pred_classes: np.ndarray,
    gt_polys: list[np.ndarray],
    gt_classes: list[int],
    iou_threshold: float = 0.5,
) -> dict:
    """Greedy matching for one image, keeping class identities.

    Returns dict:
      matches: list of (pred_class, gt_class) over matched pairs;
      fp_classes: predicted classes of unmatched predictions;
      fn_classes: GT classes of unmatched ground truths.
    """
    order = np.argsort(-pred_scores)
    matched_gt: set[int] = set()
    matches: list[tuple[int, int]] = []
    fp_classes: list[int] = []
    # AABB prefilter: a pair whose axis-aligned boxes overlap less than the
    # threshold allows can never reach it — IoU <= inter_area(AABBs) /
    # max(area_p, area_g) — so most pairs are rejected with four
    # comparisons before the exact convex-polygon IoU.
    gt_aabb = [
        (g[:, 0].min(), g[:, 1].min(), g[:, 0].max(), g[:, 1].max(), _poly_area(g))
        for g in gt_polys
    ]
    for i in order:
        p = pred_boxes[i]
        px0, py0, px1, py1 = (
            p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()
        )
        p_area = _poly_area(p)
        best_j, best_iou = -1, iou_threshold
        for j, g in enumerate(gt_polys):
            if j in matched_gt:
                continue
            gx0, gy0, gx1, gy1, g_area = gt_aabb[j]
            iw = min(px1, gx1) - max(px0, gx0)
            ih = min(py1, gy1) - max(py0, gy0)
            if iw <= 0 or ih <= 0:
                continue
            if iw * ih < best_iou * max(p_area, g_area):
                continue  # upper bound on IoU already below the bar
            v = polygon_iou(p, g)
            if v >= best_iou:
                best_iou, best_j = v, j
        if best_j >= 0:
            matched_gt.add(best_j)
            matches.append((int(pred_classes[i]), int(gt_classes[best_j])))
        else:
            fp_classes.append(int(pred_classes[i]))
    fn_classes = [int(c) for j, c in enumerate(gt_classes) if j not in matched_gt]
    return {"matches": matches, "fp_classes": fp_classes, "fn_classes": fn_classes}


def match_image(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    pred_classes: np.ndarray,
    gt_polys: list[np.ndarray],
    gt_classes: list[int],
    iou_threshold: float = 0.5,
):
    """Greedy matching for one image; returns (tp, fp, fn, cls_hits)."""
    d = match_image_detailed(
        pred_boxes, pred_scores, pred_classes, gt_polys, gt_classes, iou_threshold
    )
    tp = len(d["matches"])
    hits = sum(1 for pc, gc in d["matches"] if pc == gc)
    return tp, len(d["fp_classes"]), len(d["fn_classes"]), hits


def _prf(tp: int, fp: int, fn: int) -> tuple[float, float, float]:
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    return p, r, 2 * p * r / max(p + r, 1e-12)


def evaluate_detections(
    per_image: list[dict],
    iou_threshold: float = 0.5,
    class_names: tuple[str, ...] | None = None,
    class_groups: dict[str, tuple[str, ...]] | None = None,
) -> EvalResult:
    """per_image entries: pred_boxes/scores/classes + gt_polys/gt_classes.

    With ``class_names``, also reports per-class detection P/R/F1 and type
    accuracy, plus per-group aggregates over ``class_groups`` (defaults to
    net_config.CLASS_GROUPS: 1D / 2D / postal).
    """
    TP = FP = FN = HITS = NGT = NPRED = 0
    names = list(class_names) if class_names else []
    cc = {n: dict(tp=0, fp=0, fn=0, hits=0, group_hits=0) for n in names}
    if class_groups is None:
        class_groups = CLASS_GROUPS
    group_of = {
        n: g for g, members in class_groups.items() for n in members if n in cc
    }

    def _name(idx: int) -> str | None:
        return names[idx] if 0 <= idx < len(names) else None

    for rec in per_image:
        d = match_image_detailed(
            rec["pred_boxes"],
            rec["pred_scores"],
            rec["pred_classes"],
            rec["gt_polys"],
            rec["gt_classes"],
            iou_threshold,
        )
        TP += len(d["matches"])
        FP += len(d["fp_classes"])
        FN += len(d["fn_classes"])
        HITS += sum(1 for pc, gc in d["matches"] if pc == gc)
        NGT += len(rec["gt_polys"])
        NPRED += len(rec["pred_boxes"])
        if names:
            for pc, gc in d["matches"]:
                gn, pn = _name(gc), _name(pc)
                if gn is None:
                    continue
                cc[gn]["tp"] += 1
                cc[gn]["hits"] += int(pc == gc)
                if pn is not None and group_of.get(pn) == group_of.get(gn):
                    cc[gn]["group_hits"] += 1
            for pc in d["fp_classes"]:
                pn = _name(pc)
                if pn is not None:
                    cc[pn]["fp"] += 1
            for gc in d["fn_classes"]:
                gn = _name(gc)
                if gn is not None:
                    cc[gn]["fn"] += 1

    per_class = per_group = None
    if names:
        per_class = {}
        for n in names:
            c = cc[n]
            if c["tp"] + c["fp"] + c["fn"] == 0:
                continue  # class absent from both GT and predictions
            p, r, f1 = _prf(c["tp"], c["fp"], c["fn"])
            per_class[n] = dict(
                precision=p,
                recall=r,
                f1=f1,
                accuracy=c["hits"] / max(c["tp"], 1),
                n_gt=c["tp"] + c["fn"],
                tp=c["tp"],
                fp=c["fp"],
                fn=c["fn"],
            )
        per_group = {}
        for g, members in class_groups.items():
            tp = sum(cc[n]["tp"] for n in members if n in cc)
            fp = sum(cc[n]["fp"] for n in members if n in cc)
            fn = sum(cc[n]["fn"] for n in members if n in cc)
            if tp + fp + fn == 0:
                continue
            hits = sum(cc[n]["hits"] for n in members if n in cc)
            ghits = sum(cc[n]["group_hits"] for n in members if n in cc)
            p, r, f1 = _prf(tp, fp, fn)
            per_group[g] = dict(
                precision=p,
                recall=r,
                f1=f1,
                accuracy=hits / max(tp, 1),  # exact-type accuracy
                group_accuracy=ghits / max(tp, 1),  # predicted type in group
                n_gt=tp + fn,
            )

    precision, recall, f1 = _prf(TP, FP, FN)
    return EvalResult(
        precision=precision,
        recall=recall,
        f1=f1,
        class_accuracy=HITS / max(TP, 1),
        n_images=len(per_image),
        n_gt=NGT,
        n_pred=NPRED,
        tp=TP,
        fp=FP,
        fn=FN,
        per_class=per_class,
        per_group=per_group,
    )


def _gt_lists(polys: np.ndarray, n_verts: np.ndarray, class_ids: np.ndarray):
    gt_polys = [polys[p, : n_verts[p]] for p in range(polys.shape[0]) if n_verts[p] >= 3]
    gt_classes = [
        int(class_ids[p]) - 1 for p in range(polys.shape[0]) if n_verts[p] >= 3
    ]
    return gt_polys, gt_classes


def _readback(tree, done, stream):
    """Device results -> host numpy arrays, leaf for leaf (dicts, tuples).

    On the card the copies go on ``stream`` behind ``done``, the event
    recorded after the batch's work: they wait for that batch alone, not
    for the batch dispatched after it on the compute stream, and the host
    waits for the copies only."""
    def walk(x, f):
        if isinstance(x, dict):
            return {k: walk(v, f) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, f) for v in x)
        return f(x) if isinstance(x, torch.Tensor) else x

    if stream is not None:
        stream.wait_event(done)
        with torch.cuda.stream(stream):
            def d2h(t):
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                return host.copy_(t, non_blocking=True)

            tree = walk(tree, d2h)
            copied = torch.cuda.Event()
            copied.record(stream)
        copied.synchronize()
    return walk(tree, lambda t: t.numpy())


def _collect_batch(
    per_image: list[dict], res: dict, polys, n_verts, class_ids,
    n_real: int | None = None,
):
    """Host detection results + padded GT arrays -> per-image match records.

    ``n_real`` drops pad entries appended by the native-mode bucket padding
    (only the first n_real images are real)."""
    polys = np.asarray(polys)
    n_verts = np.asarray(n_verts)
    class_ids = np.asarray(class_ids)
    if n_real is not None:
        polys, n_verts, class_ids = (
            polys[:n_real], n_verts[:n_real], class_ids[:n_real]
        )
    for b in range(polys.shape[0]):
        valid = res["valid"][b]
        gt_polys, gt_classes = _gt_lists(polys[b], n_verts[b], class_ids[b])
        per_image.append(
            dict(
                pred_boxes=res["boxes"][b][valid],
                pred_scores=res["scores"][b][valid],
                pred_classes=res["classes"][b][valid],
                gt_polys=gt_polys,
                gt_classes=gt_classes,
            )
        )


def run_evaluation(
    params: dict,
    reader,
    cfg: NetConfig,
    data_cfg: DataConfig | None = None,
    iou_threshold: float = 0.5,
    native: bool = False,
    qparams=None,
    prefetch_depth: int = 2,
    mesh=None,
    device=None,
) -> EvalResult:
    """Batched device inference over a markup dataset -> EvalResult.

    ``params``: the port's state_dict.  ``native=False``: images come
    through ``data.Batches`` at ``data_cfg.train_hw`` (GT transformed
    identically) and the normalized batches feed the model directly.
    ``native=True``: per-image ``cfg.grid_size(h, w)`` resolution,
    shape-bucketed batches.  ``qparams`` evaluates the int8 trunk
    (``ops/quant.py``).  Runs on ``device`` (default the card).

    Feed/compute/readback overlap, as in the JAX package: the host collate
    and the copy to the device of batch N+1 run in a prefetch thread
    (``prefetch_depth``; 0 = synchronous; on the card on a stream of its
    own, ``utils/prefetch.py``) while the device runs batch N, and batch
    N's device-to-host readback starts only after batch N+1 has been
    dispatched (on a stream of its own, so it waits for batch N alone).

    ``mesh``: data-parallel evaluation — each batch sharded over the mesh
    (``detect_preprocessed_batch(mesh=)``), the weights placed once a
    distinct device, the results gathered on its first entry; a resized
    remainder batch is padded with zero images to ``batch_size``, which
    the mesh's size must divide, and the pad rows are dropped by
    ``n_real``.
    """
    dc = data_cfg or DataConfig(batch_size=8, max_polys=32)
    dc = dataclasses.replace(dc, shuffle=False, augment=None, drop_remainder=False)
    if mesh is not None:
        _check_mesh(mesh, device, dc.batch_size)
        device = mesh.devices.flat[0]  # where batches are fed and results gathered
    dev = resolve_device(device)
    params = {k: v.to(dev) for k, v in params.items()}
    qparams = None if qparams is None else qparams_to(qparams, dev)
    placed = None if mesh is None else replicate_to_mesh({"params": params, "qparams": qparams}, mesh)
    class_names = cfg.class_names if cfg.classification else None
    per_image: list[dict] = []
    pending: list[tuple] = []  # one-deep deferred (results, GT, n_real, event)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def collect_pending():
        while pending:
            res, gt, n_real, done = pending.pop(0)
            res, gt = _readback((res, gt), done, copy_stream)
            _collect_batch(per_image, res, *gt, n_real)

    def dispatch(x, gt, n_real):
        """Queue one batch's detection, then read back the batch before it."""
        if mesh is None:
            res, _ = detect_preprocessed_batch(params, x, cfg, qparams=qparams, device=dev)
        else:
            if x.shape[0] < dc.batch_size:  # the static shard shapes: pad, dropped by n_real
                x = torch.cat([x, x.new_zeros((dc.batch_size - x.shape[0],) + x.shape[1:])])
            shards = shard_batch_to_mesh(x, mesh, mesh.axis_names[0])
            res, _ = _data_parallel(detect_preprocessed_batch, mesh, placed, shards, None,
                                    tuple(x.shape[1:3]), cfg, n_strips=None)
        done = None
        if copy_stream is not None:
            done = torch.cuda.Event()
            done.record()
        collect_pending()
        pending.append((res, gt, n_real, done))

    if native:
        buckets: dict[tuple[int, int], list] = {}

        def flush(items):
            # pad remainder batches up to batch_size with blank images, so
            # that every grid runs at one batch shape; pad entries are
            # dropped from the match records via n_real
            n_real = len(items)
            z = items[0]
            items = items + [
                (torch.zeros_like(z[0]), torch.zeros_like(z[1]), np.zeros_like(z[2]),
                 np.zeros_like(z[3]))
            ] * (dc.batch_size - n_real)
            xs = torch.stack([it[0] for it in items])  # (b, H, W) f32 [0,255]
            gt = (torch.stack([it[1] for it in items]), np.stack([it[2] for it in items]),
                  np.stack([it[3] for it in items]))
            dispatch(normalize(xs)[..., None], gt, n_real)

        for s in reader.samples():
            img = load_image(s)
            grid = cfg.grid_size(img.shape[0], img.shape[1])
            p, nv, ci = pad_polygons(s, cfg, dc.max_polys, dc.max_verts)
            x, p = _to_train_shape(_to_device(img, dev), _to_device(p, dev), grid)
            buckets.setdefault(grid, []).append((x, p, nv, ci))
            if len(buckets[grid]) == dc.batch_size:
                flush(buckets.pop(grid))
        for items in buckets.values():
            flush(items)
    else:
        from ubdvss_tpu_torch.utils.prefetch import prefetched

        it = Batches(reader, cfg, dc, train=False, device=dev).epoch(0)
        if prefetch_depth > 0:
            it = prefetched(it, depth=prefetch_depth, device=dev)
        for batch in it:
            gt = (batch["polys"], batch["n_verts"], batch["class_ids"])
            dispatch(batch["images"], gt, batch["images"].shape[0])
    collect_pending()
    return evaluate_detections(per_image, iou_threshold, class_names=class_names)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Evaluate the barcode detector")
    p.add_argument("--data", required=True, help="dataset root, or 'synthetic'")
    p.add_argument("--markup-format", default="zvz-json")
    p.add_argument("--checkpoint", required=True,
                   help="training logdir, params .npz, or Keras .h5/.keras")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--image-size", type=int, nargs=2, default=(256, 256))
    p.add_argument("--eval-native", action="store_true",
                   help="evaluate each image at its own grid_size(h, w) "
                        "(max_image_side semantics) instead of --image-size")
    p.add_argument("--iou-threshold", type=float, default=0.5)
    p.add_argument("--detection-only", action="store_true")
    p.add_argument("--max-polys", type=int, default=32,
                   help="GT objects bound per image")
    p.add_argument("--report", default=None, help="write JSON report here")
    p.add_argument("--synthetic-samples", type=int, default=64)
    p.add_argument("--int8", action="store_true",
                   help="evaluate the int8 quantized trunk (PTQ calibrated "
                        "on the first --int8-calib eval images, ops/quant.py)")
    p.add_argument("--int8-calib", type=int, default=32)
    p.add_argument("--prefetch-depth", type=int, default=2,
                   help="feed/compute overlap depth (0 = synchronous feed)")
    p.add_argument("--num-devices", default=None,
                   help="data-parallel evaluation over this many CUDA devices "
                        "('auto' = all); the batch size must divide by it")
    p.add_argument("--allow-cpu-mesh", action="store_true",
                   help="let --num-devices past the cards build CPU entries "
                        "(tests and dry runs; never silent)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv: list[str] | None = None) -> EvalResult:
    args = build_argparser().parse_args(argv)
    from ubdvss_tpu_torch.detect import load_params
    from ubdvss_tpu_torch.markup import get_markup_reader
    from ubdvss_tpu_torch.ops.quant import quantize_trunk
    from ubdvss_tpu_torch.utils.checkpoint import load_net_config

    # the architecture comes from the weights' net_config.json sidecar when
    # present; --detection-only still overrides the head selection
    cfg = load_net_config(args.checkpoint)
    if cfg is None:
        cfg = NetConfig(classification=not args.detection_only)
    elif args.detection_only:
        cfg = cfg.replace(classification=False)
    params = load_params(args.checkpoint, cfg)
    dev = resolve_device(args.device)
    fmt = "synthetic" if args.data == "synthetic" else args.markup_format
    kw = (
        {"n_samples": args.synthetic_samples, "image_hw": tuple(args.image_size)}
        if fmt == "synthetic"
        else {}
    )
    reader = get_markup_reader(fmt, args.data, **kw)
    dc = DataConfig(
        batch_size=args.batch_size,
        train_hw=tuple(args.image_size),
        max_polys=args.max_polys,
    )
    qparams = None
    if args.int8:
        # standard PTQ: activation ranges from a small sample of the
        # evaluation distribution (ranges only — no label use)
        cal = []
        for batch in Batches(reader, cfg, dataclasses.replace(
            dc, shuffle=False, augment=None, drop_remainder=False
        ), train=False, device=dev).epoch(0):
            cal.append(batch["images"])
            if sum(c.shape[0] for c in cal) >= args.int8_calib:
                break
        params_d = {k: v.to(dev) for k, v in params.items()}
        qparams = quantize_trunk(params_d, cfg, torch.cat(cal)[: args.int8_calib])
    mesh = None
    if args.num_devices is not None:
        from ubdvss_tpu_torch.train import setup_devices

        mesh = setup_devices(args.num_devices, allow_cpu_mesh=args.allow_cpu_mesh)
        if args.batch_size % mesh.devices.size:
            raise SystemExit(
                f"--batch-size {args.batch_size} not divisible by the "
                f"{mesh.devices.size}-device mesh")
    result = run_evaluation(
        params, reader, cfg, dc, args.iou_threshold, native=args.eval_native,
        qparams=qparams, prefetch_depth=args.prefetch_depth, mesh=mesh, device=dev,
    )
    print(result.to_json())
    if args.report:
        with open(args.report, "w") as f:
            f.write(result.to_json())
    return result


if __name__ == "__main__":
    main()

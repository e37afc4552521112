#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (ubdvss_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the
repository around this file; exits non-zero, printing no result, without
them.  Phases, each of which raises on failure:

  1. the card's name and power limit (nvidia-smi), then the build of every
     kernel from ubdvss_tpu_torch/csrc/ (one nvcc per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, on the real logits of 64 synthetic 512x512 scenes plus
     adversarial maps (snake, checkerboard, tall bars, single pixels,
     staircase, noise, empty): CCL and slots identical, rect rows within
     1e-4 (or the same rectangle on an exact caliper tie) with any_edge
     identical, the context module within 1e-4 with TF32 off;
  3. the main path: assets/pretrained_synthetic.npz through params_from_flat,
     NetConfig() with max_components=16, B=64 synthetic 512x512 uint8 scenes
     from seed 7, detect_program_batch(device="cuda") with every launch
     counter set to 0 just before and read just after (each must be > 0),
     detections checked against the same call through the plain versions on
     the host CPU;
  4. timing with CUDA events (median of 10 samples of 10 back-to-back calls,
     after warm-up): img/s of the main
     path, each kernel's ms beside its plain version's, the library call's
     (where one PyTorch call computes the same function) and its bound;
     then a torch.profiler breakdown of the main path's device time by
     kernel and the device's busy share of the path's time.

Output: human-readable lines, then the nvidia-smi line, then one JSON line
{"kernels": [...]}, then the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from itertools import permutations
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
B, IMG, K, M = 64, 512, 16, 64
SEED = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 on the CUDA cores (no tensor cores)
ITERS, REPS, WARMUP = 10, 10, 2


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=ITERS, reps=REPS, warmup=WARMUP) -> float:
    """Time of one call of fn: the median over ``iters`` samples, each a
    CUDA-event interval around ``reps`` back-to-back calls divided by reps
    (so the device queue stays fed and a small kernel's time is not its
    wrapper's host time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def adversarial_maps(n=128):
    """(8, n, n) detection-logit maps that stress CCL, slots and rects."""
    rng = np.random.default_rng(SEED)
    maps = np.full((8, n, n), -6.0, np.float32)
    for c in range(0, n, 4):  # snake: columns joined alternately top/bottom
        maps[0, :, c] = 6
        maps[0, 0 if (c // 4) % 2 else n - 1, c : c + 5] = 6
    maps[1] = np.where(np.indices((n, n)).sum(0) % 2 == 0, 6.0, -6.0)  # checkerboard
    for i, x0 in enumerate(range(4, n - 8, 12)):  # tall bars: > M collinear rows
        maps[2, 2 + i % 5 : n - 2 - i % 7, x0 : x0 + 1 + i % 5] = 6
    ys, xs = rng.integers(0, n, (2, 300))  # single pixels
    maps[3, ys, xs] = 6
    for i in range(n):  # diagonal staircases
        maps[4, i, i] = 6
        maps[4, i, (3 * i) % n] = 6
    maps[5] = rng.normal(0, 1, (n, n))  # noise: many components, > K
    maps[6, 10:110, 20:100] = 6  # blob with holes and a notch
    maps[6, 40:60, 40:60] = -6
    maps[6, 70:80, 20:50] = -6
    return maps  # maps[7] stays empty


_PERMS = np.array(list(permutations(range(4))))


def same_corner_sets(a, b, atol):
    """(..., 4, 2) boxes -> (...) bool: b's corners are a's in some order."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = np.linalg.norm(a[..., :, None, :] - b[..., None, :, :], axis=-1)
    return d[..., np.arange(4), _PERMS].max(-1).min(-1) <= atol


def check_rect_rows(out, ref, atol=1e-4) -> tuple[float, int]:
    """Rows within atol with any_edge identical; a component whose rows
    differ must be the same rectangle reported from its other side (an
    exact tie of folded caliper angles, decided by rsqrt's last bit)."""
    from ubdvss_tpu_torch.ops.cuda.rect_kernel import rects_from_selection
    import torch

    if not np.array_equal(out[:, 6], ref[:, 6]):
        raise AssertionError("rect: any_edge differs from the plain version")
    close = np.all(np.abs(out - ref) <= atol, axis=1)
    flips = ~close
    if flips.any():
        ro = rects_from_selection(torch.from_numpy(out))
        rr = rects_from_selection(torch.from_numpy(ref))
        if not same_corner_sets(ro["points"], rr["points"], atol)[flips].all():
            raise AssertionError("rect: rows differ and the rectangles differ")
        ao = ro["size"].prod(-1).numpy()[flips]
        ar = rr["size"].prod(-1).numpy()[flips]
        if not np.allclose(ao, ar, atol=atol, rtol=1e-6):
            raise AssertionError("rect: tie flip with a different area")
    err = float(np.abs(out - ref)[np.broadcast_to(close[:, None], out.shape)].max())
    return err, int(flips.sum())


def compare_detections(out, ref, det_logits, box_atol, score_atol):
    """Detections of the kernel path == the plain path, image by image.

    Images holding a det logit within 1e-4 of the threshold are left out
    (one pixel may flip on rounding alone); so are class ids whose top two
    mean probabilities are within 1e-5.  Returns the counts left out."""
    near = (np.abs(det_logits) < 1e-4).reshape(len(det_logits), -1).any(1)
    keep = ~near
    for key in ("valid", "areas", "num_detections", "num_components_total"):
        if not np.array_equal(out[key][keep], ref[key][keep]):
            raise AssertionError(f"main path: {key} differs from the plain route")
    v = out["valid"][keep]
    srt = np.sort(ref["class_probs"][keep], -1)
    sure = v & (srt[..., -1] - srt[..., -2] > 1e-5)
    if not np.array_equal(out["classes"][keep][sure], ref["classes"][keep][sure]):
        raise AssertionError("main path: classes differ from the plain route")
    if not np.allclose(out["scores"][keep][v], ref["scores"][keep][v], atol=score_atol):
        raise AssertionError("main path: scores differ from the plain route")
    ok = same_corner_sets(out["boxes"][keep][v], ref["boxes"][keep][v], box_atol)
    if not ok.all():
        raise AssertionError("main path: boxes differ from the plain route")
    return int(near.sum()), int((v & ~sure).sum())


def profile_path(run, ms_per_batch: float, iters: int = 3) -> dict:
    """Device time of the main path by kernel (torch.profiler, CUPTI).

    Only kernel rows are summed (operator rows repeat their kernels' time);
    one stream runs them, so the sum is the device's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / iters / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    return {
        "profile_ms_per_batch": {k[:80]: ms for k, ms in rows[:15]},
        "device_busy_ms": busy,
        "busy_share": busy / ms_per_batch,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 2
    if not (REPO / "ubdvss_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the ubdvss_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from ubdvss_tpu_torch import NetConfig, detect_program_batch, load_params_npz, params_from_flat
    from ubdvss_tpu_torch.models.model import exact_f32
    from ubdvss_tpu_torch.ops.cuda import _build
    from ubdvss_tpu_torch.ops.cuda import ccl_kernel, context_kernel, postproc_kernel, rect_kernel
    from ubdvss_tpu_torch.ops.cuda.context_kernel import _pack_weights, stem_apply
    from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the f32 route needs them off")

    # --- 1. build every kernel, one nvcc per source, in parallel ---
    t0 = time.perf_counter()
    _build.build(["context_kernel", "ccl_kernel", "postproc_kernel", "rect_kernel"])
    log(f"build: {time.perf_counter() - t0:.1f} s (4 kernels, nvcc {' '.join(_build.NVCC_FLAGS)})")

    cfg = NetConfig(max_components=K, max_hull_points=M)
    params = params_from_flat(load_params_npz(REPO / "assets" / "pretrained_synthetic.npz"))
    params_d = {k: v.to(dev) for k, v in params.items()}
    reader = SyntheticMarkupReader(n_samples=B, image_hw=(IMG, IMG), seed=SEED)
    imgs = np.stack([reader.sample_at(i).image for i in range(B)])
    imgs_d = torch.from_numpy(imgs).to(dev)
    dil = tuple(cfg.dilations)

    # --- 2. each kernel against its plain version on the card ---
    with torch.inference_mode(), exact_f32():
        feat = stem_apply(params_d, imgs_d.float()[..., None], cfg, raw_gray=True)
        xc = feat.permute(0, 3, 1, 2).contiguous()  # (B, 24, 128, 128)
        w = _pack_weights(params_d, dil)
        ctx_k = context_kernel.fused_context_head(xc, *w, dil)
        ctx_p = context_kernel.context_head_reference(xc, *w, dil)
        torch.cuda.synchronize()
        err_ctx = float((ctx_k - ctx_p).abs().max())
        if not err_ctx <= 1e-4:
            raise AssertionError(f"context kernel: max |err| {err_ctx} > 1e-4")
        log(f"check context_layer: (B,C,H,W)={tuple(xc.shape)} max|err| {err_ctx:.3g} <= 1e-4")

        det_real = ctx_k[:, 0].contiguous()
        maps = torch.cat([det_real, torch.from_numpy(adversarial_maps()).to(dev)])
        for conn in (8, 4):
            lab_k = ccl_kernel.ccl_labels_from_logits(maps, connectivity=conn)
            lab_p = ccl_kernel.ccl_labels_reference(maps, connectivity=conn)
            if not torch.equal(lab_k, lab_p):
                bad = (lab_k != lab_p).flatten(1).any(1).nonzero().flatten().tolist()
                raise AssertionError(f"ccl ({conn}-conn): labels differ in maps {bad}")
        log(f"check ccl: {tuple(maps.shape)} 8- and 4-connected labels identical")
        lab = ccl_kernel.ccl_labels_reference(maps)
        geo_k = postproc_kernel.component_slots(maps, lab, K)
        geo_p = postproc_kernel.component_slots_reference(maps, lab, K)
        for key in geo_p:
            if not torch.equal(geo_k[key], geo_p[key]):
                raise AssertionError(f"slots: {key} differs from the plain version")
        log(f"check slots: K={K}, all five outputs identical")
        sel_k = rect_kernel.min_area_rect_select(geo_p["minx"], geo_p["maxx"], M)
        sel_p = rect_kernel.min_area_rect_select_reference(geo_p["minx"], geo_p["maxx"], M)
        err_rect, flips = check_rect_rows(sel_k.cpu().numpy(), sel_p.cpu().numpy())
        log(f"check rect_compact: M={M}, rows max|err| {err_rect:.3g} <= 1e-4, "
            f"any_edge identical, {flips} exact-tie flips (same rectangle)")

    # --- 3. the main path, counting launches ---
    wrappers = {
        "context_layer": context_kernel.fused_context_head,
        "ccl": ccl_kernel.ccl_labels_from_logits,
        "slots": postproc_kernel.component_slots,
        "rect_compact": rect_kernel.min_area_rect_select,
    }
    for f in wrappers.values():
        f.launches = 0
    res_d, logits_d = detect_program_batch(params_d, imgs, cfg, (IMG, IMG), device="cuda")
    torch.cuda.synchronize()
    launches = {name: f.launches for name, f in wrappers.items()}
    log(f"main path: B={B} {IMG}x{IMG} uint8 f32 K={K} M={M}, launches {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    res = {k: v.cpu().numpy() for k, v in res_d.items()}
    logits = logits_d.cpu().numpy()
    if not (np.isfinite(logits).all() and logits.shape == (B, IMG // 4, IMG // 4, 17)):
        raise AssertionError("main path: logits not finite or of the wrong shape")
    n_det = int(res["num_detections"].sum())
    if n_det == 0:
        raise AssertionError("main path: no valid detection")
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    ref, ref_logits = detect_program_batch(params, imgs, cfg, (IMG, IMG), device="cpu")
    t_cpu = time.perf_counter() - t0
    ref = {k: v.numpy() for k, v in ref.items()}
    err_logits = float(np.abs(logits - ref_logits.numpy()).max())
    if not err_logits <= 1e-4:
        raise AssertionError(f"main path: logits differ from the plain route by {err_logits}")
    skipped_imgs, skipped_cls = compare_detections(
        res, ref, logits[..., 0], box_atol=4e-4, score_atol=1e-5
    )
    log(f"main path: {n_det} detections in {B} images, "
        f"{int(res['num_components_total'].sum())} components; == plain route on the host "
        f"CPU ({t_cpu:.1f} s): logits max|err| {err_logits:.3g}, {skipped_imgs} images and "
        f"{skipped_cls} near-tie class ids left out")

    # --- 4. timing ---
    with torch.inference_mode(), exact_f32():
        def run_path(images=imgs_d):
            return detect_program_batch(
                params_d, images, cfg, (IMG, IMG), detections_only=True, device="cuda")

        ms_path = time_ms(run_path)
        ms_path_host = time_ms(lambda: run_path(imgs))
        prof = profile_path(run_path, ms_path)
        Bm, C, H, W = xc.shape
        O = w[3].shape[0]
        det = ctx_k[:, 0].contiguous()
        lab_main = ccl_kernel.ccl_labels_from_logits(det)
        geo = postproc_kernel.component_slots(det, lab_main, K)
        minx, maxx = geo["minx"], geo["maxx"]

        def library_context():
            x = xc
            for li, d in enumerate(dil):
                x = torch.nn.functional.conv2d(
                    x, w[0][li, :, :, 0, 0].T.reshape(C, 1, 3, 3), None, 1, d, d, C)
                x = torch.relu(torch.nn.functional.conv2d(
                    x, w[1][li][:, :, None, None], w[2][li][:, 0, 0]))
            return torch.nn.functional.conv2d(x, w[3][:, :, None, None], w[4][:, 0, 0])

        err_lib = float((library_context() - ctx_p).abs().max())
        if not err_lib <= 1e-4:
            raise AssertionError(f"library context differs from the plain version: {err_lib}")
        px = Bm * H * W
        # rect work this data needs: per component, valid edge directions x
        # packed points x 10 flops (4 mul, 2 add, 4 min/max)
        Nc = minx.shape[0] * K
        rowv = (maxx >= 0).reshape(Nc, H)
        n_pts = torch.zeros(Nc, dtype=torch.int64, device=dev)
        n_dirs = torch.zeros_like(n_pts)
        for v_, s_ in ((minx, 1), (maxx, -1)):
            alive = rect_kernel._convexify(v_.reshape(Nc, H).long(), rowv, s_)
            n = alive.sum(1).clamp(max=M)
            n_pts += n
            n_dirs += (n - 1).clamp(min=0)
        rect_flops = float((n_dirs * n_pts).sum()) * 10
        kernels = [
            dict(
                name="context_layer", route="cuda",
                source="ubdvss_tpu_torch/csrc/context_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/context_kernel.py:39",
                launches=launches["context_layer"], max_abs_err=err_ctx,
                ms=time_ms(lambda: context_kernel.fused_context_head(xc, *w, dil)),
                plain_ms=time_ms(lambda: context_kernel.context_head_reference(xc, *w, dil)),
                library_ms=time_ms(library_context),
                bound=bound(
                    (px * C + px * O) * 4 + sum(t.numel() for t in w) * 4,
                    px * (len(dil) * (9 * C * 2 + C * C * 2 + 2 * C) + O * C * 2),
                ),
            ),
            dict(
                name="ccl", route="cuda", source="ubdvss_tpu_torch/csrc/ccl_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/ccl_kernel.py:116",
                launches=launches["ccl"], max_abs_err=0.0,
                ms=time_ms(lambda: ccl_kernel.ccl_labels_from_logits(det)),
                plain_ms=time_ms(lambda: ccl_kernel.ccl_labels_reference(det)),
                library_ms=None,
                bound=bound(px * 8, px * 9),  # logits in, labels out; one 3x3 pass
            ),
            dict(
                name="slots", route="cuda", source="ubdvss_tpu_torch/csrc/postproc_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/postproc_kernel.py:130",
                launches=launches["slots"], max_abs_err=0.0,
                ms=time_ms(lambda: postproc_kernel.component_slots(det, lab_main, K)),
                plain_ms=time_ms(lambda: postproc_kernel.component_slots_reference(det, lab_main, K)),
                library_ms=None,
                bound=bound(px * 12 + Bm * K * (2 * H + 1) * 4 + Bm * 4, px * 4),
            ),
            dict(
                name="rect_compact", route="cuda", source="ubdvss_tpu_torch/csrc/rect_kernel.cu",
                replaces="ubdvss_tpu/ops/pallas/rect_kernel.py:294",
                launches=launches["rect_compact"], max_abs_err=err_rect,
                ms=time_ms(lambda: rect_kernel.min_area_rect_select(minx, maxx, M)),
                plain_ms=time_ms(lambda: rect_kernel.min_area_rect_select_reference(minx, maxx, M)),
                library_ms=None,
                bound=bound(Nc * H * 8 + Bm * 9 * K * 4, rect_flops),
            ),
        ]
    for kd in kernels:
        kd["bound_ms"], kd["bound_by"] = kd.pop("bound")
        log(f"time {kd['name']}: {kd['ms']:.4f} ms/call (plain {kd['plain_ms']:.4f}, "
            f"library {kd['library_ms']}, bound {kd['bound_ms']:.4f} by {kd['bound_by']})")
    log(json.dumps({
        "path": "detect_program_batch fused f32, uint8 images on the card",
        "batch": B, "image": IMG, "K": K, "M": M, "ms_per_batch": ms_path,
        "img_per_s": B / ms_path * 1e3,
        "ms_per_batch_host_images": ms_path_host,
        "img_per_s_host_images": B / ms_path_host * 1e3, "plain_cpu_s": t_cpu,
    }))
    log(json.dumps(prof))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Parent against change for the port's kernels on one CUDA card: the
geometry kernels (CCL K1, slots K2, fused compat geometry K12c, compacted
rect K3 and uncompacted rect K3x), the int8 trunk and the calibration's
bias correction, the tiled kernels of the large maps, K3x's tall
instance, and the any-width instances of K4 and the int8 convs.

    python3 scripts/torch_kernel_ab.py --parent PARENT_TREE
        [--only geometry|int8|tiled|tall|widths] [--variants TREE ...]
        [--parts exact narrow stats wide int8] [--stats-logits C ...] [--out FILE]

PARENT_TREE is an unpacked earlier commit of this repository (for example
``git archive <commit> | tar -x -C tmp/parent``, under a directory that git
ignores).  Both trees' sources are built with this tree's nvcc flags into
``build/ab/`` and called through their C entry points on the same tensors,
with preallocated outputs, in the order parent, change, change, parent.
Each case reports the median of 15 CUDA-event samples of 20 back-to-back
calls (``ms``) and the mean of its kernels' CUPTI durations over 20 calls
(``device_ms``, torch.profiler).

Geometry (the parent's C entry points must take this tree's arguments):
the asset's model on B=64 synthetic 512x512 scenes (seed 7, K=16) and on
64 QVGA 240x320 frames (seed 7).  Cases: K1 on the batch's 128² detection
maps, on the stream's 60x80 maps and on one image's map (B=1, as a detect
call gives it), and the change's device-memory K1 (``ccl_labels_tiled``,
timed in the change's turns) on the same maps; K3x on the stream's
extremes (B=64, H=60) and on four single images' extremes (B=1, H=128);
K3 at M=64 on the batch's extremes; K12c on the batch's logits and CCL +
slots.  Before timing, the outputs are checked: K1's labels (both of the
change's K1 entries), K3x's and K3's rows and K12c's eight outputs
identical between the trees, and K12c's identical to CCL + slots.  Each
``--variants`` tree (another ``csrc/rect_kernel.cu`` of the change, under
its own directory name) has its K3x rows checked against the change's and
timed in the change's turns.

int8 (the parent is commit 124d259, before the calibration's redesign): both
trees' serving trunks (``qstem_tc``
and ``qconv_tc``, eight launches; the parent's plan ints are this tree's
without the five fields this tree added to ``struct Plan``) on qparams
calibrated on the card (``quantize_trunk``, 32 synthetic 512² scenes, seed
99), for B=64 512² uint8 scenes (seed 7, NetConfig()) and B=8 2048² uint8
scans (seed 11, the asset's config): the logits must be identical, then
each trunk is timed.  Then the bias correction's walk over the calibration
scenes (``bias_correct_qparams``' int8 part after the f32 pre-activations,
which both trees share): the parent's 19 launches of the dp4a
``qconv_layer`` (a layer's f32 pre-activation, then the layer again with
the corrected bias for its int8 output; the head once) against this tree's
``qconv_layer_f32`` a layer (one launch: the pre-activation and the exact
accumulator) and ``requantize``; the corrected biases and the head's
pre-activation must be identical; the whole walk (its ``torch.mean``
calls included) and each launch alone are timed.  Then each tree's
``quantize_trunk`` on the card over those calibration scenes
(NetConfig(), bias correction on), in a process of its own started in the
tree (parent, change, change, parent): wall seconds of four calls after a
first one that builds the tree's kernels.

tiled: ``ccl_labels_tiled``, ``component_slots_tiled`` and
``geometry_compat_large``, f32 and bf16, on the B=8 2048² scans' 512² maps
(seed 11), the 4096² scan's 1024² map (seed 11) and an A4 page's 1754x1240
map (7016x4960 at 600 dpi, seed 7, 3-6 barcodes), the asset's config (K=64,
C=17), logits from the f32 trunk (the NHWC view over planes) or the bf16
trunk (channels last).  The parent is called by PR 11's C signatures
(``Pr11Tiled``: sizes as ints, PR 11's chunk, tile rows and warps), the
change by this tree's (``ChangeTiled``: ``tiled_plan``'s ints and
``tiled_scratch``).  Checks first: labels and slot outputs (roots, slots,
extremes, counts, areas) identical between the trees, each tree's
det_sums / areas and cls_sums / areas within 2e-6 of the f64 sums (bf16:
plus the rounding-boundary slack), each tree's large K12c bit for bit its
pair.  Then each call is timed (CUDA events) and split by launch from the
profiler's chrome trace: each kernel's device ms, grid, block, registers,
shared memory and estimated resident warps an SM (``chip_smoke.phase_split``).

tall: K3x's tall instance, the parent's (persistent blocks with a
device-memory workspace, called with that design's slot size) against this
tree's (a cluster a component), through the same C entry
(``rect_select_exact_tall``), on the 8192x1024 page's extremes (the
asset's model, K=64, H=2048, seed 8, as detect gives them to K3x) and on
synthetic extremes (K=16, B=1 and 3, 2048 and 4096 rows) whose slot 0 is
a staircase over every row (``chip_smoke.synthetic_extremes``) or a convex
blob whose every row is a hull point (``chip_smoke.round_extremes``).  The
rows must be identical; each case is timed; then a build of each tree
with ``clock64()`` stamps between the steps (the parent's source patched
at its step comments, this tree's compiled with ``-DRECT_TALL_STAMPS``)
gives the cycles of each step for the case's slowest component.  Each
``--variants`` tree (another ``csrc/rect_kernel.cu`` of the change) has
its rows checked against the change's and is timed in the change's turns.

widths: the kernels of the widths past the asset's, both trees'
``context_kernel.cu``, ``qconv_kernel.cu``, ``qstem_kernel.cu`` (with
``qconv.cuh``), ``postproc_kernel.cu`` and ``geometry_kernel.cu`` called
through their C entry points (each tree's int8 launches with the plan of
its own ``tile_plan``), all compiled with ``-Xptxas -v``: every K4, stats,
stem, layer-0 and any-width conv kernel's registers, stack frame and
spill bytes go to the report (``ptxas``).  Only the sources the parts
need are built.  ``--parts`` picks the sections, in this order:
  exact: K4 at its compiled widths (C = 8, 16, 24, 32 with at most 32
    outputs), each tree called with its own plan (a tree whose
    ``context_kernel.py`` has ``exact_plan`` passes each layer's P, rows of
    threads and threads a block to ``context_layer``; a tree from before
    ``exact_plan`` takes none): the
    asset's weights on the stem's features of the 64 synthetic 512² scenes,
    (64, 24, 128²) unpacked, of the B=8 2048² scans (seed 11), (8, 24,
    512²) packed, and of 64 QVGA frames (seed 7), (64, 24, 60x80); random
    features and weights (seed 7) at (64, C, 128²), C = 8, 16, 32, with
    heads of 1, 17 and 32, at the asset's dilations.  Each case also
    reports the one-launch-a-layer byte floor (``chip_smoke.k4_byte_floor``)
    and each tree's plan.  Then the SASS of each tree's exact kernels
    (``cuobjdump -sass``: LDS by width, LDG, LDC, FFMA, STG and the rest,
    static counts), and a build of each tree with ``clock64()`` stamps (the
    parent's source patched at its phase comments, this tree's and each
    variant's compiled with ``-DCONTEXT_STAMPS``): the cycles of each of the
    asset's seven layers at (64, 24, 128²) summed over the warps by phase
    (the parent: depthwise, pointwise, store or head; this tree: depthwise,
    pointwise with its stores, head with its stores), and the static SASS
    counts between the stamps;
  narrow: K4 (``context_layer``, one launch a layer, the head fused into
    the last) up to 32 channels, on the narrow configuration
    (``chip_smoke.width_configs``: 10 channels, 17 logits) over the stem's
    features of 64 synthetic 512² scenes (seed 7), (64, 10, 128²)
    unpacked, and of two 2048² scans (seed 11), (2, 10, 512²) packed; then
    random features and weights (seed 7) at (64, C, 128²), C = 4, 12, 20,
    31 with heads of 17 and 41, and (8, 41), (24, 33);
  stats: the stats at each logit count of ``--stats-logits`` (5, 25, 33,
    34, 41, 42, 65, 66 and 97: label sets of 4 and 24 classes and the ends
    of each compiled bound; the wide configuration, 48 channels,
    ``chip_smoke.carry_flat`` of the asset, seed 7, K=16), on the f32
    trunk's logits (the NHWC view of K4's planes) and the bf16 trunk's
    (channels last): the cluster K2 and K12c on the 64 scenes' logits and
    on them phase-major (``_s2d``), and the tiled K2 and the large K12c on
    the two scans' phase-major logits (``StatsTree``).  The
    cluster kernels' eight outputs must be the parent's bit for bit and
    K12c's K2's; the tiled and large kernels' slot outputs the parent's,
    each tree's means within 2e-6 (and the bf16 slack) of the f64 sums,
    the large K12c the tiled pair's bit for bit;
  wide: K4 past 32 channels on the wide configuration, (64, 48, 128²)
    unpacked and (2, 48, 512²) packed, and random weights at (64, C, 128²),
    C = 40, 64, 96, head 41;
  int8: at 36, 48 and 64 channels (``quantize_trunk`` on 8 of the scenes)
    the stem (``qstem_tc`` on the 64 uint8 scenes) and layer 0 alone
    (``qlayer0_tc`` on the same scenes normalized, y and the exact
    accumulator, then y alone); at 48 and 64 the six context layers'
    ``qconv`` on the trunk's own inputs, and at 48 ``qconv_head``
    (unpacked and packed) and the calibration's ``qconv_layer`` (layer 1
    of the six, f32 pre-activations and exact accumulators), every output
    equal to the plain version and to the parent's bit for bit.  The
    compiled stem and layer-0 plans (up to 32 channels, every input kind,
    four map shapes) must be the parent's int for int.
K4's outputs must be the parent's (and each variant's) bit for bit and
within max(1e-4, 1e-5 max|logit|) of the plain version.  Each case is
timed in turns, with its bound (``chip_smoke.bound``, ``stats_bound``) and
the library call beside it (cuDNN's depthwise and 1x1 chain for K4, the
torch one-hot stats for K2, f32 ``F.conv2d`` on the int8 values for the
int8 kernels, TF32 off): CUDA events around back-to-back calls, CUDA
events around calls queued behind a sleeping kernel
(``chip_smoke.queued_ms``: the device's time, whatever the host's
enqueueing costs) and the profiler's device ms (which has been seen to
drop launches on that machine), and each tree's kernels by launch from its
first turn: device ms, registers, shared memory, resident warps an SM
(``chip_smoke.phase_split``).  Each ``--variants`` tree (another
``context_kernel.cu``, ``postproc_kernel.cu``, ``geometry_kernel.cu`` and
``qstem_kernel.cu`` of the change, with their headers, and its own
``tile_plan``) has its K4, stats, stem and layer-0 outputs checked
against the change's (bit for bit; the tiled and large stats within the
f64 bar) and is timed in the change's turns.  With ``--variants``, the
change's and each variant's ``qstem_kernel.cu`` are also built with
``-DQSTEM_STAMPS``, and one stem call of each gives its cycles a tile by
phase (the window's
wait, the quantization, layer 0, layer 1; thread 0's ``clock64()``
between the block's barriers, summed over the blocks).

Prints one JSON object and writes it to FILE (default
``build/ab/ab.json``); exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from ubdvss_tpu_torch import NetConfig, load_net_config, load_params_npz, params_from_flat  # noqa: E402
from ubdvss_tpu_torch.models.model import exact_f32  # noqa: E402
from ubdvss_tpu_torch.ops.cuda import _build, ccl_kernel, postproc_kernel  # noqa: E402
from ubdvss_tpu_torch.ops.cuda.context_kernel import fused_model_apply  # noqa: E402
from ubdvss_tpu_torch.synthetic import SyntheticMarkupReader  # noqa: E402

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SOURCES = ("rect_kernel", "geometry_kernel", "ccl_kernel", "postproc_kernel")


def build(csrc: Path, tag: str, sources=SOURCES, extra=()) -> dict:
    """Compile the sources of one tree, in parallel (``extra``: more nvcc
    flags)."""
    return build_trees([(csrc, tag, sources, extra)])[tag]


def build_trees(trees, report: dict | None = None) -> dict:
    """Compile every (csrc, tag, sources, extra) of ``trees``, one nvcc a
    source, all started together: {tag: {source: CDLL}}.  With ``report``,
    each tree is compiled with ``-Xptxas -v`` and report[tag] gets every
    kernel's registers, stack frame and spill bytes (``ptxas_kernels``)."""
    out = REPO / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    for csrc, tag, sources, extra in trees:
        flags = [*extra, *(("-Xptxas", "-v") if report is not None else ())]
        for name in sources:
            so = out / f"{tag}-{name}.so"
            jobs.append((tag, name, so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(so), str(csrc / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs: dict = {}
    for tag, name, so, proc in jobs:
        log_, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {tag} {name}:\n{log_}")
        libs.setdefault(tag, {})[name] = ctypes.CDLL(str(so))
        if report is not None:
            report.setdefault(tag, {}).update(ptxas_kernels(log_))
    return libs


def ptxas_kernels(log_: str) -> dict:
    """Each kernel of an ``nvcc -Xptxas -v`` log, by its demangled name
    without arguments: registers, stack frame, spill stores and loads
    (bytes)."""
    import re

    rep: dict[str, dict] = {}
    cur = None
    for line in log_.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line) or re.search(
            r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            rep.setdefault(cur, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur:
            rep[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rep[cur]["registers"] = int(m.group(1))
    names = list(rep)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    out = {}
    for raw, dm in zip(names, plain):
        if "registers" not in rep[raw]:
            continue  # a device function's properties, not a kernel's
        dm = dm.replace("(anonymous namespace)::", "").replace("void ", "")
        cut = dm.find(">(")
        out[dm[:cut + 1] if cut >= 0 else dm.split("(")[0]] = rep[raw]
    return out


def time_ms(fn, iters=15, reps=20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def device_ms(fn, n=20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / n / 1e3


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream():
    return P(torch.cuda.current_stream().cuda_stream)


def card_room(libs: dict, H: int, W: int, K: int, C: int, bf16: bool) -> dict:
    """{g: clusters of g blocks of K2 and of K12c the card runs at once}
    from a tree's built libraries (``component_slots_room``,
    ``geometry_compat_room``), as ``postproc_kernel.cluster_room`` reads
    them from the package's own build."""
    threads = 32 * postproc_kernel.stats_warps(H, W, K, C)
    room = {}
    for g in postproc_kernel.SLOT_BLOCKS:
        n = []
        for lib, fn in ((libs["postproc_kernel"], "component_slots_room"),
                        (libs["geometry_kernel"], "geometry_compat_room")):
            out = ctypes.c_int(0)
            check(getattr(lib, fn)(I(C), I(H), I(W), I(K), I(threads), I(g), I(int(bf16)),
                                   ctypes.byref(out)), fn)
            n.append(out.value)
        room[g] = min(n)
    return room


def card_plan(libs: dict, B: int, H: int, W: int, K: int, C: int, bf16: bool):
    """This tree's ``slot_plan`` on the card, its room read from ``libs``."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return postproc_kernel.slot_plan(B, H, W, K, C, sms, card_room(libs, H, W, K, C, bf16))


def plan_args(plan, threads: int) -> tuple:
    """The ints a tree's cluster K2 and K12c take after their sizes: the
    plan's (threads, blocks), or ``threads`` alone for a tree from
    before the plan (``plan`` None)."""
    return (I(threads),) if plan is None else tuple(I(v) for v in plan.ints)


def takes_plan(tree: Path) -> bool:
    """Whether a tree's cluster K2 and K12c take a plan (its
    ``postproc_kernel.py`` has ``slot_plan``)."""
    return "def slot_plan(" in (tree / "ubdvss_tpu_torch" / "ops" / "cuda" / "postproc_kernel.py").read_text()


def geometry_ab(args, dev, res: dict) -> None:
    """The geometry kernels, parent against change (module docstring)."""
    libs = {"parent": build(args.parent / "ubdvss_tpu_torch" / "csrc", "parent"),
            "change": build(REPO / "ubdvss_tpu_torch" / "csrc", "change")}
    variants = [v.name for v in args.variants]
    for v in args.variants:
        libs[v.name] = build(v / "ubdvss_tpu_torch" / "csrc", v.name, ("rect_kernel",))

    # inputs: the main path's logits and extremes, the stream's extremes
    asset = REPO / "assets" / "pretrained_synthetic.npz"
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(asset)).items()}
    B, K, M = 64, 16, 64
    reader = SyntheticMarkupReader(n_samples=B, image_hw=(512, 512), seed=7)
    imgs = torch.from_numpy(np.stack([reader.sample_at(i).image for i in range(B)])).to(dev)
    reader_q = SyntheticMarkupReader(n_samples=B, image_hw=(240, 320), seed=7)
    frames = torch.from_numpy(np.stack([reader_q.sample_at(i).image for i in range(B)])).to(dev)
    with torch.inference_mode(), exact_f32():
        lg = fused_model_apply(params, imgs.float()[..., None], NetConfig(), raw_gray=True)
        lg_q = fused_model_apply(params, frames.float()[..., None], load_net_config(asset),
                                 raw_gray=True)
    H, W, C = lg.shape[1:]
    det = lg[..., 0].contiguous()
    thr = ccl_kernel.threshold_logit(0.5)
    nw = postproc_kernel.stats_warps(H, W, K, C)
    geo = postproc_kernel.component_slots_from_logits(det, K)
    geo_q = postproc_kernel.component_slots_from_logits(lg_q[..., 0].contiguous(), K)
    res.update({"B": B, "H": H, "W": W, "K": K, "C": C, "M": M, "stats_warps": nw})

    extremes = {"stream_B64_H60": (geo_q["minx"], geo_q["maxx"])}
    singles = [(geo["minx"][b : b + 1].contiguous(), geo["maxx"][b : b + 1].contiguous())
               for b in range(4)]
    outs = {}

    def rect_exact(tag, mn, mx):
        Bq, Kq, Hq = mn.shape
        out = outs.setdefault(("x", tag, Bq, Hq), torch.empty((Bq, 9, Kq), device=dev))
        check(libs[tag]["rect_kernel"].rect_select_exact(
            P(mn.data_ptr()), P(mx.data_ptr()), P(out.data_ptr()), I(Bq), I(Kq), I(Hq),
            stream()), f"{tag} rect_select_exact")
        return out

    def rect_compact(tag, mn, mx, m=M):
        Bq, Kq, Hq = mn.shape
        out = outs.setdefault(("c", tag, Bq, Hq), torch.empty((Bq, 9, Kq), device=dev))
        check(libs[tag]["rect_kernel"].rect_select(
            P(mn.data_ptr()), P(mx.data_ptr()), P(out.data_ptr()), I(Bq), I(Kq), I(Hq), I(m),
            stream()), f"{tag} rect_select")
        return out

    geo_out = {t: postproc_kernel._empty_outputs(B, H, W, K, C, dev)
               for t in ("parent", "change", "pair")}
    det_maps = {"main_B64_128": det, "stream_B64_60x80": lg_q[..., 0].contiguous(),
                "detect_B1_128": det[:1].contiguous()}

    def ccl(tag, name, entry="ccl_labels"):
        d = det_maps[name]
        lab = outs.setdefault(("k1", tag, name, entry),
                              torch.empty(d.shape, dtype=torch.int32, device=dev))
        if entry == "ccl_labels_tiled":  # this tree's: the plan's ints
            arr = postproc_kernel.tiled_plan(*d.shape, 1, 1).ints
            size = (P(arr.ctypes.data), I(arr.size))
        else:
            size = tuple(I(n) for n in d.shape)
        check(getattr(libs[tag]["ccl_kernel"], entry)(
            P(d.data_ptr()), P(lab.data_ptr()), *size, F(thr), I(8), stream()), f"{tag} {entry}")
        return lab

    plans = {"parent": card_plan(libs["parent"], B, H, W, K, C, False) if takes_plan(args.parent)
             else None, "change": card_plan(libs["change"], B, H, W, K, C, False)}

    def k12c(tag):
        o = geo_out[tag]
        check(libs[tag]["geometry_kernel"].geometry_compat(
            P(lg.data_ptr()), *(L(s_) for s_ in lg.stride()), I(C),
            *(P(t.data_ptr()) for t in o.values()), I(B), I(H), I(W), I(K),
            *plan_args(plans[tag], 32 * nw), F(thr), I(8), stream()), f"{tag} geometry_compat")
        return o

    def pair(tag="change"):
        lib = libs[tag]
        labels = ccl(tag, "main_B64_128")
        o = geo_out["pair"]
        check(lib["postproc_kernel"].component_slots(
            P(lg.data_ptr()), *(L(s_) for s_ in lg.stride()), I(C), P(labels.data_ptr()),
            *(P(t.data_ptr()) for t in o.values()), I(B), I(H), I(W), I(K),
            *plan_args(plans[tag], 32 * nw), F(thr), stream()), "slots")
        return o

    # outputs first: identical labels, rows and geometry
    for name in det_maps:
        if not torch.equal(ccl("parent", name), ccl("change", name)):
            raise AssertionError(f"K1 labels differ between the trees on {name}")
        if not torch.equal(ccl("change", name, "ccl_labels_tiled"), ccl("change", name)):
            raise AssertionError(f"the device-memory K1 differs from the one-block K1 on {name}")
    for name, (mn, mx) in list(extremes.items()) + [
            (f"detect_image{b}", s_) for b, s_ in enumerate(singles)]:
        a, b_ = rect_exact("parent", mn, mx).clone(), rect_exact("change", mn, mx).clone()
        if not torch.equal(a, b_):
            raise AssertionError(f"K3x rows differ between the trees on {name}")
        for v in variants:
            if not torch.equal(rect_exact(v, mn, mx), b_):
                raise AssertionError(f"K3x rows of {v} differ from the change's on {name}")
    a = rect_compact("parent", geo["minx"], geo["maxx"]).clone()
    if not torch.equal(a, rect_compact("change", geo["minx"], geo["maxx"])):
        raise AssertionError("K3 rows differ between the trees")
    gp = {k: v.clone() for k, v in k12c("parent").items()}
    gc = {k: v.clone() for k, v in k12c("change").items()}
    gq = pair()
    for key in gc:
        if not torch.equal(gc[key], gq[key]):
            raise AssertionError(f"K12c {key} differs from CCL + slots")
        if not torch.equal(gc[key], gp[key]):
            raise AssertionError(f"K12c {key} differs from the parent's")
    res["rows_identical"] = True

    def detect_calls(tag):
        for mn, mx in singles:
            rect_exact(tag, mn, mx)

    cases = {
        **{f"k1_{name}": (lambda t, n=name: ccl(t, n)) for name in det_maps},
        # the change's device-memory K1 on the same maps (change's turns only)
        **{f"k1_tiled_{name}": (lambda t, n=name: ccl(t, n, "ccl_labels_tiled"))
           for name in det_maps},
        "k3x_stream_B64_H60": lambda t: rect_exact(t, *extremes["stream_B64_H60"]),
        "k3x_detect_B1_H128_4calls": detect_calls,
        "k3_main_M64": lambda t: rect_compact(t, geo["minx"], geo["maxx"]),
        "k12c_main": k12c,
        "k1_plus_k2_main": pair,
    }
    for turn in ("parent", "change", "change", "parent"):
        for tag in [turn] + (variants if turn == "change" else []):
            for name, fn in cases.items():
                if tag in variants and not name.startswith("k3x"):
                    continue
                if tag == "parent" and name.startswith("k1_tiled"):
                    continue
                key = f"{name}_{tag}"
                res.setdefault(key, []).append(time_ms(lambda: fn(tag)))
                res.setdefault(key + "_device", []).append(device_ms(lambda: fn(tag)))


# one tree's quantize_trunk on the card: argv = tree, asset, calibration images (.npy)
_CALIB_TIMER = """
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from ubdvss_tpu_torch import NetConfig, load_params_npz, params_from_flat
from ubdvss_tpu_torch.ops.quant import quantize_trunk
dev = torch.device("cuda")
params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(sys.argv[2])).items()}
calib = torch.from_numpy(np.load(sys.argv[3])).to(dev)
ts = []
with torch.inference_mode():
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quantize_trunk(params, NetConfig(), calib)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
print(json.dumps(ts[1:]))
"""


def calibration_ab(args, calib: np.ndarray, res: dict) -> None:
    """Each tree's quantize_trunk seconds on the card (module docstring)."""
    out = REPO / "build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    npy = out / "calib.npy"
    np.save(npy, calib)
    asset = REPO / "assets" / "pretrained_synthetic.npz"
    trees = {"parent": args.parent.resolve(), "change": REPO}
    for turn in ("parent", "change", "change", "parent"):
        run = subprocess.run([sys.executable, "-c", _CALIB_TIMER, str(trees[turn]), str(asset), str(npy)],
                             cwd=trees[turn], capture_output=True, text=True, timeout=600)
        if run.returncode != 0:
            raise RuntimeError(f"{turn} calibration failed:\n{run.stderr[-3000:]}")
        res.setdefault(f"calibration_s_{turn}", []).append(json.loads(run.stdout.strip().splitlines()[-1]))


def int8_ab(args, dev, res: dict) -> None:
    """The int8 kernels, parent against change (module docstring): the
    serving trunk, then the bias correction's walk."""
    from ubdvss_tpu_torch.models.model import same_pad
    from ubdvss_tpu_torch.ops.cuda import qconv_kernel as qk
    from ubdvss_tpu_torch.ops.quant import _conv_specs, _trunk_pre_relu, quantize_trunk

    libs = {"parent": build(args.parent / "ubdvss_tpu_torch" / "csrc", "parent8",
                            ("qconv_kernel", "qstem_kernel", "qconv_layer_kernel")),
            "change": build(REPO / "ubdvss_tpu_torch" / "csrc", "change8",
                            ("qconv_kernel", "qstem_kernel"))}
    asset = REPO / "assets" / "pretrained_synthetic.npz"
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(asset)).items()}

    def scenes(n, hw, seed):
        reader = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed)
        return np.stack([reader.sample_at(i).image for i in range(n)])

    cfg, cfg_l = NetConfig(), load_net_config(asset)
    calib_np = (scenes(32, (512, 512), 99).astype(np.float32) / 127.5 - 1.0)[..., None]
    calib = torch.from_numpy(calib_np).to(dev)
    with torch.inference_mode():
        q = quantize_trunk(params, cfg, calib)
    ptr = lambda t: P(None if t is None else t.data_ptr())  # noqa: E731
    # the parent's struct Plan lacks this tree's calibration fields, the
    # head's packed store and the any-width kernels' fields
    new = [qk.PLAN_FIELDS.index(f) for f in ("stride", "ks", "pad_t", "pad_l", "f32", "packed",
                                             "generic", "off_koff")]

    def plan_args(tag, plan):
        arr = plan.ints if tag == "change" else np.ascontiguousarray(np.delete(plan.ints, new))
        return arr, (P(arr.ctypes.data), I(arr.size))

    def trunk_calls(tag, x, c):
        """A tree's serving trunk, as int8_trunk_apply launches it:
        (name, library, entry, arguments, the plan's ints kept alive)."""
        B, H, W = x.shape
        L, s, n = q["layers"], q["s_in"], len(c.dilations)
        c0, c1 = L[0]["q"].shape[-1], L[1]["q"].shape[-1]
        plan = qk.tile_plan("stem", B, H, W, 1, c1, c0=c0, in_kind=qk.IN_U8_RAW)
        cur = torch.empty((B, plan.Ho, plan.Wo, c1), dtype=torch.int8, device=dev)
        arr, pa = plan_args(tag, plan)
        calls = [("qstem", "qstem_kernel", "qstem_tc",
                  (ptr(x), *(ptr(t) for t in (L[0]["q"], L[0]["ws"], L[0]["b"], s[1], L[1]["q"],
                                              L[1]["ws"], L[1]["b"], s[2], cur)), *pa), arr)]
        h, w = plan.Ho, plan.Wo
        for li, d in enumerate(c.dilations):
            last = li == n - 1
            layer, head = L[2 + li], q["head"]
            cout = layer["q"].shape[-1]
            nh = head["q"].shape[-1] if last else 0
            plan = qk.tile_plan("conv", B, h, w, cur.shape[-1], cout, dil=d, nh=nh)
            out = torch.empty((B, h, w, nh or cout), device=dev,
                              dtype=torch.float32 if last else torch.int8)
            arr, pa = plan_args(tag, plan)
            hp = (head["q"], head["ws"], head["b"]) if last else (None, None, None)
            calls.append(("head" if last else f"context{li}", "qconv_kernel", "qconv_tc",
                          (ptr(cur), ptr(layer["q"]), ptr(layer["ws"]), ptr(layer["b"]),
                           ptr(s[3 + li]), *(ptr(t) for t in hp), ptr(out), *pa), arr))
            cur = out
        return calls, cur

    def run(tag, calls):
        for name, lib, fn, a, _ in calls:
            check(getattr(libs[tag][lib], fn)(*a, stream()), f"{tag} {name}")

    for name, (imgs, c) in {"main_B64_512": (scenes(64, (512, 512), 7), cfg),
                            "scans_B8_2048": (scenes(8, (2048, 2048), 11), cfg_l)}.items():
        x = torch.from_numpy(imgs).to(dev)
        calls = {tag: trunk_calls(tag, x, c) for tag in ("parent", "change")}
        for tag, (cl, _) in calls.items():
            run(tag, cl)
        torch.cuda.synchronize()
        lg_p, lg_c = calls["parent"][1], calls["change"][1]
        if not torch.equal(lg_p, lg_c):
            raise AssertionError(f"int8 {name}: {int((lg_p != lg_c).sum())} logits differ")
        res[f"int8_{name}_logits_identical"] = True
        for turn in ("parent", "change", "change", "parent"):
            cl = calls[turn][0]
            key = f"int8_trunk_{name}_{turn}"
            res.setdefault(key, []).append(time_ms(lambda: run(turn, cl)))
            res.setdefault(key + "_device", []).append(device_ms(lambda: run(turn, cl)))

    # the bias correction's walk over the calibration scenes, the f32
    # pre-activations (cuDNN, as quantize_trunk computes them) once for both
    with torch.inference_mode():
        pre = _trunk_pre_relu(params, calib, cfg)
    specs = _conv_specs(cfg)
    s_in = q["s_in"]
    lib_p = libs["parent"]["qconv_layer_kernel"]

    def parent_layer(x, layer, s_out, st, d):
        """The parent's dp4a kernel (its C entry): f32 or int8 out."""
        ks, _, cin, cout = layer["q"].shape
        f32_in = x.dtype != torch.int8
        if f32_in:
            x = x[..., 0]
        B, H, W = x.shape[:3]
        ho, wo = -(-H // st), -(-W // st)
        out = torch.empty((B, ho, wo, cout), device=dev,
                          dtype=torch.float32 if s_out is None else torch.int8)
        check(lib_p.qconv_layer(
            ptr(x), ptr(layer["q"]), ptr(layer["ws"]), ptr(layer["b"]), ptr(s_out), ptr(out),
            I(int(f32_in)), I(B), I(H), I(W), I(1 if f32_in else cin), I(ho), I(wo), I(cout), I(ks),
            I(st), I(d), I(same_pad(H, ks, st, d)[0]), I(same_pad(W, ks, st, d)[0]), stream()),
            "parent qconv_layer")
        return out

    def walk(tag, launches=None):
        """bias_correct_qparams' int8 part: the corrected biases and the
        head's pre-activation; ``launches`` collects (name, call) of each
        kernel launch with its inputs."""
        qx, biases = calib, []
        for i, (st, d) in enumerate(specs):
            L_ = q["layers"][i]
            if tag == "parent":
                y = parent_layer(qx, L_, None, st, d)
                fn_y = lambda x=qx, L_=L_, st=st, d=d: parent_layer(x, L_, None, st, d)  # noqa: E731
            else:
                y, acc = qk.qconv_layer_f32(qx, L_, st, d)
                fn_y = lambda x=qx, L_=L_, st=st, d=d: qk.qconv_layer_f32(x, L_, st, d)  # noqa: E731
            b = L_["b"] + torch.mean(pre[i] - y, dim=(0, 1, 2))
            biases.append(b)
            Lb = dict(q=L_["q"], ws=L_["ws"], b=b)
            if tag == "parent":
                nxt = parent_layer(qx, Lb, s_in[i + 1], st, d)
                fn_q = lambda x=qx, Lb=Lb, s=s_in[i + 1], st=st, d=d: parent_layer(x, Lb, s, st, d)  # noqa: E731
            else:
                nxt = qk.requantize(acc, L_["ws"], b, s_in[i + 1])
                fn_q = lambda a=acc, L_=L_, b=b, s=s_in[i + 1]: qk.requantize(a, L_["ws"], b, s)  # noqa: E731
            if launches is not None:
                launches += [(f"layer{i}", fn_y), (f"requant{i}", fn_q)]
            qx = nxt
        H_ = q["head"]
        if tag == "parent":
            y = parent_layer(qx, H_, None, 1, 1)
            fn_h = lambda x=qx: parent_layer(x, H_, None, 1, 1)  # noqa: E731
        else:
            y = qk.qconv_layer_f32(qx, H_, 1, 1, with_acc=False)[0]
            fn_h = lambda x=qx: qk.qconv_layer_f32(x, H_, 1, 1, with_acc=False)  # noqa: E731
        if launches is not None:
            launches.append(("head", fn_h))
        return biases, y

    with torch.inference_mode():
        got = {tag: walk(tag) for tag in ("parent", "change")}
        torch.cuda.synchronize()
        for (bp, bc) in zip(got["parent"][0], got["change"][0]):
            if not torch.equal(bp, bc):
                raise AssertionError("bias walk: the corrected biases differ between the trees")
        if not torch.equal(got["parent"][1], got["change"][1]):
            raise AssertionError("bias walk: the head's pre-activations differ between the trees")
        res["bias_walk_identical"] = True
        per = {}
        for tag in ("parent", "change"):
            per[tag] = []
            walk(tag, per[tag])
        res["bias_walk_launches"] = {t: len(v) for t, v in per.items()}
        for turn in ("parent", "change", "change", "parent"):
            key = f"bias_walk_{turn}"
            res.setdefault(key, []).append(time_ms(lambda: walk(turn), iters=5, reps=3))
            res.setdefault(key + "_device", []).append(device_ms(lambda: walk(turn), n=5))
            res.setdefault(key + "_per_launch_device", []).append(
                {name: device_ms(fn, n=5) for name, fn in per[turn]})
        print(json.dumps({k: v for k, v in res.items() if k.startswith("bias_walk")}), flush=True)
    calibration_ab(args, calib_np, res)


# --- the tall rect instance ---------------------------------------------------

# clock64 stamps at the parent's one-component steps (a copy of its
# rect_kernel.cu built with them): the anchor each stamp goes before
_PARENT_STAMPS = (
    (0, "  // 1. compact the valid rows; the horizontal candidate's extents"),
    (1, "  // 2. convexify both chains."),
    (2, "  if (kExact && (s_moving[0] || s_moving[1])) {"),
    (3, "  if (warp < 2 && has) {\n    const int* xs = warp == 0 ? r_l : r_r;\n    const unsigned* al"),
    (4, "  // 3. the directions: d = e on the left chain"),
    (5, "  // 4. selection by block reductions:"),
    (6, "  const int b = comp / K;\n  const int k = comp - b * K;\n  float* o ="),
)
PARENT_STEPS = ("compact rows", "lockstep rounds", "slope rule", "pack points",
                "directions + projections", "selection")
CHANGE_STEPS = ("A rows", "R first round", "B hull merges", "C kept points", "D directions",
                "E projections", "F selection")
_STAMP_DEFS = """
__device__ long long g_rect_stamps[1 << 16];
extern "C" int rect_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_rect_stamps, sizeof(long long) * n));
}
extern "C" int rect_stamps_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_rect_stamps);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_rect_stamps)));
}
#define RECT_STAMP(k) if (threadIdx.x == 0) g_rect_stamps[comp * 8 + (k)] = clock64()
"""


def _stamped_parent(csrc: Path) -> Path:
    """The parent's rect_kernel.cu with clock64 stamps between its steps."""
    src = (csrc / "rect_kernel.cu").read_text()
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + _STAMP_DEFS, 1)
    for k, anchor in _PARENT_STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor {k} not found once in the parent's rect_kernel.cu")
        src = src.replace(anchor, f"  RECT_STAMP({k});\n" + anchor)
    out = REPO / "build" / "ab" / "stamped-parent"
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    (out / "rect_kernel.cu").write_text(src)
    return out


def tall_ab(args, dev, res: dict) -> None:
    """The tall rect instance, parent against change (module docstring)."""
    from chip_smoke import round_extremes, synthetic_extremes

    libs = {"parent": build(args.parent / "ubdvss_tpu_torch" / "csrc", "parentR", ("rect_kernel",)),
            "change": build(REPO / "ubdvss_tpu_torch" / "csrc", "changeR", ("rect_kernel",))}
    variants = [v.name for v in args.variants]
    for v in args.variants:
        libs[v.name] = build(v / "ubdvss_tpu_torch" / "csrc", v.name + "R", ("rect_kernel",))
    stamp_libs = {
        "parent": build(_stamped_parent(args.parent / "ubdvss_tpu_torch" / "csrc"), "parentS",
                        ("rect_kernel",)),
        "change": build(REPO / "ubdvss_tpu_torch" / "csrc", "changeS", ("rect_kernel",),
                        extra=("-DRECT_TALL_STAMPS",)),
    }
    # the 8192x1024 page's extremes (the asset's config, K=64), as detect gives them
    asset = REPO / "assets" / "pretrained_synthetic.npz"
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(asset)).items()}
    cfg = load_net_config(asset)
    page = SyntheticMarkupReader(n_samples=1, image_hw=(8192, 1024), seed=8,
                                 n_objects=(3, 6)).sample_at(0).image
    with torch.inference_mode(), exact_f32():
        lg = fused_model_apply(params, torch.from_numpy(page).to(dev).float()[None, ..., None],
                               cfg, raw_gray=True)
        lab = ccl_kernel.ccl_labels_tiled(lg[..., 0].contiguous())
        g = postproc_kernel.component_slots_tiled(lg, lab, cfg.max_components)
    cases = {"page_8192x1024_B1_K64_H2048": (g["minx"], g["maxx"])}
    for H in (2048, 4096):
        for B in (1, 3):
            cases[f"staircase_B{B}_H{H}"] = synthetic_extremes(B, 16, H, H + B)
            cases[f"round_B{B}_H{H}"] = round_extremes(B, 16, H, H + B)
    cases = {k: (mn.to(dev).contiguous(), mx.to(dev).contiguous()) for k, (mn, mx) in cases.items()}
    outs, wss = {}, {}

    def call(lib, tag, name):
        mn, mx = cases[name]
        B, K, H = mn.shape
        out = outs.setdefault((tag, name), torch.empty((B, 9, K), device=dev))
        slots = B * K
        if tag == "parent":  # the parent's workspace: 116 B a row a persistent block
            ws = wss.setdefault((tag, name), torch.empty(slots * ((29 * 4 * H + 15) // 16 * 16),
                                                         dtype=torch.uint8, device=dev))
        else:
            ws = None
        check(lib.rect_select_exact_tall(P(mn.data_ptr()), P(mx.data_ptr()), P(out.data_ptr()),
                                         P(None if ws is None else ws.data_ptr()), I(B), I(K),
                                         I(H), I(slots), stream()), f"{tag} {name}")
        return out

    for name in cases:
        a = call(libs["parent"]["rect_kernel"], "parent", name).clone()
        b = call(libs["change"]["rect_kernel"], "change", name).clone()
        if not torch.equal(a, b):
            raise AssertionError(f"tall rect {name}: rows differ between the trees")
        for v in variants:
            if not torch.equal(call(libs[v]["rect_kernel"], v, name), b):
                raise AssertionError(f"tall rect {name}: variant {v}'s rows differ from the change's")
    res["tall_rows_identical"] = True
    for turn in ("parent", "change", "change", "parent"):
        for tag in [turn] + (variants if turn == "change" else []):
            lib = libs[tag]["rect_kernel"]
            for name in cases:
                key = f"tall_{name}_{tag}"
                res.setdefault(key, []).append(time_ms(lambda: call(lib, tag, name)))
                res.setdefault(key + "_device", []).append(device_ms(lambda: call(lib, tag, name)))
    # the steps' split: clock64 stamps by each component's thread 0 (block
    # 0 of its cluster in the change), the component with the most cycles
    for tag, steps in (("parent", PARENT_STEPS), ("change", CHANGE_STEPS)):
        lib = stamp_libs[tag]["rect_kernel"]
        lib.rect_stamps.argtypes = [P, I]
        for name in cases:
            mn, _ = cases[name]
            n_comp = mn.shape[0] * mn.shape[1]
            check(lib.rect_stamps_clear(), f"{tag} stamps")
            call(lib, tag, name)
            torch.cuda.synchronize()
            width = 8 if tag == "parent" else 16  # the change: then rows, merged chains
            host = np.zeros(n_comp * width, np.int64)
            check(lib.rect_stamps(P(host.ctypes.data), I(host.size)), f"{tag} stamps")
            full = host.reshape(n_comp, width)
            st = full[:, : len(steps) + 1]
            span = np.where((st > 0).all(1), st[:, -1] - st[:, 0], -1)  # an empty slot stops early
            worst = int(np.argmax(span))
            entry = {"component": worst, "cycles": int(span[worst]),
                     "split": {s: int(st[worst, i + 1] - st[worst, i]) for i, s in enumerate(steps)}}
            if tag == "change":  # every non-empty component: rows, merged chains (bits), cycles
                entry["components"] = [[int(full[i, 8]), int(full[i, 9]), int(span[i])]
                                       for i in range(n_comp) if span[i] > 0]
            res[f"tall_steps_{name}_{tag}"] = entry
    print(json.dumps({k: v for k, v in res.items() if k.startswith("tall")}), flush=True)


TILED_SOURCES = ("ccl_kernel", "postproc_kernel", "geometry_kernel")


def _pr11_slots_scratch(B, H, W, K, C, dev):
    """PR 11's tiled-slots geometry and scratch (``_tiled_pass_warps``,
    SLOTS_CHUNK 8192, SLOTS_TILE_ROWS 32)."""
    nw = min(8, -(-W // 32), (postproc_kernel.MAX_SHARED_BYTES - K * 4) // (K * (C + 1) * 4))
    tiles = -(-W // (32 * nw)) * -(-H // 32)
    return nw, {"counts": torch.empty((B, -(-(H * W) // 8192)), dtype=torch.int32, device=dev),
                "tpart": torch.empty((B, tiles, K, C), dtype=torch.float32, device=dev),
                "tcnt": torch.empty((B, tiles, K), dtype=torch.int32, device=dev)}


class Pr11Tiled:
    """The tiled kernels through PR 11's C signatures (the parent of the
    tiled redesign): ccl_labels_tiled, component_slots_tiled(..., counts,
    tpart, tcnt, B, H, W, K, threads, chunk, tile_rows, thr) and
    geometry_compat_large(..., labels, counts, tpart, tcnt, B, H, W, K, nw,
    chunk, tile_rows, thr, connectivity)."""

    def __init__(self, libs, lg, K, dev):
        self.libs, self.lg, self.K = libs, lg, K
        B, H, W, C = lg.shape
        self.sfx = ccl_kernel.LOGIT_DTYPES[lg.dtype]
        self.det = lg[..., 0].contiguous()
        self.labels = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        self.nw, self.scratch = _pr11_slots_scratch(B, H, W, K, C, dev)
        self.work = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        self.out = {k: postproc_kernel._empty_outputs(B, H, W, K, C, dev) for k in ("pair", "large")}
        self.thr = ccl_kernel.threshold_logit(0.5)

    def ccl(self, conn=8):
        d = self.det
        check(getattr(self.libs["ccl_kernel"], "ccl_labels_tiled" + self.sfx)(
            P(d.data_ptr()), P(self.labels.data_ptr()), *(I(n) for n in d.shape), F(self.thr),
            I(conn), stream()), "ccl_labels_tiled")
        return self.labels

    def slots(self):
        lg, o, s = self.lg, self.out["pair"], self.scratch
        B, H, W, C = lg.shape
        check(getattr(self.libs["postproc_kernel"], "component_slots_tiled" + self.sfx)(
            P(lg.data_ptr()), *(L(x) for x in lg.stride()), I(C), P(self.labels.data_ptr()),
            *(P(t.data_ptr()) for t in o.values()), *(P(t.data_ptr()) for t in s.values()),
            I(B), I(H), I(W), I(self.K), I(32 * self.nw), I(8192), I(32), F(self.thr), stream()),
            "component_slots_tiled")
        return o

    def large(self, conn=8):
        lg, o, s = self.lg, self.out["large"], self.scratch
        B, H, W, C = lg.shape
        check(getattr(self.libs["geometry_kernel"], "geometry_compat_large" + self.sfx)(
            P(lg.data_ptr()), *(L(x) for x in lg.stride()), I(C),
            *(P(t.data_ptr()) for t in o.values()), P(self.work.data_ptr()),
            *(P(t.data_ptr()) for t in s.values()), I(B), I(H), I(W), I(self.K), I(self.nw),
            I(8192), I(32), F(self.thr), I(conn), stream()), "geometry_compat_large")
        return o


class ChangeTiled(Pr11Tiled):
    """The tiled kernels through this tree's C signatures, at
    ``postproc_kernel.tiled_plan``'s geometry (the plan's ints, then the
    scratch of ``tiled_scratch``), as the wrappers call them."""

    def __init__(self, libs, lg, K, dev):
        super().__init__(libs, lg, K, dev)
        B, H, W, C = lg.shape
        self.plan = postproc_kernel.tiled_plan(B, H, W, K, C)
        self.ccl_plan = postproc_kernel.tiled_plan(B, H, W, 1, 1)
        self.scratch = postproc_kernel.tiled_scratch(self.plan, dev)

    def ccl(self, conn=8):
        arr = self.ccl_plan.ints
        check(getattr(self.libs["ccl_kernel"], "ccl_labels_tiled" + self.sfx)(
            P(self.det.data_ptr()), P(self.labels.data_ptr()), P(arr.ctypes.data), I(arr.size),
            F(self.thr), I(conn), stream()), "ccl_labels_tiled")
        return self.labels

    def slots(self):
        lg, o, arr = self.lg, self.out["pair"], self.plan.ints
        check(getattr(self.libs["postproc_kernel"], "component_slots_tiled" + self.sfx)(
            P(lg.data_ptr()), *(L(x) for x in lg.stride()), P(self.labels.data_ptr()),
            *(P(t.data_ptr()) for t in o.values()), *(P(t.data_ptr()) for t in self.scratch.values()),
            P(arr.ctypes.data), I(arr.size), F(self.thr), stream()), "component_slots_tiled")
        return o

    def large(self, conn=8):
        lg, o, arr = self.lg, self.out["large"], self.plan.ints
        check(getattr(self.libs["geometry_kernel"], "geometry_compat_large" + self.sfx)(
            P(lg.data_ptr()), *(L(x) for x in lg.stride()), *(P(t.data_ptr()) for t in o.values()),
            P(self.work.data_ptr()), *(P(t.data_ptr()) for t in self.scratch.values()),
            P(arr.ctypes.data), I(arr.size), F(self.thr), I(conn), stream()), "geometry_compat_large")
        return o


def tiled_ab(args, dev, res: dict) -> None:
    """The tiled CCL, the tiled slots and the large K12c, parent against
    change (module docstring)."""
    from chip_smoke import bf16_cls_slack, exact_stats, phase_split

    libs = {"parent": build(args.parent / "ubdvss_tpu_torch" / "csrc", "parentT", TILED_SOURCES),
            "change": build(REPO / "ubdvss_tpu_torch" / "csrc", "changeT", TILED_SOURCES)}
    asset = REPO / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(asset)
    K = cfg.max_components
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(asset)).items()}
    params16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    cfg16 = cfg.replace(dtype="bfloat16")

    def image(n, hw, seed, **kw):
        reader = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed, **kw)
        return torch.from_numpy(np.stack([reader.sample_at(i).image for i in range(n)])).to(dev)

    images = {"scans_B8_512": image(8, (2048, 2048), 11), "scan_B1_1024": image(1, (4096, 4096), 11),
              "a4_B1_1754x1240": image(1, (7016, 4960), 7, n_objects=(3, 6))}
    res["tiled_K"] = K
    for name, imgs in images.items():
        for dtype in ("f32", "bf16"):
            case = f"{name}_{dtype}"
            with torch.inference_mode():
                if dtype == "f32":
                    with exact_f32():
                        lg = fused_model_apply(params, imgs.float()[..., None], cfg, raw_gray=True)
                else:
                    lg = fused_model_apply(params16, imgs.to(torch.bfloat16)[..., None], cfg16,
                                           raw_gray=True, act_out=True)
            B, H, W, C = lg.shape
            trees = {"parent": Pr11Tiled(libs["parent"], lg, K, dev),
                     "change": ChangeTiled(libs["change"], lg, K, dev)}
            # outputs first: labels and slot outputs identical between the
            # trees, each tree's stats within 2e-6 of the f64 sums, each
            # tree's large K12c bit for bit its pair
            got = {}
            for tag, t in trees.items():
                lab = t.ccl().clone()
                pair = {k: v.clone() for k, v in t.slots().items()}
                large = t.large()
                torch.cuda.synchronize()
                for key in pair:
                    if not torch.equal(large[key], pair[key]):
                        raise AssertionError(f"{case} {tag}: the large K12c's {key} differs from its pair")
                exact = exact_stats(lg, pair["slots"], K)
                area = pair["areas"].clamp(min=1).double()
                slack = 0.0
                if lg.dtype == torch.bfloat16:
                    slack = bf16_cls_slack(lg, pair["slots"], K).double() / area[..., None]
                err_det = float((pair["det_sums"] / area - exact["det_sums"] / area).abs().max())
                err_cls = (pair["cls_sums"] / area[..., None] - exact["cls_sums"] / area[..., None]).abs()
                if not (err_det <= 2e-6 and bool((err_cls <= 2e-6 + slack).all())):
                    raise AssertionError(f"{case} {tag}: stats means {err_det}, {float(err_cls.max())} "
                                         "past 2e-6 of the f64 sums")
                res[f"{case}_{tag}_stats_err"] = [err_det, float(err_cls.max())]
                got[tag] = (lab, pair)
            if not torch.equal(got["parent"][0], got["change"][0]):
                raise AssertionError(f"{case}: labels differ between the trees")
            for key in ("rootvals", "slots", "minx", "maxx", "num_components_total", "areas"):
                if not torch.equal(got["parent"][1][key], got["change"][1][key]):
                    raise AssertionError(f"{case}: slot output {key} differs between the trees")
            res[f"{case}_shape"] = [B, H, W, C]
            res[f"{case}_nroots"] = got["change"][1]["num_components_total"].tolist()
            calls = {"ccl_tiled": lambda t: t.ccl(), "slots_tiled": lambda t: t.slots(),
                     "geometry_compat_large": lambda t: t.large()}
            for turn in ("parent", "change", "change", "parent"):
                t = trees[turn]
                for kname, fn in calls.items():
                    key = f"{case}_{kname}_{turn}"
                    res.setdefault(key, []).append(time_ms(lambda: fn(t)))
                    split = phase_split(lambda: fn(t))
                    res.setdefault(key + "_device", []).append(sum(s["ms"] for s in split.values()))
                    res.setdefault(key + "_launches", []).append(split)
            log_case = {k: v for k, v in res.items() if k.startswith(case) and not k.endswith("_launches")}
            print(json.dumps(log_case), flush=True)


# --- K4's exact instance: its SASS and its phases -----------------------------

# clock64 stamps at the phases of the register kernel that ran the exact
# widths before context_exact_kernel, context_layer_kernel<C, false> (a copy
# of that parent's context_kernel.cu built with -DCONTEXT_STAMPS): the anchor
# each goes before
_PARENT_K4_STAMPS = (
    ("  long long t_stamp = clock64();\n",
     "  // depthwise: taps in the reference order (ty, tx) = (-1,-1) ... (1,1)\n  float acc[C];\n"),
    ("  CONTEXT_STAMP(0);\n", "  // pointwise + bias + ReLU\n  float act[C];\n"),
    ("  CONTEXT_STAMP(1);\n",
     "  float* ob = out + static_cast<long long>(b) * (with_head ? O : C) * HW + p;\n  if (!with_head) {\n"),
    ("    CONTEXT_STAMP(2);\n", "    return;\n  }\n  long long os = HW;  // between output channels\n"),
    ("  CONTEXT_STAMP(2);\n", "    ob[o * os] = s + s_hb[o];\n  }\n}\n"),
)
# the stamp definitions of this tree's context_kernel.cu, for the parent's copy
_K4_STAMP_DEFS_BEGIN, _K4_STAMP_DEFS_END = "#ifdef CONTEXT_STAMPS\n", "#define CONTEXT_STAMP(k)\n#endif\n"


def _stamped_parent_k4(csrc: Path) -> Path:
    """The parent's context_kernel.cu with this tree's CONTEXT_STAMPS
    definitions and a stamp between the phases of its register kernel."""
    mine = (REPO / "ubdvss_tpu_torch" / "csrc" / "context_kernel.cu").read_text()
    i = mine.index(_K4_STAMP_DEFS_BEGIN)
    defs = mine[i:mine.index(_K4_STAMP_DEFS_END, i) + len(_K4_STAMP_DEFS_END)]
    src = (csrc / "context_kernel.cu").read_text()
    src = src.replace('#include "common.cuh"\n', '#include "common.cuh"\n' + defs, 1)
    for stamp, anchor in _PARENT_K4_STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor {anchor!r} not found once in the parent's context_kernel.cu")
        at = src.index(anchor)
        if stamp.strip().startswith("CONTEXT_STAMP(2)") and anchor.endswith("}\n}\n"):
            at += len(anchor) - 2  # the head's stamp goes after its loop, before the closing brace
        src = src[:at] + stamp + src[at:]
    out = REPO / "build" / "ab" / "stamped-parent-k4"
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    (out / "context_kernel.cu").write_text(src)
    return out


# clock64 stamps at the steps of the parent's two-block K2 and K12c (a copy
# of its postproc_kernel.cu and geometry_kernel.cu patched at these
# anchors, with this tree's SLOTS_STAMPS definitions): (anchor, stamp,
# before or after the anchor)
_PARENT_SLOT_STAMPS = (
    ("  cg::cluster_group cluster = cg::this_cluster();\n", "  SLOT_STAMP_START;\n", "after"),
    ("  geometry::ccl_flatten(lab, p0, p1, N);\n  cluster.sync();\n", "  SLOT_STAMP(0);\n", "after"),
    ("                                         C, sets, thr);\n", "  SLOT_STAMP(1);\n", "after"),
    ("    s.root[k] = k < c0 ? lo_roots[k] : (k - c0 < c1 ? hi_roots[k - c0] : N);\n  }\n"
     "  __syncthreads();\n", "  SLOT_STAMP(1);\n", "after"),
    ("  cluster.sync();\n  if (rank == 0) {\n", "  SLOT_STAMP(2);\n", "before"),
    ("  cluster.sync();  // block 1's shared memory lives until block 0 has read it\n",
     "  SLOT_STAMP(3);\n", "after"),
)
_SLOT_STAMP_DEFS_BEGIN, _SLOT_STAMP_DEFS_END = "#ifdef SLOTS_STAMPS\n", "#define SLOT_STAMP_START\n#endif\n"


def _stamped_parent_slots(csrc: Path) -> Path:
    """The parent's postproc_kernel.cu and geometry_kernel.cu with this
    tree's SLOTS_STAMPS definitions and a stamp after the roots, after the
    pixel pass and after the finish of its cluster K2 and K12c, and after
    K12c's CCL (an anchor matches once in a file or not at all: K2's file
    takes four, K12c's five)."""
    mine = (REPO / "ubdvss_tpu_torch" / "csrc" / "geometry.cuh").read_text()
    i = mine.index(_SLOT_STAMP_DEFS_BEGIN)
    defs = mine[i:mine.index(_SLOT_STAMP_DEFS_END, i) + len(_SLOT_STAMP_DEFS_END)]
    out = REPO / "build" / "ab" / "stamped-parent-slots"
    out.mkdir(parents=True, exist_ok=True)
    for f in csrc.glob("*.cuh"):
        (out / f.name).write_text(f.read_text())
    for name in ("postproc_kernel", "geometry_kernel"):
        src = (csrc / f"{name}.cu").read_text()
        src = src.replace('#include "tiled.cuh"\n',
                          '#include "tiled.cuh"\n\nnamespace geometry {\n' + defs + '}  // namespace geometry\n', 1)
        hits = 0
        for anchor, stamp, where in _PARENT_SLOT_STAMPS:
            n = src.count(anchor)
            if n > 1:
                raise RuntimeError(f"stamp anchor {anchor!r} found {n} times in the parent's {name}.cu")
            if n:
                hits += 1
                src = src.replace(anchor, anchor + stamp if where == "after" else stamp + anchor)
        want = 4 if name == "postproc_kernel" else 5
        if hits != want:
            raise RuntimeError(f"the parent's {name}.cu: {hits} of its {want} stamp anchors found")
        (out / f"{name}.cu").write_text(src)
    return out


def sass_counts(so: Path, keep) -> dict:
    """Static SASS counts of the kernels of a library whose demangled name
    ``keep`` accepts (``cuobjdump -sass``): {kernel: {"all": {opcode:
    count}, "phases": [{opcode: count}, ...]}}, an opcode with its width
    suffix (LDS, LDS.64, LDS.128, LDG.E.128 -> LDG.128) but no other
    modifier; ``phases`` splits the instructions at each read of the
    clock (a stamped build's phases)."""
    import re
    from collections import Counter

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    funcs: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*)", line)
        if m and cur is not None:
            cur.append((m.group(1), m.group(2)))
    names = list(funcs)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        plain = names
    out = {}
    for raw, dm in zip(names, plain):
        dm = dm.replace("(anonymous namespace)::", "").replace("void ", "")
        dm = dm[:dm.find(">(") + 1] if ">(" in dm else dm.split("(")[0]
        if not keep(dm):
            continue
        phases, allc = [Counter()], Counter()
        for op, rest in funcs[raw]:
            base = op.split(".")[0]
            width = next((w for w in ("64", "128", "U8", "S8", "U16", "S16") if f".{w}" in op), None)
            key = f"{base}.{width}" if width in ("64", "128") else base
            if base == "CS2R" and "SR_CLOCK" in rest:
                phases.append(Counter())
            phases[-1][key] += 1
            allc[key] += 1
        out[dm] = {"all": dict(allc), "phases": [dict(c) for c in phases]}
    return out


def _tree_module(tree: Path, name: str):
    """``ubdvss_tpu_torch/ops/cuda/<name>.py`` of another tree, loaded under
    a name of its own (its imports resolve to this tree's package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"ab_{tree.name}_{name}", tree / "ubdvss_tpu_torch" / "ops" / "cuda" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


class StatsTree:
    """One tree's stats kernels through its C entry points, as the wrappers
    call them (``stats_warps``' virtual warps and, for a tree whose cluster
    kernels take one, the slot plan ``plan``; ``tiled_plan`` and its
    scratch), on one set of logits (phase-major with ``phases``) and its
    labels: the cluster K2, K12c, the tiled K2 and the large K12c."""

    def __init__(self, libs, lg, lab, K, phases, dev, plan=None):
        pk = postproc_kernel
        self.libs, self.lg, self.lab, self.K, self.phases = libs, lg, lab, K, phases
        B, H, W, C = self.shape = pk.unpacked_shape(lg, phases)
        self.thr = ccl_kernel.threshold_logit(0.5)
        self.threads = 32 * pk.stats_warps(H, W, K, C)
        self.slot_plan = plan
        self.plan = pk.tiled_plan(B, H, W, K, C)
        self.scratch = pk.tiled_scratch(self.plan, dev)
        self.work = torch.empty((B, H, W), dtype=torch.int32, device=dev)
        self.out = {k: pk._empty_outputs(B, H, W, K, C, dev) for k in ("k2", "k12c", "tiled", "large")}

    def _fn(self, lib, name):
        fn, strides = postproc_kernel._strides(self.lg, self.shape[3], self.phases, name)
        return getattr(self.libs[lib], fn), (P(self.lg.data_ptr()), *(L(x) for x in strides))

    def k2(self):
        fn, head = self._fn("postproc_kernel", "component_slots")
        o, (B, H, W, C) = self.out["k2"], self.shape
        check(fn(*head, I(C), P(self.lab.data_ptr()), *(P(t.data_ptr()) for t in o.values()), I(B),
                 I(H), I(W), I(self.K), *plan_args(self.slot_plan, self.threads), F(self.thr),
                 stream()), f"component_slots (plan {self.slot_plan})")
        return o

    def k12c(self):
        fn, head = self._fn("geometry_kernel", "geometry_compat")
        o, (B, H, W, C) = self.out["k12c"], self.shape
        check(fn(*head, I(C), *(P(t.data_ptr()) for t in o.values()), I(B), I(H), I(W), I(self.K),
                 *plan_args(self.slot_plan, self.threads), F(self.thr), I(8), stream()),
              f"geometry_compat (plan {self.slot_plan})")
        return o

    def tiled(self):
        fn, head = self._fn("postproc_kernel", "component_slots_tiled")
        o, arr = self.out["tiled"], self.plan.ints
        check(fn(*head, P(self.lab.data_ptr()), *(P(t.data_ptr()) for t in o.values()),
                 *(P(t.data_ptr()) for t in self.scratch.values()), P(arr.ctypes.data), I(arr.size),
                 F(self.thr), stream()), "component_slots_tiled")
        return o

    def large(self):
        fn, head = self._fn("geometry_kernel", "geometry_compat_large")
        o, arr = self.out["large"], self.plan.ints
        check(fn(*head, *(P(t.data_ptr()) for t in o.values()), P(self.work.data_ptr()),
                 *(P(t.data_ptr()) for t in self.scratch.values()), P(arr.ctypes.data), I(arr.size),
                 F(self.thr), I(8), stream()), "geometry_compat_large")
        return o


def widths_ab(args, dev, res: dict) -> None:
    """The any-width kernels, parent against change (module docstring)."""
    from chip_smoke import (INT8_OPS, SEED, bf16_cls_slack, bound, carry_flat, exact_stats,
                            k4_byte_floor, phase_split, queued_ms, stats_bound, width_configs)

    from ubdvss_tpu_torch.ops.cuda import context_kernel as ck
    from ubdvss_tpu_torch.ops.cuda import qconv_kernel as qk
    from ubdvss_tpu_torch.ops.quant import quantize_trunk

    need = {"exact": ("context_kernel",), "narrow": ("context_kernel",), "wide": ("context_kernel",),
            "stats": ("postproc_kernel", "geometry_kernel"), "int8": ("qconv_kernel", "qstem_kernel")}
    srcs = tuple(dict.fromkeys(n for part in args.parts for n in need[part]))
    csrc = REPO / "ubdvss_tpu_torch" / "csrc"
    trees = [(args.parent / "ubdvss_tpu_torch" / "csrc", "parent", srcs, ()), (csrc, "change", srcs, ())]
    trees += [(v / "ubdvss_tpu_torch" / "csrc", v.name, tuple(n for n in srcs if n != "qconv_kernel"), ())
              for v in args.variants]
    ptxas: dict = {}
    # the stats' steps by clock64() stamps: the change's cluster kernels
    # built with -DSLOTS_STAMPS
    slot_srcs = ("postproc_kernel", "geometry_kernel")
    stamp_tree = [(csrc, "changeS", slot_srcs, ("-DSLOTS_STAMPS",))]
    if "stats" in args.parts and not takes_plan(args.parent):
        stamp_tree.append((_stamped_parent_slots(args.parent / "ubdvss_tpu_torch" / "csrc"), "parentS",
                           slot_srcs, ("-DSLOTS_STAMPS",)))
    t_build = time.perf_counter()
    built = build_trees(trees + (stamp_tree if "stats" in args.parts else []), ptxas)
    res["build_s"] = time.perf_counter() - t_build
    print(json.dumps({"build_s": res["build_s"]}), flush=True)
    stamped_slots = {"change": built.pop("changeS", None), "parent": built.pop("parentS", None)}
    ptxas.pop("changeS", None)
    ptxas.pop("parentS", None)
    libs = {tag: built[tag] for tag in built}
    # with --variants, the stem's phase cycles: the change's and each
    # variant's qstem_kernel.cu built with -DQSTEM_STAMPS
    stamped = build_trees([(c, f"{tag}S", ("qstem_kernel",), ("-DQSTEM_STAMPS",))
                           for c, tag, *_ in trees if tag != "parent"]) \
        if "int8" in args.parts and args.variants else {}
    res["ptxas"] = {tag: {k: v for k, v in rep.items() if any(
        n in k for n in ("context_layer", "context_exact", "slots_kernel", "slots_band_kernel", "pass_kernel",
                         "geometry_kernel", "geometry_band_kernel",
                         "geometry_large_kernel", "qstem", "qlayer0", "qconv_any"))}
                    for tag, rep in ptxas.items()}
    print(json.dumps({"ptxas": res["ptxas"]}), flush=True)
    variants = [v.name for v in args.variants]  # other K4 and stats sources of the change
    parent_qk = _tree_module(args.parent, "qconv_kernel")
    if tuple(parent_qk.PLAN_FIELDS) != qk.PLAN_FIELDS:
        raise RuntimeError("the parent's struct Plan differs from this tree's")
    plans = {"parent": parent_qk.tile_plan, "change": qk.tile_plan}
    plans.update({v.name: _tree_module(v, "qconv_kernel").tile_plan for v in args.variants})
    # the compiled stem and layer-0 instances' plans (up to 32 channels) are
    # the parent's, int for int
    n_plans = 0
    for B_, H_, W_ in ((64, 512, 512), (8, 2048, 2048), (1, 240, 320), (2, 75, 101)):
        for kind in (qk.IN_U8_RAW, qk.IN_F32_RAW, qk.IN_F32_NORM):
            for c0 in range(4, 33, 4):
                for c1 in range(4, 33, 4):
                    a, b = (plans[t]("stem", B_, H_, W_, 1, c1, c0=c0, in_kind=kind).ints
                            for t in ("parent", "change"))
                    if not np.array_equal(a, b):
                        raise AssertionError(f"stem plan {B_}x{H_}x{W_} {c0}->{c1}: ints differ")
                    n_plans += 1
            for c in range(1, 33):
                a, b = (plans[t]("layer0", B_, H_, W_, 1, c, in_kind=kind).ints
                        for t in ("parent", "change"))
                if not np.array_equal(a, b):
                    raise AssertionError(f"layer0 plan {B_}x{H_}x{W_} {c}: ints differ")
                n_plans += 1
    res["compiled_stem_plans_equal_the_parents"] = n_plans
    ptr = lambda t: P(None if t is None else t.data_ptr())  # noqa: E731
    F_ = torch.nn.functional
    turns = ("parent", "change", "change", "parent")
    asset = REPO / "assets" / "pretrained_synthetic.npz"
    reader = SyntheticMarkupReader(n_samples=64, image_hw=(512, 512), seed=SEED)
    imgs = torch.from_numpy(np.stack([reader.sample_at(i).image for i in range(64)])).to(dev)
    scans = torch.from_numpy(np.stack([SyntheticMarkupReader(n_samples=2, image_hw=(2048, 2048),
                                                             seed=11).sample_at(i).image
                                       for i in range(2)])).to(dev)

    def config(C, O=41):
        cfg = NetConfig(max_components=16, max_hull_points=64, channels=C,
                        class_names=tuple(f"sym{i}" for i in range(O - 1)))
        flat = carry_flat(load_params_npz(asset), C, O, SEED)
        return cfg, {k: v.to(dev) for k, v in params_from_flat(flat).items()}

    def timed(case, calls, lib=None, split=True):
        """Each tree's call in turns (CUDA events back to back, CUDA events
        queued behind a sleep: device ms, profiler device ms), the variants
        in the change's turns, the kernels of each tree's first turn by
        launch, the library call once."""
        seen = set()
        for turn in turns:
            for tag in [turn] + ([v for v in variants if v in calls] if turn == "change" else []):
                key = f"{case}_{tag}"
                res.setdefault(key, []).append(time_ms(calls[tag], iters=5, reps=4))
                res.setdefault(key + "_queued", []).append(queued_ms(calls[tag]))
                res.setdefault(key + "_device", []).append(device_ms(calls[tag], n=5))
                if split and tag not in seen:
                    res[key + "_launches"] = phase_split(calls[tag], n=3)
                    seen.add(tag)
        if lib is not None:
            with exact_f32():
                res[f"{case}_library"] = time_ms(lib, iters=3, reps=2)
        log = {k: v for k, v in res.items() if k.startswith(case)}
        print(json.dumps(log), flush=True)

    # ---- K4: the whole call, one launch a layer, the head fused into the last
    # each tree's context_kernel.py: its exact plan, where it has one
    ck_mods = {"parent": _tree_module(args.parent, "context_kernel"), "change": ck}
    ck_mods.update({v.name: _tree_module(v, "context_kernel") for v in args.variants})

    def k4_plans(tag, x, O, dil):
        """The (P, rows, threads) each layer of tree ``tag`` passes to
        context_layer, or None where the tree's entry takes no plan."""
        mod = ck_mods[tag]
        _, C, H, W = x.shape
        if not hasattr(mod, "exact_plan"):
            return None
        if mod.kernel_instance(C, O) != "exact":
            return [(0, 0, 0)] * len(dil)
        return [(p_.pixels, p_.rows, p_.threads) for p_ in (mod.exact_plan(H, W, d) for d in dil)]

    def k4_layer(lib, tag, plans, x, dst, w, li, d, last, packed):
        B, C, H, W = x.shape
        O = w[3].shape[0]
        extra = () if plans is None else tuple(I(v) for v in plans[li])
        check(lib.context_layer(
            ptr(x), ptr(dst), ptr(w[0][li]), ptr(w[1][li]), ptr(w[2][li]),
            ptr(w[3] if last else None), ptr(w[4] if last else None), I(B), I(C), I(H),
            I(W), I(d), I(O), I(int(packed and last)), *extra, stream()), f"{tag} context_layer")

    def k4_calls(x, w, dil, packed):
        B, C, H, W = x.shape
        O, L = w[3].shape[0], len(dil)
        shape = (B, 4 * O, H // 2, W // 2) if packed else (B, O, H, W)
        tags = ("parent", "change", *variants)
        outs = {tag: (torch.empty_like(x), torch.empty_like(x),
                      torch.empty(shape, device=dev)) for tag in tags}
        plans = {tag: k4_plans(tag, x, O, dil) for tag in tags}

        def call(tag):
            cur = x
            for li, d in enumerate(dil):
                last = li == L - 1
                dst = outs[tag][2] if last else outs[tag][li % 2]
                k4_layer(libs[tag]["context_kernel"], tag, plans[tag], cur, dst, w, li, d, last,
                         packed)
                cur = dst
            return outs[tag][2]

        return {tag: (lambda tag=tag: call(tag)) for tag in tags}

    def k4_library(x, w, dil):
        C = x.shape[1]
        for li, d in enumerate(dil):
            x = F_.conv2d(x, w[0][li, :, :, 0, 0].T.reshape(C, 1, 3, 3), None, 1, d, d, C)
            x = torch.relu(F_.conv2d(x, w[1][li][:, :, None, None], w[2][li][:, 0, 0]))
        return F_.conv2d(x, w[3][:, :, None, None], w[4][:, 0, 0])

    def k4_case(case, x, w, dil, packed):
        calls = k4_calls(x, w, dil, packed)
        got = {tag: calls[tag]().clone() for tag in calls}
        torch.cuda.synchronize()
        for v in variants:
            if not torch.equal(got[v], got["change"]):
                raise AssertionError(f"{case}: the variant {v}'s outputs differ from the change's")
        with exact_f32():
            ref = ck.context_head_reference(x, *w, dil)
        if packed:
            ref = ck._s2d_planes(ref)
        err = float((got["change"] - ref).abs().max())
        tol = max(1e-4, 1e-5 * float(ref.abs().max()))
        if not torch.equal(got["parent"], got["change"]):
            raise AssertionError(f"{case}: {int((got['parent'] != got['change']).sum())} outputs "
                                 f"differ from the parent's (max {float((got['parent'] - got['change']).abs().max())})")
        if not err <= tol:
            raise AssertionError(f"{case}: max|err| {err} against the plain version past {tol}")
        B, C, H, W = x.shape
        O, L = w[3].shape[0], len(dil)
        px = B * H * W
        res[f"{case}_shape"] = [B, C, H, W, O, int(packed)]
        res[f"{case}_instance"] = ck.kernel_instance(C, O)
        res[f"{case}_bit_for_bit"] = True
        res[f"{case}_max_abs_err"] = err
        res[f"{case}_bound"] = bound((px * C + px * O) * 4 + sum(t.numel() for t in w) * 4,
                                     px * (L * (9 * C * 2 + C * C * 2 + 2 * C) + O * C * 2))
        res[f"{case}_byte_floor"] = k4_byte_floor(x.shape, O, L, sum(t.numel() for t in w) * 4)
        res[f"{case}_plans"] = {tag: k4_plans(tag, x, O, dil) for tag in ("parent", "change", *variants)}
        timed(case, calls, lambda: k4_library(x, w, dil))

    slot_keys = ["rootvals", "slots", "minx", "maxx", "num_components_total", "areas"]

    def stats_case(case, lg, lab, phases, kinds):
        """The stats kernels ``kinds`` of both trees on one set of logits,
        each tree's cluster kernels at its own plan: where the change's plan
        sums in the parent's order (two blocks an image), the cluster K2 and
        K12c the parent's bit for bit; elsewhere their slot outputs the
        parent's and their means within 2e-6 (and the bf16 slack) of the f64
        sums; K12c == K2 in every tree; the tiled K2 and the large
        K12c with the parent's slot outputs, each tree's means within 2e-6
        (and the bf16 slack) of the f64 sums, the large K12c == the tiled
        pair; each variant's outputs as the change's; then each kind timed
        in turns."""
        tags = ("parent", "change", *variants)
        B, H, W, C = postproc_kernel.unpacked_shape(lg, phases)
        bf16 = lg.dtype == torch.bfloat16
        plans = {tag: card_plan(libs[tag], B, H, W, K, C, bf16) if tag == "change" or takes_plan(
            args.parent if tag == "parent" else next(v for v in args.variants if v.name == tag))
            else None for tag in tags}
        st = {tag: StatsTree(libs[tag], lg, lab, K, phases, dev, plans[tag]) for tag in tags}
        plan = plans["change"]
        same_order = plan.blocks == 2
        got = {tag: {kind: {k: v.clone() for k, v in getattr(t, kind)().items()} for kind in kinds}
               for tag, t in st.items()}
        torch.cuda.synchronize()
        lg_u = lg if phases is None else ck._d2s(lg, C)
        for kind in kinds:
            b_ = got["change"][kind]
            cluster = kind in ("k2", "k12c")
            keys = list(b_) if cluster and same_order else slot_keys
            for tag in ("parent", *variants):
                for key in keys:
                    if not torch.equal(got[tag][kind][key], b_[key]):
                        raise AssertionError(f"{case} {kind}: {key} of {tag} differs from the change's")
            if kind in ("tiled", "large") or not same_order:
                exact = exact_stats(lg_u, b_["slots"], K)
                area = b_["areas"].clamp(min=1).double()
                slack = 0.0
                if lg.dtype == torch.bfloat16:
                    slack = bf16_cls_slack(lg_u, b_["slots"], K).double() / area[..., None]
                for tag in tags:
                    o = got[tag][kind]
                    err_d = float((o["det_sums"] / area - exact["det_sums"] / area).abs().max())
                    err_c = (o["cls_sums"] / area[..., None] - exact["cls_sums"] / area[..., None]).abs()
                    if not (err_d <= 2e-6 and bool((err_c <= 2e-6 + slack).all())):
                        raise AssertionError(f"{case} {kind} {tag}: means {err_d}, "
                                             f"{float(err_c.max())} past 2e-6 of the f64 sums")
                    res[f"{case}_{kind}_{tag}_f64_err"] = [err_d, float(err_c.max())]
        pairs = (("k12c", "k2"), ("large", "tiled"))
        for x_, y_ in pairs:
            if x_ in kinds and y_ in kinds:
                for key in got["change"][y_]:
                    if not torch.equal(got["change"][x_][key], got["change"][y_][key]):
                        raise AssertionError(f"{case}: the change's {x_} {key} differs from its {y_}")
        res[f"{case}_shape"] = [B, H, W, C, str(lg.dtype), phases is not None]
        res[f"{case}_bit_for_bit"] = same_order
        res[f"{case}_plans"] = {tag: None if t.slot_plan is None else dataclasses.asdict(t.slot_plan)
                                for tag, t in st.items()}
        esz = lg.element_size()
        for kind in kinds:
            geo = got["change"][kind]
            res[f"{case}_{kind}_bound"] = stats_bound(lg_u, geo, K, esz, k12=kind in ("k12c", "large"))
            lib = None
            if kind in ("k2", "tiled"):
                lib = lambda geo=geo: postproc_kernel._stats_reference(lg, geo["slots"], K, phases)  # noqa: E731
            timed(f"{case}_{kind}", {tag: (lambda t=t, kind=kind: getattr(t, kind)())
                                     for tag, t in st.items()}, lib)
            if kind in ("k2", "k12c") and stamped_slots["change"] is not None:
                slot_steps(f"{case}_{kind}", {"parent": st["parent"], "change": st["change"]}, kind)

    def slot_steps(name, trees_, kind):
        """Each tree's K2 or K12c at its plan, built with -DSLOTS_STAMPS (the
        parent's patched): one call's cycles by step (K12c's CCL, the roots
        ranked and joined, the pixel pass, the finish, each with the
        cluster barrier after it), a block's mean."""
        for tag, tree in trees_.items():
            if stamped_slots.get(tag) is None:
                continue
            t = StatsTree(stamped_slots[tag], tree.lg, tree.lab, tree.K, tree.phases, dev,
                          tree.slot_plan)
            lib = stamped_slots[tag]["postproc_kernel" if kind == "k2" else "geometry_kernel"]
            lib.slot_cycles.argtypes = [P]
            host = np.zeros(5, np.uint64)
            getattr(t, kind)()
            torch.cuda.synchronize()
            check(lib.slot_cycles_clear(), "slot stamps")
            getattr(t, kind)()
            torch.cuda.synchronize()
            check(lib.slot_cycles(P(host.ctypes.data)), "slot stamps")
            n = max(int(host[4]), 1)
            res[f"{name}_steps_{tag}"] = {"blocks": int(host[4]), "cycles_a_block": {
                step: float(host[i]) / n for i, step in enumerate(("ccl", "roots", "pass", "finish"))}}
            print(json.dumps({f"{name}_steps_{tag}": res[f"{name}_steps_{tag}"]}), flush=True)

    def few_images():
        """The cluster K2 and K12c on few images of the asset's own logits
        (K=16, 17 channels), each case against the parent in turns: the
        packed route's 1024² call (B=4 256², phase-major and unpacked, f32
        and bf16) and B=2 and 8 of its maps, one detect call's heatmap (B=1
        at 128², 120x160, 192x256), then the main path's B=64 128² (f32,
        bf16) and the stream's B=64 60x80."""
        cfg = load_net_config(asset).replace(max_components=K)
        cfg16 = cfg.replace(dtype="bfloat16")
        params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(asset)).items()}
        p16 = {k: v.to(torch.bfloat16) for k, v in params.items()}

        def scenes(n, hw, seed):
            r = SyntheticMarkupReader(n_samples=n, image_hw=hw, seed=seed)
            return torch.from_numpy(np.stack([r.sample_at(i).image for i in range(n)])).to(dev)

        def logits(x, packed=False, bf16=False):
            with exact_f32():
                if bf16:
                    f = ck.packed_fused_trunk if packed else fused_model_apply
                    return f(p16, x.to(torch.bfloat16)[..., None], cfg16, raw_gray=True, act_out=True)
                f = ck.packed_fused_trunk if packed else fused_model_apply
                return f(params, x.float()[..., None], cfg, raw_gray=True)

        def case(name, lg, phases=None):
            if args.stats_cases and not any(c in name for c in args.stats_cases):
                return
            det = postproc_kernel.detection_logits(lg, phases).contiguous()
            stats_case(name, lg, ccl_kernel.ccl_labels_from_logits(det), phases, ("k2", "k12c"))

        s1k = scenes(8, (1024, 1024), 11)
        for tag, bf16 in (("f32", False), ("bf16", True)):
            packed = logits(s1k[:4], packed=True, bf16=bf16)
            case(f"few_{tag}_phase_major_4x256", packed, (2, 2))
            case(f"few_{tag}_4x256", ck._d2s(packed, 17).contiguous())
        case("few_f32_2x256", logits(s1k[:2]))
        case("few_f32_8x256", logits(s1k))
        for hw in ((512, 512), (480, 640), (768, 1024)):
            case(f"few_f32_1x{hw[0] // 4}x{hw[1] // 4}", logits(scenes(1, hw, SEED)))
        case("few_f32_64x128", logits(imgs))
        case("few_bf16_64x128", logits(imgs, bf16=True))
        case("few_f32_64x60x80", logits(scenes(64, (240, 320), SEED)))
        torch.cuda.empty_cache()

    dil = tuple(NetConfig().dilations)
    K = 16
    with torch.inference_mode():
        cfg48, p48 = config(48)
        w48 = ck._pack_weights(p48, dil)
        # ---- K4 at its compiled widths: the asset's weights on the main
        # path's, the scans' and the stream's features; random weights
        if "exact" in args.parts:
            exact_ab(args, dev, res, ck_mods, k4_layer, k4_plans, k4_case, imgs, trees)
            torch.cuda.empty_cache()
        # ---- K4 up to 32 channels: the narrow configuration (C=10, O=17)
        # and random weights
        cfg10, flat10 = width_configs(asset)["narrow"]
        p10 = {k: v.to(dev) for k, v in params_from_flat(flat10).items()}
        w10 = ck._pack_weights(p10, dil)
        with exact_f32():
            x10 = ck.stem_apply(p10, imgs.float()[..., None], cfg10,
                                raw_gray=True).permute(0, 3, 1, 2).contiguous()
            xs10 = ck.stem_apply(p10, scans.float()[..., None], cfg10,
                                 raw_gray=True).permute(0, 3, 1, 2).contiguous()
        if "narrow" in args.parts:
            k4_case("k4_narrow_64x10x128", x10, w10, dil, False)
            k4_case("k4_narrow_packed_2x10x512", xs10, w10, dil, True)
        del x10, xs10
        gen = torch.Generator(device=dev).manual_seed(SEED)
        narrow = [(c, o) for c in (4, 12, 20, 31) for o in (17, 41)] + [(8, 41), (24, 33)]
        for C, O in narrow if "narrow" in args.parts else []:
            L = len(dil)
            x = torch.randn((64, C, 128, 128), generator=gen, device=dev)
            w = [torch.randn(shape, generator=gen, device=dev) * s for s, shape in (
                (0.3, (L, 9, C, 1, 1)), (0.3 / np.sqrt(C / 8), (L, C, C)), (0.1, (L, C, 1, 1)),
                (0.3, (O, C)), (0.1, (O, 1, 1)))]
            k4_case(f"k4_C{C}_O{O}_64x128", x, w, dil, False)
            del x
        torch.cuda.empty_cache()

        # ---- the stats: the wide configuration's logits at each count of
        # --stats-logits, f32 (the NHWC view of K4's planes) and bf16
        # (channels last): the cluster kernels on them and phase-major, the
        # tiled K2 and the large K12c on the 2048² scans' phase-major logits
        for O in args.stats_logits if "stats" in args.parts else ():
            cfgO, pO = (cfg48, p48) if O == 41 else config(48, O)
            cfg16 = cfgO.replace(dtype="bfloat16")
            p16 = {k: v.to(torch.bfloat16) for k, v in pO.items()}
            with exact_f32():
                runs = [("f32", fused_model_apply(pO, imgs.float()[..., None], cfgO, raw_gray=True),
                         ck.packed_fused_trunk(pO, scans.float()[..., None], cfgO, raw_gray=True)),
                        ("bf16", fused_model_apply(p16, imgs.to(torch.bfloat16)[..., None], cfg16,
                                                   raw_gray=True, act_out=True),
                         ck.packed_fused_trunk(p16, scans.to(torch.bfloat16)[..., None], cfg16,
                                               raw_gray=True, act_out=True))]
            for name, lg, sc in runs:
                lab = ccl_kernel.ccl_labels_from_logits(lg[..., 0].contiguous())
                stats_case(f"stats{O}_{name}_64x128", lg, lab, None, ("k2", "k12c"))
                stats_case(f"stats{O}_{name}_phase_major_64x128", ck._s2d(lg).contiguous(), lab,
                           (2, 2), ("k2", "k12c"))
                det = postproc_kernel.detection_logits(sc, (2, 2)).contiguous()
                lab = ccl_kernel.ccl_labels_from_logits(det)
                stats_case(f"stats{O}_{name}_phase_major_2x512", sc, lab, (2, 2), ("tiled", "large"))
            del lg, sc, runs
            torch.cuda.empty_cache()

        if "stats" in args.parts:
            few_images()

        # ---- K4 past 32 channels: the wide configuration and random weights
        with exact_f32():
            x48 = ck.stem_apply(p48, imgs.float()[..., None], cfg48,
                                raw_gray=True).permute(0, 3, 1, 2).contiguous()
            xs = ck.stem_apply(p48, scans.float()[..., None], cfg48,
                               raw_gray=True).permute(0, 3, 1, 2).contiguous()
        if "wide" in args.parts:
            k4_case("k4_wide_64x48x128", x48, w48, dil, False)
            k4_case("k4_wide_packed_2x48x512", xs, w48, dil, True)
        del xs
        for C in (40, 64, 96) if "wide" in args.parts else ():
            L, O = len(dil), 41
            x = torch.randn((64, C, 128, 128), generator=gen, device=dev)
            w = [torch.randn(shape, generator=gen, device=dev) * s for s, shape in (
                (0.3, (L, 9, C, 1, 1)), (0.3 / np.sqrt(C / 8), (L, C, C)), (0.1, (L, C, 1, 1)),
                (0.3, (O, C)), (0.1, (O, 1, 1)))]
            k4_case(f"k4_C{C}_64x128", x, w, dil, False)
            del x
        torch.cuda.empty_cache()

        # ---- int8 at 36, 48 and 64 channels: the stem and layer 0 alone; at
        # 48 and 64 the six qconv, at 48 qconv_head and qconv_layer
        norm = imgs.float() / 127.5 - 1.0  # the bias correction's normalized images
        for C in (36, 48, 64) if "int8" in args.parts else ():
            cfg, params = (cfg48, p48) if C == 48 else config(C)
            calib = (imgs[:8].float() / 127.5 - 1.0)[..., None]
            q = quantize_trunk(params, cfg, calib)
            L8, s8 = q["layers"], q["s_in"]
            arrs = []  # the plans' ints, kept alive while their calls are
            IB, IH, IW = imgs.shape
            H0, W0 = -(-IH // 2), -(-IW // 2)

            tags8 = ("parent", "change", *variants)

            def stem_call(tag, out, lib=None):
                arr = plans[tag]("stem", IB, IH, IW, 1, C, c0=C, in_kind=qk.IN_U8_RAW).ints
                arrs.append(arr)
                fn = (lib or libs[tag]["qstem_kernel"]).qstem_tc
                args_ = (ptr(imgs), ptr(L8[0]["q"]), ptr(L8[0]["ws"]), ptr(L8[0]["b"]), ptr(s8[1]),
                         ptr(L8[1]["q"]), ptr(L8[1]["ws"]), ptr(L8[1]["b"]), ptr(s8[2]), ptr(out),
                         P(arr.ctypes.data), I(arr.size))
                return lambda: check(fn(*args_, stream()), f"{tag} qstem_tc")

            souts = {tag: torch.empty((IB, -(-H0 // 2), -(-W0 // 2), C), dtype=torch.int8, device=dev)
                     for tag in tags8}
            calls = {tag: stem_call(tag, souts[tag]) for tag in souts}
            for c in calls.values():
                c()
            torch.cuda.synchronize()
            ref = qk.qstem_reference(imgs, L8[0], s8[1], L8[1], s8[2], True)
            for tag in souts:
                if not torch.equal(souts[tag], ref):
                    raise AssertionError(f"qstem {C}: the {tag} differs from qstem_reference")
            del ref
            case = f"qstem_any_{C}"
            res[f"{case}_bit_for_bit"] = True
            res[f"{case}_plans"] = {tag: {k: plans[tag]("stem", IB, IH, IW, 1, C, c0=C,
                                                        in_kind=qk.IN_U8_RAW).fields[k]
                                          for k in ("th", "tw", "smem", "stage_bytes", "n_tiles")}
                                    for tag in souts}
            # bytes: the uint8 image in, layer 1's int8 map out (layer 0's f32
            # requantization, most of the non-tensor work, is in neither term)
            px1 = souts["change"].numel() // C
            res[f"{case}_bound"] = bound(imgs.numel() + px1 * C,
                                         2 * 9 * (IB * H0 * W0 * C + px1 * C * C), INT8_OPS)
            xf0 = imgs.float()[:, None]
            w0f = L8[0]["q"].permute(3, 2, 0, 1).float().contiguous()
            w1f = L8[1]["q"].permute(3, 2, 0, 1).float().contiguous()
            z1 = torch.zeros((IB, C, H0, W0), device=dev)
            timed(case, calls, lambda: (F_.conv2d(xf0, w0f, None, 2, 1), F_.conv2d(z1, w1f, None, 2, 1)))
            # the stamped builds: each phase's cycles a tile, summed over the
            # blocks (thread 0's clock between the block's barriers)
            for tag in ("change", *variants) if stamped else ():
                lib = stamped[f"{tag}S"]["qstem_kernel"]
                check(lib.qstem_cycles_clear(), f"{tag} stamps")
                stem_call(tag, souts[tag], lib)()
                torch.cuda.synchronize()
                if not torch.equal(souts[tag], souts["parent"]):
                    raise AssertionError(f"qstem {C}: the stamped {tag} differs")
                cyc = np.zeros(5 * 2048, np.int64)
                check(lib.qstem_cycles(P(cyc.ctypes.data), I(cyc.size)), f"{tag} stamps")
                tot = cyc.reshape(-1, 5).sum(0)
                res[f"{case}_{tag}_cycles_a_tile"] = dict(zip(
                    ("wait", "quantize", "layer0", "layer1"), (tot[:4] / max(tot[4], 1)).tolist()),
                    tiles=int(tot[4]))
                print(json.dumps({f"{case}_{tag}_cycles_a_tile": res[f"{case}_{tag}_cycles_a_tile"]}),
                      flush=True)
            del souts, z1
            # layer 0 alone with its f32 epilogue, y and the accumulator, on
            # the normalized images (the bias correction's launch)
            louts = {tag: (torch.empty((IB, H0, W0, C), device=dev), torch.empty((IB, H0, W0, C), device=dev))
                     for tag in tags8}

            def layer0_call(tag, with_acc=True):
                arr = plans[tag]("layer0", IB, IH, IW, 1, C, in_kind=qk.IN_F32_NORM).ints
                arrs.append(arr)
                fn = libs[tag]["qstem_kernel"].qlayer0_tc
                y_, a_ = louts[tag]
                args_ = (ptr(norm), ptr(L8[0]["q"]), ptr(L8[0]["ws"]), ptr(L8[0]["b"]), ptr(y_),
                         ptr(a_ if with_acc else None), P(arr.ctypes.data), I(arr.size))
                return lambda: check(fn(*args_, stream()), f"{tag} qlayer0_tc")

            calls = {tag: layer0_call(tag) for tag in louts}
            for c in calls.values():
                c()
            torch.cuda.synchronize()
            acc = qk.qconv_acc_reference(norm, L8[0], 2, 1)
            y = qk.requantize_reference(acc, L8[0]["ws"], L8[0]["b"], None)
            for tag in louts:
                if not (torch.equal(louts[tag][0], y) and torch.equal(louts[tag][1], acc)):
                    raise AssertionError(f"qlayer0 {C}: the {tag} differs from its plain version")
            for tag in louts:  # without the accumulator: y alone, the same
                louts[tag][0].zero_()
                layer0_call(tag, with_acc=False)()
            torch.cuda.synchronize()
            for tag in louts:
                if not torch.equal(louts[tag][0], y):
                    raise AssertionError(f"qlayer0 {C} without acc: the {tag} differs")
            del acc, y
            case = f"qlayer0_any_{C}"
            res[f"{case}_bit_for_bit"] = True
            res[f"{case}_bound"] = bound(norm.numel() * 4 + 8 * IB * H0 * W0 * C,
                                         2 * 9 * IB * H0 * W0 * C, INT8_OPS)
            timed(case, calls, lambda: F_.conv2d(xf0, w0f, None, 2, 1))
            del louts, calls
            torch.cuda.empty_cache()
            if C == 36:
                continue

            xq = qk.qstem(imgs, L8[0], s8[1], L8[1], s8[2], raw_gray=True)
            B, H, W = xq.shape[:3]
            ins = []
            for li, d in enumerate(dil[:-1]):
                ins.append((xq, L8[2 + li], s8[3 + li], d))
                xq = qk.qconv(*ins[-1])
            head_in = (xq, L8[1 + len(dil)], s8[2 + len(dil)], dil[-1], q["head"])

            def conv_calls(tag, a, out, head=None, packed=False):
                x_, layer, s_out, d = a
                nh = 0 if head is None else head["q"].shape[-1]
                arr = plans[tag]("conv", B, H, W, C, C, dil=d, nh=nh, packed=packed).ints
                arrs.append(arr)
                hp = (None, None, None) if head is None else (head["q"], head["ws"], head["b"])
                fn = libs[tag]["qconv_kernel"].qconv_tc
                args_ = (ptr(x_), ptr(layer["q"]), ptr(layer["ws"]), ptr(layer["b"]), ptr(s_out),
                         *(ptr(t) for t in hp), ptr(out), P(arr.ctypes.data), I(arr.size))
                return lambda: check(fn(*args_, stream()), f"{tag} qconv_tc")

            outs = {tag: [torch.empty((B, H, W, C), dtype=torch.int8, device=dev) for _ in ins]
                    for tag in ("parent", "change")}
            six = {tag: [conv_calls(tag, a, o) for a, o in zip(ins, outs[tag])]
                   for tag in ("parent", "change")}
            for tag in six:
                for c in six[tag]:
                    c()
            torch.cuda.synchronize()
            for li, a in enumerate(ins):
                ref = qk.qconv_reference(a[0], a[1], a[2], 1, a[3])
                for tag in ("parent", "change"):
                    if not torch.equal(outs[tag][li], ref):
                        raise AssertionError(f"qconv {C} layer {li}: the {tag} differs from "
                                             "qconv_reference")
            case = f"qconv_any_six_{C}"
            res[f"{case}_bit_for_bit"] = True
            res[f"{case}_bound"] = bound(len(ins) * 2 * B * H * W * C, len(ins) * 2 * B * H * W * C * C * 9,
                                         INT8_OPS)

            def conv_lib(a):
                xf = a[0].permute(0, 3, 1, 2).float().contiguous()
                wf = a[1]["q"].permute(3, 2, 0, 1).float().contiguous()
                pad = a[3] if wf.shape[-1] == 3 else 0
                return lambda: F_.conv2d(xf, wf, None, 1, pad, a[3])

            libs6 = [conv_lib(a) for a in ins]
            timed(case, {tag: (lambda tag=tag: [c() for c in six[tag]]) for tag in six},
                  lambda: [c() for c in libs6])
            if C != 48:
                continue
            # qconv_head any (unpacked and packed) and the calibration's qconv_layer any
            nh = q["head"]["q"].shape[-1]
            for packed in (False, True):
                shape = (B, H // 2, W // 2, 4 * nh) if packed else (B, H, W, nh)
                houts = {tag: torch.empty(shape, device=dev) for tag in ("parent", "change")}
                calls = {tag: conv_calls(tag, head_in[:4], houts[tag], head_in[4], packed)
                         for tag in houts}
                for c in calls.values():
                    c()
                torch.cuda.synchronize()
                ref = qk.qconv_head_reference(*head_in, packed=packed)
                for tag in houts:
                    if not torch.equal(houts[tag], ref):
                        raise AssertionError(f"qconv_head {C} packed={packed}: the {tag} differs "
                                             "from its plain version")
                case = f"qconv_head_any_{C}" + ("_packed" if packed else "")
                res[f"{case}_bit_for_bit"] = True
                hlib = [conv_lib(head_in[:4]),
                        conv_lib((xq, q["head"], None, 1))]
                timed(case, calls, lambda: [c() for c in hlib])
            xa, La, _, da = ins[1]
            ys = {tag: (torch.empty((B, H, W, C), device=dev), torch.empty((B, H, W, C), device=dev))
                  for tag in ("parent", "change")}

            def layer_call(tag):
                arr = plans[tag]("layer", B, H, W, C, C, dil=da).ints
                arrs.append(arr)
                fn = libs[tag]["qconv_kernel"].qconv_tc_f32
                args_ = (ptr(xa), ptr(La["q"]), ptr(La["ws"]), ptr(La["b"]), ptr(ys[tag][0]),
                         ptr(ys[tag][1]), P(arr.ctypes.data), I(arr.size))
                return lambda: check(fn(*args_, stream()), f"{tag} qconv_tc_f32")

            calls = {tag: layer_call(tag) for tag in ys}
            for c in calls.values():
                c()
            torch.cuda.synchronize()
            acc = qk.qconv_acc_reference(xa, La, 1, da)
            y = qk.requantize_reference(acc, La["ws"], La["b"], None)
            for tag in ys:
                if not (torch.equal(ys[tag][0], y) and torch.equal(ys[tag][1], acc)):
                    raise AssertionError(f"qconv_layer {C}: the {tag} differs from its plain version")
            res[f"qconv_layer_any_{C}_bit_for_bit"] = True
            timed(f"qconv_layer_any_{C}", calls, conv_lib(ins[1]))


def exact_ab(args, dev, res, ck_mods, k4_layer, k4_plans, k4_case, imgs, trees) -> None:
    """The ``exact`` part of ``--only widths`` (module docstring): the cases,
    then each tree's SASS and stamped phases."""
    from chip_smoke import QVGA, SCAN, SCAN_SEED, SEED

    from ubdvss_tpu_torch.ops.cuda import context_kernel as ck

    asset = REPO / "assets" / "pretrained_synthetic.npz"
    cfg = load_net_config(asset)
    params = {k: v.to(dev) for k, v in params_from_flat(load_params_npz(asset)).items()}
    dil = tuple(cfg.dilations)
    w = ck._pack_weights(params, dil)
    frames = np.stack([SyntheticMarkupReader(n_samples=64, image_hw=QVGA, seed=SEED).sample_at(i).image
                       for i in range(64)])
    reader = SyntheticMarkupReader(n_samples=8, image_hw=(SCAN, SCAN), seed=SCAN_SEED)
    scans = np.stack([reader.sample_at(i).image for i in range(8)])

    def features(images):
        with exact_f32():
            f = ck.stem_apply(params, images.float()[..., None], cfg, raw_gray=True)
        return f.permute(0, 3, 1, 2).contiguous()

    x24 = features(imgs)
    k4_case("k4_exact_64x24x128", x24, w, dil, False)
    xs = features(torch.from_numpy(scans).to(dev))
    k4_case("k4_exact_packed_8x24x512", xs, w, dil, True)
    del xs
    k4_case("k4_exact_qvga_64x24x60x80", features(torch.from_numpy(frames).to(dev)), w, dil, False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    L = len(dil)
    for C in (8, 16, 32):
        x = torch.randn((64, C, 128, 128), generator=gen, device=dev)
        for O in (1, 17, 32):
            wr = [torch.randn(shape, generator=gen, device=dev) * sc for sc, shape in (
                (0.3, (L, 9, C, 1, 1)), (0.3 / np.sqrt(C / 8), (L, C, C)), (0.1, (L, C, 1, 1)),
                (0.3, (O, C)), (0.1, (O, 1, 1)))]
            k4_case(f"k4_exact_C{C}_O{O}_64x128", x, wr, dil, False)
        del x
    torch.cuda.empty_cache()

    # the SASS of each tree's exact kernels (the parent's register kernel at
    # its compiled widths), then the stamped builds' phases on the asset's
    # seven layers at (64, 24, 128²)
    def exact_kernel(name):
        return "context_exact_kernel<" in name or any(
            f"context_layer_kernel<{c}, false>" in name for c in (8, 16, 24, 32))

    out = REPO / "build" / "ab"
    sass = {}
    for _, tag, srcs, _ in trees:
        if "context_kernel" in srcs:
            sass[tag] = sass_counts(out / f"{tag}-context_kernel.so", exact_kernel)
    csrcs = {tag: c for c, tag, *_ in trees}
    stamp_trees = [(_stamped_parent_k4(csrcs["parent"]), "parentK", ("context_kernel",),
                    ("-DCONTEXT_STAMPS",))]
    stamp_trees += [(csrcs[tag], f"{tag}K", ("context_kernel",), ("-DCONTEXT_STAMPS",))
                    for tag in csrcs if tag != "parent"]
    stamped = build_trees(stamp_trees)
    for _, tagk, *_ in stamp_trees:
        sass[tagk] = sass_counts(out / f"{tagk}-context_kernel.so", exact_kernel)
    res["k4_exact_sass"] = sass
    print(json.dumps({"k4_exact_sass": sass}), flush=True)
    O = w[3].shape[0]
    bufs = torch.empty_like(x24), torch.empty((64, O, 128, 128), device=dev)
    for tag in csrcs:
        lib = stamped[f"{tag}K"]["context_kernel"]
        lib.context_cycles.argtypes = [P]
        plans = k4_plans(tag, x24, O, dil)
        split = []
        for li, d in enumerate(dil):
            last = li == L - 1
            check(lib.context_cycles_clear(), f"{tag} stamps")
            k4_layer(lib, tag, plans, x24, bufs[1] if last else bufs[0], w, li, d, last, False)
            torch.cuda.synchronize()
            host = np.zeros(4, np.uint64)
            check(lib.context_cycles(P(host.ctypes.data)), f"{tag} stamps")
            warps = max(int(host[3]), 1)
            split.append({"dilation": d, "plan": None if plans is None else plans[li],
                          "warps": int(host[3]),
                          "cycles_a_warp": [float(v) / warps for v in host[:3]]})
        res[f"k4_exact_phases_{tag}"] = split
    print(json.dumps({k: v for k, v in res.items() if k.startswith("k4_exact_phases")}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--only", choices=("geometry", "int8", "tiled", "tall", "widths"), default=None)
    ap.add_argument("--variants", type=Path, nargs="*", default=[])
    ap.add_argument("--parts", nargs="*", default=["exact", "narrow", "stats", "wide", "int8"],
                    choices=("exact", "narrow", "stats", "wide", "int8"),
                    help="widths: K4 at its compiled widths, K4 up to 32 channels, the stats, K4 "
                         "past 32 channels, the int8 convs")
    ap.add_argument("--stats-logits", type=int, nargs="*", default=[5, 25, 33, 34, 41, 42, 65, 66, 97],
                    help="widths: the logit counts of the stats")
    ap.add_argument("--stats-cases", nargs="*", default=[],
                    help="widths: only the few-image stats cases whose name holds one of these")
    ap.add_argument("--out", type=Path, default=REPO / "build" / "ab" / "ab.json")
    args = ap.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    res = {"card": smi}
    if args.only in (None, "geometry"):
        geometry_ab(args, dev, res)
    if args.only in (None, "int8"):
        int8_ab(args, dev, res)
    if args.only in (None, "tiled"):
        tiled_ab(args, dev, res)
    if args.only in (None, "tall"):
        tall_ab(args, dev, res)
    if args.only in (None, "widths"):
        widths_ab(args, dev, res)
    print(json.dumps(res), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The context module + head (K4, and the bf16 route's dense convs) and
the trunk.

Counterpart of ``ubdvss_tpu/ops/pallas/context_kernel.py``.  The JAX
package picks a formulation by dtype and size (``context_head_route``,
:654-674): its Pallas kernel in f32 up to 128x128 feature maps, the XLA
formulations ``dense_context_head`` / ``s2d_context_head`` (layouts for
the TPU's matrix unit) in the bf16 mode and beyond.  The port runs:

  * f32: the context kernel (K4) at every size, in full f32 (``exact_f32``
    turns cuDNN's TF32 off and refuses to run with TF32 matmuls enabled;
    the JAX reference runs at ``Precision.HIGHEST``);
  * bf16: ``dense_context_head`` at every size, as the JAX bf16 route does
    below the s2d route's sizes.  ``context_head_route`` does not take
    ``s2d_context_head`` past 256² maps as JAX does: that formulation
    spends 4x the multiply-adds (block-diagonal 96-channel convs) to fill
    the TPU's 128-lane matrix unit, a trade this card does not need.

The packed route (the JAX package's large-scan trunk,
``context_kernel.py:237-624``) hands its logits to the postprocessing in
the phase-major space-to-depth layout, (B, H/8, W/8, 4 O), channel
(2 py + px) O + o for heatmap pixel (2 i + py, 2 j + px):

  * ``_s2d`` / ``_d2s``, ``_pack_s2d_kernel``, ``_pack_stride2_kernel``,
    ``packed_stem_apply`` and ``s2d_context_head`` are the JAX package's
    packed formulation (``F.conv2d`` on packed tensors, cuDNN on the card
    with TF32 off in f32), which a CPU tensor takes and which is the plain
    version of the card's packed trunk;
  * ``packed_fused_trunk`` and ``context_head_route_maybe_packed`` run, on
    the card, the direct trunk with the layout produced where the logits
    are written: in f32 the stem and K4, whose last launch stores the head
    phase-major (``fused_context_head(packed=True)``); in bf16 the dense
    route and one ``_s2d`` of its bf16 logits, the route's only layout
    copy.  No 96-channel conv runs on the card;
  * ``_s2d_route_selected`` and ``packed_trunk_selected`` are the JAX
    package's gates.

The pieces:

  * ``_pack_weights`` — the state_dict's context/head weights as the
    kernel's tensors, in the JAX package's shapes: dw (L, 9, C, 1, 1),
    pwt (L, C, C), pb (L, C, 1, 1), hwt (O, C), hb (O, 1, 1), all f32;
  * ``context_head_reference`` — the plain version of K4: 9 zero-filled
    shifted multiply-adds, the pointwise product, bias, ReLU per layer,
    then the 1x1 head;
  * ``fused_context_head`` — the K4 wrapper (one launch per layer, the
    head fused into the last, ``csrc/context_kernel.cu``; with ``packed``
    the head stored phase-major; any C and O, ``kernel_instance``), a
    ``torch.autograd.Function`` whose
    backward is autograd of the plain version, as the JAX package's
    ``custom_vjp``;
  * ``dense_context_head`` — each separable layer as one dense 3x3 dilated
    conv (cuDNN in bf16 with f32 accumulation, as XLA's conv in the JAX
    package), bias and ReLU as separate ops at the activation dtype;
  * ``stem_apply`` — the two stride-2 "SAME" convs (``F.conv2d``, as the
    JAX package leaves them to XLA), with the optional ``raw_gray`` fold of
    x/127.5 - 1 into the first conv, in either dtype;
  * ``context_head_route`` and ``fused_model_apply`` — the trunk.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ubdvss_tpu_torch.models.model import (
    bf16_full_accumulation,
    compute_precision,
    conv2d_same,
    exact_f32,
)
from ubdvss_tpu_torch.ops.ccl import _shift
from ubdvss_tpu_torch.ops.cuda import _build

# The context kernel's instances (csrc/context_kernel.cu): C in
# EXACT_CHANNELS with at most EXACT_HEAD_OUTPUTS head outputs two pixels a
# thread, d rows apart ("exact", ``exact_plan``); any other C <=
# NARROW_CHANNELS, or a larger head, the register kernel, a thread a pixel,
# compiled for that C, its weights in dynamic shared memory ("narrow",
# where they fit one block); 32 < C <= 128
# as a tile of TILE_PIXELS pixels by all C channels a block of
# TILE_THREADS, the pointwise and the head register-tiled products over
# shared memory ("wide", where that block fits); other C with each pixel's
# depthwise results and activations in shared-memory columns
# ("wide_columns", COLUMN_THREADS threads a block, fewer where C columns do
# not fit).  The choice is by (C, O) alone (and, for "wide", a map of
# fewer than 2^30 pixels), the same for every layer of a call.
EXACT_CHANNELS = (8, 16, 24, 32)
EXACT_HEAD_OUTPUTS = 32
NARROW_CHANNELS = 32
TILE_PIXELS, TILE_THREADS = 128, 256
COLUMN_THREADS = (128, 64, 32)
SHARED_MEMORY_LIMIT = 232_448  # bytes a block may use on the H100


def tile_outputs(C: int) -> int:
    """Outputs a warp of the "wide" instance takes, so that C outputs make
    at most eight groups (csrc/context_kernel.cu ``tile_ot``); 0 where the
    instance does not take C."""
    for ot, top in ((6, 48), (8, 64), (12, 96), (16, 128)):
        if 32 < C <= top:
            return ot
    return 0


def tile_smem(C: int, O: int, head: bool = True) -> int:
    """Bytes of dynamic shared memory of a "wide" launch (``tile_smem``):
    the tile's C x TILE_PIXELS depthwise results, the pointwise (and head)
    weights by output group, OT rounded up to 4 a channel, the taps and the
    biases."""
    ot = tile_outputs(C)
    if not ot:
        return SHARED_MEMORY_LIMIT + 1
    groups = -(-C // ot) + (-(-O // ot) if head else 0)
    return 4 * (C * TILE_PIXELS + groups * C * (-(-ot // 4) * 4) + 9 * C + C + (O if head else 0))


def narrow_smem(C: int, O: int) -> int:
    """Bytes of shared memory of a "narrow" block, all dynamic: the taps,
    pointwise weights and biases and the O-output head's O (C + 1) floats."""
    return 4 * (9 * C + C * C + C + O * (C + 1))


def kernel_instance(C: int, O: int) -> str:
    """Which instance of K4 runs C channels and an O-output head:
    "exact", "narrow", "wide" or "wide_columns"."""
    if C > NARROW_CHANNELS:
        return "wide" if tile_smem(C, O) <= SHARED_MEMORY_LIMIT else "wide_columns"
    if C in EXACT_CHANNELS and O <= EXACT_HEAD_OUTPUTS:
        return "exact"
    return "narrow" if narrow_smem(C, O) <= SHARED_MEMORY_LIMIT else "wide_columns"


# The exact instance's launch geometry (csrc/context_kernel.cu
# context_exact_kernel): EXACT_PIXELS pixels a thread, d rows apart in one
# column, so that they share their tap rows (one where the map is too short
# for two), EXACT_THREADS threads a block.  Two beat one and four at every
# exact width and head, with no spill (scripts/torch_kernel_ab.py --only
# widths --parts exact; PERF.md §6).
EXACT_PIXELS = 2
EXACT_THREADS = 128


@dataclass(frozen=True)
class ExactPlan:
    """One exact-instance launch: ``pixels`` (P) pixels a thread at rows
    y0, y0 + d, ..., ``rows`` rows of threads an image (a thread a column
    of each), ``threads`` a block and ``blocks`` blocks an image (grid.x;
    grid.y is the batch)."""

    pixels: int
    rows: int
    threads: int
    blocks: int


STATIC_SHARED_LIMIT = 48 * 1024  # bytes of static shared memory a block may have


def exact_smem(C: int) -> int:
    """Bytes of static shared memory of the exact instance's head layer,
    the block that holds the most: the taps, the pointwise weights and
    biases, and EXACT_HEAD_OUTPUTS head rows and biases, all f32
    (``context_exact_kernel``; a layer without the head holds the first
    three)."""
    return 4 * (9 * C + C * C + C + EXACT_HEAD_OUTPUTS * (C + 1))


def exact_thread_rows(H: int, d: int, P: int) -> int:
    """Rows of threads an image of the exact instance: the map's rows in
    groups of P d, a row of threads a residue of y mod d in each group, the
    last group's residues only as far as the map goes (csrc
    ``exact_thread_rows``)."""
    full = (H - 1) // (P * d)  # the groups before the last
    return full * d + min(d, H - full * P * d)


def exact_first_row(t, d: int, P: int):
    """The first pixel row of row of threads ``t`` (its group's start plus
    its residue of y mod d), as the kernel computes it; numpy arrays or
    ints."""
    g = t // d
    return g * P * d + (t - g * d)


def exact_plan(H: int, W: int, d: int) -> ExactPlan:
    """The exact instance's launch of one layer on H x W maps at dilation
    d, at any of its widths and with or without the head: EXACT_PIXELS
    pixels a thread, halved while the thread's last pixel could never lie
    on the map ((P - 1) d >= H)."""
    P = EXACT_PIXELS
    while P > 1 and (P - 1) * d >= H:
        P //= 2
    rows = exact_thread_rows(H, d, P)
    return ExactPlan(P, rows, EXACT_THREADS, -(-rows * W // EXACT_THREADS))


def kernel_smem(C: int, O: int) -> tuple[int, int]:
    """(threads a block, bytes of shared memory sized at run time) of K4's
    launch with the O-output head at C channels, the layer that needs the
    most: the "narrow" instance's weights, the "wide" instance's tile and
    weights, or the "wide_columns" instance's per-thread columns (2 C
    floats a thread) at the largest block that fits; (0, bytes) when none fits one block's shared memory."""
    inst = kernel_instance(C, O)
    if inst == "exact":
        return EXACT_THREADS, 0
    if inst == "narrow":
        return 256, narrow_smem(C, O)
    if inst == "wide":
        return TILE_THREADS, tile_smem(C, O)
    for T in COLUMN_THREADS:
        if 4 * 2 * C * T <= SHARED_MEMORY_LIMIT:
            return T, 4 * 2 * C * T
    return 0, 4 * 2 * C * COLUMN_THREADS[-1]


def _pack_weights(params: dict, dilations) -> tuple:
    """state_dict -> (dw, pwt, pb, hwt, hb) kernel weight tensors."""
    dws, pwts, pbs = [], [], []
    for i in range(len(dilations)):
        dk = params[f"context_{i}.depthwise.weight"].to(torch.float32)  # (C,1,3,3)
        C = dk.shape[0]
        dws.append(dk[:, 0].reshape(C, 9).T[:, :, None, None])  # (9, C, 1, 1)
        pwts.append(params[f"context_{i}.pointwise.weight"].to(torch.float32)[:, :, 0, 0])
        pbs.append(params[f"context_{i}.pointwise.bias"].to(torch.float32)[:, None, None])
    hw = params["head.weight"].to(torch.float32)[:, :, 0, 0]  # (O, C)
    hb = params["head.bias"].to(torch.float32)[:, None, None]
    return (
        torch.stack(dws).contiguous(),
        torch.stack(pwts).contiguous(),
        torch.stack(pbs).contiguous(),
        hw.contiguous(),
        hb.contiguous(),
    )


def context_head_reference(x_nchw, dw, pwt, pb, hwt, hb, dilations):
    """Plain version: (B, C, H, W) f32 -> (B, O, H, W) logits."""
    x = x_nchw.to(torch.float32)
    for li, d in enumerate(dilations):
        acc = torch.zeros_like(x)
        t = 0
        for ty in (-1, 0, 1):
            for tx in (-1, 0, 1):
                xs = x
                # zero fill at the borders == SAME-conv padding
                if ty:
                    xs = _shift(xs, -ty * d, 2, 0.0)
                if tx:
                    xs = _shift(xs, -tx * d, 3, 0.0)
                acc = acc + xs * dw[li, t][None]
                t += 1
        y = torch.einsum("oc,bchw->bohw", pwt[li], acc)
        x = torch.clamp(y + pb[li][None], min=0.0)
    return torch.einsum("oc,bchw->bohw", hwt, x) + hb[None]


def _s2d(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth s=2: (B, H, W, C) -> (B, H/2, W/2, 4C), phase-major
    channels c' = (2 pi + pj) C + c for source pixel (2i + pi, 2j + pj)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H // 2, W // 2, 4 * C)


def _d2s(x: torch.Tensor, C: int) -> torch.Tensor:
    """Inverse of ``_s2d``."""
    B, Hh, Wh, _ = x.shape
    x = x.reshape(B, Hh, Wh, 2, 2, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hh * 2, Wh * 2, C)


def _s2d_planes(x_nchw: torch.Tensor) -> torch.Tensor:
    """(B, O, H, W) -> the contiguous (B, 4 O, H/2, W/2) whose NHWC view is
    ``_s2d`` of the NHWC view: what K4's packed store writes."""
    return _s2d(x_nchw.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).contiguous()


def _d2s_planes(x_nchw: torch.Tensor, O: int) -> torch.Tensor:
    """Inverse of ``_s2d_planes``."""
    return _d2s(x_nchw.permute(0, 2, 3, 1), O).permute(0, 3, 1, 2)


_FUNCS = {"context_layer": [_build.P] * 7 + [_build.I] * 10 + [_build.P]}


def _launch_context_head(x_nchw, dw, pwt, pb, hwt, hb, dilations, packed) -> torch.Tensor:
    """The K4 launches on a CUDA tensor: one a layer, the head fused into
    the last (stored phase-major with ``packed``)."""
    dev = x_nchw.device
    _build.check_input(x_nchw, "x", torch.float32, 4)
    B, C, H, W = x_nchw.shape
    L = len(dilations)
    O = hwt.shape[0]
    if L == 0:
        raise ValueError("the context kernel needs at least one context layer")
    if min(int(d) for d in dilations) < 1:
        raise ValueError(f"dilations must be at least 1, got {tuple(dilations)}")
    for name, t, shape in (
        ("dw", dw, (L, 9, C, 1, 1)), ("pwt", pwt, (L, C, C)),
        ("pb", pb, (L, C, 1, 1)), ("hwt", hwt, (O, C)), ("hb", hb, (O, 1, 1)),
    ):
        _build.check_input(t, name, torch.float32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    threads, smem = kernel_smem(C, O)
    if threads == 0 or smem > SHARED_MEMORY_LIMIT:
        raise NotImplementedError(
            f"C={C}, O={O}: a context kernel block needs {smem} B of shared memory, "
            f"more than the card's {SHARED_MEMORY_LIMIT}"
        )
    if packed and (H % 2 or W % 2):
        raise ValueError(f"a packed store needs an even map, got {H}x{W}")
    lib = _build.load("context_kernel", _FUNCS)
    bufs = [torch.empty_like(x_nchw), torch.empty_like(x_nchw)] if L > 1 else []
    shape = (B, 4 * O, H // 2, W // 2) if packed else (B, O, H, W)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    exact = kernel_instance(C, O) == "exact"
    cur = x_nchw
    for li, d in enumerate(dilations):
        last = li == L - 1
        dst = out if last else bufs[li % 2]
        plan = exact_plan(H, W, int(d)) if exact else None
        _build.launch(
            lib, "context_layer", dev, cur.data_ptr(), dst.data_ptr(),
            dw[li].data_ptr(), pwt[li].data_ptr(), pb[li].data_ptr(),
            hwt.data_ptr() if last else None, hb.data_ptr() if last else None,
            B, C, H, W, int(d), O, int(packed and last),
            *((plan.pixels, plan.rows, plan.threads) if exact else (0, 0, 0)),
        )
        fused_context_head.launches += 1
        if packed and last:
            fused_context_head.launches_packed += 1
        cur = dst
    return out


class _ContextHead(torch.autograd.Function):
    """K4 forward, and the gradient of its plain version backward: the JAX
    package's ``custom_vjp`` (``_fch_fwd`` / ``_fch_bwd``), whose backward
    is XLA's autodiff of ``context_head_reference``.  A packed output's
    gradient is mapped back through ``_d2s`` first."""

    @staticmethod
    def forward(ctx, x_nchw, dw, pwt, pb, hwt, hb, dilations, packed):
        ctx.dilations, ctx.packed = dilations, packed
        ctx.save_for_backward(x_nchw, dw, pwt, pb, hwt, hb)
        if x_nchw.device.type == "cpu":
            out = context_head_reference(x_nchw, dw, pwt, pb, hwt, hb, dilations)
            return _s2d_planes(out) if packed else out
        return _launch_context_head(x_nchw, dw, pwt, pb, hwt, hb, dilations, packed)

    @staticmethod
    def backward(ctx, g):
        if ctx.packed:
            g = _d2s_planes(g, g.shape[1] // 4)
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), exact_f32():
            out = context_head_reference(*inputs, ctx.dilations)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None, None)


def fused_context_head(
    x_nchw, dw, pwt, pb, hwt, hb, dilations, packed: bool = False
) -> torch.Tensor:
    """Context module + head: (B, C, H, W) f32 -> (B, O, H, W) f32 logits,
    or with ``packed`` (H, W even) the (B, 4 O, H/2, W/2) planes whose NHWC
    view is the phase-major ``_s2d`` of the logits, as the packed route
    hands them to ``postprocess_batch_fused(packed_phases=(2, 2))``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    per-layer kernel (the head fused into the last launch, which stores
    phase-major with ``packed``) or raises.  Differentiable in every input:
    the backward is autograd of ``context_head_reference`` on the saved
    inputs in full f32, as the JAX package's VJP
    (``context_kernel.py:454-473``).  ``launches`` counts the forward's
    kernel launches, ``launches_packed`` those that stored phase-major.
    """
    return _ContextHead.apply(x_nchw, dw, pwt, pb, hwt, hb, tuple(dilations), bool(packed))


fused_context_head.launches = 0
fused_context_head.launches_packed = 0


def _stem(params: dict, x_nhwc: torch.Tensor, cfg, raw_gray: bool) -> torch.Tensor:
    """The stem's (B, C, H/4, W/4) features at the compute dtype (NCHW)."""
    dt = cfg.compute_dtype
    x = x_nhwc.to(dt).permute(0, 3, 1, 2)
    for i in range(2):
        w = params[f"downscale_{i}.weight"].to(torch.float32)
        b = params[f"downscale_{i}.bias"].to(dt).view(1, -1, 1, 1)
        if i == 0 and raw_gray:
            # the quotient is rounded to the compute dtype, and the border
            # correction is the conv of ones with the kernel at that dtype
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=dt, device=x.device)
            corr = conv2d_same(ones, w.to(dt), None, stride=2)
            x = conv2d_same(x, (w * (1.0 / 127.5)).to(dt), None, stride=2) - corr + b
        elif dt == torch.float32:
            x = conv2d_same(x, w, b.view(-1), stride=2)
        else:
            x = conv2d_same(x, w.to(dt), None, stride=2) + b  # bias after the conv, in bf16
        x = F.relu(x)
    return x


def stem_apply(params: dict, x_nhwc: torch.Tensor, cfg, raw_gray: bool = False):
    """Downscale stem: two 3x3 stride-2 SAME convs + ReLU,
    (B, H, W, 1) -> (B, H/4, W/4, C) f32 features (an NHWC view).

    ``raw_gray=True``: the input is unnormalized grayscale [0, 255] and
    x/127.5 - 1 is folded into the first conv — conv(x/s - 1) =
    conv(x, k/s) - conv(ones, k), where conv(ones, k) is a constant map
    that is exact at the SAME borders, where fewer taps are in bounds.

    In the bf16 mode each conv takes bf16 operands with f32 accumulation,
    and conv - corr + bias and the ReLU run in bf16; the features are then
    cast to f32, as the JAX function returns them.  (``fused_model_apply``
    keeps them in bf16: the dense context casts them straight back.)
    """
    return _stem(params, x_nhwc, cfg, raw_gray).to(torch.float32).permute(0, 2, 3, 1)


def dense_context_head(
    x_nhwc: torch.Tensor, dw, pwt, pb, hwt, hb, dilations,
    act_dtype: torch.dtype = torch.float32, act_out: bool = False,
) -> torch.Tensor:
    """Context module + head with each separable layer collapsed into ONE
    dense 3x3 dilated conv, kernel[co, ci] = dw[ci] * pwt[co, ci], the
    product taken in f32 from ``_pack_weights``' tensors and then cast to
    ``act_dtype`` (the JAX function's rounding); the activations are
    stored at ``act_dtype``, each bias added after its conv and the ReLU
    applied at that dtype.  (B, H, W, C) in, (B, H, W, O) logits out: f32,
    or at ``act_dtype`` with ``act_out=True`` (the bf16 route hands them
    to postprocessing at that dtype, as the JAX package does).
    """
    C = pwt.shape[-1]
    x = x_nhwc.to(act_dtype).permute(0, 3, 1, 2)
    for li, d in enumerate(dilations):
        k = pwt[li][:, :, None] * dw[li, :, :, 0, 0].T[None]  # (Co, Ci, 9) f32
        y = conv2d_same(x, k.reshape(C, C, 3, 3).to(act_dtype), None, dilation=d)
        x = F.relu(y + pb[li].to(act_dtype).view(1, -1, 1, 1))
    out = F.conv2d(x, hwt[:, :, None, None].to(act_dtype)) + hb.to(act_dtype).view(1, -1, 1, 1)
    out = out.permute(0, 2, 3, 1)
    return out if act_out else out.to(torch.float32)


def context_head_route(
    params: dict, feat: torch.Tensor, cfg, act_out: bool = False
) -> torch.Tensor:
    """Context module + 1x1 head over stem features (B, Hf, Wf, C) ->
    (B, Hf, Wf, O) logits, at any map size: f32 through the context kernel
    (an NHWC view of its NCHW output), bf16 through ``dense_context_head``
    (bf16 logits with ``act_out=True``, else f32)."""
    dw, pwt, pb, hwt, hb = _pack_weights(params, tuple(cfg.dilations))
    if cfg.compute_dtype == torch.bfloat16:
        return dense_context_head(
            feat, dw, pwt, pb, hwt, hb, tuple(cfg.dilations),
            act_dtype=torch.bfloat16, act_out=act_out,
        )
    xc = feat.permute(0, 3, 1, 2).contiguous()
    logits = fused_context_head(xc, dw, pwt, pb, hwt, hb, tuple(cfg.dilations))
    return logits.permute(0, 2, 3, 1)


def fused_model_apply(
    params: dict, x_nhwc: torch.Tensor, cfg, raw_gray: bool = False,
    act_out: bool = False,
):
    """Full separable FCN forward, NHWC in / NHWC logits out: the stem, then
    ``context_head_route``.  In f32 it equals ``BarcodeFCN`` on the same
    weights; in bf16 it is the JAX package's bf16 route (the dense
    equivalent of each separable layer), whose logits are f32, or bf16 with
    ``act_out=True``."""
    if not cfg.separable_context:
        raise ValueError("fused path implements the separable context module")
    if cfg.compute_dtype == torch.bfloat16:
        with bf16_full_accumulation():
            feat = _stem(params, x_nhwc, cfg, raw_gray).permute(0, 2, 3, 1)
            return context_head_route(params, feat, cfg, act_out=act_out)
    with exact_f32():
        feat = stem_apply(params, x_nhwc, cfg, raw_gray=raw_gray)
        return context_head_route(params, feat, cfg)


# ---------------------------------------------------------------------------
# The packed route: the JAX package's formulation, and the card's trunk
# ---------------------------------------------------------------------------


def _conv_nhwc(x, k_hwio, stride=1, dilation=1, padding=None):
    """NHWC conv with an HWIO kernel: TF "SAME" padding, or ``padding`` =
    ((top, bottom), (left, right)) explicit zeros."""
    xc = x.permute(0, 3, 1, 2)
    w = k_hwio.permute(3, 2, 0, 1)
    if padding is None:
        y = conv2d_same(xc, w, None, stride, dilation)
    else:
        (t, b), (left, r) = padding
        y = F.conv2d(F.pad(xc, (left, r, t, b)), w, None, stride, 0, dilation)
    return y.permute(0, 2, 3, 1)


def _pack_s2d_kernel(k: torch.Tensor, d: int) -> tuple[torch.Tensor, int]:
    """Dense 3x3 dilation-``d`` kernel (3, 3, C, Co) HWIO -> the (3, 3, 4C,
    4Co) kernel of the same conv on s=2 space-to-depth tensors, and its
    packed dilation (the JAX package's function of this name).

    Even d: each phase convolves alone at dilation d/2, block-diagonal over
    the phases.  d == 1: tap (ty, tx) of output phase (qi, qj) reads input
    phase ((qi+ty) mod 2, (qj+tx) mod 2) at packed offset (floor((qi+ty)/2),
    floor((qj+tx)/2)), within a 3x3 footprint.  Other odd d raise.  SAME
    padding of the packed map is SAME padding of the original one."""
    C, Co = k.shape[2], k.shape[3]
    KP = k.new_zeros((3, 3, 4 * C, 4 * Co))
    if d % 2 == 0:
        for p in range(4):
            KP[:, :, p * C:(p + 1) * C, p * Co:(p + 1) * Co] = k
        return KP, d // 2
    if d != 1:
        raise ValueError(f"odd dilation {d} != 1 unsupported by s2d packing")
    for qi in range(2):
        for qj in range(2):
            q = 2 * qi + qj
            for ty in (-1, 0, 1):
                for tx in (-1, 0, 1):
                    p = 2 * ((qi + ty) % 2) + (qj + tx) % 2
                    KP[(qi + ty) // 2 + 1, (qj + tx) // 2 + 1,
                       p * C:(p + 1) * C, q * Co:(q + 1) * Co] = k[ty + 1, tx + 1]
    return KP, 1


def _pack_stride2_kernel(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) stride-2 SAME kernel -> the (3, 3, 4Ci, 4Co) kernel
    of the same conv from s=2-packed input to s=2-packed output, run at
    stride 2 with explicit padding ((0, 1), (0, 1)): output cell j, phase
    q reads input cell 2j + (2q + t) // 2, phase (2q + t) % 2, for tap t
    (the JAX package's function of this name)."""
    Ci, Co = k.shape[2], k.shape[3]
    KP = k.new_zeros((3, 3, 4 * Ci, 4 * Co))
    for qy in range(2):
        for qx in range(2):
            q = 2 * qy + qx
            for ty in range(3):
                for tx in range(3):
                    dy, py = divmod(2 * qy + ty, 2)
                    dx, px = divmod(2 * qx + tx, 2)
                    p = 2 * py + px
                    KP[dy, dx, p * Ci:(p + 1) * Ci, q * Co:(q + 1) * Co] = k[ty, tx]
    return KP


_PACKED_PAD = ((0, 1), (0, 1))


def packed_stem_apply(params: dict, x_nhwc: torch.Tensor, cfg, raw_gray: bool = False):
    """``_s2d(stem_apply(...))`` computed in s=2-packed layout, the JAX
    package's formulation: the input packed once, each stride-2 SAME conv
    a stride-2 conv between packed grids (``_pack_stride2_kernel``,
    explicit ((0, 1), (0, 1)) padding), the raw-gray fold with the packed
    in-bounds tap-sum map of ones.  (B, H, W, 1), H and W divisible by 8
    -> (B, H/8, W/8, 4 C) f32.  The JAX function's ``large`` picks the
    TPU's matrix-unit precision; the port keeps its rule: exact f32 in
    f32, bf16 operands with f32 accumulation in bf16."""
    H, W = x_nhwc.shape[1:3]
    if H % 8 or W % 8:
        raise ValueError(f"the packed stem needs H, W % 8 == 0, got {H}x{W}")
    dt = cfg.compute_dtype
    x = _s2d(x_nhwc.to(dt))  # (B, H/2, W/2, 4)
    for i in range(2):
        k32 = params[f"downscale_{i}.weight"].to(torch.float32).permute(2, 3, 1, 0)  # HWIO
        bias = params[f"downscale_{i}.bias"].to(dt).repeat(4)
        if i == 0 and raw_gray:
            KPs = _pack_stride2_kernel((k32 * (1.0 / 127.5)).to(dt))
            KPc = _pack_stride2_kernel(k32.to(dt))
            ones = torch.ones((1,) + tuple(x.shape[1:3]) + (4,), dtype=dt, device=x.device)
            corr = _conv_nhwc(ones, KPc, 2, padding=_PACKED_PAD)
            x = _conv_nhwc(x, KPs, 2, padding=_PACKED_PAD) - corr + bias
        else:
            x = _conv_nhwc(x, _pack_stride2_kernel(k32.to(dt)), 2, padding=_PACKED_PAD) + bias
        x = F.relu(x)
    return x.to(torch.float32)


def s2d_context_head(
    x_nhwc, dw, pwt, pb, hwt, hb, dilations,
    act_dtype: torch.dtype = torch.float32, unpack: bool = True,
    packed_in: bool = False, act_out: bool = False,
):
    """``dense_context_head`` on s=2 space-to-depth-packed activations, the
    JAX package's large-map formulation for its TPU's matrix unit: each
    layer one (3, 3, 4C, 4C) conv (``_pack_s2d_kernel``), the head
    block-diagonal over the phases.  The same products as the dense route,
    exact zeros elsewhere.  ``packed_in``: the features are already packed
    (``packed_stem_apply``); ``unpack=False`` returns the phase-major
    (B, H/2, W/2, 4 O) logits; odd sizes fall back to
    ``dense_context_head``.  The JAX function's ``precision`` picks the
    TPU's matrix-unit precision; the port keeps its rule (exact f32 in
    f32, bf16 operands with f32 accumulation in bf16)."""
    C = pwt.shape[-1]
    if packed_in:
        x = x_nhwc.to(act_dtype)
    else:
        H, W = x_nhwc.shape[1:3]
        if H % 2 or W % 2:
            return dense_context_head(x_nhwc, dw, pwt, pb, hwt, hb, dilations,
                                      act_dtype=act_dtype, act_out=act_out)
        x = _s2d(x_nhwc.to(act_dtype))
    for li, d in enumerate(dilations):
        k = dw[li, :, :, 0, 0].reshape(3, 3, C, 1) * pwt[li].T.reshape(1, 1, C, C)
        KP, dp = _pack_s2d_kernel(k.to(act_dtype), d)
        y = _conv_nhwc(x, KP, 1, dp)
        x = F.relu(y + pb[li][:, 0, 0].to(act_dtype).repeat(4))
    O = hwt.shape[0]
    hk = hwt.T.to(act_dtype)  # (C, O)
    KH = hk.new_zeros((1, 1, 4 * C, 4 * O))
    for p in range(4):
        KH[0, 0, p * C:(p + 1) * C, p * O:(p + 1) * O] = hk
    out = _conv_nhwc(x, KH) + hb[:, 0, 0].to(act_dtype).repeat(4)
    if unpack:
        out = _d2s(out, O)
    return out if act_out else out.to(torch.float32)


def _s2d_route_selected(cfg, Hf: int, Wf: int, large: bool) -> bool:
    """The JAX package's gate of its s2d context route: the bf16 or large
    regime, maps past 256², even sizes, dilations even or 1."""
    return (
        (cfg.compute_dtype == torch.bfloat16 or large)
        and all(d == 1 or d % 2 == 0 for d in cfg.dilations)
        and Hf * Wf > 256 * 256
        and Hf % 2 == 0
        and Wf % 2 == 0
    )


def packed_trunk_selected(cfg, out_hw) -> bool:
    """The JAX package's gate of its whole-trunk packed route: scale 4, a
    separable config, dims divisible by 8, dilations even or 1, feature
    maps of at least 256²."""
    H, W = out_hw
    return (
        cfg.scale == 4
        and H % 8 == 0
        and W % 8 == 0
        and cfg.separable_context
        and all(d == 1 or d % 2 == 0 for d in cfg.dilations)
        and (H // 4) * (W // 4) >= 256 * 256
    )


def packed_trunk_reference(params: dict, x_nhwc, cfg, raw_gray: bool = False,
                           act_out: bool = False):
    """Plain version of the packed trunk, the JAX package's
    ``packed_fused_trunk``: ``packed_stem_apply`` then
    ``s2d_context_head(packed_in=True, unpack=False)``."""
    bf16 = cfg.compute_dtype == torch.bfloat16
    with compute_precision(cfg):
        feat = packed_stem_apply(params, x_nhwc, cfg, raw_gray=raw_gray)
        w = _pack_weights(params, tuple(cfg.dilations))
        return s2d_context_head(
            feat, *w, tuple(cfg.dilations), act_dtype=torch.bfloat16 if bf16 else torch.float32,
            unpack=False, packed_in=True, act_out=act_out,
        )


def _packed_head(params: dict, feat: torch.Tensor, cfg, act_out: bool) -> torch.Tensor:
    """The card's packed context + head over stem features (B, Hf, Wf, C)
    (a view at any strides): f32 through K4 with the phase-major store, an
    NHWC view of its (B, 4 O, Hf/2, Wf/2) planes; bf16 through
    ``dense_context_head`` and one ``_s2d`` of its bf16 logits."""
    w = _pack_weights(params, tuple(cfg.dilations))
    if cfg.compute_dtype == torch.bfloat16:
        out = _s2d(dense_context_head(feat, *w, tuple(cfg.dilations),
                                      act_dtype=torch.bfloat16, act_out=True))
        return out if act_out else out.to(torch.float32)
    xc = feat.to(torch.float32).permute(0, 3, 1, 2).contiguous()
    return fused_context_head(xc, *w, tuple(cfg.dilations), packed=True).permute(0, 2, 3, 1)


def packed_fused_trunk(params: dict, x_nhwc: torch.Tensor, cfg, raw_gray: bool = False,
                       act_out: bool = False) -> torch.Tensor:
    """The large-scan trunk with phase-major logits (B, H/8, W/8, 4 O) for
    ``postprocess_batch_fused(packed_phases=(2, 2))``; ``_d2s(result, O)``
    is ``fused_model_apply``'s logits.  On the card the direct trunk runs
    and only the logits' layout differs (``_packed_head``): in f32 the
    stem and K4, whose last launch stores phase-major (the same arithmetic
    as the unpacked route, so the same bits); in bf16 the dense route and
    one ``_s2d`` (the bf16 route's bits).  A CPU tensor takes the plain
    version, the JAX package's packed formulation
    (``packed_trunk_reference``).  bf16 logits with ``act_out`` in bf16,
    else f32."""
    if x_nhwc.device.type == "cpu":
        return packed_trunk_reference(params, x_nhwc, cfg, raw_gray, act_out)
    H, W = x_nhwc.shape[1:3]
    if H % 8 or W % 8:
        raise ValueError(f"the packed trunk needs H, W % 8 == 0, got {H}x{W}")
    with compute_precision(cfg):
        feat = _stem(params, x_nhwc, cfg, raw_gray).permute(0, 2, 3, 1)
        return _packed_head(params, feat, cfg, act_out)


def context_head_route_maybe_packed(params: dict, feat: torch.Tensor, cfg,
                                    large: bool | None = None, act_out: bool = False):
    """``context_head_route`` handing the logits over packed where the JAX
    package's s2d route fires (``_s2d_route_selected``): returns
    ``(logits, (2, 2))`` with phase-major (B, Hf/2, Wf/2, 4 O) logits
    there, else ``(context_head_route(...), None)``.  The packed logits
    come from ``_packed_head`` on the card and from ``s2d_context_head``
    on the CPU.  ``large`` defaults to the JAX package's Hf * Wf > 128²."""
    Hf, Wf = feat.shape[1:3]
    if large is None:
        large = Hf * Wf > 128 * 128
    if not _s2d_route_selected(cfg, Hf, Wf, large):
        return context_head_route(params, feat, cfg, act_out=act_out), None
    if feat.device.type != "cpu":
        return _packed_head(params, feat, cfg, act_out), (2, 2)
    bf16 = cfg.compute_dtype == torch.bfloat16
    w = _pack_weights(params, tuple(cfg.dilations))
    out = s2d_context_head(feat, *w, tuple(cfg.dilations),
                           act_dtype=torch.bfloat16 if bf16 else torch.float32,
                           unpack=False, act_out=act_out)
    return out, (2, 2)

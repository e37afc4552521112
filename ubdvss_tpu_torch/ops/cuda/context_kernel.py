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
    below the s2d route's sizes; ``s2d_context_head`` is the same conv on
    space-to-depth tensors for the TPU's matrix unit and is not ported
    (ROADMAP.md §1 item 7).

The pieces:

  * ``_pack_weights`` — the state_dict's context/head weights as the
    kernel's tensors, in the JAX package's shapes: dw (L, 9, C, 1, 1),
    pwt (L, C, C), pb (L, C, 1, 1), hwt (O, C), hb (O, 1, 1), all f32;
  * ``context_head_reference`` — the plain version of K4: 9 zero-filled
    shifted multiply-adds, the pointwise product, bias, ReLU per layer,
    then the 1x1 head;
  * ``fused_context_head`` — the K4 wrapper (one launch per layer, the
    head fused into the last, ``csrc/context_kernel.cu``), a
    ``torch.autograd.Function`` whose backward is autograd of the plain
    version, as the JAX package's ``custom_vjp``;
  * ``dense_context_head`` — each separable layer as one dense 3x3 dilated
    conv (cuDNN in bf16 with f32 accumulation, as XLA's conv in the JAX
    package), bias and ReLU as separate ops at the activation dtype;
  * ``stem_apply`` — the two stride-2 "SAME" convs (``F.conv2d``, as the
    JAX package leaves them to XLA), with the optional ``raw_gray`` fold of
    x/127.5 - 1 into the first conv, in either dtype;
  * ``context_head_route`` and ``fused_model_apply`` — the trunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ubdvss_tpu_torch.models.model import bf16_full_accumulation, conv2d_same, exact_f32
from ubdvss_tpu_torch.ops.ccl import _shift
from ubdvss_tpu_torch.ops.cuda import _build

# the context kernel's compiled channel counts and its head's output bound
# (csrc/context_kernel.cu)
KERNEL_CHANNELS = (8, 16, 24, 32)
MAX_HEAD_OUTPUTS = 32


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


_FUNCS = {"context_layer": [_build.P] * 7 + [_build.I] * 6 + [_build.P]}


def _launch_context_head(x_nchw, dw, pwt, pb, hwt, hb, dilations) -> torch.Tensor:
    """The K4 launches on a CUDA tensor: one a layer, the head fused into
    the last."""
    dev = x_nchw.device
    _build.check_input(x_nchw, "x", torch.float32, 4)
    B, C, H, W = x_nchw.shape
    L = len(dilations)
    O = hwt.shape[0]
    if L == 0:
        raise ValueError("the context kernel needs at least one context layer")
    for name, t, shape in (
        ("dw", dw, (L, 9, C, 1, 1)), ("pwt", pwt, (L, C, C)),
        ("pb", pb, (L, C, 1, 1)), ("hwt", hwt, (O, C)), ("hb", hb, (O, 1, 1)),
    ):
        _build.check_input(t, name, torch.float32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")
    if C not in KERNEL_CHANNELS or O > MAX_HEAD_OUTPUTS:
        raise NotImplementedError(
            f"C={C}, O={O}: the context kernel is compiled for C in {KERNEL_CHANNELS} "
            f"and O <= {MAX_HEAD_OUTPUTS} (ROADMAP.md §2a)"
        )
    lib = _build.load("context_kernel", _FUNCS)
    bufs = [torch.empty_like(x_nchw), torch.empty_like(x_nchw)] if L > 1 else []
    out = torch.empty((B, O, H, W), dtype=torch.float32, device=dev)
    cur = x_nchw
    for li, d in enumerate(dilations):
        last = li == L - 1
        dst = out if last else bufs[li % 2]
        _build.launch(
            lib, "context_layer", dev, cur.data_ptr(), dst.data_ptr(),
            dw[li].data_ptr(), pwt[li].data_ptr(), pb[li].data_ptr(),
            hwt.data_ptr() if last else None, hb.data_ptr() if last else None,
            B, C, H, W, int(d), O,
        )
        fused_context_head.launches += 1
        cur = dst
    return out


class _ContextHead(torch.autograd.Function):
    """K4 forward, and the gradient of its plain version backward: the JAX
    package's ``custom_vjp`` (``_fch_fwd`` / ``_fch_bwd``), whose backward
    is XLA's autodiff of ``context_head_reference``."""

    @staticmethod
    def forward(ctx, x_nchw, dw, pwt, pb, hwt, hb, dilations):
        ctx.dilations = dilations
        ctx.save_for_backward(x_nchw, dw, pwt, pb, hwt, hb)
        if x_nchw.device.type == "cpu":
            return context_head_reference(x_nchw, dw, pwt, pb, hwt, hb, dilations)
        return _launch_context_head(x_nchw, dw, pwt, pb, hwt, hb, dilations)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), exact_f32():
            out = context_head_reference(*inputs, ctx.dilations)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (*(next(grads) if t.requires_grad else None for t in inputs), None)


def fused_context_head(x_nchw, dw, pwt, pb, hwt, hb, dilations) -> torch.Tensor:
    """Context module + head: (B, C, H, W) f32 -> (B, O, H, W) f32 logits.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    per-layer kernel (the head fused into the last launch) or raises.
    Differentiable in every input: the backward is autograd of
    ``context_head_reference`` on the saved inputs in full f32, as the JAX
    package's VJP (``context_kernel.py:454-473``); ``launches`` counts the
    forward's kernel launches only.
    """
    return _ContextHead.apply(x_nchw, dw, pwt, pb, hwt, hb, tuple(dilations))


fused_context_head.launches = 0


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

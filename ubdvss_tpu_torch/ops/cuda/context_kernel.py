"""The fused separable context module + head (K4) and the f32 trunk.

Counterpart of ``ubdvss_tpu/ops/pallas/context_kernel.py`` on its f32
route for heatmaps up to 128x128 (``context_head_route``, :669-674):

  * ``_pack_weights`` — the state_dict's context/head weights as the
    kernel's tensors, in the JAX package's shapes: dw (L, 9, C, 1, 1),
    pwt (L, C, C), pb (L, C, 1, 1), hwt (O, C), hb (O, 1, 1);
  * ``context_head_reference`` — the plain version: 9 zero-filled shifted
    multiply-adds, the pointwise product, bias, ReLU per layer, then the
    1x1 head;
  * ``fused_context_head`` — the kernel wrapper (one launch per layer, the
    head fused into the last, ``csrc/context_kernel.cu``);
  * ``stem_apply`` — the two stride-2 "SAME" convs (``F.conv2d``, as the
    JAX package leaves them to XLA), with the optional ``raw_gray`` fold of
    x/127.5 - 1 into the first conv;
  * ``context_head_route`` and ``fused_model_apply`` — the trunk.

Everything runs in exact f32: ``exact_f32`` turns cuDNN's TF32 off and
refuses to run with TF32 matmuls enabled (the JAX reference runs at
``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ubdvss_tpu_torch.models.model import conv2d_same, exact_f32
from ubdvss_tpu_torch.ops.cuda import _build
from ubdvss_tpu_torch.ops.cuda.ccl_kernel import _shift

# largest feature map the f32 route serves (the JAX package's Pallas gate)
MAX_FEATURE_AREA = 128 * 128


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


def fused_context_head(x_nchw, dw, pwt, pb, hwt, hb, dilations) -> torch.Tensor:
    """Context module + head: (B, C, H, W) f32 -> (B, O, H, W) f32 logits.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    per-layer kernel (the head fused into the last launch) or raises.
    """
    if x_nchw.device.type == "cpu":
        return context_head_reference(x_nchw, dw, pwt, pb, hwt, hb, dilations)
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
    if C not in (8, 16, 24, 32) or O > 32:
        raise ValueError(f"context kernel takes C in (8, 16, 24, 32) and O <= 32, got {C}, {O}")
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


fused_context_head.launches = 0


def stem_apply(params: dict, x_nhwc: torch.Tensor, cfg, raw_gray: bool = False):
    """Downscale stem: two 3x3 stride-2 SAME convs + ReLU,
    (B, H, W, 1) -> (B, H/4, W/4, C) f32 features (an NHWC view).

    ``raw_gray=True``: the input is unnormalized grayscale [0, 255] and
    x/127.5 - 1 is folded into the first conv — conv(x/s - 1) =
    conv(x, k/s) - conv(ones, k), where conv(ones, k) is a constant map
    that is exact at the SAME borders, where fewer taps are in bounds.
    """
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: only the f32 route is ported; the bf16 "
            "route is ROADMAP.md §1 item 7"
        )
    x = x_nhwc.to(torch.float32).permute(0, 3, 1, 2)
    for i in range(2):
        w = params[f"downscale_{i}.weight"].to(torch.float32)
        b = params[f"downscale_{i}.bias"].to(torch.float32)
        if i == 0 and raw_gray:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=torch.float32, device=x.device)
            corr = conv2d_same(ones, w, None, stride=2)
            x = conv2d_same(x, w * (1.0 / 127.5), None, stride=2) - corr + b.view(1, -1, 1, 1)
        else:
            x = conv2d_same(x, w, b, stride=2)
        x = F.relu(x)
    return x.permute(0, 2, 3, 1)


def context_head_route(params: dict, feat: torch.Tensor, cfg) -> torch.Tensor:
    """Context module + 1x1 head over stem features (B, Hf, Wf, C) ->
    (B, Hf, Wf, O) logits (an NHWC view of the kernel's NCHW output)."""
    Hf, Wf = feat.shape[1], feat.shape[2]
    if Hf * Wf > MAX_FEATURE_AREA:
        raise NotImplementedError(
            f"{Hf}x{Wf} feature maps are the JAX package's large regime "
            "(dense/s2d context convs), ROADMAP.md §1 item 7"
        )
    dw, pwt, pb, hwt, hb = _pack_weights(params, tuple(cfg.dilations))
    xc = feat.permute(0, 3, 1, 2).contiguous()
    logits = fused_context_head(xc, dw, pwt, pb, hwt, hb, tuple(cfg.dilations))
    return logits.permute(0, 2, 3, 1)


def fused_model_apply(params: dict, x_nhwc: torch.Tensor, cfg, raw_gray: bool = False):
    """Full separable FCN forward with the fused context module + head,
    NHWC in / NHWC logits out; equals ``BarcodeFCN`` on the same weights."""
    if not cfg.separable_context:
        raise ValueError("fused path implements the separable context module")
    with exact_f32():
        feat = stem_apply(params, x_nhwc, cfg, raw_gray=raw_gray)
        return context_head_route(params, feat, cfg)

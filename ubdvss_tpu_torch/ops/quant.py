"""int8 quantized inference trunk (the JAX package's production serving mode).

Counterpart of ``ubdvss_tpu/ops/quant.py``: post-training quantization of
the FCN forward, symmetric int8 with per-output-channel weight scales and
per-channel activation scales from absmax calibration, the input scales
folded into each next kernel.  Every layer — the two stride-2 stem convs,
the context convs (each separable layer as its rank-1 dense kernel, or a
dense checkpoint's own kernel) and the 1x1 head — is an int8 x int8 ->
int32 conv, then dequant + bias + ReLU + requant to int8 (the head returns
f32 logits).  ``int8_trunk_apply`` runs them as ``qstem`` (layers 0 and
1), ``qconv`` (the context layers but the last) and ``qconv_head`` (the
last with the head): on the card the hand-written kernels of
``ops/cuda/qconv_kernel.py``, on the CPU their plain versions.

The calibration side (``trunk_intermediates``, ``_trunk_pre_relu``) runs
f32 convolutions with TF32 off (``exact_f32``), as the JAX package runs
them at ``Precision.HIGHEST``; the bias correction reads every layer's
pre-activation output, so it runs each layer alone, computing its
accumulator once as the JAX package does: ``qconv_layer_f32`` (one launch
a layer on the card, the s8 tensor cores; on the CPU the plain version)
gives ``acc * ws + b`` and the exact accumulator, and ``requantize``
turns the accumulator into the next layer's int8 input with the corrected
bias.  Rounding follows the JAX
package under ``jit``: ``acc * ws + b`` is one fused multiply-add
(``qconv_kernel``'s docstring), and so is ``normalize``'s
``x * (1/127.5) - 1`` on the int8 route (``normalize_fma``).

The qparams keep the JAX pytree's structure as torch tensors:
``{"layers": [{"q": HWIO int8, "ws": f32 (Co,), "b": f32 (Co,)}, ...],
"head": {...}, "s_in": [f32 (C,), ...]}``; ``s_in[i]`` are the
per-channel scales feeding layer i (``s_in[0]`` is the input's, [127.]).
``utils.checkpoint.qparams_from_numpy`` carries the JAX package's qparams
over.  Not ported: the packed int8 trunks (``int8_packed_trunk_apply``,
``int8_packed_trunk_tiled``), whose int32 accumulators equal the direct
trunk's bit for bit; the port runs the direct trunk at every size
(ROADMAP.md §1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from ubdvss_tpu_torch.models.model import conv2d_same, exact_f32
from ubdvss_tpu_torch.ops.cuda.qconv_kernel import (
    qconv,
    qconv_head,
    qconv_layer_f32,
    qstem,
    requantize,
)

_NORM_SCALE = float(np.float32(1.0 / 127.5))


def normalize_fma(x: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1] as ``x * (1/127.5) - 1`` rounded once, as the
    JAX package's jitted ``normalize`` computes it (one fused
    multiply-add): the f64 product of two 24-bit values is exact, and so is
    the sum.  The int8 route quantizes this value, so one ulp can move a
    pixel across a rounding boundary."""
    return (x.to(torch.float32).to(torch.float64) * _NORM_SCALE - 1.0).to(torch.float32)


def qparams_to(qparams: dict, device) -> dict:
    """The qparams with every tensor on ``device``."""
    def to(layer):
        return {k: v.to(device) for k, v in layer.items()}

    return {
        "layers": [to(layer) for layer in qparams["layers"]],
        "head": to(qparams["head"]),
        "s_in": [s.to(device) for s in qparams["s_in"]],
    }


def _qweight(k: torch.Tensor):
    """Per-output-channel symmetric int8 quantization of an HWIO kernel.

    Returns (q int8, scale f32 (O,)) with q = round(k / scale)."""
    absmax = k.abs().amax(dim=(0, 1, 2))
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def _hwio(params: dict, name: str) -> torch.Tensor:
    """The state_dict's OIHW kernel ``name`` as the JAX package's HWIO f32."""
    return params[f"{name}.weight"].to(torch.float32).permute(2, 3, 1, 0)


def _bias(params: dict, name: str) -> torch.Tensor:
    return params[f"{name}.bias"].to(torch.float32)


def _dense_context_kernels(params: dict, cfg) -> list:
    """The dense 3x3 HWIO kernels of the context module with their biases:
    the layer's own dense kernel (separable_context=False checkpoints) or
    the f32 rank-1 product of its depthwise and pointwise factors."""
    ks = []
    for li in range(len(cfg.dilations)):
        name = f"context_{li}"
        if f"{name}.depthwise.weight" in params:
            dw = _hwio(params, f"{name}.depthwise")  # 3,3,1,C
            pw = _hwio(params, f"{name}.pointwise")  # 1,1,C,C
            C = pw.shape[-1]
            # k[ty,tx,ci,co] = dw[ty,tx,ci] * pw[ci,co]
            k = dw[:, :, 0, :].reshape(3, 3, C, 1) * pw[0, 0].reshape(1, 1, C, C)
            ks.append((k, _bias(params, f"{name}.pointwise")))
        else:
            ks.append((_hwio(params, name), _bias(params, name)))
    return ks


def _trunk_kernels(params: dict, cfg) -> list:
    """(HWIO kernel, bias) of every quantized layer, head last."""
    return (
        [(_hwio(params, f"downscale_{i}"), _bias(params, f"downscale_{i}")) for i in range(2)]
        + _dense_context_kernels(params, cfg)
        + [(_hwio(params, "head"), _bias(params, "head"))]
    )


def _conv_specs(cfg) -> list:
    """(stride, dilation) per quantized layer, matching the trunk chain."""
    return [(2, 1), (2, 1)] + [(1, d) for d in cfg.dilations]


def _f32_conv(x_nchw, k_hwio, b, stride, dil):
    """conv(x, k) + b in f32 (the bias added after the conv, as in JAX)."""
    y = conv2d_same(x_nchw, k_hwio.permute(3, 2, 0, 1), None, stride, dil)
    return y + b.view(1, -1, 1, 1)


def _trunk_pre_relu(params: dict, x_nhwc: torch.Tensor, cfg) -> list:
    """f32 reference PRE-activation outputs of every trunk layer (conv +
    bias before ReLU; the last entry is the logits), as NHWC views — the
    bias-correction targets."""
    pre = []
    x = x_nhwc.to(torch.float32).permute(0, 3, 1, 2)
    specs = _conv_specs(cfg) + [(1, 1)]
    with exact_f32():
        for (k, b), (st, dil) in zip(_trunk_kernels(params, cfg), specs):
            y = _f32_conv(x, k, b, st, dil)
            pre.append(y.permute(0, 2, 3, 1))
            x = torch.relu(y)
    return pre


def trunk_intermediates(params: dict, x_nhwc: torch.Tensor, cfg):
    """f32 reference forward returning every post-ReLU activation (for
    absmax calibration) plus the logits, NHWC.  x: normalized (B, H, W, 1)."""
    pre = _trunk_pre_relu(params, x_nhwc, cfg)
    return [torch.relu(y) for y in pre[:-1]], pre[-1]


def _calib_tiles(calib_images: torch.Tensor) -> torch.Tensor:
    """Cut calibration images into <=512^2 tiles, as the JAX package does
    (absmax and mean statistics are translation-invariant conv outputs)."""
    N, H, W = calib_images.shape[:3]
    if max(H, W) <= 512:
        return calib_images
    th, tw = min(H, 512), min(W, 512)
    ny, nx = H // th, W // tw
    return (
        calib_images[:, : ny * th, : nx * tw]
        .reshape(N, ny, th, nx, tw, 1)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(N * ny * nx, th, tw, 1)
    )


def calibrate_scales(params: dict, cfg, calib_images: torch.Tensor, margin: float = 1.3) -> list:
    """Per-layer per-channel activation requant scales from absmax over the
    calibration pool (normalized (N, H, W, 1) f32).  Merge pools of
    different image shapes with an elementwise ``torch.minimum`` over the
    per-layer vectors, then ``build_qparams``."""
    acts, _ = trunk_intermediates(params, _calib_tiles(calib_images), cfg)
    return [torch.full((1,), 127.0, device=calib_images.device)] + [
        127.0 / (margin * torch.clamp(a.abs().amax(dim=(0, 1, 2)), min=1e-12)) for a in acts
    ]


def build_qparams(params: dict, cfg, a_scales) -> dict:
    """Quantize the weights against the given activation scales: each
    layer's input scales fold into its kernel's input-channel axis before
    the per-output-channel weight quantization."""
    layers = []
    for (k, b), s_in in zip(_trunk_kernels(params, cfg), a_scales):
        q, ws = _qweight(k / s_in[None, None, :, None])
        layers.append(dict(q=q.contiguous(), ws=ws, b=b.contiguous()))
    return {"layers": layers[:-1], "head": layers[-1], "s_in": list(a_scales)}


def bias_correct_qparams(qparams: dict, params: dict, cfg, calib_images: torch.Tensor) -> dict:
    """Sequential PTQ bias correction: walk the quantized trunk over the
    calibration set and fold, layer by layer, the per-output-channel mean
    error against the f32 pre-activation into the bias, every earlier layer
    already corrected.  Only the f32 biases change.  Each layer's
    accumulator is computed once: its pre-activation and its requantized
    output both come from it."""
    pre = _trunk_pre_relu(params, calib_images, cfg)
    s = qparams["s_in"]
    qx = calib_images.to(torch.float32)  # layer 0 quantizes it (normalized)
    layers = []
    for i, (st, dil) in enumerate(_conv_specs(cfg)):
        L = qparams["layers"][i]
        y, acc = qconv_layer_f32(qx, L, st, dil)  # acc * ws + b (one rounding), acc
        b = L["b"] + torch.mean(pre[i] - y, dim=(0, 1, 2))
        layers.append(dict(q=L["q"], ws=L["ws"], b=b))
        qx = requantize(acc, L["ws"], b, s[i + 1])  # with the corrected bias
    H = qparams["head"]
    y, _ = qconv_layer_f32(qx, H, 1, 1, with_acc=False)
    head = dict(q=H["q"], ws=H["ws"], b=H["b"] + torch.mean(pre[-1] - y, dim=(0, 1, 2)))
    return {"layers": layers, "head": head, "s_in": s}


def quantize_trunk(
    params: dict, cfg, calib_images: torch.Tensor, margin: float = 1.3,
    bias_correct: bool = True,
) -> dict:
    """Post-training calibration + weight quantization on the device of
    ``params`` and ``calib_images`` (normalized (N, H, W, 1) f32 in
    [-1, 1]).  Returns the qparams ``int8_trunk_apply`` takes; ``margin``
    head-rooms the calibration absmax, ``bias_correct`` folds the mean
    quantization error on the calibration set into the biases."""
    qp = build_qparams(params, cfg, calibrate_scales(params, cfg, calib_images, margin))
    if bias_correct:
        qp = bias_correct_qparams(qp, params, cfg, _calib_tiles(calib_images))
    return qp


def int8_trunk_apply(qparams: dict, x: torch.Tensor, cfg, raw_gray: bool = False) -> torch.Tensor:
    """Quantized FCN forward: images -> f32 logits (B, H/4, W/4, 1+n_cls).

    x: normalized (B, H, W, 1) f32 in [-1, 1], or with ``raw_gray`` raw
    [0, 255] grayscale (B, H, W), uint8 or f32 — the normalize folds into
    the input quantization of layer 0.  On the card 1 + len(dilations)
    launches: ``qstem`` (layers 0 and 1), ``qconv`` for each context layer
    but the last, ``qconv_head`` for the last with the head."""
    s = qparams["s_in"]
    L = qparams["layers"]
    n = len(cfg.dilations)
    qx = qstem(x, L[0], s[1], L[1], s[2], raw_gray=raw_gray)
    for li, d in enumerate(cfg.dilations[:-1]):
        qx = qconv(qx, L[2 + li], s[3 + li], d)
    return qconv_head(qx, L[1 + n], s[2 + n], cfg.dilations[-1], qparams["head"])

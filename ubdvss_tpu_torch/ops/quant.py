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
over.

The packed int8 trunks (``int8_packed_trunk_apply``,
``int8_packed_trunk_tiled``: the JAX package's large-scan int8 route,
``quant.py:332-425``) hand phase-major (B, H/8, W/8, 4 O) logits to
``postprocess_batch_fused(packed_phases=(2, 2))``.  Their plain version,
which a CPU tensor takes, is the JAX formulation: the original int8
kernels placed block-wise into (3, 3, 4C, 4C) kernels (``_packed_layer``)
on s=2 space-to-depth maps, whose int32 accumulators equal the direct
trunk's bit for bit.  On the card the direct chain runs instead (no
96-channel int8 conv), ``qconv_head`` storing its logits phase-major.

Any channel width runs on the card: the kernels take a multiple of 4 (past
32 their any-width instances), so ``int8_trunk_apply`` pads the qparams
once (``kernel_qparams``: zero weights, and for the padded outputs ws = 1,
b = 0, s_out = 1, exact zeros) and keeps the padded activations between
its launches; the logits come out at the head's own width.  The qparams
themselves keep the JAX package's shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from ubdvss_tpu_torch.models.model import conv2d_same, exact_f32
from ubdvss_tpu_torch.ops.cuda.context_kernel import (
    _d2s,
    _pack_s2d_kernel,
    _pack_stride2_kernel,
    _s2d,
)
from ubdvss_tpu_torch.ops.cuda.qconv_kernel import (
    pad_layer,
    pad_scale,
    qconv,
    qconv_head,
    qconv_layer_f32,
    qconv_reference,
    qstem,
    quantize_input,
    requantize,
)
from ubdvss_tpu_torch.ops.strips import packed_trunk_tile_grid, tile_2d_logits

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


def kernel_qparams(qparams: dict) -> dict:
    """The qparams at the channel counts the card's int8 kernels take:
    each layer's outputs (and the next layer's inputs) padded to a
    multiple of 4 with ``pad_layer`` / ``pad_scale`` (exact zeros in the
    padded channels), the head's logits as they are.  The qparams
    themselves where nothing needs padding."""
    L = qparams["layers"]
    widths = [-(-layer["q"].shape[3] // 4) * 4 for layer in L]
    if all(w == layer["q"].shape[3] for w, layer in zip(widths, L)):
        return qparams
    layers, cin = [], 1
    for layer, w in zip(L, widths):
        layers.append(pad_layer(layer, cin, w))
        cin = w
    s = qparams["s_in"]
    return {"layers": layers, "head": pad_layer(qparams["head"], cin, qparams["head"]["q"].shape[3]),
            "s_in": [s[0]] + [pad_scale(v, w) for v, w in zip(s[1:], widths)]}


def int8_trunk_apply(qparams: dict, x: torch.Tensor, cfg, raw_gray: bool = False,
                     packed: bool = False) -> torch.Tensor:
    """Quantized FCN forward: images -> f32 logits (B, H/4, W/4, 1+n_cls),
    or with ``packed`` phase-major (B, H/8, W/8, 4 (1+n_cls)).

    x: normalized (B, H, W, 1) f32 in [-1, 1], or with ``raw_gray`` raw
    [0, 255] grayscale (B, H, W), uint8 or f32 — the normalize folds into
    the input quantization of layer 0.  On the card 1 + len(dilations)
    launches: ``qstem`` (layers 0 and 1), ``qconv`` for each context layer
    but the last, ``qconv_head`` for the last with the head, at the
    widths of ``kernel_qparams``."""
    if x.device.type != "cpu":
        qparams = kernel_qparams(qparams)
    s = qparams["s_in"]
    L = qparams["layers"]
    n = len(cfg.dilations)
    qx = qstem(x, L[0], s[1], L[1], s[2], raw_gray=raw_gray)
    for li, d in enumerate(cfg.dilations[:-1]):
        qx = qconv(qx, L[2 + li], s[3 + li], d)
    return qconv_head(qx, L[1 + n], s[2 + n], cfg.dilations[-1], qparams["head"], packed=packed)


def _packed_layer(layer: dict, pack_fn, s_out):
    """One quantized layer's int8 kernel packed by ``pack_fn``
    (``_pack_stride2_kernel`` or ``_pack_s2d_kernel``), its per-channel
    vectors tiled 4x for the phase-major output channels: (layer, s_out,
    packed dilation or None).  The packed kernels hold the original int8
    values in disjoint blocks and zeros elsewhere, so every packed int32
    accumulator equals its unpacked one."""
    packed = pack_fn(layer["q"])
    kp, dil = packed if isinstance(packed, tuple) else (packed, None)
    return (
        dict(q=kp, ws=layer["ws"].repeat(4), b=layer["b"].repeat(4)),
        None if s_out is None else s_out.repeat(4),
        dil,
    )


def int8_packed_trunk_reference(qparams: dict, x: torch.Tensor, cfg,
                                raw_gray: bool = False) -> torch.Tensor:
    """Plain version of the packed int8 trunk, the JAX package's
    formulation: the quantized image packed s=2, the two stem layers as
    stride-2 packed convs with explicit ((0, 1), (0, 1)) padding, the
    context layers on (3, 3, 4C, 4C) packed kernels, the head
    block-diagonal over the phases, each through ``qconv_reference`` (the
    exact int32 accumulator).  -> phase-major (B, H/8, W/8, 4 O) f32."""
    qx = _s2d(quantize_input(x, raw_gray))  # (B, H/2, W/2, 4) int8
    s = qparams["s_in"]
    L = qparams["layers"]
    pad = ((0, 1), (0, 1))
    for i in range(2):
        layer, s_out, _ = _packed_layer(L[i], _pack_stride2_kernel, s[i + 1])
        qx = qconv_reference(qx, layer, s_out, 2, 1, padding=pad)
    for li, d in enumerate(cfg.dilations):
        layer, s_out, dp = _packed_layer(L[2 + li], lambda k, d=d: _pack_s2d_kernel(k, d),
                                         s[3 + li])
        qx = qconv_reference(qx, layer, s_out, 1, dp)
    hq = qparams["head"]["q"]  # (1, 1, C, O) int8
    C, O = hq.shape[2], hq.shape[3]
    KH = hq.new_zeros((1, 1, 4 * C, 4 * O))
    for p in range(4):
        KH[0, 0, p * C:(p + 1) * C, p * O:(p + 1) * O] = hq[0, 0]
    head = dict(q=KH, ws=qparams["head"]["ws"].repeat(4), b=qparams["head"]["b"].repeat(4))
    return qconv_reference(qx, head, None, 1, 1)


def int8_packed_trunk_apply(qparams: dict, x: torch.Tensor, cfg, raw_gray: bool = False,
                            unpack: bool = False) -> torch.Tensor:
    """The large-scan int8 trunk: images (as ``int8_trunk_apply``, H and W
    divisible by 8) -> phase-major logits (B, H/8, W/8, 4 O) for
    ``postprocess_batch_fused(packed_phases=(2, 2))``, or with ``unpack``
    their ``_d2s``, (B, H/4, W/4, O).  Bit for bit the direct trunk's
    logits.  On the card the direct chain, ``qconv_head`` storing
    phase-major; a CPU tensor takes ``int8_packed_trunk_reference``."""
    H, W = x.shape[1:3]
    if H % 8 or W % 8:
        raise ValueError(f"the packed int8 trunk needs H, W % 8 == 0, got {H}x{W}")
    if x.device.type == "cpu":
        out = int8_packed_trunk_reference(qparams, x, cfg, raw_gray)
    else:
        out = int8_trunk_apply(qparams, x, cfg, raw_gray=raw_gray, packed=True)
    return _d2s(out, out.shape[-1] // 4) if unpack else out


def int8_packed_trunk_tiled(qparams: dict, x: torch.Tensor, cfg, raw_gray: bool = False,
                            grid: tuple[int, int] | None = None) -> torch.Tensor:
    """``int8_packed_trunk_apply`` tiled at the image level for >=4096 px
    axes (``strips.packed_trunk_tile_grid``; identity below): bit for bit
    the untiled trunk's phase-major logits, the tiles' halos covering the
    receptive field."""
    halo, auto = packed_trunk_tile_grid(x.shape[1], x.shape[2], cfg)
    fn = lambda t: int8_packed_trunk_apply(qparams, t, cfg, raw_gray=raw_gray)  # noqa: E731
    return tile_2d_logits(fn, x, 8, halo, auto if grid is None else grid)

"""One layer of the int8 trunk: plain version and CUDA kernel.

Counterpart of the JAX package's ``_qconv`` and ``_quantize_input``
(``ubdvss_tpu/ops/quant.py:276-292``, :315-329), which XLA compiles: an
int8 x int8 -> int32 convolution (3x3 stride 2, 3x3 stride 1 with
dilation d, or 1x1), then ``acc * ws + b``, and for every layer but the
head ReLU and the requantization ``clip(round(y * s_out), -127, 127)`` to
int8.  Layer 0 reads the image (one channel) and quantizes it on the fly.

Rounding as the JAX package rounds under ``jit``, where XLA's CPU compiler
fuses ``acc * ws + b`` (and the raw input's ``x * (127/127.5) - 127``)
into one fused multiply-add:

  * the card (``csrc/qconv_kernel.cu``) writes ``fmaf`` explicitly;
  * the plain version (``qconv_reference``) takes the exact product in
    f64 and rounds the sum to f32 once.  f32(acc) and ``ws`` have 24
    significant bits each, so the product is exact in f64; the sum is
    exact while |b| and |acc * ws| lie within 2^29 of each other (or one
    is 0), which holds far beyond any layer's weights.

``round`` is half to even everywhere (``torch.round``, ``rintf``,
``jnp.round``).  The plain version's convolution runs in f64 on the int8
values, where every partial sum is an integer below 2^53, so it is exact
at any width, in any summation order (cuDNN is switched off for it on the
card: its FFT and Winograd algorithms would not keep the sums exact).

Layouts are the JAX package's: activations NHWC, kernels HWIO int8.  The
kernel packs its weight words itself, so a layer's tensors go to it as
they are.  ``qconv`` counts its launches in ``qconv.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from ubdvss_tpu_torch.models.model import conv2d_same, same_pad
from ubdvss_tpu_torch.ops.cuda import _build

# the kernel's channel caps (csrc/qconv_kernel.cu): input channels a
# multiple of 4 up to 32, outputs up to 32 (a multiple of 4 when int8)
MAX_CHANNELS = 32

# the input quantization's constants as the JAX package rounds them to f32
_RAW_SCALE = float(np.float32(127.0 / 127.5))


def quantize_input(x: torch.Tensor, raw_gray: bool) -> torch.Tensor:
    """The JAX package's ``_quantize_input``: normalized f32 (B, H, W[, 1])
    in [-1, 1], or with ``raw_gray`` raw [0, 255] grayscale (B, H, W), ->
    int8 (B, H, W, 1).  The raw recipe ``x * (127/127.5) - 127`` is rounded
    once (an exact f64 product and sum, then f32), as under ``jit``."""
    x = x.to(torch.float32)
    if raw_gray:
        y = (x.to(torch.float64) * _RAW_SCALE - 127.0).to(torch.float32)
    else:
        y = x * 127.0
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8).reshape(x.shape[:3] + (1,))


def qconv_reference(
    x: torch.Tensor, layer: dict, s_out: torch.Tensor | None, stride: int, dil: int,
    raw_gray: bool = False,
) -> torch.Tensor:
    """Plain version of one layer: int8 (B, H, W, Cin) -> int8 (B, Ho, Wo,
    Cout), or f32 logits when ``s_out`` is None.  A non-int8 ``x`` is the
    image of layer 0 and is quantized first (``quantize_input``)."""
    if x.dtype != torch.int8:
        x = quantize_input(x, raw_gray)
    k = layer["q"].permute(3, 2, 0, 1).to(torch.float64)  # HWIO -> OIHW
    with torch.backends.cudnn.flags(enabled=False):
        acc = conv2d_same(x.permute(0, 3, 1, 2).to(torch.float64), k, None, stride, dil)
    # (float)acc, then the exact f64 product plus the bias, rounded once
    acc = acc.to(torch.float32).to(torch.float64)
    ws = layer["ws"].to(torch.float64).view(1, -1, 1, 1)
    b = layer["b"].to(torch.float64).view(1, -1, 1, 1)
    y = (acc * ws + b).to(torch.float32)
    if s_out is not None:
        r = torch.round(torch.clamp(y, min=0.0) * s_out.to(torch.float32).view(1, -1, 1, 1))
        y = torch.clamp(r, -127, 127).to(torch.int8)
    return y.permute(0, 2, 3, 1).contiguous()


_FUNCS = {"qconv_layer": [_build.P] * 6 + [_build.I] * 13 + [_build.P]}
_IN_INT8, _IN_U8_RAW, _IN_F32_RAW, _IN_F32_NORM = range(4)


def qconv(
    x: torch.Tensor, layer: dict, s_out: torch.Tensor | None, stride: int, dil: int,
    raw_gray: bool = False,
) -> torch.Tensor:
    """One layer of the int8 trunk (see ``qconv_reference``).

    ``x``: int8 NHWC activations; or, for layer 0, the image — raw
    grayscale (B, H, W) uint8 or f32 with ``raw_gray``, else normalized f32
    (B, H, W[, 1]).  ``layer``: {q: HWIO int8 (k, k, Cin, Cout), ws, b: f32
    (Cout,)}.  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises.
    """
    if x.device.type == "cpu":
        return qconv_reference(x, layer, s_out, stride, dil, raw_gray)
    dev = x.device
    q, ws, b = layer["q"], layer["ws"], layer["b"]
    _build.check_input(q, "q", torch.int8, 4, dev)
    ks, _, Cin, Cout = q.shape
    if x.dtype == torch.int8:
        _build.check_input(x, "x", torch.int8, 4)
        kind = _IN_INT8
        if x.shape[-1] != Cin:
            raise ValueError(f"x has {x.shape[-1]} channels, the kernel {Cin}")
    else:
        if x.ndim == 4 and x.shape[-1] == 1:
            x = x[..., 0]
        if x.dtype == torch.uint8 and not raw_gray:
            raise ValueError("a uint8 image is raw grayscale: pass raw_gray=True")
        _build.check_input(x, "x", x.dtype if x.dtype == torch.uint8 else torch.float32, 3)
        kind = _IN_U8_RAW if x.dtype == torch.uint8 else (_IN_F32_RAW if raw_gray else _IN_F32_NORM)
        if Cin != 1:
            raise ValueError(f"an image has one channel, the kernel {Cin}")
    if ks != q.shape[1] or ks not in (1, 3) or (kind != _IN_INT8 and ks != 3):
        raise ValueError(f"kernel {tuple(q.shape)}: expected 3x3 (1x1 on int8 input)")
    vecs = (("ws", ws), ("b", b)) + ((("s_out", s_out),) if s_out is not None else ())
    for name, t in vecs:
        _build.check_input(t, name, torch.float32, 1, dev)
        if t.shape[0] != Cout:
            raise ValueError(f"{name}: expected ({Cout},), got {tuple(t.shape)}")
    if (kind == _IN_INT8 and (Cin % 4 or Cin > MAX_CHANNELS)) or Cout > MAX_CHANNELS or (
        s_out is not None and Cout % 4
    ):
        raise NotImplementedError(
            f"Cin={Cin}, Cout={Cout}: the int8 conv kernel takes input channels a multiple "
            f"of 4 up to {MAX_CHANNELS} and at most {MAX_CHANNELS} outputs, a multiple of 4 "
            "when they are int8 (ROADMAP.md §2a)"
        )
    B, H, W = x.shape[:3]
    ph = same_pad(H, ks, stride, dil)
    pw = same_pad(W, ks, stride, dil)
    Ho, Wo = -(-H // stride), -(-W // stride)  # SAME
    out = torch.empty(
        (B, Ho, Wo, Cout), dtype=torch.float32 if s_out is None else torch.int8, device=dev
    )
    lib = _build.load("qconv_kernel", _FUNCS)
    _build.launch(
        lib, "qconv_layer", dev, x.data_ptr(), q.data_ptr(), ws.data_ptr(), b.data_ptr(),
        None if s_out is None else s_out.data_ptr(), out.data_ptr(), kind, B, H, W, Cin,
        Ho, Wo, Cout, ks, stride, dil, ph[0], pw[0],
    )
    qconv.launches += 1
    return out


qconv.launches = 0

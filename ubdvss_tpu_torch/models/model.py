"""The dilated-convolution context-module FCN as a torch ``nn.Module``.

Counterpart of ``ubdvss_tpu/models/model.py`` (paper arXiv:1906.06281
§3.2): two 3x3 stride-2 downscale convs (output stride 4), a stack of 3x3
dilated context convs — depthwise-separable or dense — with ReLU, and a
1x1 head giving 1 detection logit + n_classes classification logits.

Parameter names follow the flax module (``downscale_0``, ``context_3``,
``context_3.depthwise``, ``head``), so ``utils.checkpoint.params_from_flat``
maps the JAX package's weight files straight onto ``state_dict()``.

Layout: the module takes and returns NHWC tensors like the JAX model; it
computes in NCHW inside.  Padding is TF "SAME": a 3x3 stride-2 conv on an
even size pads 0 before and 1 after (torch's ``padding=1`` would pad 1 and
1), a dilated stride-1 conv pads ``d`` on both sides.

Two compute dtypes, as ``NetConfig.dtype`` names them:

  * float32, the parity mode: every conv in full f32 (``exact_f32``; the
    JAX package runs at ``Precision.HIGHEST``);
  * bfloat16, the throughput mode, with flax's semantics: the input and
    every kernel are cast to bf16, each conv takes bf16 operands and
    accumulates in f32 (``Precision.DEFAULT``) with a bf16 result, the bias
    is cast to bf16 and added after the conv in bf16, ReLU runs in bf16 and
    the head's output is cast to f32.  The separable layer's depthwise
    output is a bf16 tensor before the pointwise conv.

``dense_equivalent_apply`` is the JAX function of that name: each
separable layer as its rank-1-expanded dense conv.

Training (``init_params``, ``train_apply``) takes the parameters as one
dict of leaf tensors in ``state_dict`` layout, which both routes read:
the module through ``torch.func.functional_call``, the dense equivalent
directly.  ``compute_precision`` is the numerics context of a config;
the train step holds it over the backward too, since a forward's own
context has exited by the time ``backward`` runs.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from ubdvss_tpu_torch.net_config import NetConfig


@contextlib.contextmanager
def bf16_full_accumulation():
    """bf16 matmuls on the card reduce in f32 for the block
    (``allow_bf16_reduced_precision_reduction`` off, then restored), as the
    JAX package's bf16 convs accumulate in f32."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev


@contextlib.contextmanager
def exact_f32():
    """Full-f32 convolutions and matmuls on the card: cuDNN TF32 off for the
    block; TF32 matmuls (``torch.backends.cuda.matmul.allow_tf32``) are
    refused rather than silently changed back."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: the f32 route "
            "needs full-f32 matmuls (set it to False)"
        )
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def compute_precision(cfg: NetConfig):
    """The context a config's convs run in: ``exact_f32`` (TF32 off) for
    float32; for bfloat16 also ``bf16_full_accumulation``.  Enter it around
    the forward AND the backward of a train step."""
    stack = contextlib.ExitStack()
    stack.enter_context(exact_f32())
    if cfg.compute_dtype == torch.bfloat16:
        stack.enter_context(bf16_full_accumulation())
    return stack


def same_pad(n: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """(before, after) padding of TF "SAME" along one axis of size n."""
    out = -(-n // s)
    total = max((out - 1) * s + d * (k - 1) + 1 - n, 0)
    return total // 2, total - total // 2


def conv2d_same(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
    stride: int = 1, dilation: int = 1, groups: int = 1,
) -> torch.Tensor:
    """NCHW conv with TF "SAME" padding (zero fill)."""
    kh, kw = w.shape[-2:]
    ph = same_pad(x.shape[-2], kh, stride, dilation)
    pw = same_pad(x.shape[-1], kw, stride, dilation)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride, (ph[0], pw[0]), dilation, groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride, 0, dilation, groups)


class SeparableConv(nn.Module):
    """Depthwise 3x3 (dilated) + pointwise 1x1 convolution."""

    def __init__(self, channels: int, features: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.depthwise = nn.Conv2d(channels, channels, 3, groups=channels, bias=False)
        self.pointwise = nn.Conv2d(channels, features, 1)

    def forward(self, x):
        x = conv2d_same(
            x, self.depthwise.weight, None, dilation=self.dilation,
            groups=x.shape[1],
        )
        return self.pointwise(x)


class BarcodeFCN(nn.Module):
    """Downscale convs + dilated context module + 1x1 head.

    Input:  (B, H, W, 1) float images, H and W divisible by 4.
    Output: (B, H/4, W/4, 1 + n_classes) f32 logits (NHWC).

    ``dtype``: the compute dtype (the module docstring); the parameters
    stay f32, and bf16 weights load into them exactly.
    """

    def __init__(
        self,
        channels: int = 24,
        dilations: tuple[int, ...] = (1, 1, 2, 4, 8, 16, 1),
        separable_context: bool = True,
        n_output_channels: int = 17,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: expected torch.float32 or torch.bfloat16")
        self.dtype = dtype
        self.dilations = tuple(dilations)
        self.separable_context = separable_context
        self.downscale_0 = nn.Conv2d(1, channels, 3)
        self.downscale_1 = nn.Conv2d(channels, channels, 3)
        for i, d in enumerate(self.dilations):
            layer = (
                SeparableConv(channels, channels, d)
                if separable_context
                else nn.Conv2d(channels, channels, 3)
            )
            self.add_module(f"context_{i}", layer)
        self.head = nn.Conv2d(channels, n_output_channels, 1)

    @classmethod
    def from_config(cls, cfg: NetConfig) -> "BarcodeFCN":
        return cls(
            channels=cfg.channels,
            dilations=tuple(cfg.dilations),
            separable_context=cfg.separable_context,
            n_output_channels=cfg.n_output_channels,
            dtype=cfg.compute_dtype,
        )

    def forward(self, x_nhwc: torch.Tensor, boundary_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, H, W, 1) images -> (B, H/4, W/4, C) f32 logits.

        ``boundary_mask``: optional (B, H, W, 1) 0/1 floats marking the
        pixels inside the global image when x is a halo-padded tile of a
        larger one (``parallel/tiling.py``).  It multiplies the input, the
        activation after each downscale ReLU (subsampled [::2, ::2] with
        it) and after each context ReLU, so tile borders reproduce the
        whole image's SAME padding; None adds no op.
        """
        if self.dtype == torch.bfloat16:
            with bf16_full_accumulation():
                return self._forward_bf16(x_nhwc, boundary_mask)
        with exact_f32():
            return self._forward(x_nhwc, boundary_mask)

    def _forward_bf16(self, x_nhwc: torch.Tensor, boundary_mask=None) -> torch.Tensor:
        bf = torch.bfloat16

        def conv(x, layer, stride=1, dilation=1, groups=1):
            y = conv2d_same(x, layer.weight.to(bf), None, stride, dilation, groups)
            if layer.bias is None:
                return y
            return y + layer.bias.to(bf).view(1, -1, 1, 1)

        x = x_nhwc.to(bf).permute(0, 3, 1, 2)
        m = None
        if boundary_mask is not None:
            m = boundary_mask.to(bf).permute(0, 3, 1, 2).contiguous()
            x = x * m
        for layer in (self.downscale_0, self.downscale_1):
            x = F.relu(conv(x, layer, stride=2))
            if m is not None:
                m = m[:, :, ::2, ::2].contiguous()
                x = x * m
        for i, d in enumerate(self.dilations):
            layer = getattr(self, f"context_{i}")
            if self.separable_context:
                x = conv(x, layer.depthwise, dilation=d, groups=x.shape[1])
                x = conv(x, layer.pointwise)
            else:
                x = conv(x, layer, dilation=d)
            x = F.relu(x)
            if m is not None:
                x = x * m
        x = conv(x, self.head)
        return x.to(torch.float32).permute(0, 2, 3, 1)

    def _forward(self, x_nhwc: torch.Tensor, boundary_mask=None) -> torch.Tensor:
        # NCHW with standard strides: a contiguous one-channel NHWC batch,
        # permuted, also reads as channels-last, and then the depthwise
        # convs and their gradients take cuDNN's grouped kernels, 1.8x the
        # step's time at B=128 512² on the H100
        x = x_nhwc.to(torch.float32).permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
        m = None
        if boundary_mask is not None:
            m = boundary_mask.to(torch.float32).permute(0, 3, 1, 2).contiguous()
            x = x * m
        for conv in (self.downscale_0, self.downscale_1):
            x = F.relu(conv2d_same(x, conv.weight, conv.bias, stride=2))
            if m is not None:
                m = m[:, :, ::2, ::2].contiguous()
                x = x * m
        for i, d in enumerate(self.dilations):
            layer = getattr(self, f"context_{i}")
            if self.separable_context:
                x = layer(x)
            else:
                x = conv2d_same(x, layer.weight, layer.bias, dilation=d)
            x = F.relu(x)
            if m is not None:
                x = x * m
        x = self.head(x)
        return x.permute(0, 2, 3, 1)


def get_model(cfg: NetConfig) -> BarcodeFCN:
    """Model-builder entry point mirroring the JAX package's API."""
    return BarcodeFCN.from_config(cfg)


def dense_equivalent_apply(params: dict, x_nhwc: torch.Tensor, cfg: NetConfig) -> torch.Tensor:
    """``get_model(cfg)`` on the state_dict ``params`` with each separable
    context layer computed as its rank-1-expanded dense conv, kernel[co, ci]
    = depthwise[ci] * pointwise[co, ci]: the same linear map, in the dtype
    regime of the model.  As in the JAX function, both factors are cast to
    the compute dtype and multiplied in it (a bf16 product in the bf16
    mode), and each bias is added after its conv in that dtype.  NHWC in,
    (B, H/4, W/4, O) f32 logits out."""
    dt = cfg.compute_dtype
    ctx = bf16_full_accumulation() if dt == torch.bfloat16 else exact_f32()

    def conv(x, w, b, stride=1, dilation=1):
        return conv2d_same(x, w.to(dt), None, stride, dilation) + b.to(dt).view(1, -1, 1, 1)

    with ctx:
        x = x_nhwc.to(dt).permute(0, 3, 1, 2)
        for i in range(2):
            x = F.relu(conv(x, params[f"downscale_{i}.weight"], params[f"downscale_{i}.bias"], 2))
        for i, d in enumerate(cfg.dilations):
            if cfg.separable_context:
                dw = params[f"context_{i}.depthwise.weight"].to(dt)  # (C, 1, 3, 3)
                pw = params[f"context_{i}.pointwise.weight"].to(dt)  # (C, C, 1, 1)
                k = dw[None, :, 0] * pw[:, :, 0, 0, None, None]  # (Co, Ci, 3, 3)
                b = params[f"context_{i}.pointwise.bias"]
            else:
                k = params[f"context_{i}.weight"]
                b = params[f"context_{i}.bias"]
            x = F.relu(conv(x, k, b, dilation=d))
        x = conv(x, params["head.weight"], params["head.bias"])
        return x.to(torch.float32).permute(0, 2, 3, 1)


def param_count(params: dict) -> int:
    """Number of scalars in a state_dict (or any dict of tensors/arrays)."""
    return sum(math.prod(v.shape) for v in params.values())


@functools.lru_cache(maxsize=None)
def _template(cfg: NetConfig) -> BarcodeFCN:
    """A parameterless (meta-device) module of ``cfg``'s architecture, the
    computation ``train_apply`` calls with given parameters."""
    with torch.device("meta"):
        return get_model(cfg)


def init_params(cfg: NetConfig, seed: int = 0) -> dict[str, torch.Tensor]:
    """Fresh f32 parameters for ``get_model(cfg)`` (CPU tensors, state_dict
    layout), with flax's default initializers as the JAX package's
    ``init_params`` gets them: every kernel lecun-normal — a normal
    truncated to two standard deviations, scaled to variance 1/fan_in,
    fan_in = in-features per group x kernel area (9 for a depthwise 3x3,
    C for a 1x1) — and zero biases.  Draws come from a ``torch.Generator``
    seeded with ``seed``, kernel by kernel in ``named_parameters`` order;
    JAX's PRNG streams are not reproduced."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in _template(cfg).named_parameters():
        t = torch.zeros(p.shape, dtype=torch.float32)
        if name.endswith("weight"):
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            # std of a unit normal truncated to [-2, 2]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
        out[name] = t
    return out


def train_apply(params: dict, x_nhwc: torch.Tensor, cfg: NetConfig) -> torch.Tensor:
    """Training-time forward, routed as the JAX package's ``train_apply``:
    a bf16 separable config through ``dense_equivalent_apply``, every other
    config through the module (f32 at full precision).  Differentiable in
    ``params`` (a dict of tensors in state_dict layout); NHWC in, f32 NHWC
    logits out."""
    if cfg.compute_dtype == torch.bfloat16 and cfg.separable_context:
        return dense_equivalent_apply(params, x_nhwc, cfg)
    return torch.func.functional_call(_template(cfg), params, (x_nhwc,))

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
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ubdvss_tpu_torch.net_config import NetConfig


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
    """

    def __init__(
        self,
        channels: int = 24,
        dilations: tuple[int, ...] = (1, 1, 2, 4, 8, 16, 1),
        separable_context: bool = True,
        n_output_channels: int = 17,
    ):
        super().__init__()
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
        if cfg.dtype != "float32":
            raise NotImplementedError(
                f"dtype={cfg.dtype!r}: the port serves float32 only; the bf16 "
                "route is queued in ROADMAP.md §1 item 7"
            )
        return cls(
            channels=cfg.channels,
            dilations=tuple(cfg.dilations),
            separable_context=cfg.separable_context,
            n_output_channels=cfg.n_output_channels,
        )

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        with exact_f32():
            return self._forward(x_nhwc)

    def _forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = x_nhwc.to(torch.float32).permute(0, 3, 1, 2)
        for conv in (self.downscale_0, self.downscale_1):
            x = F.relu(conv2d_same(x, conv.weight, conv.bias, stride=2))
        for i, d in enumerate(self.dilations):
            layer = getattr(self, f"context_{i}")
            if self.separable_context:
                x = layer(x)
            else:
                x = conv2d_same(x, layer.weight, layer.bias, dilation=d)
            x = F.relu(x)
        x = self.head(x)
        return x.permute(0, 2, 3, 1)


def get_model(cfg: NetConfig) -> BarcodeFCN:
    """Model-builder entry point mirroring the JAX package's API."""
    return BarcodeFCN.from_config(cfg)

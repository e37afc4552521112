"""Image preprocessing (grayscale -> resize -> normalize) in PyTorch.

Same numeric contract as ``ubdvss_tpu/ops/preproc.py``:
  * grayscale: ITU-R BT.601 luma, 0.299 R + 0.587 G + 0.114 B ('rgb'
    order; 'bgr' reverses the weights);
  * resize: separable bilinear with half-pixel centres and edge clamping,
    written as two matrix products (row matrix @ image @ column matrixᵀ)
    with f32 interpolation matrices built on the host;
  * normalize: x / 127.5 - 1  ->  [-1, 1].

Tensors keep the JAX package's layouts at these functions: images are
(H, W) or (H, W, C), batches (B, H, W[, C]), outputs carry a trailing
channel axis of 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# BT.601 luma weights, cv2 float-path order (R, G, B).
_LUMA_RGB = (0.299, 0.587, 0.114)


def rgb_to_grayscale(img: torch.Tensor, channel_order: str = "rgb") -> torch.Tensor:
    """(..., 3) -> (...) luma.  channel_order 'rgb' or 'bgr' (cv2.imread)."""
    if channel_order not in ("rgb", "bgr"):
        raise ValueError(f"channel_order must be 'rgb' or 'bgr', got {channel_order!r}")
    w = torch.tensor(
        _LUMA_RGB if channel_order == "rgb" else _LUMA_RGB[::-1],
        dtype=img.dtype,
        device=img.device,
    )
    return img @ w


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, cv2 INTER_LINEAR
    convention: src = (dst + 0.5) * n_in/n_out - 0.5, clamped to edges."""
    scale = n_in / n_out
    src = (np.arange(n_out) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = (src - i0).astype(np.float32)
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    np.add.at(m, (rows, i0c), 1.0 - frac)
    np.add.at(m, (rows, i1c), frac)
    m.setflags(write=False)  # shared by every caller through the cache
    return m


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) maps to (..., H', W') in f32.

    Rows are interpolated first, then columns, as in the JAX package.
    """
    h_in, w_in = img.shape[-2:]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return img
    mh = torch.from_numpy(_resize_matrix(h_in, h_out).copy()).to(img.device)
    mw = torch.from_numpy(_resize_matrix(w_in, w_out).copy()).to(img.device)
    x = img.to(torch.float32)
    x = torch.matmul(mh, x)  # (..., H', W)
    return torch.matmul(x, mw.T)  # (..., H', W')


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> [-1, 1]."""
    return x.to(torch.float32) * (1.0 / 127.5) - 1.0


def to_grayscale_batch(
    imgs: torch.Tensor, channel_order: str = "rgb", dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(B, H, W[, C]) -> (B, H, W) grayscale (C = 1 or 3) at ``dtype``: the
    luma of three channels is taken in f32, then cast; one channel is cast
    directly (uint8 0..255 is exact in bf16 as in f32)."""
    if imgs.ndim == 4:
        if imgs.shape[-1] == 3:
            return rgb_to_grayscale(imgs.to(torch.float32), channel_order).to(dtype)
        if imgs.shape[-1] != 1:
            raise ValueError(f"expected 1 or 3 channels, got shape {tuple(imgs.shape)}")
        imgs = imgs[..., 0]
    elif imgs.ndim != 3:
        raise ValueError(f"expected (B, H, W[, C]) images, got shape {tuple(imgs.shape)}")
    return imgs.to(dtype)


def preprocess(
    img: torch.Tensor, out_hw: tuple[int, int], channel_order: str = "rgb"
) -> torch.Tensor:
    """One (H, W[, C]) image -> (H', W', 1) normalized grayscale f32."""
    return preprocess_batch(img[None], out_hw, channel_order)[0]


def preprocess_batch(
    imgs: torch.Tensor, out_hw: tuple[int, int], channel_order: str = "rgb"
) -> torch.Tensor:
    """(B, H, W[, C]) -> (B, H', W', 1); all images share one input shape."""
    x = to_grayscale_batch(imgs, channel_order)
    x = resize_bilinear(x, out_hw)
    return normalize(x)[..., None]

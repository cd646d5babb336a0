"""Optional segmentation decoder head.

Counterpart of ``phnet_tpu/models/seg_decoder.py`` (the reference's
``libs/models/utils/seg_decoder.py:5-28``, ``SegDecoder``): Dropout2d ->
1x1 conv to ``num_class`` -> bilinear resize to the full image, NHWC as
the JAX module. No PHNet calls it, in the JAX package or here; it stands
alone (weights from a flax tree through ``convert.convert_module``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import full_f32


def _triangle_weights(n_in: int, n_out: int, dev) -> torch.Tensor:
    """``jax.image.resize``'s float32 weight matrix [n_out, n_in] of the
    "bilinear" (triangle) kernel, antialiased as it is by default:
    half-pixel sample positions, the kernel widened by the downscale
    factor, columns normalized, samples outside the input zeroed
    (``jax._src.image.scale.compute_weight_mat``)."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))  # JAX divides in Python, then rounds
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - x / kernel_scale).astype(f32)
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0)).astype(f32)
    return torch.from_numpy(np.ascontiguousarray(w.T)).to(dev)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (B, out_h, out_w, C), "bilinear")`` of NHWC
    ``x``: half-pixel bilinear when upsampling (edges clamped), the
    antialiased triangle filter when downsampling; a product with each
    axis's weight matrix, in float32 (TF32 off)."""
    _, h, w, _ = x.shape
    wy = _triangle_weights(h, out_h, x.device).to(x.dtype)
    wx = _triangle_weights(w, out_w, x.device).to(x.dtype)
    with full_f32():
        return torch.einsum("bhwc,yh,xw->byxc", x, wy, wx)


class SegDecoder(nn.Module):
    """``SegDecoder(image_height, image_width, num_class)`` of the JAX
    package; ``in_channels`` is the stacked features' width (flax infers
    it at init)."""

    def __init__(self, image_height: int, image_width: int, num_class: int,
                 in_channels: int, dropout_rate: float = 0.1):
        super().__init__()
        self.image_height = image_height
        self.image_width = image_width
        self.dropout_rate = dropout_rate
        self.conv = nn.Conv2d(in_channels, num_class, 1)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, h, w, C] stacked per-stage features -> [B, image_height,
        image_width, num_class] logits. In training, Dropout2d drops whole
        channels of each image (one keep draw a (b, c), from
        ``generator``, on x's device) and scales the rest by 1 / (1 -
        rate), as flax's ``Dropout(broadcast_dims=(1, 2))``."""
        rate = self.dropout_rate
        if train and rate > 0:
            b, _, _, c = x.shape
            keep = torch.rand((b, 1, 1, c), generator=generator,
                              device=x.device) >= rate
            keep_prob = torch.tensor(1.0 - rate, device=x.device)
            x = torch.where(keep, x / keep_prob, 0.0)
        with full_f32():
            y = F.linear(x, self.conv.weight.flatten(1), self.conv.bias)
        return resize_bilinear(y, self.image_height, self.image_width)

"""Bilinear feature sampling with zero padding (own copy of
``phnet_tpu/ops/sampler.py::bilinear_sample``, the ``F.grid_sample(...,
align_corners=True)`` of the reference's ``pool_prior_features``,
``RouterV4.py:135-153``), batched over a leading axis. The multi-scale
head pools its anchors with it; the single-scale head's one-hot pooling
(``models/head.py``) computes the same function."""

from __future__ import annotations

import torch


def bilinear_sample(feat: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample ``feat`` [B, H, W, C] at pixel coordinates ``x``, ``y``
    [B, ...] (0 .. W-1, 0 .. H-1); the four neighbours outside the map
    read zero. Returns [B, ..., C]: the neighbours weighted and summed in
    the JAX package's order, (x0, y0), (x1, y0), (x0, y1), (x1, y1)."""
    b, h, w, c = feat.shape
    lead = x.shape[1:]
    x, y = x.reshape(b, -1).to(feat.dtype), y.reshape(b, -1).to(feat.dtype)
    flat = feat.reshape(b, h * w, c)
    x0, y0 = torch.floor(x), torch.floor(y)
    x1, y1 = x0 + 1.0, y0 + 1.0
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def gather(yi, xi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return torch.where(valid[..., None], vals, 0.0)

    out = (gather(y0, x0) * (wy0 * wx0)[..., None]
           + gather(y0, x1) * (wy0 * wx1)[..., None]
           + gather(y1, x0) * (wy1 * wx0)[..., None]
           + gather(y1, x1) * (wy1 * wx1)[..., None])
    return out.reshape(b, *lead, c)

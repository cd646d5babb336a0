"""Flow-guided feature warping (the functional core of DFF).

Counterpart of ``phnet_tpu/models/flow_warp.py`` (the reference's
``libs/models/DFF.py:73-135``, ``warpModel``): warp the previous frame's
features along a normalized flow field with ``grid_sample(align_corners=
True, padding_mode="zeros")`` semantics, through the port's
``ops/sampler.py::bilinear_sample``, then fuse ``concat([curr, warped])``
with a 1x1 conv, a frozen BatchNorm and a ReLU. NHWC as the JAX module;
the flow comes precomputed (``data/flow.py``). No PHNet calls it, in the
JAX package or here; weights from a flax tree through
``convert.convert_module``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import full_f32
from ..ops.sampler import bilinear_sample


def _linspace(n: int, dev) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in float32: ``-1 + i * (2 / (n - 1))``,
    the last entry 1 exactly."""
    if n == 1:
        return torch.full((1,), -1.0, device=dev)
    step = np.float32(2.0) / np.float32(n - 1)
    out = np.float32(-1.0) + np.arange(n - 1, dtype=np.float32) * step
    return torch.from_numpy(np.append(out, np.float32(1.0))).to(dev)


def flow_warp(feat: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``feat`` [B, H, W, C] by ``flow`` [B, H, W, 2] (normalized grid
    offsets in [-1, 1], (x, y)): grid g maps to pixel (g + 1) / 2 *
    (size - 1) (align_corners=True); samples outside read zero."""
    b, h, w, _ = feat.shape
    gx = _linspace(w, feat.device)[None, None, :]
    gy = _linspace(h, feat.device)[None, :, None]
    x = (gx + flow[..., 0] + 1.0) / 2.0 * (w - 1)
    y = (gy + flow[..., 1] + 1.0) / 2.0 * (h - 1)
    return bilinear_sample(feat, x, y)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine (``DFF.py:33-70``): its
    four leaves are parameters, as they are in flax's ``params``, so
    checkpoints load; no statistics are ever updated."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return x * scale + (self.bias - self.running_mean * scale)


class WarpModel(nn.Module):
    """``warpModel(inplane, outplane)``, NHWC. The reference's unused
    flow-generation layers are not declared (as in the JAX module)."""

    def __init__(self, inplane: int, outplane: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(2 * inplane, outplane, 1, bias=False)
        self.bn = FrozenBatchNorm(outplane)

    def forward(self, last_feature: torch.Tensor, curr_feature: torch.Tensor,
                flow: torch.Tensor) -> torch.Tensor:
        """last / curr_feature: [B, H, W, inplane]; flow: [B, H, W, 2]
        normalized (pixels over (W, H)). Returns [B, H, W, outplane]."""
        warped = flow_warp(last_feature, flow)
        fused = torch.cat([curr_feature, warped], dim=-1)
        with full_f32():
            out = F.linear(fused, self.conv.weight.flatten(1))
        return torch.relu(self.bn(out))

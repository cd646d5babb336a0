"""ResNet backbone (BasicBlock and Bottleneck), NCHW inside.

Port of ``phnet_tpu/models/resnet.py``: ResNet-18/34 of BasicBlocks and
ResNet-50 of Bottlenecks (1x1, 3x3 with the stride, 1x1 to four times the
width, and a projection where the stride or the width changes), with the
7x7/s2 stem followed by a 3x3/s2 max pool (the stem the JAX package
resolves ``"auto"`` to off the TPU). The packed stems of the JAX package
compute the same function and are not ported. BatchNorm normalizes with
running statistics in eval mode and with the batch's in train mode
(:mod:`phnet_torch.ops.batchnorm`, the port of
``phnet_tpu/ops/batchnorm.py``); ``norm="group"`` puts flax's GroupNorm
(``min(32, C)`` groups, epsilon 1e-6) in its place, which has no running
statistics.

The backbone computes in its input's dtype. In bfloat16 (the JAX
package's ``compute_dtype="bfloat16"``) a convolution takes its kernel
rounded to bf16 and gives a bf16 output, BatchNorm and GroupNorm
normalize in float32 from the bf16 input and the float32 statistics and
round their output to bf16 (flax's order), and the ReLUs, the max pool
and the residual adds stay in bf16. Training keeps the running statistics
in float32.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.batchnorm import bn_train_normalize

# blocks a stage: BasicBlocks below depth 50, Bottlenecks from it
STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
GN_EPS = 1e-6  # flax nn.GroupNorm default


def lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    """Fill w from N(0, 1/fan_in), drawn on the CPU from ``g``."""
    w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(fan_in))


class BatchNorm(nn.Module):
    """BatchNorm with flax's parameters (``scale``/``bias`` as weight and
    bias, ``batch_stats`` ``mean``/``var`` as buffers), epsilon 1e-5.

    Eval mode normalizes with the running statistics. Train mode follows
    the JAX package's ``FusedBatchNorm``: statistics over every image of
    the batch (N, H, W) in float32 by the fast variance
    ``max(0, E[x^2] - E[x]^2)``, ``y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias``, and the running statistics updated in place as
    ``r = 0.9 r + 0.1 batch`` with the biased batch variance (which
    ``F.batch_norm`` does not do: it keeps the unbiased one), through
    :func:`~phnet_torch.ops.batchnorm.bn_train_normalize` and its
    closed-form backward, as the JAX package's custom VJP. A bf16 input
    normalizes in float32 and rounds its output to bf16 (flax's order), in
    both modes."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.empty(channels))
        self.register_buffer("var", torch.empty(channels))

    def reset_parameters(self, g: torch.Generator):
        del g
        for t, v in ((self.weight, 1.0), (self.bias, 0.0), (self.mean, 0.0),
                     (self.var, 1.0)):
            t.data.fill_(v)

    def forward(self, x):
        if not self.training and x.dtype == torch.bfloat16:
            mul = torch.rsqrt(self.var + self.eps) * self.weight
            y = ((x.float() - self.mean[:, None, None]) * mul[:, None, None]
                 + self.bias[:, None, None])
            return y.to(x.dtype)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.weight,
                                self.bias, False, 0.0, self.eps)
        y, mean, var = bn_train_normalize(x, self.weight, self.bias,
                                          self.eps)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm`` over [N, C, ...]: statistics per sample
    and group by the fast variance ``max(0, E[x^2] - E[x]^2)``, then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. A bf16 input
    normalizes in float32 and rounds its output to bf16 (flax's order
    with ``dtype=bfloat16``); any other in its own dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c = x.shape[:2]
        g = self.num_groups
        xf = x.float() if x.dtype == torch.bfloat16 else x
        xg = xf.reshape(n, g, -1)
        mean = xg.mean(-1)
        var = torch.clamp((xg * xg).mean(-1) - mean * mean, min=0.0)
        rest = (1,) * (x.ndim - 2)

        def per_channel(t):  # [n, g] -> [n, c, 1, ...]
            return t[..., None].expand(n, g, c // g).reshape((n, c) + rest)

        mul = per_channel(torch.rsqrt(var + self.eps)) * self.weight.reshape(
            (c,) + rest)
        y = (xf - per_channel(mean)) * mul + self.bias.reshape((c,) + rest)
        return y.to(x.dtype)


def norm_layer(kind: str, channels: int) -> nn.Module:
    """The backbone's norm: BatchNorm (``"batch"``) or GroupNorm of
    ``min(32, C)`` groups (``"group"``)."""
    if kind == "group":
        return GroupNorm(min(32, channels), channels, eps=GN_EPS)
    return BatchNorm(channels)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (flax ``Conv(dtype=...)``): a
    bf16 input takes the kernel rounded to bf16, rounds the product to
    bf16, then adds the bias in bf16; any other as ``nn.Conv2d``."""

    def forward(self, x):
        if x.dtype != torch.bfloat16:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is None:
            return y
        return y + self.bias.to(x.dtype)[:, None, None]


def _conv(cin, cout, k, stride=1, padding=0):
    return Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int,
                 norm: str = "batch"):
        super().__init__()
        self.conv0 = _conv(cin, planes, 3, stride, 1)
        self.bn0 = norm_layer(norm, planes)
        self.conv1 = _conv(planes, planes, 3, 1, 1)
        self.bn1 = norm_layer(norm, planes)
        self.has_down = stride != 1 or cin != planes
        if self.has_down:
            self.conv2 = _conv(cin, planes, 1, stride, 0)
            self.bn2 = norm_layer(norm, planes)

    def forward(self, x):
        y = torch.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        identity = self.bn2(self.conv2(x)) if self.has_down else x
        return torch.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 to ``4 * planes``, a 1x1 projection
    of the input (``conv3``) where the stride or the width changes; the
    JAX block's ``Conv_i`` / ``Norm_i`` in order as ``conv{i}`` /
    ``bn{i}``."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int,
                 norm: str = "batch"):
        super().__init__()
        out = planes * self.expansion
        self.conv0 = _conv(cin, planes, 1)
        self.bn0 = norm_layer(norm, planes)
        self.conv1 = _conv(planes, planes, 3, stride, 1)
        self.bn1 = norm_layer(norm, planes)
        self.conv2 = _conv(planes, out, 1)
        self.bn2 = norm_layer(norm, out)
        self.has_down = stride != 1 or cin != out
        if self.has_down:
            self.conv3 = _conv(cin, out, 1, stride, 0)
            self.bn3 = norm_layer(norm, out)

    def forward(self, x):
        y = torch.relu(self.bn0(self.conv0(x)))
        y = torch.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        identity = self.bn3(self.conv3(x)) if self.has_down else x
        return torch.relu(y + identity)


class ResNetBackbone(nn.Module):
    """Returns the four stage outputs (strides 4, 8, 16, 32), NCHW."""

    def __init__(self, depth: int = 18,
                 stage_channels: Tuple[int, ...] = (64, 128, 256, 512),
                 norm: str = "batch"):
        super().__init__()
        block = BasicBlock if depth < 50 else Bottleneck
        self.conv0 = _conv(3, 64, 7, 2, 3)
        self.bn0 = norm_layer(norm, 64)
        blocks, cin = [], 64
        self.stage_ends = []
        for stage, (planes, n) in enumerate(zip(stage_channels,
                                                STAGE_BLOCKS[depth])):
            for b in range(n):
                stride = 2 if (stage > 0 and b == 0) else 1
                blocks.append(block(cin, planes, stride, norm))
                cin = planes * block.expansion
            self.stage_ends.append(len(blocks) - 1)
        self.blocks = nn.ModuleList(blocks)

    def reset_parameters(self, g: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight.data, m.weight[0].numel(), g)
            elif isinstance(m, BatchNorm):
                m.reset_parameters(g)
            elif isinstance(m, GroupNorm):
                m.reset_parameters()

    def forward(self, x) -> Sequence[torch.Tensor]:
        x = torch.relu(self.bn0(self.conv0(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x)
        return tuple(outs)

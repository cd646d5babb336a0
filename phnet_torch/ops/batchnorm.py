"""Training BatchNorm with the closed-form backward (port of
``phnet_tpu/ops/batchnorm.py``).

:func:`bn_batch_stats` gives flax's statistics: float32 mean and fast
variance ``max(0, E[x^2] - E[x]^2)`` over every axis but the channels.
:func:`bn_train_normalize` normalizes with them, ``y = (x - mean) *
(rsqrt(var + eps) * scale) + bias`` in float32 (x widened from its dtype,
the parameters float32), and its backward is the JAX package's closed
form ``dx = r * s * (g - mean(g) - x_hat * mean(g * x_hat))`` with
``x_hat = (x - mean) * r``: the cotangent and x are widened to float32,
``dx`` is rounded to x's dtype, and the parameters' gradients are the two
float32 sums (a float64 model computes all of it in float64). Autograd of
the formula would round bf16 cotangents elsewhere and sum in other
orders. Channels are axis 1 (NCHW).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32 from a narrower float dtype (float64 stays)."""
    return x.float() if x.element_size() < 4 else x


def _axes(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.ndim))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (x.ndim - 2))


def bn_batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel of x [N, C, ...] in float32, fast variance."""
    x32 = _wide(x)
    n = x.numel() // x.shape[1]
    mean = x32.sum(_axes(x)) / n
    mean2 = (x32 * x32).sum(_axes(x)) / n
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


class BatchNormTrainFn(torch.autograd.Function):
    """Batch-statistics normalization with the closed-form backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mean, var = bn_batch_stats(x)
        r = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, mean, r, scale)
        ctx.mark_non_differentiable(mean, var)
        y = ((_wide(x) - _per_channel(mean, x)) * _per_channel(r * scale, x)
             + _per_channel(bias, x))
        return y, mean, var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        x, mean, r, scale = ctx.saved_tensors
        axes = _axes(x)
        n = x.numel() // x.shape[1]
        g32 = _wide(g)
        xhat = (_wide(x) - _per_channel(mean, x)) * _per_channel(r, x)
        sum_g = g32.sum(axes)
        sum_gx = (g32 * xhat).sum(axes)
        dx = _per_channel(r * scale, x) * (
            g32 - _per_channel(sum_g / n, x)
            - xhat * _per_channel(sum_gx / n, x))
        return dx.to(x.dtype), sum_gx, sum_g, None


def bn_train_normalize(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N, C, ...] normalized by its batch statistics: (y, mean, var),
    y in float32 (the caller rounds it to its compute dtype, as flax
    does) and the statistics of :func:`bn_batch_stats`, which carry no
    gradient (the running statistics' update reads them)."""
    return BatchNormTrainFn.apply(x, scale, bias, eps)

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

Under a process group of more than one rank (data-parallel training,
:mod:`phnet_torch.parallel.multihost`) the statistics are those of the
global batch, as ``SyncBatchNorm``'s: the forward all-reduces the
per-channel sums of x and x^2 and the count, the backward the sums of g
and g * x_hat before it forms ``dx``; the parameters' gradients stay the
rank's own sums (the step's gradient mean makes them the global ones).
The all-reduced sums are float64. On a mesh with a model axis the sums
run over the data group alone: the ranks of one model group hold the
same rows, which the world's sum would count once a rank. With one rank
along data nothing is all-reduced and the arithmetic is the one-process
arithmetic above.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.multihost import all_reduce_sum, data_size


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x in float32 from a narrower float dtype (float64 stays)."""
    return x.float() if x.element_size() < 4 else x


def _axes(x: torch.Tensor) -> Tuple[int, ...]:
    return (0,) + tuple(range(2, x.ndim))


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (x.ndim - 2))


def _global_sums(*sums: torch.Tensor, count: int):
    """The per-channel ``sums`` and the ``count`` summed over the data
    axis's ranks, in float64: (the sums, the count)."""
    buf = torch.cat([s.double() for s in sums] + [
        sums[0].new_full((1,), count, dtype=torch.float64)])
    all_reduce_sum(buf, "data")
    c = sums[0].shape[0]
    return [buf[i * c:(i + 1) * c] for i in range(len(sums))], buf[-1]


def bn_batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, var) per channel of x [N, C, ...] in float32, fast variance;
    over the global batch under a process group of more than one rank."""
    x32 = _wide(x)
    n = x.numel() // x.shape[1]
    sum_x, sum_x2 = x32.sum(_axes(x)), (x32 * x32).sum(_axes(x))
    if data_size() > 1:
        (sum_x, sum_x2), count = _global_sums(sum_x, sum_x2, count=n)
        mean = (sum_x / count).to(x32.dtype)
        mean2 = (sum_x2 / count).to(x32.dtype)
    else:
        mean, mean2 = sum_x / n, sum_x2 / n
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
        if data_size() > 1:
            (all_g, all_gx), count = _global_sums(sum_g, sum_gx, count=n)
            mean_g = (all_g / count).to(g32.dtype)
            mean_gx = (all_gx / count).to(g32.dtype)
        else:
            mean_g, mean_gx = sum_g / n, sum_gx / n
        dx = _per_channel(r * scale, x) * (
            g32 - _per_channel(mean_g, x)
            - xhat * _per_channel(mean_gx, x))
        return dx.to(x.dtype), sum_gx, sum_g, None


def bn_train_normalize(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [N, C, ...] normalized by its batch statistics: (y, mean, var),
    y in float32 (the caller rounds it to its compute dtype, as flax
    does) and the statistics of :func:`bn_batch_stats`, which carry no
    gradient (the running statistics' update reads them)."""
    return BatchNormTrainFn.apply(x, scale, bias, eps)

"""One training step (port of ``phnet_tpu/train/step.py``).

A step runs the model's training forward over the clip batch, the
criterion, the backward and one optimizer update, all inside
:func:`~phnet_torch.device.full_f32`, so that the backward's convolutions
and matmuls (the frames' recomputation under remat included) run in
float32 whatever the TF32 flags say, the float32 parts of a bf16 model
too. A bf16 model keeps float32 parameters and AdamW moments and casts at
use (flax's ``param_dtype``); there is no loss scaling, as in the JAX
package. It makes no host sync: the metrics come back as device
tensors.

``accum_steps > 1`` splits the batch into that many micro-batches,
accumulates their gradients and makes one update on their mean; BatchNorm's
running statistics see each micro-batch in turn, as the JAX package's scan
over micro-batches does.

In a process group (data-parallel training,
:mod:`phnet_torch.parallel.multihost`) ``frames`` and ``labels`` are the
rank's shard of the global batch. After the backward the gradients are
all-reduced to their mean in one flat buffer, before the clip and the
update, so that every rank makes the global batch's update; the metrics
are all-reduced to their mean too, so that every rank reports (and
judges) the global loss. Micro-batch k is every rank's local micro-batch
k together.

On a mesh with a model axis (:mod:`phnet_torch.parallel.tensor`) a
sharded parameter's gradient is its mean over the rank's data group (the
ranks holding the same block), and a whole parameter's its mean over the
world: the m ranks of a data row computed it from the same rows, so that
is the data mean, and it gives every rank the same bits whether or not a
backward's kernels do. The metrics are their mean over the data group.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..device import full_f32
from ..losses.criterion import LaneCriterion
from ..parallel.multihost import all_reduce_mean, in_group, model_size
from ..parallel.tensor import placement
from .state import TrainState


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of training step ``step`` of a run seeded ``seed``."""
    return (seed * 7_919 + step) % 2 ** 62


def make_train_step(criterion: LaneCriterion,
                    accum_steps: int = 1) -> Callable:
    """``train_step(state, frames, labels, seed)`` -> ``(state, metrics)``;
    frames [B, T, H, W, 3], labels [B, T, L, dim] on the model's device.
    ``seed`` seeds the decoder's dropout masks. metrics: loss, grad_norm,
    cls, reg, iou (device scalars)."""

    def train_step(state: TrainState, frames: torch.Tensor,
                   labels: torch.Tensor, seed: int
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        b = frames.shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps="
                             f"{accum_steps}")
        mb = b // accum_steps
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad()
        total, sums = 0.0, {}
        with full_f32():
            for k in range(accum_steps):
                sl = slice(k * mb, (k + 1) * mb)
                outs, _ = model.train_forward(frames[sl], labels[sl],
                                              step_seed(seed, k))
                loss, metrics = criterion(outs, labels[sl])
                loss.backward()
                total = total + loss.detach()
                for key, v in metrics.items():
                    sums[key] = sums.get(key, 0.0) + v.detach()
            if accum_steps > 1:
                torch._foreach_div_([p.grad for p in opt.params
                                     if p.grad is not None], accum_steps)
            if in_group():
                mean_gradients(opt.params)
            grad_norm = opt.step()
        metrics = {key: v / accum_steps for key, v in sums.items()}
        metrics["loss"] = total / accum_steps
        if in_group():
            metrics = mean_metrics(metrics)
        metrics["grad_norm"] = grad_norm
        state.step += 1
        return state, metrics

    return train_step


@torch.no_grad()
def mean_gradients(params):
    """Every parameter's gradient replaced by its mean over the ranks,
    through one flat buffer (a parameter the loss did not reach takes a
    zero gradient first, as the update gives it); on a mesh with a model
    axis, a sharded parameter's over its data group, in a second
    buffer."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if model_size() == 1:
        _mean_flat([p.grad for p in params], None)
        return
    _mean_flat([p.grad for p in params if placement(p) is None], None)
    _mean_flat([p.grad for p in params if placement(p) is not None], "data")


def _mean_flat(grads, axis):
    if not grads:
        return
    flat = all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]), axis)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def mean_metrics(metrics: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The step's metrics (device scalars) averaged over the ranks (of
    the data axis)."""
    keys = sorted(metrics)
    dtype = metrics["loss"].dtype
    flat = all_reduce_mean(torch.stack([metrics[k].reshape(()).to(dtype)
                                        for k in keys]),
                           None if model_size() == 1 else "data")
    return {k: flat[i] for i, k in enumerate(keys)}

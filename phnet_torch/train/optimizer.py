"""Optimizer and learning-rate schedule (port of
``phnet_tpu/train/optimizer.py``, reference ``libs/utils/optimizer.py``).

AdamW (or Nesterov SGD) over two parameter groups: parameters with more
than one dimension decay, the others (biases, norm scales) do not. The
learning rate follows the cosine schedule stepped once per optimizer
update, ``T_max`` = the run's updates over the world size (1 here), and
update ``k`` (0-based) uses ``lr(k)``. ``torch.optim.AdamW`` with the
config's betas and eps 1e-8 computes optax's ``adamw`` update: ``p -= lr *
(m_hat / (sqrt(v_hat) + eps) + wd * p)``, the JAX package's fused AdamW
with the same decay mask.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from ..config import TrainConfig


def decay_mask(params: Iterable[torch.Tensor]) -> List[bool]:
    """True for a parameter that receives weight decay (ndim > 1)."""
    return [p.ndim > 1 for p in params]


def cosine_schedule(lr: float, total_steps: int):
    """torch's ``CosineAnnealingLR`` with eta_min 0 as a function of the
    update index, in float32 as the JAX package computes it:
    ``lr * (1 + cos(pi * min(t, T) / T)) / 2``."""
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(min(step, total_steps))
        return float(f32(lr * 0.5) * (f32(1.0) + np.cos(
            f32(np.pi) * t / f32(total_steps))))

    return schedule


def global_norm(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """The L2 norm over every entry of ``tensors`` (None skipped), one
    scalar on their device."""
    ts = [t for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))


class Optimizer:
    """The training update: optional clip by global norm, then AdamW or
    Nesterov SGD at the schedule's rate for the update's index. Holds the
    torch optimizer (its ``state_dict`` goes into checkpoints) and the
    count of updates made."""

    def __init__(self, tcfg: TrainConfig, total_steps: int,
                 params: Iterable[torch.nn.Parameter]):
        params = [p for p in params if p.requires_grad]
        decay = decay_mask(params)
        groups = [{"params": [p for p, d in zip(params, decay) if d]},
                  {"params": [p for p, d in zip(params, decay) if not d],
                   "weight_decay": 0.0}]
        self.params = params
        self.clip = tcfg.grad_clip_norm
        self.schedule = cosine_schedule(tcfg.learning_rate,
                                        max(total_steps, 1))
        if tcfg.solver == "adamw":
            self.opt = torch.optim.AdamW(
                groups, lr=tcfg.learning_rate, betas=tuple(tcfg.momentum),
                eps=1e-8, weight_decay=tcfg.weight_decay)
        else:
            self.opt = torch.optim.SGD(
                groups, lr=tcfg.learning_rate, momentum=tcfg.momentum[0],
                nesterov=True, weight_decay=tcfg.weight_decay)
        self.count = 0

    def lr(self) -> float:
        """The rate of the next update."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        norm of the gradient the update used (after the clip, as the JAX
        package's fused AdamW reports it). A parameter the loss does not
        reach (the multi-scale model's unused last backbone stage) takes a
        zero gradient: the JAX package's update sees zeros there, and its
        weight decay still moves the parameter."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.clip > 0:
            scale = torch.clamp(self.clip / norm, max=1.0)
            torch._foreach_mul_([g for g in grads if g is not None], scale)
            norm = norm * scale
        lr = self.lr()
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self):
        return {"count": self.count, "torch": self.opt.state_dict()}

    def load_state_dict(self, sd):
        self.count = int(sd["count"])
        self.opt.load_state_dict(sd["torch"])


def build_optimizer(tcfg: TrainConfig, total_steps: int,
                    params: Iterable[torch.nn.Parameter]) -> Optimizer:
    return Optimizer(tcfg, total_steps, params)

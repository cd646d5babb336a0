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

``lr_scales`` gives each parameter a fixed multiple of the schedule's rate
(the JAX package's ``build_optimizer(..., lr_scales=)``): the parameters
are grouped by (decay, scale) and each group steps at the rate times its
scale, which scales the whole update, weight decay included, as the JAX
package's scaled update does. :func:`revcol_layer_scales` gives RevCol's
layer-wise decay. The trainer passes none, as the JAX trainer passes
none.

On a mesh with a model axis (:mod:`phnet_torch.parallel.tensor`) a
sharded parameter's moments live with its block (AdamW and SGD act
entry by entry), the global norm counts each sharded entry once (the
squares of the blocks summed over the model group, plus the whole
parameters' once), and :meth:`Optimizer.state_dict` holds whole tensors,
as a one-process run's: the moments are gathered (every rank calls it)
and :meth:`Optimizer.load_state_dict` cuts whole ones to the blocks.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import re

import numpy as np
import torch

from ..config import TrainConfig
from ..parallel.multihost import all_reduce_sum
from ..parallel.tensor import cut_like, gather_like, placement


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


def revcol_layer_scales(names: Iterable[str],
                        layers: Sequence[int] = (2, 2, 4, 2),
                        num_subnet: int = 4,
                        layer_decay: float = 0.9) -> List[float]:
    """The learning-rate scale of each parameter named in ``names`` (the
    port's ``named_parameters()`` names), in their order: the JAX
    package's ``revcol_layer_scales`` (reference ``param_groups_lrd``,
    ``libs/utils/optimizer.py:77-143``). A dynamic-programming table of
    depth over (block, column) gives each column / level / block a layer
    id; the scale is ``layer_decay ** (num_layers - id)``; the stem has id
    0, and whatever is not in a column of the backbone (the neck, the
    head) ``num_layers``, scale 1."""
    depth = sum(layers)
    dp = np.zeros((depth, num_subnet), dtype=int)
    dp[:, 0] = np.arange(depth)
    dp[0, :] = np.arange(num_subnet)
    for i in range(1, depth):
        for j in range(1, num_subnet):
            dp[i][j] = min(dp[i][j - 1], dp[i - 1][j]) + 1
    dp = dp + 1
    num_layers = dp[-1][-1] + 1  # numpy's integer: numpy's power, as JAX's
    scales = [float(layer_decay ** (num_layers - i))
              for i in range(num_layers + 1)]

    def layer_id(name: str) -> int:
        if "backbone" not in name:
            return num_layers
        if "stem" in name:
            return 0
        m = re.search(r"subnet(\d+)", name)
        if not m:
            return num_layers
        col = int(m.group(1))
        lm = re.search(r"level(\d+)", name)
        if "alpha" in name or lm is None:
            return int(dp[0][col])
        lvl = int(lm.group(1))
        bm = re.search(r"block(\d+)", name)
        sub = min(int(bm.group(1)), layers[lvl] - 1) if bm else 0
        return int(dp[sum(layers[:lvl]) + sub][col])

    return [scales[min(layer_id(n), num_layers)] for n in names]


def global_norm(tensors: Iterable[Optional[torch.Tensor]],
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """The L2 norm over every entry of ``tensors`` (None skipped), one
    scalar on their device. ``sharded`` marks the tensors that are blocks
    of a tensor cut over the model axis: their squares are summed over the
    model group."""
    tensors = list(tensors)
    sharded = sharded or [False] * len(tensors)
    ts = [t for t in tensors if t is not None]
    if not any(sharded):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(ts)))
    whole = [t for t, s in zip(tensors, sharded) if t is not None and not s]
    cut = [t for t, s in zip(tensors, sharded) if t is not None and s]
    cut_sq = torch.stack(torch._foreach_norm(cut)).square().sum()
    whole_sq = (torch.stack(torch._foreach_norm(whole)).square().sum()
                if whole else torch.zeros_like(cut_sq))
    return torch.sqrt(whole_sq + all_reduce_sum(cut_sq.reshape(1),
                                                "model")[0])


class Optimizer:
    """The training update: optional clip by global norm, then AdamW or
    Nesterov SGD at the schedule's rate for the update's index, times each
    parameter's ``lr_scales`` entry (one a parameter of ``params``, in its
    order; 1 without). Holds the torch optimizer (its ``state_dict`` goes
    into checkpoints) and the count of updates made."""

    def __init__(self, tcfg: TrainConfig, total_steps: int,
                 params: Iterable[torch.nn.Parameter],
                 lr_scales: Optional[Sequence[float]] = None):
        params = list(params)
        scales = [1.0] * len(params) if lr_scales is None else list(
            lr_scales)
        if len(scales) != len(params):
            raise ValueError(f"{len(scales)} lr_scales for {len(params)} "
                             f"parameters")
        scales = [s for p, s in zip(params, scales) if p.requires_grad]
        params = [p for p in params if p.requires_grad]
        # (decays, scale) -> parameters, decaying ones first; the two groups
        # at scale 1 always, so that an unscaled optimizer's state has the
        # same two groups whatever the parameters
        by_key = {(True, 1.0): [], (False, 1.0): []}
        for p, key in zip(params, zip(decay_mask(params), scales)):
            by_key.setdefault(key, []).append(p)
        by_key = dict(sorted(by_key.items(), key=lambda kv: not kv[0][0]))
        groups = [dict(params=ps, **({} if decays else {"weight_decay": 0.0}))
                  for (decays, _), ps in by_key.items()]
        # each torch group's multiple of the schedule's rate, kept here and
        # not in the groups: a checkpoint's optimizer state is torch's own
        self.lr_scales = [scale for _, scale in by_key]
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
        norm = global_norm(grads, [placement(p) is not None
                                   for p in self.params])
        if self.clip > 0:
            scale = torch.clamp(self.clip / norm, max=1.0)
            torch._foreach_mul_([g for g in grads if g is not None], scale)
            norm = norm * scale
        lr = self.lr()
        for group, scale in zip(self.opt.param_groups, self.lr_scales):
            group["lr"] = lr * scale
        self.opt.step()
        self.count += 1
        return norm

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def _placements(self):
        """The placement of each parameter by its index in the torch
        optimizer's ``state_dict`` (its groups' order)."""
        params = [p for g in self.opt.param_groups for p in g["params"]]
        return [placement(p) for p in params]

    def state_dict(self):
        sd = self.opt.state_dict()
        pls = self._placements()
        if any(pl is not None for pl in pls):
            sd = dict(sd, state={i: {k: gather_like(v, pls[i])
                                     for k, v in st.items()}
                                 for i, st in sd["state"].items()})
        return {"count": self.count, "torch": sd}

    def load_state_dict(self, sd):
        self.count = int(sd["count"])
        sd = sd["torch"]
        pls = self._placements()
        if any(pl is not None for pl in pls):
            sd = dict(sd, state={i: {k: cut_like(v, pls[int(i)])
                                     for k, v in st.items()}
                                 for i, st in sd["state"].items()})
        self.opt.load_state_dict(sd)


def build_optimizer(tcfg: TrainConfig, total_steps: int,
                    params: Iterable[torch.nn.Parameter],
                    lr_scales: Optional[Sequence[float]] = None
                    ) -> Optimizer:
    return Optimizer(tcfg, total_steps, params, lr_scales)

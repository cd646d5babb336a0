"""Softmax focal loss (port of ``phnet_tpu/losses/focal.py``, reference
``libs/utils/focal_loss.py``)."""

from __future__ import annotations

from typing import Sequence, Union

import torch


def softmax_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: Union[Sequence[float], torch.Tensor] = (0.5,
                                                                      0.5),
                       gamma: float = 2.0, eps: float = 1e-6
                       ) -> torch.Tensor:
    """``-sum_c onehot_c * alpha_c * (1 - p_c)^gamma * log(p_c)`` with
    softmax probabilities. logits [..., A, C]; targets [..., A] int ->
    [..., A]. As in the reference, eps is added to the one-hot too.
    ``alpha`` may be a tensor on the logits' device (no host copy then)."""
    probs = torch.softmax(logits, dim=-1) + eps
    classes = torch.arange(logits.shape[-1], device=logits.device)
    one_hot = (targets[..., None] == classes).to(logits.dtype) + eps
    alpha_v = torch.as_tensor(alpha, dtype=logits.dtype,
                              device=logits.device)
    focal = -alpha_v * (1.0 - probs) ** gamma * torch.log(probs)
    return torch.sum(one_hot * focal, dim=-1)

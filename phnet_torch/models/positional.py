"""Anchor-index positional encodings of the second branch (port of
``phnet_tpu/models/positional.py``): the sine table (reference
``SeqFormer/position_encoding.py:59-89``; VIL) and the learned embedding
(``position_encoding.py:116-131``; OL, ``Router4OL.py:110``)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn


def sinusoid_table(n_position: int, d_hid: int, temperature: float,
                   normalize: bool) -> np.ndarray:
    """[n_position, d_hid] sinusoid encoding of anchor index (float32)."""
    p = np.arange(n_position, dtype=np.float32)
    if normalize:
        eps = 1e-6
        p = (p - 0.5) / (p[-1] + eps) * (2 * math.pi)
    dim_t = np.arange(d_hid, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / d_hid)
    pos = p[:, None] / dim_t[None, :]
    pos[:, 0::2] = np.sin(pos[:, 0::2])
    pos[:, 1::2] = np.cos(pos[:, 1::2])
    return pos


class AnchorPositionalEncoding(nn.Module):
    """Per-anchor positions [A, d]: ``kind="sine"`` a fixed table (a
    buffer, not saved), ``"learned"`` the parameter ``embedding``
    (uniform in [0, 1) at init, as flax's ``uniform(1.0)``)."""

    def __init__(self, num_anchors: int, dim: int, kind: str = "sine",
                 temperature: float = 16.0, normalize: bool = True):
        super().__init__()
        self.kind = kind
        if kind == "learned":
            self.embedding = nn.Parameter(torch.empty(num_anchors, dim))
        else:
            self.register_buffer("table", torch.from_numpy(sinusoid_table(
                num_anchors, dim, temperature, normalize)), persistent=False)

    def reset_parameters(self, g: torch.Generator):
        if self.kind == "learned":
            self.embedding.data.copy_(torch.rand(self.embedding.shape,
                                                 generator=g))

    def forward(self) -> torch.Tensor:
        return self.embedding if self.kind == "learned" else self.table

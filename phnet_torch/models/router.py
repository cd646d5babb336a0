"""Adaptive per-anchor difficulty router (port of
``phnet_tpu/models/router.py``, reference ``Router.py:39-81``).

The residual chain runs through :func:`phnet_torch.ops.router_chain`
(the CUDA kernel on the card), then the MLP ``C*P -> C*P/reduction -> 1``
ends in ReLU and a sigmoid, so scores lie in [0.5, 1) and VIL's hard
selection ``diff >= 0.5`` always picks the second branch, as in the
reference.

The chain's mode follows ``phnet_tpu/models/router.py``: at inference
it computes in float32 unless ``chain_bf16`` selects its bf16 mode,
whatever the compute dtype; in training it computes in the compute dtype
(the bf16 mode in a bf16 model) unless ``train_chain_f32``. The MLP runs
in the compute dtype ``dtype`` (the chain's output cast to it) and the
sigmoid in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.router_chain import router_chain
from .mixed import dense, widen


class AdaptiveRouter(nn.Module):
    def __init__(self, num_anchors: int = 240, channels: int = 64,
                 points: int = 36, reduction: int = 4, blocks: int = 4,
                 dtype: Optional[torch.dtype] = None,
                 chain_bf16: bool = False, train_chain_f32: bool = False):
        """``dtype``: the compute dtype (None: float32 compute)."""
        super().__init__()
        self.blocks = blocks
        self.dtype, self.chain_bf16 = dtype, chain_bf16
        self.train_chain_f32 = train_chain_f32
        a, c, p = num_anchors, channels, points
        self.taps = nn.Parameter(torch.empty(a, blocks * 18))
        self.conv_bias = nn.Parameter(torch.empty(a, blocks * 2))
        self.ln_params = nn.Parameter(torch.empty(2 + 4 * blocks, c, p))
        hidden = c * p // reduction
        self.dense0 = nn.Linear(c * p, hidden)
        self.dense1 = nn.Linear(hidden, 1)

    def reset_parameters(self, g: torch.Generator):
        self.taps.data.copy_(torch.rand(self.taps.shape, generator=g)
                             * (2.0 / 3.0) - 1.0 / 3.0)
        self.conv_bias.data.zero_()
        lnp = torch.zeros(self.ln_params.shape)
        lnp[[0] + [2 + 4 * b + o for b in range(self.blocks)
                   for o in (0, 2)]] = 1.0  # LN scales 1, biases 0
        self.ln_params.data.copy_(lnp)
        gain2 = (5.0 / 3.0) ** 2  # xavier_uniform with tanh gain
        for lin in (self.dense0, self.dense1):
            fan_in, fan_out = lin.in_features, lin.out_features
            bound = math.sqrt(3.0 * gain2 / ((fan_in + fan_out) / 2))
            lin.weight.data.copy_(
                (torch.rand(lin.weight.shape, generator=g) * 2 - 1) * bound)
            lin.bias.data.zero_()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: [B, A, C, P] -> scores [B, A, 1]."""
        return torch.sigmoid(widen(torch.relu(self.logits(feats)),
                                   self.dtype))

    def logits(self, feats: torch.Tensor) -> torch.Tensor:
        """The MLP's output before its ReLU, in the compute dtype: [B, A,
        1]."""
        b, a, c, p = feats.shape
        if self.training:
            bf16 = self.dtype == torch.bfloat16 and not self.train_chain_f32
        else:
            bf16 = self.chain_bf16
        x = router_chain(feats.reshape(b * a, c, p), self.taps,
                         self.conv_bias, self.ln_params, self.blocks,
                         bf16=bf16)
        x = x.reshape(b, a, c * p).to(self.dtype or feats.dtype)
        return dense(torch.relu(dense(x, self.dense0)), self.dense1)

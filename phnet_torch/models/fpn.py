"""FPN neck, NCHW inside.

Port of ``phnet_tpu/models/fpn.py``: 1x1 laterals, nearest top-down
upsampling (``jax.image.resize(..., "nearest")`` equals
``mode="nearest-exact"``), 3x3 output convs, extra levels by a stride-2
1x1 max pool, and leading inputs dropped when more levels arrive than
``in_channels`` lists. ``out_channels`` is one width or one per level (the
multi-scale variant's ``fpnV2``): where two neighbouring levels differ, a
1x1 conv (``upsample[i]``) projects the coarser one down before it is
added. It computes in its inputs' dtype (:class:`.resnet.Conv2d`).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from .resnet import Conv2d, lecun_normal_


class FPN(nn.Module):
    def __init__(self, in_channels: Tuple[int, ...] = (128, 256, 512),
                 out_channels: Union[int, Tuple[int, ...]] = 64,
                 num_outs: int = 3):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.num_outs = num_outs
        n = len(in_channels)
        width = ([out_channels] * n if isinstance(out_channels, int)
                 else list(out_channels))
        self.lateral = nn.ModuleList(
            Conv2d(c, w, 1) for c, w in zip(in_channels, width))
        self.upsample = nn.ModuleDict(
            {str(i - 1): Conv2d(width[i], width[i - 1], 1)
             for i in range(1, n) if width[i] != width[i - 1]})
        self.fpn = nn.ModuleList(Conv2d(w, w, 3, padding=1) for w in width)

    def reset_parameters(self, g: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight.data, m.weight[0].numel(), g)
                m.bias.data.zero_()

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        inputs = list(inputs)[-len(self.in_channels):]
        laterals = [conv(x) for conv, x in zip(self.lateral, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = laterals[i]
            if str(i - 1) in self.upsample:
                up = self.upsample[str(i - 1)](up)
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                up, size=laterals[i - 1].shape[-2:], mode="nearest-exact")
        outs = [conv(x) for conv, x in zip(self.fpn, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][..., ::2, ::2])
        return tuple(outs)

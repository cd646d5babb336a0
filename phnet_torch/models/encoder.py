"""Backbone + neck (port of ``phnet_tpu/models/encoder.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..config import ModelConfig
from .fpn import FPN
from .mixed import cast, compute_dtype, widen
from .resnet import ResNetBackbone


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        b = cfg.backbone
        self.backbone = ResNetBackbone(b.depth, b.in_channels)
        self.neck = FPN(cfg.neck.in_channels, cfg.neck.out_channels,
                        cfg.neck.num_outs)

    def reset_parameters(self, g: torch.Generator):
        self.backbone.reset_parameters(g)
        self.neck.reset_parameters(g)

    def forward(self, frames: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """frames [N, H, W, 3] -> FPN levels, each [N, h, w, C] (a
        channels-last view of the NCHW result): strides 8/16/32 from the
        backbone stages ``out_indices`` (1, 2, 3), 4/8/16 from (0, 1, 2).
        The frames are cast to the compute dtype here and the levels come
        out in float32, as the JAX encoder gives them."""
        x = cast(frames.permute(0, 3, 1, 2), self.dtype)
        if torch.is_grad_enabled():
            # NCHW-contiguous for the backward: torch 2.13's CPU convolution
            # backward corrupts memory on this channels-last view at the
            # first stride-2 block
            x = x.contiguous()
        feats = self.backbone(x)
        feats = [feats[i] for i in self.cfg.backbone.out_indices]
        return tuple(widen(o.permute(0, 2, 3, 1), self.dtype)
                     for o in self.neck(feats))

"""Backbone + neck (port of ``phnet_tpu/models/encoder.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ..config import ModelConfig
from .fpn import FPN
from .mixed import cast, compute_dtype, widen
from .resnet import ResNetBackbone
from .revcol import RevColBackbone


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        b = cfg.backbone
        self.revcol = b.kind == "revcol"
        if self.revcol:
            self.backbone = RevColBackbone(
                b.in_channels, b.revcol_layers, b.revcol_num_subnet,
                drop_path=b.revcol_drop_path,
                save_memory=b.revcol_save_memory)
        else:
            self.backbone = ResNetBackbone(b.depth, b.in_channels, b.norm)
        self.neck = FPN(cfg.neck.in_channels, cfg.neck.out_channels,
                        cfg.neck.num_outs)

    def reset_parameters(self, g: torch.Generator):
        self.backbone.reset_parameters(g)
        self.neck.reset_parameters(g)

    def forward(self, frames: torch.Tensor,
                seed: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
        """frames [N, H, W, 3] -> FPN levels, each [N, h, w, C] (a
        channels-last view of the NCHW result): strides 8/16/32 from the
        backbone stages ``out_indices`` (1, 2, 3), 4/8/16 from (0, 1, 2).
        The frames are cast to the compute dtype here and the levels come
        out in float32, as the JAX encoder gives them. RevCol computes in
        float32 from the cast frames (the JAX module has no dtype), and
        the neck casts its levels to the compute dtype, as the JAX FPN
        does; ``seed`` gives RevCol's drop path in train mode."""
        x = cast(frames, self.dtype)
        if self.revcol:
            feats = [f.permute(0, 3, 1, 2)
                     for f in self.backbone(widen(x, self.dtype), seed)]
        else:
            x = x.permute(0, 3, 1, 2)
            if torch.is_grad_enabled():
                # NCHW-contiguous for the backward: torch 2.13's CPU
                # convolution backward corrupts memory on this
                # channels-last view at the first stride-2 block
                x = x.contiguous()
            feats = self.backbone(x)
        feats = [cast(feats[i], self.dtype)
                 for i in self.cfg.backbone.out_indices]
        if self.revcol and feats[0].device.type == "cpu" and (
                torch.is_grad_enabled()):
            feats = [f.contiguous() for f in feats]  # as above
        return tuple(widen(o.permute(0, 2, 3, 1), self.dtype)
                     for o in self.neck(feats))

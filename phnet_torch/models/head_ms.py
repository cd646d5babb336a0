"""Multi-scale dual-branch lane head (the reference's ``Router4OLV2``, run
by ``testOLV3.py``).

Port of ``phnet_tpu/models/head_ms.py``. Per refine stage s (coarse FPN
level first) the anchors are pooled at ``ms_sample_points[s]`` points
over ``ms_channels[s]`` channels (24 x 64, 48 x 32, 96 x 16 on the
preset: a constant 1536 values an anchor) by :func:`bilinear_sample`; a
Conv1d router (:class:`ConvRouter`) scores them; the V2 DynamicConv maps
them into the shared 256-wide decode; the positions (on the preset a
sine table, temperature 64, not normalized) are added to the embedding,
not concatenated, before the 256-wide temporal decoder (ffn 512); each
branch has a cls and a geometry-and-offsets :class:`BranchHead`. The
positions, the decoder's ffn width and the generators' reduction come
from ``cfg.head``; the generators' hidden width is twice the decode's.

Deviation kept from the JAX package (``head_ms.py:12-15``): the
reference's router normalizes with BatchNorm1d inside the per-frame loop;
GroupNorm stands in, as there (statistics of each anchor alone, so the
frame loop carries no normalizer state), with flax's fast variance and
epsilon 1e-6.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..ops.sampler import bilinear_sample
from .dynamic_conv import DynamicConv
from .head import AnchorHead, sample_x_indices
from .positional import AnchorPositionalEncoding
from .resnet import GN_EPS, GroupNorm, lecun_normal_
from .transformer import TemporalDecoder

class ConvRouter(nn.Module):
    """Router of one multi-scale stage (``AdaptiveRouter4LaneV2``,
    ``Router.py:83-132``): Conv1d 3 -> GroupNorm -> ReLU -> Conv1d 1 ->
    GroupNorm -> ReLU over the anchor's [C, P] profile, a linear map to P
    scores, their mean through a sigmoid."""

    def __init__(self, channels: int, points: int, last_channels: int,
                 reduction: int = 2):
        super().__init__()
        mid = max(channels // reduction, 1)
        cl = max(channels // last_channels, 1)
        self.conv1 = nn.Conv1d(channels, mid, 3, padding=1)
        self.norm1 = GroupNorm(min(8, mid), mid, eps=GN_EPS)
        self.conv2 = nn.Conv1d(mid, cl, 1)
        self.norm2 = GroupNorm(min(8, cl), cl, eps=GN_EPS)
        self.out = nn.Linear(points * cl, points)

    def reset_parameters(self, g: torch.Generator):
        for conv in (self.conv1, self.conv2):
            lecun_normal_(conv.weight.data, conv.weight[0].numel(), g)
            conv.bias.data.zero_()
        for norm in (self.norm1, self.norm2):
            norm.reset_parameters()
        fan_in, fan_out = self.out.in_features, self.out.out_features
        bound = math.sqrt(3.0 * (5.0 / 3.0) ** 2 / ((fan_in + fan_out) / 2))
        self.out.weight.data.copy_(
            (torch.rand(self.out.weight.shape, generator=g) * 2 - 1) * bound)
        self.out.bias.data.zero_()

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, A, C, P] -> scores [B, A, 1]."""
        b, a, c, p = feats.shape
        x = torch.relu(self.norm1(self.conv1(feats.reshape(b * a, c, p))))
        x = torch.relu(self.norm2(self.conv2(x)))  # [BA, cl, P]
        score = self.out(x.transpose(1, 2).reshape(b * a, -1))  # point-major
        return torch.sigmoid(score.reshape(b, a, p).mean(-1, keepdim=True))


class BranchHead(nn.Module):
    """``num_fc`` x (Linear + ReLU) and a final Linear (reference
    ``LinearModule`` stacks); flax's ``fc{i}`` and ``out`` Dense layers."""

    FINAL_INIT_STD = 1e-3

    def __init__(self, hidden: int, out_dim: int, num_fc: int):
        super().__init__()
        self.num_fc = num_fc
        for i in range(num_fc):
            self.add_module(f"fc{i}", nn.Linear(hidden, hidden))
        self.out = nn.Linear(hidden, out_dim)

    @property
    def fcs(self):
        return [getattr(self, f"fc{i}") for i in range(self.num_fc)]

    def reset_parameters(self, g: torch.Generator):
        for fc in self.fcs:
            lecun_normal_(fc.weight.data, fc.in_features, g)
            fc.bias.data.zero_()
        for t in (self.out.weight, self.out.bias):
            t.data.copy_(torch.randn(t.shape, generator=g)
                         * self.FINAL_INIT_STD)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fc in self.fcs:
            x = torch.relu(fc(x))
        return self.out(x)


class MultiScaleLaneHead(AnchorHead):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        h, spec = cfg.head, cfg.lane
        d = h.fc_hidden_dim  # the shared decode width
        pts, chs = h.ms_sample_points, h.ms_channels
        for s, p in enumerate(pts):
            self.register_buffer(
                f"sample_x_index_{s}",
                torch.from_numpy(sample_x_indices(spec.n_offsets, p)),
                persistent=False)
            self.register_buffer(f"prior_feat_ys_{s}",
                                 self._sample_ys(spec.n_offsets, p),
                                 persistent=False)
        self.pos_encoding = AnchorPositionalEncoding(
            h.num_priors, d, h.pos_encoding, h.pos_temperature,
            h.pos_normalize)
        self.pro_embedding = nn.Parameter(torch.empty(h.num_priors, d))
        self.dyn_heads = nn.ModuleList(
            DynamicConv(feat_size=pts[s], hidden_dim=chs[s],
                        dim_factor=h.dyn_dim_factor,
                        param_reduction=h.dyn_param_reduction,
                        out_dim=d, out_hidden=2 * d, pro_dim=d,
                        quantize=cfg.quantize)
            for s in range(h.refine_layers))
        self.routers = nn.ModuleList(
            ConvRouter(chs[s], pts[s], last_channels=chs[-1])
            for s in range(h.refine_layers))
        reg_dim = 3 + spec.n_lengths + spec.n_offsets
        self.cls_fir = BranchHead(d, 2, h.num_fc)
        self.reg_fir = BranchHead(d, reg_dim, h.num_fc)
        self.cls_sec = BranchHead(d, 2, h.num_fc)
        self.reg_sec = BranchHead(d, reg_dim, h.num_fc)
        self.temporal_decoder = TemporalDecoder(
            d, h.decoder_layers, h.decoder_heads, h.decoder_ffn_dim,
            h.decoder_dropout)

    def reset_parameters(self, g: torch.Generator):
        super().reset_parameters(g)
        self.pro_embedding.data.copy_(
            torch.randn(self.pro_embedding.shape, generator=g))
        for m in (*self.dyn_heads, *self.routers, self.cls_fir, self.reg_fir,
                  self.cls_sec, self.reg_sec, self.temporal_decoder):
            m.reset_parameters(g)

    def _pool(self, feat: torch.Tensor, priors: torch.Tensor,
              s: int) -> torch.Tensor:
        """feat [B, H, W, C_s], priors [B, A, dim] -> [B, A, P_s, C_s],
        sample points top -> bottom."""
        idx = getattr(self, f"sample_x_index_{s}")
        xs = priors[..., self.spec.col_xs:][..., idx].flip(-1)
        _, hh, ww, _ = feat.shape
        px = xs * (ww - 1)
        py = getattr(self, f"prior_feat_ys_{s}").expand_as(px) * (hh - 1)
        return bilinear_sample(feat, px, py)

    def _branches(self, feat_fir, feat_sec, priors):
        return tuple(self._assemble_reg(priors, cls(f), reg(f))
                     for f, cls, reg in (
                         (feat_fir, self.cls_fir, self.reg_fir),
                         (feat_sec, self.cls_sec, self.reg_sec)))

    def _stage_local(self, s, level, priors, pro_feat, pos, combined):
        """Pool, router score, DynamicConv, attention features of stage s:
        the embedding plus the positions (``Router4OLV2.py:268-270``)."""
        pooled = self._pool(level, priors, s)
        diff = self.routers[s](pooled.transpose(-1, -2).detach())[..., 0]
        decode_feat = self.dyn_heads[s](pro_feat, pooled, combined)
        return diff, decode_feat, decode_feat + pos[None]

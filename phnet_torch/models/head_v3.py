"""Cross-frame prior propagation head (the reference's ``Router4OLV3``).

Port of ``phnet_tpu/models/head_v3.py``. The lanes kept in frame t-1 come
back in frame t as K = ``max_lanes`` extra anchor rows, decoded from their
carried per-stage features by dedicated "_last" stacks: the first branch
(``heads_fir_last``, one fc level at the decode width) reads the content
channels of a carried row, the second (``heads_sec_last``) the carried row
after a 1-layer decoder (``temporal_decoder_last``) let it attend to this
frame's anchors. The predictions are the A regular rows followed by the K
propagated ones (R = A + K); between stages both halves are blended by
the router and refine their own priors.

Routing is a per-row MLP a stage (:class:`MLPRouter`) over the query rows
(the anchors' attention features and the carried rows), and its input
keeps its gradient, unlike the router chain's. The head has no router
chain, so it registers no ``routers``: the JAX head creates no parameters
for the routers its base declares and never calls.

An empty slot gives a *dead row* in both branches: cls logits [20, -20],
zeros for the geometry and lengths, the xs at -2 (off the image). The
carried rows of empty slots are zeroed, they are not self-attention keys
of the K-row decoder (``tgt_mask``) and they keep their priors through
the stages. The gradient stops where the JAX head stops it: at the
embedding handed to the next stage and at the blend weight and the
blended priors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from ..config import ModelConfig
from .head import LaneHead, MergedBranchHeads
from .mixed import cast, dense
from .transformer import TemporalDecoder


class V3HeadOutputs(NamedTuple):
    """Per-stage outputs over R = A + K rows (regular, then propagated)."""

    pred_fir: torch.Tensor    # [S, B, R, dim]
    pred_sec: torch.Tensor    # [S, B, R, dim]
    diff: torch.Tensor        # [S, B, R]
    query_feat: torch.Tensor  # [S, B, R, attn_dim] the rows a carry keeps


class MLPRouter(nn.Module):
    """``AdaptiveRouter4LaneV3`` (reference ``Router.py:134-153``): per row
    Linear(D, D), ReLU, Linear(D, D / r), ReLU, Linear(-> 1), then a
    sigmoid in float32. Dense layers in ``dtype`` (flax's ``fc0``, ``fc1``,
    ``out``)."""

    def __init__(self, dim: int, reduction: int = 4,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fc0 = nn.Linear(dim, dim)
        self.fc1 = nn.Linear(dim, dim // reduction)
        self.out = nn.Linear(dim // reduction, 1)

    def reset_parameters(self, g: torch.Generator):
        for lin in (self.fc0, self.fc1, self.out):
            lin.weight.data.copy_(torch.randn(lin.weight.shape, generator=g)
                                  / math.sqrt(lin.in_features))
            lin.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, N, D] -> scores [B, N] in float32."""
        x = cast(x, self.dtype)
        x = torch.relu(dense(x, self.fc0))
        x = torch.relu(dense(x, self.fc1))
        return torch.sigmoid(dense(x, self.out).float())[..., 0]


class PropagatingLaneHead(LaneHead):
    chain_routers = False

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        h = cfg.head
        d, dt = h.fc_hidden_dim, self.heads_fir.dtype
        self.heads_fir_last = MergedBranchHeads(d, self.out_dims, 1, dt)
        self.heads_sec_last = MergedBranchHeads(2 * d, self.out_dims,
                                                h.num_fc, dt)
        self.temporal_decoder_last = TemporalDecoder(
            2 * d, 1, h.decoder_heads, h.decoder_ffn_dim, h.decoder_dropout,
            dt)
        self.mlp_routers = nn.ModuleList(
            MLPRouter(2 * d, h.router_reduction, dt)
            for _ in range(h.refine_layers))
        spec = cfg.lane
        self.register_buffer("dead_row", torch.cat([
            torch.tensor([20.0, -20.0]), torch.zeros(3 + spec.n_lengths),
            torch.full((spec.n_offsets,), -2.0)]), persistent=False)

    def reset_parameters(self, g: torch.Generator):
        super().reset_parameters(g)
        for m in (self.heads_fir_last, self.heads_sec_last,
                  self.temporal_decoder_last, *self.mlp_routers):
            m.reset_parameters(g)

    def forward(self, fpn_feats: Tuple[torch.Tensor, ...],
                last_feat: torch.Tensor, last_priors: torch.Tensor,
                last_valid: torch.Tensor, dyn_combined=None,
                dropout_gen: Optional[torch.Generator] = None
                ) -> V3HeadOutputs:
        """One frame. fpn_feats: [B, H, W, C] levels fine -> coarse;
        the carry of frame t-1: last_feat [B, S, K, attn_dim], last_priors
        [B, K, dim], last_valid [B, K] bool; dyn_combined:
        :meth:`combine_dynamic`; dropout_gen: the decoders' dropout masks
        (train mode only)."""
        h = self.cfg.head
        a, d = self.num_priors, h.fc_hidden_dim
        levels = tuple(reversed(fpn_feats))
        b = levels[0].shape[0]
        if dyn_combined is None:
            dyn_combined = self.combine_dynamic()
        priors = self.initial_priors()[None].expand(b, -1, -1)
        priors_last = last_priors
        pro_feat = self.pro_embedding[None].expand(b, -1, -1)
        pos = self.pos_encoding()
        alive = last_valid[..., None]
        every_anchor = last_valid.new_ones((b, a))
        preds_fir, preds_sec, diffs, query_feats = [], [], [], []
        for s in range(h.refine_layers):
            pooled = self._pool(levels[s], priors)
            decode_feat = self.dyn_heads[s](pro_feat, pooled, dyn_combined[s])
            pro_feat = decode_feat.detach()
            attn_feat = torch.cat(
                [decode_feat, pos[None].expand_as(decode_feat)], dim=-1)
            mem_s = torch.where(alive, last_feat[:, s], 0.0)
            query_rows = torch.cat([attn_feat, mem_s], dim=1)
            query_feats.append(query_rows)
            diff = self.mlp_routers[s](query_rows)  # [B, R]
            diffs.append(diff)
            fir_full, fir_lines = self._branch(self.heads_fir, decode_feat,
                                               priors)
            decoded = self.temporal_decoder(attn_feat, mem_s, last_valid,
                                            dropout_gen)
            sec_full, sec_lines = self._branch(self.heads_sec, decoded,
                                               priors)
            # the propagated rows: the content channels through the local
            # stack; the carried row, after attending to this frame's
            # anchors, through the global one
            firl_full, firl_lines = self._branch(
                self.heads_fir_last, mem_s[..., :d], priors_last)
            decoded_last = self.temporal_decoder_last(
                mem_s, attn_feat, every_anchor, dropout_gen,
                tgt_mask=last_valid)
            secl_full, secl_lines = self._branch(
                self.heads_sec_last, decoded_last, priors_last)
            firl_full, firl_lines, secl_full, secl_lines = (
                torch.where(alive, x, self.dead_row)
                for x in (firl_full, firl_lines, secl_full, secl_lines))
            preds_fir.append(torch.cat([fir_full, firl_full], dim=1))
            preds_sec.append(torch.cat([sec_full, secl_full], dim=1))
            if s != h.refine_layers - 1:
                w = diff.detach()[..., None]
                w_reg, w_last = w[:, :a], w[:, a:]
                priors = ((1.0 - w_reg) * fir_lines
                          + w_reg * sec_lines).detach()
                blended_last = ((1.0 - w_last) * firl_lines
                                + w_last * secl_lines).detach()
                priors_last = torch.where(alive, blended_last, priors_last)
        return V3HeadOutputs(pred_fir=torch.stack(preds_fir),
                             pred_sec=torch.stack(preds_sec),
                             diff=torch.stack(diffs),
                             query_feat=torch.stack(query_feats))

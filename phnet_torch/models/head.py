"""Dual-branch anchor lane head with 3-stage refinement.

Port of ``phnet_tpu/models/head.py::LaneHead`` (the single-scale head of
VIL-100 and of OpenLane-V's ``Router4OL``, and the base of the
prior-propagation head in ``head_v3.py``: both branch MLP stacks per
stage, no stage-0 hoisting). Per refine stage, coarse FPN level first:

1. pool anchor features along each prior's P sample points (bilinear,
   zero padding, as a one-hot contraction over the level's width);
2. the router scores each anchor;
3. DynamicConv turns the pooled features into an anchor embedding;
4. the first branch decodes the embedding; the second branch decodes it,
   with the anchor positions concatenated, after the temporal decoder
   attended to the memory bank;
5. the router-blended geometry seeds the next stage's priors.

OpenLane's single head differs in two places: a learned positional
embedding in place of the sine table, and the offsets from a head of
their own (``separate_offset_head``) in place of the geometry head's tail.
:class:`AnchorHead` holds what this head shares with the multi-scale one
(``head_ms.py``): the anchors' geometry and the refine loop.

The gradient stops where the JAX package stops it: at the router's input
(the router learns only from the loss blend), at the embedding handed to
the next stage, and at the blend weight and the next stage's priors.
Inference is not changed by them. In train mode the temporal decoder
applies dropout with masks drawn from the generator :meth:`AnchorHead.forward`
is given.

With ``compute_dtype="bfloat16"`` the head computes as the JAX package's
does: the pooling reads the float32 levels the encoder gives and stays
float32, the router's chain too (unless ``router_chain_bf16``);
DynamicConv, the router's MLP, the temporal decoder and the branch heads
compute in bf16 and hand float32 on (the branch heads cast their outputs,
where ``phnet_tpu/models/head.py:155,393`` casts them, so that the
assignment and the criterion see float32 in training). The geometry, the
positions and the memory stay float32. In training the router's chain
runs in bf16 unless ``router_train_chain_f32`` (``models/router.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import ModelConfig
from ..device import full_f32
from ..geometry import build_prior_embeddings
from .dynamic_conv import DynamicConv
from .mixed import cast, compute_dtype, widen
from .positional import AnchorPositionalEncoding
from .router import AdaptiveRouter
from .transformer import TemporalDecoder


class HeadOutputs(NamedTuple):
    """Per-stage outputs of one frame (S = refine stages)."""

    pred_fir: torch.Tensor   # [S, B, A, dim]
    pred_sec: torch.Tensor   # [S, B, A, dim]
    diff: torch.Tensor       # [S, B, A]
    attn_feat: torch.Tensor  # [S, B, A, attn_dim]


def sample_x_indices(n_offsets: int, sample_points: int) -> np.ndarray:
    """``(linspace(0, 1, P) * n_strips).long()`` (reference
    ``RouterV4.py:58-60``)."""
    return (np.linspace(0, 1, sample_points, dtype=np.float32)
            * (n_offsets - 1)).astype(np.int64)


class MergedBranchHeads(nn.Module):
    """One branch's heads (cls, geometry + offsets): ``num_fc`` levels of
    (Linear + ReLU) stacked over the head dimension, then a per-head
    linear. Parameters keep the flax layout: ``fc{i}_kernel [n, din, h]``,
    ``fc{i}_bias [n, h]``, ``out{i}_kernel [h, d_o]``, ``out{i}_bias``.
    Computes in ``dtype`` (each product rounded to it, then its bias added
    in it) and gives float32."""

    FINAL_INIT_STD = 1e-3

    def __init__(self, hidden: int, out_dims: Tuple[int, ...], num_fc: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        n = len(out_dims)
        self.num_fc, self.out_dims = num_fc, tuple(out_dims)
        for i in range(num_fc):
            self.register_parameter(f"fc{i}_kernel", nn.Parameter(
                torch.empty(n, hidden, hidden)))
            self.register_parameter(f"fc{i}_bias",
                                    nn.Parameter(torch.empty(n, hidden)))
        for i, d_o in enumerate(out_dims):
            self.register_parameter(f"out{i}_kernel",
                                    nn.Parameter(torch.empty(hidden, d_o)))
            self.register_parameter(f"out{i}_bias",
                                    nn.Parameter(torch.empty(d_o)))

    def reset_parameters(self, g: torch.Generator):
        for name, p in self.named_parameters():
            if name.startswith("fc") and name.endswith("kernel"):
                p.data.copy_(torch.randn(p.shape, generator=g)
                             / math.sqrt(p.shape[1]))
            elif name.startswith("fc"):
                p.data.zero_()
            else:
                p.data.copy_(torch.randn(p.shape, generator=g)
                             * self.FINAL_INIT_STD)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x [B, A, din] -> one [B, A, d_o] float32 tensor per head."""
        dt = self.dtype
        y = cast(x, dt).unsqueeze(-3)  # [B, 1, A, din] against [n, din, h]
        for i in range(self.num_fc):
            w = cast(getattr(self, f"fc{i}_kernel"), dt)
            b = cast(getattr(self, f"fc{i}_bias"), dt)
            y = torch.relu(y @ w + b[:, None])  # [B, n, A, h]
        return tuple(
            widen(y[..., i, :, :] @ cast(getattr(self, f"out{i}_kernel"), dt)
                  + cast(getattr(self, f"out{i}_bias"), dt), dt)
            for i in range(len(self.out_dims)))


class AnchorHead(nn.Module):
    """The anchors' geometry and the refine loop of both head variants.
    A subclass builds ``prior_embeddings``' companions (``pro_embedding``,
    the per-stage modules, ``temporal_decoder``) and defines
    :meth:`_stage_local` and :meth:`_branches`."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h, spec = cfg.head, cfg.lane
        self.cfg, self.spec = cfg, spec
        self.num_priors = h.num_priors
        self.register_buffer(
            "prior_ys", torch.from_numpy(np.linspace(
                1.0, 0.0, spec.n_offsets, dtype=np.float32)),
            persistent=False)
        self.prior_embeddings = nn.Parameter(torch.empty(h.num_priors, 3))

    def reset_parameters(self, g: torch.Generator):
        self.prior_embeddings.data.copy_(
            torch.from_numpy(build_prior_embeddings(self.num_priors)))

    # -- geometry ----------------------------------------------------------
    def _line_xs(self, start_y, start_x, theta):
        """Normalized xs of the straight line through (start_x, start_y) at
        angle theta, over the offset rows (``RouterV4.py:160-170``)."""
        w1 = self.cfg.img_w - 1
        return (start_x * w1 + (1.0 - self.prior_ys - start_y)
                * self.cfg.img_h / torch.tan(theta * math.pi + 1e-5)) / w1

    def initial_priors(self) -> torch.Tensor:
        emb = self.prior_embeddings
        xs = self._line_xs(emb[:, 0:1], emb[:, 1:2], emb[:, 2:3])
        a = self.num_priors
        zeros = emb.new_zeros
        return torch.cat([zeros(a, 2), emb, zeros(a, self.spec.n_lengths),
                          xs], dim=-1)

    @staticmethod
    def _sample_ys(n_offsets: int, sample_points: int) -> torch.Tensor:
        """Normalized pixel-y (0 = top) of the P sample points, top ->
        bottom."""
        idx = sample_x_indices(n_offsets, sample_points)
        return torch.from_numpy(np.flip(
            1.0 - idx.astype(np.float32) / (n_offsets - 1)).copy())

    def _assemble(self, priors, cls_logits, reg_geo, offsets):
        """Head outputs -> (full predictions with offsets, lines without).
        reg_geo [B, A, 3 + n_lengths], offsets [B, A, O]."""
        geo = priors[..., 2:5] + torch.tanh(reg_geo[..., :3])
        lengths = reg_geo[..., 3:]
        xs_line = self._line_xs(geo[..., 0:1], geo[..., 1:2], geo[..., 2:3])
        full = torch.cat([cls_logits, geo, lengths, xs_line + offsets],
                         dim=-1)
        lines = torch.cat([cls_logits, geo, lengths, xs_line], dim=-1)
        return full, lines

    def _assemble_reg(self, priors, cls_logits, reg):
        """:meth:`_assemble` of a geometry head whose output ends in the
        offsets."""
        n_geo = 3 + self.spec.n_lengths
        return self._assemble(priors, cls_logits, reg[..., :n_geo],
                              reg[..., n_geo:])

    @full_f32()
    def combine_dynamic(self):
        """The collapsed (and, with ``cfg.quantize``, pre-quantized)
        DynamicConv weights of every stage: compute once per weight set,
        outside the frame loop; float32 whatever the TF32 flags say."""
        return tuple(dyn.combine_weights() for dyn in self.dyn_heads)

    def forward(self, fpn_feats: Tuple[torch.Tensor, ...],
                memory_values: torch.Tensor, memory_mask: torch.Tensor,
                dyn_combined=None,
                dropout_gen: Optional[torch.Generator] = None
                ) -> HeadOutputs:
        """One frame. fpn_feats: [B, H, W, C] levels fine -> coarse (stage
        s reads level ``-1 - s``); memory_values [B, S, M, attn_dim];
        memory_mask [B, M] bool; dyn_combined: :meth:`combine_dynamic`;
        dropout_gen: the decoder's dropout masks (train mode only)."""
        h = self.cfg.head
        levels = tuple(reversed(fpn_feats))
        b = levels[0].shape[0]
        if dyn_combined is None:
            dyn_combined = self.combine_dynamic()
        priors = self.initial_priors()[None].expand(b, -1, -1)
        pro_feat = self.pro_embedding[None].expand(b, -1, -1)
        pos = self.pos_encoding()
        preds_fir, preds_sec, diffs, attn_feats = [], [], [], []
        for s in range(h.refine_layers):
            diff, decode_feat, attn_feat = self._stage_local(
                s, levels[s], priors, pro_feat, pos, dyn_combined[s])
            diffs.append(diff)
            attn_feats.append(attn_feat)
            pro_feat = decode_feat.detach()
            decoded = self.temporal_decoder(attn_feat, memory_values[:, s],
                                            memory_mask, dropout_gen)
            (fir_full, fir_lines), (sec_full, sec_lines) = self._branches(
                decode_feat, decoded, priors)
            preds_fir.append(fir_full)
            preds_sec.append(sec_full)
            if s != h.refine_layers - 1:
                w = diff.detach()[..., None]
                priors = ((1.0 - w) * fir_lines + w * sec_lines).detach()
        return HeadOutputs(pred_fir=torch.stack(preds_fir),
                           pred_sec=torch.stack(preds_sec),
                           diff=torch.stack(diffs),
                           attn_feat=torch.stack(attn_feats))


class LaneHead(AnchorHead):
    # the router chain of each stage (``AdaptiveRouter``); the
    # prior-propagation head routes with per-row MLPs and has none, as the
    # JAX package creates no parameters for routers its head never calls
    chain_routers = True

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        h, spec = cfg.head, cfg.lane
        self.register_buffer(
            "sample_x_index",
            torch.from_numpy(sample_x_indices(spec.n_offsets,
                                              h.sample_points)),
            persistent=False)
        self.register_buffer(
            "prior_feat_ys", self._sample_ys(spec.n_offsets, h.sample_points),
            persistent=False)
        self.pos_encoding = AnchorPositionalEncoding(
            h.num_priors, h.fc_hidden_dim, h.pos_encoding, h.pos_temperature,
            h.pos_normalize)
        self.pro_embedding = nn.Parameter(
            torch.empty(h.num_priors, h.prior_feat_channels))
        dt = compute_dtype(cfg)
        self.dyn_heads = nn.ModuleList(
            DynamicConv(feat_size=h.sample_points, hidden_dim=h.fc_hidden_dim,
                        dim_factor=h.dyn_dim_factor,
                        param_reduction=h.dyn_param_reduction,
                        out_expand=h.dyn_out_expand,
                        pro_dim=(h.prior_feat_channels if s == 0
                                 else h.fc_hidden_dim),
                        quantize=cfg.quantize, dtype=dt)
            for s in range(h.refine_layers))
        self.routers = nn.ModuleList(
            AdaptiveRouter(h.num_priors, h.prior_feat_channels,
                           h.sample_points, h.router_reduction,
                           h.router_blocks, dtype=dt,
                           chain_bf16=bool(h.router_chain_bf16),
                           train_chain_f32=h.router_train_chain_f32)
            for _ in range(h.refine_layers if self.chain_routers else 0))
        d = h.fc_hidden_dim
        n_geo = 3 + spec.n_lengths
        # (cls, geometry[, offsets]) output widths
        self.out_dims = out_dims = (
            (2, n_geo, spec.n_offsets) if h.separate_offset_head
            else (2, n_geo + spec.n_offsets))
        self.heads_fir = MergedBranchHeads(d, out_dims, h.num_fc, dt)
        self.heads_sec = MergedBranchHeads(2 * d, out_dims, h.num_fc, dt)
        self.temporal_decoder = TemporalDecoder(
            2 * d, h.decoder_layers, h.decoder_heads, h.decoder_ffn_dim,
            h.decoder_dropout, dt)

    def reset_parameters(self, g: torch.Generator):
        super().reset_parameters(g)
        self.pro_embedding.data.copy_(
            torch.randn(self.pro_embedding.shape, generator=g))
        for m in (*self.dyn_heads, *self.routers, self.heads_fir,
                  self.heads_sec, self.temporal_decoder, self.pos_encoding):
            m.reset_parameters(g)

    def _pool(self, feat: torch.Tensor, priors: torch.Tensor) -> torch.Tensor:
        """feat [B, H, W, C] (one FPN level), priors [B, A, dim] ->
        [B, A, P, C], sample points top -> bottom. Bilinear with zero
        padding: the rows of a stage are static, so the two neighbouring
        feature rows are lerped once, and the x interpolation is a weight
        matrix [B, A, P, W] that is zero outside [0, W-1]."""
        xs_rows = priors[..., self.spec.col_xs:][..., self.sample_x_index]
        px = xs_rows.flip(-1) * (feat.shape[2] - 1)  # [B, A, P]
        hh = feat.shape[1]
        py = self.prior_feat_ys * (hh - 1)
        y0 = torch.floor(py)
        wy = (py - y0)[None, :, None, None]
        y0 = y0.long()
        y1 = torch.clamp(y0 + 1, max=hh - 1)
        rows = feat[:, y0] * (1.0 - wy) + feat[:, y1] * wy
        x0 = torch.floor(px)
        wx = (px - x0)[..., None]
        cols = torch.arange(feat.shape[2], device=feat.device,
                            dtype=px.dtype)
        weight = (torch.where(cols == x0[..., None], 1.0 - wx, 0.0)
                  + torch.where(cols == x0[..., None] + 1.0, wx, 0.0))
        # [B, P, A, W] @ [B, P, W, C] -> [B, P, A, C]
        return (weight.transpose(1, 2) @ rows).transpose(1, 2)

    def _branch(self, heads, feat, priors):
        if self.cfg.head.separate_offset_head:
            return self._assemble(priors, *heads(feat))
        return self._assemble_reg(priors, *heads(feat))

    def _branches(self, feat_fir, feat_sec, priors):
        """Both branches' heads. The JAX package stacks the two MLP stacks
        into one zero-padded batched product; the padded channels are exact
        zeros, so running them one after the other is the same function."""
        return (self._branch(self.heads_fir, feat_fir, priors),
                self._branch(self.heads_sec, feat_sec, priors))

    def _stage_local(self, s, level, priors, pro_feat, pos, combined):
        """Pool, router score, DynamicConv, attention features of stage s:
        the embedding with the positions concatenated."""
        pooled = self._pool(level, priors)  # [B, A, P, C]
        diff = self.routers[s](pooled.transpose(-1, -2).detach())[..., 0]
        decode_feat = self.dyn_heads[s](pro_feat, pooled, combined)
        attn_feat = torch.cat(
            [decode_feat, pos[None].expand_as(decode_feat)], dim=-1)
        return diff, decode_feat, attn_feat

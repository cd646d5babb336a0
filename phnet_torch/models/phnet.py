"""PHNet clip model (port of ``phnet_tpu/models/phnet.py``): inference and
training.

The encoder runs over all clip frames as one batch; the head then runs
frame by frame in a Python loop, carrying a fixed-shape memory from frame
to frame. Every head of both datasets runs inference and trains, in
float32 and bfloat16, chosen by ``cfg.head``: VIL-100's and OpenLane-V's
single-scale ``LaneHead`` (``Router4OL``), the multi-scale
``MultiScaleLaneHead`` (``Router4OLV2``, ``variant="multi"``) and the
prior-propagation ``PropagatingLaneHead`` (``Router4OLV3``,
``propagate_priors``).

The memory. The first two heads carry a ring of positive-lane features
``[B, S, W, L+1, attn_dim]`` with a slot mask (:class:`MemoryState`);
the prior-propagation head carries one frame (:class:`V3MemoryState`):
the query rows of the kept lanes at every stage, their routed predictions
as the next frame's extra priors, and the slots' validity.

Inference (:meth:`PHNet.forward`, :meth:`PHNet.detect`): each frame's
routed predictions go through the confidence filter and lane NMS (the CUDA
kernel on the card; over A + K rows for the prior-propagation head); the
ring takes the kept rows plus one mean-negative row, the one-frame carry
the kept rows (the first K keeps) and their routed predictions. With
``compute_dtype="bfloat16"`` the memory stays float32 and the routed
predictions that reach lane NMS are float32.

Training (:meth:`PHNet.train_forward`, the model in train mode): BatchNorm
on batch statistics, decoder dropout, RevCol's drop path, and per frame
one batched Hungarian solve on the detached predictions of both branches
and every stage. The ring takes, per stage, the features of that stage's
own second-branch matches (the labels' valid column marks the slots),
with their gradient, at ``t % window`` (VIL's ring holds the clip, OL's
wraps every 5 frames);
the one-frame carry takes the last stage's second-branch matches at every
stage, detached, and their detached predictions, with the labels' valid
column as its mask. The JAX package clips an unmatched index (-1) to row
0, and so does the port. ``remat_frames`` recomputes each frame's head in
the backward; the solve and the memory update stay outside the
recomputed region. In bfloat16 the head's outputs reach the assignment
and the criterion in float32, and the memory stays float32. Quantized
configurations do not train.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..device import full_f32, resolve_device
from ..losses.assign import train_assign
from ..ops.nms import nms_keeps
from .encoder import Encoder
from .head import HeadOutputs, LaneHead
from .head_ms import MultiScaleLaneHead
from .head_v3 import PropagatingLaneHead


class MemoryState(NamedTuple):
    """values [B, S, W, L+1, D]; mask [B, W, L+1] bool; t: frames written
    (the ring position of the next write is ``t % W``), a Python int, or
    a 0-d integer tensor in a traced step (``phnet_torch.export``)."""

    values: torch.Tensor
    mask: torch.Tensor
    t: Union[int, torch.Tensor]


class InferFrameOut(NamedTuple):
    kept: torch.Tensor        # [B, K, dim] routed predictions at the keeps
    kept_valid: torch.Tensor  # [B, K] bool
    num_kept: torch.Tensor    # [B]
    keep_idx: torch.Tensor    # [B, K] kept anchors, -1 = empty slot


class TrainFrameOut(NamedTuple):
    """The training forward's outputs, stacked over the clip's T frames."""

    pred_fir: torch.Tensor     # [T, S, B, A, dim]
    pred_sec: torch.Tensor     # [T, S, B, A, dim]
    diff: torch.Tensor         # [T, S, B, A]
    matched_sec: torch.Tensor  # [T, S, B, L] second-branch matches
    matched_fir: torch.Tensor  # [T, S, B, L] first-branch matches


def frame_seed(seed: int, frame: int) -> int:
    """The dropout seed of one frame of a step seeded ``seed``."""
    return (seed * 1_000_003 + frame) % 2 ** 63


class V3MemoryState(NamedTuple):
    """The prior-propagation head's carry: one frame of kept rows.
    feat [B, S, K, attn_dim] (their query rows per stage); priors [B, K,
    dim] (their predictions, the next frame's extra priors); mask [B, K]
    bool; t: frames seen (an int, or a 0-d integer tensor in a traced
    step)."""

    feat: torch.Tensor
    priors: torch.Tensor
    mask: torch.Tensor
    t: Union[int, torch.Tensor]


def init_memory(cfg: ModelConfig, batch: int, window: int, device=None):
    """An empty memory: a ring of ``window`` frames (:class:`MemoryState`)
    or, for the prior-propagation head, an empty one-frame carry
    (:class:`V3MemoryState`; ``window`` is not read)."""
    h = cfg.head
    if h.propagate_priors:
        k = cfg.max_lanes
        return V3MemoryState(
            feat=torch.zeros((batch, h.refine_layers, k, h.attn_dim),
                             device=device),
            priors=torch.zeros((batch, k, cfg.lane.dim), device=device),
            mask=torch.zeros((batch, k), dtype=torch.bool, device=device),
            t=0)
    slots = cfg.max_lanes + 1
    return MemoryState(
        values=torch.zeros((batch, h.refine_layers, window, slots,
                            h.attn_dim), device=device),
        mask=torch.zeros((batch, window, slots), dtype=torch.bool,
                         device=device),
        t=0)


def route_predictions(cfg: ModelConfig, out: HeadOutputs) -> torch.Tensor:
    """Final-stage predictions routed by the mean router score: hard (VIL)
    selects the second branch where it is >= 0.5, soft (OL) blends."""
    diff_mean = out.diff.mean(dim=0)[..., None]  # [B, A, 1]
    fir, sec = out.pred_fir[-1], out.pred_sec[-1]
    if cfg.routing == "hard":
        return torch.where(diff_mean >= 0.5, sec, fir)
    return diff_mean * sec + (1.0 - diff_mean) * fir


def write_memory(mem: MemoryState, attn_feat: torch.Tensor,
                 slot_idx: torch.Tensor,
                 slot_valid: Optional[torch.Tensor] = None) -> MemoryState:
    """Write one frame into the ring at ``t % W``: per stage, the features
    of the kept anchors and one negative row, the mean of the anchors not
    kept. ``slot_idx`` is [B, L] (the same anchors for every stage) or
    [S, B, L] (each stage its own, as in training); invalid slots
    (``slot_valid`` [B, L], by default ``slot_idx >= 0``) are zeroed.
    Distinct anchors per stage and stream. Returns a new state; ``mem``
    is not modified, and gradients flow into the written rows. A tensor
    ``t`` (a traced step) writes with ``index_copy`` at the position it
    holds: a copy, as the int's slice assignment, so the rows are the
    same bits."""
    s, b, a, d = attn_feat.shape
    if slot_valid is None:
        slot_valid = slot_idx >= 0
    idx = slot_idx.clamp(0, a - 1).expand(s, b, -1)
    pos = torch.gather(attn_feat, 2, idx[..., None].expand(-1, -1, -1, d))
    pos = pos * slot_valid[None, :, :, None]  # [S, B, L, D]
    n_pos = slot_valid.sum(-1).to(attn_feat.dtype)  # [B]
    neg = (attn_feat.sum(2) - pos.sum(2)) / torch.clamp(
        a - n_pos, min=1.0)[None, :, None]  # [S, B, D]
    frame_vals = torch.cat([pos, neg[:, :, None]], dim=2).transpose(0, 1)
    frame_mask = torch.cat(
        [slot_valid, slot_valid.new_ones((b, 1))], dim=1)
    if isinstance(mem.t, torch.Tensor):
        w_idx = (mem.t % mem.values.shape[2]).reshape(1).long()
        values = mem.values.index_copy(
            2, w_idx, frame_vals[:, :, None].to(mem.values.dtype))
        mask = mem.mask.index_copy(1, w_idx, frame_mask[:, None])
        return MemoryState(values=values, mask=mask, t=mem.t + 1)
    w_pos = mem.t % mem.values.shape[2]
    values = mem.values.clone()
    mask = mem.mask.clone()
    values[:, :, w_pos] = frame_vals
    mask[:, w_pos] = frame_mask
    return MemoryState(values=values, mask=mask, t=mem.t + 1)


def carry_rows(mem: V3MemoryState, query_feat: torch.Tensor,
               rows: torch.Tensor, slot_idx: torch.Tensor,
               slot_valid: torch.Tensor) -> V3MemoryState:
    """The next one-frame carry: for each of the K slots (``slot_idx`` [B,
    K] into the R rows, -1 for none), the query rows of every stage
    (``query_feat`` [S, B, R, D], zeroed where ``slot_valid`` [B, K] is
    False) and the prediction ``rows`` [B, R, dim]. An index of -1 reads
    row 0, as the JAX package's clip makes it."""
    s, b, r, d = query_feat.shape
    idx = slot_idx.clamp(0, r - 1)
    feat = torch.gather(query_feat, 2,
                        idx[None, :, :, None].expand(s, -1, -1, d))
    feat = torch.where(slot_valid[None, :, :, None], feat, 0.0)
    priors = torch.gather(rows, 1, idx[..., None].expand(
        -1, -1, rows.shape[-1]))
    return V3MemoryState(feat=feat.transpose(0, 1), priors=priors,
                         mask=slot_valid, t=mem.t + 1)


def head_memory(mem):
    """The memory as the head reads it: the ring flattened to [B, S, W *
    (L+1), D] and its mask to [B, W * (L+1)], or the one-frame carry's
    (feat, priors, mask)."""
    if isinstance(mem, V3MemoryState):
        return mem.feat, mem.priors, mem.mask
    b, s, window, slots = mem.values.shape[:4]
    return (mem.values.reshape(b, s, window * slots, -1),
            mem.mask.reshape(b, window * slots))


def check_trainable(cfg: ModelConfig):
    """ValueError for a configuration that does not train: a quantized
    one (``round()`` has no useful gradient)."""
    if cfg.quantize != "none":
        raise ValueError(
            f"quantize={cfg.quantize!r} is inference-only (round() has "
            f"no useful gradient); train with quantize='none'")


class PHNet(nn.Module):
    """Full clip model. Frames are [B, T, H, W, 3] (normalized).

    ``device=None`` builds on the card; the parameters are left
    uninitialized: load a state dict (``phnet_torch.convert``) or call
    :meth:`reset_parameters` with a generator. :meth:`forward`,
    :meth:`encode`, :meth:`frame_step` and :meth:`train_forward` compute
    in float32 whatever the process's TF32 flags say
    (:func:`~phnet_torch.device.full_f32`); a training step also runs its
    backward inside ``full_f32``. Built in eval mode; ``train()`` before
    :meth:`train_forward`."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device(dev):
            self.encoder = Encoder(cfg)
            if cfg.head.propagate_priors:
                self.head = PropagatingLaneHead(cfg)
            elif cfg.head.variant == "multi":
                self.head = MultiScaleLaneHead(cfg)
            else:
                self.head = LaneHead(cfg)
        self.to(dev)
        self.eval()

    def reset_parameters(self, g: torch.Generator):
        """Random weights from ``g`` (drawn on the CPU, so one seed gives
        the same weights on every device)."""
        with torch.no_grad():
            self.encoder.reset_parameters(g)
            self.head.reset_parameters(g)

    @full_f32()
    def encode(self, frames: torch.Tensor, seed: Optional[int] = None):
        """Backbone + FPN over all clip frames; tuple of [T, B, h, w, c].
        ``seed`` seeds RevCol's drop path in train mode (one mask an image
        of the B * T batch and block, as the JAX encoder draws them)."""
        b, t = frames.shape[:2]
        feats = self.encoder(frames.reshape((b * t,) + frames.shape[2:]),
                             seed)
        return tuple(f.reshape((b, t) + f.shape[1:]).transpose(0, 1)
                     for f in feats)

    def nms_keeps(self, routed: torch.Tensor):
        """Confidence filter + lane NMS on routed predictions [B, A, dim]
        (one softmax and one kernel launch on the card).
        Returns (kept [B, topk, dim], keep_idx [B, topk], num_kept [B])."""
        cfg = self.cfg
        scores = torch.softmax(routed[..., :2], dim=-1)[..., 1]
        kept, keep_idx, num_kept, _ = nms_keeps(
            routed, scores, cfg.lane, cfg.img_w, cfg.test.conf_threshold,
            cfg.test.nms_thres, cfg.test.nms_topk)
        return kept, keep_idx, num_kept

    @full_f32()
    def frame_step(self, feats, mem, dyn_combined):
        """One frame: head, routing, keeps, memory update. feats: tuple of
        [B, h, w, c] levels. Returns (InferFrameOut, new memory, routed
        predictions [B, R, dim]; R = A, or A + K with prior
        propagation)."""
        cfg = self.cfg
        b, k = feats[0].shape[0], cfg.max_lanes
        out = self.head(feats, *head_memory(mem), dyn_combined)
        routed = route_predictions(cfg, out)
        kept, keep_idx, num_kept = self.nms_keeps(routed)
        slot_idx = torch.full((b, k), -1, dtype=keep_idx.dtype,
                              device=keep_idx.device)
        n = min(keep_idx.shape[1], k)
        slot_idx[:, :n] = keep_idx[:, :n]
        if isinstance(mem, V3MemoryState):
            new_mem = carry_rows(mem, out.query_feat, routed, slot_idx,
                                 slot_idx >= 0)
        else:
            new_mem = write_memory(mem, out.attn_feat, slot_idx)
        out = InferFrameOut(kept=kept, kept_valid=keep_idx >= 0,
                            num_kept=num_kept, keep_idx=keep_idx)
        return out, new_mem, routed

    @torch.no_grad()
    def detect(self, feats, initial_memory: Optional[MemoryState] = None,
               dyn_combined=None):
        """Frame loop over FPN features (tuple of [T, B, h, w, c]).
        Returns (InferFrameOut with a leading T axis, final memory)."""
        t, b = feats[0].shape[:2]
        cfg = self.cfg
        window = cfg.memory.window if cfg.memory.window > 0 else t
        mem = (initial_memory if initial_memory is not None
               else init_memory(cfg, b, window, feats[0].device))
        if dyn_combined is None:
            dyn_combined = self.head.combine_dynamic()
        outs = []
        for i in range(t):
            out, mem, _ = self.frame_step(tuple(f[i] for f in feats), mem,
                                          dyn_combined)
            outs.append(out)
        return InferFrameOut(*(torch.stack(x) for x in zip(*outs))), mem

    @torch.no_grad()
    @full_f32()
    def forward(self, frames: torch.Tensor,
                initial_memory: Optional[MemoryState] = None,
                dyn_combined=None):
        return self.detect(self.encode(frames), initial_memory, dyn_combined)

    def _train_head(self, feats, memory, combined, seed):
        """One frame's head in training on ``memory`` (:func:`head_memory`);
        dropout masks from ``seed`` (the same masks again when the backward
        recomputes the frame)."""
        gen = None
        if seed is not None and self.cfg.head.decoder_dropout > 0.0:
            gen = torch.Generator(device=feats[0].device).manual_seed(seed)
        return self.head(feats, *memory, combined, gen)

    @full_f32()
    def train_forward(self, frames: torch.Tensor, labels: torch.Tensor,
                      dropout_seed: Optional[int] = None):
        """The training forward over a clip: frames [B, T, H, W, 3],
        labels [B, T, L, dim] (the label encoder's layout). Train mode
        gives BatchNorm on batch statistics (updating the running ones)
        and, with a ``dropout_seed``, decoder dropout and RevCol's drop
        path. Returns (:class:`TrainFrameOut`, final memory)."""
        cfg = self.cfg
        check_trainable(cfg)
        feats = self.encode(frames, dropout_seed)
        t, b = feats[0].shape[:2]
        s, window = cfg.head.refine_layers, (
            cfg.memory.window if cfg.memory.window > 0 else t)
        mem = init_memory(cfg, b, window, frames.device)
        combined = self.head.combine_dynamic()
        labels_t = labels.transpose(0, 1)
        remat = cfg.remat_frames and torch.is_grad_enabled()
        outs = []
        for i in range(t):
            args = (tuple(f[i] for f in feats), head_memory(mem), combined,
                    None if dropout_seed is None else frame_seed(
                        dropout_seed, i))
            if remat:
                out = checkpoint(self._train_head, *args, use_reentrant=False,
                                 preserve_rng_state=False)
            else:
                out = self._train_head(*args)
            label = labels_t[i]
            valid = label[..., 1] == 1.0
            both = torch.cat([out.pred_fir, out.pred_sec]).detach()
            matched = train_assign(cfg, both,
                                   label.expand(2 * s, *label.shape),
                                   valid.expand(2 * s, *valid.shape))
            if isinstance(mem, V3MemoryState):
                mem = carry_rows(mem, out.query_feat.detach(),
                                 out.pred_sec[-1].detach(), matched[-1],
                                 valid)
            else:
                mem = write_memory(mem, out.attn_feat, matched[s:], valid)
            outs.append(TrainFrameOut(out.pred_fir, out.pred_sec, out.diff,
                                      matched[s:], matched[:s]))
        return TrainFrameOut(*(torch.stack(x) for x in zip(*outs))), mem

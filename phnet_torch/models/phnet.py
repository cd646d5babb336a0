"""PHNet clip model (port of ``phnet_tpu/models/phnet.py``): inference and
training.

The encoder runs over all clip frames as one batch; the head then runs
frame by frame in a Python loop, carrying a fixed-shape ring memory of
positive-lane features ``[B, S, W, L+1, attn_dim]`` with a slot mask.

Inference (:meth:`PHNet.forward`, :meth:`PHNet.detect`): each frame's
routed predictions go through the confidence filter and lane NMS (the CUDA
kernel on the card), and the kept rows plus one mean-negative row are
written into the ring.

Both OpenLane-V heads run inference: the single-scale ``LaneHead`` with
OL's options and the multi-scale ``MultiScaleLaneHead``, chosen by
``cfg.head.variant``. ``compute_dtype="bfloat16"`` runs the single-scale
head's inference in the JAX package's mixed precision: the memory ring
stays float32 and the routed predictions that reach lane NMS are float32.

Training (:meth:`PHNet.train_forward`, the model in train mode; VIL-100
and OpenLane-V's single head ``Router4OL``, in float32 and bfloat16; the
multi-scale head does not train yet): BatchNorm on batch statistics,
decoder dropout, and per frame one batched Hungarian solve on the
detached predictions of both branches and every stage; each stage writes
the features of its own second-branch matches (the labels' valid column
marks the slots) into the ring, with their gradient, at ``t % window``
(VIL's ring holds the clip, OL's wraps every 5 frames). ``remat_frames``
recomputes each frame's head in the backward; the solve and the memory
write stay outside the recomputed region. In bfloat16 the head's outputs
reach the assignment and the criterion in float32, and the ring stays
float32. Quantized configurations do not train.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


class MemoryState(NamedTuple):
    """values [B, S, W, L+1, D]; mask [B, W, L+1] bool; t: frames written
    (the ring position of the next write is ``t % W``)."""

    values: torch.Tensor
    mask: torch.Tensor
    t: int


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


def init_memory(cfg: ModelConfig, batch: int, window: int,
                device=None) -> MemoryState:
    h = cfg.head
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
    is not modified, and gradients flow into the written rows."""
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
    w_pos = mem.t % mem.values.shape[2]
    values = mem.values.clone()
    mask = mem.mask.clone()
    values[:, :, w_pos] = frame_vals
    mask[:, w_pos] = frame_mask
    return MemoryState(values=values, mask=mask, t=mem.t + 1)


def check_trainable(cfg: ModelConfig):
    """ValueError for a configuration the port cannot train yet: the
    multi-scale head (``Router4OLV2``)."""
    if cfg.head.variant == "multi":
        raise ValueError("training the multi-scale OpenLane-V head "
                         "(Router4OLV2) is not ported yet; the port trains "
                         "VIL-100 and the single head (openlane_config)")


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
            self.head = (MultiScaleLaneHead(cfg) if cfg.head.variant == "multi"
                         else LaneHead(cfg))
        self.to(dev)
        self.eval()

    def reset_parameters(self, g: torch.Generator):
        """Random weights from ``g`` (drawn on the CPU, so one seed gives
        the same weights on every device)."""
        with torch.no_grad():
            self.encoder.reset_parameters(g)
            self.head.reset_parameters(g)

    @full_f32()
    def encode(self, frames: torch.Tensor):
        """Backbone + FPN over all clip frames; tuple of [T, B, h, w, c]."""
        b, t = frames.shape[:2]
        feats = self.encoder(frames.reshape((b * t,) + frames.shape[2:]))
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
    def frame_step(self, feats, mem: MemoryState, dyn_combined):
        """One frame: head, routing, keeps, memory write. feats: tuple of
        [B, h, w, c] levels. Returns (InferFrameOut, new memory, routed
        predictions [B, A, dim])."""
        cfg = self.cfg
        b, s = feats[0].shape[0], cfg.head.refine_layers
        window, slots = mem.values.shape[2:4]
        out = self.head(feats,
                        mem.values.reshape(b, s, window * slots, -1),
                        mem.mask.reshape(b, window * slots), dyn_combined)
        routed = route_predictions(cfg, out)
        kept, keep_idx, num_kept = self.nms_keeps(routed)
        slot_idx = torch.full((b, cfg.max_lanes), -1, dtype=keep_idx.dtype,
                              device=keep_idx.device)
        slot_idx[:, :keep_idx.shape[1]] = keep_idx
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

    def _train_head(self, feats, mem_values, mem_mask, combined, seed):
        """One frame's head in training; dropout masks from ``seed`` (the
        same masks again when the backward recomputes the frame)."""
        gen = None
        if seed is not None and self.cfg.head.decoder_dropout > 0.0:
            gen = torch.Generator(device=feats[0].device).manual_seed(seed)
        return self.head(feats, mem_values, mem_mask, combined, gen)

    @full_f32()
    def train_forward(self, frames: torch.Tensor, labels: torch.Tensor,
                      dropout_seed: Optional[int] = None):
        """The training forward over a clip: frames [B, T, H, W, 3],
        labels [B, T, L, dim] (the label encoder's layout). Train mode
        gives BatchNorm on batch statistics (updating the running ones)
        and, with a ``dropout_seed``, decoder dropout. Returns
        (:class:`TrainFrameOut`, final memory)."""
        cfg = self.cfg
        if cfg.quantize != "none":
            raise ValueError(
                f"quantize={cfg.quantize!r} is inference-only (round() has "
                f"no useful gradient); train with quantize='none'")
        check_trainable(cfg)
        feats = self.encode(frames)
        t, b = feats[0].shape[:2]
        s, window = cfg.head.refine_layers, (
            cfg.memory.window if cfg.memory.window > 0 else t)
        mem = init_memory(cfg, b, window, frames.device)
        slots = mem.values.shape[3]
        combined = self.head.combine_dynamic()
        labels_t = labels.transpose(0, 1)
        remat = cfg.remat_frames and torch.is_grad_enabled()
        outs = []
        for i in range(t):
            args = (tuple(f[i] for f in feats),
                    mem.values.reshape(b, s, window * slots, -1),
                    mem.mask.reshape(b, window * slots), combined,
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
            mem = write_memory(mem, out.attn_feat, matched[s:], valid)
            outs.append(TrainFrameOut(out.pred_fir, out.pred_sec, out.diff,
                                      matched[s:], matched[:s]))
        return TrainFrameOut(*(torch.stack(x) for x in zip(*outs))), mem

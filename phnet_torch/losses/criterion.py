"""Router-blended two-branch lane criterion (port of
``phnet_tpu/losses/criterion.py``).

VIL (``style="blend_all"``, reference ``lossV5.py:71-208``): per stage and
branch, focal cls on every anchor, smooth-L1 on (start_y, start_x, theta,
valid length, invalid length) and the line IoU at the matched anchors; the
per-anchor losses of the two branches are median-centered and blended by
the router score, ``sum((1 - d) * loss_A + d * loss_B)``. OL
(``"blend_cls"``): the router blends the cls vectors only, and reg + IoU of
both branches are added.

The JAX package vmaps :meth:`LaneCriterion.frame_loss` over frames and
streams; here every function takes one leading problem dimension N (a
frame of one stream each) and runs all of them at once. The matches come
from the model's one batched solve a frame (``TrainFrameOut.matched_*``),
or are solved here when not given.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import LossConfig, ModelConfig
from .assign import assign_frame, lane_iou_aligned, line_iou_aligned
from .focal import softmax_focal_loss


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    absx = x.abs()
    return torch.where(absx < beta, 0.5 * absx ** 2 / beta, absx - 0.5 * beta)


def torch_median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis as the reference takes it: the lower of
    the two middle values for an even length."""
    return torch.median(x, dim=-1).values


class LaneCriterion:
    def __init__(self, cfg: ModelConfig, loss_cfg: LossConfig):
        self.cfg, self.loss = cfg, loss_cfg
        spec = cfg.lane
        n_strips = float(spec.n_strips)
        scale = [n_strips, cfg.img_w - 1.0, 180.0, n_strips]
        if spec.n_lengths == 2:
            scale.append(n_strips)
        self._reg_scale = torch.tensor(scale)
        self._alpha = torch.tensor(loss_cfg.focal_alpha)
        self._on = {}  # device -> (reg_scale, alpha), copied once

    def _constants(self, device: torch.device):
        if device not in self._on:
            self._on[device] = (self._reg_scale.to(device),
                                self._alpha.to(device))
        return self._on[device]

    def _branch_loss(self, preds, label, valid, matched_all=None):
        """One branch of N frames.

        preds [S, N, A, dim]; label [N, L, dim]; valid [N, L] bool;
        matched_all: the per-stage matches [S, N, L], or None to solve
        them here. Returns (cls_vec [N, A], reg_vec [N, L], iou_vec [N, L],
        matched_sorted [N, L], valid_sorted [N, L], reg [N], iou [N]).

        As in the reference, each stage's per-target reg / IoU losses are
        ordered by the stage's matched prior (ascending, invalid targets
        last) and summed by position; the sum lands at the last stage's
        sorted matched priors."""
        cfg, spec = self.cfg, self.cfg.lane
        s, n, a, dim = preds.shape
        n_reg = 3 + spec.n_lengths
        reg_scale, alpha = self._constants(preds.device)
        n_t = valid.sum(-1).float().clamp(min=1.0)[:, None]
        any_t = valid.any(-1, keepdim=True)
        cls_vec = preds.new_zeros((n, a))
        reg_vec = preds.new_zeros(valid.shape)
        iou_vec = preds.new_zeros(valid.shape)
        for st in range(s):
            pred = preds[st]
            if matched_all is None:
                matched = assign_frame(pred, label, valid, spec, cfg.img_w,
                                       cfg.img_h)
            else:
                matched = matched_all[st].long()
            order = torch.argsort(torch.where(valid, matched, a), dim=-1,
                                  stable=True)
            matched_sorted = torch.gather(matched, 1, order).clamp(0, a - 1)
            valid_sorted = torch.gather(valid, 1, order)
            cls_target = torch.zeros((n, a), dtype=torch.long,
                                     device=preds.device).scatter_add_(
                1, matched, valid.long())
            cls_target = torch.where(any_t, cls_target, 0)
            cls_vec = cls_vec + softmax_focal_loss(
                pred[..., :2], cls_target, alpha, self.loss.focal_gamma)
            mrows = torch.gather(pred, 1,
                                 matched[..., None].expand(-1, -1, dim))
            reg_pred = mrows[..., 2:2 + n_reg] * reg_scale
            reg_tgt = label[..., 2:2 + n_reg] * reg_scale
            reg_l = smooth_l1(reg_pred - reg_tgt).mean(-1)
            reg_l = torch.where(valid, reg_l, 0.0)
            reg_vec = reg_vec + torch.gather(reg_l, 1, order) / n_t
            pred_xs_px = mrows[..., spec.col_xs:] * (cfg.img_w - 1)
            tgt_xs_px = label[..., spec.col_xs:]
            if self.loss.use_lane_iou:
                iou = lane_iou_aligned(
                    pred_xs_px / cfg.img_w, tgt_xs_px / cfg.img_w,
                    self.loss.lane_iou_img_h, self.loss.lane_iou_img_w,
                    lane_width=self.loss.lane_iou_width)
            else:
                iou = line_iou_aligned(pred_xs_px, tgt_xs_px, cfg.img_w,
                                       self.loss.iou_length)
            iou_l = torch.where(valid, 1.0 - iou, 0.0)
            iou_vec = iou_vec + torch.gather(iou_l, 1, order) / n_t
        cls_vec, reg_vec, iou_vec = cls_vec / s, reg_vec / s, iou_vec / s
        return (cls_vec, reg_vec, iou_vec, matched_sorted, valid_sorted,
                reg_vec.sum(-1), iou_vec.sum(-1))

    def _inst_loss(self, cls_vec, reg_vec, iou_vec, matched_sorted,
                   valid_sorted):
        """Per-anchor instance loss [N, A]: cls everywhere, plus reg + IoU
        added at the last stage's sorted matched priors (invalid positions
        add zero)."""
        upd = ((reg_vec * self.loss.reg_weight
                + iou_vec * self.loss.iou_weight)
               * valid_sorted.to(cls_vec.dtype))
        return (cls_vec * self.loss.cls_weight).scatter_add(
            1, matched_sorted, upd)

    def frame_loss(self, pred_fir, pred_sec, diff, label,
                   matched_sec: Optional[torch.Tensor] = None,
                   matched_fir: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Loss of N frames. pred_*: [S, N, A, dim]; diff [S, N, A]; label
        [N, L, dim]; matched_*: optional [S, N, L]. Returns the per-frame
        loss [N] and per-frame metrics (each [N])."""
        valid = label[..., 1] == 1.0
        a_out = self._branch_loss(pred_fir, label, valid, matched_fir)
        b_out = self._branch_loss(pred_sec, label, valid, matched_sec)
        diff_frame = diff.mean(0)  # [N, A]
        if self.loss.style == "blend_all":
            loss_a = self._inst_loss(*a_out[:5])
            loss_b = self._inst_loss(*b_out[:5])
            delta = torch_median(loss_a - loss_b).detach()[:, None]
            loss_a = loss_a - delta / 2.0
            loss_b = loss_b + delta / 2.0
            total = ((1.0 - diff_frame) * loss_a
                     + diff_frame * loss_b).sum(-1)
        else:
            cls_a, cls_b = a_out[0], b_out[0]
            delta = torch_median(cls_a - cls_b).detach()[:, None]
            cls_blend = ((1.0 - diff_frame) * (cls_a - delta / 2.0)
                         + diff_frame * (cls_b + delta / 2.0)).sum(-1)
            total = ((a_out[5] + b_out[5]) * self.loss.reg_weight
                     + (a_out[6] + b_out[6]) * self.loss.iou_weight
                     + cls_blend * self.loss.cls_weight)
        metrics = {"cls": a_out[0].sum(-1) + b_out[0].sum(-1),
                   "reg": a_out[5] + b_out[5], "iou": a_out[6] + b_out[6]}
        return total, metrics

    def __call__(self, outs, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Clip loss: the mean per-frame loss and per-frame mean metrics.
        outs: ``TrainFrameOut`` with pred_* [T, S, B, A, dim], diff
        [T, S, B, A], matched_* [T, S, B, L] (or None); labels
        [B, T, L, dim]."""
        t, s, b = outs.pred_fir.shape[:3]

        def frames_last(x):  # [T, S, B, ...] -> [S, T*B, ...]
            return None if x is None else x.transpose(0, 1).reshape(
                s, t * b, *x.shape[3:])

        labels_n = labels.transpose(0, 1).reshape(t * b, *labels.shape[2:])
        losses, metrics = self.frame_loss(
            frames_last(outs.pred_fir), frames_last(outs.pred_sec),
            frames_last(outs.diff), labels_n,
            frames_last(getattr(outs, "matched_sec", None)),
            frames_last(getattr(outs, "matched_fir", None)))
        return losses.mean(), {k: v.mean() for k, v in metrics.items()}

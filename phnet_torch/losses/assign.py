"""Label assignment: the cost matrix, the Hungarian match and the
dynamic-k (SimOTA) match, batched.

Port of the training assigners of ``phnet_tpu/losses/assign.py``
(reference ``libs/utils/dynamic_assign.py`` ``assignV2`` and
``dynamic_k_assign``):

  cost = -(distance * start_xy * theta)^2 * 3 + focal_cost
  C    = cost - pairwise_line_iou

solved by :func:`phnet_torch.ops.hungarian.hungarian_assign` on the
device, or matched by :func:`dynamic_k_frame`. Where the JAX package vmaps one frame's ``[A, dim]`` predictions
against its ``[L, dim]`` targets, these functions take any number of
leading problem dimensions: predictions ``[..., A, dim]``, targets
``[..., L, dim]``, validity ``[..., L]``. Predictions hold normalized
xs, targets pixel xs (the label encoder's layout).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import LaneSpec
from ..ops.hungarian import hungarian_assign

INF = 987654.0


def line_iou_pairwise(pred_xs: torch.Tensor, target_xs: torch.Tensor,
                      img_w: int, length: float = 15.0) -> torch.Tensor:
    """Pairwise horizontal-band IoU. pred_xs [..., A, O] px; target_xs
    [..., L, O] px -> [..., A, L]. Target points outside the image count
    for nothing."""
    p1 = (pred_xs - length)[..., :, None, :]
    p2 = (pred_xs + length)[..., :, None, :]
    t1 = (target_xs - length)[..., None, :, :]
    t2 = (target_xs + length)[..., None, :, :]
    ovr = torch.minimum(p2, t2) - torch.maximum(p1, t1)
    union = torch.maximum(p2, t2) - torch.minimum(p1, t1)
    invalid = ((target_xs < 0) | (target_xs >= img_w))[..., None, :, :]
    ovr = torch.where(invalid, 0.0, ovr)
    union = torch.where(invalid, 0.0, union)
    return ovr.sum(-1) / (union.sum(-1) + 1e-9)


def line_iou_aligned(pred_xs: torch.Tensor, target_xs: torch.Tensor,
                     img_w: int, length: float = 15.0) -> torch.Tensor:
    """Row-aligned line IoU. pred_xs / target_xs [..., O] px -> [...]."""
    p1, p2 = pred_xs - length, pred_xs + length
    t1, t2 = target_xs - length, target_xs + length
    ovr = torch.minimum(p2, t2) - torch.maximum(p1, t1)
    union = torch.maximum(p2, t2) - torch.minimum(p1, t1)
    invalid = (target_xs < 0) | (target_xs >= img_w)
    ovr = torch.where(invalid, 0.0, ovr)
    union = torch.where(invalid, 0.0, union)
    return ovr.sum(-1) / (union.sum(-1) + 1e-9)


def _lane_widths(xs: torch.Tensor, dy: float, img_w: int, lane_width: float,
                 max_dx: Optional[float] = None) -> torch.Tensor:
    """Slope-adaptive half-widths per row (CLRerNet ``_calc_lane_width``);
    ``max_dx`` (px) zeroes the dx spikes of padded -1e5 target rows."""
    dx = (xs[..., 2:] - xs[..., :-2]) * img_w
    if max_dx is not None:
        dx = torch.where(dx.abs() > max_dx, 0.0, dx)
    w = lane_width * torch.sqrt(dx ** 2 + dy ** 2) / dy
    return torch.cat([w[..., :1], w, w[..., -1:]], dim=-1)


def lane_iou_aligned(pred_xs: torch.Tensor, target_xs: torch.Tensor,
                     img_h: int, img_w: int,
                     lane_width: float = 7.5 / 768.0,
                     max_dx: float = 1e4) -> torch.Tensor:
    """CLRerNet's slope-adaptive LaneIoU on relative xs [..., O] (the OL
    criterion's IoU); the prediction's widths carry no gradient."""
    dy = img_h / (pred_xs.shape[-1] - 1) * 2.0
    pw = _lane_widths(pred_xs.detach(), dy, img_w, lane_width)
    tw = _lane_widths(target_xs, dy, img_w, lane_width, max_dx=max_dx)
    p1, p2 = pred_xs - pw, pred_xs + pw
    t1, t2 = target_xs - tw, target_xs + tw
    ovr = torch.minimum(p2, t2) - torch.maximum(p1, t1)
    union = torch.maximum(p2, t2) - torch.minimum(p1, t1)
    invalid = (target_xs < 0) | (target_xs >= 1.0)
    ovr = torch.where(invalid, 0.0, ovr)
    union = torch.where(invalid, 0.0, union)
    return ovr.sum(-1) / (union.sum(-1) + 1e-9)


def _focal_cost_pos(cls_logits: torch.Tensor, alpha: float = 0.25,
                    gamma: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """Focal assignment cost of the positive class. [..., A, 2] -> [..., A]."""
    p = torch.sigmoid(cls_logits)
    neg = -torch.log(1 - p + eps) * (1 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1 - p) ** gamma
    return pos[..., 1] - neg[..., 1]


def _cost_and_iou(predictions: torch.Tensor, targets: torch.Tensor,
                  target_valid: torch.Tensor, spec: LaneSpec, img_w: int,
                  img_h: int, distance_cost_weight: float = 3.0,
                  cls_cost_weight: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cost, iou)``, both ``[..., A, L]``, on detached inputs. Each
    distance is scored ``1 - x / (max + 1e-4)`` with the max over the
    problem's valid targets."""
    predictions = predictions.detach()
    targets = targets.detach()
    pred_xs_px = predictions[..., spec.col_xs:] * (img_w - 1)
    tgt_xs_px = targets[..., spec.col_xs:]
    # mean |dx| over the target's valid columns; the reference slices from
    # column 6, which in the VIL layout takes the invalid length along
    if spec.n_lengths == 2:
        pred_d = torch.cat([predictions[..., 6:7], pred_xs_px], dim=-1)
        tgt_d = torch.cat([targets[..., 6:7], tgt_xs_px], dim=-1)
    else:
        pred_d, tgt_d = pred_xs_px, tgt_xs_px
    invalid = (tgt_d < 0) | (tgt_d >= img_w)  # [..., L, D]
    lengths = (~invalid).sum(-1).float()
    diffs = (tgt_d[..., None, :, :] - pred_d[..., :, None, :]).abs()
    diffs = torch.where(invalid[..., None, :, :], 0.0, diffs)
    distances = diffs.sum(-1) / (lengths[..., None, :] + 1e-9)  # [..., A, L]
    pair_valid = target_valid[..., None, :]

    def score(x):
        big = torch.where(pair_valid, x, float("-inf")).amax(
            dim=(-2, -1), keepdim=True)
        return 1.0 - x / (torch.clamp(big, min=0.0) + 1e-4)

    dist_score = score(distances)
    cls_score = _focal_cost_pos(predictions[..., :2])[..., None]
    t_sy = targets[..., spec.col_start_y] * (img_h - 1)
    t_sx = targets[..., spec.col_start_x] * (img_w - 1)
    p_sy = predictions[..., spec.col_start_y] * (img_h - 1)
    p_sx = predictions[..., spec.col_start_x] * (img_w - 1)
    start_d = torch.sqrt((p_sy[..., :, None] - t_sy[..., None, :]) ** 2
                         + (p_sx[..., :, None] - t_sx[..., None, :]) ** 2
                         + 1e-12)
    start_score = score(start_d)
    theta_d = (predictions[..., :, None, spec.col_theta]
               - targets[..., None, :, spec.col_theta]).abs() * 180.0
    theta_score = score(theta_d)
    cost = (-((dist_score * start_score * theta_score) ** 2)
            * distance_cost_weight + cls_score * cls_cost_weight)
    iou = line_iou_pairwise(pred_xs_px, tgt_xs_px, img_w)
    return cost, iou


def assignment_cost(predictions: torch.Tensor, targets: torch.Tensor,
                    target_valid: torch.Tensor, spec: LaneSpec, img_w: int,
                    img_h: int, distance_cost_weight: float = 3.0,
                    cls_cost_weight: float = 1.0) -> torch.Tensor:
    """The assignment cost ``C = cost - iou``, ``[..., L, A]``. Rows of
    padded targets hold garbage: the solver masks them."""
    cost, iou = _cost_and_iou(predictions, targets, target_valid, spec,
                              img_w, img_h, distance_cost_weight,
                              cls_cost_weight)
    return (cost - iou).transpose(-1, -2)


def assign_frame(predictions: torch.Tensor, targets: torch.Tensor,
                 target_valid: torch.Tensor, spec: LaneSpec, img_w: int,
                 img_h: int) -> torch.Tensor:
    """Hungarian-match each valid target to a distinct prior, for every
    problem of the leading dimensions (targets and validity broadcast
    over them). Returns ``matched`` ``[..., L]``
    int64 (an arbitrary distinct prior for an invalid target)."""
    cost = assignment_cost(predictions, targets, target_valid, spec, img_w,
                           img_h)
    lead, (l, a) = cost.shape[:-2], cost.shape[-2:]
    matched = hungarian_assign(cost.reshape(-1, l, a),
                               target_valid.expand(cost.shape[:-1])
                               .reshape(-1, l))
    return matched.reshape(*lead, l)


def dynamic_k_assign(cost: torch.Tensor, iou: torch.Tensor,
                     target_valid: torch.Tensor, n_candidate_k: int = 4
                     ) -> torch.Tensor:
    """SimOTA's one-to-few match (``dynamic_assign.py:83-125``; JAX
    ``dynamic_k_assign``) of every problem of the leading dimensions:
    cost and iou ``[..., A, L]``, validity ``[..., L]`` -> ``[..., A, L]``
    bool. Target t takes its k_t cheapest priors left by the targets
    before it, k_t = the truncated sum of its ``n_candidate_k`` largest
    IoUs, at least 1; a prior left with several targets keeps only its
    cheapest. Ties go to the lower index everywhere, as ``jax.lax.top_k``
    and ``argmin`` break them (a stable sort here; ``torch.topk`` promises
    no order)."""
    a, l = cost.shape[-2:]
    valid = target_valid[..., None, :]
    ious = torch.where(valid, torch.maximum(iou, torch.zeros_like(iou)),
                       0.0)
    top = torch.topk(ious.transpose(-1, -2), n_candidate_k, dim=-1).values
    total = top[..., 0]
    for j in range(1, n_candidate_k):  # the largest first, in order
        total = total + top[..., j]
    ks = total.to(torch.int32).clamp(1, a)  # [..., L], truncated
    work = torch.where(valid, cost, INF)
    rank = torch.arange(a, device=cost.device)
    cols = []
    for t in range(l):
        order = torch.sort(work[..., t], dim=-1, stable=True).indices
        sel = torch.zeros_like(order, dtype=torch.bool).scatter(
            -1, order, rank < ks[..., t, None])
        sel = sel & target_valid[..., t, None]
        cols.append(sel)
        work = torch.where(sel[..., None], INF, work)
    match = torch.stack(cols, -1)
    multi = match.sum(-1) > 1
    best = torch.where(valid, cost, INF).argmin(-1)  # first of equal minima
    onehot = best[..., None] == torch.arange(l, device=cost.device)
    return torch.where(multi[..., None],
                       onehot & match.any(-1, keepdim=True), match)


def dynamic_k_frame(predictions: torch.Tensor, targets: torch.Tensor,
                    target_valid: torch.Tensor, spec: LaneSpec, img_w: int,
                    img_h: int, n_candidate_k: int = 4) -> torch.Tensor:
    """The dynamic-k assignment reduced to one prior a target (JAX
    ``dynamic_k_frame``): over :func:`assign_frame`'s cost pieces,
    :func:`dynamic_k_assign`, then each target's cheapest matched prior;
    a valid target left with no prior takes its cheapest prior of all.
    Returns ``matched`` ``[..., L]`` int64 (arbitrary for invalid
    targets)."""
    cost, iou = _cost_and_iou(predictions, targets, target_valid, spec,
                              img_w, img_h)
    target_valid = target_valid.expand(cost.shape[:-2] + cost.shape[-1:])
    match = dynamic_k_assign(cost, iou, target_valid, n_candidate_k)
    eff = torch.where(match, cost, INF)
    eff = torch.where(match.any(-2, keepdim=True), eff, cost)
    return eff.argmin(-2)


def train_assign(cfg, predictions: torch.Tensor, targets: torch.Tensor,
                 target_valid: torch.Tensor) -> torch.Tensor:
    """The training assigner of ``cfg.train_assigner``: "hungarian"
    (:func:`assign_frame`) or "dynamic_k" (:func:`dynamic_k_frame`)."""
    if cfg.train_assigner == "dynamic_k":
        return dynamic_k_frame(predictions, targets, target_valid, cfg.lane,
                               cfg.img_w, cfg.img_h)
    return assign_frame(predictions, targets, target_valid, cfg.lane,
                        cfg.img_w, cfg.img_h)

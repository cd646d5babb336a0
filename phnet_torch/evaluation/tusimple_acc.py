"""TuSimple-style per-point lane accuracy (own copy of
``phnet_tpu/evaluation/tusimple_acc.py``).

Equivalent of the reference's ``evaluation/evaluate_acc.py`` (``LaneEval``):
per frame, each GT lane is compared point-by-point against the best
matching prediction; a point hits when |x_pred - x_gt| at the same y is
within a slope-adaptive pixel threshold; accuracy = hit ratio, with FP/FN
rates from per-lane hit thresholds.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

PIXEL_THRESH = 20
PT_THRESH = 0.85


def _lane_xs_at(lane: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """x at each requested y via linear interpolation; -2 outside domain."""
    lane = lane[np.argsort(lane[:, 1])]
    xs = np.interp(ys, lane[:, 1], lane[:, 0], left=np.nan, right=np.nan)
    xs[np.isnan(xs)] = -2.0
    return xs


def _angle_thresh(lane: np.ndarray) -> float:
    lane = lane[np.argsort(lane[:, 1])]
    dy = lane[-1, 1] - lane[0, 1]
    dx = lane[-1, 0] - lane[0, 0]
    angle = np.arctan2(abs(dx), max(dy, 1e-6))
    return PIXEL_THRESH / max(np.cos(angle), 1e-6)


def line_accuracy(pred_xs: np.ndarray, gt_xs: np.ndarray, thresh: float) -> float:
    valid = gt_xs >= 0
    if valid.sum() == 0:
        return 0.0
    hits = (np.abs(pred_xs[valid] - gt_xs[valid]) < thresh)
    return float(hits.mean())


def bench_frame(
    pred_lanes: Sequence[np.ndarray],
    gt_lanes: Sequence[np.ndarray],
    ys: np.ndarray,
) -> Tuple[float, int, int]:
    """(accuracy, fp, fn) for one frame at sampling rows ``ys``."""
    if len(gt_lanes) == 0:
        return 0.0 if len(pred_lanes) else 1.0, len(pred_lanes), 0
    gt_xs = [_lane_xs_at(np.asarray(g), ys) for g in gt_lanes]
    threshs = [_angle_thresh(np.asarray(g)) for g in gt_lanes]
    pred_xs = [_lane_xs_at(np.asarray(p), ys) for p in pred_lanes]

    accs, matched = [], np.zeros(len(pred_lanes), bool)
    for g, th in zip(gt_xs, threshs):
        best, best_i = 0.0, -1
        for i, p in enumerate(pred_xs):
            a = line_accuracy(p, g, th)
            if a > best:
                best, best_i = a, i
        accs.append(best)
        if best > PT_THRESH and best_i >= 0:
            matched[best_i] = True
    fn = sum(1 for a in accs if a <= PT_THRESH)
    fp = int((~matched).sum()) if len(pred_lanes) else 0
    acc = float(np.mean(accs)) if accs else 0.0
    return acc, fp, fn


def evaluate_accuracy(
    predictions: Sequence[Sequence[np.ndarray]],
    annotations: Sequence[Sequence[np.ndarray]],
    img_h: int,
    n_rows: int = 20,
) -> Dict[str, float]:
    ys = np.linspace(img_h * 0.3, img_h - 1, n_rows)
    accs, fps, fns, n_pred, n_gt = [], 0, 0, 0, 0
    for pred, gt in zip(predictions, annotations):
        a, fp, fn = bench_frame(pred, gt, ys)
        accs.append(a)
        fps += fp
        fns += fn
        n_pred += len(pred)
        n_gt += len(gt)
    return {
        "accuracy": float(np.mean(accs)) if accs else 0.0,
        "fp_rate": fps / max(n_pred, 1),
        "fn_rate": fns / max(n_gt, 1),
    }

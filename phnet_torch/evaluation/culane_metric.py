"""CULane F1 / mIoU metric in Python, without OpenCV.

Counterpart of ``phnet_tpu/evaluation/culane_metric.py`` (the reference's
LaneATT reimplementation, ``evaluation/evaluateVIL.py``): spline-resample
both lane sets (scipy), rasterize each at a fixed stroke width, compute
the pairwise pixel IoU matrix, Hungarian-match, count TP at IoU above the
threshold; mIoU is the mean of each prediction's matched IoU (0 when
unmatched). The JAX package draws with ``cv2.line``; the port draws with
``culane_thick_line`` of its native evaluator, the pixel-exact replica of
``cv2.line(thickness=w)`` (``native/culane_eval.cpp``), so both give the
same masks and the same numbers.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.interpolate import splev, splprep
from scipy.optimize import linear_sum_assignment


def _lib() -> ctypes.CDLL:
    from ..ops import _build

    lib = _build.load("culane_eval")
    lib.culane_thick_line.restype = None
    lib.culane_thick_line.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def interp_lane(points: Sequence[Tuple[float, float]], n: int = 5) -> np.ndarray:
    """Parametric spline resampling (``evaluateVIL.py:52-58``)."""
    pts = list(dict.fromkeys(points))
    x = [p[0] for p in pts]
    y = [p[1] for p in pts]
    if len(pts) == 2:
        u = np.linspace(0.0, 1.0, num=n + 1)
        return np.stack(
            [x[0] + (x[1] - x[0]) * u, y[0] + (y[1] - y[0]) * u], axis=1)
    tck, u = splprep([x, y], s=0, t=n, k=min(3, len(pts) - 1))
    u = np.linspace(0.0, 1.0, num=(len(u) - 1) * n + 1)
    return np.array(splev(u, tck)).T


def draw_lane(lane: np.ndarray, shape, width: int = 30) -> np.ndarray:
    """The lane's segments drawn ``width`` pixels thick, as
    ``cv2.line(img, p1, p2, 255, width)`` draws them (points truncated to
    int32), on a zero uint8 image of ``shape[:2]``."""
    img = np.zeros(shape[:2], dtype=np.uint8)
    h, w = img.shape
    lib = _lib()
    lane = lane.astype(np.int32)
    for p1, p2 in zip(lane[:-1], lane[1:]):
        lib.culane_thick_line(int(p1[0]), int(p1[1]), int(p2[0]), int(p2[1]),
                              width, w, h, img.ctypes.data)
    img *= 255
    return img


def _iou_matrix(pred, anno, shape, width):
    masks_p = [draw_lane(interp_lane(p), shape, width) > 0 for p in pred]
    masks_a = [draw_lane(interp_lane(a), shape, width) > 0 for a in anno]
    ious = np.zeros((len(masks_p), len(masks_a)))
    for i, mp in enumerate(masks_p):
        for j, ma in enumerate(masks_a):
            ious[i, j] = (mp & ma).sum() / ((mp | ma).sum() + 1e-10)
    return ious


def culane_metric(
    pred: List, anno: List, shape, width: int = 30, iou_threshold: float = 0.5
) -> Tuple[int, int, int, np.ndarray, np.ndarray]:
    """One frame -> (tp, fp, fn, pred_ious, pred_hits).

    pred/anno: lists of point lists; shape: (H, W[, C]) raster size.
    """
    if len(pred) == 0:
        return 0, 0, len(anno), np.zeros(0), np.zeros(0, bool)
    if len(anno) == 0:
        return 0, len(pred), 0, np.zeros(len(pred)), np.zeros(len(pred), bool)
    ious = _iou_matrix(pred, anno, shape, width)
    row, col = linear_sum_assignment(1 - ious)
    tp = int((ious[row, col] > iou_threshold).sum())
    fp = len(pred) - tp
    fn = len(anno) - tp
    pred_ious = np.zeros(len(pred))
    pred_ious[row] = ious[row, col]
    return tp, fp, fn, pred_ious, pred_ious > iou_threshold


def culane_match(
    anno: List, pred: List, shape, width: int = 30
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Anno->pred matching with the full IoU matrix, for the temporal metric
    (``evalTemporalVIL.py`` ``culane_metric2`` results: row=anno, col=pred)."""
    if len(anno) == 0 or len(pred) == 0:
        return np.zeros(0, int), np.zeros(0, int), np.zeros((len(anno), len(pred)))
    ious = _iou_matrix(anno, pred, shape, width)  # rows=anno, cols=pred
    row, col = linear_sum_assignment(1 - ious)
    return row, col, ious


def aggregate_results(
    results: Sequence[Tuple[int, int, int, np.ndarray, np.ndarray]]
) -> Dict[str, float]:
    """``evaluateVIL.py:158-176``: totals + P/R/F1 + python-style mIoU."""
    tp = sum(r[0] for r in results)
    fp = sum(r[1] for r in results)
    fn = sum(r[2] for r in results)
    all_ious = np.concatenate([r[3] for r in results]) if results else np.zeros(0)
    miou = float(all_ious.mean()) if all_ious.size else 0.0
    if tp == 0:
        p = r = f1 = 0.0
    else:
        p = tp / (tp + fp)
        r = tp / (tp + fn)
        f1 = 2 * p * r / (p + r)
    return {"TP": tp, "FP": fp, "FN": fn, "Precision": p, "Recall": r,
            "F1": f1, "miou": miou}

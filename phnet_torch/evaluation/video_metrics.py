"""Video-object-segmentation metrics over mask outputs.

Counterpart of ``phnet_tpu/evaluation/video_metrics.py`` (the reference's
``evaluation/video_metrics/``: region Jaccard J, ``jaccard.py:13``, and
boundary F-measure, ``f_boundary.py:14``, per frame, aggregated as mean /
recall / decay like the DAVIS toolkit), on masks that are tensors on any
device (or numpy arrays). OpenCV's ``erode`` and ``dilate`` become
max-pooling; their default border is kept: erosion reads outside the
image as foreground (a mask that touches the edge has no boundary there)
and dilation as background. Counts are exact; ratios are Python floats
(float64), the statistics numpy float64, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _bool(m) -> torch.Tensor:
    m = m if torch.is_tensor(m) else torch.from_numpy(np.asarray(m))
    return m.bool()


def jaccard(seg, gt) -> float:
    """Region similarity J = |seg & gt| / |seg | gt|; 1.0 when both empty."""
    seg, gt = _bool(seg), _bool(gt)
    union = int((seg | gt).sum())
    if union == 0:
        return 1.0
    return int((seg & gt).sum()) / union


def _max_filter(m: torch.Tensor, k: int, pad_value: float) -> torch.Tensor:
    """The k x k maximum of float [H, W] ``m``, the outside read as
    ``pad_value``; one pass a direction."""
    a = k // 2
    x = F.pad(m[None, None], (a, a, a, a), value=pad_value)
    x = F.max_pool2d(x, (k, 1), stride=1)
    return F.max_pool2d(x, (1, k), stride=1)[0, 0]


def _mask_boundary(mask: torch.Tensor) -> torch.Tensor:
    """Foreground pixels that a 3 x 3 erosion removes (``cv2.erode``, its
    border read as foreground)."""
    m = mask.float()
    eroded = -_max_filter(-m, 3, -1.0)
    return mask & (eroded == 0)


def f_boundary(seg, gt, bound_pix: int = 0) -> float:
    """Boundary F-measure: precision / recall of boundary pixels within a
    tolerance band, by default ``ceil(0.008 * ||shape||)`` pixels (0.8% of
    the image diagonal)."""
    seg, gt = _bool(seg), _bool(gt)
    if not bool(seg.any()) and not bool(gt.any()):
        return 1.0
    if bound_pix <= 0:
        h, w = seg.shape
        bound_pix = int(math.ceil(0.008 * math.sqrt(float(h * h + w * w))))
    fg = _mask_boundary(seg)
    gb = _mask_boundary(gt)
    k = 2 * bound_pix + 1
    fg_dil = _max_filter(fg.float(), k, 0.0) > 0
    gb_dil = _max_filter(gb.float(), k, 0.0) > 0
    n_fg, n_gb = int(fg.sum()), int(gb.sum())
    if n_fg == 0 and n_gb > 0:
        return 0.0
    if n_gb == 0 and n_fg > 0:
        return 0.0
    precision = int((fg & gb_dil).sum()) / max(n_fg, 1)
    recall = int((gb & fg_dil).sum()) / max(n_gb, 1)
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)


def _statistics(per_frame) -> Dict[str, float]:
    """DAVIS-style mean / recall(>0.5) / decay (first vs last quartile)."""
    per_frame = np.asarray(per_frame, float)
    n = len(per_frame)
    if n == 0:
        return {"mean": 0.0, "recall": 0.0, "decay": 0.0}
    quarters = np.array_split(per_frame, 4) if n >= 4 else [per_frame] * 4
    return {
        "mean": float(per_frame.mean()),
        "recall": float((per_frame > 0.5).mean()),
        "decay": float(quarters[0].mean() - quarters[3].mean()),
    }


def evaluate_video_masks(pred_masks: Sequence, gt_masks: Sequence
                         ) -> Dict[str, Dict[str, float]]:
    """J and F of each frame's pair of binary masks, and their
    statistics."""
    js = np.array([jaccard(p, g) for p, g in zip(pred_masks, gt_masks)])
    fs = np.array([f_boundary(p, g) for p, g in zip(pred_masks, gt_masks)])
    return {"J": _statistics(js), "F": _statistics(fs)}

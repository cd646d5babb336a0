"""Temporal stability metric Rs/Rj/Rm (RVLD-style); own copy of
``phnet_tpu/evaluation/temporal.py`` over the port's CULane matching.

Reference ``evaluation/evalTemporalVIL.py:121-294`` (``LaneEval_Temporal``):
for each consecutive-frame pair in a video, match GT lanes across the two
frames (IoU > threshold); for each matched GT pair check whether the
prediction was correct in both frames (stable, Ns), in exactly one
(jitter/flicker, Nj), or in neither (missed, Nm). Ratios Rs/Rj/Rm normalize
by the total.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from .culane_metric import culane_match


def temporal_metric_video(
    annotations: Sequence[List],
    predictions: Sequence[List],
    shapes: Sequence,
    width: int = 30,
    iou_threshold: float = 0.5,
    match_threshold: float = 0.5,
) -> Tuple[int, int, int]:
    """One video: lists (per frame) of anno/pred lane point lists.

    Returns (Ns, Nj, Nm) summed over consecutive frame pairs.

    ``match_threshold`` gates the GT-to-GT cross-frame matching and is
    ALWAYS 0.5 in the reference — ``matching_lane_instance()`` is called
    with its defaults even in the IoU-0.8 run
    (``evalTemporalVIL.py:218,278``); only the prediction-correctness
    check uses ``iou_threshold``.
    """
    ns = nj = nm = 0
    # per-frame anno->pred matching with full IoU matrices
    frame_results = [
        culane_match(a, p, s, width)
        for a, p, s in zip(annotations, predictions, shapes)
    ]
    for t in range(1, len(annotations)):
        shape = shapes[t]
        # match GT lanes of frame t against GT lanes of frame t-1
        row, col, ious = culane_match(
            annotations[t], annotations[t - 1], shape, width)
        keep = [
            (r, c) for r, c in zip(row, col) if ious[r, c] > match_threshold
        ]
        r1, c1, i1 = frame_results[t]
        r2, c2, i2 = frame_results[t - 1]
        for cur_anno, prev_anno in keep:
            iou_cur = 0.0
            hit = (r1 == cur_anno).nonzero()[0]
            if len(hit):
                iou_cur = float(i1[cur_anno, c1[hit][0]])
            iou_prev = 0.0
            hit = (r2 == prev_anno).nonzero()[0]
            if len(hit):
                iou_prev = float(i2[prev_anno, c2[hit][0]])
            cur_ok = iou_cur > iou_threshold
            prev_ok = iou_prev > iou_threshold
            if cur_ok != prev_ok:
                nj += 1
            elif not cur_ok and not prev_ok:
                nm += 1
            else:
                ns += 1
    return ns, nj, nm


def aggregate_temporal(video_counts: Sequence[Tuple[int, int, int]]) -> Dict[str, float]:
    ns = sum(v[0] for v in video_counts)
    nj = sum(v[1] for v in video_counts)
    nm = sum(v[2] for v in video_counts)
    total = max(ns + nj + nm, 1)
    return {
        "Ns": ns, "Nj": nj, "Nm": nm,
        "Rs": ns / total, "Rj": nj / total, "Rm": nm / total,
    }

"""ctypes wrapper of the port's native CULane evaluator
(``native/culane_eval.cpp``, an own copy of the JAX package's).

Counterpart of ``phnet_tpu/evaluation/native_eval.py``: the reference's
``culane_evaluator`` binary (``evaluate_iou.py:55-58``) in-process through
the C ABI, OpenMP over frames. The library is built with ``g++`` at first
use (``phnet_torch.ops._build``); where it does not build, these functions
raise (there is no fallback to the Python metric).
"""

from __future__ import annotations

import ctypes
import glob
import os
from typing import Dict, Sequence, Tuple


def _lib() -> ctypes.CDLL:
    from ..ops import _build

    lib = _build.load("culane_eval")
    cl, cd = ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_double)
    lib.culane_evaluate_files_v2.restype = ctypes.c_int
    lib.culane_evaluate_files_v2.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, cl, cl, cl, cd, cl, cd]
    return lib


def evaluate_pairs(
    pairs: Sequence[Tuple[str, str]], img_w: int, img_h: int,
    lane_width: int = 30, iou_thr: float = 0.5,
) -> Dict[str, float]:
    """Score (prediction, annotation) ``.lines.txt`` file pairs: totals,
    precision, recall, F1, the matched IoU over predictions (``miou``)
    and the official binary's mean of per-frame mIoUs
    (``miou_official``). A missing prediction file has no lanes."""
    lib = _lib()
    n = len(pairs)
    pred_arr = (ctypes.c_char_p * n)(*[p.encode() for p, _ in pairs])
    anno_arr = (ctypes.c_char_p * n)(*[a.encode() for _, a in pairs])
    tp, fp, fn, n_pred = (ctypes.c_long() for _ in range(4))
    iou_sum, frame_miou_sum = ctypes.c_double(), ctypes.c_double()
    lib.culane_evaluate_files_v2(
        pred_arr, anno_arr, n, img_w, img_h, lane_width, iou_thr,
        ctypes.byref(tp), ctypes.byref(fp), ctypes.byref(fn),
        ctypes.byref(iou_sum), ctypes.byref(n_pred),
        ctypes.byref(frame_miou_sum))
    tp, fp, fn = tp.value, fp.value, fn.value
    p = tp / (tp + fp) if tp + fp else 0.0
    r = tp / (tp + fn) if tp + fn else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    miou = iou_sum.value / n_pred.value if n_pred.value else 0.0
    miou_official = frame_miou_sum.value / n if n else 0.0
    return {"TP": tp, "FP": fp, "FN": fn, "Precision": p, "Recall": r,
            "F1": f1, "miou": miou, "miou_official": miou_official}


def native_eval(pred_dir: str, anno_dir: str, img_w: int, img_h: int,
                lane_width: int = 30, iou_thr: float = 0.5
                ) -> Dict[str, float]:
    """:func:`evaluate_pairs` over every ``<video>/<frame>.lines.txt`` of
    ``anno_dir`` and its namesake under ``pred_dir``."""
    pairs = []
    for af in sorted(glob.glob(os.path.join(anno_dir, "*", "*.lines.txt"))):
        vid = os.path.basename(os.path.dirname(af))
        pairs.append((os.path.join(pred_dir, vid, os.path.basename(af)), af))
    return evaluate_pairs(pairs, img_w, img_h, lane_width, iou_thr)

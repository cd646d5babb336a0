"""CULane-format ``.lines.txt`` emission — the eval compatibility contract.

Own copy of ``phnet_tpu/evaluation/emit.py``. Byte-compatible with the
reference emitters so its evaluators score our outputs unchanged:

* VIL (``evaluation/generate_lane.py:31-44`` ``generate_pred``):
  ``'%d %d '`` of ``(x*W, y*H)`` per point, reversed point order,
  lanes with <= 2 points skipped.
* OpenLane (``generate_lane.py:46-61`` ``generate_predV2``):
  ``'%.1f %.1f '`` of ``(x*W/2, (y*H+480)/2)``.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..geometry import Lane


def write_pred_txt(
    out_dir: str,
    clip_name: str,
    img_name: str,
    lanes: Sequence[Lane],
    size: Tuple[int, int],
    fmt: str = "vil",
    crop_offset: int = 480,
) -> str:
    """Write one frame's predictions. size = (H, W) of the coordinate frame
    (VIL: original image; OL: cropped 800x1920)."""
    clip_dir = os.path.join(out_dir, clip_name)
    os.makedirs(clip_dir, exist_ok=True)
    path = os.path.join(clip_dir, img_name + ".lines.txt")
    with open(path, "w") as fp:
        for lane in lanes:
            if len(lane.points) <= 2:
                continue
            for tx, ty in reversed(lane.points):
                if fmt == "vil":
                    fp.write("%d %d " % (tx * size[1], ty * size[0]))
                else:
                    fp.write(
                        "%.1f %.1f "
                        % (tx * size[1] / 2, (ty * size[0] + crop_offset) / 2)
                    )
            fp.write("\n")
    return path


def write_gt_txt(out_dir: str, clip_name: str, img_name: str,
                 lanes_points: Sequence[np.ndarray]) -> str:
    """GT emission (``generate_lane.py:64-113`` generate_anno):
    '%.1f %.1f ' of absolute points; lanes with <= 2 points skipped."""
    clip_dir = os.path.join(out_dir, clip_name)
    os.makedirs(clip_dir, exist_ok=True)
    path = os.path.join(clip_dir, img_name + ".lines.txt")
    with open(path, "w") as fp:
        for pts in lanes_points:
            if len(pts) <= 2:
                continue
            for tx, ty in pts:
                fp.write("%.1f %.1f " % (tx, ty))
            fp.write("\n")
    return path


def read_lines_txt(path: str) -> List[List[Tuple[float, float]]]:
    """Parse a ``.lines.txt`` (``evaluateVIL.py:82-91``): lanes with < 2
    points dropped."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [line.split() for line in f.readlines()]
    lanes = []
    for row in rows:
        vals = list(map(float, row))
        pts = [(vals[i], vals[i + 1]) for i in range(0, len(vals) - 1, 2)]
        if len(pts) >= 2:
            lanes.append(pts)
    return lanes

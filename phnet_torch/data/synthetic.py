"""Synthetic video lane clips, drawn with numpy (no OpenCV).

Counterpart of ``phnet_tpu/data/synthetic.py``: bright lane stripes on a
textured road that drift smoothly over the clip, with fixed-shape labels
from the port's label encoder. The lane geometry comes from the same
seeded draws in the same order, so a clip's labels equal the JAX
package's for the same seed; the pixels differ (nearest-neighbour noise
and a numpy stripe raster instead of OpenCV's). The label layout is the
``LaneSpec``'s: VIL's two length fields, or OpenLane-V's one (with its
``max_lanes`` 4 and 72 offsets, as ``train_ol.py --synthetic`` draws).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..config import LaneSpec
from ..geometry import encode_lane_label
from .transforms import Normalize

normalize = Normalize()


def lane_points(x_bottom: float, slope: float, curve: float, y_top: float,
                img_h: int, n: int = 24) -> np.ndarray:
    ys = np.linspace(img_h - 1, y_top, n)
    d = img_h - 1 - ys
    xs = x_bottom + slope * d + curve * d * d / max(img_h, 1)
    return np.stack([xs, ys], 1).astype(np.float32)


def draw_polyline(img: np.ndarray, pts: np.ndarray, value: int,
                  half_width: float = 2.0):
    """Paint the pixels within ``half_width`` of the polyline (in place)."""
    h, w = img.shape[:2]
    for p, q in zip(pts[:-1], pts[1:]):
        x0 = int(max(np.floor(min(p[0], q[0]) - half_width), 0))
        x1 = int(min(np.ceil(max(p[0], q[0]) + half_width), w - 1))
        y0 = int(max(np.floor(min(p[1], q[1]) - half_width), 0))
        y1 = int(min(np.ceil(max(p[1], q[1]) + half_width), h - 1))
        if x1 < x0 or y1 < y0:
            continue
        yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float32)
        d = q - p
        t = np.clip(((xx - p[0]) * d[0] + (yy - p[1]) * d[1])
                    / max(float(d @ d), 1e-6), 0.0, 1.0)
        near = ((xx - p[0] - t * d[0]) ** 2 + (yy - p[1] - t * d[1]) ** 2
                <= half_width ** 2)
        img[y0:y1 + 1, x0:x1 + 1][near] = value


def synthetic_clip(seed: int, t: int, img_h: int = 384, img_w: int = 768,
                   n_lanes: int = 3, spec: Optional[LaneSpec] = None,
                   max_lanes: int = 8, drift: float = 2.0) -> Dict:
    """One clip: frames [T, H, W, 3] float32 (ImageNet-normalized), labels
    [T, max_lanes, spec.dim], and the lane points of each frame (bottom to
    top)."""
    spec = spec or LaneSpec()
    rng = np.random.default_rng(seed)
    base_x = np.sort(rng.uniform(0.15, 0.85, n_lanes)) * img_w
    slopes = rng.uniform(-0.35, 0.35, n_lanes)
    curves = rng.uniform(-0.1, 0.1, n_lanes)
    y_tops = rng.uniform(0.15, 0.4, n_lanes) * img_h
    vx = rng.uniform(-drift, drift, n_lanes)
    frames, labels, points_all = [], [], []
    for ti in range(t):
        noise = rng.integers(0, 30, (img_h // 8, img_w // 8, 3),
                             dtype=np.uint8)
        noise = np.repeat(np.repeat(noise, 8, 0), 8, 1)
        img = np.full((img_h, img_w, 3), 70, np.int16)
        img[:noise.shape[0], :noise.shape[1]] += noise.astype(np.int16) - 15
        img = np.clip(img, 0, 255).astype(np.uint8)
        lanes_pts: List[np.ndarray] = []
        for i in range(n_lanes):
            pts = lane_points(base_x[i] + vx[i] * ti, slopes[i], curves[i],
                              y_tops[i], img_h)
            if ((pts[:, 0] >= 0) & (pts[:, 0] < img_w)).sum() < 2:
                continue
            draw_polyline(img, pts.astype(np.int32).astype(np.float32), 230)
            lanes_pts.append(pts)
        sorted_lanes = [p[np.argsort(-p[:, 1])] for p in lanes_pts]
        labels.append(encode_lane_label(
            [list(map(tuple, p)) for p in sorted_lanes],
            list(range(len(sorted_lanes))), spec, img_h, img_w, max_lanes))
        frames.append(normalize(img))
        points_all.append(sorted_lanes)
    return {"frames": np.stack(frames), "labels": np.stack(labels),
            "points": points_all, "size": (img_h, img_w)}


@dataclass
class SyntheticVideoDataset:
    """N videos of ``frames_per_video`` frames. ``max_skip`` is the
    curriculum's frame-skip state, kept so that a resumed run restores it
    (``increase_max_skip`` adds ``skip_increment`` up to
    ``max_training_skip``); synthetic clips are drawn the same whatever it
    is."""

    n_videos: int = 4
    frames_per_video: int = 8
    img_h: int = 384
    img_w: int = 768
    spec: LaneSpec = None
    max_lanes: int = 8
    seed: int = 0
    max_skip: int = 0
    skip_increment: int = 5
    max_training_skip: int = 100

    def __post_init__(self):
        self.spec = self.spec or LaneSpec()
        self.videos = [f"synth_{i:03d}" for i in range(self.n_videos)]

    def __len__(self):
        return self.n_videos

    def increase_max_skip(self):
        self.max_skip = min(self.max_skip + self.skip_increment,
                            self.max_training_skip)

    def set_max_skip(self, max_skip: int):
        self.max_skip = max_skip

    def __getitem__(self, idx: int) -> Dict:
        clip = synthetic_clip(self.seed * 1000 + idx, self.frames_per_video,
                              self.img_h, self.img_w, spec=self.spec,
                              max_lanes=self.max_lanes)
        return {"name": self.videos[idx], "frames": clip["frames"],
                "labels": clip["labels"]}

    def get_clip(self, idx: int) -> Dict:
        """The whole clip for the inference pipeline: ``__getitem__``'s
        keys and the lane ``points``, the frame ``size`` and
        ``frame_names``, as the JAX package's ``get_clip`` gives them."""
        clip = synthetic_clip(self.seed * 1000 + idx, self.frames_per_video,
                              self.img_h, self.img_w, spec=self.spec,
                              max_lanes=self.max_lanes)
        return {"name": self.videos[idx], "frames": clip["frames"],
                "labels": clip["labels"], "points": clip["points"],
                "size": clip["size"],
                "frame_names": [f"{i:05d}" for i in
                                range(self.frames_per_video)]}

"""Lane geometry for the port: prior rows, anchor embeddings, decoding,
label encoding.

Own copy of the parts of ``phnet_tpu.geometry`` that inference and
training need (host-side numpy/scipy): :class:`Lane`, :func:`prior_ys`,
:func:`decode_predictions`, :func:`decode_kept_rows`,
:func:`build_prior_embeddings`, and the label encoder with its helpers
(:func:`sample_ys_for`, :func:`filter_lane`, :func:`sample_lane`,
:func:`encode_lane_label`).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
from scipy.interpolate import InterpolatedUnivariateSpline

from .config import LaneSpec


class Lane:
    """Spline-backed lane in normalized image coordinates: ``points`` is
    an (N, 2) array of (x, y) sorted by increasing y; calling the lane
    evaluates x(y)."""

    def __init__(self, points: np.ndarray, invalid_value: float = -2.0,
                 metadata=None):
        self.points = np.asarray(points, dtype=np.float64)
        self.invalid_value = invalid_value
        self.function = InterpolatedUnivariateSpline(
            self.points[:, 1], self.points[:, 0],
            k=min(3, len(self.points) - 1))
        self.min_y = self.points[:, 1].min() - 0.01
        self.max_y = self.points[:, 1].max() + 0.01
        self.metadata = metadata or {}

    def __call__(self, lane_ys: np.ndarray) -> np.ndarray:
        lane_xs = self.function(lane_ys)
        lane_xs[(lane_ys < self.min_y) | (lane_ys > self.max_y)] = (
            self.invalid_value)
        return lane_xs

    def __repr__(self):
        return "[Lane]\n" + str(self.points) + "\n[/Lane]"

    def __len__(self):
        return len(self.points)


INVALID = -1e5  # offset columns of a label row that hold no lane point


def sample_ys_for(img_h: int, n_offsets: int) -> np.ndarray:
    """Row sampling grid: bottom (y=img_h) to top (y=0), ``n_offsets``
    rows (reference ``transformV4.py:90``)."""
    strip_size = img_h / (n_offsets - 1)
    return np.arange(img_h, -1, -strip_size)[:n_offsets]


def filter_lane(lane: Sequence[Sequence[float]]) -> List[Sequence[float]]:
    """Drop points sharing a y value, keeping the first occurrence.
    Expects bottom-to-top order."""
    assert lane[-1][1] <= lane[0][1]
    filtered, used = [], set()
    for p in lane:
        if p[1] not in used:
            filtered.append(p)
            used.add(p[1])
    return filtered


def sample_lane(points: Sequence[Sequence[float]], sample_ys: np.ndarray,
                img_w: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Spline-resample a polyline onto fixed rows, extrapolated to the
    image bottom by the straight line through its two lowest points.
    ``points`` sorted bottom-to-top (decreasing y), unique y. Returns
    ``(extrap_xs, interp_xs, xs_outside_image, xs_inside_image)``."""
    points = np.array(points, dtype=np.float64)
    if not np.all(points[1:, 1] < points[:-1, 1]):
        raise ValueError("Annotation points have to be sorted")
    x, y = points[:, 0], points[:, 1]
    assert len(points) > 1
    interp = InterpolatedUnivariateSpline(y[::-1], x[::-1],
                                          k=min(3, len(points) - 1))
    inside_ys = sample_ys[(sample_ys >= y.min()) & (sample_ys <= y.max())]
    assert len(inside_ys) > 0
    interp_xs = interp(inside_ys)
    extrap = np.polyfit(points[:2, 1], points[:2, 0], deg=1)
    extrap_xs = np.polyval(extrap, sample_ys[sample_ys > y.max()])
    all_xs = np.hstack((extrap_xs, interp_xs))
    inside = (all_xs >= 0) & (all_xs < img_w)
    return extrap_xs, interp_xs, all_xs[~inside], all_xs[inside]


def encode_lane_label(lanes: Sequence[Sequence[Sequence[float]]],
                      lane_ids: Sequence[int], spec: LaneSpec, img_h: int,
                      img_w: int, max_lanes: int) -> np.ndarray:
    """Raw polylines to the fixed ``[max_lanes, spec.dim]`` label (reference
    ``transformV4.py:183-216`` for VIL: start_x over ``img_w``, a valid and
    an invalid length; OL: start_x over ``img_w - 1``, one length). Offset
    columns hold absolute pixel xs; unset entries are :data:`INVALID`. Row
    ``lane_id`` holds lane ``lane_id``; ids past ``max_lanes`` are skipped."""
    n_strips = spec.n_strips
    strip_size = img_h / n_strips
    sample_ys = sample_ys_for(img_h, spec.n_offsets)
    label = np.ones((max_lanes, spec.dim), dtype=np.float32) * INVALID
    label[:, 0] = 1.0
    label[:, 1] = 0.0
    for lane_id, lane in zip(lane_ids, lanes):
        if len(lane) < 2:
            continue
        lane = filter_lane(sorted(lane, key=lambda p: -p[1]))
        if len(lane) < 2 or lane_id >= max_lanes:
            continue
        try:
            extrap_xs, interp_xs, xs_out, xs_in = sample_lane(
                lane, sample_ys, img_w)
        except (ValueError, AssertionError):
            continue
        if len(xs_in) <= 1:
            continue
        all_xs = np.hstack((xs_out, xs_in))
        row = label[lane_id]
        row[0], row[1] = 0.0, 1.0
        row[spec.col_start_y] = len(xs_out) / n_strips
        thetas = []
        for i in range(1, len(xs_in)):
            theta = math.atan(i * strip_size
                              / (xs_in[i] - xs_in[0] + 1e-5)) / math.pi
            thetas.append(theta if theta > 0 else 1 - abs(theta))
        row[spec.col_theta] = sum(thetas) / len(thetas)
        if spec.n_lengths == 2:
            row[spec.col_start_x] = xs_in[0] / img_w
            row[spec.col_length] = len(interp_xs) / n_strips
            row[spec.col_invalid_length] = (len(extrap_xs)
                                            - len(xs_out)) / n_strips
        else:
            row[spec.col_start_x] = xs_in[0] / (img_w - 1)
            row[spec.col_length] = len(xs_in) / n_strips
        row[spec.col_xs:spec.col_xs + len(all_xs)] = all_xs
    return label


def prior_ys(n_offsets: int) -> np.ndarray:
    """Normalized row ys, 1 (bottom) .. 0 (top)."""
    return np.linspace(1.0, 0.0, n_offsets)


def decode_predictions(
    predictions: np.ndarray,
    spec: LaneSpec,
    ori_img_h: int = 0,
    cut_height: int = 0,
    extend_bottom: bool = False,
) -> List[Lane]:
    """Kept lane vectors (N, spec.dim), xs normalized and length fields
    already rounded to strip counts, to :class:`Lane` objects.

    VIL: the start includes the invalid length and ys are un-cropped with
    ``(y*(ori_h-cut)+cut)/ori_h``. OL (``extend_bottom``): no y transform,
    the contiguous in-image run below the start row is kept.
    """
    ys = prior_ys(spec.n_offsets)
    n_strips = spec.n_strips
    lanes: List[Lane] = []
    for lane in predictions:
        lane_xs = lane[spec.col_xs:].astype(np.float64).copy()
        start = min(max(0, int(round(lane[spec.col_start_y] * n_strips))),
                    n_strips)
        if spec.n_lengths == 2:
            start = start + int(round(lane[spec.col_invalid_length]))
        length = int(round(lane[spec.col_length]))
        end = min(start + length - 1, spec.n_offsets - 1)
        if extend_bottom and start > 0:
            head = lane_xs[:start]
            keep_run = (
                ((head >= 0.0) & (head <= 1.0))[::-1].cumprod()[::-1]
                .astype(bool))
            head[~keep_run] = -2.0
            lane_xs[:start] = head
        else:
            lane_xs[:start] = -2.0
        lane_xs[end + 1:] = -2.0
        valid = lane_xs >= 0
        lane_ys = ys[valid][::-1]
        xs = lane_xs[valid][::-1]
        if ori_img_h > 0:
            lane_ys = (lane_ys * (ori_img_h - cut_height) + cut_height) / (
                ori_img_h)
        if len(xs) <= 1:
            continue
        lanes.append(Lane(
            points=np.stack([xs, lane_ys], axis=1),
            metadata={
                "start_x": float(lane[spec.col_start_x]),
                "start_y": float(lane[spec.col_start_y]),
                "conf": float(lane[1]),
            },
        ))
    return lanes


def decode_kept_rows(rows: np.ndarray, spec: LaneSpec, ori_img_h: int = 0,
                     cut_height: int = 0) -> List[Lane]:
    """NMS-kept prediction rows (normalized length fields) to Lanes: scale
    the length field(s) to strip counts, then decode (VIL un-crops y with
    the stream's original geometry, OL extends to the image bottom)."""
    if len(rows) == 0:
        return []
    rows = np.asarray(rows, dtype=np.float64).copy()
    rows[:, spec.col_length] = np.round(rows[:, spec.col_length]
                                        * spec.n_strips)
    if spec.n_lengths == 2:
        rows[:, spec.col_invalid_length] = np.round(
            rows[:, spec.col_invalid_length] * spec.n_strips)
        return decode_predictions(rows, spec, ori_img_h=ori_img_h,
                                  cut_height=cut_height)
    return decode_predictions(rows, spec, extend_bottom=True)


def build_prior_embeddings(num_priors: int) -> np.ndarray:
    """Initial (start_y, start_x, theta) anchor parameters: left-edge,
    bottom-left, bottom-right and right-edge groups, two angles per start
    point (reference ``RouterV4.py:176-214``)."""
    w = np.zeros((num_priors, 3), dtype=np.float32)
    half_bottom = num_priors // 4
    left = num_priors // 4
    half = num_priors // 2
    strip_size = 0.8 / (left // 2 - 1)
    bottom_strip_size = 0.5 / (half_bottom // 2 + 1)

    for i in range(left):
        w[i, 0] = (i // 2) * strip_size
        w[i, 1] = 0.0
        w[i, 2] = 0.16 if i % 2 == 0 else 0.32
    for i in range(left, half):
        w[i, 0] = 0.0
        w[i, 1] = ((i - left) // 2 + 1) * bottom_strip_size
        w[i, 2] = 0.2 if i % 2 == 0 else 0.4
    for i in range(half, half + half_bottom):
        w[i, 0] = 0.0
        w[i, 1] = ((i - half) // 2 + 1) * bottom_strip_size + 0.5
        w[i, 2] = 0.6 if i % 2 == 0 else 0.8
    for i in range(half + half_bottom, num_priors):
        w[i, 0] = ((i - half - half_bottom) // 2) * strip_size
        w[i, 1] = 1.0
        w[i, 2] = 0.68 if i % 2 == 0 else 0.84
    return w

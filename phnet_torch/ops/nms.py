"""Row-wise lane NMS, batched over streams.

Port of ``phnet_tpu/ops/nms.py`` (``nms_proposals_from_predictions``,
``lane_nms``), of ``phnet_tpu/ops/nms_pallas.py::lane_nms_pallas`` and of
the keeps of ``PHNet._nms_keeps`` (``phnet_tpu/models/phnet.py``).

Suppression predicate (the reference's ``nms_kernel.cu`` ``devIoU``): for
proposals a, b with ``start = trunc(start_y * n_strips + .5)`` and the
whole-expression trunc ``end = trunc(start + len - 1 + .5 - (len - 1 <
0))`` clipped to ``n_offsets - 1``, a suppresses b iff the strip windows
overlap and ``sum |a.xs - b.xs|`` over the overlap is ``< thr * overlap``.
The greedy pass walks the proposals by descending score (stable sort,
invalid rows last), keeps a valid unsuppressed proposal while fewer than
``top_k`` are kept, and suppresses with it.

Two entries, both one launch of the CUDA kernel ``csrc/lane_nms.cu`` for
CUDA tensors and their plain PyTorch version for CPU tensors:
:func:`nms_keeps` goes from routed predictions to the kept rows (the
model's path), :func:`lane_nms` from proposal rows to the keeps. The
kernel picks by block argmax instead of sorting and walking; it keeps the
same proposals (see the note in its source).

Each entry is the PyTorch operator ``phnet::nms_keeps`` /
``phnet::lane_nms`` (``torch.library.custom_op``): its CUDA
implementation launches the kernel, its CPU implementation runs the plain
version, and its fake implementation gives the output shapes, so that
``torch.export`` records the entry as one node of the graph. The
operators take the lane layout as the columns and scales the kernel
reads.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from ..config import LaneSpec
from . import _build


def nms_proposals_from_predictions(predictions: torch.Tensor, spec: LaneSpec,
                                   img_w: int) -> torch.Tensor:
    """``[..., 5 + n_offsets]`` NMS rows from full lane vectors: drop theta
    (and VIL's invalid length), scale start_x and xs by ``img_w - 1`` and
    the length by ``n_strips``."""
    cls01 = predictions[..., :2]
    start_y = predictions[..., spec.col_start_y:spec.col_start_y + 1]
    start_x = predictions[..., spec.col_start_x:spec.col_start_x + 1] * (
        img_w - 1)
    length = predictions[..., spec.col_length:spec.col_length + 1] * (
        spec.n_strips)
    xs = predictions[..., spec.col_xs:] * (img_w - 1)
    return torch.cat([cls01, start_y, start_x, length, xs], dim=-1)


def _sorted_problem(proposals, scores, valid, n_offsets: int):
    """Score order and the sorted strip windows, xs and valid flags
    (what ``lane_nms_pallas`` computes before its kernel)."""
    neg_inf = torch.full_like(scores, float("-inf"))
    order = torch.argsort(-torch.where(valid, scores, neg_inf), dim=-1,
                          stable=True)
    props = torch.gather(
        proposals, 1, order[..., None].expand(-1, -1, proposals.shape[-1]))
    valid_sorted = torch.gather(valid, 1, order)
    n_strips = n_offsets - 1
    starts = torch.trunc(props[..., 2] * n_strips + 0.5).to(torch.int32)
    length = props[..., 4]
    ends = torch.trunc(
        starts.to(length.dtype) + length - 0.5
        - (length - 1.0 < 0).to(length.dtype)).to(torch.int32)
    ends = torch.clamp(ends, max=n_offsets - 1)
    xs = props[..., 5:5 + n_offsets].to(torch.float32).contiguous()
    return order, starts, ends, xs, valid_sorted


def _scatter_keeps(keep_sorted: torch.Tensor, order: torch.Tensor,
                   top_k: int):
    """Sorted keep flags [B, A] -> (keep_idx [B, top_k] in the original
    order padded with -1, num_kept [B], keep_mask [B, A])."""
    b, a = keep_sorted.shape
    num_kept = keep_sorted.sum(-1)
    kept_rank = torch.cumsum(keep_sorted.long(), -1) - 1
    src = torch.where(keep_sorted, kept_rank, torch.full_like(kept_rank,
                                                              top_k))
    keep_idx = torch.zeros((b, top_k + 1), dtype=torch.long,
                           device=order.device).scatter_(1, src, order)
    slots = torch.arange(top_k, device=order.device)
    keep_idx = torch.where(slots[None] < num_kept[:, None],
                           keep_idx[:, :top_k], -1)
    keep_mask = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep_idx, num_kept, keep_mask


def _greedy_plain(starts, ends, xs, valid, thresh: float, top_k: int):
    """The greedy walk in PyTorch: full [B, A, A] suppression matrix, then
    a loop over the sorted proposals."""
    b, a, o = xs.shape
    pair_start = torch.maximum(starts[:, :, None], starts[:, None, :])
    pair_end = torch.minimum(ends[:, :, None], ends[:, None, :])
    rows = torch.arange(o, device=xs.device, dtype=torch.int32)
    in_range = ((rows >= pair_start[..., None])
                & (rows <= pair_end[..., None]))
    absdiff = (xs[:, :, None, :] - xs[:, None, :, :]).abs()
    dist = torch.where(in_range, absdiff, 0.0).sum(-1)
    count = (pair_end - pair_start + 1).to(dist.dtype)
    sup = ((pair_end >= pair_start) & (dist < thresh * count)
           & valid[:, :, None] & valid[:, None, :])
    suppressed = torch.zeros((b, a), dtype=torch.bool, device=xs.device)
    keep = torch.zeros_like(suppressed)
    num = torch.zeros(b, dtype=torch.long, device=xs.device)
    for i in range(a):
        can = valid[:, i] & ~suppressed[:, i] & (num < top_k)
        suppressed |= sup[:, i] & can[:, None]
        keep[:, i] = can
        num += can
    return keep


def lane_nms_plain(proposals, scores, valid, thresh: float, n_offsets: int,
                   top_k: int):
    """The plain PyTorch version of :func:`lane_nms`, on any device: sort,
    strip windows, the greedy walk, scatter."""
    order, starts, ends, xs, vs = _sorted_problem(proposals, scores, valid,
                                                  n_offsets)
    keep_sorted = _greedy_plain(starts, ends, xs, vs, thresh, top_k)
    return _scatter_keeps(keep_sorted, order, top_k)


def nms_keeps_plain(routed: torch.Tensor, scores: torch.Tensor,
                    spec: LaneSpec, img_w: int, conf_threshold: float,
                    thresh: float, top_k: int):
    """The plain PyTorch version of :func:`nms_keeps`, on any device: the
    confidence filter, the NMS rows of
    :func:`nms_proposals_from_predictions`, :func:`lane_nms_plain` and the
    gather of the kept rows."""
    return _keeps_plain(routed, scores, _lane_columns(spec),
                        spec.n_offsets, float(img_w - 1),
                        float(spec.n_strips), conf_threshold, thresh, top_k)


def _lane_columns(spec: LaneSpec) -> Tuple[int, int, int]:
    """The columns of start_y, length and the first x: what the kernel
    reads of the lane layout."""
    return spec.col_start_y, spec.col_length, spec.col_xs


def _keeps_plain(routed, scores, cols, n_offsets: int, xs_scale: float,
                 len_scale: float, conf_threshold: float, thresh: float,
                 top_k: int):
    """:func:`nms_keeps_plain` from the columns and scales: the NMS rows
    hold what :func:`lane_nms_plain` reads (start_y, the scaled length and
    xs) where :func:`nms_proposals_from_predictions` puts them; the
    start_x column, which it does not read, holds start_y."""
    c_y, c_len, c_xs = cols
    valid = scores >= conf_threshold
    start_y = routed[..., c_y:c_y + 1]
    props = torch.cat([routed[..., :2], start_y, start_y,
                       routed[..., c_len:c_len + 1] * len_scale,
                       routed[..., c_xs:c_xs + n_offsets] * xs_scale],
                      dim=-1)
    keep_idx, num_kept, keep_mask = lane_nms_plain(
        props, scores, valid, thresh, n_offsets, top_k)
    gather_idx = keep_idx.clamp(0, routed.shape[1] - 1)
    kept = torch.gather(
        routed, 1, gather_idx[..., None].expand(-1, -1, routed.shape[-1]))
    return kept, keep_idx, num_kept, keep_mask


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("lane_nms").lane_nms_launch
    p, i, f, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
        ctypes.c_longlong
    fn.argtypes = [p, p, q, q, p, p, p, p, p, i, i, i, i, i, i, i, f, f, f,
                   f, i, p]
    fn.restype = i
    return fn


def _nms_cuda(rows, scores, valid: Optional[torch.Tensor], cols,
              n_offsets: int, xs_scale: float, len_scale: float,
              conf_threshold: float, thresh: float, top_k: int,
              gather: bool):
    """One launch of ``csrc/lane_nms.cu`` on the current stream. ``cols``
    are the columns of start_y, length and the first x in ``rows``; a
    ``valid`` of None means ``scores >= conf_threshold``. Returns
    (kept or None, keep_idx, num_kept, keep_mask)."""
    if rows.dim() != 3:
        raise ValueError(f"lane_nms kernel: rows must be [B, A, dim], got "
                         f"{tuple(rows.shape)}")
    b, a, dim = rows.shape
    given = {"rows": (rows, torch.float32), "scores": (scores, torch.float32)}
    if valid is not None:
        given["valid"] = (valid, torch.bool)
    for name, (t, dt) in given.items():
        if t.device != rows.device or t.dtype != dt:
            raise ValueError(f"lane_nms kernel: {name} must be a {dt} tensor "
                             f"on {rows.device}, got {t.dtype} on {t.device}")
        if t.shape[:2] != (b, a):
            raise ValueError(f"lane_nms kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected [{b}, {a}, ...]")
    if not (rows.is_cuda and rows.is_contiguous()):
        raise ValueError("lane_nms kernel: rows must be a contiguous CUDA "
                         "tensor")
    if valid is not None and not valid.is_contiguous():
        raise ValueError("lane_nms kernel: valid must be contiguous")
    dev = rows.device
    kept = (torch.empty((b, top_k, dim), dtype=torch.float32, device=dev)
            if gather else None)
    keep_idx = torch.empty((b, top_k), dtype=torch.long, device=dev)
    num_kept = torch.empty(b, dtype=torch.long, device=dev)
    keep_mask = torch.empty((b, a), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            rows.data_ptr(), scores.data_ptr(), scores.stride(0),
            scores.stride(1), None if valid is None else valid.data_ptr(),
            None if kept is None else kept.data_ptr(), keep_idx.data_ptr(),
            num_kept.data_ptr(), keep_mask.data_ptr(), b, a, dim, *cols,
            n_offsets, xs_scale, len_scale, conf_threshold, thresh, top_k,
            stream)
    if err != 0:
        raise RuntimeError(
            f"lane_nms kernel launch failed for {a} rows of {dim} (columns "
            f"{cols}, {n_offsets} offsets; the kernel takes at most 8192 "
            f"rows and the shared memory of one SM): CUDA error {err}")
    lane_nms.launches += 1
    return kept, keep_idx, num_kept, keep_mask


@torch.library.custom_op("phnet::nms_keeps", mutates_args=(),
                         device_types="cpu")
def _nms_keeps_op(routed: Tensor, scores: Tensor, col_start_y: int,
                  col_length: int, col_xs: int, n_offsets: int,
                  xs_scale: float, len_scale: float, conf_threshold: float,
                  thresh: float, top_k: int
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    return _keeps_plain(routed, scores, (col_start_y, col_length, col_xs),
                        n_offsets, xs_scale, len_scale, conf_threshold,
                        thresh, top_k)


@_nms_keeps_op.register_kernel("cuda")
def _(routed, scores, col_start_y, col_length, col_xs, n_offsets, xs_scale,
      len_scale, conf_threshold, thresh, top_k):
    return _nms_cuda(routed, scores, None, (col_start_y, col_length, col_xs),
                     n_offsets, xs_scale, len_scale, conf_threshold, thresh,
                     top_k, gather=True)


@_nms_keeps_op.register_fake
def _(routed, scores, col_start_y, col_length, col_xs, n_offsets, xs_scale,
      len_scale, conf_threshold, thresh, top_k):
    b, a, dim = routed.shape
    return (routed.new_empty((b, top_k, dim)), *_keeps_like(routed, top_k))


def _keeps_like(rows: Tensor, top_k: int):
    """Empty (keep_idx, num_kept, keep_mask) for rows [B, A, ...]."""
    b, a = rows.shape[:2]
    return (rows.new_empty((b, top_k), dtype=torch.long),
            rows.new_empty((b,), dtype=torch.long),
            rows.new_empty((b, a), dtype=torch.bool))


@torch.library.custom_op("phnet::lane_nms", mutates_args=(),
                         device_types="cpu")
def _lane_nms_op(proposals: Tensor, scores: Tensor, valid: Tensor,
                 thresh: float, n_offsets: int, top_k: int
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    return lane_nms_plain(proposals, scores, valid, thresh, n_offsets, top_k)


@_lane_nms_op.register_kernel("cuda")
def _(proposals, scores, valid, thresh, n_offsets, top_k):
    return _nms_cuda(proposals, scores, valid.contiguous(), (2, 4, 5),
                     n_offsets, 1.0, 1.0, 0.0, thresh, top_k,
                     gather=False)[1:]


@_lane_nms_op.register_fake
def _(proposals, scores, valid, thresh, n_offsets, top_k):
    return _keeps_like(proposals, top_k)


def nms_keeps(routed: torch.Tensor, scores: torch.Tensor, spec: LaneSpec,
              img_w: int, conf_threshold: float, thresh: float,
              top_k: int):
    """Confidence filter, lane NMS and the kept rows, from routed
    predictions [B, A, spec.dim] and their scores [B, A] (the softmax's
    positive class; any strides).

    Returns kept [B, top_k, dim] (the routed rows of the keeps; empty
    slots hold row 0), keep_idx [B, top_k] (descending score, padded with
    -1), num_kept [B] and keep_mask [B, A]. One call of the operator
    ``phnet::nms_keeps``: CUDA tensors run the kernel
    ``csrc/lane_nms.cu`` in one launch; CPU tensors run
    :func:`nms_keeps_plain`."""
    return torch.ops.phnet.nms_keeps(
        routed, scores, *_lane_columns(spec), spec.n_offsets,
        float(img_w - 1), float(spec.n_strips), float(conf_threshold),
        float(thresh), int(top_k))


def lane_nms(proposals: torch.Tensor, scores: torch.Tensor,
             valid: torch.Tensor, thresh: float, n_offsets: int,
             top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy lane NMS for B streams.

    proposals: [B, A, 5 + n_offsets] rows from
    :func:`nms_proposals_from_predictions`; scores: [B, A]; valid: [B, A]
    bool (invalid rows are never kept and suppress nothing).
    Returns keep_idx [B, top_k] (original order, padded with -1),
    num_kept [B] and keep_mask [B, A]. One call of the operator
    ``phnet::lane_nms``: CUDA tensors run the kernel ``csrc/lane_nms.cu``
    (columns 2, 4 and 5, unscaled); CPU tensors run
    :func:`lane_nms_plain`.
    """
    return torch.ops.phnet.lane_nms(proposals, scores, valid, float(thresh),
                                    int(n_offsets), int(top_k))


lane_nms.launches = 0  # kernel launches of both entries, counted where the
# kernel launches

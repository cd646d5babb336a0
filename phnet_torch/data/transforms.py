"""Image and lane-geometry transforms of the readers, without OpenCV.

Counterpart of ``phnet_tpu/data/transforms.py`` (the reference's imgaug
pipelines, ``transformV4.py:95-123`` from ``optionsV3.py:50-88``; OL's
``openlane/transforms.py``): the ImageNet normalization, the resize with
its lanes, and :class:`TrainAugment`. Pixels are a uint8 ``[H, W, 3]``
RGB tensor on the reader's device (the card, or the CPU) and stay there;
the random draws, the lanes and the small matrices stay on the host, in
one ``np.random.Generator`` drawn in the JAX class's order with its calls,
so that one seed gives both packages the same ops and parameters.

The JAX class runs OpenCV. Each op here computes what OpenCV 5.0's x86-64
build computes (its SIMD paths with AVX2 and fused multiply-adds), in
PyTorch, and is bit-equal to it on the tests' images
(``tests/test_torch_augment.py``):

* resize (``cv2.resize``, ``INTER_LINEAR``, uint8): 11-bit weights
  rounded from float32 offsets, integer row sums, then the vertical pass
  of ``VResizeLinearVec_32s8u``: ``((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1
  >> 16)``, rounded by ``(+ 2) >> 2``;
* brightness: float32 ``x * mul``, then ``+ add`` (two roundings), clipped
  and truncated to uint8;
* RGB -> HSV: OpenCV's fixed-point tables (``sdiv_table``,
  ``hdiv_table180``, shift 12, H on [0, 180)); HSV -> RGB: float32, with
  ``1 - s * h`` and ``1 - s * (1 - h)`` fused (the compiler contracts
  them), the result truncated;
* median blur (k 3 or 5): the median of the replicated-border window;
* motion blur: the kernel rotated by ``warpAffine`` on the host (float32
  offsets, fused interpolation), then ``filter2D``: a correlation with
  ``BORDER_REFLECT_101``, anchored at (k // 2, k // 2), summed over the
  kernel's non-zero taps in row order with fused multiply-adds, rounded
  half to even;
* affine (``warpAffine``, ``INTER_LINEAR``, ``BORDER_CONSTANT`` 0): the
  matrix inverted in float64 and cast to float32, source positions
  ``fma(m0, x, y * m1 + m2)``, taps outside the image reading 0, the
  interpolation in three fused multiply-adds, rounded half to even.

A fused multiply-add ``fma(a, b, c)`` of float32 operands is computed in
float64 and rounded once to float32 (the product is exact in float64; the
sum is double-rounded, which can move a result one float32 ulp in rare
cases).

The segmentation and flow planes ride the geometric steps only (the
resizes, the flip, the affine) and draw nothing, so that the image and
lanes come out the same with planes as without:

* resize: the mask with ``INTER_NEAREST`` (:func:`resize_nearest`:
  ``floor(d * in / out)``, not half-pixel), the flow with the float
  ``INTER_LINEAR`` (:func:`resize_linear_f32`: float32 weights, not the
  uint8 image's 11-bit ones);
* flip: mirrored, the flow's u **not** negated (imgaug flips heatmaps so,
  and the JAX class keeps it);
* affine: the mask with ``INTER_NEAREST`` (:func:`warp_affine_nearest`:
  the image's float source positions, rounded), the flow with OpenCV's
  fixed-point remap (:func:`warp_affine_f32`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Lanes = List[np.ndarray]  # list of (N, 2) float arrays (x, y)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_F32 = np.float32


class Normalize:
    """(img/255 - mean) / std (reference ``transform.py:194-203``)."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return ((img.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., 3]`` -> float32 ``(img / 255 - mean) / std`` on its
    device, in :class:`Normalize`'s order and roundings (true divisions:
    the divisors are tensors on the device, which PyTorch does not turn
    into products by reciprocals)."""
    dev = img.device
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(IMAGENET_STD).to(dev)
    return (img.to(torch.float32) / c255 - mean) / std


def scale_lanes(lanes: Lanes, src_h: int, src_w: int, out_h: int,
                out_w: int) -> Lanes:
    """The lanes of a (src_h, src_w) image in its resize to (out_h, out_w):
    ``resize_with_lanes``' arithmetic (float32 points times the float32
    pair (out_w / src_w, out_h / src_h))."""
    s = np.array([out_w / src_w, out_h / src_h], np.float32)
    return [lane * s for lane in lanes]


def _as_image(img) -> torch.Tensor:
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img))
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a uint8 [H, W, 3] image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    return img


def _on(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (in float64, then to float32)."""
    b = b.to(torch.float64) if torch.is_tensor(b) else float(b)
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


# --- resize ---------------------------------------------------------------

def _resize_taps(n_out: int, n_in: int, edge_weights: bool):
    """cv2 ``INTER_LINEAR``'s source indices and 11-bit weights along one
    axis: float32 offsets ``(d + 0.5) * scale - 0.5`` (scale = 1 / (n_out /
    n_in) in float64), floored; columns past either edge get weights (2048,
    0) (``edge_weights``), rows keep theirs and read clamped rows."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    if edge_weights:
        out = (s < 0) | (s >= n_in - 1)
        f[out] = 0
        s = np.clip(s, 0, n_in - 1)
    w0 = np.rint((_F32(1) - f) * _F32(2048)).astype(np.int32)
    w1 = np.rint(f * _F32(2048)).astype(np.int32)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def resize_u8(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_LINEAR)`` of a
    uint8 [H, W, 3] image, on its device (the fixed-point arithmetic in
    the module docstring)."""
    img = _as_image(img)
    h, w = img.shape[:2]
    dev = img.device
    x0, x1, a0, a1 = (_on(a, dev) for a in _resize_taps(out_w, w, True))
    y0, y1, b0, b1 = (_on(a, dev) for a in _resize_taps(out_h, h, False))
    rows = img[torch.cat([y0, y1])].to(torch.int32)  # [2 out_h, w, 3]
    s = (rows[:, x0] * a0[:, None] + rows[:, x1] * a1[:, None]) >> 4
    r = (((s[:out_h] * b0[:, None, None]) >> 16)
         + ((s[out_h:] * b1[:, None, None]) >> 16))
    return ((r + 2) >> 2).clamp_(0, 255).to(torch.uint8)


def resize_with_lanes(img: torch.Tensor, lanes: Lanes, out_h: int,
                      out_w: int) -> Tuple[torch.Tensor, Lanes]:
    h, w = img.shape[:2]
    return resize_u8(img, out_h, out_w), scale_lanes(lanes, h, w, out_h,
                                                     out_w)


def _linear_taps(n_out: int, n_in: int, clamp_weights: bool):
    """cv2 ``INTER_LINEAR``'s float taps along one axis: offsets
    ``float32((d + 0.5) * scale - 0.5)`` (scale = 1 / (n_out / n_in)),
    floored; columns outside [0, n_in - 1) take weights (1, 0)
    (``clamp_weights``), rows keep theirs and read clamped rows."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(_F32)).astype(_F32)
    if clamp_weights:
        f[(s < 0) | (s >= n_in - 1)] = 0
        s = np.clip(s, 0, n_in - 1)
    return (np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1),
            (_F32(1) - f).astype(_F32), f)


def resize_linear_f32(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``cv2.resize(x, (out_w, out_h), interpolation=INTER_LINEAR)`` of a
    float32 [H, W] or [H, W, C] array: each source row resized along x
    (``S[i] a0 + S[i + 1] a1``), then the rows blended (``R0 b0 + R1
    b1``), in float32 (bit-equal to OpenCV 5.0 on the tests' sizes). An
    exact halving of both sides is OpenCV's 2 x 2 mean, ``((p00 + p01) +
    (p10 + p11)) * 0.25`` for one channel, ``(((p00 + p01) + p10) + p11)
    * 0.25`` for more; the same size is a copy."""
    h, w = x.shape[:2]
    if (out_h, out_w) == (h, w):
        return x.clone()
    dev = x.device
    if h == 2 * out_h and w == 2 * out_w:
        p00, p01 = x[0::2, 0::2], x[0::2, 1::2]
        p10, p11 = x[1::2, 0::2], x[1::2, 1::2]
        if x.dim() == 2:  # OpenCV's vector loop; its scalar loop otherwise
            return ((p00 + p01) + (p10 + p11)) * 0.25
        return (((p00 + p01) + p10) + p11) * 0.25
    x0, x1, a0, a1 = _linear_taps(out_w, w, True)
    y0, y1, b0, b1 = _linear_taps(out_h, h, False)
    extra = (None,) * (x.dim() - 2)
    a0, a1 = (torch.from_numpy(a).to(dev)[(slice(None),) + extra]
              for a in (a0, a1))
    b0, b1 = (torch.from_numpy(b).to(dev)[(slice(None), None) + extra]
              for b in (b0, b1))
    x0, x1, y0, y1 = (torch.from_numpy(i).to(dev) for i in (x0, x1, y0, y1))
    rows = x.index_select(0, torch.cat([y0, y1]))
    hr = rows[:, x0] * a0 + rows[:, x1] * a1
    return hr[:out_h] * b0 + hr[out_h:] * b1


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``cv2.resize(x, (out_w, out_h), interpolation=INTER_NEAREST)`` of an
    [H, W, ...] array: output d reads source ``floor(d * (1 / (out /
    in)))``, clamped (not half-pixel; the segmentation plane's resize)."""
    h, w = x.shape[:2]
    dev = x.device

    def src(n_out, n_in):
        s = np.floor(np.arange(n_out) * (1.0 / (n_out / n_in)))
        return torch.from_numpy(np.minimum(s, n_in - 1).astype(np.int64)
                                ).to(dev)

    return x.index_select(0, src(out_h, h)).index_select(1, src(out_w, w))


# --- photometric ops --------------------------------------------------------

def brightness(img: torch.Tensor, mul: float, add: float) -> torch.Tensor:
    """``clip(float32(img) * mul + add, 0, 255)`` truncated to uint8: the
    product and the sum rounded each (two ops, no fused multiply-add)."""
    x = img.to(torch.float32) * float(_F32(mul))
    x = x + float(_F32(add))
    return x.clamp_(0, 255).to(torch.uint8)


_HSV_SHIFT = 12
_DIVS = np.arange(1, 256, dtype=np.float64)
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / _DIVS)]
                       ).astype(np.int32)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6 * _DIVS))]
                       ).astype(np.int32)
# tab indices of (r, g, b) by hue sector (OpenCV's sector_data, reversed)
_SECTORS = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                     [3, 1, 0], [0, 1, 2]], np.int64)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(img, COLOR_RGB2HSV)`` of uint8 RGB ``[..., 3]``:
    int32 (H in [0, 180], S, V)."""
    dev = img.device
    x = img.to(torch.int32)
    r, g, b = x.unbind(-1)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _on(_SDIV, dev)[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _on(_HDIV, dev)[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(hsv, COLOR_HSV2RGB)`` of integer (H, S, V) values in
    [0, 255] ``[..., 3]``: uint8 RGB (the float32 arithmetic in the module
    docstring)."""
    dev = hsv.device
    h = hsv[..., 0].to(torch.float32) * float(_F32(6.0 / 180))
    s = hsv[..., 1].to(torch.float32) * float(_F32(1.0 / 255))
    v = hsv[..., 2].to(torch.float32) * float(_F32(1.0 / 255))
    pre = torch.trunc(h)
    h = h - pre
    sector = (pre - torch.trunc(pre * float(_F32(1.0 / 6))) * 6.0).long()
    one = torch.ones_like(s)
    tab = torch.stack([v, v * (1.0 - s),
                       v * _fma(-s, h, one),
                       v * _fma(-s, 1.0 - h, one)], -1)
    rgb = torch.gather(tab, -1, _on(_SECTORS, dev)[sector])
    return torch.trunc(rgb * 255.0).clamp_(0, 255).to(torch.uint8)


def hue_saturation(img: torch.Tensor, value: float) -> torch.Tensor:
    """imgaug's ``AddToHueAndSaturation`` as the JAX class computes it:
    ``value`` added to S (saturating) and, rescaled to OpenCV's 180-step
    wheel with Python's round, to H (wrapping), through RGB -> HSV -> RGB."""
    hsv = rgb_to_hsv(img)
    h = (hsv[..., 0] + int(round(value * 180.0 / 255.0))) % 180
    s = (hsv[..., 1] + int(round(value))).clamp(0, 255)
    return hsv_to_rgb(torch.stack([h, s, hsv[..., 2]], -1))


# --- blurs ------------------------------------------------------------------

def median_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.medianBlur(img, k)``, k odd: each channel's median over the
    k x k window, the border replicated."""
    h, w = img.shape[:2]
    a = k // 2
    dev = img.device
    rows = torch.arange(-a, h + a, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-a, w + a, device=dev).clamp_(0, w - 1)
    win = img[rows][:, cols].unfold(0, k, 1).unfold(1, k, 1)  # [h,w,3,k,k]
    return win.reshape(h, w, 3, k * k).median(-1).values


def _reflect101(n_out_lo: int, n: int, n_out_hi: int, dev) -> torch.Tensor:
    i = torch.arange(-n_out_lo, n + n_out_hi, device=dev)
    i = torch.where(i < 0, -i, i)
    return torch.where(i >= n, 2 * n - 2 - i, i)


def filter2d(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """``cv2.filter2D(img, -1, kernel)`` of a uint8 [H, W, 3] image with a
    float32 k x k kernel: the correlation anchored at (k // 2, k // 2),
    ``BORDER_REFLECT_101``, a fused multiply-add a non-zero tap in row
    order, rounded half to even and saturated."""
    k = kernel.shape[0]
    a = k // 2
    h, w = img.shape[:2]
    dev = img.device
    p = img[_reflect101(a, h, k - 1 - a, dev)][:, _reflect101(
        a, w, k - 1 - a, dev)].to(torch.float64)
    acc = None
    for i, j in zip(*np.nonzero(kernel)):
        term = p[i:i + h, j:j + w] * float(kernel[i, j])  # exact in float64
        acc = (term if acc is None else term + acc).to(torch.float32)
        acc = acc.to(torch.float64)
    if acc is None:
        return torch.zeros_like(img)
    return torch.round(acc).clamp_(0, 255).to(torch.uint8)


def rotation_matrix(center: Tuple[float, float], angle: float,
                    scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: [2, 3] float64, the centre rounded to
    float32 (OpenCV takes a ``Point2f``), the angle in degrees."""
    a = angle * (math.pi / 180)
    al, be = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]])


def _inverse_affine(m: np.ndarray, cast: bool = True) -> np.ndarray:
    """warpAffine's inversion of a forward [2, 3] matrix, in float64, to
    six float32 coefficients (m0 m1 m2 / m3 m4 m5; float64 without
    ``cast``)."""
    m = np.asarray(m, np.float64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.astype(_F32) if cast else m


def _fma_np(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def motion_blur_kernel(k: int, angle: float) -> np.ndarray:
    """The JAX class's motion-blur kernel: a centred horizontal line of
    1 / k rotated by ``angle`` degrees about the kernel's centre with
    ``cv2.warpAffine`` (float32, ``INTER_LINEAR``, zeros outside: for a
    kernel this small OpenCV runs its scalar loop, ``fma(x, m0, y * m1) +
    m2`` a position and fused interpolation), then divided by its sum."""
    kernel = np.zeros((k, k), np.float32)
    kernel[k // 2, :] = 1.0 / k
    m = _inverse_affine(rotation_matrix((k / 2 - 0.5, k / 2 - 0.5), angle,
                                        1.0))
    y, x = np.meshgrid(np.arange(k, dtype=_F32), np.arange(k, dtype=_F32),
                       indexing="ij")
    sx = _fma_np(x, m[0], (y * m[1]).astype(_F32)) + m[2]
    sy = _fma_np(x, m[3], (y * m[4]).astype(_F32)) + m[5]
    ix, iy = np.floor(sx).astype(np.int64), np.floor(sy).astype(np.int64)
    ax, ay = sx - ix.astype(_F32), sy - iy.astype(_F32)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < k) & (xx >= 0) & (xx < k)
        return np.where(ok, kernel[yy.clip(0, k - 1), xx.clip(0, k - 1)],
                        _F32(0))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = _fma_np(ax, p01 - p00, p00)
    bot = _fma_np(ax, p11 - p10, p10)
    kernel = _fma_np(ay, bot - top, top)
    kernel /= max(kernel.sum(), 1e-6)
    return kernel


# --- affine -----------------------------------------------------------------

def warp_affine(img: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``cv2.warpAffine(img, m, (W, H))`` of a uint8 [H, W, 3] image, ``m``
    the forward [2, 3] matrix (the float arithmetic in the module
    docstring; taps outside the image read 0)."""
    h, w = img.shape[:2]
    dev = img.device
    m = _inverse_affine(m)
    ys = np.arange(h, dtype=_F32)
    row_x = _on((ys * m[1]).astype(_F32) + m[2], dev)[:, None]
    row_y = _on((ys * m[4]).astype(_F32) + m[5], dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None]
    sx, sy = _fma(xs, float(m[0]), row_x), _fma(xs, float(m[3]), row_y)
    fx, fy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    ix, iy = fx.long(), fy.long()
    flat = img.reshape(-1, 3).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        px = flat[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]
        return torch.where(ok[..., None], px, zero)

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = _fma(ax, p01 - p00, p00)
    bot = _fma(ax, p11 - p10, p10)
    out = _fma(ay, bot - top, top)
    return torch.round(out).clamp_(0, 255).to(torch.uint8)


def warp_affine_nearest(plane: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``cv2.warpAffine(plane, m, (W, H), flags=INTER_NEAREST)`` of an
    [H, W] plane (the segmentation mask), ``m`` the forward [2, 3]
    matrix: source positions as :func:`warp_affine` computes them,
    rounded half to even; positions outside the image read 0 (bit-equal
    to OpenCV 5.0, ``tests/test_torch_planes.py``)."""
    h, w = plane.shape[:2]
    dev = plane.device
    m = _inverse_affine(m)
    ys = np.arange(h, dtype=_F32)
    row_x = _on((ys * m[1]).astype(_F32) + m[2], dev)[:, None]
    row_y = _on((ys * m[4]).astype(_F32) + m[5], dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None]
    ix = torch.round(_fma(xs, float(m[0]), row_x)).long()
    iy = torch.round(_fma(xs, float(m[3]), row_y)).long()
    ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    px = plane[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(ok, px, torch.zeros((), dtype=plane.dtype, device=dev))


_AB_BITS, _INTER_BITS = 10, 5  # OpenCV's warpAffine / remap fixed point


def warp_affine_f32(x: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """``cv2.warpAffine(x, m, (W, H))`` (``INTER_LINEAR``, zeros outside)
    of a float32 [H, W, C] array (the flow plane), ``m`` the forward
    [2, 3] matrix. OpenCV 5.0 runs a float image of two channels through
    its older remap path: the inverse in float64, source positions in
    fixed point (``AB_BITS`` 10, then 1/32 of a pixel: ``(rint((m1 y +
    m2) 1024) + 16 + rint(m0 x 1024)) >> 5``), the 32 x 32 table of
    float32 bilinear weights ``(1 - u, u) x (1 - v, v)``, the four taps
    summed left to right, taps outside the image 0 (bit-equal to OpenCV
    5.0, ``tests/test_torch_planes.py``)."""
    h, w = x.shape[:2]
    dev = x.device
    m = _inverse_affine(m, cast=False)
    scale = 1 << _AB_BITS
    half = scale // (1 << _INTER_BITS) // 2
    shift = _AB_BITS - _INTER_BITS
    xs, ys = np.arange(w), np.arange(h)
    ad, bd = np.rint(m[0] * xs * scale), np.rint(m[3] * xs * scale)
    x0 = np.rint((m[1] * ys + m[2]) * scale) + half
    y0 = np.rint((m[4] * ys + m[5]) * scale) + half
    fx = _on(((x0[:, None] + ad[None]).astype(np.int64)) >> shift, dev)
    fy = _on(((y0[:, None] + bd[None]).astype(np.int64)) >> shift, dev)
    mask = (1 << _INTER_BITS) - 1
    ix, iy = fx >> _INTER_BITS, fy >> _INTER_BITS
    step = _F32(1.0 / (1 << _INTER_BITS))
    u = _on(np.arange(1 << _INTER_BITS, dtype=_F32) * step, dev)
    ux, uy = u[fx & mask][..., None], u[fy & mask][..., None]
    flat = x.reshape(h * w, -1)
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]
        return torch.where(ok[..., None], v, zero)

    vy0, vx0 = 1.0 - uy, 1.0 - ux
    out = (tap(iy, ix) * (vy0 * vx0) + tap(iy, ix + 1) * (vy0 * ux)
           + tap(iy + 1, ix) * (uy * vx0) + tap(iy + 1, ix + 1) * (uy * ux))
    return out.reshape(x.shape)


# --- lane clipping (host) ---------------------------------------------------

def _clip_segment(p0: np.ndarray, p1: np.ndarray, h: int, w: int):
    """Liang-Barsky clip of segment p0->p1 against [0,w)x[0,h).

    Returns (q0, q1) or None when fully outside. Mirrors shapely's
    box-intersection that imgaug's ``clip_out_of_image_`` performs on each
    LineString (``transformV4.py:246``): crossings are interpolated onto
    the border instead of dropping the whole out-of-image run."""
    d = p1 - p0
    t0, t1 = 0.0, 1.0
    for num, den in (
        (p0[0] - 0.0, -d[0]),        # left:   x >= 0
        ((w - 1e-3) - p0[0], d[0]),  # right:  x <= w-eps
        (p0[1] - 0.0, -d[1]),        # top:    y >= 0
        ((h - 1e-3) - p0[1], d[1]),  # bottom: y <= h-eps
    ):
        if den == 0.0:
            if num < 0.0:
                return None
            continue
        t = num / den
        if den < 0.0:
            if t > t1:
                return None
            t0 = max(t0, t)
        else:
            if t < t0:
                return None
            t1 = min(t1, t)
    if t0 > t1:
        return None
    return p0 + t0 * d, p0 + t1 * d


def _clip_lanes(lanes: Lanes, h: int, w: int,
                ids: Optional[Sequence[int]] = None
                ) -> Tuple[Lanes, List[int]]:
    """Clip lane polylines to the image rectangle, interpolating border
    crossings (imgaug ``clip_out_of_image_`` LineString semantics,
    transformV4.py:246). Where the clip splits a lane into several pieces
    the piece with the most points is kept. A lane reduced to <2 points is
    dropped *together with its id* so that label rows keyed by lane id
    stay aligned (transformV4.py:183-216)."""
    out: Lanes = []
    out_ids: List[int] = []
    for i, l in enumerate(lanes):
        pieces: List[List[np.ndarray]] = []
        cur: List[np.ndarray] = []
        for a, b in zip(l[:-1], l[1:]):
            seg = _clip_segment(a.astype(np.float64), b.astype(np.float64),
                                h, w)
            if seg is None:
                if len(cur) >= 2:
                    pieces.append(cur)
                cur = []
                continue
            q0, q1 = seg
            if cur and np.allclose(cur[-1], q0, atol=1e-6):
                cur.append(q1)
            else:
                if len(cur) >= 2:
                    pieces.append(cur)
                cur = [q0, q1]
        if len(cur) >= 2:
            pieces.append(cur)
        if not pieces:
            continue
        best = max(pieces, key=len)
        pts = np.asarray(best, np.float32)
        # collapse consecutive duplicates the clipping may introduce
        keep = np.ones(len(pts), bool)
        keep[1:] = np.any(np.abs(np.diff(pts, axis=0)) > 1e-6, axis=1)
        pts = pts[keep]
        if len(pts) >= 2:
            out.append(pts)
            out_ids.append(i if ids is None else ids[i])
    return out, out_ids


@dataclass
class TrainAugment:
    """Probabilistic augmentation pipeline; VIL defaults from
    ``optionsV3.py:50-88``. Use ``ol_defaults()`` for the OpenLane knobs.
    The counterpart of ``phnet_tpu.data.transforms.TrainAugment``: the same
    fields, draws and lane geometry; the pixels on the image's device."""

    img_h: int = 384
    img_w: int = 768
    p_hflip: float = 0.1
    p_channel_shuffle: float = 0.1
    p_brightness: float = 0.5
    brightness_mul: Tuple[float, float] = (0.85, 1.15)
    brightness_add: Tuple[float, float] = (-10, 10)
    p_hue_sat: float = 0.5
    hue_sat_value: Tuple[float, float] = (-10, 10)
    p_blur: float = 0.2
    p_affine: float = 0.5
    translate: float = 0.1
    rotate_deg: float = 3.0
    scale: Tuple[float, float] = (0.95, 1.05)
    rng: np.random.Generator = field(default_factory=np.random.default_rng)

    @classmethod
    def ol_defaults(cls, img_h=384, img_w=768, rng=None):
        """OL 'complex' pipeline (``openlane/transforms.py:198-247``)."""
        return cls(img_h=img_h, img_w=img_w, p_hflip=0.0, p_channel_shuffle=0.1,
                   p_brightness=0.5, p_hue_sat=0.5, p_blur=0.1, p_affine=0.1,
                   rotate_deg=5.0, scale=(0.9, 1.1),
                   rng=rng or np.random.default_rng())

    def __call__(self, img, lanes: Lanes, ids: Optional[Sequence[int]] = None,
                 seg=None, flow=None):
        """``img`` uint8 [H, W, 3] RGB (a tensor, on any device, or a numpy
        array, read on the CPU). Returns ``(img, lanes)`` or, when ``ids``
        is given, ``(img, lanes, ids)`` with the ids of dropped lanes
        removed in step; ``img`` uint8 [img_h, img_w, 3] on the input's
        device. ``seg`` (an integer mask [H, W]) and ``flow`` (float32
        [H, W, 2]), where given, ride the geometric steps (the module
        docstring) and are appended to the tuple, on the image's device.
        Every probability is drawn, 0 or not, in the JAX class's order."""
        rng = self.rng
        img = _as_image(img)
        dev = img.device
        if seg is not None:
            seg = torch.as_tensor(seg).to(dev)
        if flow is not None:
            flow = torch.as_tensor(flow).to(dev, torch.float32)
        img, lanes = resize_with_lanes(img, lanes, self.img_h, self.img_w)
        h, w = img.shape[:2]
        if seg is not None:
            seg = resize_nearest(seg, h, w)
        if flow is not None:
            flow = resize_linear_f32(flow, h, w)

        if rng.random() < self.p_hflip:
            img = img.flip(1)
            lanes = [np.stack([w - 1 - l[:, 0], l[:, 1]], 1) for l in lanes]
            if seg is not None:
                seg = seg.flip(1)
            if flow is not None:
                flow = flow.flip(1)

        if rng.random() < self.p_channel_shuffle:
            img = img[..., _on(rng.permutation(3), img.device)]

        if rng.random() < self.p_brightness:
            mul = rng.uniform(*self.brightness_mul)
            add = rng.uniform(*self.brightness_add)
            img = brightness(img, mul, add)

        if rng.random() < self.p_hue_sat:
            img = hue_saturation(img, rng.uniform(*self.hue_sat_value))

        if rng.random() < self.p_blur:
            if rng.random() < 0.5:  # OneOf(MotionBlur, MedianBlur)
                img = median_blur(img, int(rng.choice([3, 5])))
            else:  # motion blur: 1-D kernel at random angle, k in [3, 5]
                k = int(rng.integers(3, 6))
                img = filter2d(img, motion_blur_kernel(
                    k, rng.uniform(0, 360)))

        if rng.random() < self.p_affine:
            tx = rng.uniform(-self.translate, self.translate) * w
            ty = rng.uniform(-self.translate, self.translate) * h
            ang = rng.uniform(-self.rotate_deg, self.rotate_deg)
            sc = rng.uniform(*self.scale)
            m = rotation_matrix((w / 2, h / 2), ang, sc)
            m[:, 2] += (tx, ty)
            img = warp_affine(img, m)
            if seg is not None:
                seg = warp_affine_nearest(seg, m)
            if flow is not None:
                flow = warp_affine_f32(flow, m)
            new_lanes = []
            for l in lanes:
                ones = np.ones((len(l), 1), np.float32)
                pts = np.concatenate([l, ones], 1) @ m.T
                new_lanes.append(pts.astype(np.float32))
            lanes = new_lanes

        lanes, kept_ids = _clip_lanes(lanes, h, w, ids)
        out = (img, lanes)
        if ids is not None:
            out = out + (kept_ids,)
        if seg is not None:
            out = out + (seg,)
        if flow is not None:
            out = out + (flow,)
        return out

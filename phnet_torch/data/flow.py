"""Dense optical flow (Farneback) and the VIL-100 flow planes.

Counterpart of ``phnet_tpu/data/flow.py`` (the reference's
``libs/utils/calcFlow.py``): two-frame Farneback flow with the
foreground mask, the offline generation of the quantized u/v gray JPEGs
of VIL-100's ``Flow/`` directory, and the dequantization the reader
applies (``dataV3.py:168-176``). The JAX module calls OpenCV; here every
step is PyTorch on the inputs' device (the card unless the caller gives
the CPU), computing what OpenCV 5.0's ``calcOpticalFlowFarneback`` computes
(``modules/video/src/optflowgf.cpp``) with flags 0:

* each frame to gray with ``cvtColor``'s fixed point; the port's decoders
  give **RGB** (``cv2.imread`` gives BGR), so the weights are taken in
  R, G, B order: ``(9798 R + 19235 G + 3735 B + 16384) >> 15`` (equal to
  OpenCV 5.0's on all 2^24 colours);
* a pyramid of ``levels + 1`` images (OpenCV counts the levels beyond the
  first; it stops where a side would fall under 32 pixels): level k is the
  full frame blurred by a Gaussian of sigma ``(1 / scale - 1) / 2`` and
  ``round(5 sigma) | 1`` taps (at least 3; at scale 1 OpenCV's fixed
  [1/4, 1/2, 1/4]), border reflected, then resized in float (``INTER_
  LINEAR``, or the 2 x 2 mean where the scale is exactly 2);
* the polynomial expansion (``FarnebackPolyExp``: a Gaussian of
  ``poly_sigma`` over ``2 poly_n + 1`` taps, borders replicated, the
  vertical pass in float32, the horizontal in float64);
* ``FarnebackUpdateMatrices`` (the second frame's coefficients sampled
  bilinearly at the displaced position, the 5-pixel border damped) and
  ``FarnebackUpdateFlow_Blur`` (a box window of ``winsize`` pixels, borders
  replicated, summed in float64) for ``iterations`` rounds a level, the
  coarse flow resized up by ``1 / pyr_scale`` to start the next level.

OpenCV runs the matrix update interleaved with the flow rows; it only
ever rewrites rows that no later blur reads, so updating after the whole
flow, as here, computes the same values. Flow is next -> prev in pixels,
(x, y), as OpenCV returns it.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from .transforms import resize_linear_f32

FARNEBACK_PARAMS = (0.5, 3, 15, 3, 5, 1.2, 0)
BOUND = 100.0  # quantization clamp, reference dataV3.py:104
JPEG_QUALITY = 95  # cv2.imwrite's default, the JAX package's flow JPEGs
# the JPEG round trip of a flow plane in levels: at most 4 for cv2's own
# write and read of the quantized Farneback planes of the fixture's
# VIL-100 frames (``tests/test_torch_flow.py::test_jpeg_round_trip_bound``
# measures it); the readers' flow is held to it
JPEG_ROUND_TRIP_LEVELS = 4
MIN_PYRAMID_SIDE = 32
_BORDER = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
# getGaussianKernel's fixed kernels for sigma <= 0 (ksize 1, 3, 5, 7)
_SMALL_GAUSSIAN = {1: [1.0], 3: [0.25, 0.5, 0.25],
                   5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                       0.109375, 0.03125]}
_F32 = np.float32


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [..., 3] -> uint8 gray, ``cv2.cvtColor(BGR2GRAY)`` of the
    same pixels in BGR order."""
    x = img.to(torch.int32)
    y = (x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735
         + 16384) >> 15
    return y.to(torch.uint8)


# --- filters and resizes of float32 planes ---------------------------------

def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """``cv2.getGaussianKernel(n, sigma, CV_32F)``."""
    if n % 2 == 1 and n <= 7 and sigma <= 0:
        t = np.array(_SMALL_GAUSSIAN[n], np.float64)
    else:
        sigma = sigma if sigma > 0 else ((n - 1) * 0.5 - 1) * 0.3 + 0.8
        x = np.arange(n) - (n - 1) * 0.5
        t = np.exp(-0.5 / (sigma * sigma) * x * x)
    cf = t.astype(_F32)
    s = 1.0 / float(np.sum(cf.astype(np.float64)))
    return (cf.astype(np.float64) * s).astype(_F32)


def _index(n_lo: int, n: int, n_hi: int, mode: str, dev) -> torch.Tensor:
    i = torch.arange(-n_lo, n + n_hi, device=dev)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2  # reflect-101
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _symmetric_pass(x: torch.Tensor, kernel: np.ndarray, dim: int,
                    mode: str) -> torch.Tensor:
    """Correlate float32 ``x`` along ``dim`` (0 or 1) with the symmetric
    odd ``kernel``: ``k0 x + sum_i k_i (x[-i] + x[+i])``, in float32."""
    r = len(kernel) // 2
    n = x.shape[dim]
    p = x.index_select(dim, _index(r, n, r, mode, x.device))

    def at(off):
        return p.narrow(dim, r + off, n)

    acc = at(0) * float(kernel[r])
    for i in range(1, r + 1):
        acc = acc + (at(-i) + at(i)) * float(kernel[r + i])
    return acc


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (ksize, ksize), sigma, sigma)`` of a float32
    [H, W] plane, ``BORDER_REFLECT_101``: rows, then columns."""
    k = gaussian_kernel(ksize, sigma)
    return _symmetric_pass(_symmetric_pass(x, k, 1, "reflect"), k, 0,
                           "reflect")


# --- Farneback --------------------------------------------------------------

def _poly_constants(n: int, sigma: float):
    """``FarnebackPrepareGaussian``: the float32 taps g, x g, x^2 g over
    -n..n and (ig11, ig03, ig33, ig55) of the inverted 6 x 6 Gram matrix
    (products in float32 as OpenCV's, summed in float64)."""
    if sigma < np.finfo(np.float32).eps:
        sigma = n * 0.3
    xs = np.arange(-n, n + 1)
    g = np.exp(-(xs * xs) / (2 * sigma * sigma)).astype(_F32)
    s = 1.0 / float(np.sum(g.astype(np.float64)))
    g = (g.astype(np.float64) * s).astype(_F32)
    xg = (xs.astype(_F32) * g).astype(_F32)
    xxg = ((xs * xs).astype(_F32) * g).astype(_F32)
    gg = np.zeros((6, 6))
    for y in range(-n, n + 1):
        for x in range(-n, n + 1):
            p = _F32(g[y + n] * g[x + n])
            xx = _F32(x)
            gg[0, 0] += p
            gg[1, 1] += _F32(_F32(p * xx) * xx)
            gg[3, 3] += _F32(_F32(_F32(_F32(p * xx) * xx) * xx) * xx)
            gg[5, 5] += _F32(_F32(_F32(_F32(p * xx) * xx) * _F32(y)) * _F32(y))
    gg[2, 2] = gg[0, 3] = gg[0, 4] = gg[3, 0] = gg[4, 0] = gg[1, 1]
    gg[4, 4] = gg[3, 3]
    gg[3, 4] = gg[4, 3] = gg[5, 5]
    inv = np.linalg.inv(gg)
    return g, xg, xxg, (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5])


def poly_exp(src: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """``FarnebackPolyExp`` of a float32 [H, W] plane -> float32 [H, W, 5]:
    the y, x, yy, xx, xy coefficients of the local quadratic fit, in
    OpenCV's channel order."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_constants(n, sigma)
    h, w = src.shape
    dev = src.device
    rows = src.index_select(0, _index(n, h, n, "replicate", dev))

    def at(k):
        return rows[n + k:n + k + h]

    r0 = at(0) * float(g[n])
    r1 = torch.zeros_like(r0)
    r2 = torch.zeros_like(r0)
    for k in range(1, n + 1):
        lo, hi = at(-k), at(k)
        p = lo + hi
        r0 = r0 + float(g[n + k]) * p
        r1 = r1 + float(xg[n + k]) * (hi - lo)
        r2 = r2 + float(xxg[n + k]) * p
    cols = _index(n, w, n, "replicate", dev)
    r0, r1, r2 = (r.index_select(1, cols) for r in (r0, r1, r2))

    def pair(r, k):
        return r[:, n - k:n - k + w], r[:, n + k:n + k + w]

    b1 = (r0[:, n:n + w] * float(g[n])).double()
    b3 = (r1[:, n:n + w] * float(g[n])).double()
    b5 = (r2[:, n:n + w] * float(g[n])).double()
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        (l0, h0), (l1, h1), (l2, h2) = pair(r0, k), pair(r1, k), pair(r2, k)
        tg = (h0 + l0).double()
        b1 = b1 + tg * float(g[n + k])
        b4 = b4 + tg * float(xxg[n + k])
        b2 = b2 + ((h0 - l0) * float(xg[n + k])).double()
        b3 = b3 + ((h1 + l1) * float(g[n + k])).double()
        b6 = b6 + ((h1 - l1) * float(xg[n + k])).double()
        b5 = b5 + ((h2 + l2) * float(g[n + k])).double()
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b5 * ig33,
                        b1 * ig03 + b4 * ig33, b6 * ig55], -1).float()


def _border_factors(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """The damping of the first and of the last five rows (or columns):
    float32 factors, 1 elsewhere."""
    lo, hi = np.ones(n, _F32), np.ones(n, _F32)
    for i in range(min(len(_BORDER), n)):
        lo[i] = _F32(_BORDER[i])
        hi[n - 1 - i] = _F32(_BORDER[i])
    return lo, hi


def update_matrices(r0: torch.Tensor, r1: torch.Tensor,
                    flow: torch.Tensor) -> torch.Tensor:
    """``FarnebackUpdateMatrices`` over the whole frame: float32 [H, W, 5]
    (G11, G12, G22, h1, h2 in OpenCV's y-first order)."""
    h, w = flow.shape[:2]
    dev = flow.device
    dx, dy = flow[..., 0], flow[..., 1]
    fx = torch.arange(w, device=dev, dtype=torch.float32)[None] + dx
    fy = torch.arange(h, device=dev, dtype=torch.float32)[:, None] + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    fx, fy = fx - x1, fy - y1
    x1, y1 = x1.long(), y1.long()
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    base = (y1.clamp(0, h - 2) * w + x1.clamp(0, w - 2)).reshape(-1)
    flat = r1.reshape(-1, 5)

    def tap(off):
        return flat.index_select(0, base + off).reshape(h, w, 5)

    ofx, ofy = (1.0 - fx)[..., None], (1.0 - fy)[..., None]
    fx, fy = fx[..., None], fy[..., None]
    a00, a01, a10, a11 = ofx * ofy, fx * ofy, ofx * fy, fx * fy
    p = a00 * tap(0) + a01 * tap(1) + a10 * tap(w) + a11 * tap(w + 1)
    r2 = torch.where(inside, p[..., 0], 0.0)
    r3 = torch.where(inside, p[..., 1], 0.0)
    r4 = torch.where(inside, (r0[..., 2] + p[..., 2]) * 0.5,
                     r0[..., 2])
    r5 = torch.where(inside, (r0[..., 3] + p[..., 3]) * 0.5,
                     r0[..., 3])
    r6 = torch.where(inside, (r0[..., 4] + p[..., 4]) * 0.25,
                     r0[..., 4] * 0.5)
    r2 = (r0[..., 0] - r2) * 0.5
    r3 = (r0[..., 1] - r3) * 0.5
    r2 = r2 + (r4 * dy + r6 * dx)
    r3 = r3 + (r6 * dy + r5 * dx)
    # OpenCV's product, left to right: x's low and high factors, y's
    lo_x, hi_x = _border_factors(w)
    lo_y, hi_y = _border_factors(h)
    scale = torch.from_numpy((lo_x * hi_x)[None] * lo_y[:, None]
                             * hi_y[:, None]).to(dev)
    r2, r3, r4, r5, r6 = (r * scale for r in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], -1)


def _box_sum(m: torch.Tensor, k: int) -> torch.Tensor:
    """float64 sums of [H, W, C] ``m`` over k x k windows, borders
    replicated."""
    a = k // 2
    h, w = m.shape[:2]
    dev = m.device
    p = m.double()
    p = p.index_select(0, _index(a + 1, h, a, "replicate", dev))
    c = torch.cumsum(p, 0)
    p = c[k:] - c[:-k]
    p = p.index_select(1, _index(a + 1, w, a, "replicate", dev))
    c = torch.cumsum(p, 1)
    return c[:, k:] - c[:, :-k]


def update_flow_blur(m: torch.Tensor, block: int) -> torch.Tensor:
    """``FarnebackUpdateFlow_Blur``'s flow: each pixel's box-averaged
    G d = h solved with OpenCV's 1e-3 regularizer -> float32 [H, W, 2]."""
    s = _box_sum(m, block) * (1.0 / (block * block))
    g11, g12, g22, h1, h2 = s.unbind(-1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet,
                        (g22 * h1 - g12 * h2) * idet], -1).float()


def farneback(prev: torch.Tensor, nxt: torch.Tensor,
              params: Sequence[float] = FARNEBACK_PARAMS) -> torch.Tensor:
    """``cv2.calcOpticalFlowFarneback(prev, nxt, None, *params)`` of two
    uint8 gray [H, W] frames on one device -> float32 [H, W, 2] (x, y)
    there. Only flags 0 (the box window, no initial flow)."""
    pyr_scale, levels, winsize, iterations, poly_n, poly_sigma, flags = params
    if flags:
        raise ValueError("only Farneback's flags 0 (box window) is ported")
    if not 0 < pyr_scale < 1:
        raise ValueError(f"pyr_scale {pyr_scale} must be in (0, 1)")
    h, w = prev.shape
    scale, k = 1.0, 0
    for k in range(int(levels) + 1):
        if k == int(levels):
            break
        scale *= pyr_scale
        if w * scale < MIN_PYRAMID_SIDE or h * scale < MIN_PYRAMID_SIDE:
            break
    levels = k
    images = [prev.float(), nxt.float()]
    flow = None
    for k in range(levels, -1, -1):
        scale = 1.0
        for _ in range(k):
            scale *= pyr_scale
        sigma = (1.0 / scale - 1) * 0.5
        ksize = max(int(round(sigma * 5)) | 1, 3)
        lw, lh = int(round(w * scale)), int(round(h * scale))
        if flow is None:
            flow = torch.zeros((lh, lw, 2), dtype=torch.float32,
                               device=prev.device)
        else:
            flow = resize_linear_f32(flow, lh, lw) * float(1.0 / pyr_scale)
        r = [poly_exp(resize_linear_f32(gaussian_blur(img, ksize, sigma), lh,
                                        lw), int(poly_n), float(poly_sigma))
             for img in images]
        m = update_matrices(r[0], r[1], flow)
        for i in range(int(iterations)):
            flow = update_flow_blur(m, int(winsize))
            if i < iterations - 1:
                m = update_matrices(r[0], r[1], flow)
    return flow


def _frame(img, dev) -> torch.Tensor:
    """A uint8 gray plane on ``dev`` from an RGB [H, W, 3] or gray [H, W]
    image (tensor or array)."""
    x = img if torch.is_tensor(img) else torch.from_numpy(
        np.ascontiguousarray(img))
    x = x.to(dev)
    if x.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8, got {x.dtype}")
    return rgb_to_gray(x) if x.dim() == 3 else x


def dense_two_frame_flow(prev_img, next_img, prev_mask=None, next_mask=None,
                         params: Sequence[float] = FARNEBACK_PARAMS,
                         device=None) -> torch.Tensor:
    """Farneback flow next -> prev in pixels, float32 [H, W, 2]; zeroed
    outside the union of the two masks when both are given (lane
    foreground; a mask of [H, W, K] counts a pixel set in any channel).
    Frames are uint8 RGB [H, W, 3] (the port's decoders' order; the JAX
    function takes OpenCV's BGR) or gray [H, W]. Computed on ``device``;
    None: the frames' device when they are tensors, else the card."""
    from ..device import resolve_device

    if device is None and torch.is_tensor(prev_img):
        dev = prev_img.device
    else:
        dev = resolve_device(device)
    flow = farneback(_frame(prev_img, dev), _frame(next_img, dev), params)
    if prev_mask is not None and next_mask is not None:
        def fg(m):
            m = (m if torch.is_tensor(m) else torch.from_numpy(
                np.asarray(m))).to(dev)
            return (m > 0) if m.dim() == 2 else (m > 0).any(-1)

        flow = torch.where((fg(prev_mask) | fg(next_mask))[..., None], flow,
                           0.0)
    return flow


def quantize_flow(flow: torch.Tensor, bound: float = BOUND
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flow -> two uint8 planes (the reference's u/v JPEGs,
    ``calcFlow.py:141-150``): ``clip((flow + bound) / (2 bound) * 255, 0,
    255)`` in float32, left to right, truncated (true divisions, as numpy
    computes them)."""
    flow = flow if torch.is_tensor(flow) else torch.from_numpy(
        np.asarray(flow, np.float32))
    dev = flow.device
    two_b = torch.tensor(2 * bound, dtype=torch.float32, device=dev)
    q = ((flow.float() + float(_F32(bound))) / two_b * 255.0).clamp(0, 255)
    q = q.to(torch.uint8)
    return q[..., 0], q[..., 1]


def dequantize_flow(u, v, img_h: int, img_w: int,
                    bound: float = BOUND) -> torch.Tensor:
    """u/v planes -> normalized flow, float32 [H, W, 2] on their device
    (``dataV3.py:168-176``): ``flow * 2 * bound / 255 - bound`` in float32,
    left to right, then x divided by ``img_w`` and y by ``img_h``."""
    u = u if torch.is_tensor(u) else torch.from_numpy(np.asarray(u))
    v = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    dev = u.device
    c255 = torch.tensor(255.0, dtype=torch.float32, device=dev)
    flow = torch.stack([u, v.to(dev)], -1).float()
    flow = flow * 2 * float(_F32(bound)) / c255 - float(_F32(bound))
    size = torch.tensor([img_w, img_h], dtype=torch.float32, device=dev)
    return flow / size


def generate_flow_jpgs(img_dir: str, out_dir: str, frames: Sequence[str],
                       device=None) -> None:
    """Offline flow-JPEG generation for one video (``make_flow_from_VIL``,
    ``calcFlow.py:104-160``): the flow of frame t against frame t - 1
    (frame 0 against itself), quantized, written as
    ``<out_dir>/<name>u.jpg`` and ``...v.jpg``, gray JPEGs at quality 95.
    Frames are decoded, the flow computed and the JPEGs encoded on
    ``device`` (None: the card): libjpeg on the CPU, nvJPEG on the card."""
    from .native_loader import ClipDecoder, GrayJpegWriter

    os.makedirs(out_dir, exist_ok=True)
    decode = ClipDecoder(device)
    writer = GrayJpegWriter(decode.device)
    prev = None
    for name in frames:
        img = decode.u8([os.path.join(img_dir, name + ".jpg")])[0]
        flow = dense_two_frame_flow(prev if prev is not None else img, img)
        u, v = quantize_flow(flow)
        writer.write(os.path.join(out_dir, name + "u.jpg"), u, JPEG_QUALITY)
        writer.write(os.path.join(out_dir, name + "v.jpg"), v, JPEG_QUALITY)
        prev = img

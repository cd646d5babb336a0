"""JPEG clip decoding of the port's dataset readers.

Two decoders, one a device, and no other to fall back on (the port reads
no image through OpenCV or PIL):

* on the CPU, ``native/clip_loader.cpp`` (the system libjpeg): one C
  call a clip decodes, crops the top rows, resizes in cv2's bilinear
  geometry and normalizes, OpenMP-parallel over the frames
  (:func:`decode_clip`, the counterpart of
  ``phnet_tpu/data/native_loader.py::decode_clip``, bit-equal to it);
* on the card, nvJPEG (``native/nvjpeg_decode.cpp``; the card's machine
  has the CUDA toolkit and no libjpeg): :class:`NvJpegDecoder` decodes
  each frame's component planes into device memory, :func:`ycc_to_rgb`
  upsamples the chroma and converts to uint8 RGB with libjpeg's
  arithmetic, and :func:`resize_normalize` crops, resizes and normalizes,
  with the C++ loader's arithmetic, all in PyTorch on the card
  (:func:`decode_clip_card`). Only the IDCT is nvJPEG's own.

A gray JPEG (the VIL-100 flow planes) reads to its one plane
(:meth:`ClipDecoder.gray`: libjpeg's, or nvJPEG's Y plane on the card),
which is what ``cv2.imread(..., IMREAD_GRAYSCALE)`` reads; and
:class:`GrayJpegWriter` writes one, with libjpeg on the CPU
(``encode_gray_jpeg``, ``cv2.imwrite``'s settings) and nvJPEG's encoder
on the card (:class:`NvJpegEncoder`).

The libraries are built with ``g++`` at first use
(``phnet_torch.ops._build``); a failed build, or a frame that does not
decode, raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .transforms import IMAGENET_MEAN, IMAGENET_STD

_FP = ctypes.POINTER(ctypes.c_float)


def _clip_lib() -> ctypes.CDLL:
    from ..ops import _build

    lib = _build.load("clip_loader")
    lib.decode_clip_rgb.restype = ctypes.c_int
    lib.decode_clip_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _FP, _FP, _FP]
    lib.decode_clip_rgb_u8.restype = ctypes.c_int
    lib.decode_clip_rgb_u8.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.jpeg_planes.restype = ctypes.c_int
    lib.jpeg_planes.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.encode_gray_jpeg.restype = ctypes.c_int
    lib.encode_gray_jpeg.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
    return lib


def _paths(paths: Sequence[str]):
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def _stats(mean, std) -> Tuple[np.ndarray, np.ndarray]:
    mean = np.ascontiguousarray(
        IMAGENET_MEAN if mean is None else mean, np.float32)
    std = np.ascontiguousarray(
        IMAGENET_STD if std is None else std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError("mean and std take one value a channel")
    return mean, std


def decode_clip(paths: Sequence[str], cut_px: int, out_h: int, out_w: int,
                mean: Optional[np.ndarray] = None,
                std: Optional[np.ndarray] = None) -> np.ndarray:
    """libjpeg on the host: decode + crop ``cut_px`` top rows + resize +
    normalize RGB JPEGs -> [n, out_h, out_w, 3] float32."""
    lib = _clip_lib()
    mean, std = _stats(mean, std)
    out = np.empty((len(paths), out_h, out_w, 3), np.float32)
    rc = lib.decode_clip_rgb(_paths(paths), len(paths), int(cut_px),
                             int(out_h), int(out_w), mean.ctypes.data_as(_FP),
                             std.ctypes.data_as(_FP), out.ctypes.data_as(_FP))
    if rc:
        raise IOError(f"failed to decode frame {rc - 1}: {paths[rc - 1]}")
    return out


def decode_clip_u8(paths: Sequence[str]) -> np.ndarray:
    """libjpeg on the host: JPEGs of one size -> [n, h, w, 3] uint8 RGB,
    uncropped (the reference the card's nvJPEG decode is held against)."""
    h, w = jpeg_dims(paths[0])
    out = np.empty((len(paths), h, w, 3), np.uint8)
    rc = _clip_lib().decode_clip_rgb_u8(_paths(paths), len(paths), h, w,
                                        out.ctypes.data)
    if rc:
        raise IOError(f"failed to decode frame {rc - 1} (or its size is not "
                      f"{h}x{w}): {paths[rc - 1]}")
    return out


def jpeg_planes(path: str) -> List[np.ndarray]:
    """libjpeg on the host: the component planes of a JPEG after the IDCT,
    before upsampling and colour conversion (Y, or Y, Cb, Cr at their own
    sampling), uint8."""
    lib = _clip_lib()
    info = (ctypes.c_int * 9)()
    rc = lib.jpeg_planes(str(path).encode(), info, None)
    if rc:
        raise IOError(f"cannot read the planes of {path} (rc {rc})")
    dims = [(info[3 + 2 * c], info[4 + 2 * c]) for c in range(info[2])]
    buf = np.empty(sum(h * w for h, w in dims), np.uint8)
    rc = lib.jpeg_planes(str(path).encode(), info, buf.ctypes.data)
    if rc:
        raise IOError(f"failed to decode {path} (rc {rc})")
    planes, at = [], 0
    for h, w in dims:
        planes.append(buf[at:at + h * w].reshape(h, w))
        at += h * w
    return planes


def write_gray_jpeg(path: str, plane: np.ndarray, quality: int = 95) -> str:
    """libjpeg on the host: uint8 [h, w] ``plane`` to a baseline gray JPEG
    at ``quality`` (``cv2.imwrite``'s settings). Raises when it fails."""
    plane = np.ascontiguousarray(plane, np.uint8)
    if plane.ndim != 2:
        raise ValueError(f"a gray plane is [h, w], got {plane.shape}")
    rc = _clip_lib().encode_gray_jpeg(str(path).encode(), plane.ctypes.data,
                                      plane.shape[0], plane.shape[1],
                                      int(quality))
    if rc:
        raise IOError(f"failed to write {path} (rc {rc})")
    return path


def _fix(x: float) -> int:
    """libjpeg's FIX(x): x in 16-bit fixed point, rounded."""
    return int(x * 65536 + 0.5)


def _fancy_columns(s: torch.Tensor, bias_left: int, bias_right: int,
                   shift: int) -> torch.Tensor:
    """libjpeg's fancy horizontal upsampling by 2 of ``s`` [..., w]:
    output 2k = (3 s[k] + s[k-1] + bias_left) >> shift, output 2k+1 =
    (3 s[k] + s[k+1] + bias_right) >> shift, the edges replicated."""
    prev = torch.cat([s[..., :1], s[..., :-1]], -1)
    nxt = torch.cat([s[..., 1:], s[..., -1:]], -1)
    left = (3 * s + prev + bias_left) >> shift
    right = (3 * s + nxt + bias_right) >> shift
    return torch.stack([left, right], -1).flatten(-2)


def upsample_chroma(plane: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """A chroma plane to the image's h x w as libjpeg upsamples it by
    default ("fancy" triangle filters, ``jdsample.c``): as it is at full
    size, ``h2v1_fancy_upsample`` at half width (4:2:2) or
    ``h2v2_fancy_upsample`` at half width and height (4:2:0). int32."""
    ph, pw = plane.shape
    c = plane.to(torch.int32)
    if (ph, pw) == (h, w):
        return c
    if ph == h and pw == (w + 1) // 2:
        return _fancy_columns(c, 1, 2, 2)[:, :w]
    if (ph, pw) == ((h + 1) // 2, (w + 1) // 2):
        up = torch.cat([c[:1], c[:-1]], 0)
        down = torch.cat([c[1:], c[-1:]], 0)
        top = _fancy_columns(3 * c + up, 8, 7, 4)     # output rows 2j
        bottom = _fancy_columns(3 * c + down, 8, 7, 4)  # rows 2j + 1
        return torch.stack([top, bottom], 1).flatten(0, 1)[:h, :w]
    raise NotImplementedError(f"chroma sampling {ph}x{pw} of a {h}x{w} "
                              f"image: only 4:4:4, 4:2:2 and 4:2:0 are read")


def ycc_to_rgb(planes: Sequence[torch.Tensor], out: torch.Tensor = None
               ) -> torch.Tensor:
    """libjpeg's upsampling and YCbCr -> RGB conversion (``jdcolor.c``,
    16-bit fixed point tables, clamped) of a JPEG's uint8 planes (Y, or Y,
    Cb, Cr), in PyTorch on their device: uint8 [h, w, 3], into ``out``
    where given. Bit-equal to libjpeg's own RGB output from the same
    planes (``tests/test_torch_eval_data.py``)."""
    y = planes[0].to(torch.int32)
    h, w = y.shape
    if len(planes) == 1:
        rgb = y[..., None].expand(h, w, 3)
    else:
        cb = upsample_chroma(planes[1], h, w) - 128
        cr = upsample_chroma(planes[2], h, w) - 128
        half = 1 << 15
        r = y + ((_fix(1.40200) * cr + half) >> 16)
        g = y + ((-_fix(0.34414) * cb + half - _fix(0.71414) * cr) >> 16)
        b = y + ((_fix(1.77200) * cb + half) >> 16)
        rgb = torch.stack([r, g, b], -1).clamp_(0, 255)
    if out is None:
        return rgb.to(torch.uint8)
    out.copy_(rgb)
    return out


def _linear_coef(n_out: int, scale: float, src_max: int):
    """cv2.INTER_LINEAR's source indices and weight a destination index,
    as ``clip_loader.cpp::lin_coef`` computes them (double, clamped)."""
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.clip(s, 0.0, float(src_max))
    i0 = s.astype(np.int64)
    i1 = np.minimum(i0 + 1, src_max)
    return i0, i1, (s - i0).astype(np.float32)


def resize_normalize(frames: torch.Tensor, cut_px: int, out_h: int,
                     out_w: int, mean: Optional[np.ndarray] = None,
                     std: Optional[np.ndarray] = None,
                     batch: int = 16) -> torch.Tensor:
    """Plain PyTorch, on ``frames``' device: uint8 [n, h, w, 3] -> crop
    ``cut_px`` top rows, bilinear resize to (out_h, out_w) in cv2's
    geometry (src = (dst + 0.5) * scale - 0.5, edges clamped), then
    (x / 255 - mean) / std -> float32 [n, out_h, out_w, 3]. The arithmetic
    is ``clip_loader.cpp``'s, in float32 and in its order; that file is
    compiled with contraction into fused multiply-adds, so the two differ
    in the last bits (``tests/test_torch_eval_data.py`` states the
    bound). Runs ``batch`` frames at a time."""
    if (frames.dtype != torch.uint8 or frames.dim() != 4
            or frames.shape[3] != 3):
        raise ValueError("frames must be uint8 [n, h, w, 3]")
    n, h, w, _ = frames.shape
    src_h = h - cut_px
    if src_h <= 0:
        raise ValueError(f"cut of {cut_px} rows leaves nothing of {h}")
    dev = frames.device
    y0, y1, wy = _linear_coef(out_h, src_h / out_h, src_h - 1)
    x0, x1, wx = _linear_coef(out_w, w / out_w, w - 1)
    y0, y1, x0, x1 = (torch.from_numpy(i + (cut_px if k < 2 else 0)).to(dev)
                      for k, i in enumerate((y0, y1, x0, x1)))
    wy = torch.from_numpy(wy).to(dev)[:, None, None]
    wx = torch.from_numpy(wx).to(dev)[:, None]
    mean, std = _stats(mean, std)
    cmul = torch.from_numpy(np.float32(1.0 / 255.0) / std).to(dev)
    cadd = torch.from_numpy(-mean / std).to(dev)
    out = torch.empty((n, out_h, out_w, 3), dtype=torch.float32, device=dev)
    for s in range(0, n, batch):
        r0 = frames[s:s + batch, y0].float()  # [b, out_h, w, 3]
        r1 = frames[s:s + batch, y1].float()
        a0, b0 = r0[:, :, x0], r0[:, :, x1]
        a1, b1 = r1[:, :, x0], r1[:, :, x1]
        top = a0 + wx * (b0 - a0)
        bot = a1 + wx * (b1 - a1)
        out[s:s + batch] = (top + wy * (bot - top)) * cmul + cadd
    return out


class NvJpegDecoder:
    """An nvJPEG handle and decode state. :meth:`decode` decodes JPEG
    files to uint8 RGB on the card: nvJPEG's component planes, then
    :func:`ycc_to_rgb` (libjpeg's upsampling and colour conversion).
    Release it with :meth:`close` (or ``with``)."""

    def __init__(self):
        from ..ops import _build

        lib = _build.load("nvjpeg_decode")
        vp, sz, ip = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(
            ctypes.c_int)
        lib.nvj_create.restype = ctypes.c_int
        lib.nvj_create.argtypes = [ctypes.POINTER(vp)]
        lib.nvj_destroy.restype = None
        lib.nvj_destroy.argtypes = [vp]
        lib.nvj_image_info.restype = ctypes.c_int
        lib.nvj_image_info.argtypes = [vp, ctypes.c_char_p, sz, ip, ip, ip]
        lib.nvj_decode_planes.restype = ctypes.c_int
        lib.nvj_decode_planes.argtypes = [vp, ctypes.c_char_p, sz,
                                          ctypes.c_int,
                                          ctypes.POINTER(vp), ip, vp]
        self._lib = lib
        handle = vp()
        status = lib.nvj_create(ctypes.byref(handle))
        if status:
            raise RuntimeError(f"nvJPEG initialization failed (status "
                               f"{status})")
        self._handle = handle

    def close(self):
        if self._handle is not None:
            self._lib.nvj_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def _read(self, paths: Sequence[str]):
        """The files' bytes and each one's plane shapes [(h, w), ...]; the
        frames must share their shapes."""
        if self._handle is None:
            raise RuntimeError("decoder is closed")
        datas, shapes = [], None
        n = ctypes.c_int()
        hs, ws = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        for i, p in enumerate(paths):
            with open(p, "rb") as f:
                datas.append(f.read())
            status = self._lib.nvj_image_info(self._handle, datas[-1],
                                              len(datas[-1]), ctypes.byref(n),
                                              hs, ws)
            if status:
                raise IOError(f"nvJPEG cannot read frame {i}: {p} (status "
                              f"{status})")
            if n.value not in (1, 3):
                raise IOError(f"frame {i} has {n.value} components: {p}")
            got = [(hs[c], ws[c]) for c in range(n.value)]
            if shapes is None:
                shapes = got
            elif got != shapes:
                raise IOError(f"frame {i} has planes {got}, frame 0 "
                              f"{shapes}: {p}")
        return datas, shapes

    def decode_gray(self, paths: Sequence[str], device=None
                    ) -> torch.Tensor:
        """JPEG files of one size -> [n, h, w] uint8 on ``device``: each
        one's Y plane (a gray JPEG's one plane), on its current stream.
        Returns once the decode has finished."""
        return self.decode(paths, device, gray=True)

    def decode(self, paths: Sequence[str], device=None, gray: bool = False
               ) -> torch.Tensor:
        """JPEG files of one size -> [n, h, w, 3] uint8 RGB on ``device``
        (a CUDA device; the current one by default), on its current
        stream. Returns once the decode has finished."""
        device = torch.device("cuda" if device is None else device)
        if device.type != "cuda":
            raise ValueError("nvJPEG decodes on a CUDA device")
        datas, shapes = self._read(paths)
        with torch.cuda.device(device):
            shape = (len(datas), *shapes[0]) + (() if gray else (3,))
            out = torch.empty(shape, dtype=torch.uint8, device=device)
            stream = torch.cuda.current_stream(device)
            planes = [torch.empty(s, dtype=torch.uint8, device=device)
                      for s in shapes]
            ptrs = (ctypes.c_void_p * len(planes))(
                *[p.data_ptr() for p in planes])
            pitches = (ctypes.c_int * len(planes))(*[w for _, w in shapes])
            for i, data in enumerate(datas):
                status = self._lib.nvj_decode_planes(
                    self._handle, data, len(data), len(planes), ptrs, pitches,
                    stream.cuda_stream)
                if status:
                    raise IOError(f"nvJPEG failed to decode frame {i}: "
                                  f"{paths[i]} (status {status})")
                if gray:
                    out[i].copy_(planes[0])
                else:
                    ycc_to_rgb(planes, out=out[i])
            # the host buffers in ``datas`` must outlive the decode
            stream.synchronize()
        return out


class NvJpegEncoder:
    """nvJPEG's encoder of gray JPEGs at one quality on the card
    (``native/nvjpeg_decode.cpp``): :meth:`encode` turns a uint8 [h, w]
    plane in device memory into a baseline one-component JPEG's bytes.
    Release it with :meth:`close` (or ``with``)."""

    def __init__(self, quality: int = 95, device=None):
        from ..ops import _build

        lib = _build.load("nvjpeg_decode")
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        lib.nvj_encoder_create.restype = ctypes.c_int
        lib.nvj_encoder_create.argtypes = [ctypes.c_int, vp,
                                           ctypes.POINTER(vp)]
        lib.nvj_encoder_destroy.restype = None
        lib.nvj_encoder_destroy.argtypes = [vp]
        lib.nvj_encoder_encode.restype = ctypes.c_int
        lib.nvj_encoder_encode.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, vp,
                                           ctypes.POINTER(sz)]
        lib.nvj_encoder_fetch.restype = ctypes.c_int
        lib.nvj_encoder_fetch.argtypes = [vp, ctypes.c_char_p,
                                          ctypes.POINTER(sz)]
        self._lib = lib
        self.quality = int(quality)
        self.device = torch.device("cuda" if device is None else device)
        handle = vp()
        stream = torch.cuda.current_stream(self.device)
        status = lib.nvj_encoder_create(self.quality, stream.cuda_stream,
                                        ctypes.byref(handle))
        if status:
            raise RuntimeError(f"nvJPEG encoder initialization failed "
                               f"(status {status})")
        self._handle = handle

    def close(self):
        if self._handle is not None:
            self._lib.nvj_encoder_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def encode(self, plane: torch.Tensor) -> bytes:
        """The JPEG bytes of the uint8 [h, w] CUDA tensor ``plane``,
        encoded on its device's current stream."""
        if self._handle is None:
            raise RuntimeError("encoder is closed")
        if (plane.dtype != torch.uint8 or plane.dim() != 2
                or not plane.is_cuda):
            raise ValueError("nvJPEG encodes a uint8 [h, w] CUDA tensor")
        plane = plane.contiguous()
        h, w = plane.shape
        n = ctypes.c_size_t()
        with torch.cuda.device(plane.device):
            stream = torch.cuda.current_stream(plane.device)
            status = self._lib.nvj_encoder_encode(
                self._handle, plane.data_ptr(), w, w, h, stream.cuda_stream,
                ctypes.byref(n))
            if status:
                raise IOError(f"nvJPEG failed to encode a {h}x{w} plane "
                              f"(status {status})")
            stream.synchronize()
        buf = ctypes.create_string_buffer(n.value)
        status = self._lib.nvj_encoder_fetch(self._handle, buf,
                                             ctypes.byref(n))
        if status:
            raise IOError(f"nvJPEG failed to hand over the JPEG (status "
                          f"{status})")
        return buf.raw[:n.value]


class GrayJpegWriter:
    """Gray JPEG files from uint8 [h, w] planes on ``device`` (None: the
    card): :func:`write_gray_jpeg` (libjpeg) on the CPU, an
    :class:`NvJpegEncoder` (made at first use, one a quality) on the
    card. A failed encode raises."""

    def __init__(self, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self._encoders = {}

    def write(self, path: str, plane, quality: int = 95) -> str:
        if self.device.type == "cpu":
            plane = plane.cpu().numpy() if torch.is_tensor(plane) else plane
            return write_gray_jpeg(path, plane, quality)
        if quality not in self._encoders:
            self._encoders[quality] = NvJpegEncoder(quality, self.device)
        plane = torch.as_tensor(plane).to(self.device)
        data = self._encoders[quality].encode(plane)
        with open(path, "wb") as f:
            f.write(data)
        return path


def decode_clip_card(decoder: NvJpegDecoder, paths: Sequence[str],
                     cut_px: int, out_h: int, out_w: int,
                     mean: Optional[np.ndarray] = None,
                     std: Optional[np.ndarray] = None,
                     device=None) -> torch.Tensor:
    """nvJPEG on the card, then :func:`resize_normalize` there ->
    [n, out_h, out_w, 3] float32 on ``device``."""
    return resize_normalize(decoder.decode(paths, device), cut_px, out_h,
                            out_w, mean, std)


class ClipDecoder:
    """The readers' clip decoder on ``device`` (None: the card):
    :func:`decode_clip` on the CPU, :func:`decode_clip_card` (with an
    :class:`NvJpegDecoder` made at first use) on the card; a float32
    tensor on ``device`` either way. :meth:`u8` decodes to uint8 RGB for
    the training path's augmentation."""

    def __init__(self, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self._nvjpeg: Optional[NvJpegDecoder] = None

    def __call__(self, paths: Sequence[str], cut_px: int, out_h: int,
                 out_w: int) -> torch.Tensor:
        """``paths`` with ``cut_px`` top rows cropped, resized to (out_h,
        out_w) and normalized with the ImageNet statistics ->
        [n, out_h, out_w, 3] float32 on the decoder's device."""
        if self.device.type == "cpu":
            return torch.from_numpy(decode_clip(paths, cut_px, out_h, out_w))
        return decode_clip_card(self._card(), paths, cut_px, out_h, out_w,
                                device=self.device)

    def u8(self, paths: Sequence[str]) -> torch.Tensor:
        """``paths`` decoded whole, uncropped and unresized: [n, h, w, 3]
        uint8 RGB on the decoder's device (:func:`decode_clip_u8` on the
        CPU, :meth:`NvJpegDecoder.decode` on the card)."""
        if self.device.type == "cpu":
            return torch.from_numpy(decode_clip_u8(paths))
        return self._card().decode(paths, self.device)

    def gray(self, paths: Sequence[str]) -> torch.Tensor:
        """JPEG files of one size read to gray as ``cv2.imread(...,
        IMREAD_GRAYSCALE)`` reads them: each one's Y plane (a gray JPEG's
        one plane), [n, h, w] uint8 on the decoder's device (libjpeg's
        :func:`jpeg_planes` on the CPU, nvJPEG on the card)."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.stack([jpeg_planes(p)[0]
                                              for p in paths]))
        return self._card().decode_gray(paths, self.device)

    def _card(self) -> NvJpegDecoder:
        if self._nvjpeg is None:
            self._nvjpeg = NvJpegDecoder()
        return self._nvjpeg


def jpeg_dims(path: str) -> Tuple[int, int]:
    """(h, w) of a JPEG from its SOF header, without decoding any pixels
    (``phnet_tpu/data/openlane.py::_jpeg_dims``, which falls back to
    OpenCV on a file it cannot parse; this raises ``ValueError``)."""
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG")
        while True:
            byte = f.read(1)
            if not byte:
                raise ValueError(f"{path}: no SOF marker")
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":  # fill bytes
                marker = f.read(1)
            if not marker:
                raise ValueError(f"{path}: truncated JPEG")
            m = marker[0]
            if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
                seg = f.read(7)  # len(2) precision(1) h(2) w(2)
                if len(seg) < 7:
                    raise ValueError(f"{path}: truncated SOF")
                return (int.from_bytes(seg[3:5], "big"),
                        int.from_bytes(seg[5:7], "big"))
            if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
                continue  # no-length markers
            seg_len = int.from_bytes(f.read(2), "big")
            f.seek(seg_len - 2, os.SEEK_CUR)

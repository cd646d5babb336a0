"""The port's PNG codec, without OpenCV or PIL (the card's machine has
neither to count on).

Reading (:func:`read_mask`) stands in for the JAX package's
``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` on segmentation masks, with one
repair: a **palette** image reads to its palette **indices**, the lane ids,
where OpenCV reads each palette colour's luma (index 1 of the reference's
palette, (128, 0, 0), reads 38 there). The JAX package's own ``write_mask``
writes palette PNGs, so its writer and reader do not round-trip; the
reference one-hots the mask by index right after reading it
(``dataV3.py:156``), which only the indices make sense of. What each colour
type reads to:

* gray, 8-bit: its bytes; 1, 2 or 4 bits: scaled to 0..255 as libpng
  expands them (what OpenCV reads);
* palette, 1, 2, 4 or 8 bits: the indices;
* RGB and RGBA, 8-bit: OpenCV's gray, libpng's ``png_set_rgb_to_gray``
  with OpenCV's coefficients (0.299, 0.587) in libpng's fixed point:
  ``(9797 R + 19234 G + 3737 B) >> 15``, truncated (found against
  ``cv2.imread`` on every sampled colour, ``tests/test_torch_png.py``);
  the alpha channel is dropped;
* gray with alpha, 8-bit: the gray channel.

Interlaced and 16-bit files raise ``ValueError`` naming the file, as does
anything else the codec cannot read (a bad signature, chunk CRC or filter
type, a truncated stream). Nothing falls back to another reader.

The IDAT stream is inflated with Python's ``zlib``; the scanline filters
(None, Sub, Up, Average, Paeth), sequential along a row, are undone by a
dependency-free C++ function (``native/png_unfilter.cpp``, built with
``g++`` at first use by ``phnet_torch.ops._build``); :func:`unfilter_plain`
is its numpy plain version.

Writing: :func:`write_indexed` (an 8-bit palette PNG with a ``PLTE``
chunk, for ``utils/masks.py::write_mask``) and :func:`write_rgb` (for its
overlay mode); every row is written with filter None.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# libpng's fixed-point rgb_to_gray coefficients for OpenCV's (0.299, 0.587)
RGB_TO_GRAY = (9797, 19234, 3737)


def _lib() -> ctypes.CDLL:
    from ..ops import _build

    lib = _build.load("png_unfilter")
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    return lib


def unfilter(filtered: bytes, height: int, rowbytes: int, bpp: int,
             name: str = "<png>") -> np.ndarray:
    """The unfiltered rows [height, rowbytes] uint8 of ``filtered`` (a
    filter-type byte before each row), through the C++ function."""
    if len(filtered) < height * (rowbytes + 1):
        raise ValueError(f"{name}: image data truncated")
    src = np.frombuffer(filtered, np.uint8)
    out = np.empty((height, rowbytes), np.uint8)
    rc = _lib().png_unfilter(src.ctypes.data, height, rowbytes, bpp,
                             out.ctypes.data)
    if rc:
        raise ValueError(f"{name}: row {rc - 1} has an unknown filter type")
    return out


def unfilter_plain(filtered: bytes, height: int, rowbytes: int, bpp: int,
                   name: str = "<png>") -> np.ndarray:
    """:func:`unfilter` in numpy: Up row-wise, Sub as a running sum
    modulo 256 of each of the ``bpp`` interleaved byte lanes, Average and
    Paeth a byte at a time."""
    if len(filtered) < height * (rowbytes + 1):
        raise ValueError(f"{name}: image data truncated")
    rows = np.frombuffer(filtered, np.uint8)[:height * (rowbytes + 1)]
    rows = rows.reshape(height, rowbytes + 1)
    out = np.zeros((height, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.int64)
    for y in range(height):
        kind, raw = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            row = raw
        elif kind == 1:
            row = raw.copy()
            for lane in range(min(bpp, rowbytes)):
                row[lane::bpp] = np.cumsum(raw[lane::bpp]) & 255
        elif kind == 2:
            row = (raw + prior) & 255
        elif kind in (3, 4):
            row = np.zeros(rowbytes, np.int64)
            for x in range(rowbytes):
                a = row[x - bpp] if x >= bpp else 0
                b = prior[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                row[x] = (raw[x] + pred) & 255
        else:
            raise ValueError(f"{name}: row {y} has an unknown filter type")
        out[y] = row
        prior = row
    return out


def _chunks(data: bytes, name: str):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    at = 8
    while at + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[at:at + 8])
        body = data[at + 8:at + 8 + length]
        if len(body) != length or at + 12 + length > len(data):
            raise ValueError(f"{name}: chunk {kind!r} truncated")
        (crc,) = struct.unpack(">I", data[at + 8 + length:at + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        at += 12 + length
    raise ValueError(f"{name}: no IEND chunk")


def decode(data: bytes, name: str = "<png>", plain: bool = False
           ) -> Tuple[np.ndarray, dict]:
    """A PNG's samples and header: (uint8 [H, W] or [H, W, C], ``{"color":
    colour type, "depth": bit depth, "palette": [n, 3] uint8 or None}``).
    Samples are as stored: palette indices, gray values at their own bit
    depth (not yet scaled), RGB(A) or gray and alpha. ``plain``: undo the
    filters with :func:`unfilter_plain`."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = header
    if color not in _CHANNELS or comp != 0 or filt != 0:
        raise ValueError(f"{name}: colour type {color}, compression {comp}, "
                         f"filter method {filt} are not PNG's")
    if interlace:
        raise ValueError(f"{name}: interlaced PNGs are not read")
    if depth == 16:
        raise ValueError(f"{name}: 16-bit PNGs are not read")
    allowed = (1, 2, 4, 8) if color in (0, 3) else (8,)
    if depth not in allowed:
        raise ValueError(f"{name}: bit depth {depth} of colour type {color}")
    if color == 3 and palette is None:
        raise ValueError(f"{name}: a palette image without PLTE")
    if w == 0 or h == 0:
        raise ValueError(f"{name}: empty image")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{name}: image data does not inflate ({exc})")
    ch = _CHANNELS[color]
    rowbytes = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = (unfilter_plain if plain else unfilter)(raw, h, rowbytes, bpp, name)
    if depth < 8:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = px.reshape(h, rowbytes * per)[:, :w]
    else:
        samples = rows.reshape(h, w, ch) if ch > 1 else rows
    return np.ascontiguousarray(samples), {"color": color, "depth": depth,
                                           "palette": palette}


def to_gray(samples: np.ndarray, info: dict) -> np.ndarray:
    """uint8 [H, W] of :func:`decode`'s samples, by colour type as the
    module docstring lists."""
    color, depth = info["color"], info["depth"]
    if color == 3:
        return samples
    if color == 0:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    if color == 4:
        return np.ascontiguousarray(samples[..., 0])
    rgb = samples[..., :3].astype(np.uint32)
    r, g, b = RGB_TO_GRAY
    return ((r * rgb[..., 0] + g * rgb[..., 1] + b * rgb[..., 2]) >> 15
            ).astype(np.uint8)


def read_mask(path: str, plain: bool = False) -> np.ndarray:
    """A mask PNG as uint8 [H, W]: palette indices, or OpenCV's gray of
    any other colour type (the module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    return to_gray(*decode(data, str(path), plain))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode(samples: np.ndarray, color: int,
           palette: Optional[np.ndarray] = None, level: int = 6) -> bytes:
    """An 8-bit PNG of ``samples`` (uint8 [H, W] for colour types 0 and 3,
    [H, W, 3] for 2), every row filtered with None; ``palette`` [n, 3]
    uint8 for colour type 3 (n <= 256)."""
    samples = np.ascontiguousarray(samples, np.uint8)
    h, w = samples.shape[:2]
    rows = samples.reshape(h, -1)
    body = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    out = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                                  0, 0, 0))]
    if color == 3:
        pal = np.ascontiguousarray(palette, np.uint8).reshape(-1, 3)
        if not 1 <= len(pal) <= 256:
            raise ValueError(f"a palette of {len(pal)} colours")
        out.append(_chunk(b"PLTE", pal.tobytes()))
    out.append(_chunk(b"IDAT", zlib.compress(body.tobytes(), level)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def write_indexed(path: str, indices: np.ndarray,
                  palette: Sequence[Sequence[int]]) -> str:
    """An indexed PNG of uint8 ``indices`` [H, W] with ``palette`` (RGB
    triples) in its ``PLTE`` chunk, padded with black to 256 colours as
    the JAX package's ``putpalette`` pads it."""
    pal = np.zeros((256, 3), np.uint8)
    given = np.asarray(palette, np.uint8).reshape(-1, 3)[:256]
    pal[:len(given)] = given
    with open(path, "wb") as f:
        f.write(encode(indices, 3, pal))
    return path


def write_rgb(path: str, rgb: np.ndarray) -> str:
    """An RGB PNG of uint8 ``rgb`` [H, W, 3]."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3], got {rgb.shape}")
    with open(path, "wb") as f:
        f.write(encode(rgb, 2))
    return path

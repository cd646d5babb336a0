"""The port's PNG codec (``phnet_torch/data/png.py``) and ``write_mask``
(``phnet_torch/utils/masks.py``) against OpenCV, PIL and the JAX
package.

* gray PNGs written by ``cv2.imwrite``: equal to ``cv2.imread(...,
  IMREAD_GRAYSCALE)``; gray at 1, 2 and 4 bits and gray with alpha too;
* palette PNGs at bit depths 1, 2, 4 and 8 (PIL with ``bits=``, and the
  JAX package's ``write_mask``): the indices, equal to PIL's;
* RGB and RGBA: equal to OpenCV's gray (``(9797 R + 19234 G + 3737 B) >>
  15``, libpng's fixed point of OpenCV's coefficients);
* every scanline filter (None, Sub, Up, Average, Paeth) at every pixel
  size, on random rows: the C++ unfilter and its numpy plain version
  both give back the samples;
* the port's ``write_mask`` read by PIL: equal indices and palette; its
  overlay mode equal to the JAX package's pixels;
* the fault the port repairs: the JAX reader's ``cv2.imread(...,
  IMREAD_GRAYSCALE)`` reads indices 1 / 2 / 3 of a palette mask as 38 / 75
  / 113 (the palette colours' luma); the port reads 1 / 2 / 3; on a gray
  PNG the two are bit-equal;
* what the codec cannot read (interlaced, 16-bit, a bad CRC or filter
  type, a truncated stream, not a PNG) raises ``ValueError``.

All comparisons are exact.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from phnet_torch.data import png
from phnet_torch.utils.masks import DEFAULT_PALETTE, write_mask
from phnet_tpu.utils.masks import write_mask as jax_write_mask


def _read_both(path):
    """The codec's read through the C++ unfilter and through the plain
    version, which must agree."""
    a = png.read_mask(str(path))
    b = png.read_mask(str(path), plain=True)
    np.testing.assert_array_equal(a, b)
    return a


@pytest.mark.parametrize("shape,level", [((37, 53), 1), ((120, 96), 9),
                                         ((1, 7), 3), ((64, 1), 6)])
def test_gray_png_equals_cv2(tmp_path, shape, level):
    rng = np.random.default_rng(sum(shape) + level)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[: shape[0] // 2] //= 37  # runs that the encoder filters otherwise
    p = tmp_path / "g.png"
    cv2.imwrite(str(p), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(_read_both(p), cv2.imread(
        str(p), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_low_bit_gray_equals_cv2(tmp_path, bits):
    """Gray at 1, 2 and 4 bits reads scaled to 0..255, as libpng expands
    it for OpenCV."""
    rng = np.random.default_rng(bits)
    levels = rng.integers(0, 1 << bits, (29, 40)).astype(np.uint8)
    per = 8 // bits
    shifts = np.arange(8 - bits, -1, -bits)
    packed = (levels.reshape(29, -1, per) << shifts).sum(-1).astype(np.uint8)
    p = tmp_path / "g.png"
    p.write_bytes(_png(packed, 0, bits, [k % 5 for k in range(29)]))
    want = cv2.imread(str(p), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(want, levels * np.uint8(
        255 // ((1 << bits) - 1)))
    np.testing.assert_array_equal(_read_both(p), want)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_palette_reads_indices_as_pil(tmp_path, bits):
    rng = np.random.default_rng(10 + bits)
    idx = rng.integers(0, 1 << bits, (45, 67)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(rng.integers(0, 256, 768).tolist())
    p = tmp_path / "p.png"
    im.save(p, bits=bits)
    assert png.decode(p.read_bytes())[1]["depth"] == bits
    np.testing.assert_array_equal(_read_both(p), np.array(Image.open(p)))
    np.testing.assert_array_equal(_read_both(p), idx)


def test_jax_write_mask_reads_indices(tmp_path):
    rng = np.random.default_rng(0)
    mask = rng.integers(0, 10, (72, 128)).astype(np.uint8)
    p = jax_write_mask(mask, str(tmp_path / "m.png"))
    np.testing.assert_array_equal(_read_both(p), np.array(Image.open(p)))
    np.testing.assert_array_equal(_read_both(p), mask)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "LA"])
def test_colour_reads_as_cv2_gray(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    ch = {"RGB": 3, "RGBA": 4, "LA": 2}[mode]
    img = rng.integers(0, 256, (83, 131, ch)).astype(np.uint8)
    img[:20, :, :3 if ch > 2 else 1] = img[:20, :, :1]  # gray pixels too
    p = tmp_path / "c.png"
    Image.fromarray(img, mode).save(p)
    np.testing.assert_array_equal(_read_both(p), cv2.imread(
        str(p), cv2.IMREAD_GRAYSCALE))


def test_rgb_gray_on_every_colour_level(tmp_path):
    """Each of R, G and B swept over 0..255 with the others random: the
    codec's gray equals OpenCV's on all of them (palette (0, 0, 128), the
    JAX palette's index 4, reads 14 there, not round(14.6) = 15)."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (3, 256, 3)).astype(np.uint8)
    for c in range(3):
        img[c, :, c] = np.arange(256)
    p = tmp_path / "rgb.png"
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(_read_both(p), cv2.imread(
        str(p), cv2.IMREAD_GRAYSCALE))
    one = tmp_path / "one.png"
    Image.fromarray(np.array([[[0, 0, 128]]], np.uint8)).save(one)
    assert _read_both(one)[0, 0] == 14 == cv2.imread(str(one), 0)[0, 0]


def _filter_row(row, prior, kind, bpp):
    """PNG's encoder-side filter ``kind`` of one row (int arrays)."""
    n = len(row)
    a = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:n]
    c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:n]
    b = prior
    if kind == 0:
        pred = np.zeros(n, np.int64)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (row - pred) & 255


def _png(samples, color, depth, filters, palette=None):
    """A PNG of ``samples`` (rows of packed bytes) with ``filters`` a row."""
    h = len(samples)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = max(1, ch * depth // 8)
    raw, prior = b"", np.zeros(samples.shape[1], np.int64)
    for row, kind in zip(samples.astype(np.int64), filters):
        raw += bytes([kind]) + _filter_row(row, prior, kind, bpp).astype(
            np.uint8).tobytes()
        prior = row
    width = samples.shape[1] * 8 // (ch * depth)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, h, depth, color, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("color,depth", [(0, 8), (2, 8), (3, 8), (3, 2),
                                         (4, 8), (6, 8), (0, 1)])
def test_every_filter_type(color, depth):
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rng = np.random.default_rng(color * 10 + depth)
    width = 24
    rowbytes = (width * ch * depth + 7) // 8
    rows = rng.integers(0, 256, (25, rowbytes)).astype(np.uint8)
    rows[5:10] = rows[4]  # repeated rows: Up predicts exactly
    filters = [k % 5 for k in range(25)]
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8) if color == 3 \
        else None
    data = _png(rows, color, depth, filters, pal)
    got, info = png.decode(data)
    plain, _ = png.decode(data, plain=True)
    np.testing.assert_array_equal(got, plain)
    if depth == 8:
        want = rows.reshape(25, width, ch) if ch > 1 else rows
    else:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        want = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            25, -1)[:, :width]
    np.testing.assert_array_equal(got, want)
    if color == 3:
        np.testing.assert_array_equal(info["palette"], pal)


def test_unfilter_native_equals_plain_on_random_streams():
    rng = np.random.default_rng(5)
    for bpp, rowbytes in ((1, 17), (2, 30), (3, 33), (4, 64), (6, 18)):
        data = rng.integers(0, 256, (40, rowbytes + 1)).astype(np.uint8)
        data[:, 0] = rng.integers(0, 5, 40)
        raw = data.tobytes()
        np.testing.assert_array_equal(png.unfilter(raw, 40, rowbytes, bpp),
                                      png.unfilter_plain(raw, 40, rowbytes,
                                                         bpp))


def test_port_write_mask_read_by_pil(tmp_path):
    rng = np.random.default_rng(1)
    mask = rng.integers(0, 10, (60, 90)).astype(np.uint8)
    p = write_mask(mask, str(tmp_path / "sub" / "m.png"))
    im = Image.open(p)
    assert im.mode == "P"
    np.testing.assert_array_equal(np.array(im), mask)
    pal = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
    np.testing.assert_array_equal(pal[:len(DEFAULT_PALETTE)],
                                  np.array(DEFAULT_PALETTE, np.uint8))
    jax_pal = np.array(Image.open(jax_write_mask(
        mask, str(tmp_path / "j.png"))).getpalette(), np.uint8)
    np.testing.assert_array_equal(pal.reshape(-1)[:len(jax_pal)], jax_pal)
    np.testing.assert_array_equal(_read_both(p), mask)


def test_overlay_mode_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    mask = rng.integers(0, 12, (40, 56)).astype(np.uint8)
    image = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
    ours = write_mask(mask, str(tmp_path / "o.png"), indexed=False,
                      image=image)
    theirs = jax_write_mask(mask, str(tmp_path / "j.png"), indexed=False,
                            image=image)
    np.testing.assert_array_equal(np.array(Image.open(ours)),
                                  np.array(Image.open(theirs)))


def test_palette_fault_of_the_jax_reader(tmp_path):
    """The JAX reader reads a mask as ``cv2.imread(path,
    cv2.IMREAD_GRAYSCALE)`` (``phnet_tpu/data/vil100.py``): on its own
    ``write_mask``'s palette PNGs that is each palette colour's luma."""
    mask = np.array([[0, 1, 2, 3, 4, 8, 9]], np.uint8).repeat(3, 0)
    p = jax_write_mask(mask, str(tmp_path / "pal.png"))
    jax_read = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(jax_read[0], [0, 38, 75, 113, 14, 19, 57])
    np.testing.assert_array_equal(_read_both(p), mask)
    g = tmp_path / "gray.png"
    cv2.imwrite(str(g), mask)
    np.testing.assert_array_equal(_read_both(g), cv2.imread(
        str(g), cv2.IMREAD_GRAYSCALE))


def _edit_header(data, **fields):
    w, h, depth, color, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          data[16:29])
    vals = dict(w=w, h=h, depth=depth, color=color, comp=comp, filt=filt,
                inter=inter)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", *vals.values())
    return (data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body))
            + data[33:])


def test_unreadable_files_raise(tmp_path):
    ok = png.encode(np.arange(48, dtype=np.uint8).reshape(6, 8), 0)
    bad = {
        "interlaced": _edit_header(ok, inter=1),
        "16-bit": _edit_header(ok, depth=16),
        "crc": ok[:40] + bytes([ok[40] ^ 1]) + ok[41:],
        "not a PNG": b"GIF89a" + ok[6:],
        "truncated": ok[:45],
    }
    raw = bytearray(zlib.decompress(ok[41:41 + struct.unpack(
        ">I", ok[33:37])[0]]))
    raw[0] = 7  # no such filter type
    body = zlib.compress(bytes(raw))
    bad["filter"] = (ok[:33] + struct.pack(">I", len(body)) + b"IDAT" + body
                     + struct.pack(">I", zlib.crc32(b"IDAT" + body))
                     + png._chunk(b"IEND", b""))
    for name, data in bad.items():
        p = tmp_path / f"{name}.png"
        p.write_bytes(data)
        with pytest.raises(ValueError, match=str(p).replace(".", r"\.")):
            png.read_mask(str(p))
    p16 = tmp_path / "cv16.png"
    cv2.imwrite(str(p16), np.full((4, 4), 1000, np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        png.read_mask(str(p16))

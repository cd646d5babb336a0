"""The port's flow planes (``phnet_torch/data/flow.py``) against the JAX
package's (``phnet_tpu/data/flow.py``, which calls OpenCV 5.0), on the
CPU.

* ``quantize_flow`` / ``dequantize_flow``: bit-equal to JAX's;
* the gray conversion: equal to ``cvtColor(BGR2GRAY)`` on all 2^24
  colours;
* ``dense_two_frame_flow`` (Farneback in PyTorch) against JAX's
  (``cv2.calcOpticalFlowFarneback``) on the fixture's VIL-100 frames:
  over the whole frame, median |diff| <= 0.01 px and 99.9th percentile
  <= 0.1 px; the ``quantize_flow`` planes equal on at least 99% of the
  pixels and one level apart at most (measured: 2e-8 px median, 2e-3 px
  at most, no plane value apart); the masked form; JAX's 3-pixel
  translation test rerun on the port;
* the JPEG planes: the port's libjpeg writer gives ``cv2.imwrite``'s bytes
  (so its decode is within cv2's own round trip of cv2's, at 0 levels),
  the gray decode equals ``cv2.imread(..., IMREAD_GRAYSCALE)``, and
  ``JPEG_ROUND_TRIP_LEVELS`` bounds cv2's own write-and-read error of
  the fixture's flow planes, which the readers' flow is held to;
* ``generate_flow_jpgs`` on the CPU: each file the JPEG of the port's own
  quantized planes, as cv2 writes it.
"""

import glob
import os

import cv2
import numpy as np
import pytest
import torch

from phnet_torch.data import flow as F
from phnet_torch.data.native_loader import jpeg_planes, write_gray_jpeg
from phnet_tpu.data import flow as J

from torch_eval_parity import FIXTURE

VIL = os.path.join(FIXTURE, "VIL100", "JPEGImages")


def _frames(vid):
    return sorted(glob.glob(os.path.join(VIL, vid, "*.jpg")))


def test_quantize_dequantize_bit_equal():
    rng = np.random.default_rng(0)
    flow = rng.uniform(-130, 130, (31, 47, 2)).astype(np.float32)
    flow[0, :5, 0] = [-100.0, 100.0, 0.0, -0.3921569, 99.99999]
    ju, jv = J.quantize_flow(flow)
    tu, tv = F.quantize_flow(torch.from_numpy(flow))
    np.testing.assert_array_equal(tu.numpy(), ju)
    np.testing.assert_array_equal(tv.numpy(), jv)
    for h, w in ((31, 47), (720, 1280), (16, 32)):
        want = J.dequantize_flow(ju, jv, h, w)
        got = F.dequantize_flow(tu, tv, h, w).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_gray_conversion_on_every_colour():
    a = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([((a >> k) & 255).astype(np.uint8) for k in (16, 8, 0)],
                   -1).reshape(4096, 4096, 3)
    want = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    got = F.rgb_to_gray(torch.from_numpy(np.ascontiguousarray(
        bgr[..., ::-1]))).numpy()
    np.testing.assert_array_equal(got, want)


def _pair(vid, i, j, crop=None):
    a, b = cv2.imread(_frames(vid)[i]), cv2.imread(_frames(vid)[j])
    if crop is not None:
        a, b = a[crop], b[crop]
    return np.ascontiguousarray(a), np.ascontiguousarray(b)


def _rgb(bgr):
    return torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1]))


@pytest.mark.parametrize("vid,i,j,crop", [
    ("0_Road001_Trim003_frames", 0, 1, None),
    ("4_Road027_Trim005_frames", 2, 3, (slice(200, 520), slice(300, 940))),
    ("1_Road010_Trim002_frames", 1, 1, (slice(0, 240), slice(0, 320)))])
def test_farneback_matches_cv2(vid, i, j, crop):
    """The gates over the whole frame: median |diff| <= 0.01 px,
    99.9th percentile <= 0.1 px; the quantized planes equal on >= 99% and
    within one level everywhere."""
    a, b = _pair(vid, i, j, crop)
    want = J.dense_two_frame_flow(a, b)
    got = F.dense_two_frame_flow(_rgb(a), _rgb(b), device="cpu").numpy()
    d = np.abs(got - want)
    assert np.median(d) <= 0.01 and np.quantile(d, 0.999) <= 0.1, (
        np.median(d), np.quantile(d, 0.999), d.max())
    for jq, tq in zip(J.quantize_flow(want), F.quantize_flow(
            torch.from_numpy(got))):
        lv = np.abs(jq.astype(int) - tq.numpy().astype(int))
        assert lv.max() <= 1 and (lv == 0).mean() >= 0.99


def test_farneback_masked_matches_jax():
    a, b = _pair("0_Road001_Trim003_frames", 2, 3,
                 (slice(300, 620), slice(400, 1040)))
    rng = np.random.default_rng(4)
    m0 = (rng.random((320, 640)) < 0.3).astype(np.uint8)
    m1 = np.zeros((320, 640, 3), np.uint8)
    m1[100:200, 50:400, 1] = 5
    want = J.dense_two_frame_flow(a, b, m0, m1)
    got = F.dense_two_frame_flow(_rgb(a), _rgb(b), torch.from_numpy(m0),
                                 m1, device="cpu").numpy()
    fg = (m0 > 0) | m1.any(-1)
    assert (got[~fg] == 0).all() and (want[~fg] == 0).all()
    d = np.abs(got - want)
    assert np.median(d) <= 0.01 and np.quantile(d, 0.999) <= 0.1


def test_farneback_translation():
    """JAX's ``test_farneback_flow_translation``, on the port."""
    rng = np.random.default_rng(1)
    base = (rng.uniform(0, 255, (64, 96)).astype(np.uint8))
    base = cv2.GaussianBlur(base, (7, 7), 2)
    shifted = np.roll(base, 3, axis=1)  # 3 px right shift
    flow = F.dense_two_frame_flow(base, shifted, device="cpu").numpy()
    inner = flow[16:-16, 16:-16, 0]
    assert abs(np.median(inner) - 3.0) < 1.0
    np.testing.assert_allclose(flow, J.dense_two_frame_flow(base, shifted),
                               atol=1e-4)


def test_farneback_runs_on_the_frames_device_by_default():
    img = torch.zeros((40, 48, 3), dtype=torch.uint8)
    assert F.dense_two_frame_flow(img, img).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            F.dense_two_frame_flow(img.numpy(), img.numpy())


def _planes(vid, i):
    a, b = _pair(vid, max(i - 1, 0), i)
    return J.quantize_flow(J.dense_two_frame_flow(a, b))


def test_jpeg_round_trip_bound(tmp_path):
    """cv2's own write (quality 95) and read of the fixture's flow planes
    (each frame against the one before, of every video) move them at most
    ``JPEG_ROUND_TRIP_LEVELS``; the port's libjpeg writer writes cv2's
    bytes and its gray decode reads cv2's pixels."""
    worst = 0
    for vid in sorted(os.listdir(VIL)):
        for i in range(len(_frames(vid))):
            for plane in _planes(vid, i):
                c, p = str(tmp_path / "c.jpg"), str(tmp_path / "p.jpg")
                cv2.imwrite(c, plane)
                write_gray_jpeg(p, plane, F.JPEG_QUALITY)
                assert open(c, "rb").read() == open(p, "rb").read()
                back = cv2.imread(c, cv2.IMREAD_GRAYSCALE)
                np.testing.assert_array_equal(jpeg_planes(p)[0], back)
                worst = max(worst, int(np.abs(back.astype(int)
                                              - plane).max()))
    assert 0 < worst <= F.JPEG_ROUND_TRIP_LEVELS


def test_generate_flow_jpgs_cpu(tmp_path):
    vid = "4_Road027_Trim005_frames"
    names = [os.path.basename(p)[:-4] for p in _frames(vid)][:3]
    F.generate_flow_jpgs(os.path.join(VIL, vid), str(tmp_path / "port"),
                         names, device="cpu")
    prev = None
    for n in names:
        img = _rgb(cv2.imread(os.path.join(VIL, vid, n + ".jpg")))
        u, v = F.quantize_flow(F.dense_two_frame_flow(
            prev if prev is not None else img, img))
        for s, plane in (("u", u), ("v", v)):
            ref = str(tmp_path / f"{n}{s}.jpg")
            cv2.imwrite(ref, plane.numpy())
            got = tmp_path / "port" / f"{n}{s}.jpg"
            assert got.read_bytes() == open(ref, "rb").read()
        prev = img

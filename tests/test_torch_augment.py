"""The port's training augmentation (``phnet_torch.data.transforms``,
PyTorch, no OpenCV) against the JAX package's ``TrainAugment`` (OpenCV)
and the OpenCV calls it makes, on the CPU.

Each op is run alone with its parameters swept (resize at several source
sizes, brightness, hue / saturation through the hue wrap, median blur k 3
and 5, motion blur k 3, 4 and 5 at several angles, the affine at its
extremes), then each op is forced in turn through the whole class with its
probability at 1 under 40 seeds, then the VIL and OL pipelines at their
own probabilities under 60 seeds each. Both classes get generators of the
same seed; their draws must stay in step (the next draw equal after each
call).

Gates: lanes within 1e-5 px of JAX's and the same lane ids dropped; the
motion-blur kernel within 1e-6 of OpenCV's (measured: equal); pixels
bit-equal (measured over every case here: max 0 levels, 0 of the pixels
differing; the issue's gate of at most 1 level on under 1% of the pixels
is the fallback, not needed). The port reproduces OpenCV 5.0's x86-64 SIMD
paths, which take every pixel at the widths the presets and the small
configurations use (768 and 192, multiples of 32); at other widths OpenCV
computes the last width mod 32 pixels of a row of the colour conversion
and the last width mod 16 of the affine in its scalar loop, which rounds
otherwise (measured at width 200: 1 level on 1.3% of the hue / saturation
output and 0.001% of the affine's). The output widths here are 192.
"""

import cv2
import numpy as np
import pytest
import torch

from phnet_torch.data import transforms as T
from phnet_tpu.data import transforms as J

H, W = 96, 192
MAX_LEVELS, MAX_SHARE = 0, 0.0  # measured; the gate is 1 level, 1%
OPS = {"hflip": "p_hflip", "channel_shuffle": "p_channel_shuffle",
       "brightness": "p_brightness", "hue_sat": "p_hue_sat",
       "blur": "p_blur", "affine": "p_affine"}


def image(seed, h=150, w=250):
    """A uint8 RGB image: smooth gradients, saturated and grey patches and
    noise (every hue sector, the achromatic axis, both clip ends)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([(x * 255 // w), (y * 255 // h), ((x + y) * 3) % 256],
                   -1).astype(np.int64)
    img += rng.integers(-40, 41, img.shape)
    img[: h // 5, : w // 5] = 255
    img[h // 5: 2 * h // 5, : w // 5] = 0
    img[-h // 6:, -w // 6:] = rng.integers(0, 256, 3)
    img[-h // 6:, : w // 6] = rng.integers(0, 256)  # grey
    return np.clip(img, 0, 255).astype(np.uint8)


def lanes_and_ids(h=150, w=250):
    """Three lanes, the middle one far outside the frame (clipped away
    with its id), one crossing the right border, and their ids."""
    good = np.array([[0.2 * w, 0.95 * h], [0.35 * w, 0.6 * h],
                     [0.45 * w, 0.3 * h], [0.5 * w, 0.1 * h]], np.float32)
    outside = np.array([[-3.0 * w, 0.9 * h], [-2.5 * w, 0.2 * h]],
                       np.float32)
    crossing = np.array([[0.9 * w, 0.95 * h], [1.05 * w, 0.5 * h],
                         [0.98 * w, 0.1 * h]], np.float32)
    return [good, outside, crossing], [4, 5, 6]


def assert_pixels(got, want, case):
    got = got.numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape and got.dtype == np.uint8, case
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= MAX_LEVELS and (d > 0).mean() <= MAX_SHARE, (
        case, int(d.max()), float((d > 0).mean()))


def assert_lanes(got, want, case):
    assert len(got) == len(want), case
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32, case
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=case)


@pytest.mark.parametrize("src", [(150, 250), (468, 1280), (800, 1920),
                                 (60, 100), (37, 53), (96, 192)])
def test_resize_equals_cv2(src):
    img = image(1, *src)
    for out in ((H, W), (23, 31)):
        assert_pixels(T.resize_u8(torch.from_numpy(img), *out),
                      cv2.resize(img, out[::-1],
                                 interpolation=cv2.INTER_LINEAR),
                      (src, out))
    lanes, _ = lanes_and_ids(*src)
    _, got = T.resize_with_lanes(torch.from_numpy(img), lanes, H, W)
    _, want = J.resize_with_lanes(img, lanes, H, W)
    assert_lanes(got, want, src)


@pytest.mark.parametrize("mul,add", [(0.85, -10.0), (1.15, 10.0),
                                     (1.0374, -3.21), (0.9012, 7.77)])
def test_brightness_equals_the_jax_formula(mul, add):
    img = image(2, H, W)
    want = np.clip(img.astype(np.float32) * mul + add, 0, 255).astype(
        np.uint8)
    assert_pixels(T.brightness(torch.from_numpy(img), mul, add), want, mul)


def test_hsv_conversions_equal_cv2_over_their_domains():
    """RGB -> HSV on all 2**24 colours, HSV -> RGB on every (h, s, v) with
    h < 256 (the JAX class feeds h < 180)."""
    v = np.arange(256, dtype=np.uint8)
    grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(
        4096, 4096, 3)
    got = T.rgb_to_hsv(torch.from_numpy(grid)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(grid,
                                                    cv2.COLOR_RGB2HSV))
    got = T.hsv_to_rgb(torch.from_numpy(grid).to(torch.int32)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(grid,
                                                    cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("value", [-10.0, -9.9, -5.3, -0.6, 0.0, 0.7, 4.25,
                                   8.5, 10.0])
def test_hue_saturation_equals_the_jax_op(value):
    """Shifts of either sign through the hue wrap (hues near 0 and 179 in
    the image) and saturation clipping at both ends."""
    img = image(3, H, W)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(round(value * 180.0 / 255.0))) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] + int(round(value)), 0, 255)
    want = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2RGB)
    assert_pixels(T.hue_saturation(torch.from_numpy(img), value), want,
                  value)


@pytest.mark.parametrize("k", [3, 5])
def test_median_blur_equals_cv2(k):
    img = image(4, H, W)
    assert_pixels(T.median_blur(torch.from_numpy(img), k),
                  cv2.medianBlur(img, k), k)


@pytest.mark.parametrize("k", [3, 4, 5])
@pytest.mark.parametrize("angle", [0.0, 17.3, 45.0, 90.0, 133.7, 180.0,
                                   241.9, 315.0, 359.99])
def test_motion_blur_equals_cv2(k, angle):
    """The kernel (rotated by warpAffine, normalized) within 1e-6 of
    OpenCV's, and the filter2D of the image with it; k = 4 anchors at
    (2, 2), off centre."""
    kernel = np.zeros((k, k), np.float32)
    kernel[k // 2, :] = 1.0 / k
    rot = cv2.getRotationMatrix2D((k / 2 - 0.5, k / 2 - 0.5), angle, 1.0)
    kernel = cv2.warpAffine(kernel, rot, (k, k))
    kernel /= max(kernel.sum(), 1e-6)
    got = T.motion_blur_kernel(k, angle)
    assert got.dtype == np.float32
    assert np.abs(got - kernel).max() <= 1e-6
    img = image(5, H, W)
    assert_pixels(T.filter2d(torch.from_numpy(img), got),
                  cv2.filter2D(img, -1, kernel), (k, angle))


@pytest.mark.parametrize("ang,sc,tx,ty", [
    (0.0, 1.0, 0.0, 0.0), (3.0, 1.05, 0.1, 0.1), (-3.0, 0.95, -0.1, -0.1),
    (5.0, 1.1, 0.1, -0.1), (-5.0, 0.9, -0.1, 0.1), (1.234, 0.987, 0.031,
                                                    -0.077)])
def test_affine_equals_cv2(ang, sc, tx, ty):
    """The VIL and OL ranges' extremes (rotation 3 / 5 degrees, scale
    0.95-1.05 / 0.9-1.1, translation 10%) and a point inside."""
    img = image(6, H, W)
    m = cv2.getRotationMatrix2D((W / 2, H / 2), ang, sc)
    m[:, 2] += (tx * W, ty * H)
    ours = T.rotation_matrix((W / 2, H / 2), ang, sc)
    ours[:, 2] += (tx * W, ty * H)
    np.testing.assert_array_equal(ours, m)
    assert_pixels(T.warp_affine(torch.from_numpy(img), m),
                  cv2.warpAffine(img, m, (W, H)), (ang, sc, tx, ty))


def run_both(kw, seed, ol=False):
    """The port's and the JAX class on the same image, lanes, ids and
    seed; their generators must still agree afterwards."""
    img = image(100 + seed)
    lanes, ids = lanes_and_ids()
    make = ((lambda cls: cls.ol_defaults(H, W, np.random.default_rng(seed)))
            if ol else (lambda cls: cls(H, W, rng=np.random.default_rng(
                seed), **kw)))
    port, ref = make(T.TrainAugment), make(J.TrainAugment)
    got = port(torch.from_numpy(img), lanes, ids)
    want = ref(img, lanes, ids)
    assert port.rng.random() == ref.rng.random()
    return got, want


@pytest.mark.parametrize("op", list(OPS))
def test_each_op_through_the_class(op):
    """``op`` forced (its probability 1, the others 0, every draw still
    made) under 40 seeds: the parameters sweep its range."""
    kw = {p: 0.0 for p in OPS.values()}
    kw[OPS[op]] = 1.0
    for seed in range(40):
        (img, lanes, ids), (wimg, wlanes, wids) = run_both(kw, seed)
        assert ids == wids, (op, seed)
        assert_lanes(lanes, wlanes, (op, seed))
        assert_pixels(img, wimg, (op, seed))


@pytest.mark.parametrize("ol", [False, True], ids=["vil", "ol"])
def test_whole_pipeline_equals_jax(ol):
    """The VIL pipeline (``optionsV3.py``'s probabilities) and the OL one
    (``ol_defaults``: no flip, blur and affine at 0.1) under 60 seeds;
    some drop the middle lane only, some the crossing one too."""
    dropped = set()
    for seed in range(60):
        (img, lanes, ids), (wimg, wlanes, wids) = run_both({}, seed, ol)
        assert ids == wids and 5 not in ids, seed
        dropped.add(tuple(ids))
        assert_lanes(lanes, wlanes, seed)
        assert_pixels(img, wimg, seed)
    assert len(dropped) >= 1


def test_ids_drop_with_their_lanes_and_planes_refuse():
    """A lane clipped out mid-list drops its own id, not the tail's
    (``tests/test_data.py``'s case on the port); without ids the pair
    comes back; a segmentation plane is appended to it (the planes were
    refused until they were ported; ``tests/test_torch_planes.py`` holds
    them to the JAX class)."""
    aug = T.TrainAugment(H, W, rng=np.random.default_rng(0), p_hflip=0,
                         p_channel_shuffle=0, p_brightness=0, p_hue_sat=0,
                         p_blur=0, p_affine=0)
    img = torch.zeros((H, W, 3), dtype=torch.uint8)
    good = np.array([[50.0, 90.0], [60.0, 40.0]], np.float32)
    outside = np.array([[-50.0, 90.0], [-60.0, 40.0]], np.float32)
    good2 = np.array([[150.0, 90.0], [140.0, 40.0]], np.float32)
    out, lanes, ids = aug(img, [good, outside, good2], ids=[7, 8, 9])
    assert ids == [7, 9] and len(lanes) == 2 and out.dtype == torch.uint8
    np.testing.assert_allclose(lanes[1][:, 0], [150.0, 140.0])
    assert len(aug(img, [good, outside, good2])) == 2
    got = aug(img, [good], seg=np.ones((H, W), np.uint8))
    assert len(got) == 3 and torch.equal(got[2], torch.ones(
        (H, W), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        aug(img.float(), [good])


def test_normalize_equals_the_numpy_normalize():
    img = image(7, H, W)
    np.testing.assert_array_equal(T.normalize(torch.from_numpy(img)).numpy(),
                                  J.Normalize()(img))

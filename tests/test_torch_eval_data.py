"""The port's dataset readers (``phnet_torch.data.vil100``,
``phnet_torch.data.openlane``) and clip decoders against the JAX
package's, on the committed fixture (``tests/fixtures/torch_eval``) at the
presets' frame size (384 x 768), on the CPU:

* ``read_sequences`` gives what ``yaml.safe_load`` gives for each entry's
  name and set, on the fixture's ``db_info.yaml`` and on other layouts
  YAML allows;
* labels, points, sizes, cuts / crops and frame names equal the JAX
  readers'; the frames are bit-equal to the JAX native loader's (both
  decode with the system libjpeg in the same C++ arithmetic);
* against the JAX readers' OpenCV path (``native_decode="never"``): less
  than one input level, 1 / 255 / 0.225 = 0.0174 in normalized units. The
  JAX loader's docstring says "~1e-2"; on this fixture the JAX native
  loader itself is 0.0134 from its OpenCV path (OpenCV's own libjpeg and
  its fixed-point resize), so 1e-2 holds for neither;
* the card's path after the decode (``resize_normalize``, plain PyTorch)
  on the same libjpeg uint8 frames is within 1e-6 of the C++ loader
  (measured 7.2e-7: the C++ is compiled with contraction into fused
  multiply-adds, PyTorch rounds each product);
* the card's colour path (``ycc_to_rgb``: libjpeg's fancy chroma
  upsampling and fixed-point YCbCr -> RGB in PyTorch), given libjpeg's own
  component planes, is bit-equal to libjpeg's RGB, at 4:2:0, 4:2:2, 4:4:4
  and grayscale, at odd sizes too;
* ``decoded_u8.npz``, the reference of the card's nvJPEG decode, is the
  current libjpeg decode of the fixture;
* without a decoder library the readers raise.
"""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch
import yaml

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.data import native_loader as nl
from phnet_torch.data.openlane import OpenLaneDataset
from phnet_torch.data.vil100 import VIL100Dataset, read_sequences
from phnet_torch.ops import _build
from phnet_tpu.data.openlane import OpenLaneDataset as JaxOL
from phnet_tpu.data.vil100 import VIL100Dataset as JaxVIL

from torch_eval_parity import FIXTURE

LEVEL = 1.0 / 255.0 / 0.225  # one input level in normalized units
RESIZE_ATOL = 1e-6


def readers(kind):
    """(port reader on the CPU, JAX native reader, JAX OpenCV reader)."""
    if kind == "vil":
        jc, tc, J, T = (jcfg.vil100_config(), tcfg.vil100_config(), JaxVIL,
                        VIL100Dataset)
    else:
        jc, tc, J, T = (jcfg.openlane_config(), tcfg.openlane_config(),
                        JaxOL, OpenLaneDataset)
    jdata = dataclasses.replace(jc.data, root=FIXTURE)
    return (T(FIXTURE, tc.model, device="cpu"),
            J(jdata, jc.model.lane, train=False, native_decode="always"),
            J(jdata, jc.model.lane, train=False, native_decode="never"))


@pytest.fixture(scope="module", params=["vil", "ol"])
def clips(request):
    port, jax_native, jax_cv2 = readers(request.param)
    assert len(port) == len(jax_native) == (2 if request.param == "vil"
                                            else 1)
    assert port.videos == jax_native.videos
    return request.param, [(port[i], jax_native[i], jax_cv2[i])
                           for i in range(len(port))]


def test_clip_fields_equal_jax(clips):
    kind, runs = clips
    for got, want, _ in runs:
        # ``image_points`` is the port's own: the ground truth in the
        # predictions' frame (``test_torch_eval_gt_frame.py``), one lane a
        # lane of ``points``
        assert set(got) == set(want) | {"image_points"}
        assert [len(p) for p in got["image_points"]] == [
            len(p) for p in got["points"]]
        for key in want:
            if key in ("frames", "labels", "points"):
                continue
            assert got[key] == want[key], key
        np.testing.assert_array_equal(got["labels"], want["labels"])
        assert got["labels"].dtype == want["labels"].dtype
        assert len(got["points"]) == len(want["points"])
        for gp, wp in zip(got["points"], want["points"]):
            assert len(gp) == len(wp)
            for g, w in zip(gp, wp):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        # the fixture's skipped lanes: VIL's one-point lane, OL's two-point
        # and empty lanes
        assert all(len(p) == (4 if kind == "vil" else 3)
                   for p in got["points"])


def test_frames_bit_equal_to_jax_native(clips):
    _, runs = clips
    for got, want, _ in runs:
        assert isinstance(got["frames"], torch.Tensor)
        assert got["frames"].dtype == torch.float32
        np.testing.assert_array_equal(got["frames"].numpy(), want["frames"])


def test_frames_within_one_level_of_jax_opencv(clips):
    _, runs = clips
    for got, _, cv in runs:
        diff = np.abs(got["frames"].numpy() - cv["frames"])
        assert diff.max() < LEVEL, diff.max()


def test_resize_normalize_matches_cpp_after_shared_decode(clips):
    """The card's crop + resize + normalize, run here on the libjpeg uint8
    decode, against the C++ loader's output."""
    kind, runs = clips
    for got, _, _ in runs:
        if kind == "vil":
            base = os.path.join(FIXTURE, "VIL100", "JPEGImages", got["name"])
            cut = got["cut"]
        else:
            base = os.path.join(FIXTURE, "OpenLane", "images", "validation",
                                got["name"])
            cut = got["crop"]
        u8 = nl.decode_clip_u8([os.path.join(base, n + ".jpg")
                                for n in got["frame_names"]])
        out = nl.resize_normalize(torch.from_numpy(u8), cut, 384, 768,
                                  batch=3)
        assert out.dtype == torch.float32 and out.shape == (4, 384, 768, 3)
        np.testing.assert_allclose(out.numpy(), got["frames"].numpy(), rtol=0,
                                   atol=RESIZE_ATOL)


def test_decoded_reference_is_current():
    ref = np.load(os.path.join(FIXTURE, "decoded_u8.npz"))
    s = int(ref["stride"])
    for key in ("vil", "ol"):
        paths = [os.path.join(FIXTURE, f) for f in ref[key + "_files"]]
        u8 = nl.decode_clip_u8(paths)
        np.testing.assert_array_equal(u8[:, ::s, ::s], ref[key])
        # libjpeg here and OpenCV's own decoder: the same image up to the
        # decoders' rounding
        cv = np.stack([cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
                       for p in paths])
        assert np.abs(cv.astype(int) - u8).max() <= 4


def test_ycc_to_rgb_equals_libjpeg_on_the_fixture():
    ref = np.load(os.path.join(FIXTURE, "decoded_u8.npz"))
    for f in (ref["vil_files"][0], ref["ol_files"][-1]):
        path = os.path.join(FIXTURE, f)
        planes = nl.jpeg_planes(path)
        assert [p.shape for p in planes[1:]] == [tuple(
            (d + 1) // 2 for d in planes[0].shape)] * 2  # 4:2:0
        rgb = nl.ycc_to_rgb([torch.from_numpy(p) for p in planes])
        np.testing.assert_array_equal(rgb.numpy(),
                                      nl.decode_clip_u8([path])[0])


@pytest.mark.parametrize("sampling,size", [
    ("420", (97, 131)), ("422", (64, 75)), ("444", (40, 33)),
    ("gray", (31, 50))])
def test_ycc_to_rgb_equals_libjpeg(sampling, size, tmp_path):
    """Seeded coloured images written by OpenCV at each chroma sampling
    (odd sizes: the last chroma sample covers one pixel)."""
    rng = np.random.default_rng(4)
    h, w = size
    img = np.clip(rng.normal(128, 60, (h // 4 + 1, w // 4 + 1, 3)), 0, 255)
    img = np.repeat(np.repeat(img, 4, 0), 4, 1)[:h, :w].astype(np.uint8)
    img[h // 3:h // 2, :, :] = (30, 200, 240)  # a hard coloured edge
    path = str(tmp_path / "x.jpg")
    if sampling == "gray":
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    else:
        factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
        cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
    planes = nl.jpeg_planes(path)
    assert len(planes) == (1 if sampling == "gray" else 3)
    rgb = nl.ycc_to_rgb([torch.from_numpy(p) for p in planes])
    np.testing.assert_array_equal(rgb.numpy(), nl.decode_clip_u8([path])[0])


def test_jpeg_dims_match_opencv():
    ref = np.load(os.path.join(FIXTURE, "decoded_u8.npz"))
    for f in list(ref["vil_files"][:1]) + list(ref["ol_files"][:1]):
        path = os.path.join(FIXTURE, f)
        assert nl.jpeg_dims(path) == cv2.imread(path).shape[:2]


def test_bad_files_raise(tmp_path):
    bad = tmp_path / "x.jpg"
    bad.write_bytes(b"not a jpeg at all")
    with pytest.raises(ValueError, match="not a JPEG"):
        nl.jpeg_dims(str(bad))
    with pytest.raises(IOError, match="failed to decode frame 0"):
        nl.decode_clip([str(bad)], 0, 8, 8)


YAML_VARIANTS = [
    # indented block list, comments, quoted values, a nested mapping
    "# VIL-100\nsets: [train, test]\nsequences:\n  - name: 'a_b'  # c\n"
    "    set: \"test\"\n    meta:\n      k: v\n  - set: train\n"
    "    name: x#y\nyears: [2021]\n",
    # flow list of flow mappings
    "sequences: [{name: v1, set: test}, {name: 'v 2', set: train},\n"
    "  {set: test, name: v3}]\n",
    # entries opened by a flow mapping, nested lists at the key indent
    "sequences:\n- {name: v1, set: test}\n- attributes:\n  - curve\n"
    "  name: v2\n  set: train\n",
]


@pytest.mark.parametrize("text", [None] + YAML_VARIANTS)
def test_read_sequences_equals_yaml(text, tmp_path):
    if text is None:
        path = os.path.join(FIXTURE, "VIL100", "data", "db_info.yaml")
    else:
        path = str(tmp_path / "db_info.yaml")
        with open(path, "w") as f:
            f.write(text)
    with open(path) as f:
        want = [{"name": s["name"], "set": s["set"]}
                for s in yaml.safe_load(f)["sequences"]]
    assert read_sequences(path) == want and want


def test_read_sequences_raises_without_a_list(tmp_path):
    path = tmp_path / "db_info.yaml"
    path.write_text("sets: [train]\n")
    with pytest.raises(ValueError, match="sequences"):
        read_sequences(str(path))
    path.write_text("sequences:\n- name: a\n")
    with pytest.raises(ValueError, match="lacks"):
        read_sequences(str(path))


def test_train_mode_and_default_device_raise():
    """Train mode reads the train split (VIL: the fixture's one train
    video, two clips an epoch; OL: the fixture has no ``training`` split,
    so the reader raises), and without a card the default device
    raises."""
    vil, ol = tcfg.vil100_config().model, tcfg.openlane_config().model
    train = VIL100Dataset(FIXTURE, vil, train=True, device="cpu")
    assert train.videos == ["1_Road010_Trim002_frames"] and len(train) == 2
    with pytest.raises(FileNotFoundError, match="training"):
        OpenLaneDataset(FIXTURE, ol, train=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            VIL100Dataset(FIXTURE, vil)
        with pytest.raises(RuntimeError, match="CUDA"):
            OpenLaneDataset(FIXTURE, ol)


def test_no_decoder_library_raises(tmp_path, monkeypatch):
    """Where the decoder does not build, reading a clip raises; nothing
    else decodes in its place."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_gxx", lambda: "false")
    _build.load.cache_clear()
    try:
        ds = VIL100Dataset(FIXTURE, tcfg.vil100_config().model,
                           device="cpu")
        with pytest.raises(RuntimeError, match="build failed"):
            ds[0]
    finally:
        _build.load.cache_clear()

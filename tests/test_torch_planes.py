"""The segmentation and flow planes' consumers in the port against the JAX
package, on the CPU.

* the mask utilities (``utils/masks.py``) and the J and F metric
  (``evaluation/video_metrics.py``: masks touching the image's edge, empty
  masks, one side empty): equal to JAX's;
* the plane ops of ``TrainAugment`` against OpenCV 5.0: the nearest and
  float linear resizes, the nearest and float linear ``warpAffine``,
  bit-equal; ``TrainAugment`` with planes against JAX's under many seeds:
  masks equal, flow within 1e-5 (measured: equal), and the image, lanes
  and ids equal with planes and without; the flip does not negate u;
* the VIL-100 reader with ``load_seg`` / ``load_flow``: the trees of JAX's
  ``test_vil_dataset_loads_seg_and_flow`` (train mode, affine) and
  ``test_vil_flow_missing_frame_stays_aligned`` (test mode, frames
  without flow JPEGs) through both readers with gray masks: masks
  bit-equal, flow within the JPEG round trip (both decode the same JPEG
  files; measured: equal); a tree of palette masks (the JAX package's own
  ``write_mask``) where the JAX reader reads lane ids 1 / 2 / 3 as 38 / 75
  / 113 and the port as 1 / 2 / 3; the loader carrying the planes in
  ``infos``;
* ``SegDecoder`` (integer and non-integer upsampling, and a downsampling)
  and ``WarpModel`` against flax with converted parameters, within 1e-5;
  ``Dropout2d`` zeroes whole channels.
"""

import dataclasses
import json
import os
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import phnet_torch.config as tcfg
import phnet_tpu.config as jcfg
from phnet_torch.convert import convert_module
from phnet_torch.data import transforms as T
from phnet_torch.data.flow import BOUND, JPEG_ROUND_TRIP_LEVELS
from phnet_torch.data.loader import ClipLoader
from phnet_torch.data.vil100 import VIL100Dataset
from phnet_torch.evaluation import video_metrics as VM
from phnet_torch.models.flow_warp import WarpModel, flow_warp
from phnet_torch.models.seg_decoder import SegDecoder
from phnet_torch.utils import masks as M
from phnet_tpu.data import vil100 as jax_vil100
from phnet_tpu.data.transforms import TrainAugment as JaxAugment
from phnet_tpu.evaluation import video_metrics as JVM
from phnet_tpu.models.flow_warp import WarpModel as JaxWarp
from phnet_tpu.models.flow_warp import flow_warp as jax_flow_warp
from phnet_tpu.models.seg_decoder import SegDecoder as JaxSeg
from phnet_tpu.utils import masks as JM
from phnet_tpu.utils.masks import write_mask as jax_write_mask


# --- masks and metrics ------------------------------------------------------

def test_mask_utils_equal_jax():
    rng = np.random.default_rng(0)
    mask = rng.integers(0, 5, (24, 40)).astype(np.uint8)
    oh = M.convert_mask_to_one_hot(torch.from_numpy(mask), 4)
    joh = JM.convert_mask_to_one_hot(mask, 4)
    np.testing.assert_array_equal(oh.numpy(), joh)
    np.testing.assert_array_equal(
        M.convert_one_hot_to_mask(oh.to(torch.uint8), 4).numpy(),
        JM.convert_one_hot_to_mask(joh.astype(np.uint8), 4))
    pred = rng.random((3, 24, 40)).astype(np.float32)
    tgt = (rng.random((3, 24, 40)) > 0.6).astype(np.float32)
    assert M.mask_iou(torch.from_numpy(pred), tgt) == JM.mask_iou(pred, tgt)
    scores = rng.random((50, 7))
    target = rng.integers(0, 7, 50)
    assert M.topk_accuracy(torch.from_numpy(scores), target, (1, 3, 5)) \
        == JM.topk_accuracy(scores, target, (1, 3, 5))


def _mask_cases():
    rng = np.random.default_rng(1)
    m = np.zeros((48, 64), bool)
    m[10:30, 12:40] = True
    edge = np.zeros((48, 64), bool)
    edge[:, :9] = True  # touches three edges
    edge[30:, 50:] = True  # a corner
    blob = rng.random((48, 64)) > 0.7
    empty = np.zeros((48, 64), bool)
    return [(m, m), (m, np.roll(m, 3, 0)), (edge, m), (edge, edge),
            (blob, m), (empty, empty), (empty, m), (m, empty),
            (np.ones((48, 64), bool), edge)]


@pytest.mark.parametrize("case", range(9))
def test_jaccard_and_f_boundary_equal_jax(case):
    seg, gt = _mask_cases()[case]
    ts, tg = torch.from_numpy(seg), torch.from_numpy(gt)
    assert VM.jaccard(ts, tg) == JVM.jaccard(seg, gt)
    assert VM.f_boundary(ts, tg) == JVM.f_boundary(seg, gt)
    assert VM.f_boundary(ts, tg, 2) == JVM.f_boundary(seg, gt, 2)
    np.testing.assert_array_equal(VM._mask_boundary(ts).numpy(),
                                  JVM._mask_boundary(seg))


@pytest.mark.parametrize("n", [0, 3, 4, 9])
def test_video_metric_statistics_equal_jax(n):
    cases = (_mask_cases() * 2)[:n]
    preds = [torch.from_numpy(p) for p, _ in cases]
    gts = [torch.from_numpy(g) for _, g in cases]
    assert VM.evaluate_video_masks(preds, gts) == JVM.evaluate_video_masks(
        [p for p, _ in cases], [g for _, g in cases])


# --- the plane ops against OpenCV --------------------------------------------

@pytest.mark.parametrize("src,dst", [((468, 1280), (384, 768)),
                                     ((200, 400), (96, 192)),
                                     ((50, 70), (96, 192)),
                                     ((192, 384), (96, 192))])
def test_plane_resizes_equal_cv2(src, dst):
    rng = np.random.default_rng(sum(src))
    seg = rng.integers(0, 10, src).astype(np.uint8)
    flow = rng.uniform(-0.1, 0.1, src + (2,)).astype(np.float32)
    np.testing.assert_array_equal(
        T.resize_nearest(torch.from_numpy(seg), *dst).numpy(),
        cv2.resize(seg, dst[::-1], interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(
        T.resize_linear_f32(torch.from_numpy(flow), *dst).numpy(),
        cv2.resize(flow, dst[::-1], interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("seed", range(6))
def test_plane_warps_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w = (96, 192) if seed % 2 else (384, 768)
    seg = rng.integers(0, 10, (h, w)).astype(np.uint8)
    flow = rng.uniform(-1, 1, (h, w, 2)).astype(np.float32)
    m = T.rotation_matrix((w / 2, h / 2), rng.uniform(-5, 5),
                          rng.uniform(0.9, 1.1))
    m[:, 2] += (rng.uniform(-0.1, 0.1) * w, rng.uniform(-0.1, 0.1) * h)
    np.testing.assert_array_equal(
        T.warp_affine_nearest(torch.from_numpy(seg), m).numpy(),
        cv2.warpAffine(seg, m, (w, h), flags=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(
        T.warp_affine_f32(torch.from_numpy(flow), m).numpy(),
        cv2.warpAffine(flow, m, (w, h)))


def _plane_inputs(seed, h=300, w=640):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    seg = np.zeros((h, w), np.uint8)
    for k in range(1, 5):
        seg[:, 100 * k:100 * k + 30] = k
    seg[rng.random((h, w)) < 0.05] = 7
    flow = (cv2.GaussianBlur(rng.uniform(-1, 1, (h, w, 2)).astype(
        np.float32), (9, 9), 3) * 0.1).astype(np.float32)
    lanes = [np.array([[100., h - 10.], [200., 50.]], np.float32),
             np.array([[500., h - 10.], [420., 40.]], np.float32)]
    return img, seg, flow, lanes


@pytest.mark.parametrize("seed", range(8))
def test_train_augment_planes_equal_jax(seed):
    img, seg, flow, lanes = _plane_inputs(seed)
    kw = dict(img_h=96, img_w=192, p_hflip=0.5, p_affine=0.7)
    want = JaxAugment(rng=np.random.default_rng(seed), **kw)(
        img, lanes, [0, 1], seg=seg, flow=flow)
    got = T.TrainAugment(rng=np.random.default_rng(seed), **kw)(
        img, lanes, [0, 1], seg=seg, flow=flow)
    bare = T.TrainAugment(rng=np.random.default_rng(seed), **kw)(
        img, lanes, [0, 1])
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    np.testing.assert_allclose(got[4].numpy(), want[4], rtol=0, atol=1e-5)
    assert torch.equal(got[0], bare[0]) and got[2] == bare[2] == want[2]
    assert all(np.array_equal(a, b) for a, b in zip(got[1], bare[1]))
    np.testing.assert_array_equal(got[0].numpy(), want[0])


def test_flip_keeps_u_sign():
    """imgaug's quirk, kept by the JAX class: a flipped flow is mirrored,
    its u not negated."""
    img, seg, flow, lanes = _plane_inputs(0, 96, 192)
    out = T.TrainAugment(96, 192, p_hflip=1.0, p_channel_shuffle=0,
                         p_brightness=0, p_hue_sat=0, p_blur=0, p_affine=0,
                         rng=np.random.default_rng(0))(img, lanes, seg=seg,
                                                       flow=flow)
    np.testing.assert_array_equal(out[2].numpy(), seg[:, ::-1])
    np.testing.assert_array_equal(out[3].numpy(), flow[:, ::-1])


# --- the reader -------------------------------------------------------------

def lane_points(x0, slope, h, n=12):
    ys = np.linspace(h * 0.45, h - 1, n)
    return [[float(x0 + slope * (h - y)), float(y)] for y in ys]


def write_tree(root, palette=False):
    """JAX's ``vil_tree`` (``tests/test_data.py``): a train and a test video
    of 4 frames at 480x960, lane masks 1 in the bottom-left corner; with
    ``palette`` the masks are the JAX ``write_mask``'s palette PNGs of
    lane ids 1, 2 and 3."""
    ori_h, ori_w = 480, 960
    videos = {"0_Road001_Trim001": "train", "1_Road002_Trim002": "test"}
    (root / "VIL100" / "data").mkdir(parents=True)
    with open(root / "VIL100" / "data" / "db_info.yaml", "w") as f:
        yaml.safe_dump({"sequences": [{"name": v, "set": s}
                                      for v, s in videos.items()]}, f)
    for vid in videos:
        for d in ("JPEGImages", "Annotations", "Json"):
            (root / "VIL100" / d / vid).mkdir(parents=True)
        for i in range(4):
            name = f"{i:05d}"
            img = np.full((ori_h, ori_w, 3), 90, np.uint8)
            cv2.imwrite(str(root / "VIL100" / "JPEGImages" / vid
                            / f"{name}.jpg"), img)
            mask = np.zeros((ori_h, ori_w), np.uint8)
            mask[-50:, :100] = 1
            path = str(root / "VIL100" / "Annotations" / vid / f"{name}.png")
            if palette:
                mask[-50:, 300:400] = 2
                mask[-120:, 600:640] = 3
                jax_write_mask(mask, path)
            else:
                cv2.imwrite(path, mask)
            anno = {"info": {"height": ori_h, "width": ori_w},
                    "annotations": {"lane": [
                        {"lane_id": 1, "occlusion": 0,
                         "points": lane_points(300 + 3 * i, 0.2, ori_h)},
                        {"lane_id": 2, "occlusion": 1,
                         "points": lane_points(650 - 3 * i, -0.1, ori_h)}]}}
            with open(root / "VIL100" / "Json" / vid / f"{name}.jpg.json",
                      "w") as f:
                json.dump(anno, f)
    return str(root), (ori_h, ori_w)


def write_flow(root, vid, frames, u, v, size=(480, 960)):
    fdir = os.path.join(root, "VIL100", "Flow", vid)
    os.makedirs(fdir, exist_ok=True)
    for i in frames:
        cv2.imwrite(os.path.join(fdir, f"{i:05d}u.jpg"),
                    np.full(size, u, np.uint8))
        cv2.imwrite(os.path.join(fdir, f"{i:05d}v.jpg"),
                    np.full(size, v, np.uint8))


def both_readers(root, train, **kw):
    tm = dataclasses.replace(tcfg.vil100_config().model, img_h=96,
                             img_w=192, cut_scale=0.35, max_lanes=8,
                             lane=tcfg.LaneSpec(36, 2))
    jd = jcfg.DataConfig(root=root, img_h=96, img_w=192, cut_scale=0.35,
                         max_lanes=8)
    aug = kw.pop("aug", None)
    port = VIL100Dataset(root, tm, train=train, device="cpu",
                         augment=aug(T.TrainAugment) if aug else None, **kw)
    ref = jax_vil100.VIL100Dataset(jd, jcfg.LaneSpec(36, 2), train=train,
                                   augment=aug(JaxAugment) if aug else None,
                                   **kw)
    return port, ref


# the readers' flow is held to the JPEG round trip in normalized units: a
# level is 2 * BOUND / 255 pixels, over the frame's width (u) or height (v)
FLOW_TOL = JPEG_ROUND_TRIP_LEVELS * 2 * BOUND / 255.0 / 480


def test_reader_loads_seg_and_flow_train_mode(tmp_path):
    """JAX's ``test_vil_dataset_loads_seg_and_flow``, through both
    readers."""
    root, _ = write_tree(tmp_path / "dataset")
    write_flow(root, "0_Road001_Trim001", range(4), 200, 55)
    port, ref = both_readers(
        root, True, sampled_frames=2, samples_per_video=1, load_seg=True,
        load_flow=True,
        aug=lambda cls: cls(img_h=96, img_w=192,
                            rng=np.random.default_rng(0), p_affine=1.0))
    got, want = port[0], ref[0]
    assert tuple(got["seg"].shape) == (2, 96, 192)
    assert tuple(got["flow"].shape) == (2, 96, 192, 2)
    assert got["seg"].dtype == torch.uint8 and got["flow"].dtype == \
        torch.float32
    np.testing.assert_array_equal(got["seg"].numpy(), want["seg"])
    np.testing.assert_allclose(got["flow"].numpy(), want["flow"], rtol=0,
                               atol=FLOW_TOL)
    assert got["frame_names"] == want["frame_names"]
    interior = got["flow"][:, 20:70, 40:150]
    assert interior[..., 0].mean() > 0 and interior[..., 1].mean() < 0


def test_reader_flow_missing_frame_stays_aligned(tmp_path):
    """JAX's ``test_vil_flow_missing_frame_stays_aligned``, through both
    readers: frames 1 and 3 have no flow JPEGs and get zero flow."""
    root, _ = write_tree(tmp_path / "dataset")
    write_flow(root, "1_Road002_Trim002", (0, 2), 200, 200)
    port, ref = both_readers(root, False, load_flow=True, load_seg=True)
    got, want = port[0], ref[0]
    assert got["flow"].shape[0] == got["frames"].shape[0] == 4
    np.testing.assert_allclose(got["flow"].numpy(), want["flow"], rtol=0,
                               atol=FLOW_TOL)
    np.testing.assert_array_equal(got["seg"].numpy(), want["seg"])
    assert float(got["flow"][0].abs().max()) > 0
    assert float(got["flow"][2].abs().max()) > 0
    assert float(got["flow"][1].abs().max()) == 0
    assert float(got["flow"][3].abs().max()) == 0


def test_reader_reads_palette_masks_as_lane_ids(tmp_path):
    """The repair: on the JAX package's own palette masks the JAX reader
    reads lane ids 1 / 2 / 3 as their colours' luma 38 / 75 / 113; the
    port reads the ids."""
    root, _ = write_tree(tmp_path / "dataset", palette=True)
    port, ref = both_readers(root, False, load_seg=True)
    got, want = port[0]["seg"].numpy(), ref[0]["seg"]
    assert set(np.unique(got)) == {0, 1, 2, 3}
    assert set(np.unique(want)) == {0, 38, 75, 113}
    for k, luma in ((1, 38), (2, 75), (3, 113)):
        np.testing.assert_array_equal(got == k, want == luma)


def test_loader_carries_the_planes(tmp_path):
    root, _ = write_tree(tmp_path / "dataset")
    write_flow(root, "0_Road001_Trim001", range(4), 180, 90)
    port, _ = both_readers(root, True, sampled_frames=2,
                           samples_per_video=2, load_seg=True,
                           load_flow=True)
    batches = list(ClipLoader(port, batch_size=2, prefetch=2, seed=3))
    assert len(batches) == 1
    for info in batches[0]["infos"]:
        assert tuple(info["seg"].shape) == (2, 96, 192)
        assert tuple(info["flow"].shape) == (2, 96, 192, 2)
        assert float(info["flow"][..., 0].mean()) > 0


# --- the models -------------------------------------------------------------

def _jitter(variables, rng, positive=False):
    def f(a):
        d = rng.normal(size=a.shape).astype(np.float32) * 0.3
        return np.asarray(a) + (np.abs(d) if positive else d)

    return jax.tree_util.tree_map(f, variables)


@pytest.mark.parametrize("h,w,out_h,out_w", [(12, 24, 48, 96),
                                             (12, 24, 37, 71),
                                             (10, 20, 7, 13)])
def test_seg_decoder_equals_flax(h, w, out_h, out_w):
    rng = np.random.default_rng(h + out_w)
    x = rng.normal(size=(2, h, w, 6)).astype(np.float32)
    mod = JaxSeg(out_h, out_w, 5)
    v = _jitter(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(mod.apply(v, jnp.asarray(x)))
    ours = SegDecoder(out_h, out_w, 5, 6)
    ours.load_state_dict(convert_module(v))
    got = ours(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, out_h, out_w, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dropout2d_zeroes_whole_channels():
    x = torch.randn(3, 8, 10, 32) + 5.0
    dec = SegDecoder(8, 10, 4, 32, dropout_rate=0.5)
    g = torch.Generator().manual_seed(3)
    y = dec(x, train=True, generator=g)
    assert y.shape == (3, 8, 10, 4)
    # the same generator's draw: one keep a (image, channel)
    keep = torch.rand((3, 1, 1, 32), generator=torch.Generator()
                      .manual_seed(3)) >= 0.5
    dropped = torch.where(keep, x / torch.tensor(0.5), 0.0)
    zero = (dropped == 0).all(1).all(1)
    assert zero.any() and (~zero).any()
    assert torch.equal(zero, ~keep[:, 0, 0])
    ref = SegDecoder(8, 10, 4, 32, dropout_rate=0.5)
    ref.load_state_dict(dec.state_dict())
    ref.dropout_rate = 0.0
    torch.testing.assert_close(y, ref(dropped), rtol=0, atol=1e-5)
    assert torch.equal(dec(x), ref(x))  # eval: no dropout


def test_warp_model_equals_flax():
    rng = np.random.default_rng(7)
    b, h, w, c = 2, 9, 13, 4
    feat = rng.normal(size=(b, h, w, c)).astype(np.float32)
    cur = rng.normal(size=(b, h, w, c)).astype(np.float32)
    flow = rng.uniform(-0.4, 0.4, (b, h, w, 2)).astype(np.float32)
    np.testing.assert_allclose(
        flow_warp(torch.from_numpy(feat), torch.from_numpy(flow)).numpy(),
        np.asarray(jax_flow_warp(jnp.asarray(feat), jnp.asarray(flow))),
        rtol=0, atol=1e-5)
    mod = JaxWarp(c, 5)
    v = _jitter(mod.init(jax.random.PRNGKey(1), feat, cur, flow), rng,
                positive=True)
    want = np.asarray(mod.apply(v, feat, cur, flow))
    ours = WarpModel(c, 5)
    sd = convert_module(v)
    assert set(sd) == {"conv.weight", "bn.weight", "bn.bias",
                       "bn.running_mean", "bn.running_var"}
    ours.load_state_dict(sd)
    got = ours(*map(torch.from_numpy, (feat, cur, flow))).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_isolation_scans_the_planes_modules():
    """``test_torch_isolation.py`` scans every module of the port; the new
    ones are among them and import none of its forbidden roots."""
    from test_torch_isolation import FORBIDDEN, imported_roots, port_sources

    repo = Path(__file__).resolve().parents[1]
    names = {p.relative_to(repo).as_posix(): p for p in port_sources()}
    for mod in ("phnet_torch/data/png.py", "phnet_torch/data/flow.py",
                "phnet_torch/utils/masks.py",
                "phnet_torch/evaluation/video_metrics.py",
                "phnet_torch/models/seg_decoder.py",
                "phnet_torch/models/flow_warp.py"):
        assert mod in names
        assert not set(imported_roots(names[mod])) & set(FORBIDDEN), mod

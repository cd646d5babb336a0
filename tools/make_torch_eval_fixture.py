#!/usr/bin/env python
"""Write the small on-disk datasets that the evaluation path of the port is
tested on (``tests/fixtures/torch_eval/``), in the datasets' own layouts:

* ``VIL100/``: ``data/db_info.yaml`` with two test videos and one train
  video, 4 frames each at 1280x720 (``JPEGImages/<video>/<frame>.jpg``,
  ``Json/<video>/<frame>.jpg.json``); one lane of one point, which the
  readers skip, and lane ids with a gap;
* ``OpenLane/``: one validation video of 4 frames at 1920x1280
  (``images/validation/<video>/<frame>.jpg``,
  ``OpenLane-V/label/validation/<video>/<frame>.pickle``), with a lane of
  two points, which the readers drop, and an empty one;
* ``decoded_u8.npz``: the libjpeg decode (uint8 RGB) of every frame,
  every ``STRIDE``-th row and column of it (``vil``, ``ol``; the files in
  ``vil_files``, ``ol_files``, the step in ``stride``), from the port's
  own libjpeg decoder (``phnet_torch.data.native_loader.decode_clip_u8``):
  the reference that the card's nvJPEG decode is held against, where
  there is no libjpeg. ``tests/test_torch_eval_data.py`` checks that it is current.

The frames are drawn and encoded with OpenCV (JPEG quality 85, its default
4:2:0 chroma subsampling), from a seed:

    python tools/make_torch_eval_fixture.py [--out tests/fixtures/torch_eval]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import cv2
import numpy as np
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STRIDE = 7  # coprime with the 8x8 blocks: every position in a block
VIL_VIDEOS = (("0_Road001_Trim003_frames", "test"),
              ("1_Road010_Trim002_frames", "train"),
              ("4_Road027_Trim005_frames", "test"))
VIL_FRAMES = ("00000", "00003", "00006", "00009")
OL_VIDEO = "segment-1024360143612057520_3580_000_3600_000_with_camera_labels"
OL_FRAMES = ("150723473494688800", "150723473594688900",
             "150723473694688700", "150723473794688800")


def road(rng, h, w, horizon):
    """A sky-and-road background with mild blocky texture (uint8 BGR)."""
    img = np.zeros((h, w, 3), np.float32)
    ys = np.arange(h, dtype=np.float32)[:, None]
    sky = np.clip(1.0 - ys / max(horizon, 1), 0, 1)
    img[..., 0] = 140 + 90 * sky          # B
    img[..., 1] = 110 + 70 * sky          # G
    img[..., 2] = 90 + 40 * sky           # R
    ground = ys >= horizon
    img[..., :] = np.where(ground[..., None],
                           np.array([85, 88, 92], np.float32)
                           + 25 * (ys - horizon)[..., None] / h, img)
    noise = rng.integers(-6, 7, (h // 16 + 1, w // 16 + 1, 1))
    img += np.repeat(np.repeat(noise, 16, 0), 16, 1)[:h, :w]
    return np.clip(img, 0, 255).astype(np.uint8)


def lane_polyline(x_bottom, slope, y_top, h, n):
    ys = np.linspace(h - 1, y_top, n)
    xs = x_bottom + slope * (h - 1 - ys) + 2e-4 * (h - 1 - ys) ** 2
    return np.stack([xs, ys], 1)


def draw(img, lanes, colors):
    for pts, color in zip(lanes, colors):
        p = np.round(pts).astype(np.int32)
        for a, b in zip(p[:-1], p[1:]):
            cv2.line(img, tuple(map(int, a)), tuple(map(int, b)), color, 9)


def write_jpeg(path, img):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 85])
    assert ok
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def make_vil(out, rng):
    base = os.path.join(out, "VIL100")
    h, w = 720, 1280
    db = {"attributes": ["curve", "occlusion"], "sets": ["train", "test"],
          "years": [2021], "sequences": []}
    for v, (vid, split) in enumerate(VIL_VIDEOS):
        db["sequences"].append({
            "attributes": ["curve"] if v % 2 else [], "eval_t": True,
            "name": vid, "num_frames": len(VIL_FRAMES), "set": split,
            "year": 2021})
        lanes0 = [(300 + 40 * v, 0.9, 330), (560 + 10 * v, 0.1, 320),
                  (820 - 30 * v, -0.7, 335), (1060, -1.2, 350)]
        for t, name in enumerate(VIL_FRAMES):
            img = road(rng, h, w, 300)
            lanes, ann = [], []
            for k, (xb, s, yt) in enumerate(lanes0):
                pts = lane_polyline(xb + 6 * t, s, yt, h, 9 + 2 * k)
                lanes.append(pts)
                # ids 1, 2, 4, 5: a gap in the label rows
                ann.append({"lane_id": k + 1 + (k >= 2),
                            "points": [[round(float(x), 2),
                                        round(float(y), 2)]
                                       for x, y in pts[::-1]],
                            "occlusion": [0] * len(pts)})
            ann.append({"lane_id": 3, "points": [[640.0, 700.0]],
                        "occlusion": [0]})  # one point: skipped
            draw(img, lanes, [(235, 235, 235), (60, 200, 230)] * 2)
            write_jpeg(os.path.join(base, "JPEGImages", vid, name + ".jpg"),
                       img)
            jdir = os.path.join(base, "Json", vid)
            os.makedirs(jdir, exist_ok=True)
            with open(os.path.join(jdir, name + ".jpg.json"), "w") as f:
                json.dump({"info": {"height": h, "width": w},
                           "annotations": {"lane": ann}}, f)
    os.makedirs(os.path.join(base, "data"), exist_ok=True)
    with open(os.path.join(base, "data", "db_info.yaml"), "w") as f:
        yaml.safe_dump(db, f)


def make_ol(out, rng):
    base = os.path.join(out, "OpenLane")
    h, w = 1280, 1920
    img_dir = os.path.join(base, "images", "validation", OL_VIDEO)
    lab_dir = os.path.join(base, "OpenLane-V", "label", "validation",
                           OL_VIDEO)
    os.makedirs(lab_dir, exist_ok=True)
    for t, name in enumerate(OL_FRAMES):
        img = road(rng, h, w, 620)
        lanes = [lane_polyline(500 + 8 * t, 1.1, 700, h, 20),
                 lane_polyline(940 - 5 * t, 0.05, 690, h, 18),
                 lane_polyline(1420, -1.0, 710, h, 16)]
        draw(img, lanes, [(235, 235, 235), (60, 200, 230), (235, 235, 235)])
        write_jpeg(os.path.join(img_dir, name + ".jpg"), img)
        labels = [l.astype(np.float64) for l in lanes]
        labels.append(np.array([[1700.0, 1270.0], [1650.0, 1000.0]]))
        labels.append(np.zeros((0, 2)))  # empty: skipped
        with open(os.path.join(lab_dir, name + ".pickle"), "wb") as f:
            pickle.dump({"lanes": labels}, f)


def frame_paths(out):
    vil = [os.path.join(out, "VIL100", "JPEGImages", vid, n + ".jpg")
           for vid, _ in VIL_VIDEOS for n in VIL_FRAMES]
    ol = [os.path.join(out, "OpenLane", "images", "validation", OL_VIDEO,
                       n + ".jpg") for n in OL_FRAMES]
    return vil, ol


def decoded_reference(out):
    """{"vil": [12, 103, 183, 3], "ol": [4, 183, 275, 3]} uint8: every
    STRIDE-th row and column of each frame's libjpeg decode."""
    from phnet_torch.data.native_loader import decode_clip_u8

    vil, ol = frame_paths(out)
    return {"vil": decode_clip_u8(vil)[:, ::STRIDE, ::STRIDE],
            "ol": decode_clip_u8(ol)[:, ::STRIDE, ::STRIDE],
            "vil_files": np.array([os.path.relpath(p, out) for p in vil]),
            "ol_files": np.array([os.path.relpath(p, out) for p in ol]),
            "stride": np.array(STRIDE)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "fixtures",
                                                  "torch_eval"))
    ap.add_argument("--seed", type=int, default=13)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    make_vil(args.out, rng)
    make_ol(args.out, rng)
    np.savez_compressed(os.path.join(args.out, "decoded_u8.npz"),
                        **decoded_reference(args.out))
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out}: {total} bytes")


if __name__ == "__main__":
    main()

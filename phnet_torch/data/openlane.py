"""OpenLane-V dataset reader, validation mode.

Counterpart of ``phnet_tpu/data/openlane.py::OpenLaneDataset(train=False)``
on the reference's schema (``libs/dataset/openlane/datasetOL.py:19-141``):

  <root>/OpenLane/images/validation/<video>/<frame>.jpg
  <root>/OpenLane/OpenLane-V/label/validation/<video>/<frame>.pickle
      pickle = {'lanes': [ndarray (N, 2)]}

A clip is a whole validation video: its frames with the top ``crop_size``
rows cut off, resized and normalized; its lanes moved up by the crop,
those of fewer than three points dropped (the reference keeps
``len(lane) > 2``), scaled with the frames and numbered in order. The
label files are the dataset's pickles, read as the reference reads them.
Frames are decoded by libjpeg on the CPU and by nvJPEG on the card
(``native_loader``); the reader runs on the card unless it is given
``device="cpu"``. The frame size, the crop and the label rows are the
model configuration's. Train mode (flip, reversal, sampling, augmentation) is
not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from ..config import ModelConfig
from ..geometry import encode_lane_label
from .native_loader import ClipDecoder, jpeg_dims
from .transforms import scale_lanes


class OpenLaneDataset:
    """Validation videos of OpenLane-V under ``<root>/OpenLane``
    (``train=True`` raises), read for a model of configuration ``cfg``
    (its ``img_h``, ``img_w``, ``crop_size``, ``max_lanes`` and lane
    spec). ``device``: where frames are decoded and returned as a float32
    tensor (None: the card)."""

    def __init__(self, root: str, cfg: ModelConfig, train: bool = False,
                 device=None):
        if train:
            raise NotImplementedError(
                "OpenLaneDataset reads the validation split only: train "
                "mode (flip, reversal, max_skip sampling, TrainAugment "
                "without OpenCV) is not ported yet")
        self.cfg = cfg
        self.decode = ClipDecoder(device)
        root = os.path.join(root, "OpenLane")
        self.img_root = os.path.join(root, "images", "validation")
        self.label_root = os.path.join(root, "OpenLane-V", "label",
                                       "validation")
        self.videos = sorted(os.listdir(self.label_root))

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx: int) -> Dict:
        vid = self.videos[idx]
        label_dir = os.path.join(self.label_root, vid)
        frames = sorted(n[: -len(".pickle")] for n in os.listdir(label_dir))
        crop = self.cfg.crop_size
        paths = [os.path.join(self.img_root, vid, n + ".jpg") for n in frames]
        ori_h, ori_w = jpeg_dims(paths[0])
        imgs = self.decode(paths, crop, self.cfg.img_h, self.cfg.img_w)

        labels, points = [], []
        for name in frames:
            with open(os.path.join(label_dir, name + ".pickle"), "rb") as f:
                anno = pickle.load(f)
            lanes = []
            for pts in anno["lanes"]:
                pts = np.asarray(pts, np.float32)
                if len(pts) == 0:
                    continue
                pts = pts.copy()
                pts[:, 1] -= crop
                if len(pts) >= 3:  # reference filters len(lane) > 2
                    lanes.append(pts)
            lanes = scale_lanes(lanes, ori_h - crop, ori_w, self.cfg.img_h,
                                self.cfg.img_w)
            labels.append(encode_lane_label(
                [list(map(tuple, p[np.argsort(-p[:, 1])])) for p in lanes],
                list(range(len(lanes))), self.cfg.lane, self.cfg.img_h,
                self.cfg.img_w, self.cfg.max_lanes))
            points.append(lanes)
        return {"name": vid, "frames": imgs, "labels": np.stack(labels),
                "points": points,
                "size": (ori_h - crop, ori_w),  # the cropped frame
                "ori_size": (ori_h, ori_w), "crop": crop,
                "frame_names": frames}

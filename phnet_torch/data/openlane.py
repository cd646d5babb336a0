"""OpenLane-V dataset reader, in validation and in train mode.

Counterpart of ``phnet_tpu/data/openlane.py::OpenLaneDataset`` on the
reference's schema (``libs/dataset/openlane/datasetOL.py:19-141``):

  <root>/OpenLane/images/{training,validation}/<video>/<frame>.jpg
  <root>/OpenLane/OpenLane-V/label/{training,validation}/<video>/<frame>.pickle
      pickle = {'lanes': [ndarray (N, 2)]}

Validation mode: a clip is a whole validation video: its frames with the
top ``crop_size`` rows cut off, resized and normalized; its lanes moved up
by the crop, those of fewer than three points dropped (the reference
keeps ``len(lane) > 2``), scaled with the frames and numbered in order
(``points``, the model's frame); the same lanes in the frame the
predictions are written in (``image_points``: half scale, the crop
shifted back), the ground truth's.
Frames are decoded, cropped, resized and normalized by ``native_loader``
(libjpeg on the CPU, nvJPEG on the card).

Train mode (``train=True``, the ``training`` split): ``samples_per_video``
clips a video an epoch of ``sampled_frames`` frames with gaps of at most
``max_skip`` (capped at 1, the reference's ``MAX_TRAINING_SKIP``), then,
from the reader's generator in this order, a horizontal flip of the whole
clip (``x -> (ori_w - 1) - x``, before the augmentation) and its
reversal (``datasetOL.py:89-110``). Each frame is decoded whole to uint8,
cropped, flipped, put through ``augment``
(:class:`~phnet_torch.data.transforms.TrainAugment`) and normalized on the
reader's device; without ``augment`` a flipped clip is resized as
``cv2.resize`` does (``transforms.resize_u8``) and an unflipped one takes
validation mode's path, as in the JAX reader.

The label files are the dataset's pickles, read as the reference reads
them. The reader runs on the card unless it is given ``device="cpu"``.
The frame size, the crop and the label rows are the model
configuration's.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..geometry import encode_lane_label
from .native_loader import ClipDecoder, jpeg_dims
from .sampling import FrameSampling
from .transforms import (TrainAugment, normalize, resize_with_lanes,
                         scale_lanes)


class OpenLaneDataset(FrameSampling):
    """OpenLane-V under ``<root>/OpenLane``: its validation videos, or with
    ``train=True`` its training videos, read for a model of configuration
    ``cfg`` (its ``img_h``, ``img_w``, ``crop_size``, ``max_lanes`` and
    lane spec). ``device``: where frames are decoded and returned as a
    float32 tensor (None: the card). The training arguments are the JAX
    reader's."""

    MAX_TRAINING_SKIP = 1

    def __init__(self, root: str, cfg: ModelConfig, train: bool = False,
                 device=None, sampled_frames: int = 16, max_skip: int = 1,
                 skip_increment: int = 1, samples_per_video: int = 1,
                 augment: Optional[TrainAugment] = None, seed: int = 3407):
        self.cfg = cfg
        self.train = train
        self.decode = ClipDecoder(device)
        mode = "training" if train else "validation"
        self.mode = mode
        root = os.path.join(root, "OpenLane")
        self.img_root = os.path.join(root, "images", mode)
        self.label_root = os.path.join(root, "OpenLane-V", "label", mode)
        self.videos = sorted(os.listdir(self.label_root))
        self.sampled_frames = sampled_frames
        self.max_skip = max_skip
        self.increment = skip_increment
        self.samples_per_video = samples_per_video if train else 1
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.samples_per_video * len(self.videos)

    def __getitem__(self, idx: int) -> Dict:
        vid = self.videos[idx // self.samples_per_video]
        label_dir = os.path.join(self.label_root, vid)
        frames = sorted(n[: -len(".pickle")] for n in os.listdir(label_dir))
        frames = self._sample_frames(frames)
        flip = bool(self.rng.integers(0, 2)) if self.train else False
        reverse = bool(self.rng.integers(0, 2)) if self.train else False
        if reverse:
            frames = frames[::-1]
        crop = self.cfg.crop_size
        c = self.cfg
        paths = [os.path.join(self.img_root, vid, n + ".jpg") for n in frames]
        ori_h, ori_w = jpeg_dims(paths[0])
        augment = self.augment if self.train else None
        pixels = augment is not None or flip
        frames_u8 = self.decode.u8(paths) if pixels else None

        imgs, labels, points, image_points = [], [], [], []
        for i, name in enumerate(frames):
            with open(os.path.join(label_dir, name + ".pickle"), "rb") as f:
                anno = pickle.load(f)
            lanes = []
            for pts in anno["lanes"]:
                pts = np.asarray(pts, np.float32)
                if len(pts) == 0:
                    continue
                pts = pts.copy()
                pts[:, 1] -= crop
                if flip:
                    pts[:, 0] = (ori_w - 1) - pts[:, 0]
                if len(pts) >= 3:  # reference filters len(lane) > 2
                    lanes.append(pts)
            # the frame the predictions are written in: half scale, the
            # crop shifted back
            image_points.append([(p + np.array([0.0, crop], np.float32))
                                 / 2 for p in lanes])
            if pixels:
                img = frames_u8[i, crop:]
                if flip:
                    img = img.flip(1)
                if augment is not None:
                    img, lanes = augment(img, lanes)
                else:
                    img, lanes = resize_with_lanes(img, lanes, c.img_h,
                                                   c.img_w)
                imgs.append(normalize(img))
            else:
                lanes = scale_lanes(lanes, ori_h - crop, ori_w, c.img_h,
                                    c.img_w)
            labels.append(encode_lane_label(
                [list(map(tuple, p[np.argsort(-p[:, 1])])) for p in lanes],
                list(range(len(lanes))), c.lane, c.img_h, c.img_w,
                c.max_lanes))
            points.append(lanes)
        if pixels:
            out = torch.stack(imgs)
        else:
            out = self.decode(paths, crop, c.img_h, c.img_w)
        return {"name": vid, "frames": out, "labels": np.stack(labels),
                "points": points, "image_points": image_points,
                "size": (ori_h - crop, ori_w),  # the cropped frame
                "ori_size": (ori_h, ori_w), "crop": crop,
                "frame_names": frames}

"""Host-side image and lane-geometry transforms of the evaluation path.

The parts of ``phnet_tpu/data/transforms.py`` that the readers' test mode
runs, without OpenCV: the ImageNet normalization (``Normalize``) and the
lane scaling of ``resize_with_lanes`` (the pixels are resized by the
clip decoder, ``native_loader.decode_clip``, in cv2's bilinear geometry).
The training augmentation (``TrainAugment``) is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

Lanes = List[np.ndarray]  # list of (N, 2) float arrays (x, y)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Normalize:
    """(img/255 - mean) / std (reference ``transform.py:194-203``)."""

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return ((img.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def scale_lanes(lanes: Lanes, src_h: int, src_w: int, out_h: int,
                out_w: int) -> Lanes:
    """The lanes of a (src_h, src_w) image in its resize to (out_h, out_w):
    ``resize_with_lanes``' arithmetic (float32 points times the float32
    pair (out_w / src_w, out_h / src_h))."""
    s = np.array([out_w / src_w, out_h / src_h], np.float32)
    return [lane * s for lane in lanes]

"""Segmentation mask utilities.

Counterpart of ``phnet_tpu/utils/masks.py`` (the reference's
``libs/utils/utility.py``: ``write_mask`` :27, ``mask_iou`` :72, and the
one-hot converters of ``dataV3.py:45-57``), on tensors on any device or
numpy arrays. ``write_mask`` writes its PNG through the port's own codec
(``data/png.py``), not PIL.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..data import png

# default palette: reference COLORS table (transformV4.py:14-36)
DEFAULT_PALETTE = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (191, 0, 0),
]


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def convert_mask_to_one_hot(mask, max_obj: int) -> torch.Tensor:
    """Index mask [H, W] -> bool one-hot [H, W, max_obj + 1] on its device
    (``dataV3.py:45-51``)."""
    mask = _tensor(mask)
    return torch.stack([mask == k for k in range(max_obj + 1)], dim=2)


def convert_one_hot_to_mask(oh, max_obj: int) -> torch.Tensor:
    """One-hot [H, W, K] -> uint8 index mask [H, W]: each pixel takes the
    last channel ``k <= max_obj`` that equals 1 (0 where none does)."""
    oh = _tensor(oh)
    mask = torch.zeros(oh.shape[:2], dtype=torch.uint8, device=oh.device)
    for k in range(max_obj + 1):
        mask[oh[:, :, k] == 1] = k
    return mask


def mask_iou(pred, target, eps: float = 1e-7) -> float:
    """Mean per-instance mask IoU (``utility.py:72-82``): pred / target
    [K, H, W] stacks, binarized at 0.5; the ratios in float64."""
    pred = _tensor(pred) > 0.5
    target = _tensor(target) > 0.5
    k = pred.shape[0]
    inter = (pred & target).reshape(k, -1).sum(-1).double()
    union = (pred | target).reshape(k, -1).sum(-1).double()
    return float(((inter + eps) / (union + eps)).mean())


def write_mask(mask, path: str, palette: Optional[Sequence] = None,
               indexed: bool = True, image=None) -> str:
    """Save a segmentation mask (uint8 indices [H, W]): an indexed PNG with
    ``palette`` (default :data:`DEFAULT_PALETTE`, the reference's
    ``save_indexed_format``), else ``image`` (uint8 RGB [H, W, 3]) blended
    half and half with each lane's palette colour, as an RGB PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    mask = _host(mask).astype(np.uint8)
    pal = palette if palette is not None else DEFAULT_PALETTE
    if indexed:
        return png.write_indexed(path, mask, pal)
    if image is None:
        raise ValueError("write_mask(indexed=False) blends onto an image")
    image = _host(image)
    overlay = image.copy()
    for k in range(1, int(mask.max()) + 1):
        overlay[mask == k] = pal[k % len(pal)]
    blend = (0.5 * image + 0.5 * overlay).astype(np.uint8)
    return png.write_rgb(path, blend)


def topk_accuracy(pred, target, topk: Sequence[int] = (1,)) -> list:
    """Top-k classification accuracy in percent (reference
    ``libs/utils/accuracy.py``): pred [N, C] scores, target [N] classes;
    ties ordered by class index."""
    pred, target = _tensor(pred), _tensor(target)
    maxk = max(topk)
    order = torch.argsort(-pred, dim=1, stable=True)[:, :maxk]
    correct = order == target[:, None].to(order.device)
    return [float(correct[:, :k].any(dim=1).double().mean()) * 100.0
            for k in topk]

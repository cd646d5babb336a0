"""VIL-100 dataset reader, in test and in train mode.

Counterpart of ``phnet_tpu/data/vil100.py::VIL100Dataset`` on the
reference's on-disk schema (``libs/dataset/dataV3.py:64-205``):

  <root>/VIL100/
    data/db_info.yaml            sequences: [{name, set: train|test}, ...]
    JPEGImages/<vid>/<frame>.jpg
    Annotations/<vid>/<frame>.png   (segmentation masks, lane ids)
    Json/<vid>/<frame>.jpg.json  {annotations: {lane: [{lane_id, points}]}}
    Flow/<vid>/<frame>{u,v}.jpg  (quantized Farneback flow, optional)

Test mode: a clip is a whole test video: its frames cropped by the top
``cut_scale`` of the image, resized to the model's frame and normalized;
its lanes (lanes of fewer than two points skipped, ``lane_id - 1`` the
label row) moved up by the cut and scaled with the frames (``points``,
the model's frame); the same lanes as the JSON gives them
(``image_points``, the image's frame, before the cut: the frame the
predictions are written in, and the ground truth's); the fixed-shape
labels of the port's ``geometry.encode_lane_label``. Frames
are decoded, cropped, resized and normalized by ``native_loader``
(libjpeg on the CPU, bit-equal to the JAX package's native loader; nvJPEG
on the card).

Train mode (``train=True``): ``samples_per_video`` clips a train video an
epoch, each of ``sampled_frames`` frames drawn with gaps of at most
``max_skip`` (the curriculum: :meth:`increase_max_skip`), from the
reader's own generator (``seed``) as the JAX reader draws. Each frame is
decoded whole to uint8 (``ClipDecoder.u8``), cropped, put through
``augment`` (:class:`~phnet_torch.data.transforms.TrainAugment`, up to 30
tries while the label encoding raises) and normalized, all on the
reader's device; without ``augment`` the clip takes test mode's path.

The segmentation and flow planes (``load_seg``, ``load_flow``, both
modes): the mask PNG read by the port's codec (``data/png.py``: a palette
mask reads to its indices, where the JAX reader's OpenCV reads the
palette colours' luma; a gray mask to its bytes as there), the u / v
flow JPEGs decoded to gray (libjpeg on the CPU, nvJPEG's Y plane on the
card) and dequantized with the JPEGs' own size (``dataV3.py:168-176``),
both cropped by the cut; then through ``augment`` beside the frame, or in
test mode resized to the model's frame (the mask with ``INTER_NEAREST``,
the flow with the float ``INTER_LINEAR``). A frame whose flow JPEGs are
missing gets zero flow and stays aligned with its image; a file that is
there and does not decode raises. ``seg`` comes back as uint8 [T, H, W]
and ``flow`` as float32 [T, H, W, 2], on the reader's device.

``db_info.yaml`` is read by :func:`read_sequences`, not by a YAML
library. The reader runs on the card unless it is given ``device="cpu"``.
The frame size, the cut and the label rows are the model configuration's.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..geometry import encode_lane_label
from .flow import dequantize_flow
from .native_loader import ClipDecoder, jpeg_dims
from .png import read_mask
from .sampling import FrameSampling
from .transforms import (TrainAugment, normalize, resize_linear_f32,
                         resize_nearest, scale_lanes)

_KEY = re.compile(r"^([A-Za-z_][\w-]*)\s*:(?:\s+(.*))?$")


def _scalar(text: str) -> str:
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        return body.replace("''", "'") if text[0] == "'" else body
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow_items(text: str) -> List[Dict[str, str]]:
    """``[{name: a, set: test}, ...]``: a flow sequence of flow mappings
    of plain or quoted scalars."""
    items = []
    for body in re.findall(r"\{([^{}]*)\}", text):
        item = {}
        for pair in body.split(","):
            if pair.strip():
                key, _, value = pair.partition(":")
                item[key.strip()] = _scalar(value)
        items.append(item)
    return items


def read_sequences(path: str) -> List[Dict[str, str]]:
    """``[{"name": ..., "set": ...}, ...]`` of a VIL-100 ``db_info.yaml``:
    the ``name`` and ``set`` of each entry of its top-level ``sequences``
    list, in order (what ``yaml.safe_load(f)["sequences"]`` gives for those
    two keys). Reads the block style that YAML writers emit (and DAVIS's
    ``db_info.yaml`` uses) and a flow list of flow mappings; other keys
    of an entry and their nested values are skipped. Raises ValueError
    when there is no ``sequences`` list or an entry lacks either key."""
    with open(path) as f:
        lines = [_strip_comment(l).rstrip() for l in f.read().splitlines()]
    lines = [l for l in lines if l.strip() and l.strip() != "---"]
    start = next((i for i, l in enumerate(lines)
                  if re.match(r"^sequences\s*:", l)), None)
    if start is None:
        raise ValueError(f"{path}: no top-level 'sequences'")
    rest = lines[start].split(":", 1)[1].strip()
    if rest:
        if not rest.startswith("["):
            raise ValueError(f"{path}: 'sequences' is not a list")
        text, i = rest, start + 1
        while text.count("[") > text.count("]") and i < len(lines):
            text, i = text + " " + lines[i].strip(), i + 1
        items = _flow_items(text)
    else:
        items, item_indent, key_indent = [], None, None
        for line in lines[start + 1:]:
            indent = len(line) - len(line.lstrip(" "))
            body = line.strip()
            if item_indent is None:
                if not body.startswith("-"):
                    break
                item_indent = indent
            if indent < item_indent or (indent == item_indent
                                        and not body.startswith("-")):
                break  # the next top-level key
            if indent == item_indent:  # "- key: value" opens an entry
                entry = body[1:].strip()
                items.append({})
                key_indent = indent + (len(body) - len(entry))
                if entry.startswith("{"):
                    items[-1] = _flow_items(entry)[0]
                    continue
                body, indent = entry, key_indent
            if indent != key_indent:
                continue  # nested value of another key
            m = _KEY.match(body)
            if m and m.group(2) is not None:
                items[-1][m.group(1)] = _scalar(m.group(2))
    out = []
    for k, item in enumerate(items):
        if "name" not in item or "set" not in item:
            raise ValueError(f"{path}: sequence {k} lacks 'name' or 'set'")
        out.append({"name": item["name"], "set": item["set"]})
    return out


class VIL100Dataset(FrameSampling):
    """VIL-100 under ``<root>/VIL100``: its test videos, or with
    ``train=True`` its train videos, read for a model of configuration
    ``cfg`` (its ``img_h``, ``img_w``, ``cut_scale``, ``max_lanes`` and
    lane spec). ``device``: where frames are decoded and returned as a
    float32 tensor (None: the card). The training arguments and
    ``load_seg`` / ``load_flow`` are the JAX reader's."""

    MAX_TRAINING_SKIP = 100

    def __init__(self, root: str, cfg: ModelConfig, train: bool = False,
                 device=None, sampled_frames: int = 16, max_skip: int = 5,
                 skip_increment: int = 5, samples_per_video: int = 2,
                 augment: Optional[TrainAugment] = None, seed: int = 3407,
                 load_seg: bool = False, load_flow: bool = False):
        self.cfg = cfg
        self.train = train
        self.decode = ClipDecoder(device)
        root = os.path.join(root, "VIL100")
        self.imgdir = os.path.join(root, "JPEGImages")
        self.jsondir = os.path.join(root, "Json")
        self.annodir = os.path.join(root, "Annotations")
        self.flowdir = os.path.join(root, "Flow")
        self.load_seg = load_seg
        self.load_flow = load_flow
        db = read_sequences(os.path.join(root, "data", "db_info.yaml"))
        target = "train" if train else "test"
        self.videos = [s["name"] for s in db if s["set"] == target]
        self.sampled_frames = sampled_frames
        self.max_skip = max_skip
        self.increment = skip_increment
        self.samples_per_video = samples_per_video if train else 1
        self.augment = augment
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.samples_per_video * len(self.videos)

    def _lanes(self, path: str, cut: int):
        """A frame's lanes (x, y - cut) of two points or more, their label
        rows ``lane_id - 1``, and the same lanes' points as the JSON gives
        them (the image's frame, before the cut)."""
        with open(path) as f:
            info = json.load(f)
        lanes, ids, image = [], [], []
        for lane in info["annotations"]["lane"]:
            pts = np.array([(p[0], p[1] - cut) for p in lane["points"]],
                           np.float32)
            if len(pts) < 2:
                continue
            lanes.append(pts)
            ids.append(lane["lane_id"] - 1)
            image.append(np.array([(p[0], p[1]) for p in lane["points"]],
                                  np.float32))
        return lanes, ids, image

    def _label(self, lanes, ids) -> np.ndarray:
        c = self.cfg
        return encode_lane_label(
            [list(map(tuple, p[np.argsort(-p[:, 1])])) for p in lanes],
            ids, c.lane, c.img_h, c.img_w, c.max_lanes)

    def _planes(self, vid: str, name: str, cut: int):
        """A frame's mask (uint8 [H - cut, W]) and flow (float32 [H - cut,
        W, 2], None where its JPEGs are missing), each None unless
        loaded, on the reader's device."""
        dev = self.decode.device
        seg = flow = None
        if self.load_seg:
            mask = read_mask(os.path.join(self.annodir, vid, name + ".png"))
            seg = torch.from_numpy(mask[cut:]).to(dev)
        if self.load_flow:
            uv = [os.path.join(self.flowdir, vid, name + s + ".jpg")
                  for s in ("u", "v")]
            if all(os.path.exists(p) for p in uv):
                u, v = self.decode.gray(uv)
                flow = dequantize_flow(u, v, *u.shape[:2])[cut:]
        return seg, flow

    def __getitem__(self, idx: int) -> Dict:
        vid = self.videos[idx // self.samples_per_video]
        jsonfolder = os.path.join(self.jsondir, vid)
        frames = sorted(name[:5] for name in os.listdir(jsonfolder))
        frames = self._sample_frames(frames)
        paths = [os.path.join(self.imgdir, vid, n + ".jpg") for n in frames]
        ori_h, ori_w = jpeg_dims(paths[0])
        cut = int(ori_h * self.cfg.cut_scale)
        c = self.cfg
        augment = self.augment if self.train else None
        frames_u8 = self.decode.u8(paths) if augment else None
        imgs, labels, points, image_points = [], [], [], []
        segs, flows = [], []
        for i, name in enumerate(frames):
            lanes0, ids0, image = self._lanes(
                os.path.join(jsonfolder, name + ".jpg.json"), cut)
            seg0, flow0 = self._planes(vid, name, cut)
            seg = flow = None
            if augment is None:
                lanes, ids = scale_lanes(lanes0, ori_h - cut, ori_w, c.img_h,
                                         c.img_w), ids0
                labels.append(self._label(lanes, ids))
                if seg0 is not None:
                    seg = resize_nearest(seg0, c.img_h, c.img_w)
                if flow0 is not None:
                    flow = resize_linear_f32(flow0, c.img_h, c.img_w)
            else:
                # the JAX reader's 30 tries (transformV4.py:241-259): each
                # draws anew from the augmentation's generator
                for attempt in range(30):
                    try:
                        res = augment(frames_u8[i, cut:], lanes0, ids0,
                                      seg=seg0, flow=flow0)
                        img, lanes, ids = res[:3]
                        rest = list(res[3:])
                        seg = rest.pop(0) if seg0 is not None else None
                        flow = rest.pop(0) if flow0 is not None else None
                        labels.append(self._label(lanes, ids))
                        break
                    except Exception:
                        if attempt == 29:
                            raise
                imgs.append(normalize(img))
            points.append(lanes)
            image_points.append(image)
            if self.load_seg:
                segs.append(seg)
            if self.load_flow:
                # a frame without flow JPEGs keeps its row: zero flow
                flows.append(flow if flow is not None else torch.zeros(
                    (c.img_h, c.img_w, 2), dtype=torch.float32,
                    device=self.decode.device))
        if augment is None:
            out = self.decode(paths, cut, c.img_h, c.img_w)
        else:
            out = torch.stack(imgs)
        clip = {"name": vid, "frames": out, "labels": np.stack(labels),
                "points": points, "image_points": image_points,
                "size": (ori_h, ori_w), "cut": cut, "frame_names": frames}
        if segs:
            clip["seg"] = torch.stack(segs)
        if flows:
            clip["flow"] = torch.stack(flows)
        return clip

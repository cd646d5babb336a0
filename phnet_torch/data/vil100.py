"""VIL-100 dataset reader, test mode.

Counterpart of ``phnet_tpu/data/vil100.py::VIL100Dataset(train=False)``
on the reference's on-disk schema (``libs/dataset/dataV3.py:64-205``):

  <root>/VIL100/
    data/db_info.yaml            sequences: [{name, set: train|test}, ...]
    JPEGImages/<vid>/<frame>.jpg
    Json/<vid>/<frame>.jpg.json  {annotations: {lane: [{lane_id, points}]}}

A clip is a whole test video: its frames cropped by the top ``cut_scale``
of the image, resized to the model's frame and normalized; its lanes
(lanes of fewer than two points skipped, ``lane_id - 1`` the label row)
moved up by the cut and scaled with the frames; the fixed-shape labels of the port's
``geometry.encode_lane_label``. ``db_info.yaml`` is read by
:func:`read_sequences`, not by a YAML library. Frames are decoded by
libjpeg on the CPU (bit-equal to the JAX package's native loader) and by
nvJPEG on the card (``native_loader``); the reader runs on the card unless
it is given ``device="cpu"``. The frame size, the cut and the label rows
are the model configuration's. Train mode (the ``max_skip`` curriculum and
``TrainAugment``) is not ported yet.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

import numpy as np

from ..config import ModelConfig
from ..geometry import encode_lane_label
from .native_loader import ClipDecoder, jpeg_dims
from .transforms import scale_lanes

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


class VIL100Dataset:
    """Test videos of VIL-100 under ``<root>/VIL100`` (``train=True``
    raises), read for a model of configuration ``cfg`` (its ``img_h``,
    ``img_w``, ``cut_scale``, ``max_lanes`` and lane spec). ``device``:
    where frames are decoded and returned as a float32 tensor (None: the
    card)."""

    def __init__(self, root: str, cfg: ModelConfig, train: bool = False,
                 device=None):
        if train:
            raise NotImplementedError(
                "VIL100Dataset reads the test split only: train mode (the "
                "max_skip curriculum and TrainAugment without OpenCV) is "
                "not ported yet")
        self.cfg = cfg
        self.decode = ClipDecoder(device)
        root = os.path.join(root, "VIL100")
        self.imgdir = os.path.join(root, "JPEGImages")
        self.jsondir = os.path.join(root, "Json")
        db = read_sequences(os.path.join(root, "data", "db_info.yaml"))
        self.videos = [s["name"] for s in db if s["set"] == "test"]

    def __len__(self):
        return len(self.videos)

    def __getitem__(self, idx: int) -> Dict:
        vid = self.videos[idx]
        jsonfolder = os.path.join(self.jsondir, vid)
        frames = sorted(name[:5] for name in os.listdir(jsonfolder))
        paths = [os.path.join(self.imgdir, vid, n + ".jpg") for n in frames]
        ori_h, ori_w = jpeg_dims(paths[0])
        cut = int(ori_h * self.cfg.cut_scale)
        imgs = self.decode(paths, cut, self.cfg.img_h, self.cfg.img_w)

        labels, points = [], []
        for name in frames:
            with open(os.path.join(jsonfolder, name + ".jpg.json")) as f:
                info = json.load(f)
            lanes0, lane_ids = [], []
            for lane in info["annotations"]["lane"]:
                pts = np.array([(p[0], p[1] - cut) for p in lane["points"]],
                               np.float32)
                if len(pts) < 2:
                    continue
                lanes0.append(pts)
                lane_ids.append(lane["lane_id"] - 1)
            lanes = scale_lanes(lanes0, ori_h - cut, ori_w, self.cfg.img_h,
                                self.cfg.img_w)
            labels.append(encode_lane_label(
                [list(map(tuple, p[np.argsort(-p[:, 1])])) for p in lanes],
                lane_ids, self.cfg.lane, self.cfg.img_h, self.cfg.img_w,
                self.cfg.max_lanes))
            points.append(lanes)
        return {"name": vid, "frames": imgs, "labels": np.stack(labels),
                "points": points, "size": (ori_h, ori_w), "cut": cut,
                "frame_names": frames}

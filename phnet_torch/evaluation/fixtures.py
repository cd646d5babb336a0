"""Frozen evaluation fixtures: datalists + shape lists (own copy of
``phnet_tpu/evaluation/fixtures.py``, without PyYAML or OpenCV:
``db_info.yaml`` is read by ``data.vil100.read_sequences`` and image
shapes come from the JPEG headers).

The reference pins its test-set enumeration so scoring is byte-reproducible
without re-listing the dataset: ``evaluation/datalistVIL.txt`` /
``datalistOL.txt`` (one ``<video>/<frame>`` per line), the same lists as
``datalist*.pickle``, and ``shape_list.pickle`` (a parallel list of
per-frame image shapes). This module freezes, loads, and applies such
fixtures — and reads the reference's own pickles unchanged, so a run
against the real datasets scores the exact same frame set in the exact
same order.

Score against one with ``python -m phnet_torch.run.evaluate --datalist
<file>``. The reference's ``.pickle`` fixtures are read with ``pickle``,
as the reference writes them: load only files of a trusted source.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

Shape = Tuple[int, ...]


def enumerate_vil100(root: str, split: str = "test") -> List[str]:
    """``<video>/<frame>`` entries for a VIL-100 split, in sorted order
    (reference ``dataV3.py:79-99`` enumeration)."""
    from ..data.vil100 import read_sequences

    base = os.path.join(root, "VIL100")
    seqs = read_sequences(os.path.join(base, "data", "db_info.yaml"))
    entries = []
    for seq in seqs:
        if seq["set"] != split:
            continue
        vid = seq["name"]
        jdir = os.path.join(base, "Json", vid)
        for name in sorted(os.listdir(jdir)):
            entries.append(f"{vid}/{name[:5]}")
    return entries


def enumerate_openlane(root: str, split: str = "validation") -> List[str]:
    """``<video>/<frame>`` entries for an OpenLane-V split
    (reference ``openlane/perprocess.py`` enumeration order)."""
    base = os.path.join(root, "OpenLane", "OpenLane-V", "label", split)
    entries = []
    for vid in sorted(os.listdir(base)):
        for name in sorted(os.listdir(os.path.join(base, vid))):
            if name.endswith(".pickle"):
                entries.append(f"{vid}/{name[:-7]}")
    return entries


def read_shapes(root: str, entries: Sequence[str], img_subdir: str,
                ext: str = ".jpg") -> List[Shape]:
    """Per-frame image shapes, parallel to ``entries`` (the reference's
    ``shape_list.pickle`` layout: a list of (h, w, c) tuples, c = 3 as
    ``cv2.imread`` gives), from the JPEG headers; an unreadable image
    raises."""
    from ..data.native_loader import jpeg_dims

    return [(*jpeg_dims(os.path.join(root, img_subdir, e + ext)), 3)
            for e in entries]


def freeze(entries: Sequence[str], out_dir: str, name: str,
           shapes: Optional[Sequence[Shape]] = None) -> Dict[str, str]:
    """Write ``datalist<name>.txt`` + ``.pickle`` (+ ``shape_list.pickle``)
    in the reference's exact formats. Returns the written paths."""
    os.makedirs(out_dir, exist_ok=True)
    txt = os.path.join(out_dir, f"datalist{name}.txt")
    pkl = os.path.join(out_dir, f"datalist{name}.pickle")
    with open(txt, "w") as f:
        f.write("\n".join(entries) + ("\n" if entries else ""))
    with open(pkl, "wb") as f:
        pickle.dump(list(entries), f)
    out = {"txt": txt, "pickle": pkl}
    if shapes is not None:
        if len(shapes) != len(entries):
            raise ValueError(f"{len(shapes)} shapes for {len(entries)} "
                             f"entries")
        sp = os.path.join(out_dir, "shape_list.pickle")
        with open(sp, "wb") as f:
            pickle.dump([tuple(s) for s in shapes], f)
        out["shape_list"] = sp
    return out


def load_datalist(path: str) -> List[str]:
    """Load a datalist fixture — ours or the reference's (.txt or .pickle)."""
    if path.endswith(".pickle") or path.endswith(".pkl"):
        with open(path, "rb") as f:
            entries = pickle.load(f)
        return [str(e) for e in entries]
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def load_shape_list(path: str) -> List[Shape]:
    with open(path, "rb") as f:
        return [tuple(s) for s in pickle.load(f)]


def pairs_from_datalist(
    entries: Sequence[str], pred_dir: str, anno_dir: str,
    suffix: str = ".lines.txt",
) -> List[Tuple[str, str]]:
    """(pred, anno) file pairs in fixture order — every fixture entry is
    scored whether or not a prediction file exists (a missing prediction
    counts its GT lanes as FN, matching the reference evaluator)."""
    return [
        (os.path.join(pred_dir, e + suffix), os.path.join(anno_dir, e + suffix))
        for e in entries
    ]


def datalist_from_anno_dir(anno_dir: str,
                           suffix: str = ".lines.txt") -> List[str]:
    """Fallback enumeration from emitted annotation files (when no frozen
    fixture is supplied)."""
    out = []
    for af in sorted(glob.glob(os.path.join(anno_dir, "*", "*" + suffix))):
        vid = os.path.basename(os.path.dirname(af))
        out.append(f"{vid}/{os.path.basename(af)[: -len(suffix)]}")
    return out

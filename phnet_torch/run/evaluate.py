"""Offline evaluation command line (counterpart of the root
``evaluate.py``: the reference's ``evaluation/evaluate_iou.py``,
``evaluateVIL.py`` and ``evalTemporal*.py`` in one).

Scores emitted ``.lines.txt`` prediction directories against annotation
directories with the CULane F1 / mIoU metric at each ``--ious`` threshold,
and with ``--temporal`` the temporal stability metric Rs/Rj/Rm. With
``--native`` the CULane numbers come from the native evaluator, which
raises where it does not build (there is no fallback); the temporal
metric is always the Python one. Prints what ``evaluate.py`` prints.

    python -m phnet_torch.run.evaluate --pred-dir .../pred_txt \\
        --anno-dir .../anno_txt --height 720 --width 1280 \\
        [--temporal] [--native] [--datalist datalistVIL.txt]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from collections import defaultdict
from typing import Dict, Optional, Sequence


def collect(pred_dir: str, anno_dir: str) -> Dict:
    """{video: [(pred file, anno file), ...]} over ``anno_dir``."""
    videos = defaultdict(list)
    for af in sorted(glob.glob(os.path.join(anno_dir, "*", "*.lines.txt"))):
        vid = os.path.basename(os.path.dirname(af))
        videos[vid].append((os.path.join(pred_dir, vid, os.path.basename(af)),
                            af))
    return videos


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(prog="python -m phnet_torch.run.evaluate")
    ap.add_argument("--pred-dir", required=True)
    ap.add_argument("--anno-dir", required=True)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--lane-width", type=int, default=30)
    ap.add_argument("--ious", type=float, nargs="+", default=[0.5, 0.8])
    ap.add_argument("--temporal", action="store_true")
    ap.add_argument("--native", action="store_true",
                    help="score with the native evaluator (raises where it "
                         "does not build)")
    ap.add_argument("--datalist", default=None,
                    help="frozen datalist fixture (.txt or .pickle; ours or "
                         "the reference's) pinning the frame set and order")
    args = ap.parse_args(argv)

    from ..evaluation.culane_metric import aggregate_results, culane_metric
    from ..evaluation.emit import read_lines_txt
    from ..evaluation.temporal import aggregate_temporal, temporal_metric_video

    if args.datalist:
        from ..evaluation.fixtures import load_datalist, pairs_from_datalist

        entries = load_datalist(args.datalist)
        videos = defaultdict(list)
        for e, pair in zip(entries, pairs_from_datalist(
                entries, args.pred_dir, args.anno_dir)):
            videos[e.split("/", 1)[0]].append(pair)
    else:
        videos = collect(args.pred_dir, args.anno_dir)
    if not videos:
        raise SystemExit("no annotation files found")
    shape = (args.height, args.width, 3)
    out: Dict = {"native": {}, "python": {}, "temporal": None}

    if args.native:
        from ..evaluation.native_eval import evaluate_pairs

        all_pairs = [p for pairs in videos.values() for p in pairs]
        for iou in args.ious:
            res = evaluate_pairs(all_pairs, args.width, args.height,
                                 args.lane_width, iou)
            out["native"][iou] = res
            print(f"[native] IoU@{iou}:", res)
        if not args.temporal:
            return out

    data = {vid: [(read_lines_txt(pf), read_lines_txt(af))
                  for pf, af in pairs] for vid, pairs in videos.items()}
    for iou in args.ious:
        results = [culane_metric(pred, anno, shape, args.lane_width, iou)
                   for pairs in data.values() for pred, anno in pairs]
        agg = aggregate_results(results)
        out["python"][iou] = agg
        print(f"IoU@{iou}:", {k: round(v, 4) for k, v in agg.items()})

    if args.temporal:
        counts = []
        for pairs in data.values():
            preds = [p for p, _ in pairs]
            annos = [a for _, a in pairs]
            counts.append(temporal_metric_video(
                annos, preds, [shape] * len(pairs), args.lane_width, 0.5))
        out["temporal"] = aggregate_temporal(counts)
        print("temporal:", {k: round(v, 4) for k, v in
                            out["temporal"].items()})
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)

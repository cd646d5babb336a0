"""VIL-100 inference command line (counterpart of the root ``test_vil.py``,
the reference's ``testVIL.py``): whole test videos through the model with
temporal memory, CULane ``.lines.txt`` emission, the frames a second;
``--evaluate`` scores the emission with the Python CULane metric after.

On a dataset (not ``--synthetic``) the pipeline writes the ground truth
to ``--anno-dir`` in the image's frame, the predictions' (the JSON's
points, before the cut), as the reference's ``generate_anno`` does, so
``--evaluate`` scores the real F1.

    python -m phnet_torch.run.test_vil --data-root ./dataset \\
        --checkpoint models/VIL100/best [--evaluate] [--quantize w8]
    python -m phnet_torch.run.test_vil --synthetic --train-first 300

On the card unless ``--device cpu``. ``main(argv, cfg)`` takes a
configuration in place of ``vil100_config()`` (the tests' small one).
"""

from __future__ import annotations

import glob
import os
import sys
from typing import Dict, Optional, Sequence

from .common import (common_parser, load_weights, resolve_quantize,
                     synthetic_dataset, with_quantize)


def evaluate_emission(pred_dir: str, anno_dir: str, shape=None) -> Dict:
    """The Python CULane metric over ``pred_dir`` against ``anno_dir``, as
    ``test_vil.py --evaluate`` computes it: the raster is ``shape`` or,
    when None, the first annotation file's extent."""
    from ..evaluation.culane_metric import aggregate_results, culane_metric
    from ..evaluation.emit import read_lines_txt

    results = []
    for pf in sorted(glob.glob(os.path.join(pred_dir, "*", "*.lines.txt"))):
        af = pf.replace(pred_dir, anno_dir)
        pred, anno = read_lines_txt(pf), read_lines_txt(af)
        if shape is None:
            ys = [p[1] for lane in anno for p in lane] or [720]
            xs = [p[0] for lane in anno for p in lane] or [1280]
            shape = (int(max(ys)) + 1, int(max(xs)) + 1, 3)
        results.append(culane_metric(pred, anno, shape))
    return aggregate_results(results)


def main(argv: Optional[Sequence[str]] = None, cfg=None) -> Dict:
    ap = common_parser("python -m phnet_torch.run.test_vil",
                       "evaluation/txt/pred_txt", 25)
    ap.add_argument("--anno-dir", default="evaluation/txt/anno_txt")
    ap.add_argument("--train-first", type=int, default=0,
                    help="synthetic smoke: overfit N steps before testing")
    ap.add_argument("--evaluate", action="store_true")
    args = ap.parse_args(argv)
    resolve_quantize(ap, args)

    from ..config import vil100_config
    from ..device import resolve_device
    from ..pipeline import InferencePipeline

    cfg = cfg or vil100_config()
    device = resolve_device(args.device)
    if args.synthetic:
        dataset = synthetic_dataset(cfg, args)
        chunk = min(args.chunk, args.synthetic_frames)
    else:
        from ..data.vil100 import VIL100Dataset

        dataset = VIL100Dataset(args.data_root, cfg.model, device=device)
        chunk = args.chunk
    state_dict = load_weights(cfg, args, dataset, device)

    # inference-only: the weights above are float32
    pipe = InferencePipeline(with_quantize(cfg, args.quantize), state_dict,
                             chunk=chunk, device=device)
    stats = pipe.run_and_emit(dataset, args.pred_dir, args.anno_dir,
                              fmt="vil", verbose=True)
    print(f"overall: {stats['frames']} frames at {stats['fps']:.1f} fps")
    out = {"stats": stats, "metric": None}
    if args.evaluate:
        shape = ((cfg.model.img_h, cfg.model.img_w, 3) if args.synthetic
                 else None)
        out["metric"] = evaluate_emission(args.pred_dir, args.anno_dir,
                                          shape)
        print("CULane metric:", {k: round(v, 4)
                                 for k, v in out["metric"].items()})
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)

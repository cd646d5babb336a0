"""OpenLane-V inference command line (counterpart of the root
``test_ol.py``, the reference's ``testOL.py`` / ``testOLV3.py``):
16-frame chunks with the memory reset at each (the reference's per-call
reset; ``--carry-memory`` carries it), half-scale CULane emission shifted
back by the crop.

    python -m phnet_torch.run.test_ol --data-root ./dataset \\
        --checkpoint models/OpenLane/best [--variant multiscale]
    python -m phnet_torch.run.test_ol --synthetic

``--variant`` picks the head: ``single`` (``Router4OL``), ``multiscale``
(``Router4OLV2``) or ``propagate`` (``Router4OLV3``). On the card unless
``--device cpu``. ``main(argv, cfg)`` takes a configuration in place of
the variant's preset (the tests' small one).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

from .common import (common_parser, load_weights, resolve_quantize,
                     synthetic_dataset, with_quantize)

VARIANTS = {"single": "openlane_config",
            "multiscale": "openlane_multiscale_config",
            "propagate": "openlane_propagate_config"}


def main(argv: Optional[Sequence[str]] = None, cfg=None) -> Dict:
    ap = common_parser("python -m phnet_torch.run.test_ol",
                       "evaluation/txt4OL/pred_txt", 16)
    ap.add_argument("--anno-dir", default=None)
    ap.add_argument("--n-offsets", type=int, default=72)
    ap.add_argument("--carry-memory", action="store_true",
                    help="carry temporal memory across chunks instead of the "
                         "reference's per-chunk reset")
    ap.add_argument("--variant", choices=tuple(VARIANTS), default="single",
                    help="head variant: single (Router4OL), multiscale "
                         "(Router4OLV2), propagate (Router4OLV3 cross-frame "
                         "prior propagation)")
    args = ap.parse_args(argv)
    resolve_quantize(ap, args)

    from .. import config
    from ..device import resolve_device
    from ..pipeline import InferencePipeline

    cfg = cfg or getattr(config, VARIANTS[args.variant])(
        n_offsets=args.n_offsets)
    device = resolve_device(args.device)
    if args.synthetic:
        dataset = synthetic_dataset(cfg, args)
        chunk = min(args.chunk, args.synthetic_frames)
    else:
        from ..data.openlane import OpenLaneDataset

        dataset = OpenLaneDataset(args.data_root, cfg.model, device=device)
        chunk = args.chunk
    state_dict = load_weights(cfg, args, dataset, device)

    pipe = InferencePipeline(
        with_quantize(cfg, args.quantize), state_dict, chunk=chunk,
        memory_window=cfg.model.memory.window,
        reset_memory_per_chunk=not args.carry_memory, device=device)
    stats = pipe.run_and_emit(dataset, args.pred_dir, args.anno_dir,
                              fmt="ol", verbose=True)
    print(f"overall: {stats['frames']} frames at {stats['fps']:.1f} fps")
    return {"stats": stats}


if __name__ == "__main__":
    main()
    sys.exit(0)

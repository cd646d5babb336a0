"""Command line of the port's OpenLane-V training (the flags of
``train_ol.py`` the port has):

    python -m phnet_torch.train.openlane --data-root ./dataset \\
        --workdir models/openlane_torch [--variant propagate]
    python -m phnet_torch.train.openlane --synthetic --epochs 2 --frames 4

``--variant`` picks the head, as ``train_ol.py`` does: ``single`` (the
default, ``Router4OL``: :func:`~phnet_torch.config.openlane_config`),
``multiscale`` (``Router4OLV2``: ``openlane_multiscale_config``) or
``propagate`` (``Router4OLV3``: ``openlane_propagate_config``), each with
``--n-offsets``, in bfloat16 unless ``--fp32``, on one card (``--device
cpu`` for the CPU, the reader too). On the dataset, the training videos
of ``<data-root>/OpenLane`` through the train-mode reader (the clip flip
and reversal, ``TrainAugment.ol_defaults`` on the card) and the
prefetching loader, as ``train_ol.py:87-115``; ``--synthetic`` trains on
generated clips. Runs over several devices are not ported yet and exit
with a message saying so.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .cli import check_common, common_parser, run

PROG = "phnet_torch.train.openlane"
VARIANTS = {"single": "openlane_config",
            "multiscale": "openlane_multiscale_config",
            "propagate": "openlane_propagate_config"}


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = common_parser("python -m phnet_torch.train.openlane",
                       "models/OpenLane")
    ap.add_argument("--n-offsets", type=int, default=72)
    ap.add_argument("--variant", choices=tuple(VARIANTS), default="single",
                    help="head variant: single (Router4OL), multiscale "
                         "(Router4OLV2), propagate (Router4OLV3 cross-frame "
                         "prior propagation)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    check_common(args, PROG, "OpenLane-V", "OpenLane")
    from .. import config

    def dataset(cfg, frames):
        from ..data.openlane import OpenLaneDataset
        from ..data.transforms import TrainAugment

        m, t = cfg.model, cfg.train
        return OpenLaneDataset(
            args.data_root, m, train=True, device=args.device,
            sampled_frames=frames, max_skip=t.max_skip,
            skip_increment=t.skip_increment,
            samples_per_video=t.samples_per_video,
            augment=TrainAugment.ol_defaults(m.img_h, m.img_w))

    make_cfg = getattr(config, VARIANTS[args.variant])
    return run(make_cfg(n_offsets=args.n_offsets), args, dataset)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

"""Command line of the port's OpenLane-V training (the flags of
``train_ol.py`` the port has):

    python -m phnet_torch.train.openlane --data-root ./dataset \\
        --workdir models/openlane_torch [--variant propagate]
    python -m phnet_torch.train.openlane --synthetic --epochs 2 --frames 4

``--variant`` picks the head, as ``train_ol.py`` does: ``single`` (the
default, ``Router4OL``: :func:`~phnet_torch.config.openlane_config`),
``multiscale`` (``Router4OLV2``: ``openlane_multiscale_config``) or
``propagate`` (``Router4OLV3``: ``openlane_propagate_config``), each with
``--n-offsets``, in bfloat16 unless ``--fp32``, on the card (``--device
cpu`` for the CPU, the reader too). On the dataset, the training videos
of ``<data-root>/OpenLane`` through the train-mode reader (the clip flip
and reversal, ``TrainAugment.ol_defaults`` on the card) and the
prefetching loader, as ``train_ol.py:87-115``; ``--synthetic`` trains on
generated clips. Over several devices (``--devices N``, the multi-host
flags, ``torchrun``) as :mod:`phnet_torch.train.cli` sets out.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .cli import check_common, common_parser, openlane_dataset, run

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


def main(argv: Optional[Sequence[str]] = None, cfg=None):
    """The command line on ``argv``; ``cfg`` in place of the variant's
    preset where given (a smaller configuration)."""
    args = parse_args(argv)
    from .. import config

    cfg = cfg or getattr(config, VARIANTS[args.variant])(
        n_offsets=args.n_offsets)
    check_common(args, PROG, "OpenLane-V", "OpenLane",
                 cfg.train.train_batch)
    return run(cfg, args, openlane_dataset)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

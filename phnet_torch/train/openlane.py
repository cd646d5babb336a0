"""Command line of the port's OpenLane-V training (the flags of
``train_ol.py`` the port has):

    python -m phnet_torch.train.openlane --synthetic --epochs 2 \\
        --frames 4 --workdir models/openlane_torch

``--variant single`` (the default) trains ``Router4OL``
(:func:`~phnet_torch.config.openlane_config` with ``--n-offsets``), in
bfloat16 unless ``--fp32``, on one card (``--device cpu`` for the CPU).
The multi-scale (``Router4OLV2``) and prior-propagation (``Router4OLV3``)
variants, training on OpenLane-V itself and runs over several devices
are not ported yet and exit with a message saying so.
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
                    help="head variant: single (Router4OL); multiscale "
                         "(Router4OLV2) and propagate (Router4OLV3) are "
                         "not ported yet")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if args.variant != "single":
        raise SystemExit(f"{PROG}: --variant {args.variant} "
                         f"({VARIANTS[args.variant]}) training is not ported "
                         "yet; the port trains --variant single")
    check_common(args, PROG, "OpenLane-V")
    from ..config import openlane_config

    return run(openlane_config(n_offsets=args.n_offsets), args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

"""Command line of the port's VIL-100 training (the flags of
``train_vil.py`` the port has):

    python -m phnet_torch.train --synthetic --epochs 2 --frames 4 \\
        --workdir models/vil100_torch

bfloat16 compute on one card, as ``train_vil.py`` trains; ``--fp32`` for
float32, ``--device cpu`` for the CPU. Training on VIL-100 itself
(``--data-root`` without ``--synthetic``), the dynamic-k assigner and
runs over several devices are not ported yet and raise.
:mod:`phnet_torch.train.openlane` is OpenLane-V's command line.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from .cli import check_common, common_parser, run


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = common_parser("python -m phnet_torch.train", "models/VIL100")
    ap.add_argument("--assigner", default="hungarian",
                    choices=("hungarian", "dynamic_k"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    prog = "phnet_torch.train"
    check_common(args, prog, "VIL-100")
    if args.assigner != "hungarian":
        raise SystemExit(f"{prog}: --assigner {args.assigner} is not ported "
                         "yet; the port trains with 'hungarian'")
    from ..config import vil100_config

    return run(vil100_config(), args)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

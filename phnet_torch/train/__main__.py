"""Command line of the port's VIL-100 training (the flags of
``train_vil.py`` the port has):

    python -m phnet_torch.train --data-root ./dataset \\
        --workdir models/vil100_torch [--assigner dynamic_k]
    python -m phnet_torch.train --synthetic --epochs 2 --frames 4

On the dataset, the train videos of ``<data-root>/VIL100`` through the
train-mode reader (``TrainAugment`` on the card, the preset's
``samples_per_video``, ``max_skip`` and its curriculum) and the
prefetching loader, as ``train_vil.py:89-118``; ``--synthetic`` trains on
generated clips. bfloat16 compute, as ``train_vil.py`` trains;
``--fp32`` for float32, ``--device cpu`` for the CPU (the reader too).
``--assigner`` picks the training assigner (Hungarian, or the dynamic-k
match). Over several devices, one rank a device:

    python -m phnet_torch.train --synthetic --devices 4 --batch 4
    python -m phnet_torch.train ... --coordinator host0:29500 \
        --num-processes 2 --process-id 0      # on each host, its own id
    torchrun --nproc-per-node 4 -m phnet_torch.train ...

(see :mod:`phnet_torch.train.cli`). :mod:`phnet_torch.train.openlane` is
OpenLane-V's command line.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Sequence

from .cli import check_common, common_parser, run, vil_dataset


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = common_parser("python -m phnet_torch.train", "models/VIL100")
    ap.add_argument("--assigner", default="hungarian",
                    choices=("hungarian", "dynamic_k"),
                    help="training label assigner (ModelConfig."
                         "train_assigner)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, cfg=None):
    """The command line on ``argv``; ``cfg`` in place of
    ``vil100_config()`` where given (a smaller configuration)."""
    args = parse_args(argv)
    from ..config import vil100_config

    cfg = cfg or vil100_config()
    check_common(args, "phnet_torch.train", "VIL-100", "VIL100",
                 cfg.train.train_batch)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, train_assigner=args.assigner))
    return run(cfg, args, vil_dataset)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

"""Command line of the port's VIL-100 training (the flags of
``train_vil.py`` the port has):

    python -m phnet_torch.train --data-root ./dataset \\
        --workdir models/vil100_torch [--assigner dynamic_k]
    python -m phnet_torch.train --synthetic --epochs 2 --frames 4

On the dataset, the train videos of ``<data-root>/VIL100`` through the
train-mode reader (``TrainAugment`` on the card, the preset's
``samples_per_video``, ``max_skip`` and its curriculum) and the
prefetching loader, as ``train_vil.py:89-118``; ``--synthetic`` trains on
generated clips. bfloat16 compute on one card, as ``train_vil.py``
trains; ``--fp32`` for float32, ``--device cpu`` for the CPU (the reader
too). ``--assigner`` picks the training assigner (Hungarian, or the
dynamic-k match). Runs over several devices are not ported yet and exit
with a message saying so. :mod:`phnet_torch.train.openlane` is
OpenLane-V's command line.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Sequence

from .cli import check_common, common_parser, run


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = common_parser("python -m phnet_torch.train", "models/VIL100")
    ap.add_argument("--assigner", default="hungarian",
                    choices=("hungarian", "dynamic_k"),
                    help="training label assigner (ModelConfig."
                         "train_assigner)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    check_common(args, "phnet_torch.train", "VIL-100", "VIL100")
    from ..config import vil100_config

    cfg = vil100_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, train_assigner=args.assigner))

    def dataset(cfg, frames):
        from ..data.transforms import TrainAugment
        from ..data.vil100 import VIL100Dataset

        m, t = cfg.model, cfg.train
        return VIL100Dataset(
            args.data_root, m, train=True, device=args.device,
            sampled_frames=frames, max_skip=t.max_skip,
            skip_increment=t.skip_increment,
            samples_per_video=t.samples_per_video,
            augment=TrainAugment(m.img_h, m.img_w))

    return run(cfg, args, dataset)


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

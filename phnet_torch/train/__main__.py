"""Command line of the port's training (the flags of ``train_vil.py`` this
slice has):

    python -m phnet_torch.train --synthetic --epochs 2 --frames 4 \\
        --workdir models/vil100_torch

Float32 on one card (``--device cpu`` for the CPU). Training on VIL-100
itself (``--data-root`` without ``--synthetic``), the dynamic-k assigner
and runs over several devices are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m phnet_torch.train")
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--workdir", default="models/VIL100")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames per clip (default: sampled_frames)")
    ap.add_argument("--batch", type=int, default=None, help="clips per step")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-videos", type=int, default=4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--init", default=None,
                    help="weights-only init checkpoint name ('best' or an "
                         "epoch)")
    ap.add_argument("--accum", type=int, default=1,
                    help="micro-batches per optimizer update")
    ap.add_argument("--assigner", default="hungarian",
                    choices=("hungarian", "dynamic_k"))
    ap.add_argument("--devices", type=int, default=1,
                    help="cards to train on (one in this slice)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    if not args.synthetic:
        raise SystemExit("phnet_torch.train: training on VIL-100 "
                         f"(--data-root {args.data_root or './dataset'}) is "
                         "not ported yet; pass --synthetic")
    if args.assigner != "hungarian":
        raise SystemExit(f"phnet_torch.train: --assigner {args.assigner} is "
                         "not ported yet; the port trains with 'hungarian'")
    if args.devices != 1:
        raise SystemExit(f"phnet_torch.train: --devices {args.devices}: "
                         "training on more than one device is not ported "
                         "yet")

    from ..config import vil100_config
    from ..data import ClipLoader, SyntheticVideoDataset
    from .trainer import train

    cfg = vil100_config()
    tcfg = dataclasses.replace(
        cfg.train, epochs=args.epochs or cfg.train.epochs,
        accum_steps=args.accum)
    cfg = dataclasses.replace(cfg, train=tcfg)
    frames = args.frames or tcfg.sampled_frames
    m = cfg.model
    dataset = SyntheticVideoDataset(
        n_videos=args.synthetic_videos, frames_per_video=frames,
        img_h=m.img_h, img_w=m.img_w, spec=m.lane, max_lanes=m.max_lanes,
        skip_increment=tcfg.skip_increment,
        max_training_skip=tcfg.max_training_skip)
    loader = ClipLoader(dataset, batch_size=args.batch or tcfg.train_batch,
                        seed=tcfg.seed)
    _, history = train(cfg, dataset, loader, args.workdir,
                       resume=args.resume, initial=args.init,
                       device=args.device)
    print(f"done; epoch losses: {[round(h, 4) for h in history]}")
    return history


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)

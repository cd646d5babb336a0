"""What the two training command lines share (``python -m
phnet_torch.train`` for VIL-100, :mod:`phnet_torch.train.openlane` for
OpenLane-V): their common flags, the refusals of what the port cannot run
yet, and the training run both end in, on the dataset under
``--data-root`` or on synthetic clips.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np


def common_parser(prog: str, workdir: str) -> argparse.ArgumentParser:
    """The flags both training command lines take."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--data-root", default="./dataset",
                    help="the directory holding the dataset's tree")
    ap.add_argument("--workdir", default=workdir)
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
    ap.add_argument("--fp32", action="store_true",
                    help="float32 compute (default: bfloat16, as the JAX "
                         "package's trainers)")
    ap.add_argument("--devices", type=int, default=1,
                    help="cards to train on (one in this slice)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def check_common(args, prog: str, dataset: str, subdir: str):
    """SystemExit for what the port cannot run yet, and for a data root
    without the dataset's directory ``subdir``."""
    if args.devices != 1:
        raise SystemExit(f"{prog}: --devices {args.devices}: training on "
                         "more than one device is not ported yet")
    where = os.path.join(args.data_root, subdir)
    if not args.synthetic and not os.path.isdir(where):
        raise SystemExit(f"{prog}: no {dataset} at {where}; pass the "
                         f"directory holding {subdir}/ as --data-root, or "
                         "--synthetic")


def run(cfg, args, real_dataset):
    """Train ``cfg`` with the command line's settings on synthetic clips,
    or on ``real_dataset(cfg, frames)`` (the train-mode reader of
    ``--data-root``) through the prefetching loader; prints the epoch
    losses and the steps' wall time and data wait, and returns the epoch
    losses."""
    from ..data import ClipLoader, SyntheticVideoDataset
    from .trainer import train

    if not args.fp32:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))
    tcfg = dataclasses.replace(
        cfg.train, epochs=args.epochs or cfg.train.epochs,
        accum_steps=args.accum)
    cfg = dataclasses.replace(cfg, train=tcfg)
    frames = args.frames or tcfg.sampled_frames
    m = cfg.model
    if args.synthetic:
        dataset = SyntheticVideoDataset(
            n_videos=args.synthetic_videos, frames_per_video=frames,
            img_h=m.img_h, img_w=m.img_w, spec=m.lane,
            max_lanes=m.max_lanes, skip_increment=tcfg.skip_increment,
            max_training_skip=tcfg.max_training_skip)
    else:
        dataset = real_dataset(cfg, frames)
    loader = ClipLoader(dataset, batch_size=args.batch or tcfg.train_batch,
                        seed=tcfg.seed)
    timings = []
    _, history = train(cfg, dataset, loader, args.workdir,
                       resume=args.resume, initial=args.init,
                       device=args.device, timings=timings)
    if timings:
        # the first step of a process pays the warm-up (cuDNN's plans, the
        # allocator, the loader's first clip): report it apart
        data, wall = (np.array(x) for x in zip(*(timings[1:] or timings)))
        print(f"steps {len(timings)}: wall p50 {np.median(wall):.4f} s, "
              f"data wait {data.sum():.4f} s of {wall.sum():.4f} s (share "
              f"{data.sum() / max(wall.sum(), 1e-12):.4f}) after the first; "
              f"first step {timings[0][1]:.4f} s, data {timings[0][0]:.4f} s")
    print(f"done; epoch losses: {[round(h, 4) for h in history]}")
    return history

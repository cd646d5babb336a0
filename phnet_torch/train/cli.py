"""What the two training command lines share (``python -m
phnet_torch.train`` for VIL-100, :mod:`phnet_torch.train.openlane` for
OpenLane-V): their common flags, the refusals of what the port cannot run
yet, and the synthetic training run both end in.
"""

from __future__ import annotations

import argparse
import dataclasses


def common_parser(prog: str, workdir: str) -> argparse.ArgumentParser:
    """The flags both training command lines take."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--data-root", default=None)
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


def check_common(args, prog: str, dataset: str):
    """SystemExit for what the port cannot run yet."""
    if not args.synthetic:
        raise SystemExit(f"{prog}: training on {dataset} (--data-root "
                         f"{args.data_root or './dataset'}) is not ported "
                         "yet; pass --synthetic")
    if args.devices != 1:
        raise SystemExit(f"{prog}: --devices {args.devices}: training on "
                         "more than one device is not ported yet")


def run(cfg, args):
    """Train ``cfg`` with the command line's settings on synthetic clips;
    returns the epoch losses."""
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

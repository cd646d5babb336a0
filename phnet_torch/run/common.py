"""What the two inference command lines share: their common flags, the
weights (a port checkpoint, a reference checkpoint, a synthetic overfit or
a seeded random draw), the quantize mode and the synthetic dataset."""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict

import torch


def common_parser(prog: str, pred_dir: str, chunk: int
                  ) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--data-root", default="./dataset")
    ap.add_argument("--checkpoint", default=None,
                    help="a checkpoint of phnet_torch.train: "
                         "<workdir>/<name>, name 'best' or an epoch")
    ap.add_argument("--torch-checkpoint", default=None,
                    help="reference RouterWithB .pth(.tar) checkpoint to "
                         "import (unpickled: load only trusted files)")
    ap.add_argument("--pred-dir", default=pred_dir)
    ap.add_argument("--chunk", type=int, default=chunk)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-videos", type=int, default=2)
    ap.add_argument("--synthetic-frames", type=int, default=8)
    ap.add_argument("--int8", action="store_true",
                    help="shorthand for --quantize int8")
    ap.add_argument("--quantize", choices=("none", "int8", "w8"),
                    default="none",
                    help="DynamicConv-chain quantization: int8 = dynamic "
                         "w8a8, w8 = weight-only int8 (the w8 matmul "
                         "kernel on the card); inference-only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def resolve_quantize(ap, args):
    if args.int8:
        if args.quantize not in ("none", "int8"):
            ap.error("--int8 conflicts with --quantize %s" % args.quantize)
        args.quantize = "int8"


def synthetic_dataset(cfg, args):
    from ..data import SyntheticVideoDataset

    m = cfg.model
    return SyntheticVideoDataset(
        n_videos=args.synthetic_videos,
        frames_per_video=args.synthetic_frames, img_h=m.img_h,
        img_w=m.img_w, spec=m.lane, max_lanes=m.max_lanes)


def first_clip(dataset) -> Dict:
    return (dataset.get_clip(0) if hasattr(dataset, "get_clip")
            else dataset[0])


def load_weights(cfg, args, dataset, device) -> Dict[str, torch.Tensor]:
    """The run's ``state_dict``: ``--torch-checkpoint`` (imported),
    ``--checkpoint`` (weights of a port checkpoint), ``--train-first N``
    steps of overfitting the first clip from a seeded draw, or the seeded
    draw itself."""
    from ..train.state import create_train_state

    if args.torch_checkpoint:
        from ..models import PHNet
        from ..utils.torch_import import import_reference_checkpoint

        ckpt = torch.load(args.torch_checkpoint, map_location="cpu",
                          weights_only=False)
        target = PHNet(cfg.model, device="cpu").state_dict()
        print(f"imported reference checkpoint {args.torch_checkpoint}")
        return import_reference_checkpoint(ckpt, target)
    if args.checkpoint:
        from ..train.checkpoint import CheckpointManager

        name = os.path.basename(args.checkpoint)
        if name.endswith(".pt"):
            name = name[:-3]
        payload = CheckpointManager(
            os.path.dirname(args.checkpoint) or ".").restore(name, "cpu")
        return {**payload["params"], **payload["batch_stats"]}
    train_first = getattr(args, "train_first", 0)
    state = create_train_state(
        dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, learning_rate=2e-3)),
        max(train_first * 10, 1), device, seed=0)
    if train_first > 0:
        from ..losses import LaneCriterion
        from ..train.step import make_train_step

        clip = first_clip(dataset)
        frames = torch.as_tensor(clip["frames"])[None].to(
            next(state.model.parameters()).device)
        labels = torch.from_numpy(clip["labels"])[None].to(frames.device)
        step = make_train_step(LaneCriterion(cfg.model, cfg.train.loss))
        for i in range(train_first):
            state, metrics = step(state, frames, labels, i)
            if i % 100 == 0:
                print(f"overfit step {i}: loss "
                      f"{float(metrics['loss']):.4f}", flush=True)
    return {k: v.detach().cpu() for k, v in
            state.model.state_dict().items()}


def with_quantize(cfg, mode: str):
    if mode == "none":
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, quantize=mode))

"""What the two training command lines share (``python -m
phnet_torch.train`` for VIL-100, :mod:`phnet_torch.train.openlane` for
OpenLane-V): their common flags, the refusals of what the port cannot
run, their readers of ``--data-root``, and the training run both end in,
on the dataset or on synthetic clips.

More than one device is data-parallel training, one process a device
(:mod:`phnet_torch.parallel.multihost`), as ``train_vil.py`` trains over
a mesh:

* ``--devices N`` starts N local ranks (spawned processes), one a card,
  or N gloo processes on the CPU with ``--device cpu``;
* ``--coordinator host:port --num-processes P --process-id i`` makes this
  process rank i of P (the JAX trainers' multi-host flags); under
  ``torchrun`` the group comes from its environment instead.

``--batch`` is the global batch: each rank loads ``batch / world`` clips
of its shard (``ClipLoader(num_shards=world, shard_index=rank)``), and a
batch that the world size does not divide exits. Its default is the
preset's ``train_batch``, or the world size where that is larger (one
clip a rank, as ``train_vil.py`` defaults to one clip a device).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket

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
    ap.add_argument("--batch", type=int, default=None,
                    help="clips per step over every rank (the global batch)")
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
                    help="local ranks to start, one a card (gloo CPU "
                         "processes with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    # multi-host: every host runs this same command with its own
    # --process-id (train_vil.py:38-44)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 for multi-process training")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap


def under_torchrun() -> bool:
    """The process was started by ``torchrun`` (its group variables are
    set)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def _world(args) -> int:
    if args.devices > 1:
        return args.devices
    if args.num_processes:
        return args.num_processes
    if under_torchrun():
        return int(os.environ["WORLD_SIZE"])
    return 1


def check_common(args, prog: str, dataset: str, subdir: str,
                 train_batch: int = 1):
    """SystemExit for flags that do not go together, for a global batch
    (``--batch``, else the larger of ``train_batch`` and the world size)
    that the world size does not divide, and for a data root without the
    dataset's directory ``subdir``."""
    if args.devices < 1:
        raise SystemExit(f"{prog}: --devices {args.devices}: at least one")
    group = (args.coordinator, args.num_processes, args.process_id)
    if any(x is not None for x in group) and None in group:
        raise SystemExit(f"{prog}: --coordinator, --num-processes and "
                         "--process-id go together")
    if args.devices > 1 and (args.num_processes or under_torchrun()):
        raise SystemExit(f"{prog}: --devices {args.devices} starts its own "
                         "ranks; with --num-processes or under torchrun "
                         "each process is one rank")
    world = _world(args)
    batch = global_batch(args, train_batch)
    if batch % world:
        raise SystemExit(f"{prog}: a global batch of {batch} clips does not "
                         f"split over {world} ranks")
    where = os.path.join(args.data_root, subdir)
    if not args.synthetic and not os.path.isdir(where):
        raise SystemExit(f"{prog}: no {dataset} at {where}; pass the "
                         f"directory holding {subdir}/ as --data-root, or "
                         "--synthetic")


def global_batch(args, train_batch: int) -> int:
    """Clips a step over every rank."""
    return args.batch or max(train_batch, _world(args))


def vil_dataset(args, cfg, frames):
    """The train-mode VIL-100 reader of ``--data-root``."""
    from ..data.transforms import TrainAugment
    from ..data.vil100 import VIL100Dataset

    m, t = cfg.model, cfg.train
    return VIL100Dataset(
        args.data_root, m, train=True, device=args.device,
        sampled_frames=frames, max_skip=t.max_skip,
        skip_increment=t.skip_increment,
        samples_per_video=t.samples_per_video,
        augment=TrainAugment(m.img_h, m.img_w))


def openlane_dataset(args, cfg, frames):
    """The train-mode OpenLane-V reader of ``--data-root``."""
    from ..data.openlane import OpenLaneDataset
    from ..data.transforms import TrainAugment

    m, t = cfg.model, cfg.train
    return OpenLaneDataset(
        args.data_root, m, train=True, device=args.device,
        sampled_frames=frames, max_skip=t.max_skip,
        skip_increment=t.skip_increment,
        samples_per_video=t.samples_per_video,
        augment=TrainAugment.ol_defaults(m.img_h, m.img_w))


def run(cfg, args, real_dataset):
    """Train ``cfg`` with the command line's settings on synthetic clips,
    or on ``real_dataset(args, cfg, frames)`` (the train-mode reader of
    ``--data-root``) through the prefetching loader; one process, the
    ranks that ``--devices`` starts, or this process as one rank of a
    group. Rank 0 prints the epoch losses and the steps' wall time and
    data wait, and the epoch losses are returned (rank 0's, where
    ``--devices`` started the ranks)."""
    if not args.fp32:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype="bfloat16"))
    tcfg = dataclasses.replace(
        cfg.train, epochs=args.epochs or cfg.train.epochs,
        accum_steps=args.accum)
    cfg = dataclasses.replace(cfg, train=tcfg)
    if args.devices > 1:
        return _launch(cfg, args, real_dataset)
    if args.num_processes or under_torchrun():
        from ..parallel.multihost import initialize, shutdown

        device = initialize(args.coordinator, args.num_processes,
                            args.process_id, device=args.device)
        try:
            return _train(cfg, args, real_dataset, device)
        finally:
            shutdown()
    return _train(cfg, args, real_dataset, args.device)


def free_port() -> int:
    """A free TCP port of this host (the group's rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(cfg, args, real_dataset):
    """``--devices N``: N spawned ranks of a group at a free local port;
    rank i on ``cuda:i`` (or gloo on the CPU, each with its share of the
    host's threads). A rank that fails fails the run. Returns rank 0's
    epoch losses."""
    import torch.multiprocessing as mp

    n = args.devices
    ranks = [argparse.Namespace(**vars(args)) for _ in range(n)]
    port = free_port()
    for i, a in enumerate(ranks):
        a.devices, a.process_id, a.num_processes = 1, i, n
        a.coordinator = f"127.0.0.1:{port}"
    result = mp.get_context("spawn").SimpleQueue()
    mp.start_processes(_rank, args=(cfg, ranks, real_dataset, result),
                       nprocs=n, join=True, start_method="spawn")
    return result.get()


def _rank(i, cfg, ranks, real_dataset, result):
    """Rank ``i`` of :func:`_launch`."""
    import torch

    from ..parallel.multihost import initialize, shutdown

    args = ranks[i]
    os.environ["LOCAL_RANK"] = str(i)
    if args.device is not None and torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // args.num_processes))
    device = initialize(args.coordinator, args.num_processes, i,
                        device=args.device)
    try:
        history = _train(cfg, args, real_dataset, device)
    finally:
        shutdown()
    if i == 0:
        result.put(history)


def _train(cfg, args, real_dataset, device):
    """One process's training run (a rank's, in a group)."""
    from ..data import ClipLoader, SyntheticVideoDataset
    from ..parallel.multihost import data_index, data_size, rank
    from .trainer import train

    tcfg, m = cfg.train, cfg.model
    frames = args.frames or tcfg.sampled_frames
    if args.synthetic:
        dataset = SyntheticVideoDataset(
            n_videos=args.synthetic_videos, frames_per_video=frames,
            img_h=m.img_h, img_w=m.img_w, spec=m.lane,
            max_lanes=m.max_lanes, skip_increment=tcfg.skip_increment,
            max_training_skip=tcfg.max_training_skip)
    else:
        dataset = real_dataset(args, cfg, frames)
    shards = data_size()  # the ranks of one model group load alike
    loader = ClipLoader(dataset, batch_size=global_batch(
        args, tcfg.train_batch) // shards, seed=tcfg.seed, num_shards=shards,
        shard_index=data_index())
    timings = []
    _, history = train(cfg, dataset, loader, args.workdir,
                       resume=args.resume, initial=args.init,
                       device=device, timings=timings)
    if rank() != 0:
        return history
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

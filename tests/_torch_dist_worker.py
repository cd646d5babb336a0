"""Ranks of the port's multi-process tests, and their one-process twins.

It imports ``phnet_torch`` only (never JAX). Each case is a function of the
rank's share of a problem drawn with numpy from a seed; run without a
process group (world size 1) it is the one-process computation on the
global batch. :func:`run_ranks` starts the ranks of a gloo group on the CPU
as subprocesses:

    python tests/_torch_dist_worker.py <case> <rank> <world> <port> <out> [arg]

each rank writing its results to ``<out>.<rank>.pt``. Cases:

* ``bn``: ``bn_train_normalize`` on the rank's rows of a global batch and
  its backward under the same rows of a global cotangent, then the group
  helpers (:func:`bn_case`);
* ``train``: ``phnet_torch.train.trainer.train`` of the small VIL model in
  float32 with dropout on: an epoch of two steps, then a second epoch
  resumed from the first's checkpoint at ``accum_steps`` 2
  (:func:`train_case`); its results are a record of every step and the
  state after each epoch; :func:`forced_step` runs a recorded step again
  in one process on the global batch (:func:`global_batch`);
* ``cli``: ``python -m phnet_torch.train --synthetic --devices 2 --device
  cpu`` on the small configuration (the command line starts its own
  ranks; no group here);
* ``tp_layers``: the model axis's sharded Linear, Conv1d and Conv2d
  (``phnet_torch.parallel.tensor``), split on the output and on the first
  dimension, forward and backward on problems drawn from a seed
  (:func:`tp_layers_case`);
* ``tp_train``: the trainer on a ``(data, model)`` mesh of the group's
  ranks, at the JAX dry run's ``min_size`` (:func:`tp_train_case`): each
  step recorded with whole tensors (the sharded ones gathered).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import torch

RANK_TIMEOUT_S = 120  # a rank that has not ended by then is a failure


def small_cfg(accum_steps: int = 1, dropout: float = 0.1):
    """The small VIL configuration of the tests (``__graft_entry__``'s
    dry-run geometry: 64x128 frames, 32 priors, 12 offsets; widths 16),
    float32, with decoder dropout, a checkpoint every epoch."""
    from phnet_torch import config as c

    model = c.ModelConfig(
        img_h=64, img_w=128, lane=c.LaneSpec(n_offsets=12, n_lengths=2),
        backbone=c.BackboneConfig(in_channels=(8, 16, 24, 32)),
        neck=c.NeckConfig(in_channels=(16, 24, 32), out_channels=16,
                          num_outs=3),
        head=c.HeadConfig(num_priors=32, sample_points=8, fc_hidden_dim=16,
                          prior_feat_channels=16, decoder_ffn_dim=32,
                          decoder_dropout=dropout),
        memory=c.MemoryConfig(window=0),
        test=c.TestParams(conf_threshold=0.3, nms_thres=20.0, nms_topk=4),
        max_lanes=4)
    train = dataclasses.replace(c.TrainConfig(), epoch_per_test=1,
                                accum_steps=accum_steps)
    return c.Config(model=model, train=train)


# -- the cases ---------------------------------------------------------------

def bn_problem(seed: int = 0, shape=(4, 6, 5, 7)):
    """x [N, C, H, W] with a per-channel offset and spread, scale, bias and
    a cotangent, float32."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    spread = rng.uniform(0.5, 3.0, c)[None, :, None, None]
    x = (rng.normal(size=shape) * spread
         + rng.normal(size=c)[None, :, None, None]).astype(np.float32)
    return dict(x=x, scale=(1 + rng.normal(0, 0.2, c)).astype(np.float32),
                bias=rng.normal(0, 0.2, c).astype(np.float32),
                g=rng.normal(size=shape).astype(np.float32))


def bn_case(out: dict):
    """The BatchNorm case, then the group helpers: a module whose ranks
    start apart (``check_same_bits`` must raise on every rank), then
    :func:`broadcast_module` and the check again, and
    :func:`all_reduce_mean` of a rank-dependent buffer."""
    from phnet_torch.ops.batchnorm import bn_train_normalize
    from phnet_torch.parallel.multihost import (all_reduce_mean,
                                                broadcast_module,
                                                check_same_bits, rank,
                                                world_size)

    p = bn_problem()
    b = p["x"].shape[0] // world_size()
    rows = slice(rank() * b, (rank() + 1) * b)
    x = torch.from_numpy(p["x"][rows]).requires_grad_(True)
    scale = torch.from_numpy(p["scale"]).requires_grad_(True)
    bias = torch.from_numpy(p["bias"]).requires_grad_(True)
    y, mean, var = bn_train_normalize(x, scale, bias)
    y.backward(torch.from_numpy(p["g"][rows]))
    out.update(y=y.detach(), mean=mean, var=var, dx=x.grad,
               dscale=scale.grad, dbias=bias.grad)
    module = torch.nn.BatchNorm2d(3)
    module.running_mean.fill_(float(rank()))
    try:
        check_same_bits(module)
        out["apart_raised"] = False
    except RuntimeError:
        out["apart_raised"] = True
    broadcast_module(module)
    check_same_bits(module)
    out["running_mean"] = module.running_mean.clone()
    out["mean_of_ranks"] = all_reduce_mean(
        torch.arange(3, dtype=torch.float32) + rank())


def train_loader(cfg, epoch: int):
    """The synthetic dataset of :func:`train_case`'s epoch ``epoch`` and
    this rank's loader over it (the whole global batch with one
    process)."""
    from phnet_torch.data import ClipLoader, SyntheticVideoDataset
    from phnet_torch.parallel.multihost import rank, world_size

    m, t = cfg.model, cfg.train
    ds = SyntheticVideoDataset(
        n_videos=4 * EPOCHS[epoch], frames_per_video=2, img_h=m.img_h,
        img_w=m.img_w,
        spec=m.lane, max_lanes=m.max_lanes, skip_increment=t.skip_increment,
        max_training_skip=t.max_training_skip)
    return ds, ClipLoader(ds, batch_size=EPOCHS[epoch] * 2 // world_size(),
                          seed=t.seed, num_shards=world_size(),
                          shard_index=rank(), prefetch=0)


EPOCHS = {1: 1, 2: 2}  # epoch: its accum_steps (2 clips a micro-batch)


def train_case(out: dict, workdir: str):
    """The small model through the trainer on synthetic clips: epoch 1 at
    ``accum_steps`` 1 (two steps of 2 clips), then epoch 2 resumed from
    epoch 1's checkpoint at ``accum_steps`` 2 (two steps of 2
    micro-batches of 2 clips). Each step's record (``out["steps"]``): the state before it
    (parameters, buffers, the optimizer's state and the step count), its
    batch, dropout seed and accumulation, the rate of its update, and what
    it gave (loss, gradient norm, the gradient that the update used, the
    parameters and buffers after it)."""
    from phnet_torch.train import trainer

    steps = []
    make_step = trainer.make_train_step

    def copy(sd):
        return {k: v.detach().clone() for k, v in sd.items()}

    def recording(criterion, accum):
        step = make_step(criterion, accum)

        def run(state, frames, labels, seed):
            rec = dict(before=copy(state.model.state_dict()),
                       opt=copy_opt(state.optimizer.state_dict()),
                       step=state.step, frames=frames.clone(),
                       labels=labels.clone(), seed=seed, accum=accum,
                       lr=state.optimizer.lr())
            state, metrics = step(state, frames, labels, seed)
            rec.update(loss=metrics["loss"].item(),
                       grad_norm=metrics["grad_norm"].item(),
                       grads={n: p.grad.detach().clone() for n, p in
                              state.model.named_parameters()},
                       after=copy(state.model.state_dict()))
            steps.append(rec)
            return state, metrics

        return run

    trainer.make_train_step = recording
    try:
        for epoch, accum in EPOCHS.items():
            cfg = small_cfg(accum)
            ds, loader = train_loader(cfg, epoch)
            state, history = trainer.train(cfg, ds, loader, workdir,
                                           epochs=epoch, resume=epoch > 1,
                                           device="cpu", verbose=False)
            out[f"history{epoch}"] = history
            out[f"state{epoch}"] = copy(state.model.state_dict())
    finally:
        trainer.make_train_step = make_step
    out["steps"] = steps


def copy_opt(sd):
    """A deep copy of an optimizer's ``state_dict``."""
    import copy as _copy

    return _copy.deepcopy(sd)


def same_bits(a, b) -> bool:
    """Nested payloads (dicts, lists, tensors, numbers) equal bit for
    bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_bits(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_bits(x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(
                    a.reshape(-1).view(torch.uint8),
                    b.reshape(-1).view(torch.uint8)))
    return a == b


def restored(rec):
    """A one-process training state holding the state before ``rec`` (a
    step record of :func:`train_case`), its optimizer at the record's
    rate."""
    from phnet_torch.train.state import create_train_state

    state = create_train_state(small_cfg(rec["accum"],
                                         rec.get("dropout", 0.1)), 1, "cpu")
    state.model.load_state_dict(rec["before"])
    state.optimizer.load_state_dict(copy_opt(rec["opt"]))
    state.optimizer.schedule = lambda _: rec["lr"]
    state.step = rec["step"]
    return state


def forced_step(rec, frames, labels):
    """One process's step on the global batch ``frames``, ``labels`` from
    the state before ``rec``, at the record's rate, accumulation and
    dropout seed: (loss, gradient norm, gradients, parameters and buffers
    after it)."""
    from phnet_torch.losses.criterion import LaneCriterion
    from phnet_torch.train.step import make_train_step

    cfg = small_cfg(rec["accum"], rec.get("dropout", 0.1))
    state = restored(rec)
    step = make_train_step(LaneCriterion(cfg.model, cfg.train.loss),
                           rec["accum"])
    state, metrics = step(state, frames, labels, rec["seed"])
    return dict(loss=metrics["loss"].item(),
                grad_norm=metrics["grad_norm"].item(),
                grads={n: p.grad.detach().clone() for n, p in
                       state.model.named_parameters()},
                after={k: v.detach().clone()
                       for k, v in state.model.state_dict().items()})


def update_of(rec):
    """The parameters that the optimizer makes, from the state before
    ``rec``, of the gradient that ``rec`` reports."""
    state = restored(rec)
    for n, p in state.model.named_parameters():
        p.grad = rec["grads"][n].clone()
    state.optimizer.step()
    return {n: p.detach() for n, p in state.model.named_parameters()}


def global_batch(records):
    """The ranks' batches of one step (their records, in rank order) as
    one global batch whose micro-batch k holds every rank's micro-batch
    k, in rank order."""
    accum_steps = records[0]["accum"]
    parts = {"frames": [], "labels": []}
    for key in parts:
        for k in range(accum_steps):
            for rec in records:
                x = rec[key]
                mb = x.shape[0] // accum_steps
                parts[key].append(x[k * mb:(k + 1) * mb])
    return torch.cat(parts["frames"]), torch.cat(parts["labels"])


def cli_case(out: dict, workdir: str):
    from phnet_torch.train import __main__ as vil_cli

    history = vil_cli.main(
        ["--synthetic", "--epochs", "1", "--frames", "2",
         "--synthetic-videos", "4", "--batch", "2", "--fp32", "--devices",
         "2", "--device", "cpu", "--workdir", workdir], cfg=small_cfg())
    out["history"] = history


# -- the model axis ------------------------------------------------------------

TP_MIN_SIZE = 1024  # the JAX dry run's ``shard_params(..., min_size=1024)``

# name: (module kind, constructor arguments, input shape); the flax kernel's
# last dimension is odd where the rule falls back to its first
TP_LAYERS = {
    "linear_out": ("linear", (6, 8), (3, 4, 6)),
    "linear_first": ("linear", (8, 5), (3, 4, 8)),
    "conv2d_out": ("conv2d", dict(in_channels=3, out_channels=4,
                                  kernel_size=3, padding=1), (2, 3, 7, 6)),
    "conv2d_first": ("conv2d", dict(in_channels=3, out_channels=5,
                                    kernel_size=(4, 3), stride=(2, 1),
                                    padding=(2, 1)), (2, 3, 9, 6)),
    "conv2d_depthwise_out": ("conv2d", dict(in_channels=4, out_channels=4,
                                            kernel_size=3, padding=1,
                                            groups=4), (2, 4, 5, 5)),
    "conv1d_out": ("conv1d", dict(in_channels=3, out_channels=6,
                                  kernel_size=3, padding=1), (2, 3, 9)),
    "conv1d_first": ("conv1d", dict(in_channels=3, out_channels=3,
                                    kernel_size=4, padding=2,
                                    dilation=2), (2, 3, 11)),
}


def tp_layer(name: str, seed: int = 0):
    """The whole layer ``name`` of :data:`TP_LAYERS` with weights drawn
    from ``seed``, its input and an output cotangent (float32)."""
    kind, args, xshape = TP_LAYERS[name]
    torch.manual_seed(seed)
    layer = (torch.nn.Linear(*args) if kind == "linear" else
             torch.nn.Conv2d(**args) if kind == "conv2d" else
             torch.nn.Conv1d(**args))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.from_numpy(rng.normal(size=p.shape).astype(
                np.float32)))
    x = torch.from_numpy(rng.normal(size=xshape).astype(np.float32))
    with torch.no_grad():
        shape = layer(x).shape
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return layer, x, g


def tp_layers_case(out: dict):
    """Every layer of :data:`TP_LAYERS` sharded by ``shard_module`` (the
    JAX rule at ``min_size`` 1) over a mesh of the group's ranks all on
    ``model``: each layer's placement, output, input gradient and whole
    parameter gradients; a bf16 input through the first layer."""
    from phnet_torch.parallel import init_axes, make_mesh, shard_module
    from phnet_torch.parallel.multihost import world_size
    from phnet_torch.parallel.tensor import gather_like, placement

    mesh = make_mesh(devices=["cpu"] * world_size(),
                     model_parallel=world_size())
    init_axes(mesh)
    for name in TP_LAYERS:
        layer, x, g = tp_layer(name)
        box = torch.nn.ModuleDict({"layer": layer})
        out[f"{name}/held"] = shard_module(box, mesh, min_size=1)
        x.requires_grad_(True)
        y = layer(x)
        y.backward(g)
        out[f"{name}/placement"] = placement(layer.weight)
        out[f"{name}/y"] = y.detach()
        out[f"{name}/dx"] = x.grad
        for leaf in ("weight", "bias"):
            p = getattr(layer, leaf)
            out[f"{name}/d{leaf}"] = gather_like(p.grad, placement(p))
    layer, x, _ = tp_layer("linear_out")
    shard_module(torch.nn.ModuleDict({"layer": layer}), mesh, min_size=1)
    out["bf16"] = layer(x.bfloat16()).detach()


def tp_loader(cfg, epoch: int, clips: int = 2):
    """The synthetic dataset of :func:`tp_train_case`'s epoch ``epoch``
    (one step of ``clips`` clips of 2 frames) and this rank's loader, a
    shard a data row."""
    from phnet_torch.data import ClipLoader, SyntheticVideoDataset
    from phnet_torch.parallel.multihost import data_index, data_size

    m, t = cfg.model, cfg.train
    ds = SyntheticVideoDataset(
        n_videos=clips, frames_per_video=2, img_h=m.img_h, img_w=m.img_w,
        spec=m.lane, max_lanes=m.max_lanes, skip_increment=t.skip_increment,
        max_training_skip=t.max_training_skip, seed=epoch)
    return ds, ClipLoader(ds, batch_size=clips // data_size(), seed=t.seed,
                          num_shards=data_size(), shard_index=data_index(),
                          prefetch=0)


def tp_train_case(out: dict, workdir: str, model_parallel: str,
                  dropout: str, first: str, last: str):
    """The small VIL model through the trainer on a ``(world / m, m)``
    mesh of the group's ranks (``m = model_parallel``; no mesh with one
    process), decoder dropout ``dropout``, with ``TP_MIN_SIZE`` set to
    :data:`TP_MIN_SIZE`: epochs ``first`` to ``last`` of one step each,
    the first from ``workdir/init.pt``'s weights where it is epoch 1 and
    the file exists, every later one resumed from the checkpoint before
    it. Each step's record (``out["steps"]``) holds whole tensors, as
    :func:`train_case`'s; ``out["local{epoch}"]`` the rank's own
    parameters and buffers after each epoch (sharded ones as blocks),
    ``out["placements"]`` the sharded parameters' placements and
    ``out["held"]`` what the port holds whole that the rule splits."""
    from phnet_torch.parallel import mesh as pmesh
    from phnet_torch.parallel import init_axes, make_mesh, shard_params
    from phnet_torch.parallel.multihost import world_size
    from phnet_torch.parallel.tensor import (full_state_dict, gather_like,
                                             placement)
    from phnet_torch.train import trainer

    pmesh.TP_MIN_SIZE = TP_MIN_SIZE
    whole = lambda model: {k: v.clone() for k, v in  # noqa: E731
                           full_state_dict(model).items()}
    mesh = None if world_size() == 1 else make_mesh(
        devices=["cpu"] * world_size(), model_parallel=int(model_parallel))
    if mesh is not None:
        init_axes(mesh)  # before the loaders shard over the data axis
    steps = []
    make_step = trainer.make_train_step

    def recording(criterion, accum):
        step = make_step(criterion, accum)

        def run(state, frames, labels, seed):
            model = state.model
            rec = dict(before=whole(model),
                       opt=copy_opt(state.optimizer.state_dict()),
                       step=state.step, frames=frames.clone(),
                       labels=labels.clone(), seed=seed, accum=accum,
                       dropout=float(dropout), lr=state.optimizer.lr())
            state, metrics = step(state, frames, labels, seed)
            rec.update(loss=metrics["loss"].item(),
                       grad_norm=metrics["grad_norm"].item(),
                       grads={n: gather_like(p.grad, placement(p)).clone()
                              for n, p in model.named_parameters()},
                       after=whole(model))
            steps.append(rec)
            return state, metrics

        return run

    trainer.make_train_step = recording
    try:
        for epoch in range(int(first), int(last) + 1):
            cfg = small_cfg(1, float(dropout))
            ds, loader = tp_loader(cfg, epoch)
            initial = ("init" if epoch == 1 and os.path.exists(
                os.path.join(workdir, "init.pt")) else None)
            state, history = trainer.train(
                cfg, ds, loader, workdir, epochs=epoch, resume=epoch > 1,
                initial=initial, device="cpu", verbose=False, mesh=mesh)
            out[f"history{epoch}"] = history
            out[f"local{epoch}"] = {k: v.detach().clone() for k, v in
                                    state.model.state_dict().items()}
    finally:
        trainer.make_train_step = make_step
    out["steps"] = steps
    out["placements"] = {n: placement(p)
                         for n, p in state.model.named_parameters()
                         if placement(p) is not None}
    if mesh is not None:
        decided = shard_params(state.model, mesh)
        out["held"] = sorted(n for n, d in decided.items()
                             if d is not None and n not in out["placements"])


CASES = {"bn": bn_case, "train": train_case, "cli": cli_case,
         "tp_layers": tp_layers_case, "tp_train": tp_train_case}


def one_process(case: str, *args) -> dict:
    """``case`` in this process, without a group: the global batch."""
    out = {}
    CASES[case](out, *args)
    return out


# -- the launcher --------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(case: str, world: int, out_prefix: str, *args,
              timeout: float = RANK_TIMEOUT_S):
    """Start ``world`` gloo ranks of ``case`` at a free port and wait for
    every one; a rank that exits non-zero, or any that has not ended in
    ``timeout`` seconds, fails (every rank's process group is killed).
    Returns each rank's results."""
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         str(port), out_prefix, *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        start_new_session=True) for r in range(world)]
    logs, failed = [], False
    try:
        for p in procs:
            log, _ = p.communicate(timeout=timeout)
            logs.append(log.decode(errors="replace"))
            failed |= p.returncode != 0
    except subprocess.TimeoutExpired:
        failed = True
        logs.append(f"timed out after {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if failed:
        raise AssertionError(f"{case}: a rank failed\n" + "\n---\n".join(
            log[-4000:] for log in logs))
    return [torch.load(f"{out_prefix}.{r}.pt", weights_only=False)
            for r in range(world)]


def main(argv):
    case, r, world, port, out_prefix, *args = argv
    torch.set_num_threads(2)
    out = {}
    if case == "cli":
        CASES[case](out, *args)
    else:
        from phnet_torch.parallel.multihost import initialize, shutdown

        initialize(f"127.0.0.1:{port}", int(world), int(r), device="cpu")
        try:
            CASES[case](out, *args)
        finally:
            shutdown()
    torch.save(out, f"{out_prefix}.{r}.pt")


if __name__ == "__main__":
    main(sys.argv[1:])

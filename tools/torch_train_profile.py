#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on the card.

    python tools/torch_train_profile.py
        [--preset vil100|openlane|openlane_ms|openlane_propagate]
        [--compute-dtype float32|bfloat16] [--batch 1] [--frames 16]
        [--steps 3] [--profile-steps 1] [--no-remat]

Trains the full-width VIL-100 model (or one of OpenLane-V's heads:
``openlane_config``'s ``Router4OL``, ``openlane_multiscale_config``'s
``Router4OLV2``, ``openlane_propagate_config``'s ``Router4OLV3``;
float32 or the JAX trainers' bf16; seeded weights, a fixed
batch of seeded synthetic clips) with ``phnet_torch.train.step`` (remat
per frame, the configuration's default, unless ``--no-remat``): warms
up, times ``--steps`` steps without the profiler, then traces
``--profile-steps`` with ``torch.profiler`` (CPU + CUDA; processing the
trace of one step takes ~1.5 min). Prints the card's name and power
limit, the step wall time with and without the profiler, the device busy
share (kernel time over the wall time without the profiler), kernel
launches a step, the device time a step by group (cuDNN, GEMM, the
Hungarian solve, K2 and its backward, the optimizer, reductions,
elementwise, copies; a kernel launched inside the ``hungarian_assign`` or
``router_chain_backward`` range counts in that group), the top kernels,
and one JSON summary line. torch's TF32 flags are left at their defaults:
the step turns TF32 off itself. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("router_chain (K2)", ("router_chain",)),
    ("optimizer (AdamW)", ("multi_tensor_apply", "adam")),
    ("cudnn conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                    "winograd")),
    ("gemm", ("gemm", "xmma", "cutlass", "cublas")),
    ("reduce / norm / softmax", ("reduce", "norm", "softmax", "welford")),
    ("copy / index / cat", ("copy", "index", "gather", "scatter", "cat",
                            "memcpy", "memset", "fill")),
)


PRESETS = {"vil100": "vil100_config", "openlane": "openlane_config",
           "openlane_ms": "openlane_multiscale_config",
           "openlane_propagate": "openlane_propagate_config"}


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise / other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile-steps", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--preset", choices=tuple(PRESETS), default="vil100")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from phnet_torch.losses import LaneCriterion
    from phnet_torch.train.state import create_train_state
    from phnet_torch.train.step import make_train_step, step_seed

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = chip_smoke.train_config(0.1, PRESETS[args.preset],
                                  compute_dtype=args.compute_dtype,
                                  remat=not args.no_remat)
    state = create_train_state(cfg, 1000, "cuda", seed=0)
    frames, labels = chip_smoke.synthetic_batch(torch, cfg, args.batch,
                                                args.frames)
    frames, labels = frames.cuda(), labels.cuda()
    step = make_train_step(LaneCriterion(cfg.model, cfg.train.loss))

    def one():
        step(state, frames, labels, step_seed(cfg.train.seed, state.step))

    for _ in range(args.warmup):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    prof = chip_smoke.profile_steps(torch, one, args.profile_steps,
                                    group_of)
    dev = prof["device_ms"]
    print(f"{args.preset} {args.compute_dtype}: {args.steps} steps of "
          f"{args.batch} x {args.frames} frames at "
          f"{cfg.model.img_h}x{cfg.model.img_w}, dropout 0.1, "
          f"remat {cfg.model.remat_frames}: "
          f"wall {wall:.1f} ms/step ({prof['profiled_wall_ms']:.1f} under "
          f"the profiler), {args.batch * args.frames / wall * 1e3:.2f} "
          f"clip-frames/s, device kernel time {dev:.1f} ms/step, busy "
          f"share {dev / wall:.3f}, {prof['launches']:.0f} kernel "
          f"launches/step, peak {peak:.1f} MiB [{card}]")
    for group, ms in sorted(prof["by_group"].items(), key=lambda kv: -kv[1]):
        print(f"  {group:26s} {ms:9.3f} ms/step ({ms / dev:.3f} of device "
              f"time)")
    for name, r in prof["ranges"].items():
        print(f"  range {name}: {r['launches']:.0f} launches, "
              f"{r['ms']:.3f} device ms/step, {r['host_ms']:.1f} host "
              f"ms/step under the profiler")
    print("top kernels (ms/step):")
    for name, ms in sorted(prof["by_name"].items(),
                           key=lambda kv: -kv[1])[:12]:
        print(f"  {ms:9.3f}  {name[:110]}")
    print(json.dumps({
        "card": card, "preset": args.preset,
        "compute_dtype": args.compute_dtype, "batch": args.batch,
        "frames": args.frames,
        "steps": args.steps,
        "remat": cfg.model.remat_frames,
        "wall_ms_per_step": wall,
        "profiled_wall_ms_per_step": prof["profiled_wall_ms"],
        "clip_frames_per_s": args.batch * args.frames / wall * 1e3,
        "device_ms_per_step": dev, "busy_share": dev / wall,
        "launches_per_step": prof["launches"], "peak_mib": peak,
        "ranges": prof["ranges"], "group_ms_per_step": prof["by_group"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

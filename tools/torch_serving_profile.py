#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port spends its time on the card.

    python tools/torch_serving_profile.py
        [--preset {vil,openlane,openlane_ms,openlane_propagate}]
        [--streams 4] [--ticks 8] [--quantize {none,w8,int8}]
        [--compute-dtype {float32,bfloat16}]

Serves a full-width model (``--preset``: ``vil100_config``,
``openlane_config``, ``openlane_multiscale_config`` or
``openlane_propagate_config``; the seeded weights
of ``chip_smoke.py``; ``--quantize`` picks the generator chains'
numerics: float32, the w8 matmul kernel, or int8 GEMMs;
``--compute-dtype bfloat16`` the JAX package's mixed precision; above 8
streams the server runs the router chain's bf16 mode) through
``phnet_torch.serving.StreamingServer``, warms up, times ``--ticks``
ticks without the profiler (each tick fetches its lanes, so it waits for
the card), then traces as many with ``torch.profiler`` (CPU + CUDA).
Prints the card's name and power limit, the tick wall time (mean, p50,
p99) with and without the profiler (which adds host time to every
operation), frames/s, the peak device memory, the device busy share
(kernel time over the wall time without the profiler), kernel launches
per tick, the device time by kernel group and the top kernels, and one
JSON summary line.
The TF32 flags are left at torch's defaults, as a user leaves them, and
the model turns TF32 off itself (``phnet_torch.device.full_f32``).
Needs a CUDA card.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("lane_nms", ("lane_nms",)),
    ("router_chain", ("router_chain",)),
    ("w8_matmul", ("w8_matmul",)),
    ("cudnn conv / batchnorm", ("fprop", "conv", "cudnn", "winograd")),
    ("gemm", ("gemm", "xmma", "cutlass", "cublas")),
    ("reduce / norm / softmax", ("reduce", "norm", "softmax", "welford")),
    ("copy / index / cat", ("copy", "index", "gather", "scatter", "cat",
                            "memcpy", "memset", "fill")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise / other"


PRESETS = {"vil": "vil100_config", "openlane": "openlane_config",
           "openlane_ms": "openlane_multiscale_config",
           "openlane_propagate": "openlane_propagate_config"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", choices=tuple(PRESETS), default="vil")
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--quantize", choices=("none", "w8", "int8"),
                    default="none")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke
    from phnet_torch.serving import StreamingServer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = chip_smoke.preset_config(PRESETS[args.preset], args.quantize,
                                   args.compute_dtype)
    server = StreamingServer(cfg, chip_smoke.seeded_state_dict(torch, cfg),
                             max_streams=args.streams)
    sids = [server.attach() for _ in range(args.streams)]
    rng = np.random.default_rng(0)
    shape = (cfg.model.img_h, cfg.model.img_w, 3)
    # frames are drawn before any timing: drawing them costs more host
    # time than a tick
    frames = itertools.cycle([
        {s: rng.normal(size=shape).astype(np.float32) for s in sids}
        for _ in range(2)])

    def tick():
        kept, valid, got = server.step_async(next(frames))
        server.decode(kept, valid, got)

    for _ in range(args.warmup):
        tick()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(args.ticks):
        t0 = time.perf_counter()
        tick()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    plain_wall_ms = sum(walls)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            tick()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name, by_group = defaultdict(float), defaultdict(float)
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] += us
        by_group[group_of(e.name)] += us
    device_ms = sum(by_name.values()) / 1e3
    per_tick = plain_wall_ms / args.ticks
    p50, p99 = np.percentile(walls, 50), np.percentile(walls, 99)
    fps = args.streams * args.ticks / plain_wall_ms * 1e3
    print(f"{args.ticks} ticks of {args.streams} streams, preset "
          f"{args.preset}, quantize={args.quantize}, {args.compute_dtype}, "
          f"router chain bf16 {server.mcfg.head.router_chain_bf16}: wall "
          f"{per_tick:.3f} "
          f"ms/tick (p50 {p50:.3f}, p99 {p99:.3f}; {wall_ms / args.ticks:.3f}"
          f" under the profiler), {fps:.2f} frames/s, peak device memory "
          f"{peak_mib:.1f} MiB, device kernel time "
          f"{device_ms / args.ticks:.3f} ms/tick, busy share "
          f"{device_ms / plain_wall_ms:.3f}, {len(kernels) / args.ticks:.0f} "
          f"kernel launches/tick [{card}]")
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:26s} {us / 1e3 / args.ticks:8.3f} ms/tick "
              f"({us / 1e3 / device_ms:.3f} of device time)")
    print("top kernels (ms/tick):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3 / args.ticks:8.3f}  {name[:110]}")
    print(json.dumps({
        "card": card, "preset": args.preset, "streams": args.streams,
        "ticks": args.ticks, "quantize": args.quantize,
        "compute_dtype": args.compute_dtype,
        "router_chain_bf16": server.mcfg.head.router_chain_bf16,
        "wall_ms_per_tick": per_tick, "wall_ms_p50": p50,
        "wall_ms_p99": p99, "frames_per_s": fps, "peak_mib": peak_mib,
        "profiled_wall_ms_per_tick": wall_ms / args.ticks,
        "device_ms_per_tick": device_ms / args.ticks,
        "busy_share": device_ms / plain_wall_ms,
        "launches_per_tick": len(kernels) / args.ticks,
        "group_ms_per_tick": {g: us / 1e3 / args.ticks
                              for g, us in by_group.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Which collectives a process group runs when two ranks share one card.

Starts two ranks on ``cuda:0`` (``phnet_torch.parallel.multihost.
initialize(..., backend=...)``) and tries each collective that the
model axis could use on CUDA tensors: all-reduce (sum in float32 and
bf16, max and min in int32), broadcast, all-gather (a list and one
tensor), reduce-scatter, a barrier and an all-reduce over a subgroup.
Each rank prints one JSON line: ``{"rank": r, "backend": ..., "ops":
{name: "ok" | "<error>"}}``; a rank that does not end within the time
limit is reported as such. With ``--backend nccl`` this shows what NCCL
does with two ranks of one device. ``--mib N`` also times all-reduce,
all-gather and broadcast of an N MiB float32 CUDA tensor (each rank's
share for the all-gather), the median of 3 after one warm-up, under
``"seconds"``.

    python tools/torch_gloo_cuda_probe.py [--backend gloo|nccl]
        [--timeout 120] [--mib 334]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe(rank: int, world: int, port: int, backend: str,
          mib: float = 0.0) -> dict:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from phnet_torch.parallel.multihost import initialize, shutdown

    ops = {}
    try:
        dev = initialize(f"127.0.0.1:{port}", world, rank, device="cuda:0",
                         backend=backend)
    except Exception as exc:  # the report is the point
        return {"rank": rank, "backend": backend,
                "init": f"{type(exc).__name__}: {str(exc)[:300]}"}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            ops[name] = "ok"
        except Exception as exc:  # the report is the point
            ops[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}"

    x = torch.full((1024,), float(rank + 1), device=dev)

    def reduce_checked(t, op, want):
        y = t.clone()
        dist.all_reduce(y, op=op)
        if not bool((y.float() == want).all()):
            raise AssertionError(f"got {y[:2].tolist()}, want {want}")

    attempt("all_reduce_sum_f32", lambda: reduce_checked(
        x, dist.ReduceOp.SUM, 3.0))
    attempt("all_reduce_sum_bf16", lambda: reduce_checked(
        x.bfloat16(), dist.ReduceOp.SUM, 3.0))
    attempt("all_reduce_max_i32", lambda: reduce_checked(
        x.int(), dist.ReduceOp.MAX, 2.0))
    attempt("all_reduce_min_i32", lambda: reduce_checked(
        x.int(), dist.ReduceOp.MIN, 1.0))
    attempt("broadcast", lambda: dist.broadcast(x.clone(), 0))
    attempt("all_gather", lambda: dist.all_gather(
        [torch.empty_like(x) for _ in range(world)], x))
    attempt("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
        torch.empty(world * x.numel(), device=dev), x))
    attempt("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
        torch.empty(x.numel() // world, device=dev), x))
    attempt("barrier", dist.barrier)

    def subgroup():
        g = dist.new_group(list(range(world)))
        y = x.clone()
        dist.all_reduce(y, group=g)

    attempt("new_group_all_reduce", subgroup)
    seconds = {}
    if mib > 0:
        import time

        n = int(mib * 2 ** 20) // 4 // world * world
        big = torch.ones(n, device=dev)
        part = torch.ones(n // world, device=dev)
        outs = [torch.empty_like(part) for _ in range(world)]
        for name, fn in (("all_reduce", lambda: dist.all_reduce(big)),
                         ("all_gather", lambda: dist.all_gather(outs, part)),
                         ("broadcast", lambda: dist.broadcast(big, 0))):
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            seconds[name] = sorted(times[1:])[1]
    shutdown()
    return {"rank": rank, "backend": backend, "ops": ops,
            "mib": mib, "seconds": seconds}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--backend", default="gloo")
    p.add_argument("--timeout", type=float, default=120.0)
    p.add_argument("--mib", type=float, default=0.0)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        print(json.dumps(probe(args.rank, 2, args.port, args.backend,
                               args.mib)), flush=True)
        return 0
    sys.path.insert(0, REPO)
    from phnet_torch.train.cli import free_port

    port = free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get(
        "GLOO_SOCKET_IFNAME", "lo"), NCCL_SOCKET_IFNAME=os.environ.get(
        "NCCL_SOCKET_IFNAME", "lo"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--backend",
         args.backend, "--rank", str(r), "--port", str(port), "--mib",
         str(args.mib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        start_new_session=True) for r in range(2)]
    for r, proc in enumerate(procs):
        try:
            out, _ = proc.communicate(timeout=args.timeout)
            text = out.decode(errors="replace").strip().splitlines()
            line = next((l for l in reversed(text) if l.startswith("{")),
                        None)
            print(line or json.dumps({"rank": r, "backend": args.backend,
                                      "exit": proc.returncode,
                                      "log": text[-5:]}), flush=True)
        except subprocess.TimeoutExpired:
            print(json.dumps({"rank": r, "backend": args.backend,
                              "timeout_s": args.timeout}), flush=True)
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())

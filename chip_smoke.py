#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``phnet_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit, the torch and CUDA versions;
2. the kernel build from ``phnet_torch/csrc`` (one ``nvcc`` per source, in
   parallel), with the ``ptxas`` register / shared-memory / spill report;
3. lane NMS: the CUDA kernel, through both entries (``nms_keeps`` from
   routed predictions, ``lane_nms`` from proposal rows), against their
   plain PyTorch versions, bit-equal in every output, on 10 streams of
   seeded and adversarial problems (tied scores, all valid, none valid,
   fewer valid than top_k, duplicate lanes, -0.0 and NaN scores) at two
   confidence thresholds; then the main path's 4 streams, timed with CUDA
   events (device time: calls replayed from a CUDA graph; and per call
   from Python, the whole NMS step: softmax and ``nms_keeps``) beside the
   first design's numbers;
4. the router chain: the CUDA kernel against its plain version at the
   serving shapes [B*240, 64, 36], B = 1 and 4 (max |diff| <= 1e-4, and the
   router score within 1e-4), both timed; per B the kernel's plan (planes
   a CTA, grid, threads), its share of the bound and its speed-up over the
   first design;
5. the main path: ``StreamingServer`` with the full-width VIL-100 model
   (seeded random weights), 4 streams, one of them skipping every third
   tick, then a detach and an attach; the kernels' launch counters are
   zeroed just before and read just after, and must show that every tick
   went through both kernels (lane NMS once, the router chain three
   times a tick);
6. end to end: the same weights run a 2-frame clip on the card and on the
   CPU (plain versions there): routed predictions within 1e-3, keep sets
   equal; run with cuDNN's TF32 flag on, torch's default, which the model
   must override itself;
7. the w8 matmul: the CUDA kernel against its plain version at the four
   generator products of a refine stage, 1 and 4 streams, and three
   ragged shapes (max |diff| <= 1e-5 of max |plain|, two calls
   bit-equal), timed beside the
   cuBLAS bf16 GEMM of the same operands; per product its plan (tile
   width, K splits, CTAs), TFLOP/s, share of its bound and ratio to
   cuBLAS, and per stage the sums;
8. the ``quantize="w8"`` server: phase 5's run with the w8 model; the
   counters must show every generator product going through the w8
   kernel (4 per refine stage, 12 a tick, and no more); then the
   ``"int8"`` server,
   whose outputs must be finite;
9. w8 end to end: phase 6 with the w8 model (tolerance in
   :func:`phase_end_to_end`);
10. the clip pipeline: ``InferencePipeline`` with the w8 model over two
    seeded 6-frame clips in chunks of 4, emitting ``.lines.txt`` files;
    the counters must show every frame going through all three kernels;
11. lane NMS at OpenLane-V's shape: phase 3 with OL's lane layout (one
    length field), 72 offsets, top_k 4, confidence 0.5 (the kernel's
    run-time-O path);
12. the w8 matmul at the multi-scale head's 13 products a frame (from
    the preset's DynamicConv chains, ``w8_products``), 1 and 4 streams:
    phase 7's checks (and two calls bit-equal) per product, the sums per
    stage and per frame;
13. ``openlane_config`` (``Router4OL``): phase 5's run at its full width
    (memory window 5, which wraps more than three times over the 20
    ticks), lane NMS once and the router chain three times a tick; phase
    6 with this model (cuDNN's TF32 flag on); then served in w8 (12
    products a tick through K3) and int8;
14. ``openlane_multiscale_config`` (``Router4OLV2``): the same in f32
    (lane NMS once a tick, no router chain: its routers are Conv1d) and
    w8 (13 products a tick through K3);
15. training, card against CPU: the full-width model (seeded weights,
    decoder dropout 0), one synthetic clip of 4 frames, one training step
    on the card and one on the CPU, with cuDNN's TF32 flag on (the step
    must turn it off itself): loss, gradient norm and a sample of gradient
    leaves within bounds taken from the CPU's own spread under a 1e-6
    relative perturbation of the frames, and the Hungarian matches of both
    branches equal (or no more flips than the perturbed CPU run shows);
16. training throughput: the full-width model, 16-frame clips, B = 1 and
    4, dropout 0.1, 1 warm-up and 1 timed step on a fixed batch: step
    wall p50, clip-frames/s, device ms (CUDA events), peak memory, K2
    launches a step (3 a frame forward, again in the remat backward: the
    counter must read exactly that, and K1 and K3 none), then at B = 1
    one step under the profiler of the card's activity alone for launches
    a step and busy share (``tools/torch_train_profile.py`` gives the
    Hungarian solve's and K2's backward device ms); the loss finite and
    lower at the last step than at the first;
17. the trainer: ``phnet_torch.train.trainer.train`` for one epoch of 2
    steps on 2 synthetic 4-frame videos into a temporary directory, then
    resumed for a second epoch: both epochs' losses finite, and the resume
    restores step, epoch and the curriculum's ``max_skip``;
18. the router chain's bf16 mode (the chain the server runs above 8
    streams, a second instance of the same kernel) against
    ``router_chain_plain(bf16=True)`` at 4 and 16 streams, timed beside
    the float32 instance (tolerance in :func:`phase_router_bf16`);
19. the w8 matmul fed bf16 x, as the bf16 model feeds it: the four
    products of a VIL stage at 4 streams, bit-equal to the float32-x call
    on the same values, timed beside cuBLAS's bf16 GEMM;
20. bf16 inference (``compute_dtype="bfloat16"``): VIL served at 4
    streams unquantized and in w8 (lane NMS once, the float32 router chain
    three times and, in w8, the w8 matmul 12 times a tick), each held card
    against CPU (tolerance in :func:`phase_end_to_end`); VIL served in
    float32 at 16 streams, where the server turns the chain's bf16 mode on
    (the counters must show it three times a tick, the float32 mode never),
    held card against CPU with the mode pinned; ``openlane_config`` served
    in bf16 at 4 streams;
21. bf16 training, card against CPU (``vil100_config(compute_dtype=
    "bfloat16")``, the JAX trainers' default; full width, one clip of 4
    frames, cuDNN's TF32 flag on): the card's step and the CPU's steps on
    two one-ulp copies of the frames with the assignment pinned to the
    CPU's matches, gradients per module within twice the CPU's one-ulp
    spread, the loss too, the free matches differing no more than the
    CPU's copies do, the step without remat giving the same loss; K2's
    bf16 mode under autograd 3 times a frame, again in the remat
    recompute, its float32 instance never; then the same with
    ``router_train_chain_f32`` on a 2-frame clip (one one-ulp copy; the
    float32 instance launches, the bf16 mode never);
22. OpenLane-V training (``openlane_config``, ``Router4OL``), card
    against CPU: phase 15 in float32, phase 21 in bf16;
23. training throughput, phase 16's protocol: VIL bf16 at B = 1 and 4
    (``bench.py``'s shapes), OpenLane-V in bf16 (what ``train_ol.py``
    trains by default) at B = 1 without the profiled step;
24. ``python -m phnet_torch.train.openlane --synthetic`` through its
    ``main`` (bf16) for the preset's 5 epochs to its first resumable
    checkpoint, one step of a 2-frame clip an epoch, then resumed for a
    sixth;
25. lane NMS at the prior-propagation head's shape: phase 11 at R = 244
    rows (240 anchors and 4 propagated slots, a partial last warp; the
    main path's streams end in 4 dead rows, cls [20, -20] and xs -2);
26. ``openlane_propagate_config`` (``Router4OLV3``) served at full width,
    phase 5's schedule, in float32, bf16 and w8: lane NMS once a tick,
    K3 12 times a tick in w8 and never otherwise, the router chain never
    (the head routes with per-row MLPs);
27. its card against CPU on a 3-frame clip, float32 (cuDNN's TF32 flag
    on) and bf16, the one-frame carry entering the later frames;
28. ``openlane_multiscale_config(compute_dtype="bfloat16")`` (the encoder
    in bf16, the head in float32) served unquantized and in w8 (K3 13
    times a tick, its x float32), then card against CPU;
29. the multi-scale and prior-propagation heads in training: a step of a
    2-frame clip card against CPU in float32 (phase 15) and bf16 (phase
    21), a timed B = 1, T = 16 bf16 step of each (launches and kernel time
    from one step under the profiler of the card's activity alone), and
    the OL command line's ``main`` with ``--variant multiscale`` and
    ``--variant propagate`` to the first resumable checkpoint and a
    resume; neither head launches K2.

30. the evaluation path's host libraries (``g++``): the nvJPEG decoder and
    the CULane evaluator;
31. the committed fixture (``tests/fixtures/torch_eval``: VIL-100 at
    1280x720, OpenLane-V at 1920x1280) through the port's readers on the
    card: decode ms a frame at each size, and the card's decode (nvJPEG's
    planes, libjpeg's upsampling and colour conversion in PyTorch)
    against the libjpeg decode of the same files (``decoded_u8.npz``);
32. the VIL pipeline in float32 at full width over the fixture's test
    videos, on the card (lane NMS once and the router chain three times a
    frame, counters zeroed just before) and on the CPU: the emitted lines
    compared, both scored with the Python and native CULane metrics and
    the temporal metric (equal scores where the lines are equal), the
    ground truth against itself F1 = 1; the path's frames a second
    (decode + model + emit) beside the model's;
33. the command lines as subprocesses on the fixture, from port
    checkpoints this phase writes: ``python -m phnet_torch.run.test_vil
    --evaluate``, ``run.test_ol --variant single``, ``run.evaluate --native
    --temporal``, each exiting 0;
34. the training augmentation (``TrainAugment`` without OpenCV) on the
    card against the CPU on the same nvJPEG-decoded frames (VIL 1280x720,
    OL 1920x1280): each op alone, then the whole pipeline under 8 seeds;
    its ms a frame on each;
35. the readers' train mode on the card at 384x768, T = 16, on a training
    tree made from the fixture (VIL's train video and an OpenLane
    ``training`` video, 20 frames each), against the CPU readers given
    the same bytes; the reader's and the decode's ms a frame;
36. both training command lines in subprocesses on that tree (bf16, T =
    16, B = 1): VIL with ``--assigner dynamic_k``, OpenLane-V to its first
    resumable checkpoint and a resume: step wall p50 beside phases
    23-24's synthetic step, the loader's wait share, K2 a step.

37. the JAX package's other backbones in ``vil100_config`` at full width
    (:data:`BACKBONES`: RevCol-tiny, the Bottleneck ResNet-50, the
    GroupNorm ResNet-18; seeded weights, RevCol's ``gamma`` widened),
    each served at 4 streams by phase 5's schedule in float32 and bf16
    (lane NMS once and the router chain three times a tick; one tick more
    under the card-only profiler: device ms, launches, busy share), then
    card against CPU on a 2-frame clip (phase 6's gates in float32, phase
    20's in bf16, cuDNN's TF32 flag on);
38. one clip through ``InferencePipeline`` with RevCol in float32;
39. each backbone in training: a float32 step of a 2-frame clip card
    against CPU (phase 15's gates; no drop path), then a timed B = 1,
    T = 16 bf16 step (RevCol with drop path 0.1 and its column
    checkpoint; K2 96 times a step; device ms and launches from one step
    under the card-only profiler);
40. RevCol's column checkpoint: float32 gradients with and without it
    under one drop-path seed within 1e-4 of each leaf's largest entry,
    another seed moving most leaves;
41. data-parallel training at world size 1 on NCCL: the VIL command
    line's ``main`` with ``--coordinator`` (full width, float32, B = 1,
    4-frame clips, 2 steps and a resume) bit-equal to the same run
    without the distributed flags, K2 24 times a step;
42. the server's streams split over a mesh naming the card twice (two
    replicas of 2 streams): keep sets equal to the one-replica server's,
    kept rows and memory within 1e-3, K1 once and K2 three times a
    replica a tick;
43. the training step over a mesh's model axis: two ranks on the card,
    each a process, over gloo (NCCL refuses two ranks of one device),
    data 1 x model 2, full-width VIL in float32 (B = 1, 2-frame clips,
    dropout 0.1, a step and a resumed second, deterministic algorithms)
    with the 31 kernels that ``shard_params`` splits cut in two, against
    the same steps in one process: losses, gradient norms, checkpointed
    parameters and BatchNorm statistics within stated bounds, the ranks'
    bits equal, both runs' checkpoints restored at model 1, K2 12 times a
    step in each rank;
44. the deployment artifact: full-width VIL with 4 streams exported on
    the card in float32 (``export_serving_step``) and in w8 (the command
    line from a port checkpoint), loaded by ``DeployedServer`` and ticked
    8 frames beside a live server with cuDNN's TF32 flag on: keep sets
    and memory masks equal, kept rows and memory within 1e-5 of max
    |live|, K1 once, K2 three times and (w8) K3 12 times a tick launched
    inside the loaded program, whose graph holds the ``phnet::``
    operators; export, save and load seconds, the artifact's MiB and both
    tick walls;
45. the segmentation and flow planes (no kernel on their path): Farneback
    in PyTorch on the card on a 1080x1920 pair moved by a known sub-pixel
    shift (timed) and on the fixture's VIL-100 frames against the CPU;
    lane masks (``write_mask``) and flow JPEGs (``generate_flow_jpgs``,
    nvJPEG) written into a copy of the fixture's VIL-100 tree, read back
    by the reader with ``load_seg`` / ``load_flow`` in test mode and in
    train mode (``TrainAugment`` at p_hflip = p_affine = 1) against the
    CPU's readers on the same bytes and against the CPU's own Farneback
    flow within the JPEG round trip; ``SegDecoder`` on the stacked FPN
    levels and ``WarpModel`` on level 0 with the read flow, card against
    CPU; J and F of the decoder's argmax masks (:func:`phase_planes`).

The phases run in another order than their numbers, and the CPU's side
of every card-against-CPU check (phases 6, 9, 13-15, 20-22, 27-29, 37,
39 and 45) runs in one background process, on as many threads as the
script's own, while the card runs (:class:`CpuReferences`): the phases
that need no CPU run first, then 21-22, 29 and 39-40, whose CPU steps
are the longest, then the command lines' subprocesses (30-36, 41, 43),
then phase 45, which hands the background process the bytes it decoded
(the card's machine has no libjpeg) while it goes on. Each check holds
the background process's weights or clip to the card's by a digest of
their bytes.

The card machine has one card: more than one card's ranks are held on
the CPU only (``tests/test_torch_dist_train.py``,
``tests/test_torch_model_axis.py``).

Phase 18 also holds K2's bf16 mode at one stream (G = 1, the plan of a
B = 1 training step).

Float32 outside the quantized products and the bf16 phases 18-24. The
model turns TF32 off itself (``phnet_torch.device.full_f32``); the script
also turns it off for the plain versions it holds the kernels against.
The line before the last holds one JSON object per kernel (K2's with its
launches in a training step beside its serving launches, and in a step
of the VIL command line on real files, its bf16 mode's
in a bf16 training step; each kernel's
launches and times on the OpenLane-V paths under ``openlane_*`` keys, K1's
at the prior-propagation head's 244 rows under ``propagate_rows_*``, K1's
and K2's launches on the other backbones' paths under ``revcol_*``,
``resnet50_*`` and ``groupnorm_*``, K2's in phase 41's NCCL steps
under ``distributed_training_launches``, K1's and K2's in phase 42's
split server under ``mesh_serving_launches``, K2's in phase 43's ranks
under ``model_axis_training_launches``, each kernel's through phase 44's
artifacts under ``export_launches``; K2's
bf16 mode and K3 at bf16 x as entries of their own); the last line is
``{"ok": true, "device": {...}}``.
Without a card, or without the package beside it, the script exits
non-zero and prints no result.
"""

import contextlib
import dataclasses
import gc
import glob
import hashlib
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s,
# dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TPU_KERNELS = {
    "lane_nms": "phnet_tpu/ops/nms_pallas.py:27 (_nms_kernel)",
    "router_chain": "phnet_tpu/ops/router_pallas.py:180 (_router_blocks_kernel)",
    "w8_matmul": "phnet_tpu/ops/w8_pallas.py:54 (_w8_matmul_kernel)",
}
# K2's device time by streams with its first design (one 256-thread CTA a
# plane, two barriers a LayerNorm), from phase 4 of this script on an
# NVIDIA H100 80GB HBM3 at 700 W: the yardstick of the present design
K2_FIRST_DESIGN_MS = {1: 0.0364, 4: 0.1158}
# K1's first design (a stable sort, the strip windows and the scatter in
# eager PyTorch around a kernel that walked all 240 sorted proposals), at
# 4 streams x 240, from phase 3 of this script on an NVIDIA H100 80GB HBM3
# at 700 W: the kernel's device time, and the whole wrapper's time per call
# from Python over several runs: the yardstick of the present design
K1_FIRST_DESIGN_MS = {"kernel": 0.0177, "wrapper": (0.57, 0.80)}
# the generator products of one VIL refine stage: (name, K, N), M = 240 x
# streams rows
W8_PRODUCTS = (("gen1", 64, 8192), ("gen2_a", 4608, 1024),
               ("gen2_b", 1024, 8192), ("out", 2304, 64))


def make_problem(seed, a=240, n_offsets=36):
    """Seeded NMS problem (copy of tests/test_nms_pallas.py::make_problem)."""
    rng = np.random.default_rng(seed)
    proposals = np.zeros((a, 5 + n_offsets), dtype=np.float32)
    proposals[:, 2] = rng.uniform(0, 0.6, a)
    proposals[:, 4] = rng.uniform(0, 40, a)
    base = rng.uniform(0, 700, (a, 1))
    proposals[:, 5:] = base + rng.normal(0, 40, (a, n_offsets))
    scores = rng.uniform(0, 1, a).astype(np.float32)
    valid = scores >= 0.3
    return proposals, scores, valid


def time_ms(torch, fn, iters=200, warmup=10):
    """Mean time of one fn() call in ms, CUDA events over ``iters`` calls
    made from Python (host time between launches included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_SIDE_STREAM = []


def device_ms(torch, fn, iters=200, per_graph=10):
    """Device time of one fn() call in ms: ``per_graph`` calls captured in
    a CUDA graph, replayed until ``iters`` calls ran, between CUDA events,
    so that the host's time between launches is not counted. One side
    stream serves every capture (cuBLAS keeps a workspace per stream)."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    side = _SIDE_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters // per_graph):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters // per_graph * per_graph)


def bound(nbytes, ops, flops=F32_FLOPS):
    """(least time in ms, what sets it) for moving nbytes and doing ops at
    the peak rate ``flops``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


NMS_KINDS = ("seeded", "tied", "all_valid", "all_invalid", "few_valid",
             "duplicates", "neg_zero", "nan_score", "dead_rows")
DEAD_ROWS = 4  # the prior-propagation head's K slots, the last rows


def nms_stream(kind, seed, a=240, n_offsets=36, conf=0.6, n_lengths=2):
    """One lane-NMS stream of one of ``NMS_KINDS``, from
    :func:`make_problem`: routed predictions [A, 5 + n_lengths + O] in the
    VIL layout (``n_lengths=2``) or OL's (1) (start_y; the length over
    n_strips in column 5; the xs over 767, an image 768 wide), scores [A]
    and the valid flags [A] of the proposals entry (``scores >= conf``,
    and the -0.0 and NaN rows of those kinds)."""
    p, s, _ = make_problem(seed, a, n_offsets)
    rng = np.random.default_rng(seed + 1000)
    forced = []  # rows valid in the proposals entry whatever their score

    def far_apart(rows):  # lanes that suppress nothing
        for n, r in enumerate(rows):
            p[r, 5:] = 100.0 + 300.0 * n + np.arange(n_offsets)

    if kind == "tied":  # scores on a grid of 1/8: many exact ties
        s = np.round(s * 8) / 8
    elif kind == "all_valid":
        s = 0.6 + 0.4 * s
    elif kind in ("all_invalid", "few_valid", "neg_zero", "nan_score"):
        lifted, s = 0.6 + 0.4 * s, s - 1.01  # below any threshold >= 0
        if kind == "few_valid":
            rows = [5, a // 4, a // 4 + 1, a // 2, a - 1]
            s[rows] = lifted[rows]
        elif kind == "neg_zero":  # -0.0 ties a later +0.0 on the same lane
            forced = [3, 7, 11]
            s[forced] = -0.0, 0.0, -0.0
            far_apart([3, 11])
            p[7] = p[3]
        elif kind == "nan_score":  # NaN ranks below every other score
            forced = [2, 9, 30, 31]
            s[forced] = np.nan, 0.7, np.nan, -np.inf
            far_apart(forced)
    elif kind == "duplicates":  # rows n..3n repeat rows 0..2n, scores too
        n = a // 6
        p[n:3 * n], s[n:3 * n] = p[0:2 * n].copy(), s[0:2 * n].copy()
    elif kind not in ("seeded", "dead_rows"):
        raise KeyError(kind)
    col_xs = 5 + n_lengths
    routed = rng.normal(size=(a, col_xs + n_offsets))
    routed[:, 2] = p[:, 2]
    routed[:, 5] = p[:, 4] / (n_offsets - 1)
    routed[:, col_xs:] = p[:, 5:] / 767
    if kind == "dead_rows":  # empty propagated slots: cls [20, -20], zero
        # geometry and length, the xs at -2; their score is the softmax's
        dead = slice(a - DEAD_ROWS, a)
        routed[dead, :2] = 20.0, -20.0
        routed[dead, 2:col_xs] = 0.0
        routed[dead, col_xs:] = -2.0
        s[dead] = np.float32(1.0 / (1.0 + np.exp(40.0)))
    s = s.astype(np.float32)
    valid = (s >= np.float32(conf)) | np.isin(np.arange(a), forced)
    return routed.astype(np.float32), s, valid


def nms_batch(torch, streams, a=240, n_offsets=36, conf=0.6, device="cuda",
              n_lengths=2):
    """routed [B, A, 5 + n_lengths + O], scores [B, A], valid [B, A] on
    ``device`` for streams given as (kind, seed) pairs."""
    made = [nms_stream(k, seed, a, n_offsets, conf, n_lengths)
            for k, seed in streams]
    return tuple(torch.from_numpy(np.stack(x)).to(device)
                 for x in zip(*made))


def nms_ops(routed, valid, keep_idx, n_offsets, img_w, thresh, col_xs=7):
    """f32 operations of the kernel's picks on this data: before each
    pick one key compare a candidate left (the argmax); after it, against
    every candidate left whose strip window overlaps, |x_i - x_j| summed
    over the overlap (3 a point) and one compare."""
    f32 = np.float32
    n_strips = f32(n_offsets - 1)
    start = np.trunc(routed[..., 2] * n_strips + f32(0.5)).astype(np.int64)
    length = routed[..., 5] * n_strips
    end = np.trunc(start.astype(f32) + length - f32(0.5)
                   - (length - f32(1) < 0).astype(f32)).astype(np.int64)
    end = np.minimum(end, n_offsets - 1)
    xs = routed[..., col_xs:col_xs + n_offsets] * f32(img_w - 1)
    ops = 0
    for b in range(routed.shape[0]):
        cand = valid[b].copy()
        for i in keep_idx[b][keep_idx[b] >= 0]:
            ops += int(cand.sum())
            cand[i] = False
            ps = np.maximum(start[b, i], start[b])
            pe = np.minimum(end[b, i], end[b])
            for j in np.nonzero(cand & (pe >= ps))[0]:
                ops += 3 * int(pe[j] - ps[j] + 1) + 1
                lo, hi = max(ps[j], 0), pe[j] + 1
                dist = np.abs(xs[b, i, lo:hi] - xs[b, j, lo:hi]).sum()
                if dist < thresh * (pe[j] - ps[j] + 1):
                    cand[j] = False
    return ops


def chain_ops(n, c, p, blocks):
    """f32 operations of the router chain on n planes: each LayerNorm 7 per
    element, each 3x3 a multiply-add per in-plane tap plus the bias, a ReLU
    per element after each block's first LN and after the residual add."""
    taps = (3 * c - 2) * (3 * p - 2)
    conv = 2 * taps + c * p
    per_plane = 7 * c * p + blocks * (2 * conv + 2 * 7 * c * p + 3 * c * p)
    return n * per_plane


def fingerprint(torch, tensors):
    """A digest of the bytes of ``tensors`` (a name -> tensor mapping), by
    which a phase checks that the background process's CPU side ran on
    the weights or clip that the card ran on."""
    h = hashlib.sha256()
    for name, t in tensors.items():
        t = t.detach().cpu().reshape(-1).contiguous()
        h.update(f"{name} {t.dtype} {t.numel()}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def cpu_job(torch, key, **inline):
    """The CPU side of the card-against-CPU check ``key``:
    ``("end_to_end", ...)`` (:func:`cpu_end_to_end`), ``("train", ...)``
    (:func:`cpu_train`), ``("train_bf16", ...)`` (:func:`cpu_train_bf16`)
    or ``("planes", ...)`` (:func:`cpu_planes`, which takes ``feed``: the
    payloads the card's phase hands over, one a call)."""
    return {"end_to_end": cpu_end_to_end, "train": cpu_train,
            "train_bf16": cpu_train_bf16,
            "planes": cpu_planes}[key[0]](torch, *key[1:], **inline)


def cpu_worker(keys, out_dir, results, threads, inputs):
    """The background process: each of ``keys`` in turn through
    :func:`cpu_job` on ``threads`` CPU threads, each result saved under
    ``out_dir`` and announced on ``results`` as (key, path, error text,
    seconds). A ``planes`` job reads what the card hands over from
    ``inputs`` (paths of saved payloads, :meth:`CpuReferences.feed`).
    Stops at the first error. Prints go to stderr: the script's stdout
    ends in its own lines."""
    import torch

    sys.stdout = sys.stderr
    torch.set_num_threads(threads)

    def feed():
        path = inputs.get(timeout=1200)
        payload = torch.load(path, weights_only=False)
        os.remove(path)
        return payload

    for i, key in enumerate(keys):
        t0 = time.perf_counter()
        try:
            path = os.path.join(out_dir, f"{i}.pt")
            inline = {"feed": feed} if key[0] == "planes" else {}
            torch.save(cpu_job(torch, key, **inline), path)
            results.put((key, path, None, time.perf_counter() - t0))
        except BaseException:
            results.put((key, None, traceback.format_exc(),
                         time.perf_counter() - t0))
            return


class CpuReferences:
    """The CPU sides of the card-against-CPU checks, computed in one
    background process (spawned, so it never touches the card) in the
    order of ``keys``, which is the order the phases ask for them, while
    the card runs the phases before. The process takes as many CPU
    threads as this one has (``torch.get_num_threads()``): a CPU step's
    bits depend on how its sums are split over threads, and a check's
    Hungarian matches on them."""

    def __init__(self, torch, keys):
        import multiprocessing

        self.keys = list(keys)
        if len(set(self.keys)) != len(self.keys):
            raise AssertionError("CPU references: a key listed twice")
        self.threads = torch.get_num_threads()
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_cpu_")
        ctx = multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self.inputs = ctx.Queue()
        self.fed = 0
        self.proc = ctx.Process(target=cpu_worker, daemon=True, args=(
            self.keys, self.dir, self.results, self.threads, self.inputs))
        self.proc.start()
        self.ready, self.taken = {}, set()
        self.seconds, self.waited = 0.0, 0.0

    def get(self, torch, key):
        """The result of ``key``, waiting for the process if it is not
        there yet; each key is asked for once."""
        if key not in self.keys or key in self.taken:
            raise AssertionError(f"CPU references: {key} not listed, or "
                                 f"asked for twice")
        t0 = time.perf_counter()
        while key not in self.ready:
            try:
                got, path, error, sec = self.results.get(timeout=10)
            except queue.Empty:
                if not self.proc.is_alive():
                    raise AssertionError(
                        f"CPU references: the background process ended "
                        f"(exit {self.proc.exitcode}) before {key}")
                continue
            if error is not None:
                raise AssertionError(f"CPU references: {got} failed in "
                                     f"the background process:\n{error}")
            self.ready[got] = path
            self.seconds += sec
        self.waited += time.perf_counter() - t0
        self.taken.add(key)
        path = self.ready.pop(key)
        out = torch.load(path, weights_only=False)
        os.remove(path)
        return out

    def feed(self, torch, key, payload):
        """Hand ``payload`` (tensors and plain values) to the job ``key``,
        which reads it when it runs."""
        if key not in self.keys or key in self.taken:
            raise AssertionError(f"CPU references: {key} not listed, or "
                                 f"taken already")
        path = os.path.join(self.dir, f"feed{self.fed}.pt")
        self.fed += 1
        torch.save(payload, path)
        self.inputs.put(path)

    def close(self):
        """Stop the process and remove its files."""
        if self.proc.is_alive():
            self.proc.terminate()
        self.proc.join(30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        for q in (self.results, self.inputs):
            q.close()
            q.cancel_join_thread()
        shutil.rmtree(self.dir, ignore_errors=True)


CPU_REFS = None  # main's CpuReferences while it runs the phases


def cpu_side(torch, key, **inline):
    """The CPU side of the check ``key``: from :data:`CPU_REFS`'s
    background process where main started one, else computed here (with
    ``inline``'s arguments)."""
    if CPU_REFS is not None:
        return CPU_REFS.get(torch, key)
    return cpu_job(torch, key, **inline)


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return card


def phase_build():
    from phnet_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[build] {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc, sm_90a; libraries in {_build.BUILD_DIR})")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"[build] {name}: {line.strip()}")
    from phnet_torch.ops import router_chain as trc

    print("[build] router_chain: dynamic shared memory a CTA at [64, 36], "
          "4 blocks: " + ", ".join(f"G={g} {trc.smem_bytes(64, 36, g, 4)} B"
                                   for g in trc.GROUPS))


# lane NMS at each preset's shape: (O, top_k, confidence, n_lengths)
NMS_LAYOUTS = {"vil": (36, 8, 0.6, 2), "openlane": (72, 4, 0.5, 1)}


def phase_nms(torch, card, layout="vil", a=240):
    """K1 through both entries against their plain versions: 10 streams of
    every kind at the layout's confidence threshold and at 0, all four
    outputs bit-equal; then the main path's shape (4 seeded streams of
    ``a`` rows, the model's softmax scores; at the prior-propagation
    head's 244 rows the last 4 of each are dead rows), timed. Returns the
    numbers of the main path's shape."""
    from phnet_torch.config import LaneSpec
    from phnet_torch.ops import nms as tnms

    n_off, top_k, conf, n_len = NMS_LAYOUTS[layout]
    img_w, thresh = 768, 50.0
    spec = LaneSpec(n_offsets=n_off, n_lengths=n_len)
    tag = " ".join(["lane_nms"] + [t for t in (
        layout if layout != "vil" else "", f"R={a}" if a != 240 else "")
        if t])
    streams = [(kind, seed) for seed, kind in enumerate(NMS_KINDS)]
    streams += [("seeded", 9)]

    def check(routed, scores, valid, conf):
        got = tnms.nms_keeps(routed, scores, spec, img_w, conf, thresh,
                             top_k)
        ref = tnms.nms_keeps_plain(routed, scores, spec, img_w, conf,
                                   thresh, top_k)
        props = tnms.nms_proposals_from_predictions(routed, spec, img_w)
        got += tnms.lane_nms(props, scores, valid, thresh, n_off, top_k)
        ref += tnms.lane_nms_plain(props, scores, valid, thresh, n_off,
                                   top_k)
        torch.cuda.synchronize()
        names = ("kept", "keep_idx", "num_kept", "keep_mask")
        names += tuple(f"lane_nms {n}" for n in names[1:])
        for name, g, r in zip(names, got, ref):
            if not torch.equal(g, r):
                raise AssertionError(f"{tag} kernel: {name} differs from "
                                     f"the plain version (conf {conf})")
        return got[2]

    for c in (conf, 0.0):
        num = check(*nms_batch(torch, streams, a, n_off, c,
                               n_lengths=n_len), c)
        print(f"[{tag}] {len(streams)} streams x {a}, O = {n_off}, top_k "
              f"{top_k} ({', '.join(NMS_KINDS)}, seeded x 2), conf {c}: "
              f"both entries bit-equal to plain in every output; kept "
              f"{num.tolist()}")

    path_kind = "seeded" if a == 240 else "dead_rows"
    routed = nms_batch(torch, [(path_kind, s) for s in range(4)], a, n_off,
                       n_lengths=n_len)[0]
    scores = torch.softmax(routed[..., :2], dim=-1)[..., 1]  # a view
    valid = scores >= conf
    check(routed, scores, valid, conf)
    args = (routed, scores, spec, img_w, conf, thresh, top_k)
    kernel = lambda: tnms.nms_keeps(*args)  # noqa: E731
    plain = lambda: tnms.nms_keeps_plain(*args)  # noqa: E731
    props = tnms.nms_proposals_from_predictions(routed, spec, img_w)
    ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain)
    entry_ms = device_ms(torch, lambda: tnms.lane_nms(
        props, scores, valid, thresh, n_off, top_k))
    call_ms = time_ms(torch, kernel)
    step_ms = time_ms(torch, lambda: tnms.nms_keeps(
        routed, torch.softmax(routed[..., :2], dim=-1)[..., 1], spec, img_w,
        conf, thresh, top_k))
    _, keep_idx, num_kept, _ = kernel()
    b, _, dim = routed.shape
    nbytes = (4 * b * a * (dim + 1)  # routed, scores
              + 4 * b * top_k * dim + 8 * b * top_k + 8 * b + b * a)
    ops = nms_ops(routed.cpu().numpy(), valid.cpu().numpy(),
                  keep_idx.cpu().numpy(), n_off, img_w, thresh,
                  spec.col_xs)
    bound_ms, bound_by = bound(nbytes, ops)
    first = K1_FIRST_DESIGN_MS
    history = wrapper = ""
    if layout == "vil":
        history = (f" (first design {first['kernel']} ms, "
                   f"{first['kernel'] / ms:.2f}x)")
        wrapper = (f" (first design's whole wrapper {first['wrapper'][0]}-"
                   f"{first['wrapper'][1]} ms)")
    print(f"[{tag}] {b} streams x {a}, O = {n_off}, top_k {top_k} (the "
          f"main path's shape, softmax scores): bit-equal to plain; kept "
          f"{num_kept.tolist()}; device time: kernel {ms:.4f} ms{history}, "
          f"proposals entry {entry_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {ops} ops; the "
          f"kernel at {bound_ms / ms:.4f} of it); per call from Python: NMS "
          f"step (softmax + nms_keeps) {step_ms:.4f} ms, nms_keeps "
          f"{call_ms:.4f} ms{wrapper} [{card}]")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_router(torch, card):
    from phnet_torch.models.router import AdaptiveRouter
    from phnet_torch.ops import router_chain as trc

    dev = torch.device("cuda")
    a, c, p, blocks = 240, 64, 36, 4
    router = AdaptiveRouter(a, c, p).to(dev)
    router.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        # LayerNorm affines away from their init, as trained weights are
        lnp = router.ln_params
        lnp.add_(0.1 * torch.randn(lnp.shape, generator=torch.Generator(
        ).manual_seed(2)).to(dev))
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for streams in (1, 4):
        g = torch.Generator().manual_seed(10 + streams)
        feats = torch.randn((streams, a, c, p), generator=g).to(dev)
        x = feats.reshape(streams * a, c, p)
        args = (x, router.taps.data, router.conv_bias.data,
                router.ln_params.data, blocks)
        got = trc.router_chain(*args)
        torch.cuda.synchronize()
        ref = trc.router_chain_plain(*args)
        err = (got - ref).abs().max().item()
        with torch.no_grad():
            score = router(feats)
            h = torch.relu(router.dense0(ref.reshape(streams, a, c * p)))
            score_ref = torch.sigmoid(torch.relu(router.dense1(h)))
        score_err = (score - score_ref).abs().max().item()
        if not (err <= 1e-4 and score_err <= 1e-4):
            raise AssertionError(f"router_chain kernel at B={streams}: max "
                                 f"|diff| {err} (score {score_err}) > 1e-4")
        ms = device_ms(torch, lambda: trc.router_chain(*args))
        plain_ms = device_ms(torch, lambda: trc.router_chain_plain(*args))
        call_ms = time_ms(torch, lambda: trc.router_chain(*args))
        n = streams * a
        nbytes = 4 * (2 * n * c * p + a * blocks * 20
                      + (2 + 4 * blocks) * c * p)
        bound_ms, bound_by = bound(nbytes, chain_ops(n, c, p, blocks))
        plan = trc.router_plan(n, a, n_sms, c, p)
        print(f"[router_chain] B={streams} [{n}, {c}, {p}]: max |diff| "
              f"{err:.3g}, score {score_err:.3g}; device time: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} "
              f"ms ({bound_by}); per call from Python: kernel "
              f"{call_ms:.4f} ms [{card}]")
        print(f"[router_chain] B={streams}: G={plan.group} planes a CTA, "
              f"grid {plan.grid}, {plan.threads} threads; {bound_ms / ms:.3f}"
              f" of its bound; {K2_FIRST_DESIGN_MS[streams] / ms:.2f}x the "
              f"first design's {K2_FIRST_DESIGN_MS[streams]} ms")
        out[streams] = {"max_abs_err": max(err, score_err), "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by}
    return out


def phase_router_bf16(torch, card):
    """K2's bf16 mode (the chain the server runs above 8 streams and a bf16
    model trains) against ``router_chain_plain(bf16=True)`` at 1, 4 and 16
    streams (plans G = 1, 4, 4): bf16 out, two
    calls bit-equal, max |diff| within 2**-6 of max |plain| and under 1% of
    the elements differing (both round at the same points, but their
    LayerNorm sums run in other orders, so a rare element lands one bf16
    ulp apart and moves its neighbours in the next 3x3); the router score
    (the bf16 chain into the float32 MLP, whose seeded weights amplify a
    flipped ulp) within twice the plain version's own spread when each
    element of x moves by -1, 0 or +1 bf16 ulp. Timed beside the float32
    instance at the same width. Returns the numbers by streams."""
    from phnet_torch.models.router import AdaptiveRouter
    from phnet_torch.ops import router_chain as trc

    dev = torch.device("cuda")
    a, c, p, blocks = 240, 64, 36, 4
    router = AdaptiveRouter(a, c, p, chain_bf16=True).to(dev)
    router.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        lnp = router.ln_params
        lnp.add_(0.1 * torch.randn(lnp.shape, generator=torch.Generator(
        ).manual_seed(2)).to(dev))
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for streams in (1, 4, 16):
        g = torch.Generator().manual_seed(20 + streams)
        feats = torch.randn((streams, a, c, p), generator=g).to(dev)
        x = feats.reshape(streams * a, c, p)
        args = (x, router.taps.data, router.conv_bias.data,
                router.ln_params.data, blocks)
        got = trc.router_chain(*args, bf16=True)
        again = trc.router_chain(*args, bf16=True)
        torch.cuda.synchronize()
        ref = trc.router_chain_plain(*args, bf16=True)
        d = (got.float() - ref.float()).abs()
        err, top = d.max().item(), ref.float().abs().max().item()
        frac = (d > 0).float().mean().item()
        k = torch.randint(-1, 2, x.shape, generator=torch.Generator(
        ).manual_seed(30 + streams)).to(dev)
        moved = trc.router_chain_plain(x * (1 + k * 2.0 ** -8), *args[1:],
                                       bf16=True)

        def mlp(chain):
            h = torch.relu(router.dense0(chain.float().reshape(
                streams, a, c * p)))
            return torch.sigmoid(torch.relu(router.dense1(h)))

        with torch.no_grad():
            score, score_ref = router(feats), mlp(ref)
            own = (mlp(moved) - score_ref).abs().max().item()
        score_err = (score - score_ref).abs().max().item()
        if got.dtype != torch.bfloat16 or not torch.equal(got, again):
            raise AssertionError(f"router_chain bf16 kernel at B={streams}:"
                                 f" dtype {got.dtype}, or two calls differ")
        if not (err <= top / 64 and frac < 0.01 and score_err <= 2 * own):
            raise AssertionError(
                f"router_chain bf16 kernel at B={streams}: max |diff| {err} "
                f"(max |plain| {top}), {frac:.3g} of the elements differ, "
                f"score {score_err} (plain's own one-ulp spread {own})")
        ms = device_ms(torch, lambda: trc.router_chain(*args, bf16=True))
        f32_ms = device_ms(torch, lambda: trc.router_chain(*args))
        plain_ms = device_ms(torch, lambda: trc.router_chain_plain(
            *args, bf16=True))
        n = streams * a
        nbytes = (4 * n * c * p + 2 * n * c * p  # x f32 in, bf16 out
                  + 4 * (a * blocks * 20 + (2 + 4 * blocks) * c * p))
        bound_ms, bound_by = bound(nbytes, chain_ops(n, c, p, blocks))
        plan = trc.router_plan(n, a, n_sms, c, p)
        print(f"[router_chain bf16] B={streams} [{n}, {c}, {p}]: max |diff|"
              f" {err:.3g} of max |plain| {top:.3g}, {frac:.3g} of the "
              f"elements differ, score {score_err:.3g} (the plain version's "
              f"own one-ulp spread {own:.3g}), two calls bit-equal;"
              f" device time: kernel {ms:.4f} ms (the float32 instance "
              f"{f32_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}; {bound_ms / ms:.3f} of it); "
              f"G={plan.group}, grid {plan.grid}, dynamic shared memory "
              f"{trc.smem_bytes(c, p, plan.group, blocks, bf16=True)} B a "
              f"CTA (float32 "
              f"{trc.smem_bytes(c, p, plan.group, blocks)} B) [{card}]")
        out[streams] = {"max_abs_err": max(err, score_err), "ms": ms,
                        "f32_ms": f32_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def phase_w8_bf16x(torch, card, streams=4):
    """K3 fed bf16 x, as the bf16 model's generator chains feed it: the four
    products of a VIL refine stage at ``streams`` streams, bit-equal to
    the float32-x call on the same values and within 1e-5 of max |plain|,
    timed beside the float32-x call and cuBLAS's bf16 GEMM (f32 out) of the
    same operands. Returns the stage's sums."""
    from phnet_torch.ops import quant as tq
    from phnet_torch.ops import w8_matmul as tw8

    dev = torch.device("cuda")
    out = {}
    for name, k, n in W8_PRODUCTS:
        m = 240 * streams
        rng = np.random.default_rng(m + k + n + 1)
        xb = torch.from_numpy(rng.normal(size=(m, k)).astype(
            np.float32)).to(dev).bfloat16()
        wq, sw = tq.quantize_colwise(torch.from_numpy(
            (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)).to(dev))
        got = tw8.w8_matmul(xb, wq, sw)
        same = tw8.w8_matmul(xb.float(), wq, sw)
        torch.cuda.synchronize()
        ref = tq.w8_matmul_prequant(xb, wq, sw)
        err = (got - ref).abs().max().item()
        if not (torch.equal(got, same)
                and err <= 1e-5 * ref.abs().max().item()):
            raise AssertionError(f"w8_matmul at bf16 x {m}x{k}x{n}: not the "
                                 f"float32-x call's bits, or max |diff| "
                                 f"{err} from plain")
        ms = device_ms(torch, lambda: tw8.w8_matmul(xb, wq, sw))
        f32x = xb.float()
        f32x_ms = device_ms(torch, lambda: tw8.w8_matmul(f32x, wq, sw))
        plain_ms = device_ms(torch, lambda: tq.w8_matmul_prequant(xb, wq, sw))
        wb = wq.bfloat16()
        library_ms = device_ms(torch, lambda: torch.mm(
            xb, wb, out_dtype=torch.float32))
        nbytes = 2 * m * k + k * n + 4 * n + 4 * m * n
        bound_ms, bound_by = bound(nbytes, 2 * m * k * n, BF16_FLOPS)
        print(f"[w8_matmul bf16 x] {name} B={streams} [{m}, {k}] @ [{k}, "
              f"{n}]: bit-equal to the float32-x call, max |diff| {err:.3g} "
              f"from plain; device time: kernel {ms:.4f} ms (float32 x "
              f"{f32x_ms:.4f} ms), plain {plain_ms:.4f} ms, cuBLAS bf16 "
              f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}) "
              f"[{card}]")
        out[(streams, name)] = {"max_abs_err": err, "ms": ms,
                                "f32x_ms": f32x_ms, "plain_ms": plain_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by,
                                "library_ms": library_ms}
    st = stage_sum(out, streams)
    st["f32x_ms"] = sum(out[(streams, n)]["f32x_ms"] for n, _, _ in
                        W8_PRODUCTS)
    print(f"[w8_matmul bf16 x] stage (4 products) at B={streams}: kernel "
          f"{st['ms']:.4f} ms (float32 x {st['f32x_ms']:.4f} ms), cuBLAS "
          f"{st['library_ms']:.4f} ms ({st['ms'] / st['library_ms']:.2f}x), "
          f"bound {st['bound_ms']:.6f} ms [{card}]")
    return st


def phase_bf16(torch, card):
    """The bf16 paths of the port: VIL served in bf16 at 4 streams (none,
    then w8), each held card against CPU end to end; VIL served in float32
    at 16 streams, where the server turns the router chain's bf16 mode on
    (held card against CPU with that mode pinned); ``openlane_config``
    served in bf16 at 4 streams. Returns ``{name: phase_serving's
    numbers}``."""
    out = {}
    vil = seeded_state_dict(torch, preset_config("vil100_config"))
    for mode in ("none", "w8"):
        out[f"vil bf16 {mode}"] = phase_serving(
            torch, card, vil, mode, compute_dtype="bfloat16")
        phase_end_to_end(torch, card, vil, mode, compute_dtype="bfloat16")
    out["vil 16 streams"] = phase_serving(torch, card, vil, ticks=8,
                                          streams=16)
    phase_end_to_end(torch, card, vil, chain_bf16=True)
    ol = seeded_state_dict(torch, preset_config("openlane_config"))
    out["openlane bf16"] = phase_serving(
        torch, card, ol, preset="openlane_config", compute_dtype="bfloat16")
    return out


def seeded_state_dict(torch, cfg, seed=0):
    """Full-width weights from ``seed``, on the CPU. The cls output kernels
    of both branches' heads are redrawn with a wide spread and a zero bias
    (the init's 1e-3 puts every score at 0.5, on or below the confidence
    threshold, so NMS would keep nothing or everything), and the bias of
    the length field (column 5 of the lane vector: VIL's valid length,
    OL's only length) is raised so kept lanes span rows. The single head
    (VIL, OL's ``Router4OL``) keeps its cls outputs in the merged heads'
    ``out0`` (the prior-propagation head also in its "_last" stacks'), the
    multi-scale head in ``cls_fir`` / ``cls_sec``. RevCol's layer scales
    ``gamma`` are drawn from N(0, 0.3)."""
    from phnet_torch.models import PHNet

    model = PHNet(cfg.model, device="cpu")
    g = torch.Generator().manual_seed(seed)
    model.reset_parameters(g)
    head = model.head
    if cfg.model.head.variant == "multi":
        outs = [(c.out.weight.T, c.out.bias, r.out.bias) for c, r in (
            (head.cls_fir, head.reg_fir), (head.cls_sec, head.reg_sec))]
    else:  # the prior-propagation head's "_last" stacks too
        outs = [(h.out0_kernel, h.out0_bias, h.out1_bias)
                for h in (head.heads_fir, head.heads_sec,
                          *(getattr(head, f"heads_{b}_last", None)
                            for b in ("fir", "sec"))) if h is not None]
    with torch.no_grad():
        for k, cls_bias, reg_bias in outs:  # k: [hidden, 2], a view
            k.copy_(torch.randn(k.shape, generator=g) * 3.0
                    / k.shape[0] ** 0.5)
            cls_bias.zero_()
            reg_bias[3] += 0.5
        for name, p in model.named_parameters():
            # RevCol's layer scales: the init's 1e-6 would leave every
            # ConvNeXt block out of the comparison
            if name.endswith(".gamma"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return model.state_dict()


def quantized(cfg, quantize):
    if quantize == "none":
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, quantize=quantize))


def w8_products(cfg):
    """(name, K, N) of each w8 product of one frame of ``cfg``'s model:
    per stage s, the collapsed chains as one product ``s{s} gen1`` and the
    factored ones as two (``s{s} gen2_a``, ``s{s} gen2_b``), as
    ``DynamicConv.combine_weights`` makes them."""
    from phnet_torch.models import PHNet
    from phnet_torch.models.dynamic_conv import collapse_wins

    out = []
    for s, dyn in enumerate(PHNet(cfg.model, device="meta").head.dyn_heads):
        for chain in ("gen1", "gen2", "out"):
            la, lb = getattr(dyn, chain + "_a"), getattr(dyn, chain + "_b")
            if collapse_wins(la.in_features, la.out_features,
                             lb.out_features):
                out.append((f"s{s} {chain}", la.in_features,
                            lb.out_features))
            else:
                out += [(f"s{s} {chain}_a", la.in_features, la.out_features),
                        (f"s{s} {chain}_b", lb.in_features, lb.out_features)]
    return out


def phase_w8(torch, card, products=W8_PRODUCTS, tag="w8_matmul",
             ragged=True):
    """K3 against its plain version at ``products`` ((name, K, N); by
    default the four of one VIL refine stage), 1 and 4 streams (M = 240 x
    streams), and, with ``ragged``, three ragged shapes. Returns
    ``{(streams, product): numbers}``."""
    from phnet_torch.ops import quant as tq
    from phnet_torch.ops import w8_matmul as tw8

    dev = torch.device("cuda")
    lib_out = "f32"
    try:  # cuBLAS bf16 GEMM with an f32 output, where torch offers it
        torch.mm(torch.ones((1, 8), device=dev, dtype=torch.bfloat16),
                 torch.ones((8, 8), device=dev, dtype=torch.bfloat16),
                 out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        lib_out = "bf16"
    cases = [(b, name, 240 * b, k, n) for b in (1, 4)
             for name, k, n in products]
    if ragged:
        cases += [(0, "ragged", 7, 300, 60), (0, "ragged", 241, 4608, 1024),
                  (0, "ragged", 960, 72, 8192)]
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[{tag}] dynamic shared memory a CTA: " + ", ".join(
        f"{bn}-wide tiles {tw8.smem_bytes(bn)} B" for bn in (64, 128, 256))
          + f"; {n_sms} SMs")
    out = {}
    for streams, name, m, k, n in cases:
        rng = np.random.default_rng(m + k + n)
        x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(
            dev)
        wq, sw = tq.quantize_colwise(torch.from_numpy(
            (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)).to(dev))
        got = tw8.w8_matmul(x, wq, sw)
        torch.cuda.synchronize()
        ref = tq.w8_matmul_prequant(x, wq, sw)
        err = (got - ref).abs().max().item()
        norm_err = err / ref.abs().max().item()
        if not norm_err <= 1e-5:
            raise AssertionError(f"w8_matmul kernel at {m}x{k}x{n}: max "
                                 f"|diff| {norm_err} of max |plain| > 1e-5")
        again = tw8.w8_matmul(x, wq, sw)
        if not torch.equal(again, got):
            raise AssertionError(f"w8_matmul kernel at {m}x{k}x{n}: two "
                                 f"calls differ")
        ms = device_ms(torch, lambda: tw8.w8_matmul(x, wq, sw))
        plain_ms = device_ms(torch, lambda: tq.w8_matmul_prequant(x, wq, sw))
        xb, wb = x.bfloat16(), wq.bfloat16()
        if lib_out == "f32":
            lib = lambda: torch.mm(xb, wb, out_dtype=torch.float32)  # noqa: E731
        else:
            lib = lambda: torch.mm(xb, wb)  # noqa: E731
        library_ms = device_ms(torch, lib)
        nbytes = 4 * m * k + k * n + 4 * n + 4 * m * n  # x, wq, sw; out
        bound_ms, bound_by = bound(nbytes, 2 * m * k * n, BF16_FLOPS)
        plan = tw8.w8_plan(m, k, n, n_sms)
        print(f"[{tag}] {name} B={streams} [{m}, {k}] @ [{k}, {n}]: max "
              f"|diff| {err:.3g} ({norm_err:.3g} of max |plain|), two calls "
              f"bit-equal; device "
              f"time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}), cuBLAS bf16 GEMM "
              f"({lib_out} out) {library_ms:.4f} ms [{card}]")
        print(f"[{tag}] {name} B={streams}: {plan.block_n}-wide tiles, "
              f"{plan.splits} K split(s), {plan.ctas} CTAs; "
              f"{2 * m * k * n / ms / 1e9:.1f} TFLOP/s, "
              f"{bound_ms / ms:.3f} of its bound, {ms / library_ms:.2f}x "
              f"cuBLAS")
        out[(streams, name)] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "bound_ms": bound_ms,
                                "bound_by": bound_by,
                                "library_ms": library_ms}
    groups = {}  # a stage's products; VIL's names carry no stage
    for name, _, _ in products:
        groups.setdefault(name.split()[0] if " " in name else "stage",
                          []).append(name)
    if len(groups) > 1:
        groups["frame"] = [name for name, _, _ in products]
    for streams in (1, 4):
        for group, names in groups.items():
            st = stage_sum(out, streams, names)
            print(f"[{tag}] {group} ({len(names)} products) at B={streams}: "
                  f"kernel {st['ms']:.4f} ms, cuBLAS {st['library_ms']:.4f} "
                  f"ms ({st['ms'] / st['library_ms']:.2f}x), bound "
                  f"{st['bound_ms']:.6f} ms ({st['bound_ms'] / st['ms']:.3f} "
                  f"of it) [{card}]")
    return out


def stage_sum(w8, streams, names=tuple(n for n, _, _ in W8_PRODUCTS)):
    """The products ``names`` (by default the four of one VIL refine
    stage) at ``streams``, summed: the numbers of the kernels line for
    K3."""
    rows = [w8[(streams, name)] for name in names]
    top = max(rows, key=lambda r: r["bound_ms"])
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    return dict(total, max_abs_err=max(r["max_abs_err"] for r in rows),
                bound_by=top["bound_by"])


# the JAX package's other backbones at full width, by name: RevCol-tiny
# (the defaults of ``BackboneConfig(kind="revcol")``), the Bottleneck
# ResNet-50 (its stages give 256 .. 2048 channels, the neck takes the last
# three) and the GroupNorm ResNet-18
BACKBONES = ("revcol", "resnet50", "groupnorm")


def with_backbone(cfg, backbone=None):
    """``cfg`` with the backbone ``backbone`` (a name of
    :data:`BACKBONES`; None or "resnet18" keeps the preset's
    ResNet-18)."""
    from phnet_torch.config import BackboneConfig

    if backbone in (None, "resnet18"):
        return cfg
    m = cfg.model
    fields = {"revcol": dict(kind="revcol"), "resnet50": dict(depth=50),
              "groupnorm": dict(norm="group")}[backbone]
    neck = m.neck
    if backbone == "resnet50":  # a Bottleneck stage's output: 4x its width
        neck = dataclasses.replace(neck, in_channels=(512, 1024, 2048))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        m, backbone=BackboneConfig(**fields), neck=neck))


def preset_config(preset, quantize="none", compute_dtype="float32",
                  backbone=None):
    """``phnet_torch.config``'s preset of that name (``vil100_config``,
    ``openlane_config``, ``openlane_multiscale_config``) in ``quantize``
    and ``compute_dtype``, with ``backbone`` (:func:`with_backbone`)."""
    from phnet_torch import config

    return with_backbone(quantized(getattr(config, preset)(
        compute_dtype=compute_dtype), quantize), backbone)


def phase_serving(torch, card, state_dict, quantize="none", ticks=16,
                  warmup=2, preset="vil100_config", compute_dtype="float32",
                  streams=4, backbone=None):
    """``StreamingServer`` at the preset's full width in ``compute_dtype``,
    ``streams`` streams, the last of them skipping every third tick, then
    a detach and an attach; the kernels' counters are zeroed just before
    and read just after. Every tick must go through K1 once, K2 three
    times a tick where the head has the router chain (the single-scale
    heads but the prior-propagation one; in its bf16 mode above 8 streams,
    as the server resolves it, and in its float32 mode otherwise) and
    never where it has not, and K3 once a generator product in w8 and
    never otherwise. With ``backbone`` (:data:`BACKBONES`) one tick more,
    after the counters are read, runs under the profiler of the card's
    activity alone: launches and device ms a tick, and the busy share
    (device ms over the tick's wall p50). Returns the launches and the
    tick's numbers."""
    from phnet_torch.ops import nms as tnms
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.ops import w8_matmul as tw8
    from phnet_torch.serving import StreamingServer

    cfg = preset_config(preset, quantize, compute_dtype, backbone)
    mcfg = cfg.model
    vil = preset == "vil100_config"
    name = "serving" if vil else f"serving {preset.replace('_config', '')}"
    tag = " ".join([name] + [t for t in (
        backbone or "",
        quantize if quantize != "none" else "",
        "bf16" if compute_dtype == "bfloat16" else "",
        f"{streams} streams" if streams != 4 else "") if t])
    gc.collect()  # earlier phases' tensors out of the peak below
    torch.cuda.empty_cache()
    getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)()
    server = StreamingServer(cfg, state_dict, max_streams=streams)
    geometry = dict(ori_img_h=1080, cut_height=378) if vil else {}
    sids = [server.attach(**geometry) for _ in range(streams)]
    rng = np.random.default_rng(3)
    shape = (mcfg.img_h, mcfg.img_w, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def tick(i, streams):
        frames = {s: rng.normal(size=shape).astype(np.float32)
                  for s in streams if not (s == sids[-1] and i % 3 == 2)}
        t0 = time.perf_counter()
        kept, valid, got = server.step_async(frames)
        lanes = server.decode(kept, valid, got)  # fetch: waits for the card
        return time.perf_counter() - t0, kept, valid, lanes, len(frames)

    tnms.lane_nms.launches = 0
    trc.router_chain.launches = trc.router_chain.launches_bf16 = 0
    tw8.w8_matmul.launches = 0
    walls, frames_done, n_lanes, n_ticks = [], 0, 0, 0
    for i in range(warmup + ticks):
        wall, kept, valid, lanes, nf = tick(i, sids)
        n_ticks += 1
        if i >= warmup:
            walls.append(wall)
            frames_done += nf
        n_lanes += sum(len(v) for v in lanes.values())
    server.detach(sids[1])
    sids[1] = server.attach(**geometry)
    for i in range(2):
        _, kept, valid, lanes, _ = tick(i, sids)
        n_ticks += 1
    k1, k2, k2b, k3 = (tnms.lane_nms.launches, trc.router_chain.launches,
                       trc.router_chain.launches_bf16,
                       tw8.w8_matmul.launches)
    peak = torch.cuda.max_memory_allocated()

    top_k, dim = mcfg.test.nms_topk, mcfg.lane.dim
    if tuple(kept.shape) != (streams, top_k, dim) or tuple(valid.shape) != (
            streams, top_k):
        raise AssertionError(f"kept {tuple(kept.shape)} / valid "
                             f"{tuple(valid.shape)}, want [{streams}, "
                             f"{top_k}, {dim}] / [{streams}, {top_k}]")
    if not torch.isfinite(kept).all():
        raise AssertionError("non-finite kept rows")
    if not all(x.isfinite().all() for x in server.memory[:-1]
               if x.is_floating_point()):
        raise AssertionError("non-finite memory")
    propagate = mcfg.head.propagate_priors
    chain_per_tick = 0 if mcfg.head.variant == "multi" or propagate else 3
    chain_bf16 = server.mcfg.head.router_chain_bf16
    if chain_bf16 != (streams > 8):
        raise AssertionError(f"the server resolved router_chain_bf16 to "
                             f"{chain_bf16} at {streams} streams")
    want_k2 = (0, chain_per_tick) if chain_bf16 else (chain_per_tick, 0)
    if k1 != n_ticks or (k2, k2b) != tuple(w * n_ticks for w in want_k2):
        raise AssertionError(f"kernel launches lane_nms {k1}, router_chain "
                             f"{k2} (float32 mode) and {k2b} (bf16 mode) "
                             f"over {n_ticks} ticks: want lane NMS once and "
                             f"the router chain (float32, bf16) {want_k2} "
                             f"times a tick")
    per_tick = len(w8_products(cfg)) if quantize == "w8" else 0
    if k3 != per_tick * n_ticks:
        raise AssertionError(f"w8_matmul launches {k3} over {n_ticks} ticks "
                             f"with quantize={quantize!r}, want {per_tick} "
                             f"a tick")
    # not the ring's negatives; all of the one-frame carry's slots
    n_kept = int((server.memory.mask if propagate
                  else server.memory.mask[..., :-1]).sum())
    if n_kept == 0:
        raise AssertionError("NMS kept nothing: the smoke weights give the "
                             "kernel no work")
    w = np.array(walls) * 1e3
    w8_part = f", w8_matmul {k3}" if quantize != "none" else ""
    print(f"[{tag}] {n_ticks} ticks (ticks {warmup}..{warmup + ticks - 1} "
          f"timed) of {streams} streams at {mcfg.img_h}x{mcfg.img_w} in "
          f"{mcfg.compute_dtype}, memory window {server.window}, stream "
          f"{sids[-1]} skipping every third tick, then detach/attach; "
          f"launches lane_nms {k1}, router_chain {k2} (bf16 mode {k2b})"
          f"{w8_part}; kept lanes in memory {n_kept}, decoded lanes "
          f"{n_lanes}")
    numbers = {"tick_p50_ms": float(np.percentile(w, 50)),
               "tick_p99_ms": float(np.percentile(w, 99)),
               "frames_per_s": frames_done / w.sum() * 1e3,
               "peak_mib": peak / 2 ** 20}
    print(f"[{tag}] tick p50 {numbers['tick_p50_ms']:.3f} ms, p99 "
          f"{numbers['tick_p99_ms']:.3f} ms, {numbers['frames_per_s']:.2f} "
          f"frames/s aggregate, peak device memory "
          f"{numbers['peak_mib']:.1f} MiB [{card}]")
    print(f"[{tag}] stats {json.dumps(server.stats())}")
    if backbone is not None:
        n_k, k_ms = cuda_kernels(torch, lambda: tick(0, sids))
        numbers.update(launches=n_k, device_ms=k_ms,
                       busy=k_ms / numbers["tick_p50_ms"])
        print(f"[{tag}] one tick of {streams} streams under the profiler "
              f"(card activity only): {n_k} kernel launches, device kernel "
              f"time {k_ms:.2f} ms (busy {numbers['busy']:.3f} of the "
              f"unprofiled tick p50) [{card}]")
    return {"lane_nms": k1, "router_chain": k2, "router_chain_bf16": k2b,
            "w8_matmul": k3, **numbers}


def end_to_end_inputs(preset, quantize, compute_dtype, chain_bf16, frames,
                      backbone):
    """:func:`phase_end_to_end`'s model config and its clips by run:
    ``cuda`` and ``cpu`` the seeded frames, ``cpu perturbed`` (bf16 and
    quantized runs) a copy moved by one bf16 ulp (bf16) or 1e-6
    (quantized)."""
    mcfg = preset_config(preset, quantize, compute_dtype, backbone).model
    if chain_bf16 is not None:
        mcfg = dataclasses.replace(mcfg, head=dataclasses.replace(
            mcfg.head, router_chain_bf16=chain_bf16))
    clip = np.random.default_rng(4).normal(
        size=(1, frames, mcfg.img_h, mcfg.img_w, 3)).astype(np.float32)
    runs = {"cuda": clip, "cpu": clip}
    if compute_dtype == "bfloat16" or chain_bf16:
        runs["cpu perturbed"] = (clip * (1.0 + 2.0 ** -8 * np.random.default_rng(
            6).integers(-1, 2, clip.shape))).astype(np.float32)
    elif quantize != "none":
        runs["cpu perturbed"] = (clip * (1.0 + 1e-6 * np.random.default_rng(
            6).normal(size=clip.shape))).astype(np.float32)
    return mcfg, runs


def clip_run(torch, mcfg, state_dict, clip, dev):
    """``clip`` [1, T, H, W, 3] through ``frame_step`` on ``dev`` with
    ``state_dict``: the stacked routed predictions, keep indices and keep
    counts on the CPU, and the carry's valid slots entering each frame
    (prior propagation; else empty)."""
    from phnet_torch.models import PHNet
    from phnet_torch.models.phnet import init_memory

    model = PHNet(mcfg, device=dev)
    model.load_state_dict(state_dict)
    routed, keeps, counts, carried = [], [], [], []
    with torch.no_grad():
        feats = model.encode(torch.from_numpy(clip).to(dev))
        mem = init_memory(mcfg, 1, 2, dev)
        dyn = model.head.combine_dynamic()
        for t in range(clip.shape[1]):
            if mcfg.head.propagate_priors:
                carried.append(int(mem.mask.sum()))
            out, mem, r = model.frame_step(tuple(f[t] for f in feats), mem,
                                           dyn)
            routed.append(r.cpu())
            keeps.append(out.keep_idx.cpu())
            counts.append(out.num_kept.cpu())
    return (torch.stack(routed), torch.stack(keeps),
            torch.stack(counts)), carried


def cpu_end_to_end(torch, preset, quantize, compute_dtype, chain_bf16,
                   frames, backbone, state_dict=None):
    """The CPU runs of :func:`phase_end_to_end` with ``state_dict``, by
    default the seeded weights of ``preset`` and ``backbone`` (what the
    script's phases pass), and those weights' fingerprint."""
    mcfg, runs = end_to_end_inputs(preset, quantize, compute_dtype,
                                   chain_bf16, frames, backbone)
    if state_dict is None:
        state_dict = seeded_state_dict(torch, preset_config(
            preset, backbone=backbone))
    results, carried = {}, {}
    for run, clip in runs.items():
        if run != "cuda":
            results[run], carried[run] = clip_run(torch, mcfg, state_dict,
                                                  clip, "cpu")
    return {"weights": fingerprint(torch, state_dict), "results": results,
            "carried": carried}


def phase_end_to_end(torch, card, state_dict, quantize="none",
                     preset="vil100_config", compute_dtype="float32",
                     chain_bf16=None, frames=2, backbone=None):
    """The same weights, a clip of ``frames`` frames of the preset, on the
    card and on the CPU. Float32: routed predictions within 1e-3, keep
    sets equal. With prior propagation the carry must reach a later frame
    (some slot valid entering it) on both devices.

    bf16 (``compute_dtype="bfloat16"``, or the router chain's bf16 mode
    pinned by ``chain_bf16``): the card's cuDNN / cuBLAS products and the
    CPU's sum in other orders before each bf16 rounding, so rare elements
    land one bf16 ulp apart, as the port and the JAX package do on the CPU
    (``tests/test_torch_bf16.py``). The CPU also runs the frames with a
    random one-ulp change of each element (times ``1 + k * 2**-8``, k in
    -1, 0, 1); each column group of the routed predictions must be within
    twice that own spread at the 99th percentile and at most (and within
    ``BF16_FLOOR``), and the keep counts equal in every frame whose count
    the CPU's own perturbed run keeps (a count the CPU's own one-ulp change
    moves is decided inside the bf16 noise; they are printed).

    ``"w8"``: the card and the CPU round slightly different f32
    activations to bf16, so rare elements land one bf16 ulp apart, as the
    port and the JAX package do on the CPU (``tests/test_torch_quant.py``:
    kept rows within 1e-2, 90% of the head's outputs within 1e-4 at the
    small width). At full width every 4608-long generator row meets about
    one such flip, and the CPU's own routed predictions move about as much
    under a 1e-6 relative perturbation of the frames (run and printed
    here for comparison) as they differ from the card's; an anchor whose
    router score sits within that noise of the hard-routing threshold 0.5
    switches branch whole. So: equal keep counts; the lane geometry,
    lengths and xs (columns 2:) within 1e-3 at the 99th percentile and
    1e-1 at most; the cls logits within 1e-1 at the 99th percentile and 1
    at most."""
    key = ("end_to_end", preset, quantize, compute_dtype, chain_bf16,
           frames, backbone)
    mcfg, runs = end_to_end_inputs(*key[1:])
    bf16 = compute_dtype == "bfloat16" or bool(chain_bf16)
    tag = "end-to-end" if preset == "vil100_config" else (
        f"end-to-end {preset.replace('_config', '')}")
    tag = " ".join([tag] + [t for t in (
        backbone or "", quantize if quantize != "none" else "",
        "bf16" if compute_dtype == "bfloat16" else "",
        "bf16 chain" if chain_bf16 else "") if t])
    n_frames = frames
    results, carried = {}, {}
    results["cuda"], carried["cuda"] = clip_run(torch, mcfg, state_dict,
                                                runs["cuda"], "cuda")
    cpu = cpu_side(torch, key, state_dict=state_dict)
    if cpu["weights"] != fingerprint(torch, state_dict):
        raise AssertionError(f"{tag}: the CPU side's seeded weights are not "
                             f"the card's")
    results.update(cpu["results"])
    carried.update(cpu["carried"])
    (r_gpu, k_gpu, n_gpu), (r_cpu, k_cpu, n_cpu) = results["cuda"], results[
        "cpu"]
    if mcfg.head.propagate_priors:
        a = mcfg.head.num_priors
        for run in ("cuda", "cpu"):
            if not sum(carried[run][1:]):
                raise AssertionError(f"{tag} on {run}: the carry never "
                                     f"propagated (valid slots entering "
                                     f"each frame {carried[run]})")
        print(f"[{tag}] carry: valid slots entering each frame, card "
              f"{carried['cuda']}, CPU {carried['cpu']}; propagated rows "
              f"kept (card) {int((k_gpu >= a).sum())} [{card}]")
    diff = (r_gpu - r_cpu).abs()
    err = diff.max().item()
    if bf16:
        return check_bf16_end_to_end(tag, card, results, n_frames)
    if quantize == "none":
        if not err <= 1e-3:
            raise AssertionError(f"card vs CPU routed predictions: max "
                                 f"|diff| {err} > 1e-3")
        if not (torch.equal(n_gpu, n_cpu) and torch.equal(k_gpu, k_cpu)):
            raise AssertionError(f"card vs CPU keeps differ: "
                                 f"{k_gpu.tolist()} vs {k_cpu.tolist()}")
        print(f"[{tag}] {n_frames}-frame clip card vs CPU: routed max |diff| "
              f"{err:.3g} (<= 1e-3), num_kept {n_gpu.flatten().tolist()} "
              f"equal, keep sets equal; cuDNN TF32 flag "
              f"{torch.backends.cudnn.allow_tf32} around the model [{card}]")
        return
    def spread(d):
        cls, lane = d[..., :2].numpy(), d[..., 2:].numpy()
        return {"cls": (float(np.percentile(cls, 99)), float(cls.max())),
                "lane": (float(np.percentile(lane, 99)), float(lane.max()))}

    got = spread(diff)
    own = spread((results["cpu perturbed"][0] - r_cpu).abs())
    limits = {"cls": (1e-1, 1.0), "lane": (1e-3, 1e-1)}
    for part, (p99, top) in got.items():
        if not (p99 <= limits[part][0] and top <= limits[part][1]):
            raise AssertionError(
                f"{quantize} card vs CPU routed {part} columns: 99th "
                f"percentile |diff| {p99} (limit {limits[part][0]}), max "
                f"{top} (limit {limits[part][1]})")
    if not torch.equal(n_gpu, n_cpu):
        raise AssertionError(f"{quantize} card vs CPU num_kept differ: "
                             f"{n_gpu.tolist()} vs {n_cpu.tolist()}")
    print(f"[{tag}] {n_frames}-frame clip card vs CPU: routed |diff| of the "
          f"lane columns 99th percentile {got['lane'][0]:.3g} (<= 1e-3), max "
          f"{got['lane'][1]:.3g} (<= 1e-1); cls logits 99th percentile "
          f"{got['cls'][0]:.3g} (<= 1e-1), max {got['cls'][1]:.3g} (<= 1); "
          f"num_kept {n_gpu.flatten().tolist()} equal; keep sets equal: "
          f"{torch.equal(k_gpu, k_cpu)} [{card}]")
    print(f"[{tag}] for comparison, the CPU against itself on frames "
          f"perturbed by 1e-6: lane columns 99th percentile "
          f"{own['lane'][0]:.3g}, max {own['lane'][1]:.3g}; cls logits 99th "
          f"percentile {own['cls'][0]:.3g}, max {own['cls'][1]:.3g} "
          f"[{card}]")


BF16_FLOOR = {"cls": (0.5, 4.0), "lane": (5e-2, 1.0)}  # (p99, max)


def check_bf16_end_to_end(tag, card, results, n_frames=2):
    """phase_end_to_end's bf16 check (see its docstring)."""
    (r_gpu, _, n_gpu), (r_cpu, _, n_cpu), (r_own, _, n_own) = (
        results["cuda"], results["cpu"], results["cpu perturbed"])
    got, own = {}, {}
    for part, cols in (("cls", slice(0, 2)), ("lane", slice(2, None))):
        for out, other in ((got, r_gpu), (own, r_own)):
            d = (other[..., cols] - r_cpu[..., cols]).abs().numpy()
            out[part] = (float(np.percentile(d, 99)), float(d.max()))
    for part in got:
        limits = tuple(max(2 * o, f) for o, f in zip(own[part],
                                                     BF16_FLOOR[part]))
        if not (got[part][0] <= limits[0] and got[part][1] <= limits[1]):
            raise AssertionError(
                f"{tag} card vs CPU routed {part} columns: 99th percentile "
                f"|diff| {got[part][0]}, max {got[part][1]}; limits "
                f"{limits} (the CPU's own one-ulp spread {own[part]})")
    fixed = (n_own == n_cpu).numpy()
    if not fixed.any() or not (n_gpu == n_cpu).numpy()[fixed].all():
        raise AssertionError(f"{tag} card vs CPU num_kept "
                             f"{n_gpu.flatten().tolist()} vs "
                             f"{n_cpu.flatten().tolist()} (the CPU's "
                             f"one-ulp run: {n_own.flatten().tolist()})")
    print(f"[{tag}] {n_frames}-frame clip card vs CPU: routed |diff| lane "
          f"columns "
          f"99th percentile {got['lane'][0]:.3g}, max {got['lane'][1]:.3g}; "
          f"cls logits {got['cls'][0]:.3g}, {got['cls'][1]:.3g}; the CPU's "
          f"own one-ulp spread: lane {own['lane'][0]:.3g}, "
          f"{own['lane'][1]:.3g}, cls {own['cls'][0]:.3g}, "
          f"{own['cls'][1]:.3g}; num_kept card {n_gpu.flatten().tolist()}, "
          f"CPU {n_cpu.flatten().tolist()} (equal where the CPU's one-ulp "
          f"run keeps its count: {int(fixed.sum())} of {fixed.size} "
          f"frames) [{card}]")


def phase_pipeline(torch, card, state_dict, quantize="w8", clips=2,
                   frames_per_clip=6, chunk=4, backbone=None):
    """``InferencePipeline`` over seeded in-memory clips (the pipeline's
    duck-typed dataset), ``.lines.txt`` into a temporary directory, with
    ``backbone`` (:func:`with_backbone`). The counters are zeroed just
    before and read just after."""
    from phnet_torch.config import vil100_config
    from phnet_torch.evaluation.emit import read_lines_txt
    from phnet_torch.ops import nms as tnms
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.ops import w8_matmul as tw8
    from phnet_torch.pipeline import InferencePipeline

    cfg = with_backbone(quantized(vil100_config(), quantize), backbone)
    mcfg = cfg.model
    rng = np.random.default_rng(5)
    data = [{"frames": rng.normal(size=(frames_per_clip, mcfg.img_h,
                                        mcfg.img_w, 3)).astype(np.float32),
             "size": (1080, 1920), "cut": 378, "name": f"clip_{i}",
             "frame_names": [f"{t:05d}" for t in range(frames_per_clip)],
             "points": []} for i in range(clips)]
    pipe = InferencePipeline(cfg, state_dict, chunk=chunk)
    tnms.lane_nms.launches = 0
    trc.router_chain.launches = 0
    tw8.w8_matmul.launches = 0
    with tempfile.TemporaryDirectory() as pred_dir:
        stats = pipe.run_and_emit(data, pred_dir)
        files = sorted(glob.glob(os.path.join(pred_dir, "*",
                                              "*.lines.txt")))
        n_lanes = sum(len(read_lines_txt(f)) for f in files)
    k1, k2, k3 = (tnms.lane_nms.launches, trc.router_chain.launches,
                  tw8.w8_matmul.launches)
    run = clips * -(-frames_per_clip // chunk) * chunk  # padded frames
    if len(files) != clips * frames_per_clip or stats["frames"] != len(files):
        raise AssertionError(f"pipeline wrote {len(files)} files for "
                             f"{stats['frames']} frames, want "
                             f"{clips * frames_per_clip}")
    if n_lanes == 0:
        raise AssertionError("pipeline emitted no lanes")
    per_frame = 4 * mcfg.head.refine_layers
    if k1 < run or k2 < 3 * run or (quantize == "w8"
                                    and k3 < per_frame * run):
        raise AssertionError(f"pipeline launches lane_nms {k1}, router_chain"
                             f" {k2}, w8_matmul {k3} over {run} frames")
    tag = " ".join(t for t in ("pipeline", backbone, quantize) if t)
    print(f"[{tag}] {clips} clips x {frames_per_clip} frames "
          f"in chunks of {chunk} ({run} frames run with padding): "
          f"{len(files)} .lines.txt files, {n_lanes} lanes; launches "
          f"lane_nms {k1}, router_chain {k2}, w8_matmul {k3}; "
          f"{stats['fps']:.2f} frames/s [{card}]")
    return {"lane_nms": k1, "router_chain": k2, "w8_matmul": k3}


def phase_openlane(torch, card):
    """Both OpenLane-V presets at full width: ``openlane_config``
    (``Router4OL``) served in f32, card against CPU end to end with
    cuDNN's TF32 flag on, then served in w8 and int8;
    ``openlane_multiscale_config`` (``Router4OLV2``) the same in f32 and
    w8. Returns ``{(preset, quantize): phase_serving's numbers}``."""
    out = {}
    for preset, modes in (("openlane_config", ("none", "w8", "int8")),
                          ("openlane_multiscale_config", ("none", "w8"))):
        state_dict = seeded_state_dict(torch, preset_config(preset))
        for mode in modes:
            out[(preset, mode)] = phase_serving(torch, card, state_dict,
                                                mode, preset=preset)
            if mode != "none":
                continue
            torch.backends.cudnn.allow_tf32 = True  # a user's default
            try:
                phase_end_to_end(torch, card, state_dict, preset=preset)
            finally:
                torch.backends.cudnn.allow_tf32 = False
    return out


TRAIN_LEAVES = (  # gradient leaves held card against CPU, one a layer
    "encoder.backbone.conv0.weight", "encoder.backbone.bn0.weight",
    "encoder.neck.fpn.0.weight", "head.prior_embeddings",
    "head.routers.0.taps", "head.routers.2.ln_params",
    "head.routers.1.dense0.weight", "head.dyn_heads.1.gen2_a.weight",
    "head.dyn_heads.2.gen1_b.weight",
    "head.temporal_decoder.layers.1.ffn2.weight",
    "head.heads_sec.out1_kernel", "head.heads_fir.fc0_kernel")
# the same for the other OpenLane-V heads: the routers and branch stacks
# they have in place of the router chain and the merged heads
HEAD_LEAVES = {
    "openlane_multiscale_config": TRAIN_LEAVES[:4] + (
        "encoder.neck.upsample.0.weight", "head.routers.0.conv1.weight",
        "head.routers.2.out.weight", "head.dyn_heads.1.gen2_a.weight",
        "head.dyn_heads.2.out_b.weight",
        "head.temporal_decoder.layers.1.ffn2.weight",
        "head.reg_sec.out.weight", "head.cls_fir.fc0.weight"),
    "openlane_propagate_config": TRAIN_LEAVES[:4] + (
        "head.mlp_routers.0.fc0.weight", "head.mlp_routers.2.out.weight",
        "head.dyn_heads.1.gen2_a.weight",
        "head.temporal_decoder.layers.1.ffn2.weight",
        "head.temporal_decoder_last.layers.0.ffn2.weight",
        "head.heads_fir_last.fc0_kernel", "head.heads_sec_last.out1_kernel",
        "head.heads_sec.out1_kernel")}
# the backbone leaves held card against CPU for the other backbones (the
# head's are TRAIN_LEAVES[2:])
BACKBONE_LEAVES = {
    "revcol": ("encoder.backbone.stem_conv.weight",
               "encoder.backbone.subnet0.level0.block0.dwconv.weight",
               "encoder.backbone.subnet1.alpha2",
               "encoder.backbone.subnet2.level1.fusion.up_proj.weight",
               "encoder.backbone.subnet3.level3.block1.pw2.weight",
               "encoder.backbone.subnet3.level2.block3.gamma"),
    "resnet50": ("encoder.backbone.conv0.weight",
                 "encoder.backbone.bn0.weight",
                 "encoder.backbone.blocks.0.conv3.weight",
                 "encoder.backbone.blocks.15.conv2.weight",
                 "encoder.backbone.blocks.15.bn2.bias"),
    "groupnorm": ("encoder.backbone.conv0.weight",
                  "encoder.backbone.bn0.weight",
                  "encoder.backbone.blocks.2.bn2.weight",
                  "encoder.backbone.blocks.7.bn1.bias")}
PROFILE_RANGES = ("hungarian_assign", "router_chain_backward")


def train_config(dropout, preset="vil100_config", compute_dtype="float32",
                 chain_f32=False, remat=True, backbone=None, **train):
    """The full-width training configuration of ``preset`` with decoder
    dropout ``dropout``, the compute dtype, ``router_train_chain_f32``,
    remat, ``backbone`` (:func:`with_backbone`; RevCol with its default
    drop path 0.1 and column checkpoint) and ``train`` overrides."""
    from phnet_torch import config as tconfig

    cfg = with_backbone(getattr(tconfig, preset)(), backbone)
    head = dataclasses.replace(cfg.model.head, decoder_dropout=dropout,
                               router_train_chain_f32=chain_f32)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, head=head,
                                       compute_dtype=compute_dtype,
                                       remat_frames=remat),
        train=dataclasses.replace(cfg.train, **train))


def chain_per_frame(cfg) -> int:
    """K2 launches a frame of ``cfg``'s head: one a refine stage where the
    head routes with the router chain, none for the multi-scale head
    (Conv1d routers) and the prior-propagation head (per-row MLPs)."""
    h = cfg.model.head
    return 0 if h.variant == "multi" or h.propagate_priors else (
        h.refine_layers)


def chain_bf16_in_training(cfg) -> bool:
    """Whether ``cfg`` trains K2 in its bf16 mode (the JAX rule)."""
    return (cfg.model.compute_dtype == "bfloat16"
            and not cfg.model.head.router_train_chain_f32)


def synthetic_batch(torch, cfg, clips, frames_per_clip, seed=1):
    """Seeded synthetic clips at the model's size, on the CPU:
    frames [B, T, H, W, 3], labels [B, T, L, dim]."""
    from phnet_torch.data import SyntheticVideoDataset, collate_clips

    m = cfg.model
    ds = SyntheticVideoDataset(n_videos=clips,
                               frames_per_video=frames_per_clip,
                               img_h=m.img_h, img_w=m.img_w, spec=m.lane,
                               max_lanes=m.max_lanes, seed=seed)
    batch = collate_clips([ds[i] for i in range(clips)])
    return (torch.from_numpy(batch["frames"]),
            torch.from_numpy(batch["labels"]))


@contextlib.contextmanager
def pinned_assignment(matched):
    """The port's training forward with its Hungarian assignment replaced
    by ``matched`` ([2, T, S, B, L]: first branch, second branch; an array
    or a tensor), frame by frame: a bf16 step's gradients compared across
    devices must not hinge on a match that rounding noise flips. (The CPU
    parity tests, ``tests/torch_train_parity.py``, hold the same copy.)"""
    import torch

    import phnet_torch.models.phnet as tph

    matched = torch.as_tensor(matched).long()
    frame = iter(range(matched.shape[1]))
    real = tph.train_assign

    def fixed(cfg, preds, *_):
        i = next(frame)
        return torch.cat([matched[0, i], matched[1, i]]).to(preds.device)

    tph.train_assign = fixed
    try:
        yield
    finally:
        tph.train_assign = real


def grad_run(torch, cfg, frames, labels, device, pin=None, leaves=None):
    """One training step from the seeded weights on ``device``: forward,
    criterion, backward (inside ``full_f32``), update; with ``pin``, the
    assignment pinned to those matches. Returns the loss, the gradient
    norm, the matches, the gradient leaves (``leaves``, default every
    one) and K2's launches in the step (float32 instance, bf16 mode)."""
    from phnet_torch.device import full_f32
    from phnet_torch.losses import LaneCriterion
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.train.state import create_train_state

    state = create_train_state(cfg, 100, device, seed=0)
    crit = LaneCriterion(cfg.model, cfg.train.loss)
    frames, labels = frames.to(device), labels.to(device)
    trc.router_chain.launches = trc.router_chain.launches_bf16 = 0
    with full_f32(), (pinned_assignment(pin) if pin is not None
                      else contextlib.nullcontext()):
        outs, _ = state.model.train_forward(frames, labels)
        loss, _ = crit(outs, labels)
        loss.backward()
        norm = state.optimizer.step()
    k2 = (trc.router_chain.launches, trc.router_chain.launches_bf16)
    grads = dict(state.model.named_parameters())
    return {"loss": loss.item(), "grad_norm": norm.item(),
            "matched": torch.stack([outs.matched_fir, outs.matched_sec]
                                   ).cpu(),
            "grads": {n: grads[n].grad.float().cpu()
                      for n in (leaves or grads)}, "k2": k2}


def free_matches(torch, cfg, frames, labels, device):
    """The matches of a training forward from the seeded weights, with
    autograd on as in a step (the encoder then takes its input contiguous)
    but no backward: [2, T, S, B, L]."""
    from phnet_torch.device import full_f32
    from phnet_torch.train.state import create_train_state

    model = create_train_state(cfg, 100, device, seed=0).model
    with full_f32():
        outs, _ = model.train_forward(frames.to(device), labels.to(device))
    return torch.stack([outs.matched_fir, outs.matched_sec]).cpu()


def train_parity_inputs(torch, preset, frames_per_clip, backbone):
    """:func:`phase_train_parity`'s config, gradient leaves, seeded clip
    (frames, labels) and the frames moved by 1e-6 relative."""
    cfg = train_config(0.0, preset, backbone=backbone)
    leaves = HEAD_LEAVES.get(preset, TRAIN_LEAVES)
    if backbone is not None:
        leaves = BACKBONE_LEAVES[backbone] + TRAIN_LEAVES[2:]
    frames, labels = synthetic_batch(torch, cfg, 1, frames_per_clip)
    pert = frames * (1.0 + 1e-6 * torch.from_numpy(np.random.default_rng(
        7).normal(size=tuple(frames.shape)).astype(np.float32)))
    return cfg, leaves, frames, labels, pert


def cpu_train(torch, preset, frames_per_clip, backbone):
    """The CPU steps of :func:`phase_train_parity`: on the clip and on its
    perturbed copy, with the clip's fingerprint."""
    cfg, leaves, frames, labels, pert = train_parity_inputs(
        torch, preset, frames_per_clip, backbone)
    return {"inputs": fingerprint(torch, {"frames": frames,
                                          "labels": labels}),
            "cpu": grad_run(torch, cfg, frames, labels, "cpu",
                            leaves=leaves),
            "cpu_p": grad_run(torch, cfg, pert, labels, "cpu",
                              leaves=leaves)}


def phase_train_parity(torch, card, preset="vil100_config",
                       frames_per_clip=4, backbone=None):
    """One float32 training step of ``preset`` card against CPU at full
    width, B=1, T = ``frames_per_clip``; the bounds are the CPU's own
    spread under a 1e-6 relative perturbation of the frames, four times
    over, and no tighter
    than 2e-5 relative for the loss, 1e-4 for the gradient norm and 2e-3
    of each leaf's largest entry (float32 sums in other orders, atomics on
    the card). K2's float32 instance launches 3 times a frame, again in
    the remat recompute, its bf16 mode never. Returns the card's K2
    launches. ``backbone``: another backbone (:func:`with_backbone`),
    without drop path (no seed reaches the step)."""
    key = ("train", preset, frames_per_clip, backbone)
    cfg, leaves, frames, labels, _ = train_parity_inputs(torch, *key[1:])
    t0 = time.perf_counter()
    card_run = grad_run(torch, cfg, frames, labels, "cuda", leaves=leaves)
    side = cpu_side(torch, key)
    if side["inputs"] != fingerprint(torch, {"frames": frames,
                                             "labels": labels}):
        raise AssertionError(f"training {preset}: the CPU side's clip is "
                             f"not the card's")
    cpu, cpu_p = side["cpu"], side["cpu_p"]
    want_k2 = (2 * chain_per_frame(cfg) * frames_per_clip, 0)
    if card_run["k2"] != want_k2:
        raise AssertionError(f"training {preset}: K2 launches (float32, "
                             f"bf16) {card_run['k2']}, want {want_k2}")
    report = []
    for key, floor in (("loss", 2e-5), ("grad_norm", 1e-4)):
        err, own = abs(card_run[key] - cpu[key]), abs(cpu_p[key] - cpu[key])
        bound = max(4 * own, floor * abs(cpu[key]))
        if not err <= bound:
            raise AssertionError(f"training card vs CPU {key}: "
                                 f"{card_run[key]} vs {cpu[key]}, |diff| "
                                 f"{err} > {bound} (CPU's own {own})")
        report.append(f"{key} {card_run[key]:.6f} vs {cpu[key]:.6f} "
                      f"(|diff| {err:.3g}, CPU's own {own:.3g}, bound "
                      f"{bound:.3g})")
    worst = 0.0
    for name in leaves:
        ref = cpu["grads"][name]
        err = (card_run["grads"][name] - ref).abs().max().item()
        own = (cpu_p["grads"][name] - ref).abs().max().item()
        bound = max(4 * own, 2e-3 * ref.abs().max().item())
        if not err <= bound:
            raise AssertionError(f"training card vs CPU gradient {name}: "
                                 f"max |diff| {err} > {bound} (CPU's own "
                                 f"{own})")
        worst = max(worst, err / bound)
    flips = int((card_run["matched"] != cpu["matched"]).sum())
    own_flips = int((cpu_p["matched"] != cpu["matched"]).sum())
    if flips > own_flips:
        raise AssertionError(f"training card vs CPU: {flips} Hungarian "
                             f"matches differ, the perturbed CPU run "
                             f"{own_flips}")
    print(f"[train card vs CPU] {preset}{' ' + backbone if backbone else ''}"
          f", full width, 1 clip x "
          f"{frames_per_clip} frames, dropout 0, cuDNN TF32 flag "
          f"{torch.backends.cudnn.allow_tf32} around the step: "
          + "; ".join(report) + f"; {len(leaves)} gradient leaves, "
          f"worst at {worst:.3f} of its bound; matches differing {flips} of "
          f"{card_run['matched'].numel()} (perturbed CPU {own_flips}); K2 "
          f"launches (float32, bf16) {card_run['k2']}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return card_run["k2"]


def one_ulp(x, seed):
    """x with each element moved by -1, 0 or +1 bf16 ulp (relative), as
    ``tests/test_torch_bf16.py``'s ``one_ulp`` moves an array."""
    k = np.random.default_rng(seed).integers(-1, 2, tuple(x.shape))
    return x * (1.0 + x.new_tensor(k * 2.0 ** -8))


def leaf_group(name):
    """The module a gradient leaf belongs to, for the bf16 bounds."""
    parts = name.split(".")
    if parts[0] == "encoder" or parts[1] in (
            "routers", "dyn_heads", "temporal_decoder", "heads_fir",
            "heads_sec", "mlp_routers", "temporal_decoder_last",
            "heads_fir_last", "heads_sec_last", "cls_fir", "reg_fir",
            "cls_sec", "reg_sec"):
        return ".".join(parts[:2])
    return "head (anchors, embeddings)"


def zero_up_to_rounding(name, grads):
    """For a gradient leaf that a norm cancels (zero up to rounding), the
    leaf whose gradient sets its scale, else None: K2's conv biases (its
    taps; a LayerNorm follows each 3x3); a multi-scale router's conv bias
    (its weight) where its GroupNorm has one channel a group, which shows
    in ``grads`` (the CPU's) as a bias gradient under 1e-3 of the
    weight's."""
    if name.endswith("conv_bias"):
        return name[:-len("conv_bias")] + "taps"
    parts = name.split(".")
    if (parts[1:2] == ["routers"] and parts[-1] == "bias"
            and parts[-2].startswith("conv")):
        weight = name[:-len("bias")] + "weight"
        if (grads[name].abs().max().item()
                <= 1e-3 * grads[weight].abs().max().item()):
            return weight
    return None


def train_bf16_inputs(torch, preset, chain_f32, frames_per_clip,
                      ulp_seeds):
    """:func:`phase_train_parity_bf16`'s config, seeded clip (frames,
    labels) and the frames' one-ulp copies."""
    cfg = train_config(0.0, preset, compute_dtype="bfloat16",
                       chain_f32=chain_f32)
    frames, labels = synthetic_batch(torch, cfg, 1, frames_per_clip)
    return cfg, frames, labels, [one_ulp(frames, s) for s in ulp_seeds]


def cpu_train_bf16(torch, preset, chain_f32, frames_per_clip, ulp_seeds):
    """The CPU side of :func:`phase_train_parity_bf16`: the step on the
    clip, the steps on its one-ulp copies pinned to that step's matches,
    the most slots the copies' free matches move, and the clip's
    fingerprint."""
    cfg, frames, labels, copies = train_bf16_inputs(
        torch, preset, chain_f32, frames_per_clip, ulp_seeds)
    cpu = grad_run(torch, cfg, frames, labels, "cpu")
    pin = cpu["matched"]
    return {"inputs": fingerprint(torch, {"frames": frames,
                                          "labels": labels}),
            "cpu": cpu,
            "cpu_ulp": [grad_run(torch, cfg, f, labels, "cpu", pin=pin)
                        for f in copies],
            "own_flips": max(int((free_matches(torch, cfg, f, labels, "cpu")
                                  != pin).sum()) for f in copies)}


def phase_train_parity_bf16(torch, card, preset="vil100_config",
                            chain_f32=False, frames_per_clip=4,
                            ulp_seeds=(5, 6)):
    """One bf16 training step of ``preset`` (``router_train_chain_f32``
    with ``chain_f32``) card against CPU at full width, B=1, T =
    ``frames_per_clip``, by the
    one-ulp method of the CPU parity tests (``tests/torch_train_parity``):
    the card's step and the CPU's steps on copies of the frames moved by
    one bf16 ulp run with the assignment pinned to the CPU's matches. Per
    group of gradient leaves (a module) the largest relative gap (|card -
    CPU| max over a leaf's largest entry) within twice the CPU's own
    one-ulp spread; the routers' conv biases, zero up to rounding, under
    5e-2 of their taps' largest gradient on the card; the loss within
    twice its spread; the matches of a free forward on the card differing
    from the CPU's in no more slots than the CPU's own one-ulp copies do.
    K2 launches 3 times a frame, again in the remat recompute, in its
    bf16 mode (its float32 instance with ``chain_f32``). The card's step
    without remat must give the same loss bits and gradients within the
    same bounds (the recompute reproduces the forward: K2 and cuBLAS
    deterministic). Returns the card's K2 launches."""
    tag = f"{preset}{' router_train_chain_f32' if chain_f32 else ''}"
    key = ("train_bf16", preset, chain_f32, frames_per_clip, ulp_seeds)
    cfg, frames, labels, _ = train_bf16_inputs(torch, *key[1:])
    t0 = time.perf_counter()
    side = cpu_side(torch, key)
    if side["inputs"] != fingerprint(torch, {"frames": frames,
                                             "labels": labels}):
        raise AssertionError(f"training {tag} bf16: the CPU side's clip is "
                             f"not the card's")
    cpu, cpu_ulp, own_flips = side["cpu"], side["cpu_ulp"], side["own_flips"]
    pin = cpu["matched"]
    flips = int((free_matches(torch, cfg, frames, labels, "cuda")
                 != pin).sum())
    card_run = grad_run(torch, cfg, frames, labels, "cuda", pin=pin)
    no_remat = grad_run(torch, train_config(
        0.0, preset, compute_dtype="bfloat16", chain_f32=chain_f32,
        remat=False), frames, labels, "cuda", pin=pin)
    steps = 2 * chain_per_frame(cfg) * frames_per_clip
    want_k2 = (0, steps) if chain_bf16_in_training(cfg) else (steps, 0)
    if card_run["k2"] != want_k2:
        raise AssertionError(f"training {tag} bf16: K2 launches (float32, "
                             f"bf16) {card_run['k2']}, want {want_k2}")
    if flips > own_flips:
        raise AssertionError(f"training {tag} bf16: {flips} Hungarian "
                             f"matches differ card vs CPU, the CPU's one-ulp "
                             f"copies {own_flips}")
    own_loss = max(abs(u["loss"] - cpu["loss"]) for u in cpu_ulp)
    if not abs(card_run["loss"] - cpu["loss"]) <= 2 * own_loss:
        raise AssertionError(f"training {tag} bf16 loss: card "
                             f"{card_run['loss']} vs CPU {cpu['loss']}, the "
                             f"CPU's one-ulp spread {own_loss}")
    if no_remat["loss"] != card_run["loss"]:
        raise AssertionError(f"training {tag} bf16: loss without remat "
                             f"{no_remat['loss']} != {card_run['loss']}")
    groups = {}
    for name, ref in cpu["grads"].items():
        scale = ref.abs().max().item()
        if name.startswith("encoder.backbone.blocks") and not scale:
            continue  # a stage the multi-scale head does not read
        sibling = zero_up_to_rounding(name, cpu["grads"])
        if sibling is not None:
            taps = card_run["grads"][sibling]
            if not (card_run["grads"][name].abs().max().item()
                    <= 5e-2 * taps.abs().max().item()):
                raise AssertionError(f"training {tag} bf16: {name} not "
                                     f"zero up to rounding on the card")
            continue
        gap = (card_run["grads"][name] - ref).abs().max().item() / scale
        own = max((u["grads"][name] - ref).abs().max().item()
                  for u in cpu_ulp) / scale
        remat = (no_remat["grads"][name]
                 - card_run["grads"][name]).abs().max().item() / scale
        g = groups.setdefault(leaf_group(name), [0.0, 0.0, 0.0])
        g[0], g[1], g[2] = max(g[0], gap), max(g[1], own), max(g[2], remat)
    for name, (gap, own, remat) in groups.items():
        if not (gap <= 2 * own and remat <= 2 * own):
            raise AssertionError(f"training {tag} bf16 gradients of {name}: "
                                 f"card vs CPU {gap:.4g}, remat on vs off "
                                 f"{remat:.4g} of the largest entry, the "
                                 f"CPU's one-ulp spread {own:.4g}")
    print(f"[train bf16 card vs CPU] {tag}, full width, 1 clip x "
          f"{frames_per_clip} frames, dropout 0, assignment pinned to the "
          f"CPU's: loss {card_run['loss']:.6f} vs {cpu['loss']:.6f} (CPU's "
          f"one-ulp spread {own_loss:.3g}); per group the largest relative "
          f"gap card vs CPU / remat on vs off / CPU's one-ulp spread: "
          + ", ".join(f"{n} {g[0]:.3g} / {g[2]:.3g} / {g[1]:.3g}"
                      for n, g in sorted(groups.items()))
          + f"; free matches differing {flips} of {pin.numel()} (the CPU's "
          f"one-ulp copies {own_flips}); K2 launches (float32, bf16) "
          f"{card_run['k2']}; {time.perf_counter() - t0:.1f} s [{card}]")
    return card_run["k2"]


def range_kernels(event):
    """(count, device us) of the kernels launched under a CPU range of a
    ``torch.profiler`` trace."""
    n, us = len(event.kernels), sum(k.duration for k in event.kernels)
    for child in event.cpu_children:
        cn, cus = range_kernels(child)
        n, us = n + cn, us + cus
    return n, us


def profile_steps(torch, fn, steps=1, group_of=None):
    """Run fn ``steps`` times under ``torch.profiler``: device kernel ms,
    launches, and the launches, device ms and host ms (under the profiler)
    of each of ``PROFILE_RANGES``, all per call, and the kernel times by
    name. With ``group_of`` (kernel name
    -> group) also the device ms by group, each kernel counted once: a
    kernel launched under one of the ranges goes to the range's group."""
    from collections import defaultdict

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in PROFILE_RANGES]
    by_name = defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    ranges = {}
    for name in PROFILE_RANGES:
        n = us = 0
        for e in events:
            if (e.name == name
                    and e.device_type == torch.autograd.DeviceType.CPU):
                cn, cus = range_kernels(e)
                n, us = n + cn, us + cus
        host_us = sum(e.cpu_time_total for e in events
                      if e.name == name and e.device_type
                      == torch.autograd.DeviceType.CPU)
        ranges[name] = {"launches": n / steps, "ms": us / 1e3 / steps,
                        "host_ms": host_us / 1e3 / steps}
    by_group = defaultdict(float)

    def walk(event, forced):
        forced = event.name if event.name in PROFILE_RANGES else forced
        for k in event.kernels:
            by_group[forced or group_of(k.name)] += k.duration / 1e3 / steps
        for child in event.cpu_children:
            walk(child, forced)

    if group_of is not None:
        for e in events:
            if (e.device_type == torch.autograd.DeviceType.CPU
                    and e.cpu_parent is None):
                walk(e, None)
    return {"device_ms": sum(by_name.values()) / 1e3 / steps,
            "launches": len(kernels) / steps, "ranges": ranges,
            "by_group": dict(by_group),
            "profiled_wall_ms": wall * 1e3 / steps,
            "by_name": {k: v / 1e3 / steps for k, v in by_name.items()}}


def cuda_kernels(torch, fn):
    """(launches, device kernel ms) of one fn() call under
    ``torch.profiler`` with the card's activity alone: no host events to
    process, a fraction of :func:`profile_steps`' time. It reads the
    profiler's raw events, the ones ``prof.events()`` would keep (not
    hidden, not a user range, not a name the event list filters out):
    the event list builds a Python object a kernel, some 20 s for a
    training step's ~190k."""
    from torch.autograd import DeviceType
    from torch.autograd import profiler as autograd_profiler

    dropped = getattr(autograd_profiler, "_filter_name", lambda name: False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()
               and not getattr(e, "is_hidden_event", lambda: False)()
               and not dropped(e.name())]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel of the step")
    return len(kernels), sum(e.duration_ns() for e in kernels) / 1e6


def phase_train_throughput(torch, card, batches=(1, 4), frames_per_clip=16,
                           warmup=1, timed=3, preset="vil100_config",
                           compute_dtype="float32", counted=(1,),
                           backbone=None):
    """Training steps of ``preset`` in ``compute_dtype`` on a fixed batch at
    full width; at the batch sizes in ``counted`` one step more under the
    profiler of the card's activity alone (:func:`cuda_kernels`: launches
    and kernel time; the host ranges, the Hungarian solve's and K2's
    backward, come from ``tools/torch_train_profile.py``, whose trace of
    a step takes 70-130 s to process). Returns the numbers of each batch
    size."""
    from phnet_torch.losses import LaneCriterion
    from phnet_torch.ops import nms as tnms
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.ops import w8_matmul as tw8
    from phnet_torch.train.state import create_train_state
    from phnet_torch.train.step import make_train_step, step_seed

    cfg = train_config(0.1, preset, compute_dtype=compute_dtype,
                       backbone=backbone)
    tag = " ".join(t for t in ("train", preset, backbone, compute_dtype) if t)
    crit = LaneCriterion(cfg.model, cfg.train.loss)
    step = make_train_step(crit, cfg.train.accum_steps)
    bf16_chain = chain_bf16_in_training(cfg)
    out = {}
    for b in batches:
        gc.collect()
        torch.cuda.empty_cache()
        state = create_train_state(cfg, 1000, "cuda", seed=0)
        frames, labels = synthetic_batch(torch, cfg, b, frames_per_clip)
        frames, labels = frames.cuda(), labels.cuda()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls, dev, k2 = [], [], [], []
        for i in range(warmup + timed):
            tnms.lane_nms.launches = 0
            trc.router_chain.launches = trc.router_chain.launches_bf16 = 0
            tw8.w8_matmul.launches = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            state, metrics = step(state, frames, labels,
                                  step_seed(cfg.train.seed, state.step))
            end.record()
            losses.append(metrics["loss"].item())  # waits for the card
            walls.append(time.perf_counter() - t0)
            dev.append(start.elapsed_time(end))
            k2.append((trc.router_chain.launches,
                       trc.router_chain.launches_bf16))
            if tnms.lane_nms.launches or tw8.w8_matmul.launches:
                raise AssertionError("a training step launched K1 or K3")
        peak = torch.cuda.max_memory_allocated()
        n = 2 * chain_per_frame(cfg) * frames_per_clip
        want_k2 = (0, n) if bf16_chain else (n, 0)
        if any(k != want_k2 for k in k2):
            raise AssertionError(f"{tag}: router_chain launches a step "
                                 f"(float32, bf16) {k2}, want {want_k2} (3 "
                                 f"a frame, forward and remat)")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"{tag} losses {losses}: not finite or not "
                                 f"falling from the first step to the last")
        w = np.array(walls[warmup:]) * 1e3
        p50 = float(np.percentile(w, 50))
        d50 = float(np.percentile(dev[warmup:], 50))
        out[b] = {"step_p50_ms": p50, "clip_frames_per_s":
                  b * frames_per_clip / p50 * 1e3, "device_ms_p50": d50,
                  "peak_mib": peak / 2 ** 20,
                  "k2_launches": k2[-1][1 if bf16_chain else 0],
                  "losses": losses}
        print(f"[{tag} B={b}] {b} x {frames_per_clip} frames at "
              f"{cfg.model.img_h}x{cfg.model.img_w}, dropout 0.1, "
              f"{warmup} + {timed} steps: step wall p50 {p50:.1f} ms "
              f"(all {', '.join(f'{x:.1f}' for x in w)}), "
              f"{out[b]['clip_frames_per_s']:.2f} clip-frames/s, CUDA-event "
              f"ms a step p50 {d50:.1f}, peak device memory "
              f"{peak / 2 ** 20:.1f} MiB; router_chain launches a step "
              f"(float32, bf16) {k2[-1]}; losses "
              f"{', '.join(f'{x:.4f}' for x in losses)} [{card}]")
        if b in counted:
            n_k, k_ms = cuda_kernels(torch, lambda: step(
                state, frames, labels, step_seed(cfg.train.seed,
                                                 state.step)))
            out[b].update(launches=n_k, device_ms=k_ms)
            print(f"[{tag} B={b}] one step under the profiler (card "
                  f"activity only): {n_k} kernel launches, device kernel "
                  f"time {k_ms:.1f} ms (busy {k_ms / p50:.3f} of the "
                  f"unprofiled p50) [{card}]")
        del state, frames, labels
    return out


def phase_trainer(torch, card, frames_per_clip=4):
    """``train()`` for one epoch, then resumed for a second."""
    from phnet_torch.data import ClipLoader, SyntheticVideoDataset
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.train.checkpoint import CheckpointManager
    from phnet_torch.train.state import create_train_state
    from phnet_torch.train.trainer import train

    cfg = train_config(0.1, epoch_per_test=1, epochs_per_increment=1)
    m = cfg.model

    def data():
        ds = SyntheticVideoDataset(
            n_videos=2, frames_per_video=frames_per_clip, img_h=m.img_h,
            img_w=m.img_w, spec=m.lane, max_lanes=m.max_lanes,
            skip_increment=cfg.train.skip_increment)
        return ds, ClipLoader(ds, batch_size=1, seed=cfg.train.seed)

    t0 = time.perf_counter()
    trc.router_chain.launches = 0
    with tempfile.TemporaryDirectory() as workdir:
        ds, loader = data()
        state, first = train(cfg, ds, loader, workdir, epochs=1,
                             verbose=False)
        saved = (state.step, ds.max_skip)
        fresh = create_train_state(cfg, 4, "cuda", seed=5)
        fresh, epoch, max_skip = CheckpointManager(workdir).restore_state(
            fresh)
        if (fresh.step, epoch, max_skip) != (saved[0], 1, saved[1]):
            raise AssertionError(f"restored step {fresh.step}, epoch {epoch}"
                                 f", max_skip {max_skip}; saved {saved}, "
                                 f"epoch 1")
        del fresh
        ds2, loader2 = data()
        state2, second = train(cfg, ds2, loader2, workdir, epochs=2,
                               resume=True, verbose=False)
        files = sorted(os.listdir(workdir))
    k2 = trc.router_chain.launches
    if not (len(first) == len(second) == 1
            and np.isfinite(first + second).all()):
        raise AssertionError(f"trainer epoch losses {first} then {second}")
    if state2.step != 4 or ds2.max_skip != 10 or saved != (2, 5):
        raise AssertionError(f"trainer: step {state2.step}, max_skip "
                             f"{ds2.max_skip} after the resumed epoch")
    print(f"[trainer] epoch 1 loss {first[0]:.4f} (step {saved[0]}, "
          f"max_skip {saved[1]} saved), resumed from step {saved[0]}, epoch "
          f"1, max_skip {saved[1]}; epoch 2 loss {second[0]:.4f}, step "
          f"{state2.step}, max_skip {ds2.max_skip}; files {files}; "
          f"router_chain launches {k2}; {time.perf_counter() - t0:.1f} s "
          f"[{card}]")


def phase_trainer_openlane(torch, card, frames_per_clip=4, variant="single"):
    """``python -m phnet_torch.train.openlane --synthetic --variant
    variant`` through its ``main`` (bf16, its default) on one synthetic
    video of ``frames_per_clip`` frames, one step an epoch:
    ``epoch_per_test`` epochs (5: the preset saves its first resumable
    checkpoint there), then resumed for one more. Where the head has the
    router chain (``Router4OL``), K2's bf16 mode launches 3 times a frame,
    again in the remat recompute, every step; its float32 instance never;
    the other heads launch neither."""
    from phnet_torch import config
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.train import openlane as cli

    cfg = getattr(config, cli.VARIANTS[variant])()
    every = cfg.train.epoch_per_test
    t0 = time.perf_counter()
    trc.router_chain.launches = trc.router_chain.launches_bf16 = 0
    with tempfile.TemporaryDirectory() as workdir:
        argv = ["--synthetic", "--frames", str(frames_per_clip),
                "--synthetic-videos", "1", "--batch", "1", "--workdir",
                workdir, "--variant", variant]
        first = cli.main(argv + ["--epochs", str(every)])
        second = cli.main(argv + ["--epochs", str(every + 1), "--resume"])
        files = sorted(os.listdir(workdir))
    k2 = (trc.router_chain.launches, trc.router_chain.launches_bf16)
    want_k2 = (0, (every + 1) * 2 * chain_per_frame(cfg)
               * frames_per_clip)
    if not (len(first) == every and len(second) == 1
            and np.isfinite(first + second).all()):
        raise AssertionError(f"OL trainer epoch losses {first} then "
                             f"{second}")
    if f"epoch_{every}.pt" not in files or k2 != want_k2:
        raise AssertionError(f"OL trainer: files {files}, K2 launches "
                             f"(float32, bf16) {k2}, want {want_k2}")
    print(f"[trainer openlane {variant}] python -m phnet_torch.train."
          f"openlane --synthetic --variant {variant} (bf16), "
          f"{frames_per_clip}-frame clips, one step an epoch: epoch losses "
          f"{', '.join(f'{x:.4f}' for x in first)}, resumed from epoch "
          f"{every}: {second[0]:.4f}; files {files}; K2 launches (float32, "
          f"bf16) {k2}; {time.perf_counter() - t0:.1f} s [{card}]")


PROPAGATE = "openlane_propagate_config"
MULTISCALE = "openlane_multiscale_config"


def phase_propagate(torch, card):
    """Phases 26-27: ``openlane_propagate_config`` (``Router4OLV3``) served
    at full width with phase 5's schedule in float32, bf16 and w8 (lane
    NMS once a tick over the 244 rows, K3 12 times a tick in w8, the
    router chain never); then a 3-frame clip card against CPU, in float32
    with cuDNN's TF32 flag on and in bf16, the carry reaching the later
    frames. Returns ``{(quantize, compute dtype): phase_serving's
    numbers}``."""
    state_dict = seeded_state_dict(torch, preset_config(PROPAGATE))
    out = {}
    for mode, dtype in (("none", "float32"), ("none", "bfloat16"),
                        ("w8", "float32")):
        out[(mode, dtype)] = phase_serving(
            torch, card, state_dict, mode, preset=PROPAGATE,
            compute_dtype=dtype)
    torch.backends.cudnn.allow_tf32 = True  # a user's default
    try:
        phase_end_to_end(torch, card, state_dict, preset=PROPAGATE,
                         frames=3)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    phase_end_to_end(torch, card, state_dict, preset=PROPAGATE,
                     compute_dtype="bfloat16", frames=3)
    return out


def phase_multiscale_bf16(torch, card):
    """Phase 28: ``openlane_multiscale_config(compute_dtype="bfloat16")``
    (the encoder in bf16, the head in float32) served unquantized and in
    w8 (K3 13 times a tick, its x float32), then card against CPU.
    Returns ``{quantize: phase_serving's numbers}``."""
    state_dict = seeded_state_dict(torch, preset_config(MULTISCALE))
    out = {mode: phase_serving(torch, card, state_dict, mode,
                               preset=MULTISCALE, compute_dtype="bfloat16")
           for mode in ("none", "w8")}
    phase_end_to_end(torch, card, state_dict, preset=MULTISCALE,
                     compute_dtype="bfloat16")
    return out


def phase_train_heads(torch, card, frames_per_clip=2):
    """Phase 29: the multi-scale and prior-propagation heads in training:
    a step card against CPU in float32 (phase 15, a 2-frame clip) and
    bf16 (phase 21, 4 frames), cuDNN's TF32 flag on; a timed B=1, T=16 bf16 step of
    each (its launches and kernel time from one step under the card-only
    profiler); the OL command line's ``main`` with ``--variant`` to the
    first resumable checkpoint and a resume. Neither head launches K2.
    The steps against the CPU come last, so that the background process
    (:class:`CpuReferences`) has their CPU sides ready. Returns the
    throughput numbers by preset."""
    out = {preset: phase_train_throughput(
        torch, card, batches=(1,), timed=1, preset=preset,
        compute_dtype="bfloat16")[1]
        for preset in (MULTISCALE, PROPAGATE)}
    for variant in ("multiscale", "propagate"):
        phase_trainer_openlane(torch, card, frames_per_clip, variant)
    torch.backends.cudnn.allow_tf32 = True  # a user's default
    try:
        for preset in (MULTISCALE, PROPAGATE):
            phase_train_parity(torch, card, preset, frames_per_clip)
            phase_train_parity_bf16(torch, card, preset)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return out


# the evaluation path's data: the committed on-disk fixture
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "fixtures", "torch_eval")
# the card's decode (nvJPEG's planes, libjpeg's upsampling and colour
# conversion in PyTorch) against libjpeg's uint8 RGB (``decoded_u8.npz``,
# written where libjpeg exists), in levels: what the two IDCTs' rounding
# leaves, measured on the fixture with phase 31 on an NVIDIA H100 80GB
# HBM3 at 700 W (CUDA 12.8's nvJPEG): at most 3, 0.043 on average
NVJPEG_MAX_LEVELS = 4
NVJPEG_MEAN_LEVELS = 0.1


def phase_host_build():
    """Phase 30: the data and evaluation paths' host libraries, with
    ``g++``: the nvJPEG decoder and encoder, the CULane evaluator and the
    PNG codec's unfilter (the libjpeg loader is the CPU's and does not
    build where there is no libjpeg)."""
    from phnet_torch.ops import _build

    names = ["nvjpeg_decode", "culane_eval", "png_unfilter"]
    t0 = time.perf_counter()
    _build.build(names)
    print(f"[host build] {names} in {time.perf_counter() - t0:.1f} s (g++ "
          f"{' '.join(_build.GXX_FLAGS)}; libraries in {_build.BUILD_DIR})")


def timed_clips(torch, reader):
    """Every clip of ``reader``, once to warm up and once timed: (clips,
    seconds a frame, frames)."""
    reader[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clips = [reader[i] for i in range(len(reader))]
    torch.cuda.synchronize()
    n = sum(len(c["frame_names"]) for c in clips)
    return clips, (time.perf_counter() - t0) / n, n


def phase_readers(torch, card):
    """Phase 31: both fixture trees through the port's readers on the card
    (nvJPEG's planes, then libjpeg's upsampling and colour conversion, the
    crop, the resize and the normalization in PyTorch there): clip fields
    and frame shapes, decode ms a frame at each source size (the whole
    reader; the decode to uint8 RGB alone), and the decode's uint8 frames
    against the libjpeg decode of the same files (``decoded_u8.npz``, every
    7th row and column): at most ``NVJPEG_MAX_LEVELS`` and
    ``NVJPEG_MEAN_LEVELS`` on average over every sampled value, what the
    two IDCTs' rounding leaves."""
    from phnet_torch.config import openlane_config, vil100_config
    from phnet_torch.data.native_loader import NvJpegDecoder
    from phnet_torch.data.openlane import OpenLaneDataset
    from phnet_torch.data.vil100 import VIL100Dataset

    out = {}
    ref = np.load(os.path.join(FIXTURE, "decoded_u8.npz"))
    stride = int(ref["stride"])
    with NvJpegDecoder() as dec:
        for key, preset, reader_cls, n_clips in (
                ("vil", vil100_config, VIL100Dataset, 2),
                ("ol", openlane_config, OpenLaneDataset, 1)):
            cfg = preset()
            reader = reader_cls(FIXTURE, cfg.model)
            clips, sec, n = timed_clips(torch, reader)
            shape = (4, cfg.model.img_h, cfg.model.img_w, 3)
            for c in clips:
                f = c["frames"]
                if (len(clips) != n_clips or not f.is_cuda
                        or tuple(f.shape) != shape
                        or not bool(torch.isfinite(f).all())
                        or c["labels"].shape[:2] != (4, cfg.model.max_lanes)):
                    raise AssertionError(f"[readers {key}] clip {c['name']}"
                                         f": {tuple(f.shape)} on "
                                         f"{f.device}, labels "
                                         f"{c['labels'].shape}")
            paths = [os.path.join(FIXTURE, p) for p in ref[key + "_files"]]
            want = ref[key].astype(np.int16)

            def levels(u8):
                got = u8[:, ::stride, ::stride].cpu().numpy()
                return np.abs(got.astype(np.int16) - want)

            u8 = dec.decode(paths)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.decode(paths)
            torch.cuda.synchronize()
            nv_sec = (time.perf_counter() - t0) / len(paths)
            diff = levels(u8)
            src = tuple(u8.shape[1:3])
            print(f"[readers {key}] {len(clips)} clips, {n} frames of "
                  f"{src[1]}x{src[0]} -> {shape[2]}x{shape[1]}: reader "
                  f"{1e3 * sec:.2f} ms a frame (decode, resize, normalize "
                  f"on the card; labels on the host), decode to uint8 RGB "
                  f"alone {1e3 * nv_sec:.2f} ms a frame; against libjpeg: "
                  f"max {int(diff.max())}, mean {diff.mean():.4f} levels, "
                  f"{(diff > 0).mean():.4f} of values differ "
                  f"({diff.size} sampled) [{card}]")
            if (diff.max() > NVJPEG_MAX_LEVELS
                    or diff.mean() > NVJPEG_MEAN_LEVELS):
                raise AssertionError(f"[readers {key}] nvJPEG is {diff.max()}"
                                     f" levels (mean {diff.mean():.4f}) "
                                     f"from libjpeg")
            out[key] = {"clips": clips, "ms_per_frame": 1e3 * sec,
                        "nvjpeg_ms_per_frame": 1e3 * nv_sec,
                        "max_levels": int(diff.max())}
    return out


def lines_tree(root):
    return sorted(os.path.relpath(p, root) for p in glob.glob(
        os.path.join(root, "*", "*.lines.txt")))


def phase_eval_pipeline(torch, card, state_dict, clips):
    """Phase 32: the VIL pipeline in float32 at full width over the
    fixture's two test videos read on the card (``clips``): on the card,
    counters zeroed just before and read just after (K1 once and K2 three
    times a frame), and on the CPU over the same frames; the emitted lines
    compared as the pipeline tests compare them (the same files, lane
    counts equal, points within 1 px: the format writes integer pixels).
    Both emissions scored with the Python and native CULane metrics at IoU
    0.5 and the temporal metric: equal where every file is byte-equal (else
    per frame on the byte-equal files); the ground truth against itself F1
    = 1 in both metrics. The ground truth and the lines are both in the
    image's frame (the weights are random, so the scores are low); the
    card's lines scored against the CPU's (one frame) must match lanes
    (TP > 0) with equal counts in both metrics. Prints the path's frames
    a second (decode + model + emit) beside the pipeline's model-only
    rate."""
    from phnet_torch.config import vil100_config
    from phnet_torch.data.vil100 import VIL100Dataset
    from phnet_torch.evaluation.culane_metric import (aggregate_results,
                                                      culane_metric)
    from phnet_torch.evaluation.emit import read_lines_txt
    from phnet_torch.evaluation.native_eval import evaluate_pairs
    from phnet_torch.evaluation.temporal import (aggregate_temporal,
                                                 temporal_metric_video)
    from phnet_torch.ops import nms as tnms
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.ops import w8_matmul as tw8
    from phnet_torch.pipeline import InferencePipeline

    cfg = vil100_config()
    shape = (720, 1280, 3)
    n_frames = sum(len(c["frame_names"]) for c in clips)
    with tempfile.TemporaryDirectory() as tmp:
        def d(name):
            return os.path.join(tmp, name)

        pipe = InferencePipeline(cfg, state_dict, chunk=4)
        pipe.run_video(clips[0]["frames"])  # warm-up
        reader = VIL100Dataset(FIXTURE, cfg.model)
        torch.cuda.synchronize()
        tnms.lane_nms.launches = 0
        trc.router_chain.launches = 0
        tw8.w8_matmul.launches = 0
        t0 = time.perf_counter()
        stats = pipe.run_and_emit(reader, d("card"), d("anno"))
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        k1, k2, k3 = (tnms.lane_nms.launches, trc.router_chain.launches,
                      tw8.w8_matmul.launches)
        if stats["frames"] != n_frames or k1 < n_frames or k2 < 3 * n_frames:
            raise AssertionError(f"[eval pipeline] {stats['frames']} frames;"
                                 f" launches lane_nms {k1}, router_chain "
                                 f"{k2}")
        cpu = InferencePipeline(cfg, state_dict, chunk=4, device="cpu")
        host = [dict(c, frames=c["frames"].cpu()) for c in clips]
        cpu.run_and_emit(host, d("cpu"))
        files = lines_tree(d("card"))
        if files != lines_tree(d("cpu")) or len(files) != n_frames:
            raise AssertionError("[eval pipeline] card and CPU wrote "
                                 "different files")
        same, n_lanes, worst = [], 0, 0.0
        for f in files:
            a = read_lines_txt(os.path.join(d("card"), f))
            b = read_lines_txt(os.path.join(d("cpu"), f))
            if len(a) != len(b) or any(len(x) != len(y)
                                       for x, y in zip(a, b)):
                raise AssertionError(f"[eval pipeline] {f}: lanes differ "
                                     f"card {a} CPU {b}")
            for x, y in zip(a, b):
                worst = max(worst, float(np.abs(np.subtract(x, y)).max()))
            n_lanes += len(a)
            with open(os.path.join(d("card"), f), "rb") as fa, open(
                    os.path.join(d("cpu"), f), "rb") as fb:
                if fa.read() == fb.read():
                    same.append(f)
        if worst > 1.0 or n_lanes == 0:
            raise AssertionError(f"[eval pipeline] points {worst} px apart,"
                                 f" {n_lanes} lanes")
        scores = {}
        for run in ("card", "cpu"):
            pairs = [(os.path.join(d(run), f), os.path.join(d("anno"), f))
                     for f in files]
            per_frame = [culane_metric(read_lines_txt(p), read_lines_txt(a),
                                       shape) for p, a in pairs]
            videos = {}
            for f, (p, a) in zip(files, pairs):
                videos.setdefault(f.split("/")[0], []).append(
                    (read_lines_txt(p), read_lines_txt(a)))
            temporal = aggregate_temporal([temporal_metric_video(
                [a for _, a in v], [p for p, _ in v], [shape] * len(v))
                for v in videos.values()])
            scores[run] = {"python": aggregate_results(per_frame),
                           "native": evaluate_pairs(pairs, 1280, 720),
                           "temporal": temporal, "per_frame": per_frame}
        card_s, cpu_s = scores["card"], scores["cpu"]
        if len(same) == len(files):
            for k in ("python", "native", "temporal"):
                if card_s[k] != cpu_s[k]:
                    raise AssertionError(f"[eval pipeline] {k} scores "
                                         f"differ: {card_s[k]} {cpu_s[k]}")
        for i, f in enumerate(files):
            if f in same:
                a, b = card_s["per_frame"][i], cpu_s["per_frame"][i]
                if a[:3] != b[:3] or not np.array_equal(a[3], b[3]):
                    raise AssertionError(f"[eval pipeline] {f} scores differ")
        gt_pairs = [(os.path.join(d("anno"), f),) * 2 for f in files]
        gt_native = evaluate_pairs(gt_pairs, 1280, 720)
        gt_python = aggregate_results([culane_metric(
            read_lines_txt(a), read_lines_txt(a), shape)
            for a, _ in gt_pairs])
        if gt_native["F1"] != 1.0 or gt_python["F1"] != 1.0:
            raise AssertionError(f"[eval pipeline] GT against itself: "
                                 f"native {gt_native}, python {gt_python}")
        # the card's lines scored against the CPU's (random weights score
        # low against the ground truth), so that the metrics match lanes:
        # TP > 0, and the Python and native counts equal
        cross = [(os.path.join(d("card"), f), os.path.join(d("cpu"), f))
                 for f in files]
        cross_native = evaluate_pairs(cross, 1280, 720)
        cross_python = aggregate_results([culane_metric(
            read_lines_txt(p), read_lines_txt(a), shape) for p, a in cross])
        if cross_python["TP"] == 0 or any(
                cross_native[k] != cross_python[k] for k in ("TP", "FP",
                                                             "FN")):
            raise AssertionError(f"[eval pipeline] card against CPU lines: "
                                 f"native {cross_native}, python "
                                 f"{cross_python}")
    model_fps = stats["fps"]
    path_fps = n_frames / path_s
    print(f"[eval pipeline] VIL f32 over the fixture: {n_frames} frames, "
          f"{n_lanes} lanes, card vs CPU {len(same)}/{len(files)} files "
          f"byte-equal, points at most {worst:.0f} px apart; launches "
          f"lane_nms {k1}, router_chain {k2}, w8_matmul {k3}; scores at IoU "
          f"0.5 card "
          f"{ {k: round(v, 4) for k, v in card_s['native'].items()} }"
          f", python F1 {card_s['python']['F1']:.4f} (CPU "
          f"{cpu_s['python']['F1']:.4f}), temporal {card_s['temporal']}; GT "
          f"vs GT F1 native {gt_native['F1']}, python {gt_python['F1']}; "
          f"card vs CPU lines TP {cross_python['TP']} FP "
          f"{cross_python['FP']} FN {cross_python['FN']}, F1 native "
          f"{cross_native['F1']:.4f}, python {cross_python['F1']:.4f}; "
          f"path (decode + model + emit) {path_fps:.2f} frames/s, model "
          f"{model_fps:.2f} frames/s [{card}]")
    return {"path_fps": path_fps, "model_fps": model_fps,
            "lane_nms": k1, "router_chain": k2}


def write_port_checkpoint(torch, cfg, state_dict, workdir):
    """``state_dict`` as a ``phnet_torch.train`` checkpoint named best;
    returns the command lines' ``--checkpoint``."""
    from phnet_torch.train.checkpoint import CheckpointManager
    from phnet_torch.train.state import create_train_state

    state = create_train_state(cfg, 1, "cpu")
    state.model.load_state_dict(state_dict, strict=True)
    CheckpointManager(workdir).save(state, epoch=0, max_skip=0, is_best=True,
                                    periodic=False)
    return os.path.join(workdir, "best")


def phase_eval_cli(torch, card, state_dict):
    """Phase 33: the three command lines as subprocesses on the fixture, on
    the card, with weights from port checkpoints this phase writes (the
    seeded VIL weights; seeded ``openlane_config`` weights): ``test_vil
    --evaluate``, ``test_ol --variant single``, ``evaluate --native
    --temporal``; each must exit 0 (their last lines are printed)."""
    from phnet_torch.config import openlane_config, vil100_config

    ol_cfg = openlane_config()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        vil_ckpt = write_port_checkpoint(torch, vil100_config(), state_dict,
                                         os.path.join(tmp, "vil"))
        ol_ckpt = write_port_checkpoint(
            torch, ol_cfg, seeded_state_dict(torch, ol_cfg),
            os.path.join(tmp, "ol"))
        pred, anno = os.path.join(tmp, "pred"), os.path.join(tmp, "anno")
        runs = (
            ("test_vil", ["--data-root", FIXTURE, "--checkpoint", vil_ckpt,
                          "--pred-dir", pred, "--anno-dir", anno,
                          "--evaluate"]),
            ("test_ol", ["--data-root", FIXTURE, "--checkpoint", ol_ckpt,
                         "--variant", "single", "--pred-dir",
                         os.path.join(tmp, "ol_pred")]),
            ("evaluate", ["--pred-dir", pred, "--anno-dir", anno,
                          "--height", "720", "--width", "1280", "--native",
                          "--temporal"]))
        # test_vil and test_ol side by side, then evaluate on test_vil's
        for batch in (runs[:2], runs[2:]):
            t0 = time.perf_counter()
            procs = []
            try:
                for name, args in batch:  # output to files: no pipe fills
                    logs = [open(os.path.join(tmp, f"{name}.{k}"), "w+")
                            for k in ("out", "err")]
                    procs.append((name, logs, subprocess.Popen(
                        [sys.executable, "-m", f"phnet_torch.run.{name}",
                         *args], stdout=logs[0], stderr=logs[1], text=True,
                        cwd=root, env=env)))
                for _, _, proc in procs:
                    proc.wait(timeout=600)
            finally:
                for _, logs, proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
            outs = []
            for name, logs, proc in procs:
                for f in logs:
                    f.seek(0)
                outs.append((name, proc, logs[0].read(), logs[1].read()))
                for f in logs:
                    f.close()
            for name, proc, stdout, stderr in outs:
                tail = (stdout.strip().splitlines() or [""])[-1]
                print(f"[eval cli] {name}: exit {proc.returncode} in "
                      f"{time.perf_counter() - t0:.1f} s (of {len(batch)} "
                      f"side by side): {tail} [{card}]")
                if proc.returncode != 0:
                    raise AssertionError(f"[eval cli] {name} exited "
                                         f"{proc.returncode}:\n{stdout}\n"
                                         f"{stderr}")
        n_ol = len(lines_tree(os.path.join(tmp, "ol_pred")))
        if len(lines_tree(pred)) != 8 or n_ol != 4:
            raise AssertionError(f"[eval cli] wrote {len(lines_tree(pred))} "
                                 f"VIL and {n_ol} OL files")


# the augmentation's gate, card against CPU on the same uint8 frames (the
# CPU tests hold the CPU path to OpenCV with it: measured 0 levels there)
AUG_MAX_LEVELS, AUG_MAX_SHARE = 1, 0.01
TRAIN_TREE_FRAMES = 20  # frames of the training tree's one video each


def levels_apart(torch, a, b):
    """(max levels, share of values differing) of two uint8 images."""
    d = (a.cpu().to(torch.int16) - b.cpu().to(torch.int16)).abs()
    return int(d.max()), float((d > 0).float().mean())


def phase_augment(torch, card):
    """Phase 34: the training augmentation (``data/transforms.py``, PyTorch
    on the card) against the same code on the CPU, on the same uint8
    frames (a VIL fixture frame at 1280x720 cut by 35%, an OpenLane one at
    1920x1280 cropped by 480 rows, decoded by nvJPEG): each op alone at
    pinned parameters (the resize to 384x768, then on the resized frame
    brightness, hue / saturation either way, median blur k 3 and 5, motion
    blur k 3, 4 and 5, the affine at its extremes), then the whole
    ``TrainAugment`` (VIL's and OL's) under 8 seeds each, lanes and ids
    equal; at most ``AUG_MAX_LEVELS`` on under ``AUG_MAX_SHARE`` of the
    values. Prints the ms a frame of the whole augmentation on the card
    (CUDA-synchronized wall) and on the CPU."""
    from phnet_torch.data import transforms as T
    from phnet_torch.data.native_loader import NvJpegDecoder

    ref = np.load(os.path.join(FIXTURE, "decoded_u8.npz"))
    out = {}
    with NvJpegDecoder() as dec:
        for key, cut_of in (("vil", lambda h: int(h * 0.35)),
                            ("ol", lambda h: 480)):
            src = dec.decode([os.path.join(FIXTURE, ref[key + "_files"][0])])
            src = src[0, cut_of(src.shape[1]):]
            small = T.resize_u8(src, 384, 768)
            m = T.rotation_matrix((384.0, 192.0), 5.0, 1.1)
            m[:, 2] += (76.8, -38.4)
            ops = [("resize", lambda x: T.resize_u8(x, 384, 768), src)]
            ops += [(name, fn, small) for name, fn in (
                ("brightness", lambda x: T.brightness(x, 1.1234, -7.5)),
                ("hue_sat -9.7", lambda x: T.hue_saturation(x, -9.7)),
                ("hue_sat 6.3", lambda x: T.hue_saturation(x, 6.3)),
                ("median 3", lambda x: T.median_blur(x, 3)),
                ("median 5", lambda x: T.median_blur(x, 5)),
                ("motion 3", lambda x: T.filter2d(
                    x, T.motion_blur_kernel(3, 33.3))),
                ("motion 4", lambda x: T.filter2d(
                    x, T.motion_blur_kernel(4, 217.9))),
                ("motion 5", lambda x: T.filter2d(
                    x, T.motion_blur_kernel(5, 90.0))),
                ("affine", lambda x: T.warp_affine(x, m)))]
            worst = {}
            for name, fn, img in ops:
                lv, share = levels_apart(torch, fn(img), fn(img.cpu()))
                worst[name] = (lv, share)
                if lv > AUG_MAX_LEVELS or share > AUG_MAX_SHARE:
                    raise AssertionError(f"[augment {key}] {name}: card "
                                         f"{lv} levels from the CPU on "
                                         f"{share:.4f} of the values")
            h, w = src.shape[:2]
            lanes = [np.array([[0.2 * w, 0.95 * h], [0.45 * w, 0.3 * h]],
                              np.float32),
                     np.array([[-2.0 * w, 0.9 * h], [-1.5 * w, 0.1 * h]],
                              np.float32),
                     np.array([[0.9 * w, 0.95 * h], [1.1 * w, 0.2 * h]],
                              np.float32)]

            def aug(seed):
                rng = np.random.default_rng(seed)
                return (T.TrainAugment.ol_defaults(384, 768, rng)
                        if key == "ol" else T.TrainAugment(384, 768, rng=rng))

            times = {"card": 0.0, "cpu": 0.0}
            whole = (0, 0.0)
            for seed in range(8):
                results = {}
                for where, img in (("card", src), ("cpu", src.cpu())):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    results[where] = aug(seed)(img, lanes, [0, 1, 2])
                    torch.cuda.synchronize()
                    if seed:  # the first is the warm-up
                        times[where] += time.perf_counter() - t0
                (ci, cl, cids), (pi, pl, pids) = (results["card"],
                                                  results["cpu"])
                lv, share = levels_apart(torch, ci, pi)
                whole = (max(whole[0], lv), max(whole[1], share))
                if (cids != pids or len(cl) != len(pl)
                        or any(not np.array_equal(a, b)
                               for a, b in zip(cl, pl))
                        or lv > AUG_MAX_LEVELS or share > AUG_MAX_SHARE):
                    raise AssertionError(f"[augment {key}] seed {seed}: ids "
                                         f"{cids} / {pids}, {lv} levels on "
                                         f"{share:.4f}")
            ms = {k: 1e3 * v / 7 for k, v in times.items()}
            print(f"[augment {key}] {w}x{h} -> 768x384, card against CPU on "
                  f"the same bytes: ops (max levels, share) "
                  + ", ".join(f"{n} {v[0]}/{v[1]:.4f}"
                              for n, v in worst.items())
                  + f"; TrainAugment 8 seeds: {whole[0]} levels on "
                  f"{whole[1]:.4f}, lanes and ids equal; ms a frame card "
                  f"{ms['card']:.2f}, CPU {ms['cpu']:.2f} [{card}]")
            out[key] = dict(ms, max_levels=whole[0])
    return out


def make_train_tree(root):
    """A training tree under ``root`` from the fixture: VIL-100's train
    video and an OpenLane ``training`` video made from its validation
    video, each of ``TRAIN_TREE_FRAMES`` frames (the fixture's 4 JPEGs and
    labels repeated in turn)."""
    import shutil

    vid = "1_Road010_Trim002_frames"
    src = os.path.join(FIXTURE, "VIL100")
    names = sorted(f[:5] for f in os.listdir(os.path.join(src, "Json", vid)))
    for sub, ext in (("JPEGImages", ".jpg"), ("Json", ".jpg.json")):
        os.makedirs(os.path.join(root, "VIL100", sub, vid))
        for i in range(TRAIN_TREE_FRAMES):
            shutil.copy(os.path.join(src, sub, vid, names[i % 4] + ext),
                        os.path.join(root, "VIL100", sub, vid,
                                     f"{i:05d}{ext}"))
    os.makedirs(os.path.join(root, "VIL100", "data"))
    with open(os.path.join(root, "VIL100", "data", "db_info.yaml"), "w") as f:
        f.write(f"sequences:\n- name: {vid}\n  set: train\n")
    ol = os.path.join(FIXTURE, "OpenLane")
    seg = os.listdir(os.path.join(ol, "images", "validation"))[0]
    stamps = sorted(f[:-4] for f in os.listdir(os.path.join(
        ol, "images", "validation", seg)))
    for sub, ext in (("images", ".jpg"),
                     (os.path.join("OpenLane-V", "label"), ".pickle")):
        dst = os.path.join(root, "OpenLane", sub, "training", seg)
        os.makedirs(dst)
        for i in range(TRAIN_TREE_FRAMES):
            shutil.copy(os.path.join(ol, sub, "validation", seg,
                                     stamps[i % 4] + ext),
                        os.path.join(dst, f"{int(stamps[0]) + i}{ext}"))
    return root


def phase_train_readers(torch, card, tree):
    """Phase 35: the readers' train mode on the card at the presets' full
    width (384x768), T = 16, on the training tree: VIL's two clips an
    epoch and OL's one (flip and reversal drawn), two epochs with a
    curriculum step, against the same readers on the CPU given the card's
    decoded bytes (the card's machine has no libjpeg; phase 31 holds
    nvJPEG to libjpeg): frame names, labels and points equal, frames
    within the augmentation's gate (normalized: ``AUG_MAX_LEVELS`` / 255 /
    0.225). Prints the ms a frame of the whole reader on the card (decode,
    crop, augmentation, normalization, labels) and of the decode alone."""
    from phnet_torch.config import openlane_config, vil100_config
    from phnet_torch.data.openlane import OpenLaneDataset
    from phnet_torch.data.transforms import TrainAugment
    from phnet_torch.data.vil100 import VIL100Dataset

    out = {}
    for key, preset, cls, kw, make_aug in (
            ("vil", vil100_config, VIL100Dataset,
             dict(max_skip=5, skip_increment=5, samples_per_video=2),
             lambda m, rng: TrainAugment(m.img_h, m.img_w, rng=rng)),
            ("ol", openlane_config, OpenLaneDataset,
             dict(max_skip=1, skip_increment=1, samples_per_video=1),
             lambda m, rng: TrainAugment.ol_defaults(m.img_h, m.img_w,
                                                     rng))):
        m = preset().model

        def reader(device, seed=7):
            return cls(tree, m, train=True, device=device, sampled_frames=16,
                       augment=make_aug(m, np.random.default_rng(seed)),
                       seed=seed, **kw)

        on_card, on_cpu = reader(None), reader("cpu")
        on_cpu.decode.u8 = lambda paths: on_card.decode.u8(paths).cpu()
        worst, n, t_read, skips = 0.0, 0, 0.0, []
        for epoch in range(2):
            skips.append(on_card.max_skip)
            for i in range(len(on_card)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = on_card[i]
                torch.cuda.synchronize()
                if epoch or i:
                    t_read += time.perf_counter() - t0
                    n += len(got["frame_names"])
                want = on_cpu[i]
                f = got["frames"]
                if (not f.is_cuda or tuple(f.shape) != (16, 384, 768, 3)
                        or got["frame_names"] != want["frame_names"]
                        or not np.array_equal(got["labels"], want["labels"])
                        or any(len(a) != len(b) or any(
                            not np.array_equal(x, y) for x, y in zip(a, b))
                            for a, b in zip(got["points"],
                                            want["points"]))):
                    raise AssertionError(f"[train readers {key}] clip {i} "
                                         f"epoch {epoch}: fields differ")
                worst = max(worst, float((f.cpu() - want["frames"]).abs()
                                         .max()))
            on_card.increase_max_skip()
            on_cpu.increase_max_skip()
        if worst > AUG_MAX_LEVELS / 255.0 / 0.225:
            raise AssertionError(f"[train readers {key}] frames {worst} "
                                 f"apart (normalized)")
        vid = on_card.videos[0]
        imgdir = (os.path.join(tree, "VIL100", "JPEGImages", vid)
                  if key == "vil" else os.path.join(on_card.img_root, vid))
        paths = sorted(os.path.join(imgdir, f)
                       for f in os.listdir(imgdir))[:16]
        on_card.decode.u8(paths)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card.decode.u8(paths)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0) / 16
        read_ms = 1e3 * t_read / max(n, 1)
        print(f"[train readers {key}] {len(on_card)} clip(s) an epoch of 16 "
              f"frames at 768x384, two epochs (max_skip {skips[0]} then "
              f"{skips[1]}): names, labels and points equal to "
              f"the CPU's on the same bytes, frames at most {worst:.3g} "
              f"apart (normalized); reader {read_ms:.2f} ms a frame on the "
              f"card, decode alone {decode_ms:.2f} ms a frame [{card}]")
        out[key] = {"read_ms": read_ms, "decode_ms": decode_ms}
    return out


_CLI_WRAP = (
    "import importlib, json, sys; "
    "from phnet_torch.ops import router_chain as rc; "
    "importlib.import_module(sys.argv[1]).main(sys.argv[2:]); "
    "print('K2 ' + json.dumps([rc.router_chain.launches, "
    "rc.router_chain.launches_bf16]))")


def run_train_cli(module, args, root, env):
    """``module``'s ``main(args)`` in a subprocess on the card; returns
    (seconds, the output's steps, wall p50, data wait share, epoch losses,
    K2 launches (float32, bf16)), raising on a non-zero exit."""
    import ast
    import re

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CLI_WRAP, module, *args],
                          capture_output=True, text=True, timeout=600,
                          cwd=root, env=env)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[train cli] {module} {' '.join(args)} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    text = proc.stdout
    steps = re.search(r"steps (\d+): wall p50 ([\d.]+) s, data wait "
                      r"([\d.]+) s of ([\d.]+) s", text)
    losses = re.search(r"done; epoch losses: (\[.*\])", text)
    k2 = re.search(r"^K2 (\[.*\])$", text, re.M)
    if not (steps and losses and k2):
        raise AssertionError(f"[train cli] {module}: no summary in\n"
                             f"{text[-3000:]}")
    return dict(seconds=sec, steps=int(steps.group(1)),
                p50=float(steps.group(2)),
                share=float(steps.group(3)) / float(steps.group(4)),
                wall=float(steps.group(4)),
                losses=ast.literal_eval(losses.group(1)),
                k2=json.loads(k2.group(1)))


def phase_train_cli(torch, card, tree, synthetic):
    """Phase 36: both training command lines in subprocesses on the
    training tree, on the card at the presets' full width, T = 16, B = 1,
    bf16 (their default): ``python -m phnet_torch.train --data-root tree
    --assigner dynamic_k`` for an epoch (two steps); ``python -m
    phnet_torch.train.openlane --data-root tree`` to the preset's first
    resumable checkpoint (epoch 5, one step an epoch), then resumed for a
    sixth. Each must exit 0 with finite losses and its checkpoints, K2
    launching 96 times a step (3 a frame, again in the remat recompute).
    Prints the step wall p50 and the loader's wait share (the trainer's
    data seconds over the steps' wall), both over the steps after a
    process's first, clip-frames/s (16 / p50) beside the same B = 1,
    T = 16 bf16 step on synthetic clips in this call (``synthetic``:
    phases 23-24's step p50 in ms by "vil" and "ol", no loader), and K2's
    launches a step. Returns the runs' numbers."""
    from phnet_torch.config import openlane_config, vil100_config

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    vil, ol = "phnet_torch.train.__main__", "phnet_torch.train.openlane"
    k2_step = {vil: 2 * chain_per_frame(vil100_config()) * 16,
               ol: 2 * chain_per_frame(openlane_config()) * 16}
    out = {}
    with tempfile.TemporaryDirectory() as work:
        runs = (
            ("vil dynamic_k", vil, ["--epochs", "1", "--assigner",
                                    "dynamic_k"], "vil", ["best.pt"]),
            ("ol", ol, ["--epochs", "5"], "ol", ["epoch_5.pt", "best.pt"]),
            ("ol resumed", ol, ["--epochs", "6", "--resume"], "ol",
             ["epoch_5.pt"]))
        for tag, module, args, workdir, files in runs:
            workdir = os.path.join(work, workdir)
            r = run_train_cli(module, args + [
                "--data-root", tree, "--frames", "16", "--batch", "1",
                "--workdir", workdir], root, env)
            got = os.listdir(workdir)
            k2 = sum(r["k2"]) / r["steps"]
            if (not r["losses"] or not np.isfinite(r["losses"]).all()
                    or any(f not in got for f in files)
                    or k2 != k2_step[module]):
                raise AssertionError(f"[train cli] {tag}: losses "
                                     f"{r['losses']}, files {sorted(got)}, "
                                     f"K2 {r['k2']} over {r['steps']} steps")
            r["k2_per_step"] = k2
            out[tag] = r
            syn = synthetic[tag[:3].strip()] / 1e3
            print(f"[train cli] {tag}: exit 0 in {r['seconds']:.1f} s, "
                  f"{r['steps']} steps, losses {r['losses']}; after the "
                  f"first step: wall p50 {r['p50']:.3f} s ("
                  f"{16 / r['p50']:.2f} clip-frames/s; synthetic clips "
                  f"without the loader {syn:.3f} s, {16 / syn:.2f}), data "
                  f"wait share {r['share']:.4f}; K2 a step {k2:g} (float32, "
                  f"bf16 totals {r['k2']}) [{card}]")
    return out


def phase_backbones(torch, card, ticks=8):
    """Phase 37: ``vil100_config`` with each of :data:`BACKBONES` at full
    width (seeded weights, RevCol's ``gamma`` widened), served at 4
    streams by phase 5's schedule in float32 and bf16 (lane NMS once and
    the router chain three times a tick, counters zeroed just before and
    read just after; one tick more under the card-only profiler), then a
    2-frame clip card against CPU (phase 6's gates in float32, phase 20's
    in bf16, cuDNN's TF32 flag on). The preset's ResNet-18 is served
    first, the same way, for the profiled tick beside theirs (phases 6 and
    20 hold it card against CPU). Returns the serving numbers by
    (backbone, compute dtype)."""
    from phnet_torch.config import vil100_config

    out = {}
    for backbone in ("resnet18",) + BACKBONES:
        state_dict = seeded_state_dict(torch, with_backbone(
            vil100_config(), backbone))
        for dtype in ("float32", "bfloat16"):
            out[(backbone, dtype)] = phase_serving(
                torch, card, state_dict, ticks=ticks, compute_dtype=dtype,
                backbone=backbone)
            if backbone == "resnet18":
                continue
            torch.backends.cudnn.allow_tf32 = True  # a user's default
            try:
                phase_end_to_end(torch, card, state_dict, compute_dtype=dtype,
                                 backbone=backbone)
            finally:
                torch.backends.cudnn.allow_tf32 = False
        del state_dict
    return out


def phase_train_backbones(torch, card):
    """Phase 39: each of :data:`BACKBONES` in training at full width: a
    float32 step of a 2-frame clip card against CPU (phase 15's gates,
    cuDNN's TF32 flag on), then a timed B = 1, T = 16 bf16 step (the VIL
    trainer's default; RevCol with drop path 0.1 and its column
    checkpoint): K2 96 times a step, device ms, launches and busy share
    from one step under the card-only profiler, wall p50, peak memory
    (the preset's ResNet-18 has phase 23's step, by the same function in
    the same run). Returns the throughput numbers by backbone."""
    torch.backends.cudnn.allow_tf32 = True  # a user's default
    try:
        for backbone in BACKBONES:
            phase_train_parity(torch, card, frames_per_clip=2,
                               backbone=backbone)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    return {backbone: phase_train_throughput(
        torch, card, batches=(1,), timed=1, compute_dtype="bfloat16",
        backbone=backbone)[1] for backbone in BACKBONES}


def phase_revcol_checkpoint(torch, card, frames_per_clip=2, seeds=(5, 6)):
    """Phase 40: RevCol's column checkpoint on the card: float32 steps of
    a 2-frame clip at full width with drop path 0.1 and the dropout seed
    ``seeds[0]``, every column but the first recomputed in the backward
    (``revcol_save_memory``) and not: the backbone's gradients agree
    within 1e-4 of each leaf's largest entry (the recompute draws the
    same masks from the seed; cuDNN's backward sums in an order of its
    own), while the seed ``seeds[1]`` moves most leaves by more than 1e-2
    of their largest entry. ``gamma`` is drawn from N(0, 0.3), as in the
    served weights, so that a block's drop changes the ones after it.
    Peak memory of both."""
    from phnet_torch.device import full_f32
    from phnet_torch.losses import LaneCriterion
    from phnet_torch.train.state import create_train_state

    def grads(save_memory, seed):
        cfg = train_config(0.0, backbone="revcol")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, backbone=dataclasses.replace(
                cfg.model.backbone, revcol_save_memory=save_memory)))
        frames, labels = synthetic_batch(torch, cfg, 1, frames_per_clip)
        state = create_train_state(cfg, 100, "cuda", seed=0)
        state.model.load_state_dict(weights)
        crit = LaneCriterion(cfg.model, cfg.train.loss)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with full_f32():
            outs, _ = state.model.train_forward(frames.cuda(),
                                                labels.cuda(), seed)
            loss, _ = crit(outs, labels.cuda())
            loss.backward()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        return ({n: p.grad.float().cpu() for n, p in
                 state.model.named_parameters()
                 if n.startswith("encoder.backbone.")}, peak)

    weights = seeded_state_dict(torch, train_config(0.0, backbone="revcol"))
    t0 = time.perf_counter()
    (remat, peak_remat), (plain, peak_plain), (other, _) = (
        grads(True, seeds[0]), grads(False, seeds[0]), grads(True, seeds[1]))
    worst, moved = 0.0, 0
    for n, g in remat.items():
        scale = g.abs().max().item() + 1e-12
        worst = max(worst, (g - plain[n]).abs().max().item() / scale)
        moved += (other[n] - g).abs().max().item() > 1e-2 * scale
    if not worst <= 1e-4 or moved <= len(remat) // 2:
        raise AssertionError(f"RevCol column checkpoint: gradients "
                             f"{worst} of a leaf's largest entry apart "
                             f"(<= 1e-4); another seed moved {moved} of "
                             f"{len(remat)} leaves by > 1e-2")
    print(f"[revcol checkpoint] full width, 1 clip x {frames_per_clip} "
          f"frames, float32, drop path 0.1, seed {seeds[0]}: backbone "
          f"gradients with and without the column checkpoint at most "
          f"{worst:.3g} of a leaf's largest entry apart (<= 1e-4); seed "
          f"{seeds[1]} moves {moved} of {len(remat)} leaves by > 1e-2; peak "
          f"device memory {peak_remat:.1f} MiB checkpointed, "
          f"{peak_plain:.1f} MiB not; {time.perf_counter() - t0:.1f} s "
          f"[{card}]")


@contextlib.contextmanager
def deterministic(torch):
    """PyTorch's deterministic implementations (``warn_only``: an op that
    has none warns and runs its own) and cuDNN's deterministic
    algorithms, the caller's settings given back after. Yields the list
    of the warnings' distinct texts."""
    import warnings

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    seen = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
        for w in caught:
            text = str(w.message).splitlines()[0][:160]
            if "deterministic" in text and text not in seen:
                seen.append(text)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            prev[2:]


def checkpoint_payloads(torch, workdir):
    """Every checkpoint file of ``workdir``: {file: payload} on the CPU."""
    return {f: torch.load(os.path.join(workdir, f), map_location="cpu",
                          weights_only=True)
            for f in sorted(os.listdir(workdir)) if f.endswith(".pt")}


def same_bits(torch, a, b) -> bool:
    """Nested payloads (dicts, lists, tensors, numbers) equal bit for
    bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_bits(torch, a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_bits(torch, x, y) for x, y in zip(a, b)))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape
                and torch.equal(a.reshape(-1).view(torch.uint8),
                                b.reshape(-1).view(torch.uint8)))
    return a == b


def phase_distributed_training(torch, card, frames_per_clip=4):
    """Phase 41: data-parallel training on the card at world size 1, on
    NCCL. ``python -m phnet_torch.train``'s ``main`` in this process, the
    VIL-100 preset at full width in float32 (``--fp32``) with decoder
    dropout 0.1 and a checkpoint every epoch, B = 1, one synthetic video
    of ``frames_per_clip`` frames: an epoch (one step), then resumed for
    a second; once without the distributed flags and once with
    ``--coordinator 127.0.0.1:<free port> --num-processes 1 --process-id
    0`` (``initialize`` on NCCL; the step all-reduces its gradients and
    metrics, rank 0 writes the checkpoints behind a barrier). Both under
    deterministic algorithms (an op without one is printed). The gate: the
    epoch losses, the final parameters and every checkpoint file's payload
    bit-equal between the two runs, and K2 launched 3 times a frame,
    again in the remat recompute, every step of the distributed run.
    Prints the step wall p50 of each run and K2's launches a step."""
    import io
    import re

    from phnet_torch.ops import router_chain as trc
    from phnet_torch.train import __main__ as cli
    from phnet_torch.train.cli import free_port

    cfg = train_config(0.1, epoch_per_test=1)
    base = ["--synthetic", "--fp32", "--frames", str(frames_per_clip),
            "--synthetic-videos", "1", "--batch", "1"]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # rank 0 alone
    t0 = time.perf_counter()
    runs = {}
    for tag in ("one process", "nccl"):
        with tempfile.TemporaryDirectory() as work:
            trc.router_chain.launches = trc.router_chain.launches_bf16 = 0
            out = io.StringIO()
            with deterministic(torch) as notes, \
                    contextlib.redirect_stdout(out):
                losses = []
                for epochs, resume in ((1, []), (2, ["--resume"])):
                    group = [] if tag == "one process" else [
                        "--coordinator", f"127.0.0.1:{free_port()}",
                        "--num-processes", "1", "--process-id", "0"]
                    losses += cli.main(base + ["--epochs", str(epochs),
                                               "--workdir", work]
                                       + resume + group, cfg=cfg)
            walls = [float(x) for x in re.findall(r"wall p50 ([\d.]+) s",
                                                  out.getvalue())]
            runs[tag] = dict(losses=losses, files=checkpoint_payloads(
                torch, work), k2=(trc.router_chain.launches,
                                  trc.router_chain.launches_bf16),
                notes=notes, walls=walls)
    a, b = runs["one process"], runs["nccl"]
    steps = 2
    per_step = 2 * chain_per_frame(cfg) * frames_per_clip
    if sorted(b["files"]) != ["best.pt", "epoch_1.pt", "epoch_2.pt"]:
        raise AssertionError(f"[distributed training] files "
                             f"{sorted(b['files'])}")
    if b["k2"] != (per_step * steps, 0) or a["k2"] != b["k2"]:
        raise AssertionError(f"[distributed training] K2 launches "
                             f"(float32, bf16) {b['k2']} with NCCL, "
                             f"{a['k2']} without, want {per_step} a step "
                             f"over {steps} steps")
    if not (a["losses"] == b["losses"] and np.isfinite(a["losses"]).all()
            and same_bits(torch, a["files"], b["files"])):
        diff = [f for f in a["files"] if not same_bits(
            torch, a["files"][f], b["files"].get(f))]
        raise AssertionError(f"[distributed training] NCCL at world size 1 "
                             f"is not bit-equal to the one-process run: "
                             f"losses {a['losses']} / {b['losses']}, files "
                             f"differing {diff}; ops without a "
                             f"deterministic implementation: "
                             f"{a['notes'] + b['notes']}")
    print(f"[distributed training] VIL f32 full width, B=1, "
          f"{frames_per_clip}-frame clips, dropout 0.1: an epoch then a "
          f"resumed second ({steps} steps), NCCL at world size 1 against one "
          f"process: epoch losses {[round(x, 6) for x in b['losses']]} "
          f"bit-equal, checkpoints {sorted(b['files'])} bit-equal "
          f"(parameters, BatchNorm statistics, optimizer state); K2 "
          f"{b['k2'][0] // steps} launches a step; step wall p50 by "
          f"command (one process) {a['walls']} s, (NCCL) {b['walls']} s; "
          f"ops without a deterministic implementation: "
          f"{sorted(set(a['notes'] + b['notes'])) or 'none'}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return {"router_chain": b["k2"][0], "k2_per_step": b["k2"][0] // steps,
            "step_wall_s": b["walls"], "one_process_step_wall_s": a["walls"]}


def phase_mesh_serving(torch, card, state_dict, ticks=8, streams=4):
    """Phase 42: the server's streams split over a mesh that names the card
    twice (``make_mesh(devices=["cuda:0", "cuda:0"])``: two replicas of
    ``streams / 2`` streams) against the one-replica server, the VIL-100
    preset at full width in float32 with the same weights, over ``ticks``
    ticks: stream 3 (the second replica) skipping ticks 2 and 5, stream 0
    (the first) tick 3, stream 2 detached and re-attached before tick 4,
    new weights (``update_variables``) before tick 6. Per tick the valid
    slots (the keep sets) equal, the kept rows within 1e-3, the memory
    mask equal and its values within 1e-3 (phase 6's card-against-CPU
    bound: the replicas' GEMMs have another M, so bits may differ). The
    split server's counters, zeroed just before its ticks and read just
    after, must show K1 once and K2 three times a replica a tick. Prints
    both servers' tick wall p50 (dispatch and decode)."""
    from phnet_torch.config import vil100_config
    from phnet_torch.ops import nms as tnms
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.parallel import make_mesh
    from phnet_torch.serving import StreamingServer

    cfg = vil100_config()
    m = cfg.model
    swap = seeded_state_dict(torch, cfg, seed=1)
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    frames = [rng.normal(size=(streams, m.img_h, m.img_w, 3)).astype(
        np.float32) for _ in range(ticks)]
    skips = {2: {3}, 3: {0}, 5: {3}}

    def drive(server):
        geometry = dict(ori_img_h=1080, cut_height=378)
        sids = [server.attach(**geometry) for _ in range(streams)]
        out, walls = [], []
        for i in range(ticks):
            if i == 4:
                server.detach(2)
                assert server.attach(**geometry) == 2
            if i == 6:
                server.update_variables(swap)
            tick = {s: frames[i][s] for s in sids
                    if s not in skips.get(i, ())}
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            kept, valid, got = server.step_async(tick)
            lanes = server.decode(kept, valid, got)
            walls.append(time.perf_counter() - w0)
            mem = server.memory
            out.append((server.gather(kept), server.gather(valid),
                        mem.mask.cpu().numpy(), mem.values.cpu().numpy(),
                        sum(len(v) for v in lanes.values())))
        return out, walls

    one, one_walls = drive(StreamingServer(cfg, state_dict,
                                           max_streams=streams))
    split = StreamingServer(cfg, state_dict, max_streams=streams,
                            mesh=make_mesh(devices=["cuda:0", "cuda:0"]))
    n = len(split.replicas)
    tnms.lane_nms.launches = 0
    trc.router_chain.launches = trc.router_chain.launches_bf16 = 0
    got, walls = drive(split)
    k1, k2, k2b = (tnms.lane_nms.launches, trc.router_chain.launches,
                   trc.router_chain.launches_bf16)
    worst_kept = worst_mem = 0.0
    for i, ((ak, av, am, amv, _), (bk, bv, bm, bmv, _)) in enumerate(
            zip(one, got)):
        if not (np.array_equal(av, bv) and np.array_equal(am, bm)):
            raise AssertionError(f"[mesh serving] tick {i}: keep sets or "
                                 f"memory mask differ from one replica's")
        worst_kept = max(worst_kept, float(np.abs(ak - bk).max()))
        worst_mem = max(worst_mem, float(np.abs(amv - bmv).max()))
    n_kept = sum(int(v.sum()) for _, v, _, _, _ in got)
    if worst_kept > 1e-3 or worst_mem > 1e-3 or n_kept == 0:
        raise AssertionError(f"[mesh serving] kept rows {worst_kept}, "
                             f"memory {worst_mem} from one replica's "
                             f"(bound 1e-3); {n_kept} kept")
    if (k1, k2, k2b) != (n * ticks, 3 * n * ticks, 0):
        raise AssertionError(f"[mesh serving] launches lane_nms {k1}, "
                             f"router_chain {k2} (bf16 mode {k2b}) over "
                             f"{ticks} ticks of {n} replicas: want 1 and 3 "
                             f"a replica a tick")
    p50, one_p50 = (float(np.median(np.array(w[1:]) * 1e3))
                    for w in (walls, one_walls))
    print(f"[mesh serving] VIL f32 full width, {streams} streams over "
          f"{n} replicas on one card, {ticks} ticks (skips, a detach and "
          f"attach, a weight swap): keep sets and memory masks equal to the "
          f"one-replica server's, kept rows within {worst_kept:.3g}, memory "
          f"within {worst_mem:.3g} (<= 1e-3); {n_kept} kept slots; "
          f"launches a tick lane_nms {k1 // ticks} ({k1 // ticks // n} a "
          f"replica), router_chain {k2 // ticks} ({k2 // ticks // n} a "
          f"replica); tick wall p50 (dispatch and decode, ticks 1..) "
          f"{p50:.2f} ms against one replica's {one_p50:.2f} ms; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return {"lane_nms": k1, "router_chain": k2, "tick_p50_ms": p50,
            "one_replica_tick_p50_ms": one_p50}


MODEL_AXIS_FRAMES = 2  # phase 43's clips: the fewest frames a clip holds
# phase 43's bounds, each step against one process's step from the same
# state: relative for the loss and the gradient norm, of a buffer's largest
# entry for the running statistics
MODEL_AXIS_BOUNDS = {"loss": 1e-5, "grad_norm": 1e-4, "batch_stats": 1e-4}


def trainer_steps(torch, device, workdir, frames_per_clip, epochs=(1, 2),
                  mesh=None, clips=1):
    """Phase 43's run of ``phnet_torch.train.trainer.train``: the VIL-100
    preset at full width in float32, decoder dropout 0.1, a checkpoint
    every epoch, a global batch of ``clips`` synthetic videos of
    ``frames_per_clip`` frames (a clip a data row on a mesh), under
    deterministic algorithms:
    each epoch of ``epochs`` one step, an epoch after the first resumed
    from ``workdir``'s latest checkpoint; on ``mesh`` where given (the
    group laid out on it first). Returns each step's loss and gradient
    norm, the ops without a deterministic implementation, whether the
    ranks hold the same bits at the end (True without a group) and the
    count of sharded parameters."""
    from phnet_torch.data import ClipLoader, SyntheticVideoDataset
    from phnet_torch.parallel.multihost import (check_same_bits, data_index,
                                                data_size, init_axes)
    from phnet_torch.parallel.tensor import sharded_names
    from phnet_torch.train import trainer

    cfg = train_config(0.1, epoch_per_test=1)
    m, t = cfg.model, cfg.train
    if mesh is not None:
        init_axes(mesh)  # before the loader shards over the data axis
    steps, walls = [], []
    make_step = trainer.make_train_step

    def recording(criterion, accum):
        step = make_step(criterion, accum)

        def run(state, frames, labels, seed):
            state, metrics = step(state, frames, labels, seed)
            steps.append({"loss": metrics["loss"].item(),
                          "grad_norm": metrics["grad_norm"].item()})
            return state, metrics

        return run

    trainer.make_train_step = recording
    t0 = time.perf_counter()
    try:
        with deterministic(torch) as notes:
            for epoch in epochs:
                e0 = time.perf_counter()
                timings = []
                ds = SyntheticVideoDataset(
                    n_videos=clips, frames_per_video=frames_per_clip,
                    img_h=m.img_h, img_w=m.img_w, spec=m.lane,
                    max_lanes=m.max_lanes, skip_increment=t.skip_increment,
                    max_training_skip=t.max_training_skip)
                loader = ClipLoader(ds, batch_size=clips // data_size(),
                                    seed=t.seed,
                                    num_shards=data_size(),
                                    shard_index=data_index(), prefetch=0)
                state, _ = trainer.train(cfg, ds, loader, workdir,
                                         epochs=epoch, resume=epoch > 1,
                                         device=device, verbose=False,
                                         mesh=mesh, timings=timings)
                walls.append((timings[0][1], time.perf_counter() - e0))
        t1 = time.perf_counter()
        try:
            check_same_bits(state.model)
            same = True
        except RuntimeError:
            same = False
    finally:
        trainer.make_train_step = make_step
    return {"steps": steps, "notes": notes, "same_bits": same,
            "sharded": len(sharded_names(state.model)), "walls": walls,
            "outside_s": (t1 - t0 - sum(w for _, w in walls),
                          time.perf_counter() - t1)}


def model_axis_rank(rank, world, port, workdir, out, frames_per_clip,
                    model_parallel, backend):
    """One rank of phase 43, in a process of its own: the group on
    ``backend``, every rank on ``cuda:0`` with gloo (NCCL refuses two
    ranks of one device), rank r on ``cuda:r`` with NCCL, laid out as
    data ``world / model_parallel`` x model ``model_parallel``;
    :func:`trainer_steps` with the mesh, a clip a data row; the rank's K2
    launches (its counters start at 0 in this process) and what
    :func:`trainer_steps` gives, saved to ``out``."""
    import torch

    from phnet_torch.ops import router_chain as trc
    from phnet_torch.parallel import initialize, make_mesh
    from phnet_torch.parallel.multihost import shutdown

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // (world + 1)))
    dev = initialize(f"127.0.0.1:{port}", world, rank, backend=backend,
                     device="cuda:0" if backend == "gloo" else f"cuda:{rank}")
    try:
        devices = ([dev] * world if backend == "gloo" else
                   [f"cuda:{r}" for r in range(world)])
        mesh = make_mesh(devices=devices, model_parallel=model_parallel)
        t0 = time.perf_counter()
        start_s = t0 - t_start
        got = trainer_steps(torch, dev, workdir, frames_per_clip, mesh=mesh,
                            clips=world // model_parallel)
        got["seconds"] = time.perf_counter() - t0
        got["start_s"] = start_s
        got["k2"] = (trc.router_chain.launches,
                     trc.router_chain.launches_bf16)
        got["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        shutdown()
    torch.save(got, out)


def start_ranks(world, port, workdir, outs, frames_per_clip, model_parallel,
                backend):
    """:func:`model_axis_rank` in ``world`` processes (this script's
    directory on their path)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for name in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        env.setdefault(name, "lo")
    return [subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke as c; a = "
         "sys.argv; c.model_axis_rank(int(a[1]), int(a[2]), int(a[3]), "
         "a[4], a[5], int(a[6]), int(a[7]), a[8])", str(r), str(world),
         str(port), workdir, outs[r], str(frames_per_clip),
         str(model_parallel), backend],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True) for r in range(world)]


def wait_ranks(procs, timeout=600):
    """Wait for every rank; on a failure, or at ``timeout`` seconds, stop
    them all and raise with the end of each one's output."""
    logs, failed = [], False
    try:
        for proc in procs:
            log, _ = proc.communicate(timeout=timeout)
            logs.append(log.decode(errors="replace"))
            failed |= proc.returncode != 0
    except subprocess.TimeoutExpired:
        failed = True
        logs.append(f"timed out after {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    if failed:
        raise AssertionError("[model axis training] a rank failed:\n"
                             + "\n---\n".join(l[-3000:] for l in logs))


def phase_model_axis_training(torch, card,
                              frames_per_clip=MODEL_AXIS_FRAMES, data=1,
                              model=2, backend="gloo"):
    """Phase 43: the training step over a mesh's model axis on the card.
    Two processes, each a rank on ``cuda:0`` over gloo (the backend
    named to ``initialize``: NCCL refuses two ranks of one device), laid
    out as data 1 x model 2, run :func:`trainer_steps` (full-width VIL in
    float32, B = 1, dropout 0.1, a step, then a second resumed from the
    first's checkpoint); with ``data``, ``model`` and ``backend="nccl"``,
    ``data * model`` ranks a card each (B = ``data``), the layout that
    more than one card takes: the 31 kernels that ``shard_params`` splits at
    its default ``min_size`` cut in two, their outputs joined over the
    model axis. Meanwhile this process runs the first step alone from the
    same seed; then it resumes the ranks' first checkpoint (written whole
    by rank 0) at model 1 for the second step. Each step is held to the
    one-process step from the same state: the loss, the gradient norm and
    the BatchNorm statistics within :data:`MODEL_AXIS_BOUNDS`, the
    parameters within AdamW's update bound (an entry moves by about the
    rate a step whatever its gradient's size, so one whose gradient is
    rounding noise may move either way: 2 x rate x (1 + decay)). Also:
    every rank's parameters and buffers the same bits over the group
    (whole ones) and the data group (blocks), the 31 parameters sharded,
    K2 launched 3 times a frame and again in the remat recompute in each
    rank's step, and the ranks' checkpoints in a one-process file's
    layout. Prints the differences and the time of each part."""
    import shutil

    from phnet_torch.train.cli import free_port

    cfg = train_config(0.1, epoch_per_test=1)
    world = data * model
    t0 = time.perf_counter()
    names = ("epoch_1.pt", "epoch_2.pt")
    with tempfile.TemporaryDirectory() as root:
        tp_dir, one_dir, resumed_dir = (os.path.join(root, d) for d in (
            "tp", "one", "resumed"))
        for d in (tp_dir, one_dir, resumed_dir):
            os.makedirs(d)
        outs = [os.path.join(root, f"rank{r}.pt") for r in range(world)]
        procs = start_ranks(world, free_port(), tp_dir, outs,
                            frames_per_clip, model, backend)
        try:  # step 1 alone, while the ranks run theirs
            one = trainer_steps(torch, torch.device("cuda:0"), one_dir,
                                frames_per_clip, epochs=(1,), clips=data)
        finally:
            t_one = time.perf_counter() - t0
            wait_ranks(procs)
        t_ranks = time.perf_counter() - t0
        ranks = [torch.load(o, weights_only=False) for o in outs]
        # step 2 alone, from the ranks' first checkpoint (model 2 -> 1)
        shutil.copy(os.path.join(tp_dir, names[0]), resumed_dir)
        t1 = time.perf_counter()
        two = trainer_steps(torch, torch.device("cuda:0"), resumed_dir,
                            frames_per_clip, epochs=(2,), clips=data)
        t_two = time.perf_counter() - t1

        def load(d, name):  # mapped: only the compared tensors are read
            return torch.load(os.path.join(d, name), map_location="cpu",
                              weights_only=True, mmap=True)

        pairs = [(load(one_dir, names[0]), load(tp_dir, names[0])),
                 (load(resumed_dir, names[1]), load(tp_dir, names[1]))]
    steps = len(ranks[0]["steps"])
    per_step = 2 * chain_per_frame(cfg) * frames_per_clip
    errs = []
    for r, got in enumerate(ranks):
        if got["k2"] != (per_step * steps, 0):
            errs.append(f"rank {r}: K2 launches (float32, bf16) {got['k2']}, "
                        f"want {per_step} a step over {steps} steps")
        if not got["same_bits"]:
            errs.append(f"rank {r}: the ranks' bits differ")
        if got["sharded"] != 31:
            errs.append(f"rank {r}: {got['sharded']} parameters sharded, "
                        f"want the 31 that shard_params splits")
        if got["steps"] != ranks[0]["steps"]:
            errs.append(f"rank {r}: its losses differ from rank 0's")
    bounds = MODEL_AXIS_BOUNDS
    lr, wd = cfg.train.learning_rate, cfg.train.weight_decay
    param_bound = 2 * lr * (1 + wd) + 1e-6
    apart = []  # a step: loss, grad_norm (relative), parameters' worst
    # |difference|, entries apart by more than 1e-6, the statistics' worst
    # |difference| of their buffer's largest |entry|
    alone = one["steps"] + two["steps"]
    for k, ((a, b), x, y) in enumerate(zip(pairs, alone, ranks[0]["steps"])):
        if {n: (v.shape, v.dtype) for n, v in a["params"].items()} != {
                n: (v.shape, v.dtype) for n, v in b["params"].items()}:
            errs.append(f"step {k + 1}: the checkpoints' layouts differ")
            continue
        worst_p, moved, worst_s = 0.0, 0, 0.0
        for key, v in a["params"].items():
            d = (v - b["params"][key]).abs()
            worst_p = max(worst_p, float(d.max()))
            moved += int((d > 1e-6).sum())
        for key, v in a["batch_stats"].items():
            worst_s = max(worst_s, float(
                (v - b["batch_stats"][key]).abs().max()
                / v.abs().max().clamp(min=1e-12)))
        rel = {q: abs(x[q] - y[q]) / abs(x[q]) for q in x}
        apart.append((rel["loss"], rel["grad_norm"], worst_p, moved,
                      worst_s))
        if rel["loss"] > bounds["loss"] or rel["grad_norm"] > bounds[
                "grad_norm"] or worst_p > param_bound or worst_s > bounds[
                "batch_stats"] or not np.isfinite(x["loss"]):
            errs.append(f"step {k + 1} against one process: loss "
                        f"{rel['loss']:.3g}, grad_norm {rel['grad_norm']:.3g}"
                        f" (bounds {bounds['loss']}, {bounds['grad_norm']}),"
                        f" parameters {worst_p:.3g} ({param_bound:.3g}), "
                        f"BatchNorm statistics {worst_s:.3g} "
                        f"({bounds['batch_stats']})")
    n_params = sum(v.numel() for v in pairs[0][0]["params"].values())
    notes = sorted(set(one["notes"] + two["notes"] + ranks[0]["notes"]))
    where = ("gloo ranks on one card" if backend == "gloo" else
             f"{backend} ranks, a card each")
    print(f"[model axis training] VIL f32 full width, B={data}, "
          f"{frames_per_clip}-frame clips, dropout 0.1, a step and a resumed "
          f"second: data {data} x model {model} ({world} {where}), each step "
          f"against one process's from the same state (the second resumed "
          f"at model 1 from the ranks' first checkpoint): losses "
          f"{[s['loss'] for s in ranks[0]['steps']]} / "
          f"{[s['loss'] for s in alone]}; by step (loss and grad_norm "
          f"relative / parameters' worst |difference| (bound "
          f"{param_bound:.3g}) / entries of {n_params} apart by more than "
          f"1e-6 / BatchNorm statistics' worst, of the buffer's largest): "
          + "; ".join(f"{l:.3g} {g:.3g} / {p:.3g} / {m} / {st:.3g}"
                      for l, g, p, m, st in apart)
          + f"; the ranks' bits equal: {[g['same_bits'] for g in ranks]}; "
          f"sharded {[g['sharded'] for g in ranks]}; K2 launches (rank: "
          f"float32, bf16) {[g['k2'] for g in ranks]}, want {per_step} a "
          f"step; ranks' two epochs {[round(g['seconds'], 2) for g in ranks]}"
          f" s (rank 0: group start {ranks[0]['start_s']:.2f} s, (step, "
          f"epoch) walls "
          f"{[(round(a, 2), round(b, 2)) for a, b in ranks[0]['walls']]} s, "
          f"around them {[round(x, 2) for x in ranks[0]['outside_s']]} s; "
          f"peak {[round(g['peak_mib']) for g in ranks]} MiB), ranks' "
          f"processes {t_ranks:.1f} s, one process's first step "
          f"{t_one:.1f} s (beside them), its resumed second {t_two:.1f} s; "
          f"ops without a deterministic implementation: {notes or 'none'}; "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    if errs:
        raise AssertionError("[model axis training] " + "; ".join(errs))
    return {"router_chain": sum(g["k2"][0] for g in ranks),
            "k2_per_step_per_rank": per_step, "apart": apart}


def phase_export(torch, card, state_dict, ticks=8, streams=4):
    """Phase 44: the deployment artifact. The full-width VIL-100 model with
    the seeded weights, ``streams`` streams, exported on the card twice:
    in float32 by ``export_serving_step`` and in w8 by the command line
    (``python -m phnet_torch.run.export_model --quantize w8`` from a port
    checkpoint of the same weights). Each is loaded by ``DeployedServer``
    and ticks ``ticks`` frames a stream beside a live ``StreamingServer``
    of the same weights and mode, in turns, on the same frames. Gates per
    tick: valid slots and the memory mask equal, kept rows and memory
    values within 1e-5 of max |live|; the counters, zeroed just before the
    artifacts' ticks and advanced only by them, must show K1 once and K2
    three times a tick through the artifact, and K3 12 times in w8; the
    loaded graph must hold the ``phnet::`` operators (one lane NMS, a
    router chain a refine stage, the w8 products). Prints the export,
    save and load seconds, the artifact's MiB and both tick walls p50
    (frames up, the tick, kept rows and valid slots down; ticks 1..)."""
    from phnet_torch.config import vil100_config
    from phnet_torch.export import DeployedServer, export_serving_step
    from phnet_torch.ops import nms as tnms
    from phnet_torch.ops import router_chain as trc
    from phnet_torch.ops import w8_matmul as tw8
    from phnet_torch.run import export_model
    from phnet_torch.serving import StreamingServer

    cfg = vil100_config()
    m = cfg.model
    rng = np.random.default_rng(6)
    frames = [rng.normal(size=(streams, m.img_h, m.img_w, 3)).astype(
        np.float32) for _ in range(ticks)]
    per_tick = {"none": (1, 3, 0), "w8": (1, 3, len(w8_products(cfg)))}
    results = {}
    with tempfile.TemporaryDirectory() as root:
        for quantize, want in per_tick.items():
            t0 = time.perf_counter()
            art = os.path.join(root, quantize)
            gc.collect()
            torch.cuda.empty_cache()
            if quantize == "none":
                export_serving_step(m, state_dict, art, batch=streams)
            else:
                ckpt = write_port_checkpoint(torch, cfg, state_dict,
                                             os.path.join(root, "run"))
                export_model.main(["--checkpoint", ckpt, "--out", art,
                                   "--batch", str(streams), "--quantize",
                                   quantize])
            made_s = time.perf_counter() - t0
            w0 = time.perf_counter()
            dep = DeployedServer(art)
            load_s = time.perf_counter() - w0
            mib = sum(os.path.getsize(os.path.join(art, f))
                      for f in os.listdir(art)) / 2 ** 20
            graph = {n: sum(str(node.target) == f"phnet.{n}.default"
                            for node in dep.graph.nodes)
                     for n in ("nms_keeps", "router_chain", "w8_matmul")}
            if tuple(graph.values()) != want:
                raise AssertionError(f"[export {quantize}] the loaded graph "
                                     f"holds {graph}, want {want}")
            live = StreamingServer(quantized(cfg, quantize), state_dict,
                                   max_streams=streams)
            sids = [live.attach() for _ in range(streams)]
            tnms.lane_nms.launches = 0
            trc.router_chain.launches = trc.router_chain.launches_bf16 = 0
            tw8.w8_matmul.launches = 0
            counts = np.zeros(4, np.int64)
            walls, live_walls = [], []
            worst_kept = worst_mem = 0.0
            n_kept = 0
            for i in range(ticks):
                torch.cuda.synchronize()
                before = np.array([tnms.lane_nms.launches,
                                   trc.router_chain.launches,
                                   tw8.w8_matmul.launches,
                                   trc.router_chain.launches_bf16])
                w0 = time.perf_counter()
                kept, valid = dep.tick(frames[i])
                walls.append(time.perf_counter() - w0)
                counts += np.array([tnms.lane_nms.launches,
                                    trc.router_chain.launches,
                                    tw8.w8_matmul.launches,
                                    trc.router_chain.launches_bf16]) - before
                torch.cuda.synchronize()
                w0 = time.perf_counter()
                lk, lv, _ = live.step_async({s: frames[i][s] for s in sids})
                lk, lv = live.gather(lk), live.gather(lv)
                live_walls.append(time.perf_counter() - w0)
                mem = live.memory
                if not (np.array_equal(valid, lv) and torch.equal(
                        dep.memory[1], mem.mask)):
                    raise AssertionError(f"[export {quantize}] tick {i}: "
                                         f"valid slots or memory mask differ "
                                         f"from the live server's")
                worst_kept = max(worst_kept, float(np.abs(kept - lk).max())
                                 / max(float(np.abs(lk).max()), 1e-30))
                worst_mem = max(worst_mem, float(
                    (dep.memory[0] - mem.values).abs().max()
                    / mem.values.abs().max().clamp_min(1e-30)))
                n_kept += int(valid.sum())
                if int(dep.memory[2]) != mem.t:
                    raise AssertionError(f"[export {quantize}] t "
                                         f"{int(dep.memory[2])} against "
                                         f"{mem.t}")
            if worst_kept > 1e-5 or worst_mem > 1e-5 or n_kept == 0 \
                    or not np.isfinite(kept).all():
                raise AssertionError(
                    f"[export {quantize}] kept rows {worst_kept:.3g}, memory "
                    f"{worst_mem:.3g} of max |live| from the live server's "
                    f"(bound 1e-5); {n_kept} kept slots")
            if tuple(counts) != tuple(w * ticks for w in want) + (0,):
                raise AssertionError(
                    f"[export {quantize}] launches through the artifact over "
                    f"{ticks} ticks lane_nms {counts[0]}, router_chain "
                    f"{counts[1]} (bf16 mode {counts[3]}), w8_matmul "
                    f"{counts[2]}: want {want} a tick")
            seconds = dep.manifest["seconds"]
            p50, live_p50 = (float(np.median(np.array(w[1:]) * 1e3))
                             for w in (walls, live_walls))
            how = ("export_serving_step" if quantize == "none"
                   else "the command line from a checkpoint")
            print(f"[export {quantize}] VIL full width, {streams} streams, "
                  f"by {how} in {made_s:.1f} s: torch.export "
                  f"{seconds['export']:.2f} s, save {seconds['save']:.2f} s, "
                  f"load {load_s:.2f} s; artifact {mib:.1f} MiB; graph "
                  f"{graph}; {ticks} ticks beside the live server (cuDNN "
                  f"TF32 flag {torch.backends.cudnn.allow_tf32}): keep sets "
                  f"and memory masks equal, kept rows within {worst_kept:.3g}"
                  f" and memory within {worst_mem:.3g} of max |live|; "
                  f"{n_kept} kept slots; launches a tick through the "
                  f"artifact lane_nms {counts[0] // ticks}, router_chain "
                  f"{counts[1] // ticks}, w8_matmul {counts[2] // ticks}; "
                  f"tick wall p50 (ticks 1..) deployed {p50:.2f} ms, live "
                  f"{live_p50:.2f} ms [{card}]", flush=True)
            results[quantize] = {
                "lane_nms": int(counts[0]), "router_chain": int(counts[1]),
                "w8_matmul": int(counts[2]), "export_s": seconds["export"],
                "save_s": seconds["save"], "load_s": load_s, "mib": mib,
                "tick_p50_ms": p50, "live_tick_p50_ms": live_p50}
            del dep, live
    return results


# phase 45: the segmentation and flow planes. The flow planes read back
# from the card's nvJPEG files, against the CPU's own Farneback flow
# quantized without a JPEG, may differ by the JPEG round trip
# (``flow.JPEG_ROUND_TRIP_LEVELS``: cv2's own write and read of the
# fixture's flow planes, ``tests/test_torch_flow.py``) and one level more
# where the card's and the CPU's float flows quantize to neighbouring
# levels
PLANES_SEED = 11
PLANES_CLASSES = 9  # the background and VIL-100's 8 lane ids
PLANES_SHIFT = (1.7, -0.6)  # px of the 1080p pair's known motion
PLANES_FARNEBACK = {"median": 1e-2, "p999": 1e-1}  # px, card vs CPU


def lane_mask(json_path, h, w, half_width=8):
    """uint8 [h, w]: each lane of a VIL-100 JSON drawn as its ``lane_id``,
    ``half_width`` pixels either side of its polyline, row by row."""
    with open(json_path) as f:
        lanes = json.load(f)["annotations"]["lane"]
    mask = np.zeros((h, w), np.uint8)
    cols = np.arange(w)
    for lane in lanes:
        pts = np.array(lane["points"], np.float64).reshape(-1, 2)
        if len(pts) < 2:
            continue
        pts = pts[np.argsort(pts[:, 1])]
        ys = np.arange(max(0, int(np.ceil(pts[0, 1]))),
                       min(h, int(np.floor(pts[-1, 1])) + 1))
        xs = np.interp(ys, pts[:, 1], pts[:, 0])
        hit = np.abs(cols[None] - xs[:, None]) <= half_width
        mask[ys[:, None].repeat(w, 1)[hit], np.nonzero(hit)[1]] = \
            lane["lane_id"]
    return mask


def planes_weights(torch):
    """Seeded weights of the phase's ``SegDecoder`` (192 -> 9 classes) and
    ``WarpModel`` (64 -> 64), drawn on the CPU."""
    g = torch.Generator().manual_seed(PLANES_SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    seg = {"conv.weight": randn(PLANES_CLASSES, 192, 1, 1,
                                scale=192 ** -0.5),
           "conv.bias": randn(PLANES_CLASSES, scale=0.1)}
    warp = {"conv.weight": randn(64, 128, 1, 1, scale=128 ** -0.5),
            "bn.weight": 1.0 + randn(64, scale=0.1),
            "bn.bias": randn(64, scale=0.1),
            "bn.running_mean": randn(64, scale=0.1),
            "bn.running_var": 1.0 + randn(64, scale=0.1).abs()}
    return seg, warp


def planes_models(torch, feats, level0, flow_small):
    """The decoder's logits of ``feats`` [T, 48, 96, 192] and the warp of
    each frame's level-0 features onto the next one's along its flow,
    on the inputs' device, float32 with TF32 off."""
    from phnet_torch.models.flow_warp import WarpModel
    from phnet_torch.models.seg_decoder import SegDecoder

    seg_sd, warp_sd = planes_weights(torch)
    dev = feats.device
    dec = SegDecoder(384, 768, PLANES_CLASSES, 192).to(dev)
    dec.load_state_dict(seg_sd)
    warp = WarpModel(64, 64).to(dev)
    warp.load_state_dict(warp_sd)
    with torch.no_grad():
        return (dec(feats), warp(level0[:-1], level0[1:], flow_small[1:]))


class FedDecoder:
    """A reader's decoder on the CPU that hands out bytes the card decoded
    (the card's machine has no libjpeg): ``u8`` frames and ``gray``
    planes by path, ``__call__`` the test mode's resize and normalize of
    the frames."""

    def __init__(self, torch, u8, gray):
        self.device = torch.device("cpu")
        self._torch, self._u8, self._gray = torch, u8, gray

    def u8(self, paths):
        return self._torch.stack([self._u8[p] for p in paths])

    def gray(self, paths):
        return self._torch.stack([self._gray[p] for p in paths])

    def __call__(self, paths, cut_px, out_h, out_w):
        from phnet_torch.data.native_loader import resize_normalize

        return resize_normalize(self.u8(paths), cut_px, out_h, out_w)


def planes_readers(torch, tree, device, decoder=None):
    """The phase's readers of ``tree``: test mode without and with the
    planes, train mode (``TrainAugment`` with p_hflip = p_affine = 1) with
    them, on ``device``; ``decoder`` replaces each one's decoder."""
    from phnet_torch.config import vil100_config
    from phnet_torch.data.transforms import TrainAugment
    from phnet_torch.data.vil100 import VIL100Dataset

    m = vil100_config().model
    out = {"test": VIL100Dataset(tree, m, device=device),
           "test planes": VIL100Dataset(tree, m, device=device,
                                        load_seg=True, load_flow=True),
           "train planes": VIL100Dataset(
               tree, m, train=True, device=device, sampled_frames=4,
               samples_per_video=1, seed=PLANES_SEED, load_seg=True,
               load_flow=True, augment=TrainAugment(
                   m.img_h, m.img_w, p_hflip=1.0, p_affine=1.0,
                   rng=np.random.default_rng(PLANES_SEED)))}
    if decoder is not None:
        for r in out.values():
            r.decode = decoder
    return out


def cpu_planes(torch, seed, feed):
    """The CPU side of phase 45, in two parts fed by the card: (1) the
    fixture's frames as the card decoded them -> the Farneback flow of
    each frame against the one before (frame 0 against itself) and its
    quantized planes; (2) the written tree, the card's decoded frames and
    flow planes, the decoder's and the warp's inputs -> the readers' clips
    (test mode with the planes, train mode), the models' outputs and the
    metric of the CPU's own argmax masks."""
    from phnet_torch.data.flow import dense_two_frame_flow, quantize_flow

    first = feed()
    flows, planes = {}, {}
    for vid, frames in first["frames"].items():
        prev = None
        for t, img in enumerate(frames):
            flow = dense_two_frame_flow(prev if prev is not None else img,
                                        img, device="cpu")
            flows[(vid, t)] = flow
            planes[(vid, t)] = torch.stack(quantize_flow(flow))
            prev = img
    second = feed()
    readers = planes_readers(torch, second["tree"], "cpu", FedDecoder(
        torch, second["u8"], second["gray"]))
    clips = {"test": [readers["test planes"][i]
                      for i in range(len(readers["test planes"]))],
             "train": readers["train planes"][0]}
    logits, warped = planes_models(torch, second["feats"], second["level0"],
                                   second["flow_small"])
    pred = logits.argmax(-1)
    top2 = logits.topk(2, -1).values
    return {"flows": flows, "planes": planes, "clips": clips,
            "logits": logits, "warped": warped, "pred": pred,
            "gap": (top2[..., 0] - top2[..., 1]),
            "metric": planes_metric(pred, second["seg"])}


def planes_metric(pred, seg):
    """J and F means over the lane ids present in ``seg`` [T, H, W], each a
    video of binary masks of ``pred`` == id against ``seg`` == id."""
    from phnet_torch.evaluation.video_metrics import evaluate_video_masks

    out = {}
    for k in range(1, PLANES_CLASSES):
        gt = [s == k for s in seg]
        if not any(bool(g.any()) for g in gt):
            continue
        res = evaluate_video_masks([p == k for p in pred], gt)
        out[k] = (res["J"]["mean"], res["F"]["mean"])
    return out


def shifted_texture(torch, h, w, shift, device):
    """A uint8 texture [h, w] (24 sinusoids of 10 to 40 pixels' period,
    curved enough for the polynomial expansion) and the same texture moved
    by ``shift`` = (dx, dy) pixels, computed on ``device``."""
    y = torch.arange(h, dtype=torch.float64, device=device)[:, None]
    x = torch.arange(w, dtype=torch.float64, device=device)[None]
    g = np.random.default_rng(PLANES_SEED)
    waves = []
    for _ in range(24):
        r, th = g.uniform(0.15, 0.6), g.uniform(0, np.pi)
        waves.append((r * np.cos(th), r * np.sin(th), g.uniform(0, 6.3)))

    def tex(xx, yy):
        v = sum(torch.sin(a * xx + b * yy + c) for a, b, c in waves)
        return (127.5 + 8.0 * v).clamp(0, 255).round().to(torch.uint8)

    return tex(x, y), tex(x - shift[0], y - shift[1])


def phase_planes(torch, card, state_dict):
    """Phase 45: the segmentation and flow planes on the card, at full
    width. (a) Farneback (``data/flow.py``, PyTorch on the card) on a
    1080x1920 pair, a smooth texture moved by ``PLANES_SHIFT`` (median
    flow of the interior within 0.05 px of it), timed; and on the
    fixture's VIL-100 frames, against the CPU's run on the same decoded
    bytes (median and 99.9th percentile of |diff| within
    ``PLANES_FARNEBACK``). (b) A copy of the fixture's VIL-100 tree gets
    lane masks written by ``write_mask`` (indexed PNGs) and flow JPEGs by
    ``generate_flow_jpgs`` (nvJPEG), timed a frame. (c) The copy read back
    by the reader on the card with ``load_seg`` and ``load_flow``: in test
    mode (ms a frame with and without the planes) and in train mode with
    ``TrainAugment`` at p_hflip = p_affine = 1; against the same readers
    on the CPU given the card's decoded bytes: masks equal, flow within
    1e-6 (the same bytes and ops), frames within the augmentation's gate;
    the test mode's flow against the CPU's own Farneback flow, quantized
    and dequantized without a JPEG, within ``JPEG_ROUND_TRIP_LEVELS`` + 1
    levels. (d) ``SegDecoder`` on the stacked FPN levels of
    ``vil100_config()`` (the seeded model's encoder on the read frames;
    3 x 64 channels at 48x96, upsampled to 384x768, 9 classes) and
    ``WarpModel`` on the 64-channel level 0 with the read flow: card
    against CPU within 1e-4 of max |CPU| (TF32 off). (e) J and F of the
    decoder's argmax masks against the read masks, equal to the CPU's on
    the same masks; the CPU's own argmax differs only where its top two
    logits are within 1e-4."""
    import shutil as sh

    from phnet_torch.config import vil100_config
    from phnet_torch.data.flow import (JPEG_ROUND_TRIP_LEVELS, BOUND,
                                       dense_two_frame_flow,
                                       dequantize_flow, generate_flow_jpgs)
    from phnet_torch.data.native_loader import ClipDecoder
    from phnet_torch.data.transforms import resize_linear_f32
    from phnet_torch.models import PHNet
    from phnet_torch.models.seg_decoder import resize_bilinear
    from phnet_torch.utils.masks import write_mask

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    key = ("planes", PLANES_SEED)
    feeds = []

    def feed(payload):
        if CPU_REFS is not None:
            CPU_REFS.feed(torch, key, payload)
        else:
            feeds.append(payload)

    # (a) Farneback at 1080p on a known motion, then the fixture's frames
    prev, nxt = shifted_texture(torch, 1080, 1920, PLANES_SHIFT, dev)
    dense_two_frame_flow(prev, nxt)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow = dense_two_frame_flow(prev, nxt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    farneback_ms = 1e3 * float(np.median(times))
    inner = flow[64:-64, 64:-64].reshape(-1, 2)
    med = inner.median(0).values.cpu().numpy()
    if (not flow.is_cuda or np.abs(med - np.array(PLANES_SHIFT)).max()
            > 0.05):
        raise AssertionError(f"[planes] Farneback on the 1080p pair: median "
                             f"{med}, the motion {PLANES_SHIFT}")
    decode = ClipDecoder(dev)
    src = os.path.join(FIXTURE, "VIL100")
    with tempfile.TemporaryDirectory() as tmp:
        tree = os.path.join(tmp, "data")
        root = os.path.join(tree, "VIL100")
        for sub in ("JPEGImages", "Json", "data"):
            sh.copytree(os.path.join(src, sub), os.path.join(root, sub))
        videos = sorted(os.listdir(os.path.join(root, "JPEGImages")))
        names = {v: sorted(f[:-4] for f in os.listdir(
            os.path.join(root, "JPEGImages", v))) for v in videos}
        jpgs = {v: [os.path.join(root, "JPEGImages", v, n + ".jpg")
                    for n in names[v]] for v in videos}
        u8 = {v: decode.u8(jpgs[v]) for v in videos}
        feed({"frames": {v: u8[v].cpu() for v in videos}})
        card_flows = {}
        for v in videos:
            for t in range(len(names[v])):
                card_flows[(v, t)] = dense_two_frame_flow(
                    u8[v][max(t - 1, 0)], u8[v][t])
        # (b) the written files
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_frames = 0
        for v in videos:
            for n in names[v]:
                h, w = u8[v].shape[1:3]
                write_mask(lane_mask(os.path.join(root, "Json", v,
                                                  n + ".jpg.json"), h, w),
                           os.path.join(root, "Annotations", v, n + ".png"))
            generate_flow_jpgs(os.path.join(root, "JPEGImages", v),
                               os.path.join(root, "Flow", v), names[v],
                               device=dev)
            n_frames += len(names[v])
        torch.cuda.synchronize()
        write_ms = 1e3 * (time.perf_counter() - t0) / n_frames
        # (c) read back on the card
        readers = planes_readers(torch, tree, None)
        plain, plain_s, _ = timed_clips(torch, readers["test"])
        test, planes_s, _ = timed_clips(torch, readers["test planes"])
        train = readers["train planes"][0]
        for c in test + [train]:
            if (not c["seg"].is_cuda or c["seg"].dtype != torch.uint8
                    or tuple(c["seg"].shape) != (4, 384, 768)
                    or tuple(c["flow"].shape) != (4, 384, 768, 2)
                    or not bool(torch.isfinite(c["flow"]).all())):
                raise AssertionError(f"[planes] clip {c['name']}: seg "
                                     f"{tuple(c['seg'].shape)} on "
                                     f"{c['seg'].device}, flow "
                                     f"{tuple(c['flow'].shape)}")
        flow_files = sorted(glob.glob(os.path.join(root, "Flow", "*",
                                                   "*.jpg")))
        gray = dict(zip(flow_files, decode.gray(flow_files).cpu()))
        # (d) the models on the read clips
        model = PHNet(vil100_config().model, device=dev)
        model.load_state_dict(state_dict)
        with torch.no_grad():
            levels = [lv[:, 0] for lv in model.encode(test[0]["frames"][None])]
        hh, ww = levels[0].shape[1:3]
        feats = torch.cat([levels[0]] + [resize_bilinear(lv, hh, ww)
                                         for lv in levels[1:]], -1)
        flow_small = torch.stack([resize_linear_f32(f, hh, ww)
                                  for f in test[0]["flow"]])
        logits, warped = planes_models(torch, feats, levels[0], flow_small)
        pred = logits.argmax(-1)
        seg = test[0]["seg"]
        metric = planes_metric(pred, seg)
        feed({"tree": tree, "u8": {p: f.cpu() for v in videos
                                   for p, f in zip(jpgs[v], u8[v])},
              "gray": gray, "feats": feats.cpu(), "level0": levels[0].cpu(),
              "flow_small": flow_small.cpu(), "seg": seg.cpu()})
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t_phase
        ref = (cpu_side(torch, key) if CPU_REFS is not None
               else cpu_planes(torch, PLANES_SEED, iter(feeds).__next__))
    # the gates
    fb = []
    for k, f in card_flows.items():
        d = (f.cpu() - ref["flows"][k]).abs().reshape(-1)
        fb.append((float(d.median()), float(d.quantile(0.999))))
    fb_med, fb_p999 = max(x[0] for x in fb), max(x[1] for x in fb)
    if fb_med > PLANES_FARNEBACK["median"] or \
            fb_p999 > PLANES_FARNEBACK["p999"]:
        raise AssertionError(f"[planes] Farneback card vs CPU: median "
                             f"{fb_med}, 99.9th percentile {fb_p999} px")
    level = 2 * BOUND / 255.0
    worst = {"seg": 0, "flow": 0.0, "frames": 0.0, "levels": 0.0}
    for got, want in zip(test + [train], ref["clips"]["test"]
                         + [ref["clips"]["train"]]):
        if got["frame_names"] != want["frame_names"] or not torch.equal(
                got["seg"].cpu(), want["seg"]):
            raise AssertionError(f"[planes] clip {got['name']}: masks or "
                                 f"frames differ from the CPU's")
        worst["flow"] = max(worst["flow"], float(
            (got["flow"].cpu() - want["flow"]).abs().max()))
        worst["frames"] = max(worst["frames"], float(
            (got["frames"].cpu() - want["frames"]).abs().max()))
    cfg = vil100_config().model
    for c in test:
        v = c["name"]
        oh, ow = u8[v].shape[1:3]
        size = torch.tensor([ow, oh], dtype=torch.float32)
        for t in range(len(c["frame_names"])):
            u, vv = ref["planes"][(v, t)]
            flow = dequantize_flow(u, vv, oh, ow)
            want = resize_linear_f32(flow[c["cut"]:], cfg.img_h, cfg.img_w)
            lv = ((c["flow"][t].cpu() - want).abs() * size / level).max()
            worst["levels"] = max(worst["levels"], float(lv))
    if (worst["flow"] > 1e-6 or worst["frames"] > AUG_MAX_LEVELS / 255.0
            / 0.225 or worst["levels"] > JPEG_ROUND_TRIP_LEVELS + 1 + 1e-3):
        raise AssertionError(f"[planes] read-back planes: {worst}")
    model_err = {}
    for name, got, want in (("seg_decoder", logits, ref["logits"]),
                            ("warp_model", warped, ref["warped"])):
        err = float((got.cpu() - want).abs().max())
        model_err[name] = err / float(want.abs().max())
        if model_err[name] > 1e-4:
            raise AssertionError(f"[planes] {name}: card {err} from the CPU")
    cpu_metric = planes_metric(pred.cpu(), seg.cpu())
    flips = pred.cpu() != ref["pred"]
    near = int((flips & (ref["gap"] > 1e-4)).sum())
    if cpu_metric != metric or near or not metric:
        raise AssertionError(f"[planes] J&F card {metric}, CPU {cpu_metric}"
                             f"; {near} argmax flips with a gap > 1e-4")
    jm = np.mean([j for j, _ in metric.values()])
    fm = np.mean([f for _, f in metric.values()])
    print(f"[planes] Farneback on the card: 1080x1920 pair "
          f"{farneback_ms:.1f} ms (median of 3, synchronized wall), motion "
          f"{PLANES_SHIFT} found as {tuple(np.round(med, 4))}; VIL frames "
          f"card vs CPU median {fb_med:.3g} px, 99.9th percentile "
          f"{fb_p999:.3g} px; written: masks + flow JPEGs (nvJPEG) "
          f"{write_ms:.1f} ms a frame; reader at 768x384 test mode "
          f"{1e3 * plain_s:.2f} ms a frame without planes, "
          f"{1e3 * planes_s:.2f} ms with; read back against the CPU on the "
          f"card's bytes: masks equal, flow within {worst['flow']:.3g}, "
          f"frames within {worst['frames']:.3g}; against the CPU's own "
          f"Farneback without a JPEG {worst['levels']:.3f} levels (<= "
          f"{JPEG_ROUND_TRIP_LEVELS + 1}); SegDecoder "
          f"{model_err['seg_decoder']:.3g}, WarpModel "
          f"{model_err['warp_model']:.3g} of max |CPU| "
          f"(<= 1e-4); J&F over {len(metric)} lane ids J {jm:.4f} F "
          f"{fm:.4f} (random weights), equal to the CPU's, "
          f"{int(flips.sum())} argmax flips all at gaps <= 1e-4; card "
          f"{card_s:.1f} s, phase {time.perf_counter() - t_phase:.1f} s "
          f"[{card}]", flush=True)
    return {"farneback_ms": farneback_ms, "write_ms": write_ms,
            "read_ms": 1e3 * plain_s, "read_planes_ms": 1e3 * planes_s,
            "card_s": card_s}


def lap(t0, tag):
    """Print the seconds since the script started, after ``tag``."""
    print(f"[time] {tag}: {time.perf_counter() - t0:.1f} s", flush=True)


# the CPU sides of the card-against-CPU checks, in the order run_phases
# asks for them (end_to_end: preset, quantize, compute dtype, chain_bf16,
# frames, backbone; train: preset, frames, backbone; train_bf16: preset,
# router_train_chain_f32, frames, one-ulp seeds)
VIL, OL = "vil100_config", "openlane_config"
CPU_JOBS = (
    ("end_to_end", VIL, "none", "float32", None, 2, None),  # phase 6
    ("end_to_end", VIL, "w8", "float32", None, 2, None),  # 9
    ("end_to_end", OL, "none", "float32", None, 2, None),  # 13
    ("end_to_end", MULTISCALE, "none", "float32", None, 2, None),  # 14
    ("train", VIL, 4, None),  # 15
    ("end_to_end", VIL, "none", "bfloat16", None, 2, None),  # 20
    ("end_to_end", VIL, "w8", "bfloat16", None, 2, None),
    ("end_to_end", VIL, "none", "float32", True, 2, None),
    ("end_to_end", PROPAGATE, "none", "float32", None, 3, None),  # 27
    ("end_to_end", PROPAGATE, "none", "bfloat16", None, 3, None),
    ("end_to_end", MULTISCALE, "none", "bfloat16", None, 2, None),  # 28
    *(("end_to_end", VIL, "none", dtype, None, 2, b)  # 37
      for b in ("revcol", "resnet50", "groupnorm")
      for dtype in ("float32", "bfloat16")),
    ("train_bf16", VIL, False, 4, (5, 6)),  # 21
    ("train_bf16", VIL, True, 2, (5,)),
    ("train", OL, 4, None),  # 22
    ("train_bf16", OL, False, 4, (5, 6)),
    ("train", MULTISCALE, 2, None),  # 29
    ("train_bf16", MULTISCALE, False, 4, (5, 6)),
    ("train", PROPAGATE, 2, None),
    ("train_bf16", PROPAGATE, False, 4, (5, 6)),
    *(("train", VIL, 2, b)  # 39
      for b in ("revcol", "resnet50", "groupnorm")),
    ("planes", PLANES_SEED))  # 45


def run_phases(torch, card, t0):
    """Phases 2-45. The phases that need nothing of the CPU's run first
    and those whose checks wait for :data:`CPU_JOBS` later (21-22, 29,
    39), so that the background process is ahead of them; the command
    lines' subprocesses (30-36, 41, 43) run last, when it has ended, and
    then phase 45, whose CPU side the background process computes from
    what the card hands it while the card goes on.
    Returns the numbers that the ``kernels`` line and the summaries
    read."""
    from phnet_torch.config import vil100_config

    phase_build()
    nms = phase_nms(torch, card)
    chain = phase_router(torch, card)
    state_dict = seeded_state_dict(torch, vil100_config())
    launches = phase_serving(torch, card, state_dict)
    torch.backends.cudnn.allow_tf32 = True  # a user's default
    try:
        phase_end_to_end(torch, card, state_dict)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    w8 = phase_w8(torch, card)
    launches_w8 = phase_serving(torch, card, state_dict, quantize="w8")
    phase_serving(torch, card, state_dict, quantize="int8")
    phase_end_to_end(torch, card, state_dict, quantize="w8")
    phase_pipeline(torch, card, state_dict)
    lap(t0, "phases 1-10")
    nms_ol = phase_nms(torch, card, layout="openlane")
    ms_products = w8_products(preset_config("openlane_multiscale_config"))
    w8_ms = phase_w8(torch, card, ms_products,
                     tag="w8_matmul openlane_multiscale", ragged=False)
    ol = phase_openlane(torch, card)
    lap(t0, "phases 11-14")
    torch.backends.cudnn.allow_tf32 = True  # a user's default
    try:
        phase_train_parity(torch, card)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    # the smoke's time limit: one timed step a size (as phases 29 and 39),
    # 2-frame clips in phase 24 (phase 36 covers the OL command line at
    # T = 16); phase 15's f32 step keeps 4 frames (at 2 the card's FPN
    # gradient came out 1.005 times its bound)
    training = phase_train_throughput(torch, card, timed=1)
    phase_trainer(torch, card)
    lap(t0, "phases 15-17")
    chain_bf16 = phase_router_bf16(torch, card)
    w8_bf16x = phase_w8_bf16x(torch, card)
    bf16 = phase_bf16(torch, card)
    lap(t0, "phases 18-20")
    training_bf16 = phase_train_throughput(torch, card, timed=1,
                                           compute_dtype="bfloat16")
    training_ol = phase_train_throughput(
        torch, card, batches=(1,), timed=1, preset="openlane_config",
        compute_dtype="bfloat16", counted=())
    phase_trainer_openlane(torch, card, frames_per_clip=2)
    lap(t0, "phases 23-24")
    nms_v3 = phase_nms(torch, card, layout="openlane", a=244)
    v3 = phase_propagate(torch, card)
    ms_bf16 = phase_multiscale_bf16(torch, card)
    lap(t0, "phases 25-28")
    backbones = phase_backbones(torch, card)
    backbone_pipe = phase_pipeline(torch, card, seeded_state_dict(
        torch, with_backbone(vil100_config(), "revcol")), quantize="none",
        clips=1, backbone="revcol")
    lap(t0, "phases 37-38")
    mesh_serving = phase_mesh_serving(torch, card, state_dict)
    torch.backends.cudnn.allow_tf32 = True  # a user's default
    try:
        exported = phase_export(torch, card, state_dict)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    lap(t0, "phases 42, 44")
    torch.backends.cudnn.allow_tf32 = True  # a user's default
    try:
        phase_train_parity_bf16(torch, card)
        phase_train_parity_bf16(torch, card, chain_f32=True,
                                frames_per_clip=2, ulp_seeds=(5,))
        ol_f32_k2 = phase_train_parity(torch, card, "openlane_config")
        phase_train_parity_bf16(torch, card, "openlane_config")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    lap(t0, "phases 21-22")
    train_heads = phase_train_heads(torch, card)
    lap(t0, "phase 29")
    train_backbones = phase_train_backbones(torch, card)
    phase_revcol_checkpoint(torch, card)
    lap(t0, "phases 39-40")
    phase_host_build()
    readers = phase_readers(torch, card)
    phase_eval_pipeline(torch, card, state_dict, readers["vil"]["clips"])
    del readers
    phase_eval_cli(torch, card, state_dict)
    phase_augment(torch, card)
    with tempfile.TemporaryDirectory() as tree:
        make_train_tree(tree)
        phase_train_readers(torch, card, tree)
        train_cli = phase_train_cli(torch, card, tree, synthetic={
            "vil": training_bf16[1]["step_p50_ms"],
            "ol": training_ol[1]["step_p50_ms"]})
    lap(t0, "phases 30-36")
    distributed = phase_distributed_training(torch, card)
    model_axis = phase_model_axis_training(torch, card)
    lap(t0, "phases 41, 43")
    planes = phase_planes(torch, card, state_dict)
    lap(t0, "phase 45")
    return (nms, chain, launches, w8, launches_w8, nms_ol, ms_products,
            w8_ms, ol, training, chain_bf16, w8_bf16x, bf16, ol_f32_k2,
            training_bf16, training_ol, nms_v3, v3, ms_bf16, train_heads,
            train_cli, backbones, backbone_pipe, train_backbones,
            distributed, mesh_serving, model_axis, exported, planes)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import phnet_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: phnet_torch not importable ({exc}); run from "
              "the repository root", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    global CPU_REFS
    t0 = time.perf_counter()
    card = phase_device(torch)
    CPU_REFS = CpuReferences(torch, CPU_JOBS)
    try:
        got = run_phases(torch, card, t0)
    finally:
        refs, CPU_REFS = CPU_REFS, None
        refs.close()
    print(f"[cpu references] {len(refs.taken)} of {len(refs.keys)} CPU "
          f"sides from the background process ({refs.threads} threads): "
          f"{refs.seconds:.1f} s of its time, {refs.waited:.1f} s of "
          f"waiting for it [{card}]")
    (nms, chain, launches, w8, launches_w8, nms_ol, ms_products, w8_ms, ol,
     training, chain_bf16, w8_bf16x, bf16, ol_f32_k2, training_bf16,
     training_ol, nms_v3, v3, ms_bf16, train_heads, train_cli, backbones,
     backbone_pipe, train_backbones, distributed, mesh_serving, model_axis,
     exported, planes) = got

    w8_ms_frame = stage_sum(w8_ms, 4, [name for name, _, _ in ms_products])
    single, multi = "openlane_config", "openlane_multiscale_config"
    ol_keys = {  # the kernels' numbers on the OpenLane-V paths
        "lane_nms": {"openlane_launches": ol[(single, "none")]["lane_nms"],
                     "openlane_multiscale_launches":
                         ol[(multi, "none")]["lane_nms"],
                     "openlane_ms": nms_ol["ms"],
                     "openlane_plain_ms": nms_ol["plain_ms"],
                     "openlane_bound_ms": nms_ol["bound_ms"],
                     "openlane_propagate_launches":
                         v3[("none", "float32")]["lane_nms"],
                     "propagate_rows_ms": nms_v3["ms"],
                     "propagate_rows_plain_ms": nms_v3["plain_ms"],
                     "propagate_rows_bound_ms": nms_v3["bound_ms"]},
        "router_chain": {"openlane_launches":
                             ol[(single, "none")]["router_chain"],
                         "openlane_multiscale_launches":
                             ol[(multi, "none")]["router_chain"],
                         "openlane_propagate_launches":
                             v3[("none", "float32")]["router_chain"]
                             + v3[("none", "float32")]["router_chain_bf16"]},
        "w8_matmul": {"openlane_launches": ol[(single, "w8")]["w8_matmul"],
                      "openlane_multiscale_launches":
                          ol[(multi, "w8")]["w8_matmul"],
                      "openlane_propagate_launches":
                          v3[("w8", "float32")]["w8_matmul"],
                      "openlane_multiscale_bf16_launches":
                          ms_bf16["w8"]["w8_matmul"],
                      "openlane_multiscale_ms": w8_ms_frame["ms"],
                      "openlane_multiscale_library_ms":
                          w8_ms_frame["library_ms"],
                      "openlane_multiscale_bound_ms":
                          w8_ms_frame["bound_ms"]}}
    kernels = []
    for name, numbers, source, count in (
            ("lane_nms", dict(nms, library_ms=None),
             "phnet_torch/csrc/lane_nms.cu", launches["lane_nms"]),
            ("router_chain", dict(chain[4], library_ms=None),
             "phnet_torch/csrc/router_chain.cu", launches["router_chain"]),
            ("w8_matmul", stage_sum(w8, 4), "phnet_torch/csrc/w8_matmul.cu",
             launches_w8["w8_matmul"])):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": TPU_KERNELS[name], "launches": count,
            "max_abs_err": numbers["max_abs_err"],
            "max_abs_diff": numbers["max_abs_err"],
            "ms": numbers["ms"], "kernel_ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"], "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"]})
        if name == "router_chain":  # its launches in a B=1 training step
            kernels[-1]["training_launches"] = training[1]["k2_launches"]
            # OpenLane-V in float32: phase 22's step of a 4-frame clip
            kernels[-1]["openlane_training_launches"] = ol_f32_k2[0]
            # a bf16 step of the VIL command line on real files (phase 36)
            kernels[-1]["real_data_training_launches"] = \
                train_cli["vil dynamic_k"]["k2_per_step"]
        kernels[-1].update(ol_keys[name])
        # the other backbones' paths (phases 37-39): served in float32 and
        # bf16, the RevCol pipeline, a bf16 training step
        for (backbone, dtype), n in backbones.items():
            kernels[-1][f"{backbone}_{'bf16_' if dtype == 'bfloat16' else ''}"
                        f"launches"] = n[name]
        kernels[-1]["revcol_pipeline_launches"] = backbone_pipe[name]
        if name == "router_chain":
            for backbone, n in train_backbones.items():
                kernels[-1][f"{backbone}_training_launches"] = \
                    n["k2_launches"]
            # phase 41: the NCCL trainer's steps at world size 1
            kernels[-1]["distributed_training_launches"] = \
                distributed["router_chain"]
            # phase 43: both ranks' steps over the model axis
            kernels[-1]["model_axis_training_launches"] = \
                model_axis["router_chain"]
        if name != "w8_matmul":  # phase 42: the split server's ticks
            kernels[-1]["mesh_serving_launches"] = mesh_serving[name]
        # phase 44: the ticks of the exported program (w8's for K3)
        kernels[-1]["export_launches"] = exported[
            "w8" if name == "w8_matmul" else "none"][name]
    for name, base, numbers, source, count in (  # the bf16 paths' entries
            ("router_chain_bf16", "router_chain",
             dict(chain_bf16[16], library_ms=None),
             "phnet_torch/csrc/router_chain.cu",
             bf16["vil 16 streams"]["router_chain_bf16"]),
            ("w8_matmul_bf16x", "w8_matmul", w8_bf16x,
             "phnet_torch/csrc/w8_matmul.cu",
             bf16["vil bf16 w8"]["w8_matmul"])):
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": TPU_KERNELS[base], "launches": count,
            "max_abs_err": numbers["max_abs_err"], "ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"], "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"],
            "library_ms": numbers["library_ms"]})
    kernels[-2]["b4_ms"] = chain_bf16[4]["ms"]
    kernels[-2]["b1_ms"] = chain_bf16[1]["ms"]
    kernels[-2]["b1_plain_ms"] = chain_bf16[1]["plain_ms"]
    kernels[-2]["b1_bound_ms"] = chain_bf16[1]["bound_ms"]
    # its launches in a bf16 B=1 training step (VIL; OpenLane-V)
    kernels[-2]["training_launches"] = training_bf16[1]["k2_launches"]
    kernels[-2]["openlane_training_launches"] = training_ol[1]["k2_launches"]
    kernels[-2]["f32_mode_ms"] = chain_bf16[16]["f32_ms"]
    kernels[-1]["f32x_ms"] = w8_bf16x["f32x_ms"]
    print(f"[train heads] B=1 T=16 bf16 steps: " + "; ".join(
        f"{p}: {n['device_ms_p50']:.1f} ms (CUDA events), "
        f"{n['launches']} launches, busy "
        f"{n['device_ms'] / n['step_p50_ms']:.3f}, "
        f"peak {n['peak_mib']:.1f} MiB, wall p50 {n['step_p50_ms']:.1f} ms"
        for p, n in train_heads.items()) + f" [{card}]")
    print(f"[backbones] served (4 streams, tick p50 / p99 ms, device ms a "
          f"tick, launches, busy, peak MiB): " + "; ".join(
              f"{b} {d}: {n['tick_p50_ms']:.1f} / {n['tick_p99_ms']:.1f}, "
              f"{n['device_ms']:.2f}, {n['launches']}, {n['busy']:.3f}, "
              f"{n['peak_mib']:.0f}" for (b, d), n in backbones.items())
          + f" [{card}]")
    print(f"[backbones] B=1 T=16 bf16 steps: " + "; ".join(
        f"{b}: {n['device_ms']:.1f} ms device (profiled step), "
        f"{n['launches']} launches, busy "
        f"{n['device_ms'] / n['step_p50_ms']:.3f}, peak "
        f"{n['peak_mib']:.1f} MiB, wall p50 {n['step_p50_ms']:.1f} ms"
        for b, n in {"resnet18 (phase 23)": training_bf16[1],
                     **train_backbones}.items()) + f" [{card}]")
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

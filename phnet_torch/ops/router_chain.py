"""The adaptive router's residual chain over per-anchor [C, P] planes.

Port of the chain in ``phnet_tpu/ops/router_pallas.py`` (``_ln`` in its
fast-variance form, ``_conv3x3``, and the kernel ``fused_router_blocks``):
LN0, then ``blocks`` times depthwise 3x3 (zero padding, per-anchor taps
and bias) -> LN -> ReLU -> 3x3 -> LN -> + residual -> ReLU.

``bf16=True`` is the chain with bfloat16 intermediates that the JAX
package serves above 8 streams (``AdaptiveRouter(chain_bf16=True)``,
``phnet_tpu/models/router.py``) and trains in a bf16 model: the same
function, rounded to bf16 at the points :func:`router_chain_plain` lists,
with a bf16 output. The kernel runs it as a second instance of the same
CUDA kernel.

:func:`router_chain` is the wrapper: CUDA tensors run the kernel
``csrc/router_chain.cu``, CPU tensors run :func:`router_chain_plain`,
both as the PyTorch operator ``phnet::router_chain``
(``torch.library.custom_op``, ``bf16`` one of its arguments), whose fake
implementation gives the output's shape, so that ``torch.export`` records
the chain as one node of the graph.
:func:`router_plan` chooses how the kernel groups the planes. Where a
gradient is wanted, the wrapper goes through :class:`RouterChainFn`: its
forward is the same launch (in either mode), its backward recomputes
:func:`router_chain_plain` in the same mode under autograd and
differentiates that (the kernel has no backward of its own yet; the JAX
package trains this chain through XLA, not through its Pallas kernel).
In the bf16 mode the recomputed chain rounds the cotangent to bf16 where
its forward rounds (the backward of each cast), as JAX's autodiff of its
bf16 chain does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from . import _build

STRIP = 8            # channels a kernel thread owns at its point (kR)
GROUPS = (1, 2, 4)   # planes of one anchor a CTA: the kernel's instances
CTAS_PER_SM = 2      # the kernel's launch bounds at the path's shape


class RouterPlan(NamedTuple):
    group: int              # G: planes of one anchor, one a stream, a CTA
    grid: Tuple[int, int]   # (anchors, stream groups)
    threads: int            # a CTA: one a strip of STRIP channels, whole warps


def router_plan(n_planes: int, anchors: int, sm_count: int, c: int = 64,
                p: int = 36) -> RouterPlan:
    """How the kernel covers ``n_planes`` = B x ``anchors`` planes: CTA
    (a, y) takes anchor a of streams y*G .. y*G + G - 1 (the last group
    may be partial). G is the smallest of :data:`GROUPS` whose grid fits
    one wave (``CTAS_PER_SM`` CTAs on each of ``sm_count`` SMs), and no
    larger than B needs; where none fits, the largest."""
    streams = n_planes // anchors
    need = next((g for g in GROUPS if g >= min(streams, GROUPS[-1])),
                GROUPS[-1])
    wave = CTAS_PER_SM * sm_count
    group = next((g for g in GROUPS if g <= need
                  and anchors * -(-streams // g) <= wave), need)
    return RouterPlan(group, (anchors, -(-streams // group)),
                      cta_threads(c, p))


def cta_threads(c: int, p: int) -> int:
    """Threads of a CTA for a [c, p] plane: one a strip, whole warps."""
    return -(-(c // STRIP) * p // 32) * 32


def smem_bytes(c: int, p: int, group: int, blocks: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of a CTA, as the launcher sizes it: the
    LayerNorm partials (two halves), the anchor's taps and biases (12
    floats a conv), and two zero-halo planes (x and the block's middle
    value) a stream, each strip of STRIP rows followed by a gap that keeps
    warps off bank conflicts; the planes hold float32, or bf16 in the
    bf16 mode (2 bytes an element, the gap then a multiple of 64
    elements, 16-byte aligned)."""
    warps = cta_threads(c, p) // 32
    head = 4 * (2 * warps * group * 2 + blocks * 24)
    if bf16:
        pad = (p - STRIP * (p + 2)) % 64
        plane = (c + 2) * (p + 2) + (c // STRIP + 1) * pad
        return head + 2 * 2 * group * (-(-plane // 8) * 8)
    pad = (p - STRIP * (p + 2)) % 32
    plane = (c + 2) * (p + 2) + (c // STRIP + 1) * pad
    return head + 4 * 2 * group * plane


def plan_planes(plan: RouterPlan, n_planes: int) -> torch.Tensor:
    """The planes each CTA of ``plan`` computes, as the kernel indexes
    them: [anchors, stream groups, G], -1 where a partial group has no
    stream."""
    anchors, groups = plan.grid
    stream = (torch.arange(groups)[:, None] * plan.group
              + torch.arange(plan.group))[None]
    planes = stream * anchors + torch.arange(anchors)[:, None, None]
    return torch.where(planes < n_planes, planes, -1)


def layer_norm_cp(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over each [C, P] plane of x [N, C, P], fast variance
    ``max(E[x^2] - E[x]^2, 0)``."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    mean2 = (x * x).mean(dim=(1, 2), keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * scale[None] + bias[None]


def conv3x3_depthwise(x: torch.Tensor, taps: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """Per-plane 3x3 over (C, P) with zero padding, as nine shifted adds in
    tap order k = 3 * (dc + 1) + (dp + 1). x: [N, C, P]; taps: [N, 9];
    bias: [N]."""
    _, c, p = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    y = torch.zeros_like(x)
    k = 0
    for i in range(3):
        for j in range(3):
            y = y + taps[:, k, None, None] * xp[:, i:i + c, j:j + p]
            k += 1
    return y + bias[:, None, None]


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bf16 (ties to even), kept in float32."""
    return x.to(torch.bfloat16).float()


def router_chain_plain(x: torch.Tensor, taps: torch.Tensor,
                       bias: torch.Tensor, ln_params: torch.Tensor,
                       blocks: int, bf16: bool = False) -> torch.Tensor:
    """The plain PyTorch chain. x: [N, C, P] float32 with N a multiple of A
    (plane n belongs to anchor n % A); taps: [A, blocks*18]; bias: [A,
    blocks*2]; ln_params: [2 + 4*blocks, C, P].

    ``bf16=True`` rounds to bf16 where the JAX chain casts with
    ``cdtype = bfloat16``, and computes in float32 between those points:
    the taps and the conv biases; LN0's output (from the float32 input);
    each 3x3's output (its nine products summed in float32 in tap order,
    then the bias); each LayerNorm's output (float32 statistics, fast
    variance); the residual sum ``y + x`` (the ReLUs act on bf16 values and
    round nothing). The output is bf16. The JAX program rounds the 3x3 in
    bf16 after every product and sum where the compiler keeps that
    precision (XLA on the CPU does); the kernel and this version round
    each 3x3 once."""
    reps = x.shape[0] // taps.shape[0]
    rnd = _round_bf16 if bf16 else (lambda t: t)
    taps_n = rnd(taps.repeat(reps, 1))
    bias_n = rnd(bias.repeat(reps, 1))
    x = rnd(layer_norm_cp(x, ln_params[0], ln_params[1]))
    for blk in range(blocks):
        o = 2 + 4 * blk
        y = rnd(conv3x3_depthwise(x, taps_n[:, 18 * blk:18 * blk + 9],
                                  bias_n[:, 2 * blk]))
        y = torch.relu(rnd(layer_norm_cp(y, ln_params[o], ln_params[o + 1])))
        y = rnd(conv3x3_depthwise(y, taps_n[:, 18 * blk + 9:18 * blk + 18],
                                  bias_n[:, 2 * blk + 1]))
        y = rnd(layer_norm_cp(y, ln_params[o + 2], ln_params[o + 3]))
        x = torch.relu(rnd(y + x))
    return x.to(torch.bfloat16) if bf16 else x


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("router_chain").router_chain_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p, i, i]
    fn.restype = i
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _chain_cuda(x, taps, bias, ln_params, blocks: int, bf16: bool = False):
    """Launch ``csrc/router_chain.cu`` on the current stream (its bf16
    instance with ``bf16``)."""
    n, c, p = x.shape
    a = taps.shape[0]
    shapes = {"x": (x, (n, c, p)), "taps": (taps, (a, blocks * 18)),
              "bias": (bias, (a, blocks * 2)),
              "ln_params": (ln_params, (2 + 4 * blocks, c, p))}
    for name, (t, shape) in shapes.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"router_chain kernel: {name} must be a "
                             f"contiguous CUDA float32 tensor, got {t.dtype}"
                             f" on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"router_chain kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if n % a:
        raise ValueError(f"router_chain kernel: {n} planes is not a "
                         f"multiple of {a} anchors")
    plan = router_plan(n, a, _sm_count(x.device), c, p)
    out = torch.empty_like(x, dtype=torch.bfloat16 if bf16 else x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), taps.data_ptr(), bias.data_ptr(),
                          ln_params.data_ptr(), out.data_ptr(), n, a, c, p,
                          blocks, stream, plan.group, int(bf16))
    if err != 0:
        raise RuntimeError(
            f"router_chain kernel launch failed for [{c}, {p}] planes (the "
            f"kernel takes C a multiple of {STRIP}, C * P <= 4096): CUDA "
            f"error {err}")
    if bf16:
        router_chain.launches_bf16 += 1
    else:
        router_chain.launches += 1
    return out


@torch.library.custom_op("phnet::router_chain", mutates_args=(),
                         device_types="cpu")
def _chain_op(x: Tensor, taps: Tensor, bias: Tensor, ln_params: Tensor,
              blocks: int, bf16: bool) -> Tensor:
    return router_chain_plain(x, taps, bias, ln_params, blocks, bf16)


@_chain_op.register_kernel("cuda")
def _(x, taps, bias, ln_params, blocks, bf16):
    return _chain_cuda(x.contiguous(), taps.contiguous(), bias.contiguous(),
                       ln_params.contiguous(), blocks, bf16)


@_chain_op.register_fake
def _(x, taps, bias, ln_params, blocks, bf16):
    return x.new_empty(x.shape, dtype=torch.bfloat16 if bf16 else x.dtype)


def _chain(x, taps, bias, ln_params, blocks: int,
           bf16: bool = False) -> torch.Tensor:
    return torch.ops.phnet.router_chain(x, taps, bias, ln_params,
                                        int(blocks), bool(bf16))


class RouterChainFn(torch.autograd.Function):
    """The chain with a gradient: forward as :func:`router_chain` (the
    kernel on the card, float32 or bf16 mode), backward by autograd
    through :func:`router_chain_plain` in the same mode, recomputed from
    the saved inputs (the range ``router_chain_backward`` in a
    ``torch.profiler`` trace)."""

    @staticmethod
    def forward(ctx, x, taps, bias, ln_params, blocks, bf16=False):
        ctx.save_for_backward(x, taps, bias, ln_params)
        ctx.blocks, ctx.bf16 = blocks, bf16
        return _chain(x, taps, bias, ln_params, blocks, bf16)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(
            ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad(), torch.profiler.record_function(
                "router_chain_backward"):
            y = router_chain_plain(*inputs, ctx.blocks, ctx.bf16)
            grads = iter(torch.autograd.grad(y, wanted, grad))
        return (*(next(grads) if t.requires_grad else None
                  for t in inputs), None, None)


def router_chain(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                 ln_params: torch.Tensor, blocks: int,
                 bf16: bool = False) -> torch.Tensor:
    """The router chain on x [N, C, P] float32 (see
    :func:`router_chain_plain`); ``bf16`` selects the chain with bf16
    intermediates and output. CUDA tensors run the kernel, CPU tensors the
    plain version; with autograd on and an input that wants a gradient,
    through :class:`RouterChainFn` (in either mode)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, taps, bias, ln_params)):
        return RouterChainFn.apply(x, taps, bias, ln_params, blocks, bf16)
    return _chain(x, taps, bias, ln_params, blocks, bf16)


# kernel launches, counted where the kernel launches: the float32 instance
# and the bf16 one
router_chain.launches = 0
router_chain.launches_bf16 = 0

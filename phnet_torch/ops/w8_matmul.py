"""Weight-only int8 matmul, ``out = (bf16(x) @ bf16(wq)) * sw`` in f32.

Port of ``phnet_tpu/ops/w8_pallas.py::w8_matmul_pallas`` (its kernel
``_w8_matmul_kernel``), the drop-in for ``ops/quant.py::
w8_matmul_prequant``: x [..., K] f32 or bf16, wq [K, N] int8 with the
per-column scales sw [N] f32; returns [..., N] f32, leading dims
flattened into rows.

:func:`w8_matmul` is the wrapper: CUDA tensors run the kernel
``csrc/w8_matmul.cu``, CPU tensors run the plain version
:func:`phnet_torch.ops.quant.w8_matmul_prequant`, both as the PyTorch
operator ``phnet::w8_matmul`` (``torch.library.custom_op``), whose fake
implementation gives the output's shape, so that ``torch.export`` records
each product as one node of the graph.

:func:`w8_plan` chooses the kernel's tiling from (M, K, N) and the SM
count: the output tile width and the split-K count, and the padding that
the kernel's tensor maps need (none at the shapes of the main path).
:func:`w8_matmul_split_plain` is the plain version of the kernel's
summation order under a plan: one f32 partial product per K split, summed
in split order, then scaled.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from . import _build
from .quant import w8_matmul_prequant

BLOCK_M = 128  # output rows of a CTA: two wgmma warpgroups of 64
K_UNIT = 64    # split-K granularity, elements of K
MIN_SPLIT_K = 256  # least K depth of one split
# TMA wants 16-byte row strides: K of f32 or bf16 x a multiple of 8 (one
# rule for both, so both take the same plan), N of the int8 wq of 16
K_ALIGN, N_ALIGN = 8, 16


class W8Plan(NamedTuple):
    """Tiling of one product: ``block_n``-wide output tiles of
    ``BLOCK_M`` rows, K cut into ``splits`` ranges of whole ``K_UNIT``s
    (:func:`split_ranges`), x and wq zero-padded by ``pad_k`` / ``pad_n``."""
    block_n: int
    splits: int
    pad_k: int
    pad_n: int
    ctas: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def w8_plan(m: int, k: int, n: int, n_sms: int = 132) -> W8Plan:
    """Tile width and split count for an [m, k] @ [k, n] product on a card
    with ``n_sms`` SMs.

    A CTA of the kernel holds a whole SM (384 threads at up to 168
    registers, 170-210 KB of shared memory), so a grid runs in waves of
    ``n_sms`` CTAs and a grid just past a wave costs a second one. Wide
    tiles re-read x (f32) fewer times: the widest tile (256, or N rounded
    up to 128 or 64 where N is narrower) is taken, or half of it, as long
    as its tiles fill at least half a wave. Where neither does, K is split
    into as many ranges as fit in one wave, each at least ``MIN_SPLIT_K``
    deep; of the two widths, the one that fills more of the wave, and on a
    tie the one with fewer splits (each split adds a workspace round
    trip)."""
    pad_k, pad_n = -k % K_ALIGN, -n % N_ALIGN
    kp, np_ = k + pad_k, n + pad_n
    m_tiles, units = _cdiv(m, BLOCK_M), _cdiv(kp, K_UNIT)
    widest = 256 if np_ > 128 else 128 if np_ > 64 else 64
    widths = (widest, widest // 2) if widest > 64 else (widest,)
    for block_n in widths:
        tiles = m_tiles * _cdiv(np_, block_n)
        if 2 * tiles >= n_sms:
            return W8Plan(block_n, 1, pad_k, pad_n, tiles)
    best = None
    for block_n in widths:
        tiles = m_tiles * _cdiv(np_, block_n)
        splits = max(1, min(n_sms // tiles, units * K_UNIT // MIN_SPLIT_K))
        key = (tiles * splits, -splits)
        if best is None or key > best[0]:
            best = (key, W8Plan(block_n, splits, pad_k, pad_n,
                                tiles * splits))
    return best[1]


def split_ranges(k: int, plan: W8Plan) -> List[Tuple[int, int]]:
    """The K range [k0, k1) of each split, in summation order: split s
    takes units ``s * u // S`` to ``(s + 1) * u // S`` of the padded K (as
    the kernel computes them); the last ends at the padded K."""
    kp = k + plan.pad_k
    units, s = _cdiv(kp, K_UNIT), plan.splits
    return [(i * units // s * K_UNIT, min((i + 1) * units // s * K_UNIT, kp))
            for i in range(s)]


def w8_matmul_split_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                          plan: W8Plan) -> torch.Tensor:
    """The kernel's summation order in plain PyTorch: per K split an f32
    product of the bf16-rounded operands, the partials summed in split
    order, then scaled by sw. x [M, K]; returns [M, N] f32."""
    xb = x.to(torch.bfloat16).float()
    w = wq.float()
    total = None
    for k0, k1 in split_ranges(x.shape[-1], plan):
        k1 = min(k1, x.shape[-1])  # the padding adds zeros only
        part = xb[:, k0:k1] @ w[k0:k1]
        total = part if total is None else total + part
    return total * sw


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load("w8_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.w8_matmul_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i, p]
    lib.w8_matmul_launch.restype = i
    lib.w8_matmul_smem_bytes.argtypes = [i]
    lib.w8_matmul_smem_bytes.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def smem_bytes(block_n: int) -> int:
    """Dynamic shared memory of one CTA of the kernel (builds it)."""
    return _library().w8_matmul_smem_bytes(block_n)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _w8_cuda(x: torch.Tensor, wq: torch.Tensor,
             sw: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/w8_matmul.cu`` on x [M, K] on the current stream."""
    m, k = x.shape
    n = wq.shape[1]
    checks = {"x": (x, (torch.float32, torch.bfloat16), (m, k)),
              "wq": (wq, (torch.int8,), (k, n)),
              "sw": (sw, (torch.float32,), (n,))}
    for name, (t, dtypes, shape) in checks.items():
        if not t.is_cuda or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"w8_matmul kernel: {name} must be a contiguous "
                             f"tensor on {x.device}, got one on {t.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"w8_matmul kernel: {name} has dtype {t.dtype}, "
                             f"expected one of {dtypes}")
        if tuple(t.shape) != shape:
            raise ValueError(f"w8_matmul kernel: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.float32, device=x.device)
    plan = w8_plan(m, k, n, _sm_count(x.device.index or 0))
    if plan.pad_k or plan.pad_n:  # never on the main path
        x = F.pad(x, (0, plan.pad_k))
        wq = F.pad(wq, (0, plan.pad_n, 0, plan.pad_k))
        sw = F.pad(sw, (0, plan.pad_n))
    x, wq, sw = _aligned(x), _aligned(wq), _aligned(sw)
    kp, np_ = k + plan.pad_k, n + plan.pad_n
    out = torch.empty((m, np_), dtype=torch.float32, device=x.device)
    ws = (torch.empty((plan.splits, m, np_), dtype=torch.float32,
                      device=x.device) if plan.splits > 1 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _library().w8_matmul_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(),
            sw.data_ptr(), out.data_ptr(),
            ws.data_ptr() if ws is not None else None, m, kp, np_,
            plan.block_n, plan.splits, stream)
    if err != 0:
        raise RuntimeError(f"w8_matmul kernel launch failed: error {err} "
                           f"(CUDA error if positive; see csrc/w8_matmul.cu "
                           f"for the host-side codes)")
    w8_matmul.launches += 1
    return out if not plan.pad_n else out[:, :n].contiguous()


@torch.library.custom_op("phnet::w8_matmul", mutates_args=(),
                         device_types="cpu")
def _w8_op(x: Tensor, wq: Tensor, sw: Tensor) -> Tensor:
    return w8_matmul_prequant(x, wq, sw)


@_w8_op.register_kernel("cuda")
def _(x, wq, sw):
    k, n = wq.shape
    out = _w8_cuda(x.reshape(-1, k).contiguous(), wq.contiguous(),
                   sw.contiguous())
    return out.reshape(*x.shape[:-1], n)


@_w8_op.register_fake
def _(x, wq, sw):
    return x.new_empty((*x.shape[:-1], wq.shape[1]), dtype=torch.float32)


def w8_matmul(x: torch.Tensor, wq: torch.Tensor,
              sw: torch.Tensor) -> torch.Tensor:
    """``(bf16(x) @ bf16(wq)) * sw`` in f32 over x [..., K]: one call of
    the operator ``phnet::w8_matmul``. CUDA tensors run the kernel, CPU
    tensors the plain version."""
    return torch.ops.phnet.w8_matmul(x, wq, sw)


w8_matmul.launches = 0  # kernel launches, counted where the kernel launches

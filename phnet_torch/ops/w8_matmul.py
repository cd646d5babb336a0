"""Weight-only int8 matmul, ``out = (bf16(x) @ bf16(wq)) * sw`` in f32.

Port of ``phnet_tpu/ops/w8_pallas.py::w8_matmul_pallas`` (its kernel
``_w8_matmul_kernel``), the drop-in for ``ops/quant.py::
w8_matmul_prequant``: x [..., K] f32 or bf16, wq [K, N] int8 with the
per-column scales sw [N] f32; returns [..., N] f32, leading dims
flattened into rows.

:func:`w8_matmul` is the wrapper: CUDA tensors run the kernel
``csrc/w8_matmul.cu``, CPU tensors run the plain version
:func:`phnet_torch.ops.quant.w8_matmul_prequant`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .quant import w8_matmul_prequant


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("w8_matmul").w8_matmul_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, p, p, i, i, i, p]
    fn.restype = i
    return fn


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
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _launcher()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                          wq.data_ptr(), sw.data_ptr(), out.data_ptr(), m, k,
                          n, stream)
    if err != 0:
        raise RuntimeError(f"w8_matmul kernel launch failed: CUDA error {err}")
    w8_matmul.launches += 1
    return out


def w8_matmul(x: torch.Tensor, wq: torch.Tensor,
              sw: torch.Tensor) -> torch.Tensor:
    """``(bf16(x) @ bf16(wq)) * sw`` in f32 over x [..., K]. CUDA tensors
    run the kernel, CPU tensors the plain version."""
    k, n = wq.shape
    if x.is_cuda:
        out = _w8_cuda(x.reshape(-1, k).contiguous(), wq.contiguous(),
                       sw.contiguous())
        return out.reshape(*x.shape[:-1], n)
    if x.device.type == "cpu":
        return w8_matmul_prequant(x, wq, sw)
    raise ValueError(f"w8_matmul: unsupported device {x.device}")


w8_matmul.launches = 0  # kernel launches, counted where the kernel launches

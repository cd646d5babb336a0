"""Symmetric int8 quantization of the DynamicConv generator chains.

Own copy of ``phnet_tpu/ops/quant.py`` (inference only):

- activations: per-row absmax scale (:func:`quantize_rowwise`);
- weights: per-output-column absmax scale (:func:`quantize_colwise`),
  computed once per weight set outside the frame loop;
- ``"int8"`` (w8a8): both operands int8, int32 accumulation, f32 rescale
  by the outer product of the two scales (:func:`int8_matmul_prequant`);
- ``"w8"`` (weight-only): int8 weights dequantized into a bf16 product
  with f32 accumulation (:func:`w8_matmul_prequant`, the plain version
  of the w8 matmul kernel ``csrc/w8_matmul.cu``).

Rounding is half-to-even (``torch.round``, as ``jnp.round``); scales are
floored at 1e-8 and codes clipped to [-127, 127].
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-8
# 1/127 rounded once to float32: XLA rewrites a division by the constant
# 127 into a multiply by this reciprocal inside a compiled graph
_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis: (q [.., K] int8, scale [.., 1]
    f32) with x ~= q * scale. The scale is ``absmax * f32(1/127)``, the
    form every JAX caller computes (activations are quantized inside the
    compiled graph)."""
    scale = x.abs().amax(dim=-1, keepdim=True) * _INV127
    scale = torch.clamp(scale, min=_EPS)
    return _codes(x, scale), scale.float()


def quantize_colwise(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per output column of a [K, N] kernel: (q [K, N] int8,
    contiguous; scale [N] f32). The scale is ``absmax / 127``, true
    division, as the JAX server's eager weight quantization computes it."""
    scale = w.abs().amax(dim=0) / 127.0
    scale = torch.clamp(scale, min=_EPS)
    return _codes(w, scale).contiguous(), scale.float()


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] @ int8 [K, N] -> int32. On the card
    ``torch._int_mm`` needs M > 16 and K, N multiples of 8: smaller or
    ragged operands are zero-padded (exact) and the result cut back."""
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
        if pm or pk or pn:
            a = F.pad(a, (0, pk, 0, pm))
            b = F.pad(b, (0, pn, 0, pk))
            return torch._int_mm(a, b)[:m, :n]
    return torch._int_mm(a, b)


def int8_weight_layout(wq: torch.Tensor) -> torch.Tensor:
    """The same [K, N] int8 kernel stored column-major, the layout
    cuBLASLt's int8 GEMM (``torch._int_mm``) takes without transposing the
    weight on every call (row-major is several times slower on an
    H100)."""
    return wq.t().contiguous().t()


def int8_matmul_prequant(x: torch.Tensor, wq: torch.Tensor,
                         sw: torch.Tensor) -> torch.Tensor:
    """x [..., K] against an already-quantized kernel (wq int8 [K, N],
    sw f32 [N]): per-row activation quantization, int32 accumulation,
    ``acc * sx * sw`` in f32. Returns [..., N] f32."""
    k, n = wq.shape
    xq, sx = quantize_rowwise(x.float())
    acc = _int_mm(xq.reshape(-1, k), wq).reshape(*x.shape[:-1], n)
    return acc.float() * sx * sw


def w8_matmul_prequant(x: torch.Tensor, wq: torch.Tensor,
                       sw: torch.Tensor) -> torch.Tensor:
    """Weight-only int8: ``(bf16(x) @ bf16(wq)) * sw`` with f32 products
    and accumulation. Returns [..., N] f32. Both operands are rounded to
    bf16 and then multiplied in f32 (with TF32 off on the card): a bf16
    ``torch.matmul`` would round its output to bf16, which the JAX function
    (``preferred_element_type=f32``) does not."""
    xb = x.to(torch.bfloat16).float()
    return (xb @ wq.float()) * sw


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] f32 with dynamic w8a8. Returns [..., N] f32."""
    wq, sw = quantize_colwise(w.float())
    return int8_matmul_prequant(x, wq, sw)


def int8_affine(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized ``x @ kernel + bias`` (bias stays f32)."""
    y = int8_matmul(x, kernel)
    if bias is not None:
        y = y + bias.float()
    return y

"""The JAX package's mixed precision, ``compute_dtype="bfloat16"``, as
the port's modules run it, in inference and in training.

flax modules built with ``dtype=bfloat16`` keep float32 parameters and
cast them at use: a ``Dense`` casts its input, kernel and bias to bf16,
rounds the product to bf16 and adds the bias in bf16; a ``LayerNorm``
computes its statistics in float32 with the fast variance
``max(E[x^2] - E[x]^2, 0)``, normalizes in float32 and rounds its output
to its ``dtype`` (float32 where it has none). The helpers below do the
same from a module's float32 parameters; under autograd each cast
rounds the cotangent back, as JAX's transpose of a cast does, and the
parameters' gradients stay float32 (flax's ``param_dtype``).

A module's compute dtype is ``torch.bfloat16``, or None for the float32
model: that model casts nothing and keeps its own formulation, so that it
computes in its parameters' dtype (float32; float64 where a test runs it
so).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..config import ModelConfig
from ..parallel.tensor import is_sharded


def compute_dtype(cfg: ModelConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def cast(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x in the compute dtype (as it is for None)."""
    return x if dtype is None else x.to(dtype)


def widen(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x back in float32 from the compute dtype (as it is for None)."""
    return x if dtype is None else x.float()


def dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` in x's dtype: for bf16 the product rounded to bf16,
    then the bias added in bf16; ``lin(x)`` otherwise, and for a layer
    sharded over the mesh's model axis (whose forward casts alike)."""
    if x.dtype != torch.bfloat16 or is_sharded(lin):
        return lin(x)
    return x @ lin.weight.to(x.dtype).t() + lin.bias.to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``LayerNorm`` over the last axis: float32 statistics by the
    fast variance, output rounded to ``dtype``; ``ln`` itself for None."""
    if dtype is None:
        return ln(x)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias
    return y.to(dtype)

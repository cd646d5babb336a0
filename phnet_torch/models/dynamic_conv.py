"""Instance interaction with dynamically generated weights.

Port of ``phnet_tpu/models/dynamic_conv.py`` (reference
``dynamic_head.py:6-59``). A proposal embedding generates a per-anchor
[C, 2C] weight; the pooled anchor feature [P, C] goes through it,
LayerNorm, ReLU, then through a second generated [2C, C] weight
conditioned on the intermediate, LayerNorm, ReLU, and a flattening output
MLP with a final LayerNorm. LayerNorms use flax's epsilon, 1e-6. The
multi-scale head's form (``DynamicConvV2``, ``dynamic_head.py:61``) maps
the stage's C channels into a shared ``out_dim`` (256) through an
``out_hidden``-wide (512) output MLP, from a ``pro_dim``-wide (256)
proposal embedding, with ``param_reduction=4``.

Each generator is two stacked linears with no activation between them.
Where ``hid * (in + out) >= in * out`` the pair is served as one product
with the pre-combined matrix (:func:`combine_weights`, computed once
outside the frame loop): on VIL the first generator (64 -> 1024 -> 8192)
and the output MLP (2304 -> 384 -> 64) collapse; the second generator
(4608 -> 1024 -> 8192) stays factored. On the multi-scale OL preset the
output MLPs (1536 -> 512 -> 256) and the first generators of stages 0 and
1 collapse, and every second generator and stage 2's first generator
(256 -> 128 -> 512) stay factored. The second generated weight is in
the natural d-major order (the JAX package's c-major permutation is a
layout choice of the TPU; a column permutation commutes with per-column
quantization, so it is the same function in the quantized modes too).
Over a mesh's model axis (training) a chain with a sharded generator is
a :class:`phnet_torch.parallel.tensor.Chain`: the same combine, with the
split kept on the combined kernel where it can be.
The second generator reads its input detached, as the reference does
(``dynamic_head.py:48-50``). In train mode :meth:`combine_weights` keeps
the autograd graph, so the combined-to-factored chain rule runs once per
step, after the frame loop, as in the JAX package.

``quantize="w8"`` / ``"int8"`` (inference only, ``ops/quant.py``) turns
every chain product into an int8 one against kernels quantized per output
column once per weight set: on VIL four products per stage (gen1
collapsed, gen2 factored into two, out collapsed), on the multi-scale
OL preset 13 a frame. ``"w8"`` runs them
through the w8 matmul kernel on the card; ``"int8"`` quantizes the
activations per row and accumulates in int32.

``dtype=torch.bfloat16`` is the JAX package's ``compute_dtype="bfloat16"``
(inference and training): :meth:`combine_weights` computes in float32
(keeping its graph in train mode) and casts its
kernels and biases to bf16 at the end; the inputs are cast to bf16, the
products and their bias adds run in bf16, and the LayerNorms are flax's
with ``dtype=bf16`` (float32 statistics, bf16 output); the output is
float32. In the quantized modes the combines stay as they are: a w8
product takes the bf16 activations as they come (``(f32 product + b)``,
then cast to bf16), an int8 one upcasts them before quantizing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from ..config import check_quantize
from ..ops.quant import (int8_matmul_prequant, int8_weight_layout,
                         quantize_colwise)
from ..ops.w8_matmul import w8_matmul
from ..parallel.tensor import Chain, is_sharded
from .mixed import cast, layer_norm, widen

LN_EPS = 1e-6  # flax nn.LayerNorm default


def collapse_wins(in_dim: int, hid: int, out_dim: int) -> bool:
    """One product of the combined matrix costs in*out MACs per row, the
    factored pair in*hid + hid*out."""
    return hid * (in_dim + out_dim) >= in_dim * out_dim


class DynamicConv(nn.Module):
    def __init__(self, feat_size: int = 36, hidden_dim: int = 64,
                 dim_factor: int = 2, param_reduction: int = 8,
                 out_expand: int = 6, out_dim: int = 0, out_hidden: int = 0,
                 pro_dim: int = 0, quantize: str = "none",
                 dtype: Optional[torch.dtype] = None):
        """``out_dim`` 0 means C and ``out_hidden`` 0 means C *
        ``out_expand``; ``pro_dim`` 0 means ``out_dim``; ``dtype`` is the
        compute dtype (None: float32 compute)."""
        super().__init__()
        self.quantize = check_quantize(quantize)
        self.dtype = dtype
        c = hidden_dim
        d = c * dim_factor
        num_params = c * d
        hid = num_params // param_reduction
        out_dim = out_dim or c
        out_hidden = out_hidden or c * out_expand
        pro_dim = pro_dim or out_dim
        self.feat_size, self.c, self.d = feat_size, c, d
        self.gen1_a = nn.Linear(pro_dim, hid)
        self.gen1_b = nn.Linear(hid, num_params)
        self.gen2_a = nn.Linear(feat_size * d, hid)
        self.gen2_b = nn.Linear(hid, num_params)
        self.out_a = nn.Linear(feat_size * c, out_hidden)
        self.out_b = nn.Linear(out_hidden, out_dim)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(out_dim, eps=LN_EPS)

    def reset_parameters(self, g: torch.Generator):
        for lin in (self.gen1_a, self.gen1_b, self.gen2_a, self.gen2_b,
                    self.out_a, self.out_b):
            lin.weight.data.copy_(torch.randn(lin.weight.shape, generator=g)
                                  / math.sqrt(lin.in_features))
            lin.bias.data.zero_()
        for ln in (self.norm1, self.norm2, self.norm3):
            ln.weight.data.fill_(1.0)
            ln.bias.data.zero_()

    def combine_weights(self) -> Dict[str, Union[tuple, Dict]]:
        """Per chain: ``(kernel [in, out], bias)`` of the collapsed pair, or
        ``(k1, b1, k2, b2)`` of the factored one, kernels as [in, out].
        Quantized modules return the pre-quantized form instead:
        ``{wq, sw, b}`` for a collapsed chain (the f32 product and bias
        fold, then :func:`quantize_colwise`) and ``{wq1, sw1, b1, wq2, sw2,
        b2}`` for a factored one; ``"int8"`` stores the int8 kernels
        column-major (:func:`int8_weight_layout`). Unquantized entries are
        cast to the compute dtype after the float32 combine. Keeps the
        autograd graph only in train mode and unquantized (the quantized
        forms are inference-only)."""
        with torch.set_grad_enabled(self.training and self.quantize == "none"
                                    and torch.is_grad_enabled()):
            return self._combine()

    def _combine(self) -> Dict[str, Union[tuple, Dict, Chain]]:
        out = {}
        for name in ("gen1", "gen2", "out"):
            la, lb = getattr(self, name + "_a"), getattr(self, name + "_b")
            ka, kb = la.weight.t(), lb.weight.t()
            collapse = collapse_wins(la.in_features, la.out_features,
                                     lb.out_features)
            if is_sharded(la) or is_sharded(lb):
                if self.quantize != "none":
                    raise NotImplementedError(
                        "a quantized DynamicConv sharded over the model "
                        "axis (the server replicates its weights)")
                out[name] = Chain(la, lb, collapse, self.dtype)
            elif self.quantize == "none":
                out[name] = tuple(cast(t, self.dtype) for t in (
                    (ka @ kb, la.bias @ kb + lb.bias) if collapse
                    else (ka.contiguous(), la.bias, kb.contiguous(),
                          lb.bias)))
            elif collapse:
                wq, sw = quantize_colwise(ka @ kb)
                out[name] = {"wq": wq, "sw": sw, "b": la.bias @ kb + lb.bias}
            else:
                wq1, sw1 = quantize_colwise(ka)
                wq2, sw2 = quantize_colwise(kb)
                out[name] = {"wq1": wq1, "sw1": sw1, "b1": la.bias,
                             "wq2": wq2, "sw2": sw2, "b2": lb.bias}
        if self.quantize == "int8":
            for entry in out.values():
                for key in [k for k in entry if k.startswith("wq")]:
                    entry[key] = int8_weight_layout(entry[key])
        return out

    def _affine(self, x, pre):
        """A chain on x in the compute dtype, its output in it too (a
        factored quantized chain keeps its middle value in float32)."""
        if isinstance(pre, Chain):
            return pre(x)
        if self.quantize == "none":
            if len(pre) == 2:
                return x @ pre[0] + pre[1]
            return (x @ pre[0] + pre[1]) @ pre[2] + pre[3]
        mm = w8_matmul if self.quantize == "w8" else int8_matmul_prequant
        if "wq" in pre:
            y = mm(x, pre["wq"], pre["sw"]) + pre["b"]
        else:
            y = mm(x, pre["wq1"], pre["sw1"]) + pre["b1"]
            y = mm(y, pre["wq2"], pre["sw2"]) + pre["b2"]
        return cast(y, self.dtype)

    def forward(self, pro_feat: torch.Tensor, roi_feat: torch.Tensor,
                combined=None) -> torch.Tensor:
        """pro_feat [B, A, pro_dim], roi_feat [B, A, P, C] -> [B, A,
        out_dim].
        ``combined``: :meth:`combine_weights`, computed once per weight
        set by the caller (None computes it here)."""
        c, d, p = self.c, self.d, self.feat_size
        combined = combined if combined is not None else self.combine_weights()
        pro_feat, roi_feat = cast(pro_feat, self.dtype), cast(roi_feat,
                                                               self.dtype)
        w1 = self._affine(pro_feat, combined["gen1"])
        w1 = w1.reshape(*w1.shape[:-1], c, d)
        feats = torch.relu(layer_norm(roi_feat @ w1, self.norm1,
                                      self.dtype))  # [B, A, P, D]
        w2 = self._affine(feats.detach().reshape(*feats.shape[:-2], p * d),
                          combined["gen2"])
        w2 = w2.reshape(*w2.shape[:-1], d, c)
        feats = torch.relu(layer_norm(feats @ w2, self.norm2,
                                      self.dtype))  # [B, A, P, C]
        out = self._affine(feats.reshape(*feats.shape[:-2], p * c),
                           combined["out"])
        return widen(layer_norm(out, self.norm3, self.dtype), self.dtype)

"""Pre-norm transformer decoder of the second branch.

Port of ``phnet_tpu/models/transformer.py``. The memory is a fixed-shape
[B, M, D] bank with a key mask; masked logits are set to -1e9 (not -inf,
so an all-masked row stays finite), and rows of a stream with no valid
memory pass ``tgt`` through unchanged after the final norm. An optional
``tgt_mask`` [B, Nt] marks the target rows valid as self-attention keys
(the prior-propagation head's empty slots are not; where every slot is
empty, every key is masked and the -1e9 logits give a uniform softmax).
Projections
are fused per source (``qkv`` for self-attention, ``q`` + ``kv`` for
cross-attention); LayerNorms use flax's epsilon 1e-6 and the FFN the tanh
GELU of ``flax.linen.gelu``.

Dropout (train mode, rate ``dropout``) sits where the JAX package puts
it: on the attention weights, on each attention's residual branch, after
the FFN's GELU and on its output. Its masks come from the
``torch.Generator`` the caller passes, so that a recompute seeded alike
draws the same masks; with no generator, or in eval mode, there is none.
Under data-parallel training each rank's masks are its rows of the masks
of the global batch (``parallel.multihost.batch_rand``).

In bfloat16 (``dtype``, the JAX package's ``compute_dtype="bfloat16"``)
the decoder's residual stream and memory are cast to bf16 and
its dense layers compute in bf16; its LayerNorms, which have no dtype in
the JAX package, give float32 from float32 statistics; the q.k logits come
out of a bf16 product and are cast to float32 before the scale, the
softmax runs in float32 and its weights are cast back to bf16 for the
value product; the final norm reads the stream in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.multihost import batch_rand
from .mixed import cast, dense, layer_norm, widen

NEG_INF = -1e9
LN_EPS = 1e-6


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep with probability ``1 - rate`` (a uniform
    draw from ``gen`` at or above ``rate``) and divide the kept by the keep
    rate in x's dtype (a bf16 tensor by bf16(1 - rate), as JAX divides by
    its weakly typed keep rate). Identity when ``gen`` is None or rate is
    0."""
    if gen is None or rate <= 0.0:
        return x
    keep = batch_rand(x.shape, gen, x.device) >= rate
    keep_rate = float(torch.tensor(1.0 - rate, dtype=x.dtype))
    return torch.where(keep, x / keep_rate, 0.0)


def widen_to(dtype: Optional[torch.dtype]) -> Optional[torch.dtype]:
    """The output dtype of a LayerNorm without a dtype: float32 in a
    mixed-precision model, the model's own (None) in a float32 one."""
    return None if dtype is None else torch.float32


def _lecun_(lin: nn.Linear, g: torch.Generator):
    lin.weight.data.copy_(torch.randn(lin.weight.shape, generator=g)
                          / math.sqrt(lin.in_features))
    lin.bias.data.zero_()


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, self_attention: bool,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.dtype = dtype
        self.self_attention = self_attention
        if self_attention:
            self.qkv = nn.Linear(dim, 3 * dim)
        else:
            self.q = nn.Linear(dim, dim)
            self.kv = nn.Linear(dim, 2 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q, kv, key_mask: Optional[torch.Tensor] = None,
                rate: float = 0.0, gen: Optional[torch.Generator] = None):
        """q [B, Nq, D]; kv [B, Nk, D] (ignored for self-attention);
        key_mask [B, Nk] bool (True = keep); dropout of the attention
        weights at ``rate`` from ``gen``."""
        h = self.num_heads
        hd = self.dim // h
        b, nq, _ = q.shape
        if self.self_attention:
            qp, kp, vp = dense(q, self.qkv).split(self.dim, dim=-1)
        else:
            qp = dense(q, self.q)
            kp, vp = dense(kv, self.kv).split(self.dim, dim=-1)
        nk = kp.shape[1]
        qp = qp.reshape(b, nq, h, hd).transpose(1, 2)  # [B, H, Nq, hd]
        kp = kp.reshape(b, nk, h, hd).transpose(1, 2)
        vp = vp.reshape(b, nk, h, hd).transpose(1, 2)
        logits = widen(qp @ kp.transpose(-1, -2), self.dtype) / math.sqrt(
            float(hd))
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :], NEG_INF)
        weights = dropout(torch.softmax(logits, dim=-1), rate, gen)
        out = weights.to(vp.dtype) @ vp  # [B, H, Nq, hd]
        return dense(out.transpose(1, 2).reshape(b, nq, self.dim), self.out)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, ffn_dim: int = 256,
                 dropout: float = 0.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.rate = dropout
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.self_attn = MultiHeadAttention(dim, num_heads, True, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = MultiHeadAttention(dim, num_heads, False, dtype)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn1 = nn.Linear(dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, dim)

    def forward(self, tgt, memory, memory_mask,
                gen: Optional[torch.Generator] = None,
                tgt_mask: Optional[torch.Tensor] = None):
        """``gen``: the dropout masks' generator (train mode only);
        ``tgt_mask`` [B, Nt] bool: the target rows valid as self-attention
        keys (None: all)."""
        p = self.rate
        gen = gen if self.training else None

        def norm(x, ln):  # flax LayerNorm() has no dtype: float32 out
            return cast(layer_norm(x, ln, widen_to(self.dtype)), self.dtype)

        sa = self.self_attn(norm(tgt, self.norm1), None, tgt_mask, p, gen)
        tgt = tgt + dropout(sa, p, gen)
        ca = self.cross_attn(norm(tgt, self.norm2), memory, memory_mask, p,
                             gen)
        tgt = tgt + dropout(ca, p, gen)
        y = F.gelu(dense(norm(tgt, self.norm3), self.ffn1), approximate="tanh")
        return tgt + dropout(dense(dropout(y, p, gen), self.ffn2), p, gen)


class TemporalDecoder(nn.Module):
    """Pre-norm decoder layers + final LayerNorm; identity for a stream
    whose memory bank is empty."""

    def __init__(self, dim: int, num_layers: int = 2, num_heads: int = 8,
                 ffn_dim: int = 256, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            DecoderLayer(dim, num_heads, ffn_dim, dropout, dtype)
            for _ in range(num_layers))
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def reset_parameters(self, g: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                _lecun_(m, g)
            elif isinstance(m, nn.LayerNorm):
                m.weight.data.fill_(1.0)
                m.bias.data.zero_()

    def forward(self, tgt, memory, memory_mask,
                gen: Optional[torch.Generator] = None,
                tgt_mask: Optional[torch.Tensor] = None):
        """tgt [B, A, D]; memory [B, M, D]; memory_mask [B, M] bool;
        ``gen``: the dropout masks' generator (train mode only);
        ``tgt_mask`` [B, A] bool: the rows of tgt valid as self-attention
        keys (None: all)."""
        x, memory = cast(tgt, self.dtype), cast(memory, self.dtype)
        for layer in self.layers:
            x = layer(x, memory, memory_mask, gen, tgt_mask)
        x = layer_norm(x, self.final_norm, widen_to(self.dtype))
        has_memory = memory_mask.any(dim=-1)
        return torch.where(has_memory[:, None, None], x, tgt)

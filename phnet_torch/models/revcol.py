"""RevCol backbone (reversible columns of ConvNeXt blocks), NHWC inside.

Port of ``phnet_tpu/models/revcol.py`` (the reference's
``libs/models/revcolV2.py``, selected by ``cfg.backbone == 'revcol'``): a
4x4/s4 stem conv and LayerNorm, then ``num_subnet`` columns; column ``i``
updates the four levels in turn as ``c_j <- alpha_j * c_j + Level_j(
c_{j-1}, c_{j+1})`` (the first column has no ``alpha`` and no upward
input), each level a :class:`Fusion` of its inputs followed by ConvNeXt
blocks. The outputs are the last column's four levels (strides 4, 8, 16,
32), NHWC.

What decides parity with the JAX package:

* the LayerNorms (``stem_norm``, ``down_norm``, ``up_norm``, a block's
  ``norm``) are flax's: epsilon 1e-6 and the fast variance
  ``max(0, E[x^2] - E[x]^2)``; GELU is the tanh form;
* ``alpha`` is clamped at use to ``sign(a) * max(|a|, 1e-3)``, so that 0
  stays 0;
* the backbone computes in its parameters' dtype: the JAX modules have no
  ``dtype``, so a bf16 model's frames are rounded to bf16 and then
  computed in float32 (the encoder does the rounding);
* drop path (training only, with a seed): one Bernoulli(1 - rate) mask
  per image, ``y * mask / keep``, in every block; each column draws its
  masks from a generator seeded with :func:`column_seed`, so that the
  recompute of a checkpointed column draws the same masks without
  touching any live generator. The masks come from PyTorch's generators,
  not JAX's, so they match the JAX package's in distribution only; under
  data-parallel training each rank's masks are its images' rows of the
  global batch's (``parallel.multihost.batch_rand``).

``save_memory`` recomputes every column but the first in the backward
(``torch.utils.checkpoint``), the port of ``nn.remat(SubNet)`` and of
the reference's reversible recomputation: the same function and
gradients, with the activations of one column held at a time.

Convolutions take NCHW views of the NHWC activations. Under autograd on
the CPU the view is made contiguous first: this CPU build's convolution
backward corrupts memory on a channels-last view (see
:class:`~phnet_torch.models.encoder.Encoder`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.multihost import batch_rand
from .resnet import lecun_normal_

LN_EPS = 1e-6  # flax nn.LayerNorm default
ALPHA_MIN = 1e-3
LAYER_SCALE_INIT = 1e-6
ALPHA_INIT = 0.5


def column_seed(seed: int, column: int) -> int:
    """The drop-path seed of one column of a step seeded ``seed``."""
    return (seed * 1_000_033 + column) % 2 ** 63


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over NHWC ``x``, the result NHWC."""
    y = x.permute(0, 3, 1, 2)
    if y.device.type == "cpu" and torch.is_grad_enabled():
        y = y.contiguous()
    return conv(y).permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """flax's ``nn.LayerNorm`` over the last axis: the fast variance,
    epsilon 1e-6, in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


def drop_path(y: torch.Tensor, rate: float,
              gen: Optional[torch.Generator]) -> torch.Tensor:
    """``y`` with each image dropped at ``rate`` and the kept ones scaled
    by ``1 / (1 - rate)``; ``y`` itself without a generator."""
    if gen is None or rate <= 0.0:
        return y
    keep = 1.0 - rate
    mask = batch_rand((y.shape[0],) + (1,) * (y.ndim - 1), gen,
                      y.device) < keep
    return y * mask / keep


class ConvNeXtBlock(nn.Module):
    """depthwise 3x3 (with bias) -> LayerNorm -> Dense 4C -> GELU -> Dense
    C -> ``* gamma`` -> drop path, added to the input."""

    def __init__(self, dim: int, kernel_size: int = 3, expansion: int = 4,
                 drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.dwconv = nn.Conv2d(dim, dim, kernel_size,
                                padding=kernel_size // 2, groups=dim)
        self.norm = LayerNorm(dim)
        self.pw1 = nn.Linear(dim, dim * expansion)
        self.pw2 = nn.Linear(dim * expansion, dim)
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        y = self.norm(conv_nhwc(self.dwconv, x))
        y = self.pw2(F.gelu(self.pw1(y), approximate="tanh")) * self.gamma
        return x + drop_path(y, self.drop_path, gen)


class Fusion(nn.Module):
    """A level's input (``revcolV2.py:14-38``): the level below through a
    2x2/s2 conv and LayerNorm (level 0 takes the stem's output as it is);
    in a column after the first and below level 3, plus the level above
    (the previous column's) through a Dense, a nearest x2 resize and a
    LayerNorm."""

    def __init__(self, level: int, channels: Tuple[int, ...],
                 first_col: bool):
        super().__init__()
        self.level = level
        c = channels[level]
        if level > 0:
            self.down = nn.Conv2d(channels[level - 1], c, 2, stride=2)
            self.down_norm = LayerNorm(c)
        self.has_up = not first_col and level < 3
        if self.has_up:
            self.up_proj = nn.Linear(channels[level + 1], c)
            self.up_norm = LayerNorm(c)

    def forward(self, c_down: torch.Tensor,
                c_up: Optional[torch.Tensor]) -> torch.Tensor:
        down = c_down
        if self.level > 0:
            down = self.down_norm(conv_nhwc(self.down, c_down))
        if not self.has_up or c_up is None:
            return down
        up = self.up_proj(c_up)
        up = up.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return down + self.up_norm(up)


class LevelBlocks(nn.Module):
    def __init__(self, level: int, channels: Tuple[int, ...],
                 layers: Tuple[int, ...], kernel_size: int, first_col: bool,
                 drop_path: float):
        super().__init__()
        self.fusion = Fusion(level, channels, first_col)
        self.n_blocks = layers[level]
        for i in range(self.n_blocks):
            self.add_module(f"block{i}", ConvNeXtBlock(
                channels[level], kernel_size, drop_path=drop_path))

    def forward(self, c_down, c_up, gen=None):
        x = self.fusion(c_down, c_up)
        for i in range(self.n_blocks):
            x = getattr(self, f"block{i}")(x, gen)
        return x


class SubNet(nn.Module):
    """One column (``revcolV2.py:54-110``); ``alpha{i}`` clamped at use."""

    def __init__(self, channels: Tuple[int, ...], layers: Tuple[int, ...],
                 kernel_size: int, first_col: bool, drop_path: float):
        super().__init__()
        self.first_col = first_col
        for i in range(4):
            if not first_col:
                self.register_parameter(
                    f"alpha{i}", nn.Parameter(torch.empty(channels[i])))
            self.add_module(f"level{i}", LevelBlocks(
                i, channels, layers, kernel_size, first_col, drop_path))

    def alpha(self, i: int) -> torch.Tensor:
        a = getattr(self, f"alpha{i}")
        return torch.sign(a) * torch.clamp(a.abs(), min=ALPHA_MIN)

    def forward(self, x, c0, c1, c2, c3, seed: Optional[int] = None):
        """The four levels after this column; drop path where ``seed`` is
        given (its masks drawn from a generator seeded with it)."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        level = [getattr(self, f"level{i}") for i in range(4)]
        if self.first_col:
            c0 = level[0](x, None, gen)
            c1 = level[1](c0, None, gen)
            c2 = level[2](c1, None, gen)
            c3 = level[3](c2, None, gen)
        else:
            c0 = self.alpha(0) * c0 + level[0](x, c1, gen)
            c1 = self.alpha(1) * c1 + level[1](c0, c2, gen)
            c2 = self.alpha(2) * c2 + level[2](c1, c3, gen)
            c3 = self.alpha(3) * c3 + level[3](c2, None, gen)
        return c0, c1, c2, c3


class RevColBackbone(nn.Module):
    """revcol_tiny by default (``revcolV2.py:203-208``). Input NHWC frames,
    output the last column's four levels, NHWC."""

    def __init__(self, channels: Tuple[int, ...] = (64, 128, 256, 512),
                 layers: Tuple[int, ...] = (2, 2, 4, 2),
                 num_subnet: int = 4, kernel_size: int = 3,
                 drop_path: float = 0.1, save_memory: bool = True):
        super().__init__()
        self.num_subnet = num_subnet
        self.drop_path = drop_path
        self.save_memory = save_memory
        self.stem_conv = nn.Conv2d(3, channels[0], 4, stride=4)
        self.stem_norm = LayerNorm(channels[0])
        for i in range(num_subnet):
            self.add_module(f"subnet{i}", SubNet(
                channels, layers, kernel_size, first_col=i == 0,
                drop_path=drop_path))

    def reset_parameters(self, g: torch.Generator):
        """The JAX package's init: kernels from N(0, 1/fan_in), biases 0,
        LayerNorms the identity, ``gamma`` 1e-6, ``alpha`` 0.5."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight.data, m.weight[0].numel(), g)
                m.bias.data.zero_()
            elif isinstance(m, LayerNorm):
                m.reset_parameters()
            elif isinstance(m, ConvNeXtBlock):
                m.gamma.data.fill_(LAYER_SCALE_INIT)
        for name, p in self.named_parameters():
            if name.split(".")[-1].startswith("alpha"):
                p.data.fill_(ALPHA_INIT)

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> Sequence[torch.Tensor]:
        """x [N, H, W, 3] -> four levels [N, h, w, C]. ``seed`` turns drop
        path on (in train mode only)."""
        x = self.stem_norm(conv_nhwc(self.stem_conv, x))
        if not (self.training and self.drop_path > 0.0):
            seed = None
        remat = (self.save_memory and self.training
                 and torch.is_grad_enabled())
        c = (None,) * 4
        for i in range(self.num_subnet):
            subnet = getattr(self, f"subnet{i}")
            s = None if seed is None else column_seed(seed, i)
            if remat and i > 0:
                c = checkpoint(subnet, x, *c, s, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                c = subnet(x, *c, s)
        return tuple(c)

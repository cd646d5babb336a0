"""Tensor-sharded layers over the mesh's ``model`` axis: the port of the
JAX package's ``shard_params`` placement as GSPMD runs it
(``phnet_tpu/parallel/mesh.py``, ``phnet_tpu/train/trainer.py``).

:func:`shard_module` keeps, on each rank of a model group, its block of
every kernel that :func:`.mesh.shard_params` splits, cut in place from the
whole tensor (rank 0's, after the broadcast), and records the cut as the
parameter's :class:`Placement`. The layers that own such a kernel compute
with their block:

* **output dimension** (a Linear's rows, a conv's output channels; the
  flax kernel's last dimension, every preset's case): the rank computes
  its block of the output, the blocks are all-gathered over the model
  group in rank order, then the whole bias is added. The backward takes
  the rank's own block of the incoming gradient (everything after the
  join is replicated) and sums the input's gradient over the model group
  (each rank's holds its block's share);
* **first dimension** (a contraction split: a Linear's input columns, a
  conv's kernel rows): the rank multiplies its block of the input by its
  block of the kernel and the partial products are summed over the model
  group, then the bias is added. Within rounding of the whole product,
  not bit-equal to it.

A Linear, Conv1d or Conv2d with a sharded weight gets a subclass whose
``forward`` is :func:`linear` or :func:`conv` (``phnet_torch.models.mixed.
dense`` and the DynamicConv generators' combine take the same paths:
:class:`Chain`). A sharded parameter of another kind stays whole on every
rank, and :func:`shard_module` lists it: the router's packed K2 inputs
(``taps``, ``conv_bias``, ``ln_params``) and the merged branch heads'
batched kernels (``fc{i}_kernel``, ``out{i}_kernel``), which the JAX rule
splits only below its default ``min_size``; a placement changes no
arithmetic there.

The collectives run on the process group's backend: all-gather and
all-reduce, which gloo runs on CUDA tensors too (two ranks on one card,
which NCCL refuses).

Checkpoints and the optimizer's ``state_dict`` hold whole tensors:
:func:`full_state_dict` gathers the sharded parameters, and
:func:`load_full_state_dict` cuts whole tensors to the rank's blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from . import multihost
from .mesh import Mesh, shard_params

ATTR = "tp_placement"


@dataclasses.dataclass(frozen=True)
class Placement:
    """A parameter cut over the model axis: torch dimension ``dim`` split
    into ``size`` blocks, this rank's is block ``index``;
    ``full_shape`` is the whole tensor's."""

    dim: int
    size: int
    index: int
    full_shape: Tuple[int, ...]

    @property
    def block(self) -> int:
        return self.full_shape[self.dim] // self.size

    @property
    def start(self) -> int:
        return self.index * self.block

    def cut(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``whole`` (a copy)."""
        return whole.narrow(self.dim, self.start, self.block).clone()


def placement(t) -> Optional[Placement]:
    """The placement of a parameter (None: whole on every rank)."""
    return getattr(t, ATTR, None)


def is_sharded(module: nn.Module) -> bool:
    """``module``'s weight is cut over the model axis."""
    return placement(getattr(module, "weight", None)) is not None


# -- collectives over the model axis -------------------------------------------

def all_gather(x: torch.Tensor, dim: int, axis: str = "model"
               ) -> torch.Tensor:
    """The blocks ``x`` of the ranks of ``axis``'s group joined along
    ``dim`` in their order there."""
    size = multihost.axis_size(axis)
    if size == 1:
        return x
    x = x.contiguous()
    blocks = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(blocks, x, group=multihost.axis_group(axis))
    return torch.cat(blocks, dim)


def _sum_over_model(x: torch.Tensor) -> torch.Tensor:
    buf = x.contiguous().clone()
    dist.all_reduce(buf, group=multihost.axis_group("model"))
    return buf


class _Gather(torch.autograd.Function):
    """Forward: the model group's blocks joined along ``dim``. Backward:
    this rank's block of the (replicated) incoming gradient."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim % x.ndim
        return all_gather(x, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // multihost.model_size()
        return g.narrow(ctx.dim, multihost.model_index() * n,
                        n).contiguous(), None


class _CopyIn(torch.autograd.Function):
    """A replicated tensor entering a sharded product. Forward: itself.
    Backward: the ranks' gradients (each its block's share) summed over
    the model group."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_model(g)


class _ReduceOut(torch.autograd.Function):
    """Partial products summed over the model group. Backward: the
    (replicated) incoming gradient itself."""

    @staticmethod
    def forward(ctx, x):
        return _sum_over_model(x)

    @staticmethod
    def backward(ctx, g):
        return g


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _Gather.apply(x, dim)


def copy_in(x: torch.Tensor) -> torch.Tensor:
    return _CopyIn.apply(x)


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    return _ReduceOut.apply(x)


def whole(p: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a parameter (gathered under autograd where it
    is sharded), for a replicated computation."""
    pl = placement(p)
    return p if pl is None else gather(p, pl.dim)


# -- the layers -----------------------------------------------------------------

def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], pl: Optional[Placement]
           ) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` with ``weight`` [out, in] this rank's
    block of the whole kernel at ``pl`` (None: the whole kernel)."""
    if pl is None:
        return F.linear(x, weight, bias)
    if pl.dim == 0:
        y = gather(F.linear(copy_in(x), weight), -1)
    else:
        y = reduce_out(F.linear(copy_in(x).narrow(-1, pl.start, pl.block),
                                weight))
    return y if bias is None else y + bias


def _tuple(v, nd: int) -> Tuple[int, ...]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * nd


def conv(x: torch.Tensor, weight: torch.Tensor,
         bias: Optional[torch.Tensor], pl: Optional[Placement], stride=1,
         padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """A 1-D or 2-D convolution (by ``weight``'s rank) with ``weight``
    [out, in / groups, k...] this rank's block at ``pl``: its output
    channels (dim 0) or its kernel rows (dim 2, the first spatial axis;
    zero padding)."""
    nd = weight.ndim - 2
    fn = F.conv1d if nd == 1 else F.conv2d
    stride, padding, dilation = (_tuple(v, nd) for v in (stride, padding,
                                                         dilation))
    if pl is None:
        return fn(x, weight, bias, stride, padding, dilation, groups)
    xin = copy_in(x)
    if pl.dim == 0:
        if groups > 1:  # the output block's groups read their own inputs
            per_group = pl.full_shape[0] // groups
            cin = weight.shape[1] * (pl.block // per_group)
            xin = xin.narrow(1, pl.index * cin, cin)
            groups = pl.block // per_group
        y = gather(fn(xin, weight, None, stride, padding, dilation, groups),
                   1)
    elif pl.dim == 2:
        k, d0, p0 = weight.shape[2], dilation[0], padding[0]
        full_k = pl.full_shape[2]
        n_out = (x.shape[2] + 2 * p0 - d0 * (full_k - 1) - 1) // stride[0] + 1
        pad = [0, 0] * (nd - 1) + [p0, p0]
        xp = F.pad(xin, pad)
        offset = pl.index * k * d0  # the block's first kernel row
        part = fn(xp.narrow(2, offset, xp.shape[2] - offset), weight, None,
                  stride, (0,) + padding[1:], dilation, groups)
        y = reduce_out(part.narrow(2, 0, n_out))
    else:
        raise NotImplementedError(f"a conv kernel split on dim {pl.dim}")
    if bias is not None:
        y = y + bias.reshape((1, -1) + (1,) * nd)
    return y


class _ShardedLayer:
    """The forward of a Linear, Conv1d or Conv2d whose weight is sharded:
    :func:`linear` / :func:`conv`, in the input's dtype (a bf16 input
    takes the weight and the bias rounded to bf16, as the model's own
    layers do)."""

    def forward(self, x):
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:
            w = w.to(x.dtype)
            b = None if b is None else b.to(x.dtype)
        pl = placement(self.weight)
        if isinstance(self, nn.Linear):
            return linear(x, w, b, pl)
        return conv(x, w, b, pl, self.stride, self.padding, self.dilation,
                    self.groups)


_CLASSES: Dict[type, type] = {}


def _sharded_class(cls: type) -> type:
    if cls not in _CLASSES:
        _CLASSES[cls] = type(f"Sharded{cls.__name__}", (_ShardedLayer, cls),
                             {"__module__": __name__})
    return _CLASSES[cls]


class Chain:
    """One DynamicConv generator chain, two stacked Linears ``la``, ``lb``
    of which one or both are sharded, as a callable ``x -> y`` in the
    compute dtype ``dtype`` (None: float32): factored, the two sharded
    layers in turn; collapsed, the combined kernel ``K = ka @ kb`` and
    bias ``ba @ kb + bb`` (computed in float32, then cast) as one layer
    that keeps ``lb``'s output split (K's columns), else ``la``'s input
    split (K's rows), else is whole (a split factor gathered first)."""

    def __init__(self, la: nn.Linear, lb: nn.Linear, collapse: bool,
                 dtype: Optional[torch.dtype]):
        pa, pb = placement(la.weight), placement(lb.weight)
        cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
        if not collapse:
            self.layers = [(cast(la.weight), cast(la.bias), pa),
                           (cast(lb.weight), cast(lb.bias), pb)]
            return
        if pb is not None and pb.dim == 0:  # K's columns
            ka = whole(la.weight).t()
            kb = lb.weight.t()
            k = copy_in(ka) @ kb
            b = gather(copy_in(la.bias) @ kb, 0) + lb.bias
            pk = dataclasses.replace(pb, full_shape=(pb.full_shape[0],
                                                     ka.shape[0]))
        elif pa is not None and pa.dim == 1:  # K's rows
            ka = la.weight.t()
            kb = whole(lb.weight).t()
            k = ka @ copy_in(kb)
            b = la.bias @ kb + lb.bias
            pk = dataclasses.replace(pa, full_shape=(kb.shape[1],
                                                     pa.full_shape[1]))
        else:
            kb = whole(lb.weight).t()
            k = whole(la.weight).t() @ kb
            b = la.bias @ kb + lb.bias
            pk = None
        self.layers = [(cast(k.t()), cast(b), pk)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        for w, b, pl in self.layers:
            x = linear(x, w, b, pl)
        return x


# -- placing a model ---------------------------------------------------------------

def _check_conv(name: str, mod: nn.Module):
    if isinstance(mod, (nn.Conv1d, nn.Conv2d)) and (
            mod.padding_mode != "zeros" or isinstance(mod.padding, str)):
        raise NotImplementedError(f"{name}: a sharded conv needs integer "
                                  f"zero padding")


@torch.no_grad()
def shard_module(model: nn.Module, mesh: Mesh,
                 min_size: Optional[int] = None) -> List[str]:
    """Cut every parameter that :func:`.mesh.shard_params` splits to this
    rank's block, in place (the Parameter objects stay: an optimizer built
    on them keeps them), and give its layer the sharded forward. The group
    must be laid out as ``mesh`` (:func:`.multihost.init_axes`). Returns
    the names of the parameters that the rule splits and the port holds
    whole (see the module's docstring)."""
    m = mesh.shape.get("model", 1)
    if m == 1:
        return []
    if multihost.model_size() != m:
        raise RuntimeError(f"shard_module: the group's model axis has "
                           f"{multihost.model_size()} ranks, the mesh's "
                           f"{m} (call multihost.init_axes(mesh) first)")
    owners = dict(model.named_modules())
    held = []
    for name, dim in shard_params(model, mesh, min_size).items():
        if dim is None:
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = owners[mod_name]
        p = getattr(mod, leaf)
        if placement(p) is not None:
            continue
        if leaf != "weight" or not isinstance(
                mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            held.append(name)
            continue
        _check_conv(name, mod)
        pl = Placement(dim, m, multihost.model_index(), tuple(p.shape))
        p.data = pl.cut(p.data)
        setattr(p, ATTR, pl)
        mod.__class__ = _sharded_class(type(mod))
    return held


def sharded_names(model: nn.Module) -> List[str]:
    """The parameters of ``model`` cut over the model axis."""
    return [n for n, p in model.named_parameters()
            if placement(p) is not None]


@torch.no_grad()
def gather_like(t: torch.Tensor, pl: Optional[Placement]) -> torch.Tensor:
    """A block of a sharded parameter's shape (its gradient, an optimizer
    moment) gathered whole; anything else as it is."""
    if pl is None or not torch.is_tensor(t) or t.ndim != len(pl.full_shape) \
            or t.shape[pl.dim] != pl.block:
        return t
    return all_gather(t.detach(), pl.dim)


def cut_like(t: torch.Tensor, pl: Optional[Placement]) -> torch.Tensor:
    """A whole tensor of a sharded parameter's shape cut to this rank's
    block; anything else as it is."""
    if pl is None or not torch.is_tensor(t) or tuple(t.shape) != \
            pl.full_shape:
        return t
    return pl.cut(t)


@torch.no_grad()
def cut_optimizer_state(opt: torch.optim.Optimizer):
    """A torch optimizer's per-parameter state restored whole (before
    :func:`shard_module` cut its parameters) cut to the blocks."""
    for p, st in opt.state.items():
        for k, v in st.items():
            st[k] = cut_like(v, placement(p))


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded parameter gathered whole
    (a collective: every rank of the group calls it)."""
    return {k: gather_like(v.detach(), placement(v))
            for k, v in model.state_dict(keep_vars=True).items()}


def load_full_state_dict(model: nn.Module,
                         state: Mapping[str, torch.Tensor]):
    """Load whole tensors into ``model``, each sharded parameter taking
    its block."""
    live = model.state_dict(keep_vars=True)
    model.load_state_dict({k: cut_like(v, placement(live.get(k)))
                           for k, v in state.items()})

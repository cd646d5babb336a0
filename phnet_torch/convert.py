"""Parameter bridge: a flax ``variables`` tree of the JAX package's PHNet
to the port's ``state_dict``.

The tree is nested dicts of numpy arrays (``{"params": ...,
"batch_stats": ...}``). Module paths are renamed to the port's
(``BasicBlock_3`` and ``Bottleneck_3`` -> ``blocks.3``,
``Norm_1/BatchNorm_0`` and ``Norm_1/GroupNorm_0`` -> ``bn1``, the
``i``-th norm of a block whichever its kind, ``dyn_head_0`` ->
``dyn_heads.0``, ``layer1`` -> ``layers.1``, the prior-propagation head's
``mlp_router_0`` -> ``mlp_routers.0`` ...; RevCol's modules, the
prior-propagation head's "_last" stacks and decoder keep their names)
and leaves are laid out for PyTorch:

* Dense / linear ``kernel [in, out]`` -> ``weight [out, in]`` (this covers
  the DynamicConv ``gen1_a .. out_b`` pairs, the router's ``Dense_0/1`` and
  the fused ``qkv`` / ``q`` + ``kv`` attention projections, whose packed
  output order the port keeps, and the MLP routers' ``fc0`` / ``fc1`` /
  ``out``);
* conv ``kernel`` HWIO -> ``weight`` OIHW (RevCol's depthwise ``dwconv``
  ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]``), and a 1-D conv's (the
  multi-scale router's ``conv1`` / ``conv2``) ``[k, in, out]`` -> ``[out,
  in, k]``;
* BatchNorm, LayerNorm and GroupNorm ``scale`` -> ``weight``; BatchNorm
  ``mean`` and ``var`` stay buffers of those names;
* everything else keeps its layout: the merged branch heads'
  ``fc{i}_kernel [n, din, h]`` / ``out{i}_kernel [h, d_o]``, the router's
  ``taps``, ``conv_bias`` and ``ln_params``, ``prior_embeddings``,
  ``pro_embedding`` and the learned ``pos_encoding/embedding``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

_PATH_RULES = [
    (r"^(params|batch_stats)/encoder/", "encoder/"),
    (r"^params/frame/head/", "head/"),
    (r"(?:BasicBlock|Bottleneck)_(\d+)", r"blocks/\1"),
    (r"Norm_(\d+)/(?:BatchNorm|GroupNorm)_0", r"bn\1"),
    (r"Conv_(\d+)", r"conv\1"),
    (r"lateral_(\d+)", r"lateral/\1"),
    (r"fpn_(\d+)", r"fpn/\1"),
    (r"upsample_(\d+)", r"upsample/\1"),
    (r"dyn_head_(\d+)", r"dyn_heads/\1"),
    (r"router_(\d+)", r"routers/\1"),
    (r"Dense_(\d+)", r"dense\1"),
    (r"/layer(\d+)/", r"/layers/\1/"),
]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def torch_key(path: Tuple[str, ...], ndim: int) -> Tuple[str, str]:
    """(state_dict key, layout change) of one flax leaf. The change is
    "linear" ([in, out] -> [out, in]), "conv1d" ([k, in, out] -> [out, in,
    k]), "conv" (HWIO -> OIHW) or ""."""
    joined = "/".join(path)
    for pattern, repl in _PATH_RULES:
        joined = re.sub(pattern, repl, joined)
    *mod, leaf = joined.split("/")
    change = ""
    if leaf == "kernel":
        leaf, change = "weight", {2: "linear", 3: "conv1d", 4: "conv"}[ndim]
    elif leaf == "scale":
        leaf = "weight"
    return ".".join(mod + [leaf]), change


# torch dim i of a kernel is flax dim LAYOUTS[change][i]
LAYOUTS = {"linear": (1, 0), "conv1d": (2, 1, 0), "conv": (3, 2, 0, 1)}


def _relayout(x: np.ndarray, change: str) -> np.ndarray:
    return x.transpose(LAYOUTS[change]) if change else x


def flax_shape(shape: Sequence[int], change: str) -> Tuple[int, ...]:
    """The flax leaf's shape of a port tensor of ``shape``."""
    out = list(shape)
    for i, f in enumerate(LAYOUTS.get(change, ())):
        out[f] = shape[i]
    return tuple(out)


def module_layout(module: nn.Module, leaf: str) -> str:
    """The layout change of ``module``'s tensor ``leaf`` (:func:`torch_key`'s,
    from the port's side): "linear", "conv1d", "conv" for the weight of a
    Linear, Conv1d or Conv2d, "" for anything else."""
    if leaf != "weight":
        return ""
    for cls, change in ((nn.Linear, "linear"), (nn.Conv1d, "conv1d"),
                        (nn.Conv2d, "conv")):
        if isinstance(module, cls):
            return change
    return ""


def plan(shapes: Mapping) -> Dict[str, Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """For a tree of leaves with a ``.shape`` (arrays or
    ``jax.ShapeDtypeStruct``s): ``{state_dict key: (flax path, torch
    shape)}``. Raises if two leaves map to one key."""
    out = {}
    for path, leaf in _flatten(shapes):
        shape = tuple(leaf.shape)
        key, change = torch_key(path, len(shape))
        if key in out:
            raise ValueError(f"{'/'.join(path)} and "
                             f"{'/'.join(out[key][0])} both map to {key}")
        if change:
            shape = tuple(shape[f] for f in LAYOUTS[change])
        out[key] = (path, shape)
    return out


def convert_module(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``variables`` of a module that stands alone (``SegDecoder``,
    ``WarpModel``: every leaf under ``params``) -> its ``state_dict``:
    ``conv/kernel`` HWIO -> ``conv.weight`` OIHW, ``conv/bias``, and
    ``bn/{weight,bias,running_mean,running_var}`` as they are (no path
    rule touches their names)."""
    return convert(variables["params"])


def convert(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``variables`` (nested dicts of numpy arrays) -> the port's
    ``state_dict`` (float32 CPU tensors)."""
    sd = {}
    for path, leaf in _flatten(variables):
        x = np.asarray(leaf)
        key, change = torch_key(path, x.ndim)
        if key in sd:
            raise ValueError(f"two leaves map to {key}")
        sd[key] = torch.from_numpy(
            np.ascontiguousarray(_relayout(x, change), dtype=np.float32))
    return sd

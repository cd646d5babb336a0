"""Load the reference implementation's PyTorch checkpoints into the port.

Counterpart of ``phnet_tpu/utils/torch_import.py``, straight into the
port's ``state_dict`` (no flax tree in between):

* :func:`import_reference_checkpoint`: a ``RouterWithB``
  (``RouterV4.py:466``) checkpoint of the reference's trainers (the
  ``trainVIL.py`` save schema, DDP's ``module.`` prefix and the
  ``{'state_dict': ...}`` wrapper included), VIL-100's head (``RouterV2``:
  cls and reg stacks) and OpenLane-V's (``DetNetV2``: a third, offsets
  stack from ``iou_modules`` / ``iou_layers``, learned positions);
* :func:`load_pretrained_backbone`: torchvision-named ResNet weights (the
  reference's backbone initialization, ``libs/models/resnet.py:310-317``)
  into the backbone.

The port's layouts are PyTorch's, so convolution and linear weights are
taken as they are; what the port packs differently is repacked as the JAX
importer does: the branch heads' stacked ``fc{i}_kernel [n, in, out]``
and ``out{i}_kernel [in, out]``, the routers' ``taps``, ``conv_bias`` and
``ln_params``, the attention's fused ``qkv`` and split ``q`` / ``kv``.
Both functions are strict: every key of the target is filled, from a
checkpoint key of the same shape, or they raise (``KeyError`` for a key
the checkpoint lacks, ``ValueError`` for a shape). Checkpoint keys the
model has no use for are ignored, as the JAX importer ignores them.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from ..models.resnet import STAGE_BLOCKS


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def strip_prefixes(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """Unwrap ``{'state_dict': ...}`` checkpoints and drop DDP's
    ``module.``; values as numpy arrays."""
    sd = state_dict.get("state_dict", state_dict)
    return {k[len("module."):] if k.startswith("module.") else k: _numpy(v)
            for k, v in sd.items()}


class _Source:
    """A checkpoint's arrays under a key prefix; a missing key raises
    ``KeyError`` naming the full key."""

    def __init__(self, sd: Mapping[str, np.ndarray], prefix: str = ""):
        self.sd, self.prefix = sd, prefix

    def __call__(self, key: str) -> np.ndarray:
        full = self.prefix + key
        if full not in self.sd:
            raise KeyError(f"the checkpoint has no {full!r}")
        return self.sd[full]

    def any(self, start: str) -> bool:
        return any(k.startswith(self.prefix + start) for k in self.sd)


def _indices(target: Mapping, pattern: str):
    """Sorted integers ``i`` of the target keys matching ``pattern``
    (a regex with one group)."""
    rx = re.compile(pattern)
    return sorted({int(m.group(1)) for k in target
                   for m in [rx.match(k)] if m})


def _backbone(src: _Source, prefix: str, target: Mapping
              ) -> Dict[str, np.ndarray]:
    """torchvision ResNet names -> ``<prefix>conv0 / bn0 / blocks.i``, the
    blocks numbered in order over ``layer1 .. layer4`` of the target's
    depth (its block count: 8 for ResNet-18, 16 for ResNet-34). A
    Bottleneck or RevCol target raises ValueError: the JAX package's
    importer reads BasicBlocks only."""
    if prefix + "conv0.weight" not in target:
        raise ValueError("the target's backbone is no ResNet (RevCol?): "
                         "the importer reads BasicBlock ResNets only")
    if _indices(target, "^" + re.escape(prefix) + r"blocks\.(\d+)\.conv3\."):
        raise ValueError("the target's backbone is a Bottleneck ResNet: "
                         "the importer reads BasicBlock ResNets (18, 34) "
                         "only")
    n_blocks = len(_indices(target, "^" + re.escape(prefix)
                            + r"blocks\.(\d+)\."))
    stages = {sum(v): v for d, v in STAGE_BLOCKS.items()
              if d < 50}.get(n_blocks)
    if stages is None:
        raise ValueError(f"a backbone of {n_blocks} blocks is no ResNet-18 "
                         f"or -34")
    out = {prefix + "conv0.weight": src("conv1.weight")}

    def norm(ours: str, theirs: str):
        for o, t in (("weight", "weight"), ("bias", "bias"),
                     ("mean", "running_mean"), ("var", "running_var")):
            out[f"{prefix}{ours}.{o}"] = src(f"{theirs}.{t}")

    norm("bn0", "bn1")
    idx = 0
    for stage, count in enumerate(stages):
        for b in range(count):
            t, o = f"layer{stage + 1}.{b}", f"blocks.{idx}"
            out[f"{prefix}{o}.conv0.weight"] = src(t + ".conv1.weight")
            out[f"{prefix}{o}.conv1.weight"] = src(t + ".conv2.weight")
            norm(o + ".bn0", t + ".bn1")
            norm(o + ".bn1", t + ".bn2")
            if f"{prefix}{o}.conv2.weight" in target:  # the downsample
                out[f"{prefix}{o}.conv2.weight"] = src(
                    t + ".downsample.0.weight")
                norm(o + ".bn2", t + ".downsample.1")
            idx += 1
    return out


def _neck(src: _Source, levels) -> Dict[str, np.ndarray]:
    out = {}
    for i in levels:
        for ours, theirs in (("lateral", "lateral_convs"),
                             ("fpn", "fpn_convs")):
            for leaf in ("weight", "bias"):
                out[f"encoder.neck.{ours}.{i}.{leaf}"] = src(
                    f"{theirs}.{i}.conv.{leaf}")
    return out


def _linear(out: Dict, ours: str, src: _Source, theirs: str):
    out[ours + ".weight"] = src(theirs + ".weight")
    out[ours + ".bias"] = src(theirs + ".bias")


def _head(src: _Source, target: Mapping) -> Dict[str, np.ndarray]:
    """Reference head keys -> ``head.*`` (``RouterV2`` and ``DetNetV2``)."""
    out = {"head.prior_embeddings": src("prior_embeddings.weight"),
           "head.pro_embedding": src("pro_embedding.weight")}
    if "head.pos_encoding.embedding" in target:
        out["head.pos_encoding.embedding"] = src(
            "PositionEmbedding.embed.weight")

    # merged branch heads: stack order (cls, reg[, iou])
    stacks = ("cls", "reg", "iou") if src.any("iou_modules.") else (
        "cls", "reg")
    for branch, suffix in (("heads_fir", ""), ("heads_sec", "_sec")):
        pre = f"head.{branch}."
        for i in range(2):
            out[pre + f"fc{i}_kernel"] = np.stack([
                src(f"{m}_modules{suffix}.{2 * i}.weight").T for m in stacks])
            out[pre + f"fc{i}_bias"] = np.stack([
                src(f"{m}_modules{suffix}.{2 * i}.bias") for m in stacks])
        for j, m in enumerate(stacks):
            out[pre + f"out{j}_kernel"] = src(f"{m}_layers{suffix}.weight").T
            out[pre + f"out{j}_bias"] = src(f"{m}_layers{suffix}.bias")

    for s in _indices(target, r"^head\.dyn_heads\.(\d+)\."):
        ours, theirs = f"head.dyn_heads.{s}.", f"DHead_series.{s}."
        for o, t in (("gen1_a", "dynamic_layer_1.0"),
                     ("gen1_b", "dynamic_layer_1.1"),
                     ("gen2_a", "dynamic_layer_2.0"),
                     ("gen2_b", "dynamic_layer_2.1"),
                     ("out_a", "out_layer.0"), ("out_b", "out_layer.1"),
                     ("norm1", "norm1"), ("norm2", "norm2"),
                     ("norm3", "norm3")):
            _linear(out, ours + o, src, theirs + t)

    # routers: the taps / conv_bias / ln_params packing of models/router.py
    for s in _indices(target, r"^head\.routers\.(\d+)\."):
        pre = f"head.routers.{s}."
        a, width = target[pre + "taps"].shape
        blocks = width // 18
        taps = np.zeros((a, width), np.float32)
        cbias = np.zeros((a, 2 * blocks), np.float32)
        lnp = [src(f"router.pre_norm.{s}.weight"),
               src(f"router.pre_norm.{s}.bias")]
        for b in range(blocks):
            base = f"router.DWNets.{s}.{b}"
            taps[:, 18 * b: 18 * b + 9] = src(f"{base}.0.weight").reshape(a, 9)
            cbias[:, 2 * b] = src(f"{base}.0.bias")
            taps[:, 18 * b + 9: 18 * b + 18] = src(
                f"{base}.3.weight").reshape(a, 9)
            cbias[:, 2 * b + 1] = src(f"{base}.3.bias")
            lnp += [src(f"{base}.1.weight"), src(f"{base}.1.bias"),
                    src(f"{base}.4.weight"), src(f"{base}.4.bias")]
        out[pre + "taps"] = taps
        out[pre + "conv_bias"] = cbias
        out[pre + "ln_params"] = np.stack(lnp)
        _linear(out, pre + "dense0", src, f"router.layers.{s}.0")
        _linear(out, pre + "dense1", src, f"router.layers.{s}.2")

    # temporal decoder: the packed in_proj -> fused qkv, split q / kv
    td = "head.temporal_decoder."
    _linear(out, td + "final_norm", src, "transformer_Dec.norm")
    for i in _indices(target, r"^head\.temporal_decoder\.layers\.(\d+)\."):
        pre, theirs = f"{td}layers.{i}.", f"transformer_Dec.layers.{i}."
        out[pre + "self_attn.qkv.weight"] = src(
            theirs + "self_attn.in_proj_weight")
        out[pre + "self_attn.qkv.bias"] = src(
            theirs + "self_attn.in_proj_bias")
        _linear(out, pre + "self_attn.out", src, theirs + "self_attn.out_proj")
        w_in = src(theirs + "multihead_attn.in_proj_weight")
        b_in = src(theirs + "multihead_attn.in_proj_bias")
        d = w_in.shape[1]
        out[pre + "cross_attn.q.weight"] = w_in[:d]
        out[pre + "cross_attn.q.bias"] = b_in[:d]
        out[pre + "cross_attn.kv.weight"] = w_in[d:]
        out[pre + "cross_attn.kv.bias"] = b_in[d:]
        _linear(out, pre + "cross_attn.out", src,
                theirs + "multihead_attn.out_proj")
        _linear(out, pre + "ffn1", src, theirs + "linear1")
        _linear(out, pre + "ffn2", src, theirs + "linear2")
        for n in ("norm1", "norm2", "norm3"):
            _linear(out, pre + n, src, theirs + n)
    return out


def _checked(arrays: Mapping[str, np.ndarray],
             target: Mapping[str, torch.Tensor], keys) -> Dict[str,
                                                              torch.Tensor]:
    """``arrays`` as float32 tensors, each of its target key's shape, and
    covering ``keys``; else ``KeyError`` / ``ValueError``."""
    unknown = sorted(set(arrays) - set(target))
    if unknown:
        raise KeyError(f"the model has no {unknown[:5]}")
    missing = sorted(set(keys) - set(arrays))
    if missing:
        raise KeyError(f"the checkpoint fills no {missing[:5]} "
                       f"({len(missing)} keys)")
    out = {}
    for k, v in arrays.items():
        want = tuple(target[k].shape)
        if tuple(v.shape) != want:
            raise ValueError(f"{k}: the checkpoint's shape {tuple(v.shape)},"
                             f" the model's {want}")
        out[k] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return out


def import_reference_checkpoint(
        state_dict: Mapping, target: Mapping[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """A reference ``RouterWithB`` checkpoint (``torch.load``'s dict,
    tensors or arrays) -> the port's ``state_dict`` for the model whose
    ``state_dict()`` is ``target`` (shapes are read from it): float32 CPU
    tensors, every key of ``target`` filled."""
    sd = strip_prefixes(state_dict)
    arrays = _backbone(_Source(sd, "backbone.backbone.model."),
                       "encoder.backbone.", target)
    arrays.update(_neck(_Source(sd, "backbone.neck."),
                        _indices(target, r"^encoder\.neck\.lateral\.(\d+)\.")))
    arrays.update(_head(_Source(sd, "detNet."), target))
    return _checked(arrays, target, target.keys())


def load_pretrained_backbone(target: Mapping[str, torch.Tensor],
                             resnet_state_dict: Mapping
                             ) -> Dict[str, torch.Tensor]:
    """``target`` (a port ``state_dict``) with its backbone replaced by
    torchvision-named ResNet weights; every backbone key filled."""
    arrays = _backbone(_Source(strip_prefixes(resnet_state_dict)),
                       "encoder.backbone.", target)
    backbone = [k for k in target if k.startswith("encoder.backbone.")]
    out = dict(target)
    out.update(_checked(arrays, target, backbone))
    return out

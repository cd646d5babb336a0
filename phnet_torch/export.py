"""Deployment artifacts: the serving tick as a ``torch.export`` program.

Port of ``phnet_tpu/export.py``. A served model ships as a directory that
a serving host runs without the model-building Python (``PHNet``, its
heads, the weight init):

    <dir>/
      step.pt2        the exported tick (``torch.export.save``): the
                      graph, the weights and the collapsed DynamicConv
                      weights it reads
      params.npz      the state dict the artifact was made from
      memory.npz      the initial memory leaves (``t`` as int32)
      manifest.json   shapes, lane-spec decode constants, device, versions

:func:`export_serving_step` traces one batched tick, ``(frames [batch, 1,
H, W, 3], *memory leaves) -> (kept, valid, num_kept, *new memory
leaves)``, the memory carried by the caller as
:class:`~phnet_torch.serving.StreamingServer` carries it (the ring's
``values, mask, t`` or the one-frame carry's ``feat, priors, mask, t``;
``t`` a 0-d int32 tensor, so the ring's write position is part of the
program). Lane NMS, the router chain and the w8 products are the
operators ``phnet::nms_keeps``, ``phnet::router_chain`` and
``phnet::w8_matmul`` (``phnet_torch.ops``) in the graph: on the card
each launches its CUDA kernel inside the loaded program and counts its
launches as the live path does.

:class:`DeployedServer` ticks from the directory. It imports
``phnet_torch.ops`` (to register the operators), ``phnet_torch.geometry``
and ``phnet_torch.config`` (to decode), never ``phnet_torch.models``.

The program holds one device's branch of every wrapper (the kernel on the
card, the plain version on the CPU): an artifact runs on the device type
it was exported on, and loading one from the card where there is none
raises. The program does not record the TF32 flags either: the tick runs
inside :func:`~phnet_torch.device.full_f32`, as the live model does.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from . import ops  # noqa: F401  (registers the phnet:: operators)
from .config import LaneSpec, ModelConfig
from .device import full_f32, resolve_device
from .geometry import decode_kept_rows

_MANIFEST = "manifest.json"
_STEP = "step.pt2"
_PARAMS = "params.npz"
_MEMORY = "memory.npz"


class _ServingStep(torch.nn.Module):
    """The tick as a module: the encoder over one frame a stream, then the
    model's ``frame_step`` on the collapsed DynamicConv weights, held as
    buffers (``dyn_<i>``, the leaves of ``combine_dynamic()``'s tree)."""

    def __init__(self, model, dyn_combined, mem_cls):
        super().__init__()
        self.model = model
        self.mem_cls = mem_cls
        leaves, self.dyn_spec = pytree.tree_flatten(dyn_combined)
        self.n_dyn = len(leaves)
        for i, leaf in enumerate(leaves):
            self.register_buffer(f"dyn_{i}", leaf.detach().clone())

    def forward(self, frames, *mem_leaves):
        dyn = pytree.tree_unflatten(
            [getattr(self, f"dyn_{i}") for i in range(self.n_dyn)],
            self.dyn_spec)
        feats = self.model.encode(frames)
        out, mem, _ = self.model.frame_step(tuple(f[0] for f in feats),
                                            self.mem_cls(*mem_leaves), dyn)
        return (out.kept, out.kept_valid, out.num_kept, *mem)


def export_serving_step(cfg: ModelConfig, state_dict: Dict[str, torch.Tensor],
                        out_dir: str, batch: int = 1,
                        memory_window: Optional[int] = None,
                        device=None) -> str:
    """Export the batched streaming tick of ``cfg`` with the weights
    ``state_dict`` (the port's) to ``out_dir`` and return it.

    ``device=None`` exports for the card; the artifact runs on the device
    type it was exported on. The ring holds ``memory_window`` frames, by
    default the config's window, or the live server's ``DEFAULT_WINDOW``
    (64) where that is unbounded. The router chain's mode is the config's
    (``router_chain_bf16=None`` is the float32 chain, as in the JAX
    export; the live server resolves None from its stream count instead).
    The tick is traced in eval mode with autograd off."""
    from .models.phnet import PHNet, init_memory
    from .serving import DEFAULT_WINDOW

    dev = resolve_device(device)
    model = PHNet(cfg, device=dev)
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    window = memory_window or (cfg.memory.window if cfg.memory.window > 0
                               else DEFAULT_WINDOW)
    mem0 = init_memory(cfg, batch, window, dev)
    mem0 = mem0._replace(t=torch.zeros((), dtype=torch.int32, device=dev))
    frames = torch.zeros((batch, 1, cfg.img_h, cfg.img_w, 3), device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        step = _ServingStep(model, model.head.combine_dynamic(), type(mem0))
        program = torch.export.export(step, (frames, *mem0), strict=False)
    t1 = time.perf_counter()
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _STEP))
    t2 = time.perf_counter()
    np.savez(os.path.join(out_dir, _PARAMS),
             **{k: v.detach().cpu().numpy() for k, v in state_dict.items()})
    np.savez(os.path.join(out_dir, _MEMORY),
             **{f"m{i}": x.cpu().numpy() for i, x in enumerate(mem0)})
    manifest = {
        "kind": "serving_step",
        "torch_version": torch.__version__,
        "device": dev.type,
        "batch": batch,
        "memory_window": window,
        "memory_class": type(mem0).__name__,
        "img_h": cfg.img_h,
        "img_w": cfg.img_w,
        "packed": None,  # the TPU's space-to-depth stems are not ported
        "frames_dtype": "float32",
        "compute_dtype": cfg.compute_dtype,
        "quantize": cfg.quantize,
        "router_chain_bf16": bool(cfg.head.router_chain_bf16),
        "lane_spec": dataclasses.asdict(cfg.lane),
        "max_lanes": cfg.max_lanes,
        # host seconds of torch.export.export and of torch.export.save
        "seconds": {"export": t1 - t0, "save": t2 - t1},
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return out_dir


class DeployedServer:
    """A ticking server rebuilt from an artifact directory.

    Mirrors :class:`~phnet_torch.serving.StreamingServer`'s tick for
    ``batch`` streams that all tick (the same kept rows and valid slots,
    the memory carried here) but runs the loaded program: no model is
    built. The artifact's device is the manifest's; one from the card
    raises where there is none."""

    def __init__(self, art_dir: str):
        with open(os.path.join(art_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        kind = self.manifest["device"]
        if kind == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"the artifact {art_dir} was exported for a CUDA device and "
                f"none is available: its program launches the CUDA kernels "
                f"(export it again with device='cpu' for the CPU)")
        self.device = resolve_device(kind)
        self._step = torch.export.load(os.path.join(art_dir, _STEP)).module()
        with np.load(os.path.join(art_dir, _MEMORY)) as z:
            self._mem0 = tuple(torch.from_numpy(z[f"m{i}"]).to(self.device)
                               for i in range(len(z.files)))
        self.memory = self._mem0
        self.batch = int(self.manifest["batch"])
        self.lane_spec = LaneSpec(**self.manifest["lane_spec"])

    def reset(self):
        self.memory = self._mem0

    @property
    def graph(self) -> torch.fx.Graph:
        """The loaded program's graph (its ``phnet::`` operator nodes show
        which kernels a tick launches)."""
        return self._step.graph

    @torch.no_grad()
    def tick(self, frames) -> Tuple[np.ndarray, np.ndarray]:
        """frames: [batch, H, W, 3] float32 (one frame a stream; numpy or a
        tensor), or one [H, W, 3] frame at batch 1. Returns (kept [batch,
        K, dim], valid [batch, K]) as numpy; the memory advances."""
        frames = torch.as_tensor(frames, dtype=torch.float32)
        if frames.dim() == 3:
            frames = frames[None]
        frames = frames[:, None].to(self.device)
        with full_f32():
            kept, valid, _num, *mem = self._step(frames, *self.memory)
        self.memory = tuple(mem)
        return kept.cpu().numpy(), valid.cpu().numpy()

    def decode(self, kept: np.ndarray, valid: np.ndarray, ori_img_h=0,
               cut_height=0):
        """Decode kept rows to :class:`~phnet_torch.geometry.Lane` lists,
        one a stream, with the lane-spec constants of the manifest (the
        live server's :func:`~phnet_torch.geometry.decode_kept_rows`).
        ``ori_img_h`` / ``cut_height``: an int for every stream, or one
        value a stream (the live server's attach-time geometry)."""
        n = kept.shape[0]
        ori = [ori_img_h] * n if np.ndim(ori_img_h) == 0 else list(ori_img_h)
        cut = ([cut_height] * n if np.ndim(cut_height) == 0
               else list(cut_height))
        if len(ori) != n or len(cut) != n:
            raise ValueError(
                f"per-stream geometry length mismatch: batch={n}, "
                f"ori_img_h={len(ori)}, cut_height={len(cut)}")
        return [decode_kept_rows(np.asarray(kept[b])[np.asarray(valid[b])],
                                 self.lane_spec, ori_img_h=ori[b],
                                 cut_height=cut[b])
                for b in range(n)]

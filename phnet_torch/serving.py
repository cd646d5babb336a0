"""Multi-stream online serving (port of ``phnet_tpu/serving.py``, one
device, no mesh).

Up to ``max_streams`` live videos share one batched frame step per tick;
each stream has its own rows of the temporal memory ring, so attaching or
detaching a stream is a masked write. The ring holds the config's window
(OpenLane-V: 5 frames, so it wraps during a stream) or, where that is
unbounded (VIL-100), ``DEFAULT_WINDOW`` frames; the prior-propagation
head (``openlane_propagate_config``) carries one frame of kept rows
instead. Every preset of ``phnet_torch.config`` serves. A persistent
device frame buffer receives only the frames that arrived this tick; a
stream that skips a tick keeps its pre-step memory rows (for the ring,
the slot written this tick becomes a hole, masked, for it; the one-frame
carry is kept whole), and attaching or detaching a stream clears its
slots' mask in either layout.

Above :data:`CHAIN_BF16_ABOVE` streams the router chain runs in its bf16
mode, as the JAX server's does (``router_chain_bf16=None`` resolves to
``max_streams > 8``; True or False in the config wins), in float32 compute
as in bfloat16. The frames go up in float32 and the encoder casts them to
the compute dtype.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from .config import Config
from .device import resolve_device
from .geometry import Lane, decode_kept_rows
from .models.phnet import MemoryState, PHNet, V3MemoryState, init_memory

DEFAULT_WINDOW = 64  # ring frames when the config's window is unbounded
CHAIN_BF16_ABOVE = 8  # streams past which the router chain goes bf16


def resolve_chain_bf16(cfg: Config, max_streams: int) -> Config:
    """``cfg`` with ``head.router_chain_bf16`` resolved: None (auto) is
    ``max_streams > CHAIN_BF16_ABOVE``, as ``phnet_tpu/serving.py``
    resolves it; a pinned value stays."""
    head = cfg.model.head
    if head.router_chain_bf16 is not None:
        return cfg
    head = dataclasses.replace(
        head, router_chain_bf16=max_streams > CHAIN_BF16_ABOVE)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, head=head))


class StreamingServer:
    """Batched frame-synchronous server for up to ``max_streams`` videos.

    ``state_dict``: the port's weights (for example
    ``phnet_torch.convert.convert`` of a JAX checkpoint). ``device=None``
    serves on the card. ``self.cfg`` is ``cfg`` with the router chain's
    mode resolved (:func:`resolve_chain_bf16`)."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 max_streams: int = 4, memory_window: int = None,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg = resolve_chain_bf16(cfg, max_streams)
        self.mcfg = mcfg = cfg.model
        self.model = PHNet(mcfg, device=self.device)
        self.max_streams = max_streams
        self.update_variables(state_dict)
        self.window = memory_window or (
            mcfg.memory.window if mcfg.memory.window > 0 else DEFAULT_WINDOW)
        self.memory = init_memory(mcfg, max_streams, self.window, self.device)
        self._frames = torch.zeros(
            (max_streams, 1, mcfg.img_h, mcfg.img_w, 3), device=self.device)
        self.active = np.zeros(max_streams, bool)
        # original-image decode geometry per stream
        self.stream_geo: List[Tuple[int, int]] = [(0, 0)] * max_streams
        self._tick_wall = deque(maxlen=512)
        self._n_ticks = 0
        self._n_frames = 0
        self._frames_per_stream = np.zeros(max_streams, np.int64)

    def update_variables(self, state_dict: Mapping[str, torch.Tensor]):
        """Swap the served weights and rebuild the collapsed (with
        ``quantize``, re-quantized) DynamicConv weights, so no tick serves
        stale combines."""
        self.model.load_state_dict(state_dict, strict=True)
        self._dyn = self.model.head.combine_dynamic()

    # ------------------------------------------------------------------
    def attach(self, ori_img_h: int = 0, cut_height: int = 0) -> int:
        """Register a new stream; returns its slot id (memory cleared)."""
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            raise RuntimeError("no free stream slots")
        sid = int(free[0])
        self.active[sid] = True
        self.stream_geo[sid] = (ori_img_h, cut_height)
        self._frames_per_stream[sid] = 0
        self._clear_slot(sid)
        return sid

    def detach(self, sid: int):
        self.active[sid] = False
        self._clear_slot(sid)

    def _clear_slot(self, sid: int):
        mask = self.memory.mask.clone()
        mask[sid] = False
        self.memory = self.memory._replace(mask=mask)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step_async(self, frames: Dict[int, np.ndarray]):
        """Dispatch one batched tick without waiting for the device.
        Returns (kept [S, K, dim], valid [S, K], sids); pass them to
        :meth:`decode`."""
        mcfg = self.mcfg
        t0 = time.perf_counter()
        for sid in frames:
            assert self.active[sid], f"stream {sid} not attached"
        sids = list(frames.keys())
        if sids:
            rows = np.stack([np.asarray(frames[s], np.float32).reshape(
                mcfg.img_h, mcfg.img_w, 3) for s in sids])
            idx = torch.tensor(sids, device=self.device)
            self._frames[idx, 0] = torch.from_numpy(rows).to(self.device)
        row_mask = torch.zeros(self.max_streams, dtype=torch.bool)
        row_mask[sids] = True
        row_mask = row_mask.to(self.device)

        mem = self.memory
        outs, new = self.model(self._frames, initial_memory=mem,
                               dyn_combined=self._dyn)
        self.memory = self._keep_skipped(mem, new, row_mask)

        self._tick_wall.append(time.perf_counter() - t0)
        self._n_ticks += 1
        self._n_frames += len(sids)
        for sid in sids:
            self._frames_per_stream[sid] += 1
        return outs.kept[0], outs.kept_valid[0], sids

    def _keep_skipped(self, mem, new, row_mask):
        """The memory after a tick: streams with no new frame keep their
        pre-step rows (the counter still advances). In the ring the slot
        written this tick is a hole for them; the one-frame carry is kept
        whole, as the JAX server's ``sel(new, old)`` keeps it."""
        if isinstance(new, V3MemoryState):
            def keep(n, o):
                m = row_mask.reshape((-1,) + (1,) * (n.dim() - 1))
                return torch.where(m, n, o)

            return V3MemoryState(feat=keep(new.feat, mem.feat),
                                 priors=keep(new.priors, mem.priors),
                                 mask=keep(new.mask, mem.mask), t=new.t)
        pos = mem.t % self.window
        values, mask = new.values, new.mask  # fresh tensors, ours to edit
        values[:, :, pos] = torch.where(row_mask[:, None, None, None],
                                        values[:, :, pos],
                                        mem.values[:, :, pos])
        mask[:, pos] &= row_mask[:, None]
        return MemoryState(values=values, mask=mask, t=new.t)

    def stats(self) -> Dict:
        """Lifetime tick/frame counters, per-stream frames, and
        dispatch-wall percentiles over the last <= 512 ticks (host
        assembly + H2D + launch; the device work may still be running)."""
        wall = np.array(self._tick_wall) * 1e3
        return {
            "ticks": self._n_ticks,
            "frames": self._n_frames,
            "active_streams": int(self.active.sum()),
            "frames_per_stream": self._frames_per_stream.tolist(),
            "dispatch_ms_p50": (float(np.percentile(wall, 50))
                                if len(wall) else None),
            "dispatch_ms_p99": (float(np.percentile(wall, 99))
                                if len(wall) else None),
        }

    def decode(self, kept, valid, sids) -> Dict[int, List[Lane]]:
        """Fetch and decode a tick dispatched by :meth:`step_async`."""
        spec = self.mcfg.lane
        kept = kept.cpu().numpy()
        valid = valid.cpu().numpy()
        results: Dict[int, List[Lane]] = {}
        for sid in sids:
            ori_h, cut = self.stream_geo[sid]
            results[sid] = decode_kept_rows(kept[sid][valid[sid]], spec,
                                            ori_img_h=ori_h, cut_height=cut)
        return results

    def step(self, frames: Dict[int, np.ndarray]) -> Dict[int, List[Lane]]:
        """Synchronous tick: dispatch, fetch and decode."""
        kept, valid, sids = self.step_async(frames)
        return self.decode(kept, valid, sids)

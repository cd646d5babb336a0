"""Multi-stream online serving (port of ``phnet_tpu/serving.py``).

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

With a ``mesh`` (:func:`phnet_torch.parallel.make_mesh`) the streams are
split over its ``data`` axis, as the JAX server shards them: each of its
D devices holds a replica of the model, its collapsed DynamicConv
weights, and the memory rows and frame buffer of ``max_streams / D``
streams; slot s lives on device ``s // (max_streams / D)``. A tick
uploads every device's frames, then dispatches every device's step
before it waits on any; :meth:`StreamingServer.decode` gathers the kept
rows on the host. The router chain's mode is resolved from the global
``max_streams``. A mesh may name one device more than once (replicas
sharing a card). A ``model`` axis replicates the weights over each data
row, as the JAX server replicates its variables over the whole mesh:
the row's first device serves it.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Mapping, Sequence, Tuple

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


class _Replica:
    """One device's share of the server: the model and its collapsed
    DynamicConv weights, the memory rows and the frame buffer of
    ``streams`` slots."""

    def __init__(self, cfg: Config, state_dict, streams: int, window: int,
                 device: torch.device):
        m = cfg.model
        self.device = device
        self.window = window
        self.model = PHNet(m, device=device)
        self.load(state_dict)
        self.memory = init_memory(m, streams, window, device)
        self.frames = torch.zeros((streams, 1, m.img_h, m.img_w, 3),
                                  device=device)
        self.row_mask = torch.zeros(streams, dtype=torch.bool, device=device)

    def load(self, state_dict):
        self.model.load_state_dict(state_dict, strict=True)
        self.dyn = self.model.head.combine_dynamic()

    def clear(self, slot: int):
        mask = self.memory.mask.clone()
        mask[slot] = False
        self.memory = self.memory._replace(mask=mask)

    def stage(self, slots: Sequence[int], rows: Sequence[np.ndarray],
              img_h: int, img_w: int):
        """Upload this tick's frames into the slots that have one, and the
        tick's row mask."""
        mask = torch.zeros(self.row_mask.shape[0], dtype=torch.bool)
        if slots:
            batch = np.stack([np.asarray(r, np.float32).reshape(
                img_h, img_w, 3) for r in rows])
            idx = torch.tensor(list(slots), device=self.device)
            self.frames[idx, 0] = torch.from_numpy(batch).to(self.device)
            mask[list(slots)] = True
        self.row_mask = mask.to(self.device)

    def launch(self):
        """Dispatch the tick's step; returns (kept, valid) on the device."""
        mem = self.memory
        outs, new = self.model(self.frames, initial_memory=mem,
                               dyn_combined=self.dyn)
        self.memory = self._keep_skipped(mem, new, self.row_mask)
        return outs.kept[0], outs.kept_valid[0]

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


class StreamingServer:
    """Batched frame-synchronous server for up to ``max_streams`` videos.

    ``state_dict``: the port's weights (for example
    ``phnet_torch.convert.convert`` of a JAX checkpoint). ``device=None``
    serves on the card; ``mesh`` splits the streams over its ``data``
    axis (``max_streams`` must be a multiple of its size), one replica a
    data row on the row's first device, and takes the place of
    ``device``; its ``model`` axis replicates the weights, as the JAX
    server's mesh does, so the result is the data-only mesh's.
    ``self.cfg`` is ``cfg`` with the router chain's mode resolved
    (:func:`resolve_chain_bf16`) from ``max_streams``."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 max_streams: int = 4, memory_window: int = None,
                 device=None, mesh=None):
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            if device is not None:
                raise ValueError("pass a device or a mesh, not both")
            if "data" not in mesh.axis_names:
                raise ValueError(f"mesh needs a 'data' axis to split streams "
                                 f"over (got axes {mesh.axis_names})")
            devices = [resolve_device(d) for d in mesh.data_devices()]
            if max_streams % len(devices):
                raise ValueError(
                    f"max_streams={max_streams} must be divisible by the "
                    f"mesh data axis ({len(devices)})")
        self.mesh = mesh
        self.cfg = cfg = resolve_chain_bf16(cfg, max_streams)
        self.mcfg = mcfg = cfg.model
        self.max_streams = max_streams
        self.share = max_streams // len(devices)
        self.window = memory_window or (
            mcfg.memory.window if mcfg.memory.window > 0 else DEFAULT_WINDOW)
        self.replicas = [_Replica(cfg, state_dict, self.share, self.window,
                                  dev) for dev in devices]
        self.active = np.zeros(max_streams, bool)
        # original-image decode geometry per stream
        self.stream_geo: List[Tuple[int, int]] = [(0, 0)] * max_streams
        self._tick_wall = deque(maxlen=512)
        self._n_ticks = 0
        self._n_frames = 0
        self._frames_per_stream = np.zeros(max_streams, np.int64)

    # the first replica's, the only one without a mesh
    @property
    def device(self) -> torch.device:
        return self.replicas[0].device

    @property
    def model(self) -> PHNet:
        return self.replicas[0].model

    @property
    def _dyn(self):
        return self.replicas[0].dyn

    @property
    def memory(self):
        """The streams' memory: without a mesh the live state on the
        device; with one, every replica's rows joined on the host (a
        copy)."""
        if len(self.replicas) == 1:
            return self.replicas[0].memory
        mems = [r.memory for r in self.replicas]

        def join(name):
            return torch.cat([getattr(m, name).cpu() for m in mems])

        if isinstance(mems[0], V3MemoryState):
            return V3MemoryState(feat=join("feat"), priors=join("priors"),
                                 mask=join("mask"), t=mems[0].t)
        return MemoryState(values=join("values"), mask=join("mask"),
                           t=mems[0].t)

    def _where(self, sid: int) -> Tuple[_Replica, int]:
        """The replica holding slot ``sid`` and its slot there."""
        return self.replicas[sid // self.share], sid % self.share

    def update_variables(self, state_dict: Mapping[str, torch.Tensor]):
        """Swap the served weights on every replica and rebuild the
        collapsed (with ``quantize``, re-quantized) DynamicConv weights, so
        no tick serves stale combines."""
        for r in self.replicas:
            r.load(state_dict)

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
        replica, slot = self._where(sid)
        replica.clear(slot)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step_async(self, frames: Dict[int, np.ndarray]):
        """Dispatch one batched tick without waiting for the device.
        Returns (kept [S, K, dim], valid [S, K], sids) (with a mesh, kept
        and valid are lists of each replica's rows: :meth:`gather` joins
        them); pass them to :meth:`decode`."""
        mcfg = self.mcfg
        t0 = time.perf_counter()
        for sid in frames:
            assert self.active[sid], f"stream {sid} not attached"
        sids = list(frames.keys())
        shares = [[] for _ in self.replicas]
        for sid in sids:
            shares[sid // self.share].append(sid)
        # every replica's upload, then every replica's step: a replica's
        # upload does not wait behind another's work
        for replica, own in zip(self.replicas, shares):
            replica.stage([s % self.share for s in own],
                          [frames[s] for s in own], mcfg.img_h, mcfg.img_w)
        outs = [replica.launch() for replica in self.replicas]

        self._tick_wall.append(time.perf_counter() - t0)
        self._n_ticks += 1
        self._n_frames += len(sids)
        for sid in sids:
            self._frames_per_stream[sid] += 1
        if len(outs) == 1:
            return outs[0][0], outs[0][1], sids
        return [k for k, _ in outs], [v for _, v in outs], sids

    @staticmethod
    def gather(rows) -> np.ndarray:
        """A tick's kept rows or valid slots on the host: one tensor, or a
        mesh's list of each replica's, joined in slot order."""
        if isinstance(rows, (list, tuple)):
            return np.concatenate([r.cpu().numpy() for r in rows])
        return rows.cpu().numpy()

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
        kept, valid = self.gather(kept), self.gather(valid)
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

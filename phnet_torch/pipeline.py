"""High-level inference pipeline: video in, Lane objects / CULane txt out.

Port of ``phnet_tpu/pipeline.py`` (reference ``testVIL.py:72-130``: whole
video per call; ``testOLV3.py:95-121``: 16-frame chunks). A video runs in
chunks of ``chunk`` frames through :class:`phnet_torch.models.PHNet`, the
last chunk padded by repeating the last frame, with the temporal memory (the
ring, or the prior-propagation head's one-frame carry) carried across
chunks (``reset_memory_per_chunk=True`` resets it at every chunk, the
reference's OL behaviour). The DynamicConv combines (quantized
when the config asks for it, in the compute dtype) are built once per
weight set. The router chain's mode is the config's
(``router_chain_bf16``, None meaning off): the JAX pipeline does not
resolve it by batch as the server does.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import Config, ModelConfig
from .device import resolve_device
from .evaluation.emit import write_gt_txt, write_pred_txt
from .geometry import Lane, decode_kept_rows
from .models.phnet import PHNet, init_memory

VIL_WINDOW = 128  # ring frames when the config's window is unbounded


class InferencePipeline:
    """``state_dict``: the port's weights (``phnet_torch.convert``).
    ``device=None`` runs on the card."""

    def __init__(self, cfg: Config, state_dict: Mapping[str, torch.Tensor],
                 chunk: int = 16, memory_window: Optional[int] = None,
                 reset_memory_per_chunk: bool = False, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mcfg: ModelConfig = cfg.model
        self.model = PHNet(self.mcfg, device=self.device)
        self.chunk = chunk
        self.reset_per_chunk = reset_memory_per_chunk
        if memory_window is None:
            memory_window = (self.mcfg.memory.window
                             if self.mcfg.memory.window > 0 else VIL_WINDOW)
        self.memory_window = memory_window
        # original-image decode geometry of the clip being run
        self._ori_h, self._cut = 0, 0
        self.update_variables(state_dict)

    def update_variables(self, state_dict: Mapping[str, torch.Tensor]):
        """Swap the weights and rebuild the DynamicConv combines."""
        self.model.load_state_dict(state_dict, strict=True)
        self._dyn = self.model.head.combine_dynamic()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def run_video(self, frames: Union[np.ndarray, torch.Tensor]
                  ) -> Tuple[List[List[Lane]], float]:
        """frames: [T, H, W, 3] normalized, a numpy array or a tensor on
        any device (the dataset readers give a tensor on their device).
        Returns (per-frame Lane lists, model seconds)."""
        mcfg = self.mcfg
        frames = torch.as_tensor(frames)
        t_total = frames.shape[0]
        chunk = self.chunk
        pad = (-t_total) % chunk
        if pad:
            frames = torch.cat([frames, frames[-1:].expand(
                pad, *frames.shape[1:])])
        mem = init_memory(mcfg, 1, self.memory_window, self.device)

        kept_all, valid_all = [], []
        t0 = time.perf_counter()
        for c in range(0, frames.shape[0], chunk):
            if self.reset_per_chunk:
                mem = init_memory(mcfg, 1, self.memory_window, self.device)
            x = frames[None, c:c + chunk].to(self.device, torch.float32)
            outs, mem = self.model(x, initial_memory=mem,
                                   dyn_combined=self._dyn)
            kept_all.append(outs.kept[:, 0].cpu().numpy())
            valid_all.append(outs.kept_valid[:, 0].cpu().numpy())
        model_seconds = time.perf_counter() - t0

        kept_np = np.concatenate(kept_all)[:t_total]  # [T, K, dim]
        valid_np = np.concatenate(valid_all)[:t_total]
        per_frame = [decode_kept_rows(kept_np[t][valid_np[t]], mcfg.lane,
                                      ori_img_h=self._ori_h,
                                      cut_height=self._cut)
                     for t in range(t_total)]
        return per_frame, model_seconds

    def _clip_geometry(self, clip, fmt: str) -> Tuple[Tuple[int, int],
                                                      int, int]:
        """(emission frame (H, W), ori_img_h, cut_height) of a clip. VIL:
        the clip's original size and its ``cut`` (0 where it has none, as
        the JAX pipeline reads it: such frames were never cropped). OL:
        the clip's ``size`` or else ``org_size`` less its top
        ``crop_size`` rows; the decode leaves y in that frame."""
        m = self.mcfg
        if fmt == "vil":
            size = clip["size"]
            return size, size[0], clip.get("cut", 0)
        size = clip.get("size") or (m.org_size[0] - m.crop_size,
                                    m.org_size[1])
        return size, 0, 0

    # ------------------------------------------------------------------
    def run_and_emit(self, dataset, pred_dir: str,
                     anno_dir: Optional[str] = None, fmt: str = "vil",
                     video_indices: Optional[Sequence[int]] = None,
                     verbose: bool = False) -> Dict:
        """Run whole videos and emit CULane txt files; optionally also GT.
        ``dataset``: indexable (or with ``get_clip``) clip dicts with
        ``frames``, ``name``, ``frame_names``, ``points``, ``size`` (which
        OL clips may leave to the config) and an optional ``cut``. OL
        lines are shifted back by the config's ``crop_size`` rows. The
        ground truth is written from ``image_points`` (the readers' lanes
        in the frame of the predictions), or from ``points`` where a clip
        has no such key. Returns ``{'fps', 'frames', 'videos'}`` like the
        reference's per-video fps printout (``testVIL.py:127-130``)."""
        indices = list(video_indices) if video_indices is not None else list(
            range(len(dataset)))
        total_frames, total_seconds = 0, 0.0
        names = []
        for i in indices:
            clip = (dataset.get_clip(i) if hasattr(dataset, "get_clip")
                    else dataset[i])
            size, self._ori_h, self._cut = self._clip_geometry(clip, fmt)
            lanes_per_frame, secs = self.run_video(clip["frames"])
            total_frames += len(lanes_per_frame)
            total_seconds += secs
            names.append(clip["name"])
            for fname, lanes in zip(clip["frame_names"], lanes_per_frame):
                write_pred_txt(pred_dir, clip["name"], fname, lanes, size, fmt,
                               crop_offset=self.mcfg.crop_size)
            if anno_dir is not None:
                # the ground truth in the frame the predictions are written
                # in, as the reference's generate_anno writes it; a clip
                # without it (a synthetic one) has no other frame than the
                # model's
                gt = clip.get("image_points", clip["points"])
                for fname, pts in zip(clip["frame_names"], gt):
                    write_gt_txt(anno_dir, clip["name"], fname, pts)
            if verbose:
                print(f"{clip['name']}: {len(lanes_per_frame)} frames, "
                      f"{len(lanes_per_frame) / max(secs, 1e-9):.1f} fps")
        return {"fps": total_frames / max(total_seconds, 1e-9),
                "frames": total_frames, "videos": names}

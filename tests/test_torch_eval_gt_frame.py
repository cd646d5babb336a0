"""The ground truth that the port's evaluation path writes is in the frame
of its predictions, on the committed fixture (``tests/fixtures/torch_eval``).

A perfect model predicts each frame's labels exactly. Its lanes go through
the pipeline's own emission (``InferencePipeline.run_and_emit``: the
decode of kept rows with the clip's geometry, ``write_pred_txt``), the
ground truth through the same call's ``anno_dir``. Scored with the Python
CULane metric and with the native one, at IoU 0.5, the emission must give
F1 1.0 for VIL-100 (1280x720, the cut undone) and for OpenLane-V (the
half-scale frame, the crop shifted back). With the ground truth in the
model's frame (the readers' ``points``: resized, VIL's cut removed) it
scores near 0.
"""

import dataclasses
import os

import numpy as np
import pytest

import phnet_torch.config as tcfg
from phnet_torch.data.openlane import OpenLaneDataset
from phnet_torch.data.vil100 import VIL100Dataset
from phnet_torch.evaluation.culane_metric import (aggregate_results,
                                                  culane_metric)
from phnet_torch.evaluation.emit import read_lines_txt
from phnet_torch.evaluation.native_eval import native_eval
from phnet_torch.geometry import decode_kept_rows
from phnet_torch.models.phnet import PHNet
from phnet_torch.pipeline import InferencePipeline

import torch_parity as tp
from torch_eval_parity import FIXTURE, lane_count

# dataset: (reader, small config, the emission frame's (H, W))
DATASETS = {"vil": (VIL100Dataset, tp.small_model_cfg, (720, 1280)),
            "ol": (OpenLaneDataset, tp.small_ol_cfg, (640, 960))}


class PerfectPipeline(InferencePipeline):
    """The pipeline of a model whose kept rows are the frame's labels: the
    clip's labels stand in for its frames, and are decoded and emitted as
    the model's predictions are (xs normalized by ``img_w - 1``, the
    length fields as fractions of the strips, as the head predicts
    them)."""

    def run_video(self, labels):
        m = self.mcfg
        spec = m.lane
        per_frame = []
        for lab in labels:
            rows = lab[lab[:, 1] == 1.0].astype(np.float64)
            rows[:, spec.col_xs:] /= m.img_w - 1
            per_frame.append(decode_kept_rows(rows, spec,
                                              ori_img_h=self._ori_h,
                                              cut_height=self._cut))
        return per_frame, 1.0


@pytest.fixture(scope="module", params=sorted(DATASETS))
def emitted(request, tmp_path_factory):
    reader, small_cfg, frame = DATASETS[request.param]
    # the preset's label rows: the fixture numbers its VIL lanes up to 5
    model_cfg = dataclasses.replace(small_cfg(tcfg), max_lanes=8)
    data = reader(FIXTURE, model_cfg, device="cpu")
    clips = [dict(clip, frames=clip["labels"]) for clip in data]
    tmp = tmp_path_factory.mktemp(request.param)
    pipe = PerfectPipeline(tcfg.Config(model=model_cfg),
                           PHNet(model_cfg, device="cpu").state_dict(),
                           device="cpu")
    stats = pipe.run_and_emit(clips, str(tmp / "pred"), str(tmp / "anno"),
                              fmt=request.param)
    assert stats["frames"] == sum(len(c["frame_names"]) for c in clips)
    assert lane_count(tmp / "anno") > 0
    assert lane_count(tmp / "pred") == lane_count(tmp / "anno")
    return tmp, frame


def python_f1(pred_dir, anno_dir, frame):
    results = []
    for vid in sorted(os.listdir(anno_dir)):
        for f in sorted(os.listdir(os.path.join(anno_dir, vid))):
            results.append(culane_metric(
                read_lines_txt(os.path.join(pred_dir, vid, f)),
                read_lines_txt(os.path.join(anno_dir, vid, f)),
                frame + (3,)))
    return aggregate_results(results)


def native_f1(pred_dir, anno_dir, frame):
    return native_eval(pred_dir, anno_dir, img_w=frame[1], img_h=frame[0])


@pytest.mark.parametrize("metric", [python_f1, native_f1],
                         ids=["python", "native"])
def test_ground_truth_as_predictions_scores_f1_one(emitted, metric):
    tmp, frame = emitted
    got = metric(str(tmp / "pred"), str(tmp / "anno"), frame)
    assert got["TP"] > 0 and got["FP"] == got["FN"] == 0, got
    assert got["F1"] == 1.0


def test_ground_truth_lies_in_the_emission_frame(emitted):
    """Every ground-truth point lies inside the predictions' frame, and the
    ground truth reaches past the small model's frame (128x64 VIL, 192x96
    OL) that the readers' ``points`` are in."""
    tmp, (h, w) = emitted
    pts = np.array([p for d, _, fs in os.walk(tmp / "anno") for f in fs
                    for lane in read_lines_txt(os.path.join(d, f))
                    for p in lane])
    assert (pts >= 0).all() and (pts[:, 0] < w).all() and (
        pts[:, 1] < h).all()
    assert pts[:, 1].max() > 0.5 * h
